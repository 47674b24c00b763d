// int8 convolution with its epilogue, and the int8 max pool, for Hopper
// (sm_90a): the sites of the int8 ResNet-101 encoder.
//
// Replaces what XLA compiled for icek_tpu/models/resnet_int8.py (no Pallas
// kernel): _qconv (:73), lax.conv_general_dilated of int8 NHWC activations
// and int8 HWIO weights into int32, with the elementwise epilogue XLA fuses
// into it (_site_out :330, the residual add, _requant_relu :68), the input
// quantization before the stem (:344), and the stem's int8 max pool
// (reduce_window with a -128 identity, :353).
//
// The convolution is an implicit GEMM: C[m, n] = sum_k A[m, k] B[k, n] with
// m = (b, oh, ow) an output pixel, n = co an output channel and k = (kh,
// kw, ci) a tap and input channel.  A is never materialised.  B is the
// weight as (Cout, K) int8, k-contiguous (OHWI).  Both are K-major, which
// int8 wgmma requires.
//
// What bounds a site (batch 256, 256x256 images): the 1x1 sites of layers
// 1 and 2 and the stem are bound by bytes (K = 64 to 512 int8 operations a
// byte of activation against the card's 590 int8 operations a byte of
// memory traffic; the stem reads float32 images); the 3x3 sites and layers 3
// and 4 by operations.  Measured, the epilogue's instruction count held the
// small-K sites back most (PERF.md, section 6).
//
// The kernel (int8_conv_wgmma_kernel), one design for every site whose C and
// Cout are multiples of 64:
//  * a persistent grid of one block an SM walks the (m, n) tiles of 128 rows
//    x BN channels, n fastest, so neighbouring blocks share an A tile in L2;
//  * three warpgroups: two consumers of 64 rows each run
//    wgmma.mma_async m64nBNk32 (s8 x s8 -> s32) on operands in shared memory
//    (descriptors, 128- or 64-byte swizzle), one producer fills a ring of
//    stages of BK = 128 bytes of k (64 where C % 128 != 0), each guarded by a
//    full and an empty mbarrier; no __syncthreads in the loop; setmaxnreg
//    gives the consumers the registers the producer does not need;
//  * the weight tiles always come by TMA; the activation tiles of a 1x1 / 1
//    site by TMA as rows of an (M, C) matrix, those of a 3x3 or strided site
//    whose tiles are whole output rows or images (every site of an encode)
//    by TMA as 4D boxes (the tap's offset, traversal stride = the site's,
//    zeros in the padding); other shapes' are gathered by the producer, one
//    row a thread, 16-byte cp.async into the swizzled tile;
//  * the producer also fetches each tile's epilogue inputs into one of two
//    buffers (es and b by bulk copies, an int8 shortcut tile by TMA, behind
//    the tile's k-stages); the epilogue converts with exact magic-number
//    arithmetic where int <-> float conversions would run at a quarter rate,
//    and stores each warp's 16 rows through shared memory as whole 16-byte
//    row segments;
//  * the fused site (a bottleneck's block 0) runs the down convolution's GEMM
//    and conv3's into two accumulator sets on each tile and requantizes
//    (acc3 es3 + b3) + (accd esd + bd): the float32 shortcut never reaches
//    device memory;
//  * the stem reads the normalized float32 images (planar: two TMA boxes a
//    tile; any other strides: float by float), quantizes its tile's 7-row
//    input patch into shared memory once and builds its A rows from there
//    (k laid out as 7 rows of 32 bytes, 21 taps x channels each, the weight
//    zero elsewhere).
// The mma.sync kernel (int8_conv_kernel, m16n8k32, three cp.async stages)
// stays for the shapes the wgmma kernel does not take: C or Cout not a
// multiple of 64, such as the int8 stem through int8_conv (C = 3, padded
// to 4) or Cout = 72.
//
// Epilogue, per element, in the plain version's order with no contraction
// (__fmul_rn / __fadd_rn) and round half to even, so its int8 codes equal
// the plain version's bit for bit:
//   y = float(acc) * es[n] + b[n]
//   MODE_F32      out = y                      (float32; the down conv)
//   MODE_Q8       out = q(y)
//   MODE_Q8_F32SC out = q(y + shortcut_f32)    (conv3 after a down conv)
//   MODE_Q8_Q8SC  out = q(y + float(xq) * a_x) (conv3, identity shortcut)
//   MODE_ACC      out = acc                    (int32; no epilogue)
//   fused         out = q(y3 + yd)             (conv3 and the down conv)
// with q(v) = clamp(rint(max(v, 0) * inv), 0, 127) as int8.
#include "common.cuh"

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time

#include <type_traits>

namespace {

enum Mode { MODE_F32 = 0, MODE_Q8 = 1, MODE_Q8_F32SC = 2, MODE_Q8_Q8SC = 3, MODE_ACC = 4 };
enum Route { ROUTE_MMA_SYNC = 0, ROUTE_TMA = 1, ROUTE_GATHER = 2, ROUTE_TMA_BOX = 3 };

__device__ __forceinline__ int requant(float y, float inv) {
  const int q = __float2int_rn(__fmul_rn(fmaxf(y, 0.0f), inv));
  return min(max(q, 0), 127);
}

// The mma.sync kernel: m16n8k32 on tiles of 128 rows x 64 or 128
// channels x 64 taps, three cp.async stages, operands read from shared
// memory with 32-bit loads (rows padded to 80 bytes).
namespace mma {

constexpr int BM = 128;          // output pixels a block
constexpr int BK = 64;           // k (bytes) a stage
constexpr int LDS = BK + 16;     // shared row pitch in bytes
constexpr int STAGES = 3;
constexpr int THREADS = 256;     // 8 warps: 4 along m x 2 along n

struct ConvArgs {
  const int8_t* x;       // (B, H, W, C) int8
  const int8_t* w;       // (N, Kpad) int8
  const float* es;       // (N,) dequant scale
  const float* bias;     // (N,)
  const void* shortcut;  // (M, N) float32 or int8, per mode
  void* out;             // (M, N) float32, int8 or int32, per mode
  float a_x, inv;
  int B, H, W, C, Ho, Wo, N, KW, stride, pad, K, Kpad, M, mode;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// GENERIC: C % 4 == 0 and k-tiles may straddle taps (the stem, C padded to
// 4): 4-byte copies, each its own tap.  Otherwise C % 64 == 0, so a 64-byte
// k-tile lies inside one tap: 16-byte copies.
template <int BN, bool GENERIC>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(const ConvArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;
  int8_t* Bs = smem + STAGES * BM * LDS;
  constexpr int WN = BN / 2;       // channels a warp
  constexpr int NT = WN / 8;       // n8 tiles a warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // this thread's two A rows (tid / 4 and tid / 4 + 64), 16 bytes at a_col
  const int a_col = (tid & 3) * 16;
  int a_pix[2], a_ih[2], a_iw[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + (tid >> 2) + r * 64;
    a_ok[r] = m < p.M;
    const int mm = a_ok[r] ? m : 0;
    const int hw = p.Ho * p.Wo;
    const int b = mm / hw, rem = mm - b * hw;
    const int oh = rem / p.Wo, ow = rem - oh * p.Wo;
    a_pix[r] = b * p.H;                      // row base of image b
    a_ih[r] = oh * p.stride - p.pad;
    a_iw[r] = ow * p.stride - p.pad;
  }

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    int8_t* as = As + stage * BM * LDS;
    if (!GENERIC) {
      const int tap = k0 / p.C;
      const int ci = k0 - tap * p.C + a_col;
      const int kh = tap / p.KW, kw = tap - kh * p.KW;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (tid >> 2) + r * 64;
        const int ih = a_ih[r] + kh, iw = a_iw[r] + kw;
        const bool ok = a_ok[r] && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
        const int8_t* src =
            ok ? p.x + ((size_t)(a_pix[r] + ih) * p.W + iw) * p.C + ci : p.x;
        cp_async16(smem_u32(as + row * LDS + a_col), src, ok);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (tid >> 2) + r * 64;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + a_col + j * 4;
          const int tap = k / p.C, ci = k - tap * p.C;
          const int kh = tap / p.KW, kw = tap - kh * p.KW;
          const int ih = a_ih[r] + kh, iw = a_iw[r] + kw;
          const bool ok = a_ok[r] && k < p.K && ih >= 0 && ih < p.H && iw >= 0 &&
                          iw < p.W;
          const int8_t* src =
              ok ? p.x + ((size_t)(a_pix[r] + ih) * p.W + iw) * p.C + ci : p.x;
          cp_async4(smem_u32(as + row * LDS + a_col + j * 4), src, ok);
        }
      }
    }
    int8_t* bs = Bs + stage * BN * LDS;
#pragma unroll
    for (int c = tid; c < BN * 4; c += THREADS) {
      const int row = c >> 2, col = (c & 3) * 16;
      const int n = n0 + row;
      const bool ok = n < p.N;
      const int8_t* src = ok ? p.w + (size_t)n * p.Kpad + k0 + col : p.w;
      cp_async16(smem_u32(bs + row * LDS + col), src, ok);
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = p.Kpad / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();      // tile kt landed; every warp is done with kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_tile(nk % STAGES, nk);
    cp_async_commit();
    const int8_t* as = As + (kt % STAGES) * BM * LDS;
    const int8_t* bs = Bs + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* a = as + (wm * 32 + mt * 16 + g) * LDS + ks + t4;
        af[mt][0] = lds32(a);
        af[mt][1] = lds32(a + 8 * LDS);
        af[mt][2] = lds32(a + 16);
        af[mt][3] = lds32(a + 8 * LDS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* b = bs + (wn * WN + nt * 8 + g) * LDS + ks + t4;
        bf[nt][0] = lds32(b);
        bf[nt][1] = lds32(b + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: lane holds rows g and g + 8 of each m16 tile, columns
  // 2 (lane % 4) and + 1 of each n8 tile
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + wn * WN + nt * 8 + (lane & 3) * 2;
    if (col >= p.N) continue;
    float es0 = 0.f, es1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (p.mode != MODE_ACC) {
      es0 = p.es[col];
      es1 = p.es[col + 1];
      b0 = p.bias[col];
      b1 = p.bias[col + 1];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mt * 16 + g + half * 8;
        if (row >= p.M) continue;
        const size_t o = (size_t)row * p.N + col;   // even: N and col are
        const int v0 = acc[mt][nt][half * 2], v1 = acc[mt][nt][half * 2 + 1];
        if (p.mode == MODE_ACC) {
          reinterpret_cast<int2*>(p.out)[o / 2] = make_int2(v0, v1);
          continue;
        }
        float y0 = __fadd_rn(__fmul_rn(__int2float_rn(v0), es0), b0);
        float y1 = __fadd_rn(__fmul_rn(__int2float_rn(v1), es1), b1);
        if (p.mode == MODE_F32) {
          reinterpret_cast<float2*>(p.out)[o / 2] = make_float2(y0, y1);
          continue;
        }
        if (p.mode == MODE_Q8_F32SC) {
          const float2 s = reinterpret_cast<const float2*>(p.shortcut)[o / 2];
          y0 = __fadd_rn(y0, s.x);
          y1 = __fadd_rn(y1, s.y);
        } else if (p.mode == MODE_Q8_Q8SC) {
          const char2 s = reinterpret_cast<const char2*>(p.shortcut)[o / 2];
          y0 = __fadd_rn(y0, __fmul_rn(static_cast<float>(s.x), p.a_x));
          y1 = __fadd_rn(y1, __fmul_rn(static_cast<float>(s.y), p.a_x));
        }
        reinterpret_cast<char2*>(p.out)[o / 2] =
            make_char2(static_cast<signed char>(requant(y0, p.inv)),
                       static_cast<signed char>(requant(y1, p.inv)));
      }
  }
}

template <int BN>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * (BM + BN) * LDS;
}

template <int BN, bool GENERIC>
int launch(const ConvArgs& a, cudaStream_t s) {
  auto kernel = int8_conv_kernel<BN, GENERIC>;
  constexpr size_t smem = smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

// The wgmma kernel (the head of the file describes it).
namespace hop {

constexpr int BM = 128;                 // output pixels a tile: two warpgroups of 64
constexpr int THREADS = 384;            // consumers: warpgroups 0, 1; producer: 2
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int SPITCH = 272;             // staging row pitch: 64 x 4 or 256 x 1 bytes + 16
constexpr int STEM_PITCH = 800;         // stem patch row: 261 columns x 3 channels, padded
constexpr int STEM_COLS = 261;          // 2 * 127 + 7 input columns under 128 outputs
constexpr int RAW_BOX = 132;            // floats a raw patch row half: 2 x 132 >= 261 + 1
constexpr int RAW_HALF = 2784;          // floats a half (21 rows), 128-byte aligned for TMA
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may use
constexpr int MAX_STAGES = 6;

// How an operand's A tiles arrive: gathered by the producer's threads, by
// TMA as rows of an (M, C) matrix (a 1x1 / 1 site), or by TMA as a 4D box
// of (C, W, H, B) at the tap's offset, strided by the site's stride, zeros
// in the padding (a site whose 128-row tiles are whole output rows of one
// image or whole images: box_tile).
enum ALoad { A_GATHER = 0, A_MATRIX = 1, A_BOX = 2 };

// One GEMM feeding a tile: its activations' geometry and the epilogue's
// scale and bias; kt k-stages of BK bytes.
struct Operand {
  const int8_t* x;
  const float* es;
  const float* bias;
  int H, W, C, KW, stride, pad, kt, load;
};

struct Args {
  Operand op[2];
  const float* img;                     // the stem's float32 images
  long long sb, sh, sw, sc;             // their strides, in elements
  int raw_tma;                          // its raw patch by TMA (planar, W % 4 == 0, aligned)
  const void* shortcut;                 // MODE_Q8_F32SC: (M, N) float32
  void* out;
  float a_x, inv, inv_img;
  int M, N, Ho, Wo, mode, tiles, tiles_n;
};

// Shared memory: the ring (A then B a stage, each 1024-aligned), the
// epilogue's inputs twice, by tile parity (the int8 shortcut tile; es and b
// of each GEMM), the warps' staging rows, the stem's patch and its two raw
// float patches, the mbarriers.
template <int BN, int BK, bool STEM>
struct Layout {
  static constexpr int A = BM * BK, B = BN * BK, STAGE = A + B;
  static constexpr int STG = 8 * 16 * SPITCH;
  static constexpr int PAR = 2 * 4 * BN * 4;
  static constexpr int PATCH = STEM ? 7 * STEM_PITCH : 0;
  static constexpr int RAW = STEM ? 2 * 2 * RAW_HALF * 4 : 0;
  static constexpr int BARS = 256;
  static constexpr int REST = STG + PAR + PATCH + RAW + BARS;
  static constexpr int ROOM = SMEM_LIMIT - 1024 - REST;
  static constexpr int SC = STEM ? 0 : 2 * BM * BN;
  static constexpr int FIT = (ROOM - SC) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SC_OFF = STAGES * STAGE;
  static constexpr int STG_OFF = SC_OFF + SC;
  static constexpr int PAR_OFF = STG_OFF + STG;
  static constexpr int RAW_OFF = PAR_OFF + PAR;      // 128-aligned (TMA)
  static constexpr int PATCH_OFF = RAW_OFF + RAW;
  static constexpr int BAR_OFF = PATCH_OFF + PATCH;
  static constexpr int BYTES = BAR_OFF + BARS + 1024;   // + the 1024-byte alignment
  // the consumers hold a stage while they read the next, and a gathered
  // stage is announced one stage late: two stages would deadlock
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
  static_assert(RAW_OFF % 128 == 0 && RAW_HALF % 32 == 0 && RAW_HALF >= 21 * RAW_BOX, "raw patch");
  static_assert((2 * STAGES + 6) * 8 <= BARS, "mbarriers");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait for the phase of parity `parity` to complete; a wait that never ends
// (a fault in the pipeline) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t n = 0;
  while (!mbar_try(bar, parity))
    if (++n == (1u << 26)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA: the box at (c0 bytes, c1 rows) of a 2D tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// bytes (a multiple of 16) from global to shared memory, both 16-aligned
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA: the box at (channel, column, row, image) of a 4D tensor map
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int w, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(b)
      : "memory");
}

// the generic proxy's writes to shared memory (st.shared, cp.async) made
// visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor of a K-major tile whose rows are SW bytes
// (one swizzle span: 128 or 64), 8-row groups SW * 8 bytes apart
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = SW == 128 ? 1 : 2;
  constexpr uint64_t sbo = (8 * SW) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (sbo << 32) |
         (layout << 62);
}

// 16-byte chunk j of row r of a tile of SW-byte rows, where the swizzle puts
// it (TMA's CU_TENSOR_MAP_SWIZZLE_128B / _64B on a 1024 / 512-aligned base)
template <int SW>
__device__ __forceinline__ int swizzle_chunk(int r, int j) {
  return SW == 128 ? (j ^ (r & 7)) : (j ^ ((r >> 1) & 3));
}

template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <> struct Wgmma<256> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

__device__ __forceinline__ float dequant(int acc, float es, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), es), b);
}

// The epilogue is bound by its instruction count, and int <-> float
// conversions run at a quarter of the rate of adds: an int8 code becomes a
// float, and a float in [-127, 127] its nearest integer (ties to even, as
// rint), through the magic number 1.5 * 2^23, exactly, in two full-rate
// instructions.
constexpr float MAGIC = 12582912.0f;
__device__ __forceinline__ float code_to_float(int code) {
  return __fsub_rn(__int_as_float(0x4B400000 + code), MAGIC);
}

// q(y) = clamp(rint(max(y, 0) * inv), 0, 127) in the low byte
__device__ __forceinline__ uint32_t requant_byte(float y, float inv) {
  return __float_as_uint(__fadd_rn(fminf(__fmul_rn(fmaxf(y, 0.0f), inv), 127.0f), MAGIC));
}

template <int BN, int BK, int NG, bool STEM>
__global__ void __launch_bounds__(THREADS, 1)
    int8_conv_wgmma_kernel(const __grid_constant__ Args a, const __grid_constant__ CUtensorMap w0,
                           const __grid_constant__ CUtensorMap w1,
                           const __grid_constant__ CUtensorMap x0,
                           const __grid_constant__ CUtensorMap x1,
                           const __grid_constant__ CUtensorMap scm) {
  using L = Layout<BN, BK, STEM>;
  constexpr int STAGES = L::STAGES;
  constexpr int SB = BN < 128 ? BN : 128;       // shortcut box width (its swizzle span)
  extern __shared__ __align__(16) int8_t smem_raw[];
  // aligned to 1024 by pointer arithmetic, so accesses stay shared ones (LDS / STS)
  int8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  // full[s], empty[s] of the ring; ep_full[j], ep_empty[j] of the epilogue's inputs
  const uint32_t bars = base + L::BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  auto ep_full = [&](int j) { return bars + 16 * STAGES + 8 * j; };
  auto ep_empty = [&](int j) { return bars + 16 * STAGES + 16 + 8 * j; };
  auto raw_full = [&](int j) { return bars + 16 * STAGES + 32 + 8 * j; };   // the stem's
  auto a_tile = [&](int s) { return base + s * L::STAGE; };
  auto b_tile = [&](int s) { return base + s * L::STAGE + L::A; };
  const int tid = threadIdx.x;
  const bool q8sc = a.mode == MODE_Q8_Q8SC;
  const int nparams = a.mode == MODE_ACC ? 0 : 2 * NG;    // es, b of each GEMM

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 128 + 1);      // the producer's 128 threads and its TMA's bytes
      mbar_init(empty(s), 2);           // one arrival a consumer warpgroup
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(ep_full(j), 1);
      mbar_init(ep_empty(j), 256);
      mbar_init(raw_full(j), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (STEM && tid >= 256) {             // the patch rows' tails stay zero
    for (int i = tid - 256; i < 7 * (STEM_PITCH - 3 * STEM_COLS); i += 128) {
      const int r = i / (STEM_PITCH - 3 * STEM_COLS);
      smem[L::PATCH_OFF + r * STEM_PITCH + 3 * STEM_COLS + i % (STEM_PITCH - 3 * STEM_COLS)] = 0;
    }
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = tid - 256;
    int s = 0, tcount = 0, pending = -1;   // pending: a gathered stage not yet announced
    uint32_t ph = 0;
    auto advance = [&]() {
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    };
    // a tile's epilogue inputs, into buffer tcount & 1: es and b of each GEMM
    // for its columns (bulk copies) and the int8 shortcut tile (TMA), started
    // behind its k-stages (so the ring runs ahead of the epilogues), in
    // flight while they run
    auto fetch_epilogue = [&](int m0, int n0) {
      const int j = tcount & 1;
      mbar_wait(ep_empty(j), ((tcount >> 1) & 1) ^ 1);
      if (pt == 0) {
        const int cols = min(BN, a.N - n0);
        mbar_expect_tx(ep_full(j), nparams * cols * 4 + (q8sc ? BM * BN : 0));
        const uint32_t par = base + L::PAR_OFF + j * 4 * BN * 4;
        for (int p = 0; p < nparams; ++p) {
          const Operand& op = a.op[p >> 1];
          bulk_load(par + p * BN * 4, ((p & 1) ? op.bias : op.es) + n0, cols * 4, ep_full(j));
        }
        if (!STEM && q8sc) {
#pragma unroll
          for (int i = 0; i < BN / SB; ++i)
            tma_load(base + L::SC_OFF + (j * BN / SB + i) * BM * SB, &scm, ep_full(j),
                     n0 + i * SB, m0);
        }
      }
    };
    if constexpr (STEM) {
      // A tile's raw float patch (7 rows x 3 channels x 262 columns) into
      // raw buffer `buf`: two halves of 21 rows (7 ci + kh) of RAW_BOX
      // floats; float r of a row is input column 2 BM owb - 4 + r (patch
      // column r - 1), zeros outside the image.  Planar aligned images
      // (normalize_in_graph's view) come by two 4D TMA boxes of the image
      // map x0, others float by float (cp.async); the next tile's patch is
      // in flight while this one's rows are built.
      const int owb_n = (a.Wo + BM - 1) / BM;
      const Operand& op = a.op[0];
      auto fetch_raw = [&](int tile, int buf) {
        const int t2 = tile / owb_n, owb = tile - t2 * owb_n;
        const int b = t2 / a.Ho, oh = t2 - b * a.Ho;
        const int ih0 = 2 * oh - 3, iw0 = 2 * BM * owb - 3;
        const uint32_t raw = base + L::RAW_OFF + buf * 2 * RAW_HALF * 4;
        if (a.raw_tma) {
          if (pt == 0) {
            mbar_expect_tx(raw_full(buf), 2 * 21 * RAW_BOX * 4);
            for (int h = 0; h < 2; ++h)
              tma_load_4d(raw + h * RAW_HALF * 4, &x0, raw_full(buf), iw0 - 1 + h * RAW_BOX, ih0,
                          0, b);
          }
        } else {
          for (int i = pt; i < 21 * STEM_COLS; i += 128) {
            const int row = i / STEM_COLS, c = i - row * STEM_COLS;   // row = 7 ci + kh
            const int ci = row / 7, kh = row - 7 * ci;
            const int ih = ih0 + kh, iw = iw0 + c, h = (c + 1) / RAW_BOX;
            const bool ok = static_cast<unsigned>(ih) < static_cast<unsigned>(op.H) &&
                            static_cast<unsigned>(iw) < static_cast<unsigned>(op.W);
            const float* src = ok ? a.img + b * a.sb + ih * a.sh + iw * a.sw + ci * a.sc : a.img;
            cp_async4(raw + (h * RAW_HALF + row * RAW_BOX + c + 1 - h * RAW_BOX) * 4, src, ok);
          }
        }
      };
      int8_t* patch = smem + L::PATCH_OFF;
      fetch_raw(blockIdx.x, 0);
      cp_async_commit();
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++tcount) {
        if (tile + static_cast<int>(gridDim.x) < a.tiles) fetch_raw(tile + gridDim.x, (tcount + 1) & 1);
        cp_async_commit();
        fetch_epilogue(0, 0);           // es / b, the same every tile: at its start
        cp_async_wait<1>();
        if (a.raw_tma) mbar_wait(raw_full(tcount & 1), (tcount >> 1) & 1);
        named_sync(2, 128);             // this tile's raw patch landed, the last rows are built
        // quantized into the int8 patch, (column, channel) interleaved, four
        // floats a step: clamp(rint(x inv_img), -127, 127) by the magic number
        const float* raw =
            reinterpret_cast<const float*>(smem + L::RAW_OFF) + (tcount & 1) * 2 * RAW_HALF;
#pragma unroll 4
        for (int i = pt; i < 21 * (2 * RAW_BOX / 4); i += 128) {
          const int row = i / (2 * RAW_BOX / 4), c4 = i - row * (2 * RAW_BOX / 4);
          const int ci = row / 7, kh = row - 7 * ci, h = c4 / (RAW_BOX / 4);
          const float4 v = *reinterpret_cast<const float4*>(
              raw + h * RAW_HALF + row * RAW_BOX + 4 * c4 - h * RAW_BOX);
          const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = 4 * c4 + u - 1;
            if (c < 0 || c >= STEM_COLS) continue;
            const float t = fminf(fmaxf(__fmul_rn(f[u], a.inv_img), -127.0f), 127.0f);
            patch[kh * STEM_PITCH + 3 * c + ci] =
                static_cast<int8_t>(__float_as_uint(__fadd_rn(t, MAGIC)) & 0xFF);
          }
        }
        named_sync(2, 128);
        // A row pt (output column BM owb + pt): for each kernel row kh the 32
        // patch bytes from 6 pt (21 taps x channels, then neighbours the
        // zero weights cancel); kernel row 7 is zeros
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          mbar_wait(empty(s), ph ^ 1);
          if (pt == 0) {
            mbar_expect_tx(full(s), BN * BK);
            tma_load(b_tile(s), &w0, full(s), st * BK, 0);
          }
          const uint32_t row = a_tile(s) + pt * BK;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int kh = st * 4 + q;
            uint32_t v[8];
            if (kh < 7) {
              const int off = kh * STEM_PITCH + 6 * pt;
              const uint32_t* src = reinterpret_cast<const uint32_t*>(patch + (off & ~3));
              if (off & 3) {
#pragma unroll
                for (int i = 0; i < 8; ++i) v[i] = __funnelshift_r(src[i], src[i + 1], 16);
              } else {
#pragma unroll
                for (int i = 0; i < 8; ++i) v[i] = src[i];
              }
            } else {
#pragma unroll
              for (int i = 0; i < 8; ++i) v[i] = 0u;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t dst = row + (swizzle_chunk<BK>(pt, 2 * q + h) << 4);
              asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                           "r"(v[4 * h]), "r"(v[4 * h + 1]), "r"(v[4 * h + 2]), "r"(v[4 * h + 3])
                           : "memory");
            }
          }
          fence_async_shared();
          mbar_arrive(full(s));
          advance();
        }
      }
      cp_async_wait<0>();
    } else {
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++tcount) {
        const int m0 = (tile / a.tiles_n) * BM, n0 = (tile % a.tiles_n) * BN;
        const int m = m0 + pt;
        const bool mv = m < a.M;
        const int mm = mv ? m : 0, hw = a.Ho * a.Wo;
        const int b = mm / hw, rem = mm - b * hw;
        const int oh = rem / a.Wo, ow = rem - oh * a.Wo;
        const int b0 = m0 / hw, oh0 = (m0 - b0 * hw) / a.Wo;   // a box tile's origin
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          const Operand& op = a.op[gi];
          const CUtensorMap* wmap = gi ? &w1 : &w0;
          const CUtensorMap* xmap = gi ? &x1 : &x0;
          const int8_t* xb = op.x + static_cast<size_t>(b) * op.H * op.W * op.C;
          const int ih0 = oh * op.stride - op.pad, iw0 = ow * op.stride - op.pad;
          int ci = 0, kw = 0, kh = 0;
          for (int kt = 0; kt < op.kt; ++kt) {
            mbar_wait(empty(s), ph ^ 1);
            if (pt == 0) {
              mbar_expect_tx(full(s), BN * BK + (op.load != A_GATHER ? BM * BK : 0));
              tma_load(b_tile(s), wmap, full(s), kt * BK, n0);
              if (op.load == A_MATRIX) tma_load(a_tile(s), xmap, full(s), kt * BK, m0);
              if (op.load == A_BOX)
                tma_load_4d(a_tile(s), xmap, full(s), ci, kw - op.pad,
                            oh0 * op.stride + kh - op.pad, b0);
            }
            if (op.load != A_GATHER) {
              if (pending >= 0) {
                cp_async_wait<0>();
                fence_async_shared();
                mbar_arrive(full(pending));
                pending = -1;
              }
              mbar_arrive(full(s));
            } else {
              const int ih = ih0 + kh, iw = iw0 + kw;
              const bool ok = mv && static_cast<unsigned>(ih) < static_cast<unsigned>(op.H) &&
                              static_cast<unsigned>(iw) < static_cast<unsigned>(op.W);
              const int8_t* src =
                  ok ? xb + (static_cast<size_t>(ih) * op.W + iw) * op.C + ci : op.x;
              const uint32_t row = a_tile(s) + pt * BK;
#pragma unroll
              for (int j = 0; j < BK / 16; ++j)
                cp_async16(row + (swizzle_chunk<BK>(pt, j) << 4), src + 16 * j, ok);
              cp_async_commit();
              // announce the previous gathered stage once its copies landed:
              // each thread keeps two stages of copies in flight
              if (pending >= 0) {
                cp_async_wait<1>();
                fence_async_shared();
                mbar_arrive(full(pending));
              }
              pending = s;
            }
            ci += BK;
            if (ci == op.C) {
              ci = 0;
              if (++kw == op.KW) {
                kw = 0;
                ++kh;
              }
            }
            advance();
          }
        }
        fetch_epilogue(m0, n0);
      }
      if (pending >= 0) {
        cp_async_wait<0>();
        fence_async_shared();
        mbar_arrive(full(pending));
      }
    }
  } else {
    // ---------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = tid >> 7, warp = tid >> 5, wq = warp & 3, lane = tid & 31;
    const int g = lane >> 2, t2 = (lane & 3) * 2;
    const bool lead = (tid & 127) == 0;
    int8_t* stg = smem + L::STG_OFF + warp * 16 * SPITCH;
    int s = 0, tcount = 0, prev = -1;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++tcount) {
      int m0, mlim, n0;
      if constexpr (STEM) {
        const int owb_n = (a.Wo + BM - 1) / BM;
        const int t2s = tile / owb_n, owb = tile - t2s * owb_n;
        m0 = t2s * a.Wo + owb * BM;
        mlim = min(BM, a.Wo - owb * BM);
        n0 = 0;
      } else {
        m0 = (tile / a.tiles_n) * BM;
        mlim = min(BM, a.M - m0);
        n0 = (tile % a.tiles_n) * BN;
      }
      int acc[NG][BN / 2];             // the first k-step overwrites (scale-d 0)
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int kts = STEM ? 2 : a.op[gi].kt;
        for (int kt = 0; kt < kts; ++kt) {
          mbar_wait(full(s), ph);
          const uint32_t at = a_tile(s) + wg * 64 * BK, bt = b_tile(s);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < BK / 32; ++k)
            Wgmma<BN>::run(acc[gi], smem_desc<BK>(at + 32 * k), smem_desc<BK>(bt + 32 * k),
                           kt > 0 || k > 0);
          wgmma_commit();
          wgmma_wait<1>();              // the stage before this one is read
          if (prev >= 0 && lead) mbar_arrive(empty(prev));
          prev = s;
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
      wgmma_wait<0>();
      if (lead) mbar_arrive(empty(prev));
      prev = -1;

      // epilogue: this warp's 16 rows through its staging rows, once the
      // tile's es / b (and shortcut tile) landed
      const int ej = tcount & 1;
      mbar_wait(ep_full(ej), (tcount >> 1) & 1);
      const float* par = reinterpret_cast<const float*>(smem + L::PAR_OFF) + ej * 4 * BN;
      const int rt = wg * 64 + wq * 16;              // first row in the tile
      const float* es0 = par;
      const float* b0 = par + BN;
      const float* es1 = par + 2 * BN;
      const float* b1 = par + 3 * BN;
      if (a.mode == MODE_ACC || a.mode == MODE_F32) {
        // 4-byte outputs, 64 columns at a time
#pragma unroll
        for (int c0 = 0; c0 < BN; c0 += 64) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = c0 / 8 + jj, col = 8 * j + t2;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int v0 = acc[0][4 * j + 2 * h], v1 = acc[0][4 * j + 2 * h + 1];
              int8_t* p = stg + (g + 8 * h) * SPITCH + (col - c0) * 4;
              if (a.mode == MODE_ACC)
                *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
              else
                *reinterpret_cast<float2*>(p) =
                    make_float2(dequant(v0, es0[col], b0[col]), dequant(v1, es0[col + 1], b0[col + 1]));
            }
          }
          if (c0 + 64 >= BN) mbar_arrive(ep_empty(ej));   // es / b read
          __syncwarp();
          for (int i = lane; i < 16 * 16; i += 32) {
            const int r = i >> 4, seg = i & 15;
            const int gc = n0 + c0 + seg * 4;
            if (rt + r < mlim && gc < a.N)
              *reinterpret_cast<int4*>(static_cast<int*>(a.out) +
                                       static_cast<size_t>(m0 + rt + r) * a.N + gc) =
                  *reinterpret_cast<const int4*>(stg + r * SPITCH + seg * 16);
          }
          __syncwarp();
        }
      } else {
        const int8_t* sct = smem + L::SC_OFF + ej * BM * BN;
        // the register phase, one specialization a shortcut kind (no branch
        // inside): 0 none, 1 the int8 tile, 2 float32 from global memory
        auto codes = [&](auto kind) {
          constexpr int SCK = decltype(kind)::value;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = 8 * j + t2;
            const float2 e = *reinterpret_cast<const float2*>(es0 + col);
            const float2 bb = *reinterpret_cast<const float2*>(b0 + col);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = g + 8 * h, tr = rt + r;
              float y0 = dequant(acc[0][4 * j + 2 * h], e.x, bb.x);
              float y1 = dequant(acc[0][4 * j + 2 * h + 1], e.y, bb.y);
              if constexpr (NG == 2) {    // y3 + yd: op[1] is conv3, op[0] the down conv
                const float2 e3 = *reinterpret_cast<const float2*>(es1 + col);
                const float2 b3 = *reinterpret_cast<const float2*>(b1 + col);
                y0 = __fadd_rn(dequant(acc[1][4 * j + 2 * h], e3.x, b3.x), y0);
                y1 = __fadd_rn(dequant(acc[1][4 * j + 2 * h + 1], e3.y, b3.y), y1);
              }
              if constexpr (SCK == 1) {
                const int cb = col % SB;
                const int off = (col / SB) * BM * SB + tr * SB +
                                ((swizzle_chunk<SB>(tr, cb >> 4) << 4) | (cb & 15));
                const int sv = *reinterpret_cast<const int16_t*>(sct + off);   // two codes
                y0 = __fadd_rn(y0, __fmul_rn(code_to_float(static_cast<int8_t>(sv)), a.a_x));
                y1 = __fadd_rn(y1, __fmul_rn(code_to_float(sv >> 8), a.a_x));
              } else if constexpr (SCK == 2) {
                if (tr < mlim && n0 + col < a.N) {
                  const float2 sv = *reinterpret_cast<const float2*>(
                      static_cast<const float*>(a.shortcut) +
                      static_cast<size_t>(m0 + tr) * a.N + n0 + col);
                  y0 = __fadd_rn(y0, sv.x);
                  y1 = __fadd_rn(y1, sv.y);
                }
              }
              *reinterpret_cast<uint16_t*>(stg + r * SPITCH + col) = static_cast<uint16_t>(
                  __byte_perm(requant_byte(y0, a.inv), requant_byte(y1, a.inv), 0x0040));
            }
          }
        };
        if (q8sc)
          codes(std::integral_constant<int, 1>());
        else if (a.mode == MODE_Q8_F32SC)
          codes(std::integral_constant<int, 2>());
        else
          codes(std::integral_constant<int, 0>());
        mbar_arrive(ep_empty(ej));      // es / b and the shortcut read
        __syncwarp();
        constexpr int SEGS = BN / 16;
        for (int i = lane; i < 16 * SEGS; i += 32) {
          const int r = i / SEGS, seg = i - r * SEGS;
          const int gc = n0 + seg * 16;
          if (rt + r < mlim && gc < a.N)
            *reinterpret_cast<int4*>(static_cast<int8_t*>(a.out) +
                                     static_cast<size_t>(m0 + rt + r) * a.N + gc) =
                *reinterpret_cast<const int4*>(stg + r * SPITCH + seg * 16);
        }
        __syncwarp();
      }
    }
  }
}

// cuTensorMapEncodeTiled, fetched once through the runtime's entry-point query
// (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) int8 matrix, row pitch cols bytes, boxes of box_cols x
// box_rows swizzled by box_cols (128 or 64) bytes; reads past it are zeros
int tensor_map(CUtensorMap* map, const void* ptr, long long rows, long long cols, int box_cols,
               int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || cols % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        box_cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a tile of BM output pixels as a box of bh output rows of Wo columns of bb
// images (whole rows of one image, or whole images), or false
bool box_tile(int Ho, int Wo, int* bh, int* bb) {
  const long long P = static_cast<long long>(Ho) * Wo;
  if (P % BM == 0 && BM % Wo == 0) {
    *bh = BM / Wo;
    *bb = 1;
  } else if (BM % P == 0) {
    *bh = Ho;
    *bb = static_cast<int>(BM / P);
  } else {
    return false;
  }
  return true;
}

// the A operand's load at a site of stride s whose output is Ho x Wo
int a_load(int KH, int stride, int Ho, int Wo) {
  int bh, bb;
  if (KH == 1 && stride == 1) return A_MATRIX;
  if (box_tile(Ho, Wo, &bh, &bb) && stride * Wo <= 256 && stride * bh <= 256) return A_BOX;
  return A_GATHER;
}

// x (B, H, W, C) int8 as a 4D map whose boxes are the BK channels of a box
// tile's pixels at stride s (traversal strides s along W and H)
int tensor_map_box(CUtensorMap* map, const void* x, int B, int H, int W, int C, int bk, int Ho,
                   int Wo, int s) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  int bh, bb;
  if (reinterpret_cast<uintptr_t>(x) % 16 || C % 16 || !box_tile(Ho, Wo, &bh, &bb))
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W) * C,
                                 static_cast<cuuint64_t>(H) * W * C};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bk), static_cast<cuuint32_t>(s * Wo),
                             static_cast<cuuint32_t>(s * bh), static_cast<cuuint32_t>(bb)};
  const cuuint32_t estr[4] = {1, static_cast<cuuint32_t>(s), static_cast<cuuint32_t>(s), 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides,
                        box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the stem's float32 images (B, H, W, 3) at element strides (sb, sh, 1, sc)
// as a 4D map (W, H, C, B) whose boxes are RAW_BOX columns of 7 rows of the
// 3 channels of one image; reads outside the images are zeros
int tensor_map_images(CUtensorMap* map, const float* img, int B, int H, int W, long long sb,
                      long long sh, long long sc) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H), 3,
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 4, static_cast<cuuint64_t>(sc) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {RAW_BOX, 7, 3, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(img), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 132;
}

// maps: w0, w1, x0, x1, shortcut (unused ones zero)
template <int BN, int BK, int NG, bool STEM>
int launch(const Args& a, const CUtensorMap (&maps)[5], cudaStream_t s) {
  auto kernel = int8_conv_wgmma_kernel<BN, BK, NG, STEM>;
  constexpr int smem = Layout<BN, BK, STEM>::BYTES;
  static unsigned long long attr_set = 0;       // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !(attr_set >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attr_set |= 1ull << dev;
  }
  const int grid = a.tiles < sm_count() ? a.tiles : sm_count();
  kernel<<<grid, THREADS, smem, s>>>(a, maps[0], maps[1], maps[2], maps[3], maps[4]);
  return static_cast<int>(cudaGetLastError());
}

// channels a wgmma tile: 64 where Cout is 64, else 128 (256 measured slower
// over an encode, with three ring stages: PERF.md)
int pick_bn(int N) { return N == 64 ? 64 : 128; }

// es and b are bulk-copied: 16-byte aligned
bool params_aligned(const void* es, const void* bias) {
  return reinterpret_cast<uintptr_t>(es) % 16 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
}

}  // namespace hop

// 3x3 / 2 max pool, padding 1, -128 outside the image (the port of the
// reduce_window at icek_tpu/models/resnet_int8.py:353).
//
// What bounds it: at the encode's (256, 128, 128, 64) it reads 268 MB and
// writes 67 MB, 0.100 ms at 3.35 TB/s; the comparisons (9 a byte, four bytes
// an instruction with __vmaxs4) are far below any compute limit.  So the
// design reads HBM once and spends few instructions a byte:
// * a block takes a strip of R output rows and WC output columns of one
//   image and stages the strip's 2 R + 1 input rows, each a segment of the
//   2 WC + 1 input columns those outputs see (whole rows of W * C bytes, 8
//   KB, at the encode, where WC is the image's width), in shared memory by
//   VB-byte cp.async; neighbouring strips share one row, so HBM (or L2) is
//   read (2 R + 1) / 2 R times;
// * a thread takes VB bytes (16: 16 channels; 4 where C % 16 != 0) of one
//   output pixel: nine VB-byte shared loads, __vmaxs4 on each 32-bit word,
//   one VB-byte store;
// * padding rows and columns are skipped, not staged: the running maximum
//   starts at -128, the int8 identity of JAX's reduce_window.
// A staged segment starts at input column 2 ow0 - 1 (ow0 the block's first
// output column; column -1 is padding and its slot is never written).
template <int VB>
__global__ void __launch_bounds__(256) maxpool_strip_kernel(
    const int8_t* __restrict__ x, int8_t* __restrict__ out, int H, int W, int C, int Ho,
    int Wo, int R, int WC) {
  extern __shared__ __align__(16) unsigned char rows_s[];
  const int b = blockIdx.y, oh0 = blockIdx.x * R, ow0 = blockIdx.z * WC;
  const int nr = min(R, Ho - oh0), nc = min(WC, Wo - ow0);
  const int ih0 = 2 * oh0 - 1, iw0 = 2 * ow0 - 1;   // the first staged row, column
  const int segb = (2 * WC + 1) * C;                // a staged row's pitch in bytes
  // the columns read from the image, [cw0, cw1], and their place in a segment
  const int cw0 = max(iw0, 0), cw1 = min(2 * (ow0 + nc) - 1, W - 1);
  const int cpr = (cw1 - cw0 + 1) * C / VB, off = (cw0 - iw0) * C;
  const int8_t* img = x + ((long long)b * H * W + cw0) * C;
  for (int e = threadIdx.x; e < (2 * nr + 1) * cpr; e += blockDim.x) {
    const int r = e / cpr, ih = ih0 + r;
    if (ih < 0 || ih >= H) continue;
    const int piece = VB * (e - r * cpr);
    const uint32_t dst = smem_u32(rows_s + r * segb + off + piece);
    const int8_t* src = img + (long long)ih * W * C + piece;
    if constexpr (VB == 16) {
      cp_async16(dst, src, true);
    } else {
      cp_async4(dst, src, true);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  constexpr int WORDS = VB / 4;
  const int cpp = C / VB;                       // VB-byte pieces a pixel
  for (int e = threadIdx.x; e < nr * nc * cpp; e += blockDim.x) {
    const int pix = e / cpp, c = e - pix * cpp;
    const int r = pix / nc, owl = pix - r * nc, ow = ow0 + owl;
    uint32_t m[WORDS];
#pragma unroll
    for (int i = 0; i < WORDS; ++i) m[i] = 0x80808080u;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int ih = ih0 + 2 * r + dh;
      if (ih < 0 || ih >= H) continue;
      const unsigned char* row = rows_s + (2 * r + dh) * segb + c * VB;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const int iw = 2 * ow - 1 + dw;
        if (iw < 0 || iw >= W) continue;
        const unsigned char* p = row + (2 * owl + dw) * C;
        if constexpr (VB == 16) {
          const uint4 v = *reinterpret_cast<const uint4*>(p);
          m[0] = __vmaxs4(m[0], v.x);
          m[1] = __vmaxs4(m[1], v.y);
          m[2] = __vmaxs4(m[2], v.z);
          m[3] = __vmaxs4(m[3], v.w);
        } else {
          m[0] = __vmaxs4(m[0], *reinterpret_cast<const uint32_t*>(p));
        }
      }
    }
    int8_t* o = out + (((long long)b * Ho + oh0 + r) * Wo + ow) * C + c * VB;
    if constexpr (VB == 16) {
      *reinterpret_cast<uint4*>(o) = make_uint4(m[0], m[1], m[2], m[3]);
    } else {
      *reinterpret_cast<uint32_t*>(o) = m[0];
    }
  }
}

// the wgmma kernel's launch of one site (kt k-stages of BK bytes; A by TMA
// at a 1x1 / 1 site)
template <int BK>
int launch_site(hop::Args& h, const void* w, const void* x, int B, int H, int W, int C, int N,
                int Kpad, int bn, cudaStream_t s) {
  const hop::Operand& op = h.op[0];
  CUtensorMap maps[5] = {};
  int err = hop::tensor_map(&maps[0], w, N, Kpad, BK, bn);
  if (!err && op.load == hop::A_MATRIX)
    err = hop::tensor_map(&maps[2], x, static_cast<long long>(B) * H * W, C, BK, hop::BM);
  if (!err && op.load == hop::A_BOX)
    err = hop::tensor_map_box(&maps[2], x, B, H, W, C, BK, h.Ho, h.Wo, op.stride);
  if (!err && h.mode == MODE_Q8_Q8SC)
    err = hop::tensor_map(&maps[4], h.shortcut, h.M, N, bn < 128 ? bn : 128, hop::BM);
  if (err) return err;
  return bn == 64 ? hop::launch<64, BK, 1, false>(h, maps, s)
                  : hop::launch<128, BK, 1, false>(h, maps, s);
}

}  // namespace

// The route int8_conv takes for a site of an H x W input: where C and N are
// multiples of 64 the wgmma kernel, its A tiles by TMA (ROUTE_TMA: as a
// matrix at a 1x1 / 1 site, ROUTE_TMA_BOX: as boxes where the tiles are
// whole rows or images) or gathered (ROUTE_GATHER); else ROUTE_MMA_SYNC
// (the mma.sync kernel).
ICEK_EXPORT int int8_conv_route(int C, int N, int KH, int KW, int stride, int H, int W) {
  if (C % 64 || N % 64 || KH != KW) return ROUTE_MMA_SYNC;
  const int pad = (KH - 1) / 2;
  const int Ho = (H + 2 * pad - KH) / stride + 1, Wo = (W + 2 * pad - KW) / stride + 1;
  const int load = hop::a_load(KH, stride, Ho, Wo);
  return load == hop::A_MATRIX ? ROUTE_TMA : load == hop::A_BOX ? ROUTE_TMA_BOX : ROUTE_GATHER;
}

// x (B, H, W, C) int8; w (N, Kpad) int8 with K = KH * KW * C taps in
// (kh, kw, ci) order, zeros past K; es, bias (N,) float32 (unread in
// MODE_ACC); shortcut (M, N) float32 (MODE_Q8_F32SC) or int8
// (MODE_Q8_Q8SC); out (M, N), M = B * Ho * Wo.  Needs C % 64 == 0, or
// C % 4 == 0 (4-byte copies, the stem); N % 8 == 0; Kpad % 64 == 0 and
// Kpad >= K; every pointer 16-byte aligned.  The route is
// int8_conv_route's.
ICEK_EXPORT int int8_conv(const void* x, const void* w, const void* es,
                          const void* bias, const void* shortcut, void* out, float a_x,
                          float inv, int B, int H, int W, int C, int N, int KH, int KW,
                          int stride, int pad, int Kpad, int mode, void* stream) {
  const int K = KH * KW * C;
  const int Ho = (H + 2 * pad - KH) / stride + 1, Wo = (W + 2 * pad - KW) / stride + 1;
  const long long M = (long long)B * Ho * Wo;
  const bool generic = C % 64 != 0;
  if (B < 1 || Ho < 1 || Wo < 1 || N < 8 || N % 8 || C % 4 || Kpad % mma::BK ||
      Kpad < K || (!generic && Kpad != K) || mode < MODE_F32 || mode > MODE_ACC ||
      M > INT_MAX || (long long)B * H * W * C > INT_MAX * 4LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int route = KH == KW && pad == (KH - 1) / 2
                        ? int8_conv_route(C, N, KH, KW, stride, H, W) : ROUTE_MMA_SYNC;
  if (route == ROUTE_MMA_SYNC) {
    mma::ConvArgs a;
    a.x = static_cast<const int8_t*>(x);
    a.w = static_cast<const int8_t*>(w);
    a.es = static_cast<const float*>(es);
    a.bias = static_cast<const float*>(bias);
    a.shortcut = shortcut;
    a.out = out;
    a.a_x = a_x;
    a.inv = inv;
    a.B = B; a.H = H; a.W = W; a.C = C; a.N = N; a.KW = KW;
    a.stride = stride; a.pad = pad; a.Kpad = Kpad; a.mode = mode;
    a.K = K; a.Ho = Ho; a.Wo = Wo;
    a.M = static_cast<int>(M);
    const bool wide = N % 128 == 0;
    if (generic) return wide ? mma::launch<128, true>(a, s) : mma::launch<64, true>(a, s);
    return wide ? mma::launch<128, false>(a, s) : mma::launch<64, false>(a, s);
  }
  const int BK = C % 128 ? 64 : 128;
  hop::Args h = {};
  h.op[0] = {static_cast<const int8_t*>(x), static_cast<const float*>(es),
             static_cast<const float*>(bias), H, W, C, KW, stride, pad, K / BK,
             hop::a_load(KH, stride, Ho, Wo)};
  h.shortcut = shortcut;
  h.out = out;
  h.a_x = a_x;
  h.inv = inv;
  h.M = static_cast<int>(M);
  h.N = N;
  h.Ho = Ho;
  h.Wo = Wo;
  h.mode = mode;
  const int bn = hop::pick_bn(N);
  if (mode != MODE_ACC && !hop::params_aligned(es, bias))
    return static_cast<int>(cudaErrorMisalignedAddress);
  h.tiles_n = (N + bn - 1) / bn;
  const long long tiles = (M + hop::BM - 1) / hop::BM * h.tiles_n;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  h.tiles = static_cast<int>(tiles);
  return BK == 128 ? launch_site<128>(h, w, x, B, H, W, C, N, Kpad, bn, s)
                   : launch_site<64>(h, w, x, B, H, W, C, N, Kpad, bn, s);
}

// A bottleneck's block 0 in one launch: out = q(conv3(y) + down(x)) with
// conv3 1x1 / 1 over y (B, Ho, Wo, Cmid) and the down convolution 1x1 /
// stride over x (B, H, W, Cin), Ho = (H - 1) / stride + 1; wd (N, Cin), w3
// (N, Cmid) int8; esd, bd, es3, b3 (N,) float32; out (B, Ho, Wo, N) int8.
// Needs Cin, Cmid and N multiples of 64, 16-byte aligned pointers.
ICEK_EXPORT int int8_conv_fused(const void* x, const void* wd, const void* esd, const void* bd,
                                const void* y, const void* w3, const void* es3, const void* b3,
                                void* out, float inv, int B, int H, int W, int Cin, int Cmid,
                                int N, int stride, void* stream) {
  if (B < 1 || H < 1 || W < 1 || stride < 1 || Cin % 64 || Cmid % 64 || N % 64 || Cin < 64 ||
      Cmid < 64 || N < 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const long long M = (long long)B * Ho * Wo;
  if (M > INT_MAX || (long long)B * H * W > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int BK = Cin % 128 || Cmid % 128 ? 64 : 128, BN = 128;
  if (!hop::params_aligned(esd, bd) || !hop::params_aligned(es3, b3))
    return static_cast<int>(cudaErrorMisalignedAddress);
  hop::Args h = {};
  h.op[0] = {static_cast<const int8_t*>(x), static_cast<const float*>(esd),
             static_cast<const float*>(bd), H, W, Cin, 1, stride, 0, Cin / BK,
             hop::a_load(1, stride, Ho, Wo)};
  h.op[1] = {static_cast<const int8_t*>(y), static_cast<const float*>(es3),
             static_cast<const float*>(b3), Ho, Wo, Cmid, 1, 1, 0, Cmid / BK, hop::A_MATRIX};
  h.out = out;
  h.inv = inv;
  h.M = static_cast<int>(M);
  h.N = N;
  h.Ho = Ho;
  h.Wo = Wo;
  h.mode = MODE_Q8;
  h.tiles_n = (N + BN - 1) / BN;
  const long long tiles = (M + hop::BM - 1) / hop::BM * h.tiles_n;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  h.tiles = static_cast<int>(tiles);
  CUtensorMap maps[5] = {};
  int err = hop::tensor_map(&maps[0], wd, N, Cin, BK, BN);
  if (!err) err = hop::tensor_map(&maps[1], w3, N, Cmid, BK, BN);
  if (!err && h.op[0].load == hop::A_MATRIX) err = hop::tensor_map(&maps[2], x, M, Cin, BK, hop::BM);
  if (!err && h.op[0].load == hop::A_BOX)
    err = hop::tensor_map_box(&maps[2], x, B, H, W, Cin, BK, Ho, Wo, stride);
  if (!err) err = hop::tensor_map(&maps[3], y, M, Cmid, BK, hop::BM);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return BK == 128 ? hop::launch<128, 128, 2, false>(h, maps, s)
                   : hop::launch<128, 64, 2, false>(h, maps, s);
}

// The stem from the normalized float32 images: img (B, H, W, 3) at element
// strides (sb, sh, sw, sc), quantized in the kernel as clamp(rint(x *
// inv_img), -127, 127); the 7x7 / 2 convolution, padding 3, by w (64, 256)
// int8 with k = 32 kh + 3 kw + ci (zeros elsewhere); es, bias (64,); out
// (B, Ho, Wo, 64) int8 codes at inv (MODE_Q8) or int32 sums (MODE_ACC).
ICEK_EXPORT int int8_stem(const void* img, long long sb, long long sh, long long sw,
                          long long sc, const void* w, const void* es, const void* bias,
                          void* out, float inv_img, float inv, int B, int H, int W, int N,
                          int mode, void* stream) {
  if (B < 1 || H < 1 || W < 1 || N != 64 || (mode != MODE_Q8 && mode != MODE_ACC))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != MODE_ACC && !hop::params_aligned(es, bias))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long M = (long long)B * Ho * Wo;
  const long long tiles = (long long)B * Ho * ((Wo + hop::BM - 1) / hop::BM);
  if (M > INT_MAX || tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  hop::Args h = {};
  h.op[0] = {nullptr, static_cast<const float*>(es), static_cast<const float*>(bias), H, W, 3,
             7, 2, 3, 2, hop::A_GATHER};
  h.img = static_cast<const float*>(img);
  h.sb = sb;
  h.sh = sh;
  h.sw = sw;
  h.sc = sc;
  h.out = out;
  h.inv = inv;
  h.inv_img = inv_img;
  h.M = static_cast<int>(M);
  h.N = N;
  h.Ho = Ho;
  h.Wo = Wo;
  h.mode = mode;
  h.tiles_n = 1;
  h.tiles = static_cast<int>(tiles);
  CUtensorMap maps[5] = {};
  const int err = hop::tensor_map(&maps[0], w, N, 256, 128, 64);
  if (err) return err;
  // planar images with 16-byte rows (normalize_in_graph's view): the raw
  // patch by TMA; otherwise by the producer's copies
  h.raw_tma = sw == 1 && W % 4 == 0 && sh == W && sc == static_cast<long long>(H) * W &&
              sb == 3LL * H * W && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
              hop::tensor_map_images(&maps[2], static_cast<const float*>(img), B, H, W, sb, sh,
                                     sc) == 0;
  return hop::launch<64, 128, 1, true>(h, maps, static_cast<cudaStream_t>(stream));
}

// x (B, H, W, C) int8 -> out (B, Ho, Wo, C) int8, Ho = (H - 1) / 2 + 1;
// C % 4 == 0 and C <= POOL_MAX_C, both pointers 16-byte aligned (torch's
// allocations are); the strip kernel (16 bytes a copy and a thread where C %
// 16 == 0, else 4)
constexpr int POOL_SMEM = 96 * 1024;   // a strip's rows: two blocks an SM at the encode
constexpr int POOL_MAX_C = (POOL_SMEM / 3 / 3) / 4 * 4;   // three rows of one output pixel

ICEK_EXPORT int int8_maxpool(const void* x, void* out, int B, int H, int W, int C,
                             void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 4 || C % 4 || C > POOL_MAX_C || B > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  // whole rows where three fit, else the widest segments that do
  int WC = Wo;
  if (3LL * (2LL * Wo + 1) * C > POOL_SMEM) WC = (POOL_SMEM / (3 * C) - 1) / 2;
  const int chunks = (Wo + WC - 1) / WC;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int segb = (2 * WC + 1) * C;
  int R = 8;
  while (R > 1 && (2 * R + 1) * segb > POOL_SMEM) --R;
  if (R > Ho) R = Ho;
  const int smem = (2 * R + 1) * segb;
  auto kernel = C % 16 ? &maxpool_strip_kernel<4> : &maxpool_strip_kernel<16>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3((Ho + R - 1) / R, B, chunks), 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), H, W, C, Ho, Wo, R, WC);
  return static_cast<int>(cudaGetLastError());
}
