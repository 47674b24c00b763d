// int8 convolution with its epilogue, and the int8 max pool, for Hopper
// (sm_90a): the sites of the int8 ResNet-101 encoder.
//
// Replaces what XLA compiled for icek_tpu/models/resnet_int8.py (no Pallas
// kernel): _qconv (:73), lax.conv_general_dilated of int8 NHWC activations
// and int8 HWIO weights into int32, with the elementwise epilogue XLA fuses
// into it (_site_out :330, the residual add, _requant_relu :68), and the
// stem's int8 max pool (reduce_window with a -128 identity, :353).
//
// The convolution is an implicit GEMM: C[m, n] = sum_k A[m, k] B[k, n] with
// m = (b, oh, ow) an output pixel, n = co an output channel and k = (kh,
// kw, ci) a tap and input channel.  A is never materialised: a block's
// loader computes, for each of its rows, the input pixel a tap reads and
// copies 16 bytes of channels (4 for the stem) from the NHWC activations
// into shared memory by cp.async, zeros where the tap falls in the padding.
// B is the weight as (Cout, Kpad) int8, k-contiguous (OHWI, K padded with
// zeros to a multiple of 64), the "col" operand of mma.sync.
//
// What bounds it: operations.  Above the stem a site does 2 K operations a
// byte of output it writes (K = 64 to 4608), far above the card's 590
// int8 operations a byte of memory traffic.  This first version runs
// mma.sync m16n8k32 (s8 x s8 -> s32) on tiles of 128 rows x 64 or 128
// channels x 64 taps, three stages of cp.async in flight, operands read
// from shared memory with 32-bit loads (rows padded to 80 bytes, so the
// eight rows a fragment load touches fall in distinct banks).  Hopper's
// wgmma and TMA would reach more of the int8 rate: later work.
//
// Epilogue, per element, in the plain version's order with no contraction
// (__fmul_rn / __fadd_rn) and round half to even (__float2int_rn), so its
// int8 codes equal the plain version's bit for bit:
//   y = float(acc) * es[n] + b[n]
//   MODE_F32      out = y                      (float32; the down conv)
//   MODE_Q8       out = q(y)
//   MODE_Q8_F32SC out = q(y + shortcut_f32)    (conv3 after a down conv)
//   MODE_Q8_Q8SC  out = q(y + float(xq) * a_x) (conv3, identity shortcut)
//   MODE_ACC      out = acc                    (int32; no epilogue)
// with q(v) = clamp(rint(max(v, 0) * inv), 0, 127) as int8.
#include "common.cuh"

namespace {

constexpr int BM = 128;          // output pixels a block
constexpr int BK = 64;           // k (bytes) a stage
constexpr int LDS = BK + 16;     // shared row pitch in bytes
constexpr int STAGES = 3;
constexpr int THREADS = 256;     // 8 warps: 4 along m x 2 along n

enum Mode { MODE_F32 = 0, MODE_Q8 = 1, MODE_Q8_F32SC = 2, MODE_Q8_Q8SC = 3, MODE_ACC = 4 };

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

__device__ __forceinline__ int requant(float y, float inv) {
  const int q = __float2int_rn(__fmul_rn(fmaxf(y, 0.0f), inv));
  return min(max(q, 0), 127);
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

// 3x3 / 2 max pool, padding 1, -128 outside the image; 4 channels a thread
__global__ void maxpool_kernel(const char4* __restrict__ x, char4* __restrict__ out,
                               int B, int H, int W, int C4, int Ho, int Wo) {
  const long long total = (long long)B * Ho * Wo * C4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = static_cast<int>(i % C4);
    long long r = i / C4;
    const int ow = static_cast<int>(r % Wo);
    r /= Wo;
    const int oh = static_cast<int>(r % Ho);
    const int b = static_cast<int>(r / Ho);
    int m0 = -128, m1 = -128, m2 = -128, m3 = -128;
    for (int dh = 0; dh < 3; ++dh) {
      const int ih = oh * 2 - 1 + dh;
      if (ih < 0 || ih >= H) continue;
      for (int dw = 0; dw < 3; ++dw) {
        const int iw = ow * 2 - 1 + dw;
        if (iw < 0 || iw >= W) continue;
        const char4 v = x[(((long long)b * H + ih) * W + iw) * C4 + c];
        m0 = max(m0, (int)v.x);
        m1 = max(m1, (int)v.y);
        m2 = max(m2, (int)v.z);
        m3 = max(m3, (int)v.w);
      }
    }
    out[i] = make_char4(static_cast<signed char>(m0), static_cast<signed char>(m1),
                        static_cast<signed char>(m2), static_cast<signed char>(m3));
  }
}

}  // namespace

// x (B, H, W, C) int8; w (N, Kpad) int8 with K = KH * KW * C taps in
// (kh, kw, ci) order, zeros past K; es, bias (N,) float32 (unread in
// MODE_ACC); shortcut (M, N) float32 (MODE_Q8_F32SC) or int8
// (MODE_Q8_Q8SC); out (M, N), M = B * Ho * Wo.  Needs C % 64 == 0, or
// C % 4 == 0 (4-byte copies, the stem); N % 8 == 0; Kpad % 64 == 0 and
// Kpad >= K; every pointer 16-byte aligned.
ICEK_EXPORT int int8_conv(const void* x, const void* w, const void* es,
                          const void* bias, const void* shortcut, void* out, float a_x,
                          float inv, int B, int H, int W, int C, int N, int KH, int KW,
                          int stride, int pad, int Kpad, int mode, void* stream) {
  ConvArgs a;
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
  a.K = KH * KW * C;
  a.Ho = (H + 2 * pad - KH) / stride + 1;
  a.Wo = (W + 2 * pad - KW) / stride + 1;
  const long long M = (long long)B * a.Ho * a.Wo;
  const bool generic = C % 64 != 0;
  if (B < 1 || a.Ho < 1 || a.Wo < 1 || N < 8 || N % 8 || C % 4 || Kpad % BK ||
      Kpad < a.K || (!generic && Kpad != a.K) || mode < MODE_F32 || mode > MODE_ACC ||
      M > INT_MAX || (long long)B * H * W * C > INT_MAX * 4LL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.M = static_cast<int>(M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = N % 128 == 0;
  if (generic) return wide ? launch<128, true>(a, s) : launch<64, true>(a, s);
  return wide ? launch<128, false>(a, s) : launch<64, false>(a, s);
}

// x (B, H, W, C) int8 -> out (B, Ho, Wo, C) int8, Ho = (H - 1) / 2 + 1;
// C % 4 == 0, both pointers 4-byte aligned
ICEK_EXPORT int int8_maxpool(const void* x, void* out, int B, int H, int W, int C,
                             void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 4 || C % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long total = (long long)B * Ho * Wo * (C / 4);
  long long blocks = (total + 255) / 256;
  if (blocks > 65536) blocks = 65536;
  maxpool_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(x), static_cast<char4*>(out), B, H, W, C / 4, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}
