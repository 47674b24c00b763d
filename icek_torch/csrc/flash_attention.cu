// Flash attention for Hopper (sm_90a), forward and backward, f32 and bf16.
//
// Replaces icek_tpu/kernels/flash_attention.py::_flash_fwd and ::_flash_bwd
// (the Pallas kernels behind flash_mha_packed):
//   P  = softmax(Q K^T / sqrt(Hd), keys >= kv_len masked, optional causal)
//   O  = dropout(P) V                      (attention-weight dropout)
//   dV = dropout(P)^T dO,  dP = dropout'(dO V^T),
//   dS = P * (dP - rowsum(dP * P)),  dQ = dS K / sqrt(Hd),  dK = dS^T Q / sqrt(Hd)
// with float32 softmax and accumulation; dropout(P) and dS are rounded to
// the working dtype before their second product, as the TPU kernel does.
//
// Layout: q, k, v are (B, T, H, Hd) with the head dim contiguous, heads
// adjacent (head stride Hd) and free batch / time strides, so the three
// slices of one fused QKV projection go in without a copy.  The TPU head
// slot packing and lane padding are not carried over.  o, dO, dq, dk, dv are
// contiguous (B, T, H, Hd).  The forward also writes each row's logsumexp,
// so the backward never reruns the online softmax, and the backward is two
// kernels with no atomics (dQ, which also writes delta = rowsum(dO * O),
// then dK/dV), so its result is the same from run to run.
//
// What bounds it: at the geo context encoder (B=256, T=301, H=10, Hd=30)
// the forward moves ~185 MB in bf16 (q, k, v read once, o written once:
// ~55 us at 3.35 TB/s) and does 4 * 2560 * 301^2 * 30 = 27.8 GFLOP (29.7 at
// the padded width: ~30 us at the bf16 tensor-core peak, 0.44 ms on the
// f32 CUDA cores), plus 232 M exponentials and, with dropout, one Philox
// block per four scores.  The backward moves seven such tensors and does
// five such products.  So in bf16 the card's bound is memory, and the
// products must run on the tensor cores to get anywhere near it.  What the
// tensor-core kernels below are bound by in the end is the number of
// instructions a tile takes (the softmax, the staging and, with dropout,
// Philox), not the matrix unit.
//
// Two families of kernels live here.
//
// 1. The tensor-core kernels (flash_*_mma_kernel): bf16 with an even Hd <=
//    32 and 4-byte aligned head rows, which is every attention of the
//    presets (10 heads of Hd 30).
//    * Alignment.  A head's row is 30 bf16 = 60 bytes at h * 60 bytes
//      inside a row of 600 bytes; a fused-QKV view has a row stride of 1800
//      bytes and starts 600 or 1200 bytes into its buffer.  Global
//      addresses are therefore 4-byte aligned and no more: 16-byte vector
//      loads, 16-byte cp.async and TMA (16-byte aligned addresses and
//      strides) are all out.  Every global access here is one 32-bit word
//      (a bf16 pair), 15 per head row, lanes on neighbouring words; tiles
//      are staged with 4-byte cp.async, whose zero-fill form also writes
//      the pad word (Hd 30 -> 32) and the rows past the end, so the pad
//      lanes exist in shared memory and registers only.
//    * Products.  mma.sync.m16n8k16 (bf16 in, f32 out), Hd padded to 32 =
//      two k-steps.  A warp owns 16 rows; their operand fragments come
//      straight from global memory into 8 registers.  The other operand is
//      staged in shared memory as bf16, 64 rows a tile with an 80-byte row
//      pitch (20 words: the eight rows of an ldmatrix phase fall on
//      distinct banks), double-buffered so the next tile loads under this
//      tile's products.  K as stored is already the B operand of S = Q K^T
//      and V of dP = dO V^T (plain ldmatrix); V in O = P V and K in dQ =
//      dS K are read through ldmatrix.trans.  Two neighbouring accumulator
//      tiles rounded to bf16 are one A fragment, so P and dS go from the
//      softmax into their second product without touching shared memory.
//      wgmma was not taken: it wants 64-row tiles and swizzled operands,
//      two of the three sites have 32 query rows, and the kernels are not
//      bound by the matrix unit.
//    * Forward and dQ: a block of four warps (two when Tq <= 32) walks the
//      key tiles; whole tiles beyond kv_len or above the causal diagonal
//      are skipped, the straddling tile is masked element-wise.  The online
//      softmax lives in the log2 domain (one FFMA and one ex2 a score) and
//      reduces over the four lanes of a quad.
//    * dK/dV: a warp owns 16 keys and computes the transposed scores S^T =
//      K Q^T and dP^T = V dO^T over staged query tiles, so P^T and dS^T are
//      again A fragments for dV += P^T dO and dK += dS^T Q.
//    * The scale 1/sqrt(Hd) multiplies S in the f32 accumulator (folded
//      with log2 e into the exponent's FFMA), not the bf16 Q fragment: no
//      extra rounding, and no extra instruction either.
//    * Dropout.  The mask is a function of the score's position only (see
//      below).  In the forward the two lanes that together hold four
//      neighbouring keys of a row compute one Philox block each and trade
//      words by shuffle: one block per four scores, which is still the
//      largest single cost of a dropout launch (about 0.25 ms at the
//      encoder site).  The backward therefore does not regenerate it: the
//      forward saves its keep flags, one bit a score (keep_cell), and the
//      dQ and dK/dV kernels read them back.  Rate 0 is a template parameter
//      of all three kernels: those instantiations carry no mask code.
//
// 2. The CUDA-core kernels (flash_fwd_kernel, flash_bwd_dq_kernel,
//    flash_bwd_dkv_kernel): f32 at any supported head dim (the tensor cores
//    take f32 only as TF32, about three decimal digits), bf16 with Hd in
//    (32, 128] (forward, rate 0) and bf16 inputs that miss the alignment
//    above.  One thread owns a query row (or key row) with its operands in
//    registers and the dot products run in f32, one shared-memory operand
//    per FMA; Hd is padded to a compile-time bound (32 / 64 / 128).
//
// Dropout mask: score (b, h, q, k) keeps iff keep_bits(random_bits(seed,
// STREAM_FLASH, ((b * H + h) * Tq + q) * Tk4 + k)) with Tk4 = Tk rounded up
// to a multiple of 4: the element's absolute position, so every kernel
// can regenerate the forward's mask under its own tiling (the CUDA-core
// backward and keep_mask_kernel do), and four adjacent keys of a row share
// one Philox block.  `block0` (4 * block0 added to every index) places a
// call's batch rows inside a larger batch: a data-parallel rank holding rows
// b0.. of a global batch passes block0 = b0 * H * Tq * Tk4 / 4 and draws the
// global batch's mask.
#include "common.cuh"

namespace {

// the arguments every kernel here shares
struct Shape {
  int Tq, Tk, H, Hd;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;   // batch / time strides
  int kv_len, causal;
  float scale;                                    // 1 / sqrt(Hd)
  float inv;                                      // 1 / (1 - rate)
  uint32_t thresh, seed;                          // dropout: see keep_bits
  unsigned long long block0;                      // Philox block of score (0, 0, 0, 0)
};

// Philox block of key 0 of score row (b, h, row); key k adds k / 4
__device__ __forceinline__ unsigned long long mask_row_block(const Shape& a, int b,
                                                             int h, int row) {
  return a.block0 + ((unsigned long long)(b * a.H + h) * a.Tq + row) * ((a.Tk + 3) >> 2);
}

// stage rows [k0, k0 + BK) of head h of k and v into shared memory as f32
template <typename T, int HD, int BK, int NT>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k,
                                         const T* __restrict__ v, const Shape& a,
                                         int b, int h, int k0, float (*ks)[HD],
                                         float (*vs)[HD]) {
  for (int e = threadIdx.x; e < BK * HD; e += NT) {
    const int j = e / HD, d = e % HD, t = k0 + j;
    float kv = 0.f, vv = 0.f;
    if (t < a.Tk && d < a.Hd) {
      kv = to_f32(k[b * a.k_sb + (long long)t * a.k_st + (long long)h * a.Hd + d]);
      vv = to_f32(v[b * a.v_sb + (long long)t * a.v_st + (long long)h * a.Hd + d]);
    }
    ks[j][d] = kv;
    vs[j][d] = vv;
  }
}

// DROP is a template parameter so that the rate-0 forward (the serving
// path) carries no Philox code or registers.
template <typename T, int HD, int BQ, int BK, bool DROP>
__global__ void __launch_bounds__(BQ) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, const Shape a) {
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool active = row < a.Tq;

  float qr[HD];
  float acc[HD];
  const T* qp = q + b * a.q_sb + (long long)row * a.q_st + (long long)h * a.Hd;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = (active && d < a.Hd) ? to_f32(qp[d]) * a.scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  // keys this row may see: [0, row_end); keys this block may see: [0, blk_end)
  const int row_end = a.causal ? min(a.kv_len, row + 1) : a.kv_len;
  const int blk_end = a.causal ? min(a.kv_len, (int)(blockIdx.x + 1) * BQ) : a.kv_len;
  const unsigned long long mrow = DROP ? mask_row_block(a, b, h, row) : 0ull;

  for (int k0 = 0; k0 < blk_end; k0 += BK) {
    __syncthreads();
    stage_kv<T, HD, BK, BQ>(k, v, a, b, h, k0, ks, vs);
    __syncthreads();
    if (!active || k0 >= row_end) continue;
    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      s[j] = (k0 + j < row_end) ? dot : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);  // finite: key k0 < row_end is valid
    const float alpha = __expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j4 = 0; j4 < BK; j4 += 4) {
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (DROP) r = philox4x32_10(a.seed, STREAM_FLASH, mrow + ((k0 + j4) >> 2));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j4 + c;
        const float p = __expf(s[j] - m_new);  // masked: exp(-inf) = 0
        l += p;                                // the softmax sum takes every key
        const float pd = (!DROP || keep_bits(word_of(r, c), a.thresh)) ? p : 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(pd, vs[j][d], acc[d]);
      }
    }
    m = m_new;
  }
  if (active) {
    const float inv = a.inv / l;
    T* op = o + (((long long)b * a.Tq + row) * a.H + h) * a.Hd;
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if (d < a.Hd) op[d] = from_f32<T>(acc[d] * inv);
    lse[((long long)b * a.H + h) * a.Tq + row] = m + logf(l);
  }
}

// dQ, and delta = rowsum(dO * O) for the dK/dV kernel.  Same shape as the
// forward: a thread owns one query row.
template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(BQ) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ d_o,
    const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
    const Shape a) {
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool active = row < a.Tq;
  const bool drop = a.thresh < KEEP_ALL;

  float qr[HD], dor[HD], acc[HD];
  const T* qp = q + b * a.q_sb + (long long)row * a.q_st + (long long)h * a.Hd;
  const long long orow = (((long long)b * a.Tq + row) * a.H + h) * a.Hd;
  const long long srow = ((long long)b * a.H + h) * a.Tq + row;
  float dl = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    const bool in = active && d < a.Hd;
    qr[d] = in ? to_f32(qp[d]) * a.scale : 0.f;
    dor[d] = in ? to_f32(d_o[orow + d]) : 0.f;
    dl = fmaf(dor[d], in ? to_f32(o[orow + d]) : 0.f, dl);
    acc[d] = 0.f;
  }
  const float L = active ? lse[srow] : 0.f;
  if (active) delta[srow] = dl;
  const int row_end = a.causal ? min(a.kv_len, row + 1) : a.kv_len;
  const int blk_end = a.causal ? min(a.kv_len, (int)(blockIdx.x + 1) * BQ) : a.kv_len;
  const unsigned long long mrow = mask_row_block(a, b, h, row);

  for (int k0 = 0; k0 < blk_end; k0 += BK) {
    __syncthreads();
    stage_kv<T, HD, BK, BQ>(k, v, a, b, h, k0, ks, vs);
    __syncthreads();
    if (!active || k0 >= row_end) continue;
#pragma unroll
    for (int j4 = 0; j4 < BK; j4 += 4) {
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (drop) r = philox4x32_10(a.seed, STREAM_FLASH, mrow + ((k0 + j4) >> 2));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j4 + c;
        if (k0 + j >= row_end) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          s = fmaf(qr[d], ks[j][d], s);
          dp = fmaf(dor[d], vs[j][d], dp);
        }
        const float p = __expf(s - L);
        if (drop) dp = keep_bits(word_of(r, c), a.thresh) ? dp * a.inv : 0.f;
        const float ds = round_to<T>(p * (dp - dl));
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if (d < a.Hd) dq[orow + d] = from_f32<T>(acc[d] * a.scale);
  }
}

// dK and dV.  A block owns BKT keys of one (batch, head), a thread one key
// row; query tiles of BQT rows (q pre-scaled, dO, lse, delta) pass through
// shared memory.  Keys at or beyond kv_len and causally hidden pairs add
// exactly zero.
template <typename T, int HD, int BKT, int BQT>
__global__ void __launch_bounds__(BKT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const Shape a) {
  static_assert(BKT % BQT == 0, "a causal block starts on a query-tile boundary");
  __shared__ float qs[BQT][HD];
  __shared__ float dos[BQT][HD];
  __shared__ float ls[BQT];
  __shared__ float dls[BQT];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = blockIdx.x * BKT + threadIdx.x;
  const bool key_active = t < a.kv_len;
  const bool drop = a.thresh < KEEP_ALL;
  const int Tk4 = (a.Tk + 3) & ~3;

  float kr[HD], vr[HD], dkr[HD], dvr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    const bool in = t < a.Tk && d < a.Hd;
    kr[d] = in ? to_f32(k[b * a.k_sb + (long long)t * a.k_st + (long long)h * a.Hd + d]) : 0.f;
    vr[d] = in ? to_f32(v[b * a.v_sb + (long long)t * a.v_st + (long long)h * a.Hd + d]) : 0.f;
    dkr[d] = dvr[d] = 0.f;
  }
  const long long srow0 = ((long long)b * a.H + h) * a.Tq;

  for (int q0 = a.causal ? blockIdx.x * BKT : 0; q0 < a.Tq; q0 += BQT) {
    __syncthreads();
    for (int e = threadIdx.x; e < BQT * HD; e += BKT) {
      const int i = e / HD, d = e % HD, qi = q0 + i;
      float qv = 0.f, gv = 0.f;
      if (qi < a.Tq && d < a.Hd) {
        qv = to_f32(q[b * a.q_sb + (long long)qi * a.q_st + (long long)h * a.Hd + d]) * a.scale;
        gv = to_f32(d_o[(((long long)b * a.Tq + qi) * a.H + h) * a.Hd + d]);
      }
      qs[i][d] = qv;
      dos[i][d] = gv;
    }
    for (int i = threadIdx.x; i < BQT; i += BKT) {
      const bool in = q0 + i < a.Tq;
      ls[i] = in ? lse[srow0 + q0 + i] : 0.f;
      dls[i] = in ? delta[srow0 + q0 + i] : 0.f;
    }
    __syncthreads();
    if (!key_active) continue;
    const int n = min(BQT, a.Tq - q0);
    for (int i = 0; i < n; ++i) {
      const int qi = q0 + i;
      if (a.causal && t > qi) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s = fmaf(kr[d], qs[i][d], s);
        dp = fmaf(vr[d], dos[i][d], dp);
      }
      const float p = __expf(s - ls[i]);
      float pd = p;
      if (drop) {
        const bool keep = keep_bits(
            random_bits(a.seed, STREAM_FLASH,
                        4ull * a.block0 + (unsigned long long)(srow0 + qi) * Tk4 + t),
            a.thresh);
        pd = keep ? p * a.inv : 0.f;
        dp = keep ? dp * a.inv : 0.f;
      }
      pd = round_to<T>(pd);
      const float ds = round_to<T>(p * (dp - dls[i]));
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dvr[d] = fmaf(pd, dos[i][d], dvr[d]);
        dkr[d] = fmaf(ds, qs[i][d], dkr[d]);
      }
    }
  }
  if (t < a.Tk) {
    const long long krow = (((long long)b * a.Tk + t) * a.H + h) * a.Hd;
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if (d < a.Hd) {
        dk[krow + d] = from_f32<T>(dkr[d]);
        dv[krow + d] = from_f32<T>(dvr[d]);
      }
  }
}

// the mask the kernels above use, as (B, H, Tq, Tk) bytes of 0 / 1; one
// thread per group of four adjacent keys of a score row
__global__ void __launch_bounds__(256) keep_mask_kernel(
    uint8_t* __restrict__ out, long long rows, int Tk, uint32_t thresh,
    uint32_t seed, unsigned long long block0) {
  const int G = (Tk + 3) >> 2;
  const long long total = rows * G;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / G;
    const int g = static_cast<int>(t - row * G);
    const uint4 r = philox4x32_10(seed, STREAM_FLASH, block0 + (unsigned long long)t);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * g + c < Tk)
        out[row * Tk + 4 * g + c] = keep_bits(word_of(r, c), thresh) ? 1 : 0;
  }
}

// ===========================================================================
// Tensor-core kernels: bf16, even Hd <= 32, 4-byte aligned head rows.
// ===========================================================================

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;    // rows of a staged tile
constexpr int PITCH = 40;   // its row pitch in bf16: 32 + 8, see the header
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// Stage rows [r0, r0 + TILE) of one head into a shared tile.  `src` points at
// (row 0, d 0) of the head and `st` is its row stride in elements; 16 lanes
// take the 16 words of a row and a block takes NT / 16 rows a pass.  Rows >=
// limit and words >= hw (= Hd / 2) are written as zero (their source address
// is formed but not read).  The loop is unrolled with the addresses advanced
// by constants: forming each address anew (a 64-bit multiply, selects and a
// compare per copy) cost more instructions than the tile's arithmetic.
template <int NT>
__device__ __forceinline__ void stage_rows(bf16 (*dst)[PITCH], const bf16* src,
                                           long long st, int r0, int limit, int hw) {
  constexpr int STEP = NT / 16;
  static_assert(TILE % STEP == 0, "a block stages whole passes");
  const int w = threadIdx.x & 15, r = threadIdx.x >> 4;
  const bool lane_ok = w < hw;
  const int left = limit - r0 - r;           // row r + i is live iff i < left
  const uint32_t d = smem_u32(&dst[r][2 * w]);
  const bf16* p = src + (long long)(r0 + r) * st + (lane_ok ? 2 * w : 0);
  const long long step = STEP * st;
#pragma unroll 8   // 16 passes in one piece (64 threads) make ptxas spill
  for (int i = 0; i < TILE; i += STEP) {
    cp_async4(d + i * PITCH * 2, p, lane_ok && i < left);
    p += step;
  }
}

// The A fragments (two k-steps of m16n8k16) of rows [r0, r0 + 16) of one
// head, straight from global memory; `src`, `st`, `limit`, `hw` as above.
// With g = lane / 4, t = lane % 4, register i of k-step s is the bf16 pair at
// row g + 8 (i % 2), word 8 s + 4 (i / 2) + t.
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[2][4], const bf16* src,
                                             long long st, int r0, int limit, int hw,
                                             int g, int t) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i & 1), w = 8 * s + 4 * (i >> 1) + t;
      f[s][i] = (row < limit && w < hw)
                    ? __ldg(reinterpret_cast<const uint32_t*>(src + (long long)row * st) + w)
                    : 0u;
    }
}

// Keep flags (bit i for accumulator register i) of one 16 x 8 score tile in
// the row-walking kernels: registers 0, 1 are (row g, keys 2t, 2t + 1),
// registers 2, 3 the same keys of row g + 8.  Lanes t = 2u and 2u + 1 hold
// the four keys of one Philox block in each of the two rows: the even lane
// computes row g's block, the odd lane row g + 8's (`blk` is the caller's
// block number for its own row), and they trade two words each.
__device__ __forceinline__ uint32_t keep4_rows(const Shape& a, unsigned long long blk,
                                               int t) {
  const uint4 r = philox4x32_10(a.seed, STREAM_FLASH, blk);
  const bool odd = t & 1;
  const uint32_t ra = __shfl_xor_sync(FULL, odd ? r.x : r.z, 1);
  const uint32_t rb = __shfl_xor_sync(FULL, odd ? r.y : r.w, 1);
  const uint32_t w0 = odd ? ra : r.x, w1 = odd ? rb : r.y;   // row g
  const uint32_t w2 = odd ? r.z : ra, w3 = odd ? r.w : rb;   // row g + 8
  return (keep_bits(w0, a.thresh) ? 1u : 0u) | (keep_bits(w1, a.thresh) ? 2u : 0u) |
         (keep_bits(w2, a.thresh) ? 4u : 0u) | (keep_bits(w3, a.thresh) ? 8u : 0u);
}

// Where the forward saves its keep flags for the backward.  The scores of
// one (batch, head) fall into cells of 16 query rows x 64 keys (a warp's rows
// x a staged tile); a cell is 32 words, lane l's word holding the flags of
// the 32 scores lane l owns in the forward's fragment layout: bit 4 j + i is
// accumulator register i of the 8-key tile j (keep4_rows).  The forward
// stores and the dQ kernel loads one coalesced 128-byte line per cell.
__device__ __forceinline__ long long keep_cell(const Shape& a, int b, int h, int rows16,
                                               int tile) {
  const int cells_q = ((a.Tq + TILE - 1) / TILE) * (TILE / 16);
  const int cells_k = (a.Tk + TILE - 1) / TILE;
  return ((((long long)b * a.H + h) * cells_q + rows16) * cells_k + tile) * 32;
}

// Forward.  A block of NW warps owns NW * 16 query rows of one (batch, head);
// a warp keeps its rows' Q fragments, output accumulator and softmax state in
// registers and walks the key tiles.
template <int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, uint32_t* __restrict__ keep_words,
    const Shape a) {
  constexpr int BQ = NW * 16, NT = NW * 32;
  __shared__ __align__(16) bf16 ks[2][TILE][PITCH];
  __shared__ __align__(16) bf16 vs[2][TILE][PITCH];
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int hw = a.Hd >> 1;
  const int row0 = blockIdx.x * BQ + warp * 16;   // this warp's first query row
  const bf16* kp = k + b * a.k_sb + (long long)h * a.Hd;
  const bf16* vp = v + b * a.v_sb + (long long)h * a.Hd;
  // keys the block / the warp may see: [0, blk_end) / [0, warp_end)
  const int blk_end = a.causal ? min(a.kv_len, (int)(blockIdx.x + 1) * BQ) : a.kv_len;
  const int warp_end = a.causal ? min(a.kv_len, row0 + 16) : a.kv_len;
  const int ntiles = (blk_end + TILE - 1) / TILE;
  auto stage = [&](int it) {
    stage_rows<NT>(ks[it & 1], kp, a.k_st, it * TILE, blk_end, hw);
    stage_rows<NT>(vs[it & 1], vp, a.v_st, it * TILE, blk_end, hw);
  };
  stage(0);
  cp_async_commit();

  uint32_t qf[2][4];
  load_a_frags(qf, q + b * a.q_sb + (long long)h * a.Hd, a.q_st, row0, a.Tq, hw, g, t);
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // rows g (index 0) and g + 8 (index 1): running max and this lane's share
  // of the running sum, both of 2^(s * c)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float c = a.scale * LOG2E;
  // this lane's Philox block for keys 0..3 of its tile column (see keep4_rows)
  const unsigned long long mblk =
      DROP ? mask_row_block(a, b, h, row0 + g + ((t & 1) ? 8 : 0)) + (t >> 1) : 0ull;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * TILE;
    if (it + 1 < ntiles) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (k0 < warp_end) {
      const bf16(*kt)[PITCH] = ks[it & 1];
      const bf16(*vt)[PITCH] = vs[it & 1];
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t kb[4];
        ldsm_x4(kb, &kt[8 * j + (lane & 7)][8 * (lane >> 3)]);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
        mma_bf16(s[j], qf[0], kb[0], kb[1]);
        mma_bf16(s[j], qf[1], kb[2], kb[3]);
      }
      // the tile that straddles kv_len or the diagonal is masked by element
      if (k0 + TILE > a.kv_len || (a.causal && k0 + TILE > row0 + 1)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 8 * j + 2 * t + (i & 1), row = row0 + g + 8 * (i >> 1);
            const int end = a.causal ? min(a.kv_len, row + 1) : a.kv_len;
            if (key >= end) s[j][i] = -INFINITY;
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        // finite from the first tile on: key 0 is visible to every row
        const float m_new = fmaxf(m[r], quad_max(mx) * c);
        alpha[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];
      uint32_t pf[4][4];   // P as A fragments: k-step kk holds keys 16 kk .. 16 kk + 15
      uint32_t word = 0u;  // this lane's keep flags of the tile, for the backward
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t keep = 0xfu;
        if (DROP) {
          keep = keep4_rows(a, mblk + ((k0 + 8 * j) >> 2), t);
          word |= keep << (4 * j);
        }
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = fast_exp2(fmaf(s[j][i], c, -m[i >> 1]));   // masked: 2^-inf = 0
          l[i >> 1] += p[i];                                // the sum takes every key
          if (DROP && !((keep >> i) & 1u)) p[i] = 0.f;
        }
        pf[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
        pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
      }
      if (DROP) keep_words[keep_cell(a, b, h, row0 >> 4, it) + lane] = word;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, &vt[16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)]
                               [16 * np + 8 * (lane >> 4)]);
          mma_bf16(acc[2 * np], pf[kk], vb[0], vb[1]);
          mma_bf16(acc[2 * np + 1], pf[kk], vb[2], vb[3]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float lsum = quad_sum(l[r]);
    if (row >= a.Tq) continue;
    const float inv = a.inv / lsum;
    uint32_t* op = reinterpret_cast<uint32_t*>(
        o + (((long long)b * a.Tq + row) * a.H + h) * a.Hd);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      if (4 * n + t < hw)
        op[4 * n + t] = pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0) lse[((long long)b * a.H + h) * a.Tq + row] = (m[r] + log2f(lsum)) * LN2;
  }
}

// dQ, and delta = rowsum(dO * O) for the dK/dV kernel.  The forward's shape:
// a warp owns 16 query rows (Q and dO fragments in registers) and walks the
// key tiles, 32 keys at a time: S and dP from the same K and V tiles, dS
// packed into A fragments, dQ += dS K.
template <int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ d_o,
    const float* __restrict__ lse, const uint32_t* __restrict__ keep_words,
    float* __restrict__ delta, bf16* __restrict__ dq, const Shape a) {
  constexpr int BQ = NW * 16, NT = NW * 32;
  __shared__ __align__(16) bf16 ks[2][TILE][PITCH];
  __shared__ __align__(16) bf16 vs[2][TILE][PITCH];
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int hw = a.Hd >> 1;
  const int row0 = blockIdx.x * BQ + warp * 16;
  const bf16* kp = k + b * a.k_sb + (long long)h * a.Hd;
  const bf16* vp = v + b * a.v_sb + (long long)h * a.Hd;
  const int blk_end = a.causal ? min(a.kv_len, (int)(blockIdx.x + 1) * BQ) : a.kv_len;
  const int warp_end = a.causal ? min(a.kv_len, row0 + 16) : a.kv_len;
  const int ntiles = (blk_end + TILE - 1) / TILE;
  auto stage = [&](int it) {
    stage_rows<NT>(ks[it & 1], kp, a.k_st, it * TILE, blk_end, hw);
    stage_rows<NT>(vs[it & 1], vp, a.v_st, it * TILE, blk_end, hw);
  };
  stage(0);
  cp_async_commit();

  // o, dO, dq: contiguous (B, Tq, H, Hd)
  const long long obase = ((long long)b * a.Tq * a.H + h) * a.Hd;
  const long long ost = (long long)a.H * a.Hd;
  const long long srow0 = ((long long)b * a.H + h) * a.Tq;
  uint32_t qf[2][4], gf[2][4];
  load_a_frags(qf, q + b * a.q_sb + (long long)h * a.Hd, a.q_st, row0, a.Tq, hw, g, t);
  load_a_frags(gf, d_o + obase, ost, row0, a.Tq, hw, g, t);
  float dl[2] = {0.f, 0.f}, L2[2];
  {
    uint32_t of[2][4];
    load_a_frags(of, o + obase, ost, row0, a.Tq, hw, g, t);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack_bf16(of[s][i]), y = unpack_bf16(gf[s][i]);
        dl[i & 1] = fmaf(x.x, y.x, fmaf(x.y, y.y, dl[i & 1]));
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    dl[r] = quad_sum(dl[r]);
    L2[r] = row < a.Tq ? lse[srow0 + row] * LOG2E : 0.f;
    if (t == 0 && row < a.Tq) delta[srow0 + row] = dl[r];
  }
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const float c = a.scale * LOG2E;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) stage(it + 1);
    cp_async_commit();
    // the forward's keep flags of this warp's rows in this tile (keep_cell)
    const uint32_t word = DROP ? __ldg(keep_words + keep_cell(a, b, h, row0 >> 4, it) + lane)
                               : 0u;
    cp_async_wait<1>();
    __syncthreads();
    const bf16(*kt)[PITCH] = ks[it & 1];
    const bf16(*vt)[PITCH] = vs[it & 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kc = it * TILE + 32 * half;   // first key of this chunk
      if (kc >= warp_end) continue;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kb[4], vb[4];
        const int r = 32 * half + 8 * j + (lane & 7), col = 8 * (lane >> 3);
        ldsm_x4(kb, &kt[r][col]);
        ldsm_x4(vb, &vt[r][col]);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
        mma_bf16(s[j], qf[0], kb[0], kb[1]);
        mma_bf16(s[j], qf[1], kb[2], kb[3]);
        mma_bf16(dp[j], gf[0], vb[0], vb[1]);
        mma_bf16(dp[j], gf[1], vb[2], vb[3]);
      }
      const bool full = kc + 32 <= a.kv_len && (!a.causal || kc + 32 <= row0 + 1);
      uint32_t dsf[2][4];   // dS as A fragments: k-step kk holds keys 16 kk .. 16 kk + 15
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t keep = word >> (16 * half + 4 * j);
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = fast_exp2(fmaf(s[j][i], c, -L2[i >> 1]));
          if (!full) {
            const int key = kc + 8 * j + 2 * t + (i & 1), row = row0 + g + 8 * (i >> 1);
            const int end = a.causal ? min(a.kv_len, row + 1) : a.kv_len;
            if (key >= end) p = 0.f;
          }
          float d = dp[j][i];
          if (DROP) d = ((keep >> i) & 1u) ? d * a.inv : 0.f;
          ds[i] = p * (d - dl[i >> 1]);
        }
        dsf[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
        dsf[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, &kt[32 * half + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)]
                               [16 * np + 8 * (lane >> 4)]);
          mma_bf16(acc[2 * np], dsf[kk], kb[0], kb[1]);
          mma_bf16(acc[2 * np + 1], dsf[kk], kb[2], kb[3]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= a.Tq) continue;
    uint32_t* dp32 = reinterpret_cast<uint32_t*>(dq + obase + (long long)row * ost);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      if (4 * n + t < hw)
        dp32[4 * n + t] = pack_bf16(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
  }
}

// dK and dV.  A block of NW warps owns NW * 16 keys of one (batch, head), a
// warp 16 of them with their K and V fragments in registers; query tiles (q,
// dO, lse, delta) pass through shared memory, 32 queries at a time.  The
// scores are computed transposed (S^T = K Q^T, dP^T = V dO^T), so P^T and
// dS^T come out as A fragments for dV += P^T dO and dK += dS^T Q.  Keys at or
// beyond kv_len and causally hidden pairs add exactly zero.
template <int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint32_t* __restrict__ keep_words,
    bf16* __restrict__ dk, bf16* __restrict__ dv, const Shape a) {
  constexpr int BKT = NW * 16, NT = NW * 32;
  __shared__ __align__(16) bf16 qs[2][TILE][PITCH];
  __shared__ __align__(16) bf16 gs[2][TILE][PITCH];
  __shared__ __align__(8) float ls[2][TILE];
  __shared__ __align__(8) float dls[2][TILE];
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int hw = a.Hd >> 1;
  const int blk_key0 = blockIdx.x * BKT, key0 = blk_key0 + warp * 16;
  const long long obase = ((long long)b * a.Tq * a.H + h) * a.Hd;   // of d_o
  const long long ost = (long long)a.H * a.Hd;
  const long long srow0 = ((long long)b * a.H + h) * a.Tq;
  const bf16* qp = q + b * a.q_sb + (long long)h * a.Hd;
  const bf16* gp = d_o + obase;
  // query tiles [first, last): a causal block starts at its own diagonal, a
  // block of padded keys has nothing to do
  const int first = a.causal ? blk_key0 / TILE : 0;
  const int last = blk_key0 < a.kv_len ? (a.Tq + TILE - 1) / TILE : first;
  auto stage = [&](int it) {
    const int buf = (it - first) & 1;
    stage_rows<NT>(qs[buf], qp, a.q_st, it * TILE, a.Tq, hw);
    stage_rows<NT>(gs[buf], gp, ost, it * TILE, a.Tq, hw);
    for (int i = threadIdx.x; i < TILE; i += NT) {
      const bool ok = it * TILE + i < a.Tq;
      const long long at = srow0 + (ok ? it * TILE + i : 0);
      cp_async4(smem_u32(&ls[buf][i]), lse + at, ok);
      cp_async4(smem_u32(&dls[buf][i]), delta + at, ok);
    }
  };
  if (first < last) stage(first);
  cp_async_commit();

  uint32_t kf[2][4], vf[2][4];
  load_a_frags(kf, k + b * a.k_sb + (long long)h * a.Hd, a.k_st, key0, a.kv_len, hw, g, t);
  load_a_frags(vf, v + b * a.v_sb + (long long)h * a.Hd, a.v_st, key0, a.kv_len, hw, g, t);
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;
  const float c = a.scale * LOG2E;
  // The forward's keep flags (keep_cell), read from the transposed side:
  // register i of query tile j here is (query 8 j + 2 t + i % 2, key g + 8
  // (i / 2)) of the chunk, which the forward held in lane 4 (2 t + i % 2) + g /
  // 2 of the cell of rows 16 (j / 2) .., at bit 4 (8-key tile of the key) + 2
  // (j % 2) + g % 2.
  const int keep_lane = 8 * t + (g >> 1), keep_bit = 4 * ((key0 & (TILE - 1)) >> 3) + (g & 1);

  for (int it = first; it < last; ++it) {
    if (it + 1 < last) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = (it - first) & 1;
    const bf16(*qt)[PITCH] = qs[buf];
    const bf16(*gt)[PITCH] = gs[buf];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qc = it * TILE + 32 * half;   // first query of this chunk
      if (qc >= a.Tq || (a.causal && qc + 31 < key0)) continue;
      uint32_t kw[2][2] = {{0u, 0u}, {0u, 0u}};   // [rows 16 rs ..][query parity]
      if (DROP) {
#pragma unroll
        for (int rs = 0; rs < 2; ++rs)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            kw[rs][e] = __ldg(keep_words + keep_cell(a, b, h, (qc >> 4) + rs, key0 / TILE) +
                              keep_lane + 4 * e);
      }
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t qb[4], gb[4];
        const int r = 32 * half + 8 * j + (lane & 7), col = 8 * (lane >> 3);
        ldsm_x4(qb, &qt[r][col]);
        ldsm_x4(gb, &gt[r][col]);
#pragma unroll
        for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
        mma_bf16(st[j], kf[0], qb[0], qb[1]);
        mma_bf16(st[j], kf[1], qb[2], qb[3]);
        mma_bf16(dpt[j], vf[0], gb[0], gb[1]);
        mma_bf16(dpt[j], vf[1], gb[2], gb[3]);
      }
      const bool full = qc + 32 <= a.Tq && key0 + 16 <= a.kv_len &&
                        (!a.causal || key0 + 15 <= qc);
      // P^T and dS^T as A fragments: k-step kk holds queries 16 kk .. 16 kk + 15
      uint32_t pf[2][4], dsf[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = 32 * half + 8 * j + 2 * t;   // in the tile; + (i & 1)
        const float2 L = *reinterpret_cast<const float2*>(&ls[buf][qi]);
        const float2 D = *reinterpret_cast<const float2*>(&dls[buf][qi]);
        float pd[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = fast_exp2(fmaf(st[j][i], c, -LOG2E * ((i & 1) ? L.y : L.x)));
          if (!full) {
            const int query = it * TILE + qi + (i & 1), key = key0 + g + 8 * (i >> 1);
            if (query >= a.Tq || key >= a.kv_len || (a.causal && key > query)) p = 0.f;
          }
          float d = dpt[j][i];
          pd[i] = p;
          if (DROP) {
            const bool kept =
                (kw[j >> 1][i & 1] >> (keep_bit + 4 * (i >> 1) + 2 * (j & 1))) & 1u;
            pd[i] = kept ? p * a.inv : 0.f;
            d = kept ? d * a.inv : 0.f;
          }
          ds[i] = p * (d - ((i & 1) ? D.y : D.x));
        }
        pf[j >> 1][2 * (j & 1)] = pack_bf16(pd[0], pd[1]);
        pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(pd[2], pd[3]);
        dsf[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
        dsf[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t gb[4], qb[4];
          const int r = 32 * half + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
          const int col = 16 * np + 8 * (lane >> 4);
          ldsm_x4_trans(gb, &gt[r][col]);
          ldsm_x4_trans(qb, &qt[r][col]);
          mma_bf16(dva[2 * np], pf[kk], gb[0], gb[1]);
          mma_bf16(dva[2 * np + 1], pf[kk], gb[2], gb[3]);
          mma_bf16(dka[2 * np], dsf[kk], qb[0], qb[1]);
          mma_bf16(dka[2 * np + 1], dsf[kk], qb[2], qb[3]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    if (key >= a.Tk) continue;
    const long long krow = (((long long)b * a.Tk + key) * a.H + h) * a.Hd;
    uint32_t* dk32 = reinterpret_cast<uint32_t*>(dk + krow);
    uint32_t* dv32 = reinterpret_cast<uint32_t*>(dv + krow);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      if (4 * n + t < hw) {
        dk32[4 * n + t] = pack_bf16(dka[n][2 * r] * a.scale, dka[n][2 * r + 1] * a.scale);
        dv32[4 * n + t] = pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
      }
  }
}

// The tensor-core kernels take an even Hd <= 32; the wrapper has checked the
// 4-byte alignment of the pointers and strides.  Two warps a block where
// there are at most 32 rows to own, four otherwise.
bool mma_shape_ok(const Shape& a) { return a.Hd <= 32 && (a.Hd & 1) == 0; }

template <int NW>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                   void* keep_words, int B, const Shape& a, cudaStream_t s) {
  auto kernel = flash_fwd_mma_kernel<NW, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_fwd_mma_kernel<NW, true>;
  kernel<<<dim3((a.Tq + NW * 16 - 1) / (NW * 16), a.H, B), NW * 32, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<uint32_t*>(keep_words), a);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* o,
                  const void* d_o, const void* lse, const void* keep_words, void* delta,
                  void* dq, int B, const Shape& a, cudaStream_t s) {
  auto kernel = flash_bwd_dq_mma_kernel<NW, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_bwd_dq_mma_kernel<NW, true>;
  kernel<<<dim3((a.Tq + NW * 16 - 1) / (NW * 16), a.H, B), NW * 32, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<const uint32_t*>(keep_words), static_cast<float*>(delta),
      static_cast<bf16*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* delta, const void* keep_words, void* dk,
                   void* dv, int B, const Shape& a, cudaStream_t s) {
  auto kernel = flash_bwd_dkv_mma_kernel<NW, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_bwd_dkv_mma_kernel<NW, true>;
  kernel<<<dim3((a.Tk + NW * 16 - 1) / (NW * 16), a.H, B), NW * 32, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint32_t*>(keep_words), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int BQ, int BK>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, const Shape& a, cudaStream_t stream) {
  dim3 grid((a.Tq + BQ - 1) / BQ, a.H, B);
  // Dropout is built for head dims up to 32 only, as the backward is: the
  // wider variants' dropout forward would have no backward to train with.
  auto kernel = flash_fwd_kernel<T, HD, BQ, BK, false>;
  if (a.thresh < KEEP_ALL) {
    if constexpr (HD == 32) {
      kernel = flash_fwd_kernel<T, HD, BQ, BK, true>;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  kernel<<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward(const void* q, const void* k, const void* v, void* o, void* lse,
            int B, const Shape& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.Hd <= 32) return launch_fwd<T, 32, 64, 32>(q, k, v, o, lse, B, a, s);
  if (a.Hd <= 64) return launch_fwd<T, 64, 64, 16>(q, k, v, o, lse, B, a, s);
  if (a.Hd <= 128) return launch_fwd<T, 128, 32, 8>(q, k, v, o, lse, B, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Head dims above 32 are not built for the backward: a key row's k, v, dk
// and dv would not fit a thread's registers.
template <typename T>
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* d_o, const void* lse, void* delta, void* dq, void* dk,
             void* dv, int B, const Shape& a, void* stream) {
  constexpr int HD = 32, BQ = 64, BK = 32, BKT = 64, BQT = 32;
  if (a.Hd > HD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_bwd_dq_kernel<T, HD, BQ, BK>
      <<<dim3((a.Tq + BQ - 1) / BQ, a.H, B), BQ, 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(d_o), static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<T*>(dq), a);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  flash_bwd_dkv_kernel<T, HD, BKT, BQT>
      <<<dim3((a.Tk + BKT - 1) / BKT, a.H, B), BKT, 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(d_o),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}

Shape make_shape(int Tq, int Tk, int H, int Hd, long long q_sb, long long q_st,
                 long long k_sb, long long k_st, long long v_sb, long long v_st,
                 int kv_len, int causal, float scale, float inv, unsigned thresh,
                 unsigned seed, unsigned long long block0) {
  return Shape{Tq, Tk, H, Hd, q_sb, q_st, k_sb, k_st, v_sb, v_st,
               kv_len, causal, scale, inv, thresh, seed, block0};
}

}  // namespace

#define ICEK_SHAPE_PARAMS                                                      \
  int B, int Tq, int Tk, int H, int Hd, long long q_sb, long long q_st,        \
      long long k_sb, long long k_st, long long v_sb, long long v_st,          \
      int kv_len, int causal, float scale, float inv, unsigned thresh,         \
      unsigned seed, unsigned long long block0, void *stream
#define ICEK_SHAPE_ARGS                                                        \
  make_shape(Tq, Tk, H, Hd, q_sb, q_st, k_sb, k_st, v_sb, v_st, kv_len,        \
             causal, scale, inv, thresh, seed, block0)

// Every forward and backward entry point takes `keep_words`, where the
// tensor-core forward leaves its dropout mask for its backward; the CUDA-core
// kernels regenerate the mask and ignore it.
ICEK_EXPORT int flash_fwd_f32(const void* q, const void* k, const void* v,
                              void* o, void* lse, void*, ICEK_SHAPE_PARAMS) {
  return forward<float>(q, k, v, o, lse, B, ICEK_SHAPE_ARGS, stream);
}

ICEK_EXPORT int flash_fwd_bf16(const void* q, const void* k, const void* v,
                               void* o, void* lse, void*, ICEK_SHAPE_PARAMS) {
  return forward<__nv_bfloat16>(q, k, v, o, lse, B, ICEK_SHAPE_ARGS, stream);
}

ICEK_EXPORT int flash_bwd_f32(const void* q, const void* k, const void* v,
                              const void* o, const void* d_o, const void* lse,
                              const void*, void* delta, void* dq, void* dk, void* dv,
                              ICEK_SHAPE_PARAMS) {
  return backward<float>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B,
                         ICEK_SHAPE_ARGS, stream);
}

ICEK_EXPORT int flash_bwd_bf16(const void* q, const void* k, const void* v,
                               const void* o, const void* d_o, const void* lse,
                               const void*, void* delta, void* dq, void* dk, void* dv,
                               ICEK_SHAPE_PARAMS) {
  return backward<__nv_bfloat16>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B,
                                 ICEK_SHAPE_ARGS, stream);
}

// bf16 on the tensor cores (even Hd <= 32, 4-byte aligned rows).  With
// dropout, `keep_words` (32-bit words, keep_cell's layout: B * H * 4 ceil(Tq /
// 64) * ceil(Tk / 64) * 32 of them) takes the forward's keep flags to the
// backward; it may be null at rate 0.
ICEK_EXPORT int flash_fwd_bf16_mma(const void* q, const void* k, const void* v,
                                   void* o, void* lse, void* keep_words,
                                   ICEK_SHAPE_PARAMS) {
  const Shape a = ICEK_SHAPE_ARGS;
  if (!mma_shape_ok(a) || (a.thresh < KEEP_ALL && !keep_words))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.Tq > 32 ? launch_fwd_mma<4>(q, k, v, o, lse, keep_words, B, a, s)
                   : launch_fwd_mma<2>(q, k, v, o, lse, keep_words, B, a, s);
}

ICEK_EXPORT int flash_bwd_bf16_mma(const void* q, const void* k, const void* v,
                                   const void* o, const void* d_o, const void* lse,
                                   const void* keep_words, void* delta, void* dq,
                                   void* dk, void* dv, ICEK_SHAPE_PARAMS) {
  const Shape a = ICEK_SHAPE_ARGS;
  if (!mma_shape_ok(a) || (a.thresh < KEEP_ALL && !keep_words))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* kw = keep_words;
  const int err =
      a.Tq > 32 ? launch_dq_mma<4>(q, k, v, o, d_o, lse, kw, delta, dq, B, a, s)
                : launch_dq_mma<2>(q, k, v, o, d_o, lse, kw, delta, dq, B, a, s);
  if (err) return err;
  return a.Tk > 32 ? launch_dkv_mma<4>(q, k, v, d_o, lse, delta, kw, dk, dv, B, a, s)
                   : launch_dkv_mma<2>(q, k, v, d_o, lse, delta, kw, dk, dv, B, a, s);
}

ICEK_EXPORT int flash_keep_mask(void* out, int B, int H, int Tq, int Tk,
                                unsigned thresh, unsigned seed,
                                unsigned long long block0, void* stream) {
  const long long rows = (long long)B * H * Tq;
  if (rows < 1 || Tk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows * ((Tk + 3) / 4) + 255) / 256;
  keep_mask_kernel<<<static_cast<unsigned>(blocks > 132 * 16 ? 132 * 16 : blocks),
                     256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), rows, Tk, thresh, seed, block0);
  return static_cast<int>(cudaGetLastError());
}
