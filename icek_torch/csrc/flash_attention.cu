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
// slot packing and lane padding are not carried over: Hd is padded to a
// compile-time bound (32 / 64 / 128) with zero lanes in registers and
// shared memory only.  o, dO, dq, dk, dv are contiguous (B, T, H, Hd).
//
// What bounds it: at the geo context encoder (B=256, T=301, H=10, Hd=30)
// the forward moves ~185 MB in bf16 (q, k, v read once, o written once)
// and does ~2.8 GFLOP, so the card's bound is memory (~55 us at
// 3.35 TB/s); the backward moves seven such tensors and does five such
// products, still memory-bound.  Forward design: one block per (query tile
// of BQ rows, head, batch), one thread per query row holding its q row and
// output accumulator in registers; key/value tiles of BK rows are staged in
// shared memory (read by every row of the block as broadcasts) and folded
// in with an online softmax, so any Tk fits and the (Tq, Tk) scores never
// leave registers.  It also writes each row's logsumexp, so the backward
// need not rerun the online softmax (the TPU kernel holds a whole (Tq, Tk)
// tile in VMEM and recomputes; shared memory cannot at Tk = 497).
// Backward design, two kernels and no atomics: the dQ kernel has the
// forward's shape (a thread owns a query row; it also writes
// delta = rowsum(dO * O) = rowsum(dP * P) for the next kernel); the dK/dV
// kernel turns it around (a block owns a tile of keys, a thread one key row
// with its k, v, dk, dv in registers, and loops over staged query tiles).
// The dot products run on the CUDA cores in f32 (simple and exact first;
// tensor-core MMA is later work).
//
// Dropout mask: score (b, h, q, k) keeps iff keep_bits(random_bits(seed,
// STREAM_FLASH, ((b * H + h) * Tq + q) * Tk4 + k)) with Tk4 = Tk rounded up
// to a multiple of 4: the element's absolute position, so both backward
// kernels regenerate the forward's mask under their own tilings, and four
// adjacent keys of a row share one Philox block.
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
};

// Philox block of key 0 of score row (b, h, row); key k adds k / 4
__device__ __forceinline__ unsigned long long mask_row_block(const Shape& a, int b,
                                                             int h, int row) {
  return ((unsigned long long)(b * a.H + h) * a.Tq + row) * ((a.Tk + 3) >> 2);
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
                        (unsigned long long)(srow0 + qi) * Tk4 + t), a.thresh);
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
    uint32_t seed) {
  const int G = (Tk + 3) >> 2;
  const long long total = rows * G;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / G;
    const int g = static_cast<int>(t - row * G);
    const uint4 r = philox4x32_10(seed, STREAM_FLASH, (unsigned long long)t);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * g + c < Tk)
        out[row * Tk + 4 * g + c] = keep_bits(word_of(r, c), thresh) ? 1 : 0;
  }
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
                 unsigned seed) {
  return Shape{Tq, Tk, H, Hd, q_sb, q_st, k_sb, k_st, v_sb, v_st,
               kv_len, causal, scale, inv, thresh, seed};
}

}  // namespace

#define ICEK_SHAPE_PARAMS                                                      \
  int B, int Tq, int Tk, int H, int Hd, long long q_sb, long long q_st,        \
      long long k_sb, long long k_st, long long v_sb, long long v_st,          \
      int kv_len, int causal, float scale, float inv, unsigned thresh,         \
      unsigned seed, void *stream
#define ICEK_SHAPE_ARGS                                                        \
  make_shape(Tq, Tk, H, Hd, q_sb, q_st, k_sb, k_st, v_sb, v_st, kv_len,        \
             causal, scale, inv, thresh, seed)

ICEK_EXPORT int flash_fwd_f32(const void* q, const void* k, const void* v,
                              void* o, void* lse, ICEK_SHAPE_PARAMS) {
  return forward<float>(q, k, v, o, lse, B, ICEK_SHAPE_ARGS, stream);
}

ICEK_EXPORT int flash_fwd_bf16(const void* q, const void* k, const void* v,
                               void* o, void* lse, ICEK_SHAPE_PARAMS) {
  return forward<__nv_bfloat16>(q, k, v, o, lse, B, ICEK_SHAPE_ARGS, stream);
}

ICEK_EXPORT int flash_bwd_f32(const void* q, const void* k, const void* v,
                              const void* o, const void* d_o, const void* lse,
                              void* delta, void* dq, void* dk, void* dv,
                              ICEK_SHAPE_PARAMS) {
  return backward<float>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B,
                         ICEK_SHAPE_ARGS, stream);
}

ICEK_EXPORT int flash_bwd_bf16(const void* q, const void* k, const void* v,
                               const void* o, const void* d_o, const void* lse,
                               void* delta, void* dq, void* dk, void* dv,
                               ICEK_SHAPE_PARAMS) {
  return backward<__nv_bfloat16>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B,
                                 ICEK_SHAPE_ARGS, stream);
}

ICEK_EXPORT int flash_keep_mask(void* out, int B, int H, int Tq, int Tk,
                                unsigned thresh, unsigned seed, void* stream) {
  const long long rows = (long long)B * H * Tq;
  if (rows < 1 || Tk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows * ((Tk + 3) / 4) + 255) / 256;
  keep_mask_kernel<<<static_cast<unsigned>(blocks > 132 * 16 ? 132 * 16 : blocks),
                     256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), rows, Tk, thresh, seed);
  return static_cast<int>(cudaGetLastError());
}
