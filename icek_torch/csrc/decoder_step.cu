// Decoder-step megakernel for Hopper (sm_90a), two routes.
//
// Replaces icek_tpu/kernels/decoder_step.py::fused_beam_decoder_step: one
// whole post-LN decoder stack step for the K beam hypotheses of an image,
//   for each layer:  x = LN1(x + SelfAttn(x))     (ancestry-selected cache
//                                                   + the current step)
//                    x = LN2(x + CrossAttn(x))    (shared per-image memory)
//                    x = LN3(x + FFN(x))          (ReLU)
// returning h (B, K, D) f32 and this step's self-attention K/V rows
// (nL, B, K, D); the caller writes them at cache rows i*K .. i*K+K-1.
//
// Semantics match the stock beam step (decode/beam.py::_beam_decoder_step)
// given the beam loop's invariant that ancestry[:, :, i] is each
// hypothesis's own slot: history position t < i of hypothesis k is cache
// row t*K + ancestry[b, k, t]; the current step attends to its freshly
// projected K/V directly (the cache rows for step i are written only after
// the kernel returns).  Layer norms, softmax and all accumulation are f32.
//
// What bounds it: per step the cross K/V of every layer (3 x 256 x 497 x
// 300 x 2 values, ~460 MB in bf16, ~920 MB in f32) plus the live cache
// prefix must be read from device memory: ~0.15 ms (f32 ~0.31) at 3.35
// TB/s.  The weights (~2.5 M parameters, ~5 MB in bf16, ~10 MB in f32) do
// not fit shared memory (unlike the TPU's VMEM); they come from the 50 MB L2
// to every block, so the fewer blocks read them the better.
//
// Route 1, the tensor cores (decoder_step_mma_kernel<T, HP>, bf16 and f32; the
// wrapper's predicate kernels/decoder_step.py::uses_tensor_cores):
//   * a block owns up to 16 hypothesis rows (one m16 tile): the G * K rows
//     of G images for K <= 16 (the wrapper picks G so the grid is about one
//     wave: G = 2, 128 blocks at the beam shape), the last group ragged; or,
//     for wider beams, one of S = ceil(K / 16) parts of an image's K rows
//     (B S blocks, each streaming its image's memory);
//   * the six linears run on the tensor cores.  bf16: mma.sync m16n8k16
//     with the activations rounded to bf16 in shared memory as the plain
//     bf16 path rounds them.  f32: three TF32 products of m16n8k8 (3xTF32,
//     lo hi + hi lo + hi hi, every operand split into TF32 hi and lo in
//     registers, each k-step's product added to the sums by f32 adds), so
//     the route stays within rounding of f32 (one TF32 pass would be off by
//     about 1e-3).  The weights are packed once per decode batch in the
//     order of the B fragments (kernels/decoder_step.py::pack_mma, or
//     pack_tf32: one f32 copy, split in registers, which reads half the L2
//     bytes of packed hi and lo copies), so a lane loads two k-steps of an
//     n8 tile with one 16-byte load straight from L2 into registers, two
//     k-pairs ahead; each weight is read once per block for all its rows and
//     kept in L2 (evict_last) against the stream;
//   * the cross K/V arrive head-major with Hd padded to HP (laid out once
//     per decode batch, kernels/decoder_step.py::pad_cross_heads): 16-byte
//     aligned rows that stream, 32 memory rows of one image a stage (bf16;
//     16 in f32, whose rows are twice as long), through a three-stage
//     cp.async ring (evict_first in L2: each byte is used once) that runs on
//     across the layers, so the first tiles of layer l + 1 load while layer
//     l's FFN and layer l + 1's self-attention and projections run.  Warp h
//     takes head h: S = Q K^T and O += P V on the tensor cores, online
//     softmax in f32, flash style (f32: Q's fragments read from shared
//     memory and split each tile, P split like any A operand and taken in a
//     permuted k order, cross_tile_f32);
//   * HP, the head pad, is a template parameter: 32 for heads of at most 32
//     dims (the presets' 10 heads of 30), 64 for heads of 33 to 64
//     (--geometry 512x8's 8 heads of 64).  At 64 warp h's S takes four k16
//     steps (bf16) or eight k8 steps (f32) and its O is 16 x 64, and a stage
//     holds 16 bf16 memory rows: with 32-row stages D 512's block would need
//     316,800 bytes (117,120 of activations beside a 199,680-byte ring), with
//     16 it needs 216,960.  f32 at 64 stages 8 rows (one k8 step of P V) and
//     keeps q alone in the projection buffer, the step's own K/V rows read
//     back from k_new / v_new (kv_out): 200,064 bytes at 512x8, where the
//     bf16 layout would take 166,272 of activations and a 198,144-byte ring;
//   * self-attention: two threads a (row, head), each half of the head's
//     dims (16 at HP 32, 32 at HP 64), an online softmax over the
//     ancestry-gathered cache rows (4-byte bf16 or 8-byte f32 loads, the
//     next row's in flight, except f32 at HP 64, which fetches a row after
//     the last row's math) and the current step's own K/V, on the CUDA cores
//     in f32;
//   * biases, residual adds, LayerNorm and softmax statistics in f32 in
//     shared memory and registers.
//   On an H100 at step 15 of the beam shape bf16 takes 0.37-0.38 ms against
//   the 0.154 ms byte bound (PERF.md): the stream runs at ~2.9 TB/s, but
//   the linears, bound by L2 (~5.5 TB/s of weight reads), and the stream
//   take turns (python -m icek_torch.kernels._variants decoder_step).  f32
//   takes 0.90-0.95 ms against 0.308: its linears issue ~7 instructions an
//   mma (each block splits every weight), the cross attention's chains are
//   latency-bound at 10 warps; packed hi / lo weights (twice the L2 bytes)
//   were slower, 1.235 ms (PERF.md).  At 512x8 (HP 64, G = 2: 128 blocks)
//   bf16 takes about 0.89 ms against a 0.264 ms byte bound and f32 about
//   1.9 against 0.528, where the CUDA-core kernel takes 7.1 (G = 3, 86
//   blocks reading the weights from L2 a third fewer times, measured slower
//   in both: PERF.md).
// Route 2, the CUDA-core kernel (decoder_step_kernel): the shapes route 1
// refuses (more than 10 heads, a head dim above 64 or odd, or route 1's
// shared memory past the card's), and bf16 or f32 weights stacked without
// their packed copy.  A block owns R <= 8 hypotheses of one image (grid B x
// ceil(K / R)): R = min(K, 8), lowered until the block's shared memory fits
// the card, so beams of any width run (two or more blocks an image above 8,
// each reading the image's memory once).  Activations (R x D, R x 3D, R x F)
// and the (R*H) x max(M, L) attention weights live in shared memory; each
// memory / cache row a block reads is used by all its R hypotheses and all
// heads; products in f32 on the CUDA cores.
#include "common.cuh"

namespace {

constexpr int KMAX = 8;           // hypothesis rows of a CUDA-core block
constexpr int THREADS = 512;

template <typename T>
struct StepArgs {
  const T* x;        // (B, K, D)
  const int* anc;    // (B, K, L)
  const T* ck;       // (nL, B, L*K, D)
  const T* cv;
  const T* xk;       // (nL, B, M, D)
  const T* xv;
  const T* qkv_w;    // (nL, D, 3D)
  const float* qkv_b;  // (nL, 3D)
  const T* so_w;     // (nL, D, D)
  const float* so_b;
  const T* cq_w;     // (nL, D, D)
  const float* cq_b;
  const T* co_w;     // (nL, D, D)
  const float* co_b;
  const T* f1_w;     // (nL, D, F)
  const float* f1_b;
  const T* f2_w;     // (nL, F, D)
  const float* f2_b;
  const float* ln_s;  // (nL, 3, D)
  const float* ln_b;
  float* h;          // (B, K, D)
  T* k_new;          // (nL, B, K, D)
  T* v_new;
  int B, K, L, D, H, F, nL, M, step;
  float eps;
  int R;             // hypotheses a block (the host picks it)
};

// out[r][j] = act(sum_d in[r][d] * W[d][j] + bias[j]) for the K rows
template <typename T>
__device__ void rows_linear(const float* in, int din, const T* __restrict__ W,
                            const float* __restrict__ bias, int dout,
                            float* out, int K, bool relu) {
  for (int j = threadIdx.x; j < dout; j += blockDim.x) {
    float acc[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < din; ++d) {
      const float w = to_f32(W[(long long)d * dout + j]);
#pragma unroll
      for (int r = 0; r < KMAX; ++r)
        if (r < K) acc[r] = fmaf(in[r * din + d], w, acc[r]);
    }
    const float b = bias[j];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) {
      if (r < K) {
        const float y = acc[r] + b;
        out[r * dout + j] = relu ? fmaxf(y, 0.f) : y;
      }
    }
  }
}

// x = LayerNorm(x + y) per row, f32, two-pass variance (as the stock path)
__device__ void add_layer_norm(float* x, const float* y, const float* scale,
                               const float* bias, int K, int D, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < K; r += blockDim.x / 32) {
    float* xr = x + r * D;
    const float* yr = y + r * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = xr[d] + yr[d];
      xr[d] = v;
      s += v;
    }
    const float mu = warp_sum(s) / D;
    float q = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = xr[d] - mu;
      q += c * c;
    }
    const float rstd = rsqrtf(warp_sum(q) / D + eps);
    for (int d = lane; d < D; d += 32)
      xr[d] = (xr[d] - mu) * rstd * scale[d] + bias[d];
  }
}

// in-place softmax over the first n entries of each of `rows` rows
__device__ void softmax_rows(float* lg, int rows, int n, int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float* p = lg + (long long)r * stride;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, p[t]);
    m = warp_max(m);
    float s = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = __expf(p[t] - m);
      p[t] = e;
      s += e;
    }
    const float inv = 1.f / warp_sum(s);
    for (int t = lane; t < n; t += 32) p[t] *= inv;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) decoder_step_kernel(StepArgs<T> a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  // hypotheses [k0, k0 + K) of image b; the caches keep the beam's width
  const int KB = a.K, k0 = blockIdx.y * a.R, K = min(a.R, KB - k0);
  const int D = a.D, H = a.H, F = a.F, L = a.L, M = a.M;
  const int Hd = D / H, LK = L * KB, i = a.step;
  const int lgw = max(M, L);
  const float scale = rsqrtf((float)Hd);
  float* xs = sm;                 // (K, D)   running activations
  float* proj = xs + K * D;       // (K, 3D)  projections / sublayer outputs
  float* att = proj + K * 3 * D;  // (K, D)   attention outputs
  float* hid = att + K * D;       // (K, F)   FFN hidden
  float* lg = hid + K * F;        // (K*H, lgw) attention weights
  int* anc = reinterpret_cast<int*>(lg + K * H * lgw);  // (K, L)

  for (int e = threadIdx.x; e < K * D; e += blockDim.x)
    xs[e] = to_f32(a.x[((long long)b * KB + k0) * D + e]);
  for (int e = threadIdx.x; e < K * L; e += blockDim.x)
    anc[e] = a.anc[((long long)b * KB + k0) * L + e];
  __syncthreads();

  for (int l = 0; l < a.nL; ++l) {
    const long long cache_base = ((long long)l * a.B + b) * LK * D;
    const long long mem_base = ((long long)l * a.B + b) * M * D;
    const float* lns = a.ln_s + (long long)l * 3 * D;
    const float* lnb = a.ln_b + (long long)l * 3 * D;

    // ---- self-attention over the ancestry-selected history + this step ----
    rows_linear(xs, D, a.qkv_w + (long long)l * D * 3 * D,
                a.qkv_b + (long long)l * 3 * D, 3 * D, proj, K, false);
    __syncthreads();
    for (int e = threadIdx.x; e < K * D; e += blockDim.x) {
      const int r = e / D, j = e % D;
      const long long o = (((long long)l * a.B + b) * KB + k0 + r) * D + j;
      a.k_new[o] = from_f32<T>(proj[r * 3 * D + D + j]);
      a.v_new[o] = from_f32<T>(proj[r * 3 * D + 2 * D + j]);
    }
    for (int e = threadIdx.x; e < K * H * (i + 1); e += blockDim.x) {
      const int t = e % (i + 1), rh = e / (i + 1);
      const int r = rh / H, hh = rh % H;
      const float* qv = proj + r * 3 * D + hh * Hd;
      float dot = 0.f;
      if (t < i) {
        const T* kp = a.ck + cache_base +
                      (long long)(t * KB + anc[r * L + t]) * D + hh * Hd;
        for (int d = 0; d < Hd; ++d) dot = fmaf(qv[d], to_f32(kp[d]), dot);
      } else {
        const float* kp = proj + r * 3 * D + D + hh * Hd;
        for (int d = 0; d < Hd; ++d) dot = fmaf(qv[d], kp[d], dot);
      }
      lg[rh * lgw + t] = dot * scale;
    }
    __syncthreads();
    softmax_rows(lg, K * H, i + 1, lgw);
    __syncthreads();
    for (int e = threadIdx.x; e < K * D; e += blockDim.x) {
      const int r = e / D, j = e % D, hh = j / Hd;
      const float* w = lg + (r * H + hh) * lgw;
      float acc = 0.f;
      for (int t = 0; t < i; ++t)
        acc = fmaf(w[t], to_f32(a.cv[cache_base + (long long)(t * KB + anc[r * L + t]) * D + j]), acc);
      att[e] = fmaf(w[i], proj[r * 3 * D + 2 * D + j], acc);
    }
    __syncthreads();
    rows_linear(att, D, a.so_w + (long long)l * D * D, a.so_b + (long long)l * D,
                D, proj, K, false);
    __syncthreads();
    add_layer_norm(xs, proj, lns, lnb, K, D, a.eps);
    __syncthreads();

    // ---- cross-attention over the shared per-image memory ----
    rows_linear(xs, D, a.cq_w + (long long)l * D * D, a.cq_b + (long long)l * D,
                D, proj, K, false);
    __syncthreads();
    for (int e = threadIdx.x; e < H * M; e += blockDim.x) {
      const int hh = e % H, m = e / H;
      const T* kp = a.xk + mem_base + (long long)m * D + hh * Hd;
      float acc[KMAX];
#pragma unroll
      for (int r = 0; r < KMAX; ++r) acc[r] = 0.f;
      for (int d = 0; d < Hd; ++d) {
        const float kv = to_f32(kp[d]);
#pragma unroll
        for (int r = 0; r < KMAX; ++r)
          if (r < K) acc[r] = fmaf(proj[r * D + hh * Hd + d], kv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < KMAX; ++r)
        if (r < K) lg[(r * H + hh) * lgw + m] = acc[r] * scale;
    }
    __syncthreads();
    softmax_rows(lg, K * H, M, lgw);
    __syncthreads();
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      const int hh = j / Hd;
      float acc[KMAX];
#pragma unroll
      for (int r = 0; r < KMAX; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
        const float vv = to_f32(a.xv[mem_base + (long long)m * D + j]);
#pragma unroll
        for (int r = 0; r < KMAX; ++r)
          if (r < K) acc[r] = fmaf(lg[(r * H + hh) * lgw + m], vv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < KMAX; ++r)
        if (r < K) att[r * D + j] = acc[r];
    }
    __syncthreads();
    rows_linear(att, D, a.co_w + (long long)l * D * D, a.co_b + (long long)l * D,
                D, proj, K, false);
    __syncthreads();
    add_layer_norm(xs, proj, lns + D, lnb + D, K, D, a.eps);
    __syncthreads();

    // ---- ReLU FFN ----
    rows_linear(xs, D, a.f1_w + (long long)l * D * F, a.f1_b + (long long)l * F,
                F, hid, K, true);
    __syncthreads();
    rows_linear(hid, F, a.f2_w + (long long)l * F * D, a.f2_b + (long long)l * D,
                D, proj, K, false);
    __syncthreads();
    add_layer_norm(xs, proj, lns + 2 * D, lnb + 2 * D, K, D, a.eps);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < K * D; e += blockDim.x)
    a.h[((long long)b * KB + k0) * D + e] = xs[e];
}

// shared memory of a CUDA-core block of R hypotheses
size_t rows_smem_bytes(int R, int D, int H, int F, int M, int L) {
  return sizeof(float) * ((size_t)R * D * 5 + (size_t)R * F + (size_t)R * H * max(M, L)) +
         sizeof(int) * (size_t)R * L;
}

// R of a CUDA-core block: min(K, KMAX), lowered until the block fits the
// device's opt-in shared memory; 0 when not even one hypothesis fits
int rows_per_block(int K, int D, int H, int F, int M, int L) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  int R = min(K, KMAX);
  while (R > 0 && rows_smem_bytes(R, D, H, F, M, L) > (size_t)limit) --R;
  return R;
}

template <typename T>
int run(StepArgs<T> a, void* stream) {
  if (a.K < 1 || a.H < 1 || a.D % a.H != 0 || a.step < 0 || a.step >= a.L)
    return static_cast<int>(cudaErrorInvalidValue);
  a.R = rows_per_block(a.K, a.D, a.H, a.F, a.M, a.L);
  if (a.R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rows_smem_bytes(a.R, a.D, a.H, a.F, a.M, a.L);
  cudaError_t err = cudaFuncSetAttribute(
      decoder_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B, (a.K + a.R - 1) / a.R);
  decoder_step_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(const void* x, const int* anc, const void* ck, const void* cv,
          const void* xk, const void* xv, const void* qkv_w, const float* qkv_b,
          const void* so_w, const float* so_b, const void* cq_w,
          const float* cq_b, const void* co_w, const float* co_b,
          const void* f1_w, const float* f1_b, const void* f2_w,
          const float* f2_b, const float* ln_s, const float* ln_b, float* h,
          void* k_new, void* v_new, int B, int K, int L, int D, int H, int F,
          int nL, int M, int step, float eps, void* stream) {
  StepArgs<T> a{static_cast<const T*>(x), anc,
                static_cast<const T*>(ck), static_cast<const T*>(cv),
                static_cast<const T*>(xk), static_cast<const T*>(xv),
                static_cast<const T*>(qkv_w), qkv_b,
                static_cast<const T*>(so_w), so_b,
                static_cast<const T*>(cq_w), cq_b,
                static_cast<const T*>(co_w), co_b,
                static_cast<const T*>(f1_w), f1_b,
                static_cast<const T*>(f2_w), f2_b,
                ln_s, ln_b, h,
                static_cast<T*>(k_new), static_cast<T*>(v_new),
                B, K, L, D, H, F, nL, M, step, eps, 0};
  return run<T>(a, stream);
}


// ---------------------------------------------------------------------------
// Route 1: the tensor cores, bf16 and f32 (decoder_step_mma_kernel<T, HP>)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int MW = 10;            // warps of a block: one a head (H <= MW)
constexpr int MT = MW * 32;
constexpr int ROWS = 16;          // hypothesis rows of a block: one m16 tile
constexpr int XSTAGES = 3;        // depth of the cross ring
constexpr int NTW = 4;            // n8 tiles a warp takes per pass of a linear
constexpr int MMA_MAX_SMEM = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// What differs between the element types.  bf16: mma.sync m16n8k16, a lane's
// 16-byte weight load holds two k16 steps (a k-pair 32 deep), 32 memory rows
// a cross stage at HP 32.  f32: three TF32 products of m16n8k8 (3xTF32: hi
// hi + hi lo + lo hi, each operand split in registers), a lane's 16-byte
// weight load holds two k8 steps (16 deep), 16 memory rows a stage at HP 32
// (a stage of 32 f32 rows would not leave three stages room).  Row pitches are padded by 16
// bytes past a whole k-pair, which puts the eight rows of an ldmatrix (and
// the f32 fragments' eight rows g at word t) on distinct banks.
template <typename T> struct Tc;
template <> struct Tc<bf16> {
  static constexpr int XT = 32;   // memory rows of a cross stage
  static constexpr int KP = 32;   // depth of a k-pair
  using Word = uint32_t;          // two elements
};
template <> struct Tc<float> {
  static constexpr int XT = 16;
  static constexpr int KP = 16;
  using Word = float2;
};
template <typename T> constexpr int PAD = 16 / sizeof(T);   // 16 bytes of pitch pad

// The head dim of the padded cross layout, HP: 32 for heads of at most 32
// dims, 64 above.  A cross stage holds XT memory rows: Tc<T>::XT at HP 32; at
// HP 64, whose rows are twice as long, 16 bf16 or 8 f32 rows, so that three
// stages fit beside the activations of D 512 (216,960 bytes at 512x8 in bf16,
// 200,064 in f32).
__host__ __device__ constexpr int head_pad(int Hd) { return Hd <= 32 ? 32 : 64; }
template <typename T, int HP> __host__ __device__ constexpr int xt_of() {
  return HP == 32 ? Tc<T>::XT : sizeof(T) == 2 ? 16 : 8;
}
// Whether the step's own K/V rows go out to k_new / v_new only, `big` holding
// q alone, and the self-attention reads them back from there (f32 at HP 64:
// a 3D-wide `big` beside three stages of 8 rows would pass the card's shared
// memory at D 512, 364,416 bytes with 16-row stages)
template <typename T, int HP> __host__ __device__ constexpr bool kv_out() {
  return sizeof(T) == 4 && HP == 64;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// the pitch of an A operand of depth n: n padded to whole k-pairs, plus 16 bytes
template <typename T> __host__ __device__ inline int a_pitch(int n) {
  return round_up(n, Tc<T>::KP) + PAD<T>;
}

// layout of the tensor-core kernel's shared memory (bytes), for (D, H, F, L)
// and the cross layout's head pad HP
struct MmaSmem {
  int pa, pq, pf, pb, px;                   // row pitches in elements (px: x's, f32)
  int xs, xa, ab, big, anc, ring, total;    // offsets, then the size
};

template <typename T, int HP>
__host__ __device__ inline MmaSmem mma_smem(int D, int H, int F, int L) {
  constexpr int E = sizeof(T);
  MmaSmem s;
  s.pa = a_pitch<T>(D);
  s.pq = H * HP + PAD<T>;
  s.pf = a_pitch<T>(F);
  s.pb = max(max(round_up(kv_out<T, HP>() ? D : 3 * D, 8), s.pq), s.pf);
  // f32: x is its own A operand (pitch pa, zeros in the pad); bf16: x in f32
  // (ROWS, D) and rounded to bf16 in xa
  s.px = E == 4 ? s.pa : D;
  s.xs = 0;
  s.xa = E == 4 ? 0 : round_up(4 * ROWS * D, 16);
  s.ab = s.xa + E * ROWS * s.pa;                      // T (ROWS, pa): attention out
  s.big = s.ab + E * ROWS * s.pa;                     // T (ROWS, pb): qkv (or q) | q | hidden
  s.anc = s.big + E * ROWS * s.pb;                    // int (ROWS, L)
  s.ring = round_up(s.anc + 4 * ROWS * L, 16);        // T XSTAGES x (K, V) x (XT, pq)
  s.total = s.ring + E * XSTAGES * 2 * xt_of<T, HP>() * s.pq;
  return s;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// two elements as one word and back
__device__ __forceinline__ uint32_t pack_word(bf16*, float a, float b) { return pack_bf16(a, b); }
__device__ __forceinline__ float2 pack_word(float*, float a, float b) { return make_float2(a, b); }
__device__ __forceinline__ float2 unpack(uint32_t w) { return unpack_bf16(w); }
__device__ __forceinline__ float2 unpack(float2 w) { return w; }

// p[0], p[1] = a, b (p 4-byte aligned for bf16, 8-byte for f32)
template <typename T> __device__ __forceinline__ void store_pair(T* p, float a, float b) {
  *reinterpret_cast<typename Tc<T>::Word*>(p) = pack_word(p, a, b);
}

template <typename T>
struct MmaArgs {
  const T* x;           // (B, K, D)
  const int* anc;       // (B, K, L)
  const T* ck;          // (nL, B, L*K, D)
  const T* cv;
  const T* xk;          // (nL, B, M, H, HP): head-major, Hd padded with zeros
  const T* xv;
  const uint4* w[6];    // qkv, so, cq, co, f1, f2 packed: (nL, n/8, din/KP, 32 lanes, 16 bytes)
  const float* b[6];    // their biases (nL, dout)
  const float* ln_s;    // (nL, 3, D)
  const float* ln_b;
  float* h;             // (B, K, D)
  T* k_new;             // (nL, B, K, D)
  T* v_new;
  int B, K, L, D, H, F, nL, M, step;
  int G, S;             // G images a block (S = 1), or S blocks an image (G = 1)
  float eps;
};

// Two L2 policies.  The cross K/V are read once a step and pass through L2
// on their way to shared memory: evict_first, so that they do not push out
// the weights, which every block reads (evict_last).
__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// cp_async16 (common.cuh) under an L2 policy
__device__ __forceinline__ void cp_async16_hint(uint32_t dst, const void* src, bool valid,
                                                uint64_t pol) {
  const uint32_t n = valid ? 16u : 0u;
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(dst),
               "l"(src), "r"(n), "l"(pol)
               : "memory");
}

// a 16-byte read-only load under an L2 policy
__device__ __forceinline__ uint4 ldg16_hint(const uint4* p, uint64_t pol) {
  uint4 r;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0,%1,%2,%3}, [%4], %5;\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p), "l"(pol));
  return r;
}

// An f32 A fragment of m16n8k8 as it comes from ldmatrix, split into TF32 hi
// and lo pieces
__device__ __forceinline__ FragA<2> split_frag(const uint32_t (&r)[4]) {
  FragA<2> f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t p[2];
    split_tf32_bits(__uint_as_float(r[i]), p);
    f.p[0][i] = p[0];
    f.p[1][i] = p[1];
  }
  return f;
}

// c += a b in three TF32 products, hi lo + lo hi + hi hi (the smaller first),
// summed by the tensor cores; the B fragment (b0, b1) is split here.  The
// callers keep the tensor cores' sums short (one k-pair of a linear, one
// tile of P V) and add them to their long sums by f32 adds, which round to
// nearest where the mma's accumulation does not
__device__ __forceinline__ void mma3(float (&c)[4], const FragA<2>& a, float b0, float b1) {
  uint32_t x[2], y[2];
  split_tf32_bits(b0, x);
  split_tf32_bits(b1, y);
  mma_tf32(c, a.p[0], x[1], y[1]);
  mma_tf32(c, a.p[1], x[0], y[0]);
  mma_tf32(c, a.p[0], x[0], y[0]);
}

// y = A W for the block's 16 rows: A in shared memory (pitch pa, zero past
// its depth), W packed in B-fragment order (kpairs k-pairs for each of
// ntiles n8 tiles).  Warp w takes n8 tiles [NTW w, NTW w + NTW), then the
// same plus NTW * MW, ...; a lane loads its two k-steps of a tile as one
// 16-byte word, two k-pairs ahead of the products.  A k-step's A fragment
// comes from one ldmatrix x4: bf16 the four 8x8 matrices of rows 0-7 / 8-15
// by k 0-7 / 8-15, f32 (as b16 pairs) rows 0-7 / 8-15 by k 0-3 / 4-7.  f32
// products are three TF32 products each (mma3), a k-pair's formed apart and
// added to the sums in f32.  epi(row, col, y0, y1) gets the f32 sums of
// columns col, col + 1 (col even) of every row.
template <typename T, typename Epi>
__device__ __forceinline__ void mma_linear(const T* A, int pa, int kpairs,
                                           const uint4* __restrict__ W, int ntiles, Epi epi) {
  constexpr int KP = Tc<T>::KP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const T* a_src = A + (lane & 15) * pa + (lane >> 4) * PAD<T>;
  const uint64_t keep = l2_policy_evict_last();
  for (int n0 = warp * NTW; n0 < ntiles; n0 += MW * NTW) {
    float acc[NTW][4];
    const uint4* wp[NTW];
    bool ok[NTW];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      ok[j] = n0 + j < ntiles;
      wp[j] = W + ((long long)(ok[j] ? n0 + j : 0) * kpairs) * 32 + lane;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    uint4 b0[NTW], b1[NTW];
    auto fetch = [&](uint4 (&b)[NTW], int kp) {
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        b[j] = (ok[j] && kp < kpairs) ? ldg16_hint(wp[j] + kp * 32, keep)
                                      : make_uint4(0u, 0u, 0u, 0u);
    };
    auto step = [&](const uint4 (&b)[NTW], int kp) {
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, a_src + KP * kp);
      ldsm_x4(a1, a_src + KP * kp + KP / 2);
      if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          mma_bf16(acc[j], a0, b[j].x, b[j].y);
          mma_bf16(acc[j], a1, b[j].z, b[j].w);
        }
      } else {
        const FragA<2> f0 = split_frag(a0), f1 = split_frag(a1);
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          float s[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(s, f0, __uint_as_float(b[j].x), __uint_as_float(b[j].y));
          mma3(s, f1, __uint_as_float(b[j].z), __uint_as_float(b[j].w));
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += s[e];
        }
      }
    };
    fetch(b0, 0);
    fetch(b1, 1);
    for (int kp = 0; kp < kpairs; kp += 2) {
      step(b0, kp);
      fetch(b0, kp + 2);
      if (kp + 1 < kpairs) {
        step(b1, kp + 1);
        fetch(b1, kp + 3);
      }
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (!ok[j]) continue;
      const int col = 8 * (n0 + j) + 2 * t;
      epi(g, col, acc[j][0], acc[j][1]);
      epi(g + 8, col, acc[j][2], acc[j][3]);
    }
  }
}

// x = LayerNorm(x) over the block's R real rows (the residual is already in
// x, pitch px), f32, two-pass variance as the stock path; bf16 also rounds x
// into xa for the next product (f32's x is its own A operand)
template <typename T>
__device__ __forceinline__ void norm_rows(float* xs, int px, T* xa, int pa, const float* scale,
                                          const float* bias, int R, int D, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += MW) {
    float* xr = xs + r * px;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += xr[d];
    const float mu = warp_sum(s) / D;
    float q = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = xr[d] - mu;
      q += c * c;
    }
    const float rstd = rsqrtf(warp_sum(q) / D + eps);
    for (int d = lane; d < D; d += 32) {
      const float y = (xr[d] - mu) * rstd * scale[d] + bias[d];
      xr[d] = y;
      if constexpr (sizeof(T) == 2) xa[r * pa + d] = __float2bfloat16(y);
    }
  }
}

// One memory tile of XT rows of the cross attention for warp hh's head,
// flash style, in f32: S = Q K^T and O += P V in 3xTF32 (mma3; a tile's P V
// formed apart and added to O in f32).  Q's fragments (HP / 8 k8 steps over
// the padded head dim) are read from shared memory at qt, where q stays
// through the loop, and split for each tile: held in registers for the image
// instead, their split pieces (64 registers a lane at HP 64) spill in the
// loop, 2.69 ms a step against 1.91 at 512x8, and at HP 32 they measured 2%
// slower too (PERF.md).  P reaches its product
// without a shuffle: the accumulator holds keys 2 t, 2 t + 1 where the A
// fragment wants k = t, t + 4, so P is taken as A with its k order permuted
// (key 2 t as k t, 2 t + 1 as t + 4) and V's rows are read in that order.
template <int HP, int XT>
__device__ __forceinline__ void cross_tile_f32(const float* qt, const float* kt, const float* vt,
                                               int PQ, float (&acc)[HP / 8][4], float (&mrow)[2],
                                               float (&lrow)[2], int m0, int M, float c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float sv[XT / 8][4];
#pragma unroll
  for (int j = 0; j < XT / 8; ++j) {
    uint32_t kb[HP / 16][4];            // K rows 8 j + g, dims 16 h + 4 q + t (matrix q = lane / 8)
    const float* kr = kt + (8 * j + (lane & 7)) * PQ + 4 * (lane >> 3);
#pragma unroll
    for (int h = 0; h < HP / 16; ++h) ldsm_x4(kb[h], kr + 16 * h);
#pragma unroll
    for (int e = 0; e < 4; ++e) sv[j][e] = 0.f;
#pragma unroll
    for (int ds = 0; ds < HP / 8; ++ds) {
      uint32_t q4[4];                   // Q rows g, g + 8 by dims 8 ds + t, + 4
      ldsm_x4(q4, qt + 8 * ds);
      mma3(sv[j], split_frag(q4), __uint_as_float(kb[ds >> 1][2 * (ds & 1)]),
           __uint_as_float(kb[ds >> 1][2 * (ds & 1) + 1]));
    }
  }
  if (m0 + XT > M) {                    // the ragged last tile
#pragma unroll
    for (int j = 0; j < XT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m0 + 8 * j + 2 * t + (e & 1) >= M) sv[j][e] = -INFINITY;
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < XT / 8; ++j) mx = fmaxf(mx, fmaxf(sv[j][2 * r], sv[j][2 * r + 1]));
    const float m_new = fmaxf(mrow[r], quad_max(mx) * c);   // finite: row 0 of a tile is live
    alpha[r] = fast_exp2(mrow[r] - m_new);
    mrow[r] = m_new;
    lrow[r] *= alpha[r];
  }
  float pv[HP / 8][4] = {};
#pragma unroll
  for (int j = 0; j < XT / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = fast_exp2(fmaf(sv[j][e], c, -mrow[e >> 1]));   // masked: 2^-inf = 0
      lrow[e >> 1] += p[e];
    }
    const uint32_t pa[4] = {__float_as_uint(p[0]), __float_as_uint(p[2]), __float_as_uint(p[1]),
                            __float_as_uint(p[3])};
    const FragA<2> pf = split_frag(pa);
    const float* v0 = vt + (8 * j + 2 * t) * PQ + g;
#pragma unroll
    for (int n = 0; n < HP / 8; ++n) mma3(pv[n], pf, v0[8 * n], v0[PQ + 8 * n]);
  }
#pragma unroll
  for (int n = 0; n < HP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
}

template <typename T, int HP>
__global__ void __launch_bounds__(MT, 1) decoder_step_mma_kernel(MmaArgs<T> a) {
  constexpr bool F32 = sizeof(T) == 4;
  static_assert(HP == 32 || HP == 64, "heads of at most 64 dims");
  constexpr int XT = xt_of<T, HP>(), KP = Tc<T>::KP;
  constexpr bool KV_OUT = kv_out<T, HP>();
  constexpr int SW = HP / 4;        // words (element pairs) of a self-attention thread
  using Word = typename Tc<T>::Word;
  // a self-attention thread fetches the next row's K and V during this row's
  // math where they take at most 64 bytes each (32 registers); f32 at HP 64
  // (128 bytes each) fetches after it: ahead, beside the 168 registers ten
  // warps allow, it measured 11% slower a step (PERF.md)
  constexpr bool AHEAD = SW * sizeof(Word) <= 64;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, D = a.D, H = a.H, F = a.F, L = a.L, M = a.M, i = a.step;
  const int Hd = D / H, HPT = H * HP;
  const MmaSmem sm = mma_smem<T, HP>(D, H, F, L);
  const int PA = sm.pa, PQ = sm.pq, PF = sm.pf, PB = sm.pb, PX = sm.px;
  float* xs = reinterpret_cast<float*>(smem + sm.xs);
  T* xa = reinterpret_cast<T*>(smem + sm.xa);     // f32: xs itself
  T* ab = reinterpret_cast<T*>(smem + sm.ab);
  T* big = reinterpret_cast<T*>(smem + sm.big);   // proj (pitch PB), qc (PQ), hid (PF)
  int* anc = reinterpret_cast<int*>(smem + sm.anc);
  T* ring = reinterpret_cast<T*>(smem + sm.ring);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the block's rows [row0, row0 + R) of the (B K) hypotheses: G whole
  // images, the last group ragged (S = 1), or part of one image's (S > 1)
  int row0, R;
  if (a.S == 1) {
    const int b0 = blockIdx.x * a.G;
    row0 = b0 * K;
    R = min(a.G, a.B - b0) * K;
  } else {
    const int per = (K + a.S - 1) / a.S, k0 = (blockIdx.x % a.S) * per;
    row0 = (blockIdx.x / a.S) * K + k0;
    R = min(per, K - k0);
  }
  const int img0 = row0 / K, nimg = (row0 + R - 1) / K - img0 + 1;
  const uint64_t stream = l2_policy_evict_first();

  // zeros in every pad of the operands (and finite values in `big`)
  for (int e = tid; e < (sm.anc - sm.xa) / 16; e += MT)
    reinterpret_cast<uint4*>(smem + sm.xa)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int e = tid; e < R * D; e += MT) {
    const T v = a.x[(long long)row0 * D + e];
    xs[(e / D) * PX + e % D] = to_f32(v);
    if constexpr (!F32) xa[(e / D) * PA + e % D] = v;
  }
  for (int e = tid; e < R * L; e += MT) anc[e] = a.anc[(long long)row0 * L + e];

  // the cross ring: stage s is memory tile s % nT of image (s / nT) % nimg
  // of layer s / (nimg nT), K then V, 16 bytes a copy, zeros past M
  const int nT = (M + XT - 1) / XT;
  const int per_layer = nimg * nT, total = a.nL * per_layer;
  const int chunks = HPT / PAD<T>;
  auto load_stage = [&](int s) {
    if (s < total) {
      const int l = s / per_layer, rem = s - l * per_layer;
      const int gi = rem / nT, m0 = (rem - gi * nT) * XT;
      const long long base = (((long long)l * a.B + img0 + gi) * M + m0) * HPT;
      T* kd = ring + (s % XSTAGES) * 2 * XT * PQ;
      T* vd = kd + XT * PQ;
      for (int e = tid; e < XT * chunks; e += MT) {
        const int r = e / chunks, c = e - r * chunks;
        const bool ok = m0 + r < M;
        const long long src = ok ? base + (long long)r * HPT + PAD<T> * c : 0;
        cp_async16_hint(smem_u32(kd + r * PQ + PAD<T> * c), a.xk + src, ok, stream);
        cp_async16_hint(smem_u32(vd + r * PQ + PAD<T> * c), a.xv + src, ok, stream);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < XSTAGES - 1; ++s) load_stage(s);
  __syncthreads();

  const float sc = rsqrtf((float)Hd);
  const int kp_d = round_up(D, KP) / KP, kp_f = round_up(F, KP) / KP;
  const int nt_d = round_up(D, 8) / 8;
  for (int l = 0; l < a.nL; ++l) {
    const float* lns = a.ln_s + (long long)l * 3 * D;
    const float* lnb = a.ln_b + (long long)l * 3 * D;
    auto wl = [&](int j, int din, int dout) {
      return a.w[j] + (long long)l * (round_up(dout, 8) / 8) * (round_up(din, KP) / KP) * 32;
    };
    // residual sums: x += y + bias over the real rows
    auto residual = [&](const float* bias) {
      return [=](int row, int col, float y0, float y1) {
        if (row < R && col < D) {
          xs[row * PX + col] += y0 + bias[col];
          xs[row * PX + col + 1] += y1 + bias[col + 1];
        }
      };
    };

    // ---- QKV projection; this step's K/V rows out ----
    {
      const float* bias = a.b[0] + (long long)l * 3 * D;
      const long long out0 = ((long long)l * a.B * K + row0) * D;
      mma_linear(xa, PA, kp_d, wl(0, D, 3 * D), round_up(3 * D, 8) / 8,
                 [&](int row, int col, float y0, float y1) {
                   if (col >= 3 * D) return;
                   const Word p = pack_word(big, y0 + bias[col], y1 + bias[col + 1]);
                   if (!KV_OUT || col < D) *reinterpret_cast<Word*>(big + row * PB + col) = p;
                   if (row < R && col >= D) {
                     T* dst = col < 2 * D ? a.k_new + col - D : a.v_new + col - 2 * D;
                     *reinterpret_cast<Word*>(dst + out0 + (long long)row * D) = p;
                   }
                 });
    }
    __syncthreads();

    // ---- self-attention: two threads a (row, head), half the dims each ----
    {
      const int half = tid & 1, w0 = SW * half, nw = min(SW, Hd / 2 - w0);
      const unsigned pair = 3u << (lane & 30);
      const long long img = (long long)L * K * D;
      for (int task = tid >> 1; task < R * H; task += MT / 2) {
        const int r = task / H, hh = task - r * H;
        const int col = hh * Hd + 2 * w0;
        const Word* qs = reinterpret_cast<const Word*>(big + r * PB + col);
        // this step's own K/V: beside q, or (KV_OUT) this block's rows of k_new /
        // v_new, written above and visible after the barrier (plain loads)
        const long long own = ((long long)l * a.B * K + row0 + r) * D + col;
        const Word* ks_ = reinterpret_cast<const Word*>(KV_OUT ? a.k_new + own
                                                                : big + r * PB + D + col);
        const Word* vs_ = reinterpret_cast<const Word*>(KV_OUT ? a.v_new + own
                                                                : big + r * PB + 2 * D + col);
        const long long base = ((long long)l * a.B + (row0 + r) / K) * img + col;
        const T* kb = a.ck + base;
        const T* vb = a.cv + base;
        const int* ar = anc + r * L;
        float q[2 * SW], o[2 * SW];
#pragma unroll
        for (int w = 0; w < SW; ++w) {
          const float2 f = w < nw ? unpack(qs[w]) : make_float2(0.f, 0.f);
          q[2 * w] = f.x;
          q[2 * w + 1] = f.y;
          o[2 * w] = o[2 * w + 1] = 0.f;
        }
        Word kw[SW], vw[SW];
        const Word zero{};
        // history row tt < i through the ancestry, or this step's own K/V
        auto fetch = [&](int tt, Word (&kq)[SW], Word (&vq)[SW]) {
          if (tt < i) {
            const long long off = (long long)(tt * K + ar[tt]) * D;
            const Word* kp = reinterpret_cast<const Word*>(kb + off);
            const Word* vp = reinterpret_cast<const Word*>(vb + off);
#pragma unroll
            for (int w = 0; w < SW; ++w) {
              kq[w] = w < nw ? __ldg(kp + w) : zero;
              vq[w] = w < nw ? __ldg(vp + w) : zero;
            }
          } else {
#pragma unroll
            for (int w = 0; w < SW; ++w) {
              kq[w] = w < nw ? ks_[w] : zero;
              vq[w] = w < nw ? vs_[w] : zero;
            }
          }
        };
        fetch(0, kw, vw);
        float m = -INFINITY, s = 0.f;
        for (int tt = 0; tt <= i; ++tt) {
          Word kn[SW], vn[SW];
          if constexpr (AHEAD) {
            if (tt < i) fetch(tt + 1, kn, vn);
          }
          float dot = 0.f;
#pragma unroll
          for (int w = 0; w < SW; ++w) {
            const float2 k2 = unpack(kw[w]);
            dot = fmaf(q[2 * w], k2.x, fmaf(q[2 * w + 1], k2.y, dot));
          }
          dot += __shfl_xor_sync(pair, dot, 1);
          const float sv = dot * sc;
          const float m_new = fmaxf(m, sv);
          const float alpha = __expf(m - m_new), p = __expf(sv - m_new);
          s = s * alpha + p;
#pragma unroll
          for (int w = 0; w < SW; ++w) {
            const float2 v2 = unpack(vw[w]);
            o[2 * w] = fmaf(p, v2.x, o[2 * w] * alpha);
            o[2 * w + 1] = fmaf(p, v2.y, o[2 * w + 1] * alpha);
          }
          m = m_new;
          if (tt < i) {
            if constexpr (AHEAD) {
#pragma unroll
              for (int w = 0; w < SW; ++w) {
                kw[w] = kn[w];
                vw[w] = vn[w];
              }
            } else {
              fetch(tt + 1, kw, vw);
            }
          }
        }
        const float inv = 1.f / s;
        Word* dst = reinterpret_cast<Word*>(ab + r * PA + col);
#pragma unroll
        for (int w = 0; w < SW; ++w)
          if (w < nw) dst[w] = pack_word(ab, o[2 * w] * inv, o[2 * w + 1] * inv);
      }
    }
    __syncthreads();

    // ---- self-attention out projection (+ residual); q's buffer zeroed ----
    for (int e = tid; e < ROWS * PQ / PAD<T>; e += MT)
      reinterpret_cast<uint4*>(big)[e] = make_uint4(0u, 0u, 0u, 0u);
    mma_linear(ab, PA, kp_d, wl(1, D, D), nt_d, residual(a.b[1] + (long long)l * D));
    __syncthreads();
    norm_rows(xs, PX, xa, PA, lns, lnb, R, D, a.eps);
    __syncthreads();

    // ---- cross-attention query, head-major with Hd padded to HP ----
    {
      const float* bias = a.b[2] + (long long)l * D;
      mma_linear(xa, PA, kp_d, wl(2, D, D), nt_d, [&](int row, int col, float y0, float y1) {
        if (col >= D) return;
        const int hh = col / Hd;
        store_pair(big + row * PQ + hh * HP + col - hh * Hd, y0 + bias[col], y1 + bias[col + 1]);
      });
    }
    __syncthreads();

    // ---- cross-attention: the ring's tiles of this layer, warp hh = head hh ----
    {
      const int hh = warp;
      const float c = sc * LOG2E;
      uint32_t qf[HP / 16][4];                // bf16: Q's A fragments (HP / 16 k16 steps)
      float acc[HP / 8][4], mrow[2], lrow[2];
      const T* qsrc = big + (lane & 15) * PQ + hh * HP + (lane >> 4) * PAD<T>;
      const int s0 = l * per_layer;
      for (int s = s0; s < s0 + per_layer; ++s) {
        cp_async_wait<XSTAGES - 2>();
        __syncthreads();                      // stage s is in; stage s - 1's buffer is free
        load_stage(s + XSTAGES - 1);
        if (hh >= H) continue;
        const int rem = s - s0, gi = rem / nT, mt = rem - gi * nT, m0 = mt * XT;
        const T* kt = ring + (s % XSTAGES) * 2 * XT * PQ + hh * HP;
        const T* vt = kt + XT * PQ;
        if (mt == 0) {                        // an image's first tile: fresh state
          if constexpr (!F32) {
#pragma unroll
            for (int ks = 0; ks < HP / 16; ++ks) ldsm_x4(qf[ks], qsrc + 16 * ks);
          }
#pragma unroll
          for (int n = 0; n < HP / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
          mrow[0] = mrow[1] = -INFINITY;
          lrow[0] = lrow[1] = 0.f;
        }
        if constexpr (F32) {
          cross_tile_f32<HP, XT>(qsrc, kt, vt, PQ, acc, mrow, lrow, m0, M, c);
        } else {
          // S: XT / 8 n8 tiles of keys, each HP / 16 k-steps (an ldmatrix.x4
          // gives two); O: HP / 8 n8 tiles of dims, XT / 16 k-steps of keys
          float sv[XT / 8][4];
#pragma unroll
          for (int j = 0; j < XT / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sv[j][e] = 0.f;
#pragma unroll
            for (int d = 0; d < HP / 32; ++d) {
              uint32_t kb[4];
              ldsm_x4(kb, kt + (8 * j + (lane & 7)) * PQ + 32 * d + 8 * (lane >> 3));
              mma_bf16(sv[j], qf[2 * d], kb[0], kb[1]);
              mma_bf16(sv[j], qf[2 * d + 1], kb[2], kb[3]);
            }
          }
          if (m0 + XT > M) {                  // the ragged last tile
#pragma unroll
            for (int j = 0; j < XT / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (m0 + 8 * j + 2 * t + (e & 1) >= M) sv[j][e] = -INFINITY;
          }
          float alpha[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < XT / 8; ++j) mx = fmaxf(mx, fmaxf(sv[j][2 * r], sv[j][2 * r + 1]));
            const float m_new = fmaxf(mrow[r], quad_max(mx) * c);   // finite: row 0 of a tile is live
            alpha[r] = fast_exp2(mrow[r] - m_new);
            mrow[r] = m_new;
            lrow[r] *= alpha[r];
          }
#pragma unroll
          for (int n = 0; n < HP / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
          uint32_t pf[XT / 16][4];            // P as A fragments, keys 16 kk .. 16 kk + 15
#pragma unroll
          for (int j = 0; j < XT / 8; ++j) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              p[e] = fast_exp2(fmaf(sv[j][e], c, -mrow[e >> 1]));   // masked: 2^-inf = 0
              lrow[e >> 1] += p[e];
            }
            pf[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
            pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
          }
#pragma unroll
          for (int kk = 0; kk < XT / 16; ++kk)
#pragma unroll
            for (int np = 0; np < HP / 16; ++np) {
              uint32_t vb[4];
              ldsm_x4_trans(vb, vt + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * PQ +
                                    16 * np + 8 * (lane >> 4));
              mma_bf16(acc[2 * np], pf[kk], vb[0], vb[1]);
              mma_bf16(acc[2 * np + 1], pf[kk], vb[2], vb[3]);
            }
        }
        if (mt == nT - 1) {                   // the image's last tile: its rows out
          const int lo = (img0 + gi) * K - row0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = g + 8 * r;
            const float inv = 1.f / quad_sum(lrow[r]);
            if (row < lo || row >= lo + K || row >= R) continue;
            T* dst = ab + row * PA + hh * Hd;
#pragma unroll
            for (int n = 0; n < HP / 8; ++n)
              if (8 * n + 2 * t < Hd)
                store_pair(dst + 8 * n + 2 * t, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
          }
        }
      }
    }
    __syncthreads();
    mma_linear(ab, PA, kp_d, wl(3, D, D), nt_d, residual(a.b[3] + (long long)l * D));
    __syncthreads();
    norm_rows(xs, PX, xa, PA, lns + D, lnb + D, R, D, a.eps);
    __syncthreads();

    // ---- ReLU FFN ----
    {
      const float* bias = a.b[4] + (long long)l * F;
      mma_linear(xa, PA, kp_d, wl(4, D, F), round_up(F, 8) / 8,
                 [&](int row, int col, float y0, float y1) {
                   const bool ok = col < F;   // F is even: a pair is in or out
                   store_pair(big + row * PF + col, ok ? fmaxf(y0 + bias[col], 0.f) : 0.f,
                              ok ? fmaxf(y1 + bias[col + 1], 0.f) : 0.f);
                 });
    }
    __syncthreads();
    mma_linear(big, PF, kp_f, wl(5, F, D), nt_d, residual(a.b[5] + (long long)l * D));
    __syncthreads();
    norm_rows(xs, PX, xa, PA, lns + 2 * D, lnb + 2 * D, R, D, a.eps);
    __syncthreads();
  }
  cp_async_wait<0>();
  for (int e = tid; e < R * D; e += MT) a.h[(long long)row0 * D + e] = xs[(e / D) * PX + e % D];
}

template <typename T, int HP>
int launch_mma(const MmaArgs<T>& a, void* stream) {
  const MmaSmem sm = mma_smem<T, HP>(a.D, a.H, a.F, a.L);
  if (sm.total > MMA_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      decoder_step_mma_kernel<T, HP>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = a.S == 1 ? (a.B + a.G - 1) / a.G : a.B * a.S;
  decoder_step_mma_kernel<T, HP><<<blocks, MT, sm.total, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// heads of at most 32 dims at pad 32, 33-64 at pad 64 (bf16 and f32)
template <typename T>
int run_mma(const MmaArgs<T>& a, void* stream) {
  const int Hd = a.H > 0 ? a.D / a.H : 0;
  const bool rows_ok = a.S == 1 ? a.G >= 1 && a.G * a.K <= ROWS
                                : a.G == 1 && a.S > 1 && a.S <= a.K &&
                                      (a.K + a.S - 1) / a.S <= ROWS;
  if (a.K < 1 || !rows_ok || a.H < 1 || a.H > MW || a.D % a.H != 0 || Hd % 2 != 0 ||
      Hd > 64 || a.F % 2 != 0 || a.step < 0 || a.step >= a.L || a.M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_pad(Hd) == 64) return launch_mma<T, 64>(a, stream);
  return launch_mma<T, 32>(a, stream);
}

template <typename T>
int entry_mma(const void* x, const int* anc, const void* ck, const void* cv, const void* xk,
              const void* xv, const void* qkv_w, const float* qkv_b, const void* so_w,
              const float* so_b, const void* cq_w, const float* cq_b, const void* co_w,
              const float* co_b, const void* f1_w, const float* f1_b, const void* f2_w,
              const float* f2_b, const float* ln_s, const float* ln_b, float* h, void* k_new,
              void* v_new, int B, int K, int L, int D, int H, int F, int nL, int M, int step,
              int G, int S, float eps, void* stream) {
  MmaArgs<T> a{static_cast<const T*>(x), anc, static_cast<const T*>(ck),
               static_cast<const T*>(cv), static_cast<const T*>(xk),
               static_cast<const T*>(xv),
               {static_cast<const uint4*>(qkv_w), static_cast<const uint4*>(so_w),
                static_cast<const uint4*>(cq_w), static_cast<const uint4*>(co_w),
                static_cast<const uint4*>(f1_w), static_cast<const uint4*>(f2_w)},
               {qkv_b, so_b, cq_b, co_b, f1_b, f2_b}, ln_s, ln_b, h,
               static_cast<T*>(k_new), static_cast<T*>(v_new),
               B, K, L, D, H, F, nL, M, step, G, S, eps};
  return run_mma<T>(a, stream);
}

}  // namespace

#define STEP_ARGS                                                              \
  const void *x, const int *anc, const void *ck, const void *cv,               \
      const void *xk, const void *xv, const void *qkv_w, const float *qkv_b,   \
      const void *so_w, const float *so_b, const void *cq_w,                   \
      const float *cq_b, const void *co_w, const float *co_b,                  \
      const void *f1_w, const float *f1_b, const void *f2_w,                   \
      const float *f2_b, const float *ln_s, const float *ln_b, float *h,       \
      void *k_new, void *v_new, int B, int K, int L, int D, int H, int F,      \
      int nL, int M, int step
#define STEP_PASS                                                              \
  x, anc, ck, cv, xk, xv, qkv_w, qkv_b, so_w, so_b, cq_w, cq_b, co_w, co_b,    \
      f1_w, f1_b, f2_w, f2_b, ln_s, ln_b, h, k_new, v_new, B, K, L, D, H, F,   \
      nL, M, step

ICEK_EXPORT int decoder_step_f32(STEP_ARGS, float eps, void* stream) {
  return entry<float>(STEP_PASS, eps, stream);
}
ICEK_EXPORT int decoder_step_bf16(STEP_ARGS, float eps, void* stream) {
  return entry<__nv_bfloat16>(STEP_PASS, eps, stream);
}

// the tensor-core route; weights packed by kernels/decoder_step.py::pack_mma
// (bf16) or pack_tf32 (f32), cross K/V by pad_cross_heads; G images a block,
// or S blocks an image
ICEK_EXPORT int decoder_step_bf16_mma(STEP_ARGS, int G, int S, float eps, void* stream) {
  return entry_mma<bf16>(STEP_PASS, G, S, eps, stream);
}
ICEK_EXPORT int decoder_step_f32_mma(STEP_ARGS, int G, int S, float eps, void* stream) {
  return entry_mma<float>(STEP_PASS, G, S, eps, stream);
}

// shared memory of the tensor-core route for (D, H, F, L), in bytes (f32 != 0: the f32
// route's), at the head pad of D / H
ICEK_EXPORT int decoder_step_mma_smem(int D, int H, int F, int L, int f32) {
  if (H < 1 || D % H) return -1;
  if (head_pad(D / H) == 64)
    return f32 ? mma_smem<float, 64>(D, H, F, L).total : mma_smem<bf16, 64>(D, H, F, L).total;
  return f32 ? mma_smem<float, 32>(D, H, F, L).total : mma_smem<bf16, 32>(D, H, F, L).total;
}
