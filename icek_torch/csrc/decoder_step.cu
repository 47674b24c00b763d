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
// 300 x 2 values, ~460 MB in bf16) plus the live cache prefix must be read
// from device memory: ~0.15 ms at 3.35 TB/s.  The weights (~2.5 M
// parameters, ~5 MB in bf16) do not fit shared memory (unlike the TPU's
// VMEM); they come from the 50 MB L2 to every block, so the fewer blocks
// read them the better.
//
// Route 1, bf16 on the tensor cores (decoder_step_mma_kernel; the wrapper's
// predicate kernels/decoder_step.py::uses_tensor_cores):
//   * a block owns the G*K hypothesis rows of G images (G*K <= 16, one
//     m16 tile; the wrapper picks G so the grid is about one wave: G = 2,
//     128 blocks at the beam shape), the last group ragged;
//   * the six linears run mma.sync m16n8k16 (bf16 in, f32 out) with the
//     activations rounded to bf16 in shared memory as the plain bf16 path
//     rounds them.  The weights are packed once per decode batch in the
//     order of the B fragments (kernels/decoder_step.py::pack_mma), so a
//     lane loads two k-steps of an n8 tile with one 16-byte load straight
//     from L2 into registers, two k-pairs ahead; each weight is read once
//     per block for all its rows (half the L2 traffic of one image a
//     block at G = 2) and kept in L2 (evict_last) against the stream;
//   * the cross K/V arrive head-major with Hd padded to 32 (laid out once
//     per decode batch, kernels/decoder_step.py::pad_cross_heads): 16-byte
//     aligned 640-byte rows that stream, 32 memory rows of one image a
//     stage, through a three-stage cp.async ring (evict_first in L2: each
//     byte is used once) that runs on across the layers, so the first
//     tiles of layer l + 1 load while layer l's FFN and layer l + 1's
//     self-attention and projections run.  Warp h takes head h: S = Q K^T
//     and O += P V on the tensor cores (ldmatrix / ldmatrix.trans from the
//     ring), online softmax in f32, flash style;
//   * self-attention: two threads a (row, head), each half of the head's
//     dims, an online softmax over the ancestry-gathered cache rows (4-byte
//     loads, the next row's in flight) and the current step's own K/V;
//   * biases, residual adds, LayerNorm and softmax statistics in f32 in
//     shared memory and registers.
//   On an H100 at step 15 of the beam shape it takes 0.37-0.38 ms against
//   the 0.154 ms byte bound (PERF.md): the stream runs at ~2.9 TB/s, but
//   the linears, bound by L2 (~5.5 TB/s of weight reads), and the stream
//   take turns (python -m icek_torch.kernels._variants decoder_step).
// Route 2, the CUDA-core kernel (decoder_step_kernel): f32, and any shape
// route 1 refuses.  A block owns R <= 8 hypotheses of one image (grid B x
// ceil(K / R)): R = min(K, 8), lowered until the block's shared memory fits
// the card, so beams of any width run (two or more blocks an image above 8,
// each reading the image's memory once).  Activations (R x D, R x 3D, R x F)
// and the (R*H) x max(M, L) attention weights live in shared memory; each
// memory / cache row a block reads is used by all its R hypotheses and all
// heads; products in f32 on the CUDA cores (TF32 would break the f32
// checks at 1e-4).
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
// Route 1: bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int MW = 10;            // warps of a block: one a head (H <= MW)
constexpr int MT = MW * 32;
constexpr int ROWS = 16;          // hypothesis rows of a block: one m16 tile
constexpr int XT = 32;            // memory rows of a cross stage
constexpr int XSTAGES = 3;        // depth of the cross ring
constexpr int HDP = 32;           // head dim of the padded cross layout
constexpr int NTW = 4;            // n8 tiles a warp takes per pass of a linear
constexpr int MMA_MAX_SMEM = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// layout of the tensor-core kernel's shared memory (bytes), for (D, H, F, L)
struct MmaSmem {
  int pa, pq, pf, pb;                       // row pitches in bf16
  int xs, xa, ab, big, anc, ring, total;    // offsets, then the size
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// a bf16 A operand of depth n: n padded to the 32-deep k-pairs, plus 8 so
// ldmatrix's eight rows fall in distinct banks
__host__ __device__ inline int a_pitch(int n) { return round_up(n, 32) + 8; }

__host__ __device__ inline MmaSmem mma_smem(int D, int H, int F, int L) {
  MmaSmem s;
  s.pa = a_pitch(D);
  s.pq = H * HDP + 8;
  s.pf = a_pitch(F);
  s.pb = max(max(round_up(3 * D, 8), s.pq), s.pf);
  s.xs = 0;                                           // f32 (ROWS, D): x
  s.xa = round_up(4 * ROWS * D, 16);                  // bf16 (ROWS, pa): x rounded
  s.ab = s.xa + 2 * ROWS * s.pa;                      // bf16 (ROWS, pa): attention out
  s.big = s.ab + 2 * ROWS * s.pa;                     // bf16 (ROWS, pb): qkv | q | hidden
  s.anc = s.big + 2 * ROWS * s.pb;                    // int (ROWS, L)
  s.ring = round_up(s.anc + 4 * ROWS * L, 16);        // bf16 XSTAGES x (K, V) x (XT, pq)
  s.total = s.ring + 2 * XSTAGES * 2 * XT * s.pq;
  return s;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

struct MmaArgs {
  const bf16* x;        // (B, K, D)
  const int* anc;       // (B, K, L)
  const bf16* ck;       // (nL, B, L*K, D)
  const bf16* cv;
  const bf16* xk;       // (nL, B, M, H, 32): head-major, Hd padded with zeros
  const bf16* xv;
  const uint4* w[6];    // qkv, so, cq, co, f1, f2 packed: (nL, n/8, din/32, 32 lanes)
  const float* b[6];    // their biases (nL, dout)
  const float* ln_s;    // (nL, 3, D)
  const float* ln_b;
  float* h;             // (B, K, D)
  bf16* k_new;          // (nL, B, K, D)
  bf16* v_new;
  int B, K, L, D, H, F, nL, M, step, G;
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

// y = A W for the block's 16 rows: A bf16 in shared memory (pitch pa, zero
// past its depth), W packed in B-fragment order (kpairs k-pairs of 32 for
// each of ntiles n8 tiles).  Warp w takes n8 tiles [NTW w, NTW w + NTW), then
// the same plus NTW * MW, ...; a lane loads its two k-steps of a tile as one
// 16-byte word, two k-pairs ahead of the products.  epi(row, col, y0, y1)
// gets the f32 sums of columns col, col + 1 (col even) of every row.
template <typename Epi>
__device__ __forceinline__ void mma_linear(const bf16* A, int pa, int kpairs,
                                           const uint4* __restrict__ W, int ntiles, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* a_src = A + (lane & 15) * pa + (lane >> 4) * 8;
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
      ldsm_x4(a0, a_src + 32 * kp);
      ldsm_x4(a1, a_src + 32 * kp + 16);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        mma_bf16(acc[j], a0, b[j].x, b[j].y);
        mma_bf16(acc[j], a1, b[j].z, b[j].w);
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
// x), f32, two-pass variance as the stock path; also x rounded to bf16 for
// the next product
__device__ __forceinline__ void norm_rows(float* xs, bf16* xa, int pa, const float* scale,
                                          const float* bias, int R, int D, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += MW) {
    float* xr = xs + r * D;
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
      xa[r * pa + d] = __float2bfloat16(y);
    }
  }
}

__global__ void __launch_bounds__(MT, 1) decoder_step_mma_kernel(MmaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, D = a.D, H = a.H, F = a.F, L = a.L, M = a.M, i = a.step;
  const int Hd = D / H, HP = H * HDP;
  const MmaSmem sm = mma_smem(D, H, F, L);
  const int PA = sm.pa, PQ = sm.pq, PF = sm.pf, PB = sm.pb;
  float* xs = reinterpret_cast<float*>(smem + sm.xs);
  bf16* xa = reinterpret_cast<bf16*>(smem + sm.xa);
  bf16* ab = reinterpret_cast<bf16*>(smem + sm.ab);
  bf16* big = reinterpret_cast<bf16*>(smem + sm.big);   // proj (pitch PB), qc (PQ), hid (PF)
  int* anc = reinterpret_cast<int*>(smem + sm.anc);
  bf16* ring = reinterpret_cast<bf16*>(smem + sm.ring);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * a.G;
  const int nimg = min(a.G, a.B - b0);
  const int R = nimg * K;                       // real rows; the rest stay zero
  const uint64_t stream = l2_policy_evict_first();

  // zeros in every pad of the bf16 operands (and finite values in `big`)
  for (int e = tid; e < (sm.anc - sm.xa) / 16; e += MT)
    reinterpret_cast<uint4*>(smem + sm.xa)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int e = tid; e < R * D; e += MT) {
    const bf16 v = a.x[(long long)b0 * K * D + e];
    xs[e] = __bfloat162float(v);
    xa[(e / D) * PA + e % D] = v;
  }
  for (int e = tid; e < R * L; e += MT) anc[e] = a.anc[(long long)b0 * K * L + e];

  // the cross ring: stage s is memory tile s % nT of image (s / nT) % nimg
  // of layer s / (nimg nT), K then V, 16 bytes a copy, zeros past M
  const int nT = (M + XT - 1) / XT;
  const int per_layer = nimg * nT, total = a.nL * per_layer;
  const int chunks = HP / 8;
  auto load_stage = [&](int s) {
    if (s < total) {
      const int l = s / per_layer, rem = s - l * per_layer;
      const int gi = rem / nT, m0 = (rem - gi * nT) * XT;
      const long long base = (((long long)l * a.B + b0 + gi) * M + m0) * HP;
      bf16* kd = ring + (s % XSTAGES) * 2 * XT * PQ;
      bf16* vd = kd + XT * PQ;
      for (int e = tid; e < XT * chunks; e += MT) {
        const int r = e / chunks, c = e - r * chunks;
        const bool ok = m0 + r < M;
        const long long src = ok ? base + (long long)r * HP + 8 * c : 0;
        cp_async16_hint(smem_u32(kd + r * PQ + 8 * c), a.xk + src, ok, stream);
        cp_async16_hint(smem_u32(vd + r * PQ + 8 * c), a.xv + src, ok, stream);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < XSTAGES - 1; ++s) load_stage(s);
  __syncthreads();

  const float sc = rsqrtf((float)Hd);
  const int kp_d = round_up(D, 32) / 32, kp_f = round_up(F, 32) / 32;
  const int nt_d = round_up(D, 8) / 8;
  for (int l = 0; l < a.nL; ++l) {
    const float* lns = a.ln_s + (long long)l * 3 * D;
    const float* lnb = a.ln_b + (long long)l * 3 * D;
    auto wl = [&](int j, int din, int dout) {
      return a.w[j] + (long long)l * (round_up(dout, 8) / 8) * (round_up(din, 32) / 32) * 32;
    };
    // residual sums: x += y + bias over the real rows
    auto residual = [&](const float* bias) {
      return [=](int row, int col, float y0, float y1) {
        if (row < R && col < D) {
          xs[row * D + col] += y0 + bias[col];
          xs[row * D + col + 1] += y1 + bias[col + 1];
        }
      };
    };

    // ---- QKV projection; this step's K/V rows out ----
    {
      const float* bias = a.b[0] + (long long)l * 3 * D;
      const long long out0 = ((long long)l * a.B + b0) * K * D;
      mma_linear(xa, PA, kp_d, wl(0, D, 3 * D), round_up(3 * D, 8) / 8,
                 [&](int row, int col, float y0, float y1) {
                   if (col >= 3 * D) return;
                   const uint32_t p = pack_bf16(y0 + bias[col], y1 + bias[col + 1]);
                   *reinterpret_cast<uint32_t*>(big + row * PB + col) = p;
                   if (row < R && col >= D) {
                     bf16* dst = col < 2 * D ? a.k_new + col - D : a.v_new + col - 2 * D;
                     *reinterpret_cast<uint32_t*>(dst + out0 + (long long)row * D) = p;
                   }
                 });
    }
    __syncthreads();

    // ---- self-attention: two threads a (row, head), half the dims each ----
    {
      const int half = tid & 1, w0 = 8 * half, nw = min(8, Hd / 2 - w0);
      const unsigned pair = 3u << (lane & 30);
      const long long img = (long long)L * K * D;
      for (int task = tid >> 1; task < R * H; task += MT / 2) {
        const int r = task / H, hh = task - r * H;
        const int col = hh * Hd + 2 * w0;
        const uint32_t* qs = reinterpret_cast<const uint32_t*>(big + r * PB + col);
        const uint32_t* ks_ = reinterpret_cast<const uint32_t*>(big + r * PB + D + col);
        const uint32_t* vs_ = reinterpret_cast<const uint32_t*>(big + r * PB + 2 * D + col);
        const long long base = ((long long)l * a.B + b0 + r / K) * img + col;
        const bf16* kb = a.ck + base;
        const bf16* vb = a.cv + base;
        const int* ar = anc + r * L;
        float q[16], o[16];
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const float2 f = w < nw ? unpack_bf16(qs[w]) : make_float2(0.f, 0.f);
          q[2 * w] = f.x;
          q[2 * w + 1] = f.y;
          o[2 * w] = o[2 * w + 1] = 0.f;
        }
        uint32_t kw[8], vw[8];
        // history row tt < i through the ancestry, or this step's own K/V
        auto fetch = [&](int tt, uint32_t (&kq)[8], uint32_t (&vq)[8]) {
          if (tt < i) {
            const long long off = (long long)(tt * K + ar[tt]) * D;
            const uint32_t* kp = reinterpret_cast<const uint32_t*>(kb + off);
            const uint32_t* vp = reinterpret_cast<const uint32_t*>(vb + off);
#pragma unroll
            for (int w = 0; w < 8; ++w) {
              kq[w] = w < nw ? __ldg(kp + w) : 0u;
              vq[w] = w < nw ? __ldg(vp + w) : 0u;
            }
          } else {
#pragma unroll
            for (int w = 0; w < 8; ++w) {
              kq[w] = w < nw ? ks_[w] : 0u;
              vq[w] = w < nw ? vs_[w] : 0u;
            }
          }
        };
        fetch(0, kw, vw);
        float m = -INFINITY, s = 0.f;
        for (int tt = 0; tt <= i; ++tt) {
          uint32_t kn[8], vn[8];
          if (tt < i) fetch(tt + 1, kn, vn);
          float dot = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) {
            const float2 k2 = unpack_bf16(kw[w]);
            dot = fmaf(q[2 * w], k2.x, fmaf(q[2 * w + 1], k2.y, dot));
          }
          dot += __shfl_xor_sync(pair, dot, 1);
          const float sv = dot * sc;
          const float m_new = fmaxf(m, sv);
          const float alpha = __expf(m - m_new), p = __expf(sv - m_new);
          s = s * alpha + p;
#pragma unroll
          for (int w = 0; w < 8; ++w) {
            const float2 v2 = unpack_bf16(vw[w]);
            o[2 * w] = fmaf(p, v2.x, o[2 * w] * alpha);
            o[2 * w + 1] = fmaf(p, v2.y, o[2 * w + 1] * alpha);
          }
          m = m_new;
          if (tt < i) {
#pragma unroll
            for (int w = 0; w < 8; ++w) {
              kw[w] = kn[w];
              vw[w] = vn[w];
            }
          }
        }
        const float inv = 1.f / s;
        uint32_t* dst = reinterpret_cast<uint32_t*>(ab + r * PA + col);
#pragma unroll
        for (int w = 0; w < 8; ++w)
          if (w < nw) dst[w] = pack_bf16(o[2 * w] * inv, o[2 * w + 1] * inv);
      }
    }
    __syncthreads();

    // ---- self-attention out projection (+ residual); q's buffer zeroed ----
    for (int e = tid; e < ROWS * PQ / 8; e += MT)
      reinterpret_cast<uint4*>(big)[e] = make_uint4(0u, 0u, 0u, 0u);
    mma_linear(ab, PA, kp_d, wl(1, D, D), nt_d, residual(a.b[1] + (long long)l * D));
    __syncthreads();
    norm_rows(xs, xa, PA, lns, lnb, R, D, a.eps);
    __syncthreads();

    // ---- cross-attention query, head-major with Hd padded to 32 ----
    {
      const float* bias = a.b[2] + (long long)l * D;
      mma_linear(xa, PA, kp_d, wl(2, D, D), nt_d, [&](int row, int col, float y0, float y1) {
        if (col >= D) return;
        const int hh = col / Hd;
        *reinterpret_cast<uint32_t*>(big + row * PQ + hh * HDP + col - hh * Hd) =
            pack_bf16(y0 + bias[col], y1 + bias[col + 1]);
      });
    }
    __syncthreads();

    // ---- cross-attention: the ring's tiles of this layer, warp hh = head hh ----
    {
      const int hh = warp;
      const float c = sc * LOG2E;
      uint32_t qf[2][4];
      float acc[4][4], mrow[2], lrow[2];
      const int s0 = l * per_layer;
      for (int s = s0; s < s0 + per_layer; ++s) {
        cp_async_wait<XSTAGES - 2>();
        __syncthreads();                      // stage s is in; stage s - 1's buffer is free
        load_stage(s + XSTAGES - 1);
        if (hh >= H) continue;
        const int rem = s - s0, gi = rem / nT, mt = rem - gi * nT, m0 = mt * XT;
        const bf16* kt = ring + (s % XSTAGES) * 2 * XT * PQ + hh * HDP;
        const bf16* vt = kt + XT * PQ;
        if (mt == 0) {                        // an image's first tile: fresh state
          const bf16* qsrc = big + (lane & 15) * PQ + hh * HDP + (lane >> 4) * 8;
          ldsm_x4(qf[0], qsrc);
          ldsm_x4(qf[1], qsrc + 16);
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
          mrow[0] = mrow[1] = -INFINITY;
          lrow[0] = lrow[1] = 0.f;
        }
        float sv[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t kb[4];
          ldsm_x4(kb, kt + (8 * j + (lane & 7)) * PQ + 8 * (lane >> 3));
#pragma unroll
          for (int e = 0; e < 4; ++e) sv[j][e] = 0.f;
          mma_bf16(sv[j], qf[0], kb[0], kb[1]);
          mma_bf16(sv[j], qf[1], kb[2], kb[3]);
        }
        if (m0 + XT > M) {                    // the ragged last tile
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (m0 + 8 * j + 2 * t + (e & 1) >= M) sv[j][e] = -INFINITY;
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) mx = fmaxf(mx, fmaxf(sv[j][2 * r], sv[j][2 * r + 1]));
          const float m_new = fmaxf(mrow[r], quad_max(mx) * c);   // finite: row 0 of a tile is live
          alpha[r] = fast_exp2(mrow[r] - m_new);
          mrow[r] = m_new;
          lrow[r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
        uint32_t pf[2][4];                    // P as A fragments, keys 16 kk .. 16 kk + 15
#pragma unroll
        for (int j = 0; j < 4; ++j) {
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
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t vb[4];
            ldsm_x4_trans(vb, vt + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * PQ +
                                  16 * np + 8 * (lane >> 4));
            mma_bf16(acc[2 * np], pf[kk], vb[0], vb[1]);
            mma_bf16(acc[2 * np + 1], pf[kk], vb[2], vb[3]);
          }
        if (mt == nT - 1) {                   // the image's last tile: its rows out
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = g + 8 * r;
            const float inv = 1.f / quad_sum(lrow[r]);
            if (row < gi * K || row >= gi * K + K) continue;
            uint32_t* dst = reinterpret_cast<uint32_t*>(ab + row * PA + hh * Hd);
#pragma unroll
            for (int n = 0; n < 4; ++n)
              if (8 * n + 2 * t < Hd)
                dst[4 * n + t] = pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
          }
        }
      }
    }
    __syncthreads();
    mma_linear(ab, PA, kp_d, wl(3, D, D), nt_d, residual(a.b[3] + (long long)l * D));
    __syncthreads();
    norm_rows(xs, xa, PA, lns + D, lnb + D, R, D, a.eps);
    __syncthreads();

    // ---- ReLU FFN ----
    {
      const float* bias = a.b[4] + (long long)l * F;
      mma_linear(xa, PA, kp_d, wl(4, D, F), round_up(F, 8) / 8,
                 [&](int row, int col, float y0, float y1) {
                   const bool ok = col < F;   // F is even: a pair is in or out
                   *reinterpret_cast<uint32_t*>(big + row * PF + col) =
                       pack_bf16(ok ? fmaxf(y0 + bias[col], 0.f) : 0.f,
                                 ok ? fmaxf(y1 + bias[col + 1], 0.f) : 0.f);
                 });
    }
    __syncthreads();
    mma_linear(big, PF, kp_f, wl(5, F, D), nt_d, residual(a.b[5] + (long long)l * D));
    __syncthreads();
    norm_rows(xs, xa, PA, lns + 2 * D, lnb + 2 * D, R, D, a.eps);
    __syncthreads();
  }
  cp_async_wait<0>();
  for (int e = tid; e < R * D; e += MT) a.h[(long long)b0 * K * D + e] = xs[e];
}

int run_mma(const MmaArgs& a, void* stream) {
  const int Hd = a.H > 0 ? a.D / a.H : 0;
  if (a.K < 1 || a.G < 1 || a.G * a.K > ROWS || a.H < 1 || a.H > MW || a.D % a.H != 0 ||
      Hd % 2 != 0 || Hd > HDP || a.F % 2 != 0 || a.step < 0 || a.step >= a.L || a.M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaSmem sm = mma_smem(a.D, a.H, a.F, a.L);
  if (sm.total > MMA_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      decoder_step_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.B + a.G - 1) / a.G;
  decoder_step_mma_kernel<<<blocks, MT, sm.total, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
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
      int nL, int M, int step, float eps, void *stream
#define STEP_PASS                                                              \
  x, anc, ck, cv, xk, xv, qkv_w, qkv_b, so_w, so_b, cq_w, cq_b, co_w, co_b,    \
      f1_w, f1_b, f2_w, f2_b, ln_s, ln_b, h, k_new, v_new, B, K, L, D, H, F,   \
      nL, M, step, eps, stream

ICEK_EXPORT int decoder_step_f32(STEP_ARGS) { return entry<float>(STEP_PASS); }
ICEK_EXPORT int decoder_step_bf16(STEP_ARGS) { return entry<__nv_bfloat16>(STEP_PASS); }

// the tensor-core route; weights packed by kernels/decoder_step.py::pack_mma,
// cross K/V by pad_cross_heads; G images a block
ICEK_EXPORT int decoder_step_bf16_mma(
    const void* x, const int* anc, const void* ck, const void* cv, const void* xk,
    const void* xv, const void* qkv_w, const float* qkv_b, const void* so_w,
    const float* so_b, const void* cq_w, const float* cq_b, const void* co_w,
    const float* co_b, const void* f1_w, const float* f1_b, const void* f2_w,
    const float* f2_b, const float* ln_s, const float* ln_b, float* h, void* k_new,
    void* v_new, int B, int K, int L, int D, int H, int F, int nL, int M, int step, int G,
    float eps, void* stream) {
  MmaArgs a{static_cast<const bf16*>(x), anc, static_cast<const bf16*>(ck),
            static_cast<const bf16*>(cv), static_cast<const bf16*>(xk),
            static_cast<const bf16*>(xv),
            {static_cast<const uint4*>(qkv_w), static_cast<const uint4*>(so_w),
             static_cast<const uint4*>(cq_w), static_cast<const uint4*>(co_w),
             static_cast<const uint4*>(f1_w), static_cast<const uint4*>(f2_w)},
            {qkv_b, so_b, cq_b, co_b, f1_b, f2_b}, ln_s, ln_b, h,
            static_cast<bf16*>(k_new), static_cast<bf16*>(v_new),
            B, K, L, D, H, F, nL, M, step, G, eps};
  return run_mma(a, stream);
}

// shared memory of the tensor-core route for (D, H, F, L), in bytes
ICEK_EXPORT int decoder_step_mma_smem(int D, int H, int F, int L) {
  return mma_smem(D, H, F, L).total;
}
