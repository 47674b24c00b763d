// Shared helpers for the port's CUDA kernels (plain C interface, loaded
// with ctypes; see icek_torch/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define ICEK_EXPORT extern "C" __attribute__((visibility("default")))

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Counter-based random bits for the dropout kernels: Philox-4x32-10
// (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11),
// written out here.  The key is (seed, stream), the counter a 64-bit block
// number; one block yields four 32-bit words.  A kernel's mask depends only
// on (seed, stream, element index), never on its tiling, so a backward
// kernel with another tiling regenerates the forward's mask.
__device__ __forceinline__ uint4 philox4x32_10(uint32_t seed, uint32_t stream,
                                               unsigned long long block) {
  uint32_t c0 = static_cast<uint32_t>(block);
  uint32_t c1 = static_cast<uint32_t>(block >> 32);
  uint32_t c2 = 0u, c3 = 0u, k0 = seed, k1 = stream;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word_of(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// 32 random bits of element `index` under (seed, stream): word index % 4 of
// Philox block index / 4, so four adjacent elements share one block.
__device__ __forceinline__ uint32_t random_bits(uint32_t seed, uint32_t stream,
                                                unsigned long long index) {
  return word_of(philox4x32_10(seed, stream, index >> 2),
                 static_cast<int>(index & 3ull));
}

// Dropout keeps an element iff the top 24 of its bits lie below
// int((1 - rate) * 2^24): the integer compare of the TPU kernels
// (icek_tpu/kernels/flash_attention.py::_keep_mask).
__device__ __forceinline__ bool keep_bits(uint32_t bits, uint32_t thresh) {
  return (bits >> 8) < thresh;
}

constexpr uint32_t KEEP_ALL = 1u << 24;     // thresh at rate 0: no Philox needed
constexpr uint32_t STREAM_FLASH = 1u;       // attention-weight dropout
constexpr uint32_t STREAM_NORM = 2u;        // residual / FFN dropout

// round a float through T (the working dtype), as a store and reload would
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// Tensor-core building blocks (the bf16 flash and score-head kernels):
// cp.async staging, ldmatrix operand loads and mma.sync m16n8k16.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4, 8 or 16 bytes global -> shared, asynchronously; zeros when !valid (the
// source is then not read).  Both addresses are aligned to the size.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const uint32_t n = valid ? 4u : 0u;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  const uint32_t n = valid ? 8u : 0u;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const uint32_t n = valid ? 16u : 0u;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A B for one m16n8k16 tile: A row-major bf16, B column-major bf16
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// TF32 tensor-core products of f32 operands (the f32 flash backward and the
// f32 decoder step): an operand split into TF32 pieces, mma.sync m16n8k8.
// x rounded to TF32 (to nearest, ties away from zero), as a b32 register
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as P TF32 pieces, largest first (each the TF32 rounding of what the
// ones before it left): P = 2 (hi + lo) gives x to 2^-22 of |x|; P = 1 keeps
// x, which must then be exact in TF32 (bf16)
template <int P>
__device__ __forceinline__ void split_tf32(float x, uint32_t (&p)[P]) {
  if constexpr (P == 1) {
    p[0] = __float_as_uint(x);
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      p[k] = tf32_rna(x);
      x -= __uint_as_float(p[k]);
    }
  }
}

// x as hi + lo by integer arithmetic: hi = tf32_rna(x)'s bits for finite x
// (half of the 13 dropped bits' weight added to the magnitude, then the bits
// cleared), lo = x - hi, exact in f32, left unrounded (an mma reads the top 19
// bits of a TF32 operand: lo truncated).  Three instructions, where
// split_tf32<2>'s cvt.rna pair expands into a compare-and-select sequence.
__device__ __forceinline__ void split_tf32_bits(float x, uint32_t (&p)[2]) {
  p[0] = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  p[1] = __float_as_uint(x - __uint_as_float(p[0]));
}

// D += A B for one m16n8k8 tile: A row-major TF32, B column-major TF32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment as P TF32 pieces: piece k of register i is p[k][i]
template <int P>
struct FragA {
  uint32_t p[P][4];
};

// c += a b over the pieces whose ranks sum to less than P (P = 2: lo hi + hi
// lo + hi hi, the lo lo term below the pieces' own rounding), smallest
// first; the B fragment (b0, b1) is split here
template <int P>
__device__ __forceinline__ void mma_pieces(float (&c)[4], const FragA<P>& a, float b0,
                                           float b1) {
  uint32_t x[P], y[P];
  split_tf32<P>(b0, x);
  split_tf32<P>(b1, y);
#pragma unroll
  for (int r = P - 1; r >= 0; --r)
#pragma unroll
    for (int i = 0; i <= r; ++i) mma_tf32(c, a.p[i], x[r - i], y[r - i]);
}

// c += a b as mma_pieces, with the product formed apart and added to c by
// f32 adds (round to nearest): dQ, dK and dV sum one such product per 8 keys
// (queries), hundreds of them, and the tensor cores' own accumulation is
// not round to nearest (csrc/flash_attention.cu's header)
template <int P>
__device__ __forceinline__ void mma_add(float (&c)[4], const FragA<P>& a, float b0, float b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_pieces<P>(t, a, b0, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// blocks of `kernel` resident on the current device at once (the occupancy
// API times the SM count): a persistent kernel's grid, or the block count a
// wrapper splits its work into
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

ICEK_EXPORT const char* icek_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
