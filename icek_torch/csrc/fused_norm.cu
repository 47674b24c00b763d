// Residual-dropout-LayerNorm (forward and backward) and plain dropout for
// Hopper (sm_90a), f32 and bf16.
//
// Replaces the three Pallas kernels of icek_tpu/kernels/fused_norm.py:
//   _ln_fwd    y = LayerNorm(x + dropout(h)) over the last axis, row
//              statistics in float32, y in x's dtype, scale / bias float32;
//   _ln_bwd    regenerates the mask, recomputes the row statistics, emits
//              dx, dh (masked and scaled), dscale = sum_rows g * zhat and
//              dbias = sum_rows g in float32;
//   _drop_call out = where(keep, in / (1 - rate), 0), one entry point for
//              the forward and the backward (which keeps only the seed).
//
// What bounds them: bytes.  Each is one pass over (N, D) tensors (3, 5 and
// 2 of them) with a few operations per element, far below the card's
// operations-per-byte balance; at the train steps' 8192 to 77056 rows a
// pass moves 5 to 140 MB, a few to 40 microseconds at the card's rate, so
// launch, the last wave's tail and the bytes each warp keeps in flight
// decide how close a kernel comes.
//   * The bf16 forward (ln_fwd_span_kernel, when D % 4 == 0 and x, h, y
//     lie on 16-byte boundaries): a team (a half warp for rows of up to
//     320 columns, as the backward's bf16 teams, else a warp) owns a span
//     of two rows that lies in memory as one 16-byte-aligned run, so every
//     access is 16 bytes, even where a 600-byte row starts mid-line; a
//     chunk of 16 bytes is two groups of four columns, and at D % 8 == 4
//     one chunk holds the last group of one row and the first of the next.
//     At D 300 a lane holds 5 of a span's 75 chunks (80 slots; a warp a
//     span would leave 21 of 96 idle).  The span's two rows reduce together
//     (two sums a shuffle).  Persistent blocks, one wave of them, walk the
//     spans; each warp copies its teams' next spans into the other stage of
//     a two-stage ring in shared memory by cp.async while it reduces the
//     current ones.  Below some 26000 rows it is bound by its instructions
//     (a variant that loads nothing takes as long; Philox is a quarter of
//     it), above by the bytes.  It runs when its teams walk two spans or
//     more each (FWD_SPAN_MIN_SETS).  f32 rows, fewer bf16 rows, and rows
//     that miss the alignment take ln_fwd_kernel: one warp a row, 16-, 8-
//     or 4-byte accesses (a span of one f32 row timed slower than it at
//     every train-step row count).
//   * Dropout (dropout_flat_kernel, when D % 4 == 0 and both pointers lie on
//     16-byte boundaries): the tensor as one flat run of 16-byte chunks, two
//     chunks a thread in flight before their Philox blocks are drawn, one
//     wave of blocks, streaming loads; other shapes take dropout_kernel.
//   * The backward (see its section) keeps the next row's loads in flight
//     under the current row's reductions, fuses its four row reductions
//     into two, and sums dscale / dbias without atomics: the TPU kernel
//     carries them across its sequential grid, here persistent blocks keep
//     them in registers, each block writes one partial row and a second
//     kernel adds the partial rows in a fixed order.
//
// Mask: element (row, col) keeps iff keep_bits(random_bits(seed,
// STREAM_NORM, row * D4 + col)) with D4 = D rounded up to a multiple of 4,
// so the four columns of a group share one Philox block whatever D is.
// When D % 4 == 0 the group at element offset e of the (N, D) tensor is
// Philox block e / 4, which is how the flat and span kernels number it.
// Every kernel adds `block0` to the block: a data-parallel rank holding rows
// r0.. of a global (N, D) tensor passes block0 = r0 * D4 / 4 and draws the
// global tensor's mask.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;       // rows per block and pass
constexpr int MAXD = 1024;     // a lane holds NG = 4 or 8 groups: D <= 128 * NG

// four adjacent columns starting at `col` of a row of D values
template <typename T>
__device__ __forceinline__ void load4(const T* row, int col, int D, bool vec,
                                      float out[4]);

template <>
__device__ __forceinline__ void load4<float>(const float* row, int col, int D,
                                             bool vec, float out[4]) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(row + col);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = col + c < D ? row[col + c] : 0.f;
  }
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* row,
                                                     int col, int D, bool vec,
                                                     float out[4]) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + col);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    out[0] = __low2float(a); out[1] = __high2float(a);
    out[2] = __low2float(b); out[3] = __high2float(b);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[c] = col + c < D ? __bfloat162float(row[col + c]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* row, int col, int D, bool vec,
                                       const float in[4]);

template <>
__device__ __forceinline__ void store4<float>(float* row, int col, int D,
                                              bool vec, const float in[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(row + col) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < D) row[col + c] = in[c];
  }
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* row, int col,
                                                      int D, bool vec,
                                                      const float in[4]) {
  if (vec) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(in[0], in[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(in[2], in[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&a);
    raw.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(row + col) = raw;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < D) row[col + c] = __float2bfloat16(in[c]);
  }
}

// keep flags of the group's four columns as the low bits of the result
__device__ __forceinline__ uint32_t keep4(uint32_t seed, uint32_t thresh,
                                          unsigned long long block0,
                                          unsigned long long block) {
  if (thresh >= KEEP_ALL) return 0xFu;
  const uint4 r = philox4x32_10(seed, STREAM_NORM, block0 + block);
  return (keep_bits(r.x, thresh) ? 1u : 0u) | (keep_bits(r.y, thresh) ? 2u : 0u) |
         (keep_bits(r.z, thresh) ? 4u : 0u) | (keep_bits(r.w, thresh) ? 8u : 0u);
}

// z = x + dropout(h) for this lane's groups of one row; returns the lane's
// part of sum(z).  `keeps` gets four flags per group.
template <typename T, int NG>
__device__ __forceinline__ float load_row(const T* xr, const T* hr, long long row,
                                          int D, int G, bool vec, int lane,
                                          uint32_t seed, unsigned long long block0,
                                          uint32_t thresh, float inv,
                                          float z[NG][4], uint32_t& keeps) {
  float sum = 0.f;
  keeps = 0u;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = lane + 32 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) z[i][c] = 0.f;
    if (g < G) {
      float xv[4], hv[4];
      load4<T>(xr, 4 * g, D, vec, xv);
      load4<T>(hr, 4 * g, D, vec, hv);
      const uint32_t k = keep4(seed, thresh, block0, (unsigned long long)row * G + g);
      keeps |= k << (4 * i);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        z[i][c] = xv[c] + ((k >> c) & 1u ? hv[c] * inv : 0.f);
        sum += z[i][c];
      }
    }
  }
  return sum;
}

// centre z in place and return rstd; columns at or beyond D stay 0
template <int NG>
__device__ __forceinline__ float normalise(float z[NG][4], float sum, int D,
                                           int G, int lane, float eps) {
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = lane + 32 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool valid = g < G && 4 * g + c < D;
      z[i][c] = valid ? z[i][c] - mean : 0.f;
      sq += z[i][c] * z[i][c];
    }
  }
  return rsqrtf(warp_sum(sq) / D + eps);
}

template <typename T, int NG>
__global__ void __launch_bounds__(32 * WARPS) ln_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ h,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ y, long long N, int D, float eps, float inv,
    uint32_t thresh, uint32_t seed, int vec, unsigned long long block0) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  const int G = (D + 3) >> 2;
  float z[NG][4];
  uint32_t keeps;
  const float sum = load_row<T, NG>(x + row * D, h + row * D, row, D, G, vec != 0,
                                lane, seed, block0, thresh, inv, z, keeps);
  const float rstd = normalise<NG>(z, sum, D, G, lane, eps);
  const bool vec_par = D % 4 == 0;   // scale / bias are float32 and 16-byte aligned
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = lane + 32 * i;
    if (g < G) {
      float sv[4], bv[4], out[4];
      load4<float>(scale, 4 * g, D, vec_par, sv);
      load4<float>(bias, 4 * g, D, vec_par, bv);
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = z[i][c] * rstd * sv[c] + bv[c];
      store4<T>(y + row * D, 4 * g, D, vec != 0, out);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward and dropout, 16-byte path (D % 4 == 0, 16-byte-aligned pointers)
// ---------------------------------------------------------------------------

// sum over a team of LPR lanes (a half warp or a warp); every lane of the
// warp takes part, each half summing its own lanes
template <int LPR>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of a row: eight bf16 or four f32 values
template <typename T> struct Chunk;
template <> struct Chunk<float> { using type = float4; };
template <> struct Chunk<__nv_bfloat16> { using type = uint4; };

__device__ __forceinline__ void unpack_chunk(float4 r, float (&out)[4]) {
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}

__device__ __forceinline__ void unpack_chunk(uint4 r, float (&out)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[q]));
    out[2 * q] = f.x;
    out[2 * q + 1] = f.y;
  }
}

__device__ __forceinline__ float4 pack_chunk(const float (&in)[4]) {
  return make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack_chunk(const float (&in)[8]) {
  return make_uint4(pack_bf16x2(in[0], in[1]), pack_bf16x2(in[2], in[3]),
                    pack_bf16x2(in[4], in[5]), pack_bf16x2(in[6], in[7]));
}

// chunk at element offset e of a tensor of `total` elements (a multiple of
// 4): 16 bytes with a streaming (evict-first) load, or, for a bf16 chunk
// that the tensor's end cuts after its first group, 8 bytes and zeros
template <typename T>
__device__ __forceinline__ typename Chunk<T>::type load_chunk(const T* p, long long e,
                                                              long long total) {
  using R = typename Chunk<T>::type;
  constexpr int CE = 16 / sizeof(T);
  if (e + CE <= total) return __ldcs(reinterpret_cast<const R*>(p + e));
  R r{};
  if constexpr (sizeof(T) == 2) {
    if (e < total) {
      const uint2 half = __ldcs(reinterpret_cast<const uint2*>(p + e));
      r.x = half.x;
      r.y = half.y;
    }
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* p, long long e, long long total,
                                            typename Chunk<T>::type r) {
  using R = typename Chunk<T>::type;
  constexpr int CE = 16 / sizeof(T);
  if (e + CE <= total) {
    *reinterpret_cast<R*>(p + e) = r;
  } else if constexpr (sizeof(T) == 2) {
    if (e < total) *reinterpret_cast<uint2*>(p + e) = make_uint2(r.x, r.y);
  }
}

constexpr int FWD_THREADS = 128;
constexpr int FWD_STAGES = 2;    // span sets a warp's ring holds: one in flight under one
                                 // (three measured slower)
// the span kernel runs when its one-wave grid's teams walk at least this
// many spans each, so that a team's ring has a next span to copy ahead;
// with fewer, the row kernel, with more warps resident, is faster (D 300,
// H100 80GB HBM3 at 700 W: at 1.58 spans a team the span kernel took 11%
// longer than the row kernel, at 1.94 7% less)
constexpr long long FWD_SPAN_MIN_SETS = 2;

// the span kernel's team: rows of G = D / 4 <= 80 chunks a span (D <= 320)
// take half-warp teams of 5 chunks a lane (80 slots), as the backward's
// bf16 teams; wider rows a warp
__host__ __device__ constexpr int fwd_team_lanes(int G) { return G <= 16 * 5 ? 16 : 32; }

// shared memory of the span kernel for rows of D: scale and bias, then each
// warp's ring of FWD_STAGES sets of (x, h) spans, one span a team
__host__ __device__ constexpr size_t fwd_smem_bytes(int D) {
  return 16 * (size_t)(D / 4) *
         (2 + (FWD_THREADS / 32) * FWD_STAGES * 2 * (32 / fwd_team_lanes(D / 4)));
}

// 16 bytes global -> shared, asynchronously, of which the first `bytes`
// (16, 8 or 0) are read and the rest zero-filled
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// A team of LPR lanes (a half warp or a warp) a span of two bf16 rows at a
// time; the warp's teams take consecutive spans.  The spans' x and h arrive
// in a stage of the warp's ring by cp.async, FWD_STAGES - 1 span sets ahead
// of the set being reduced; lane l of a team then holds chunks l, l + LPR,
// ... (NC of them) of its span's 2 D elements, chunk c = groups 2 c and 2 c
// + 1 of the span (group q: row q / G of the span, columns 4 (q % G) ..).
// A chunk that the tensor's end cuts after its first group copies 8 bytes
// and zeros.  The loop runs while the warp's first span exists, so every
// lane of the warp takes every shuffle; a team past the last span reduces
// zeros and stores nothing.
template <int LPR, int NC>
__global__ void __launch_bounds__(FWD_THREADS) ln_fwd_span_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
    const float* __restrict__ scale, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ y, long long N, int D, float eps, float inv,
    uint32_t thresh, uint32_t seed, unsigned long long block0) {
  using T = __nv_bfloat16;
  constexpr int CE = 8;                        // elements a chunk
  constexpr int TEAMS = 32 / LPR;              // spans a warp takes at once
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = lane / LPR, l = lane % LPR;
  const int G = D >> 2;                        // groups a row, and chunks a span
  float4* sc = reinterpret_cast<float4*>(smem);
  float4* bi = sc + G;
  uint4* ring = reinterpret_cast<uint4*>(bi + G) + (size_t)warp * FWD_STAGES * TEAMS * 2 * G;
  for (int g = threadIdx.x; g < G; g += FWD_THREADS) {
    sc[g] = reinterpret_cast<const float4*>(scale)[g];
    bi[g] = reinterpret_cast<const float4*>(bias)[g];
  }
  __syncthreads();
  const long long total = N * D;
  const long long spans = (N + 1) / 2;
  const long long stride = (long long)gridDim.x * (FWD_THREADS / 32) * TEAMS;
  const long long first = ((long long)blockIdx.x * (FWD_THREADS / 32) + warp) * TEAMS;
  // the team's span of the set at `s0` into stage `stage` (x chunks, then h
  // chunks); one commit group a call, empty past the last span, so the
  // groups count iterations
  auto issue = [&](long long s0, int stage) {
    const long long s = s0 + team;
    if (s < spans) {
      uint4* dst = ring + ((size_t)stage * TEAMS + team) * 2 * G;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = l + LPR * i;
        if (c < G) {
          const long long e = s * 2 * D + (long long)c * CE;
          const long long left = (total - e) * (long long)sizeof(T);
          const int bytes = left >= 16 ? 16 : left > 0 ? static_cast<int>(left) : 0;
          const long long src = bytes ? e : 0;
          cp_async16_n(smem_u32(dst + c), x + src, bytes);
          cp_async16_n(smem_u32(dst + G + c), h + src, bytes);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < FWD_STAGES - 1; ++st) issue(first + st * stride, st);
  int stage = 0;
  for (long long s0 = first; s0 < spans; s0 += stride) {
    cp_async_wait<FWD_STAGES - 2>();           // this lane's copies of the set are in
    __syncwarp();                              // ... and every lane's
    // the stage read one iteration ago is free: refill it FWD_STAGES - 1 ahead
    issue(s0 + (FWD_STAGES - 1) * stride, stage == 0 ? FWD_STAGES - 1 : stage - 1);
    const uint4* cur = ring + ((size_t)stage * TEAMS + team) * 2 * G;
    const long long sp = s0 + team;
    const long long base = sp * 2 * D;         // the span's first element
    // z = x + dropout(h); each row's sum (groups past the tensor read as 0)
    float z[NC][CE];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = l + LPR * i;
#pragma unroll
      for (int v = 0; v < CE; ++v) z[i][v] = 0.f;
      if (c < G && sp < spans) {
        float xv[CE], hv[CE];
        unpack_chunk(cur[c], xv);
        unpack_chunk(cur[G + c], hv);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = 2 * c + j;
          const uint32_t k = keep4(seed, thresh, block0, (unsigned long long)(base >> 2) + q);
          float part = 0.f;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int ev = 4 * j + v;
            z[i][ev] = xv[ev] + ((k >> v) & 1u ? hv[ev] * inv : 0.f);
            part += z[i][ev];
          }
          if (q >= G) sum1 += part;
          else sum0 += part;
        }
      }
    }
    __syncwarp();                              // every lane is done with the stage
    stage = stage == FWD_STAGES - 1 ? 0 : stage + 1;
    const float mean0 = team_sum<LPR>(sum0) / D, mean1 = team_sum<LPR>(sum1) / D;
    float sq0 = 0.f, sq1 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = l + LPR * i;
      if (c < G) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool second = 2 * c + j >= G;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float d = z[i][4 * j + v] - (second ? mean1 : mean0);
            z[i][4 * j + v] = d;
            if (second) sq1 += d * d;
            else sq0 += d * d;
          }
        }
      }
    }
    const float rstd0 = rsqrtf(team_sum<LPR>(sq0) / D + eps);
    const float rstd1 = rsqrtf(team_sum<LPR>(sq1) / D + eps);
    if (sp >= spans) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = l + LPR * i;
      if (c < G) {
        float out[CE];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = 2 * c + j;
          const bool second = q >= G;
          const float4 s4 = sc[second ? q - G : q], b4 = bi[second ? q - G : q];
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
          const float rs = second ? rstd1 : rstd0;
#pragma unroll
          for (int v = 0; v < 4; ++v) out[4 * j + v] = z[i][4 * j + v] * rs * sv[v] + bv[v];
        }
        store_chunk<T>(y, base + (long long)c * CE, total, pack_chunk(out));
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Backward.  A team of LPR lanes (a half warp or a warp) owns one row at a
// time; lane l of a team holds groups l, l + LPR, ... (NG of them) of four
// columns.  Persistent blocks, as many as fit on the card at once, walk the
// rows with a fixed stride; a team issues the loads of x, h and gy of its
// next row before it reduces the current one, so each warp keeps a row's
// bytes in flight under its arithmetic (rows of up to 512 bf16 or 384 f32
// columns; wider ones load after the current row).  Per row there are two
// team reductions: (count, mean, M2) combined by Chan's rule, which gives the
// centred variance in one pass, and the pair (sum g s zhat, sum g s).  Each
// lane sums g * zhat and g over its columns for dscale / dbias; a block folds
// its teams in a fixed order into one partial row, and ln_bwd_reduce_kernel
// adds the partial rows in a fixed order: no atomics, the same bits from
// launch to launch.
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 128;

// four adjacent elements of a row as they lie in memory: 16 bytes (f32) or
// 8 bytes (bf16); columns at or beyond D read as 0 off the vector path
template <typename T> struct Raw4;
template <> struct Raw4<float> { using type = float4; };
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };

template <typename T>
__device__ __forceinline__ typename Raw4<T>::type load_raw(const T* row, int col, int D,
                                                           bool vec);

template <>
__device__ __forceinline__ float4 load_raw<float>(const float* row, int col, int D,
                                                  bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(row + col);
  float e[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) e[c] = col + c < D ? row[col + c] : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

template <>
__device__ __forceinline__ uint2 load_raw<__nv_bfloat16>(const __nv_bfloat16* row, int col,
                                                         int D, bool vec) {
  if (vec) return *reinterpret_cast<const uint2*>(row + col);
  uint32_t e[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    e[c] = col + c < D ? static_cast<uint32_t>(__bfloat16_as_ushort(row[col + c])) : 0u;
  return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

__device__ __forceinline__ void unpack4(float4 r, float out[4]) {
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}

__device__ __forceinline__ void unpack4(uint2 r, float out[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// partial: (gridDim.x, 2, D) float32; [b][0] = sum g * zhat, [b][1] = sum g
template <typename T, int LPR, int NG>
__global__ void __launch_bounds__(BWD_THREADS, 4) ln_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ h,
    const float* __restrict__ scale, const T* __restrict__ gy,
    T* __restrict__ dx, T* __restrict__ dh, float* __restrict__ partial,
    long long N, int D, float eps, float inv, uint32_t thresh, uint32_t seed,
    int vec, unsigned long long block0) {
  using R = typename Raw4<T>::type;
  constexpr int TEAMS = BWD_THREADS / LPR;
  // the next row's raw inputs take 3 NG sizeof(T) registers; wider rows
  // load after the current row instead, where holding both would spill
  constexpr bool PREFETCH = NG * sizeof(T) <= 12;
  constexpr int WARPS_B = BWD_THREADS / 32;
  __shared__ float red[2][MAXD];
  __shared__ float4 sc[MAXD / 4];
  const int team = threadIdx.x / LPR, l = threadIdx.x % LPR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the lanes of this lane's team: the two teams of a half-warp instance
  // leave the row loop apart when one of them runs out of rows (odd N), so
  // the loop's shuffles name only the team's own half
  const unsigned team_mask = LPR == 32 ? 0xffffffffu : 0xffffu << (lane & 16);
  const int G = (D + 3) >> 2;
  const bool vec_d = vec != 0;
  for (int g = threadIdx.x; g < G; g += BWD_THREADS) {
    float s4[4];
    load4<float>(scale, 4 * g, D, D % 4 == 0, s4);
    sc[g] = make_float4(s4[0], s4[1], s4[2], s4[3]);
  }
  // this lane's valid columns, as a float for the statistics
  float cnt = 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = l + LPR * i;
    if (g < G) cnt += static_cast<float>(min(4, D - 4 * g));
  }
  __syncthreads();

  float acc_gz[NG][4], acc_g[NG][4];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_gz[i][c] = acc_g[i][c] = 0.f;

  const long long stride = (long long)gridDim.x * TEAMS;
  long long row = (long long)blockIdx.x * TEAMS + team;
  R cx[NG], ch[NG], cg[NG];
  auto load = [&](long long r, R (&rx)[NG], R (&rh)[NG], R (&rg)[NG]) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = l + LPR * i;
      if (g < G) {
        rx[i] = load_raw<T>(x + r * D, 4 * g, D, vec_d);
        rh[i] = load_raw<T>(h + r * D, 4 * g, D, vec_d);
        rg[i] = load_raw<T>(gy + r * D, 4 * g, D, vec_d);
      }
    }
  };
  if (row < N) load(row, cx, ch, cg);
  for (; row < N; row += stride) {
    R nx[NG], nh[NG], ng[NG];
    if (PREFETCH && row + stride < N) load(row + stride, nx, nh, ng);

    // z = x + dropout(h); the lane's own mean and M2 first
    float z[NG][4];
    uint32_t keeps = 0u;
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = l + LPR * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) z[i][c] = 0.f;
      if (g < G) {
        float xv[4], hv[4];
        unpack4(cx[i], xv);
        unpack4(ch[i], hv);
        const uint32_t k = keep4(seed, thresh, block0, (unsigned long long)row * G + g);
        keeps |= k << (4 * i);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          z[i][c] = xv[c] + ((k >> c) & 1u ? hv[c] * inv : 0.f);
          lsum += z[i][c];          // columns past D read as 0 on both inputs
        }
      }
    }
    float mean = cnt > 0.f ? lsum / cnt : 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = l + LPR * i;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (g < G && 4 * g + c < D) m2 += (z[i][c] - mean) * (z[i][c] - mean);
    }
    // Chan's rule over the team; the lower lane of a pair is always the
    // left operand, so both lanes compute the same bits
    float n = cnt;
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      const float on = __shfl_xor_sync(team_mask, n, o);
      const float om = __shfl_xor_sync(team_mask, mean, o);
      const float oq = __shfl_xor_sync(team_mask, m2, o);
      const bool low = (l & o) == 0;
      const float na = low ? n : on, nb = low ? on : n;
      const float ma = low ? mean : om, mb = low ? om : mean;
      const float qa = low ? m2 : oq, qb = low ? oq : m2;
      const float nt = na + nb;
      const float f = nt > 0.f ? nb / nt : 0.f;
      const float d = mb - ma;
      mean = ma + d * f;
      m2 = qa + qb + d * d * na * f;
      n = nt;
    }
    const float rstd = rsqrtf(m2 / D + eps);

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = l + LPR * i;
      if (g < G) {
        float gv[4];
        unpack4(cg[i], gv);
        const float4 s4 = sc[g];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          z[i][c] = 4 * g + c < D ? (z[i][c] - mean) * rstd : 0.f;     // zhat
          acc_gz[i][c] += gv[c] * z[i][c];
          acc_g[i][c] += gv[c];
          s1 += gv[c] * sv[c] * z[i][c];
          s2 += gv[c] * sv[c];
        }
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(team_mask, s1, o);
      s2 += __shfl_xor_sync(team_mask, s2, o);
    }
    const float c1 = s1 / D, c2 = s2 / D;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = l + LPR * i;
      if (g < G) {
        float gv[4], dz[4], dhv[4];
        unpack4(cg[i], gv);
        const float4 s4 = sc[g];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dz[c] = (gv[c] * sv[c] - c2 - z[i][c] * c1) * rstd;
          dhv[c] = (keeps >> (4 * i + c)) & 1u ? dz[c] * inv : 0.f;
        }
        store4<T>(dx + row * D, 4 * g, D, vec_d, dz);
        store4<T>(dh + row * D, 4 * g, D, vec_d, dhv);
      }
    }
    if (!PREFETCH) {
      if (row + stride < N) load(row + stride, cx, ch, cg);
      continue;
    }
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      cx[i] = nx[i];
      ch[i] = nh[i];
      cg[i] = ng[i];
    }
  }

  // the two teams of a warp hold the same columns: add them (a + b on both
  // lanes; every lane of the warp is past its loop here), then fold the
  // block's warps in warp order into one partial row
  if (LPR == 16) {
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc_gz[i][c] += __shfl_xor_sync(0xffffffffu, acc_gz[i][c], 16);
        acc_g[i][c] += __shfl_xor_sync(0xffffffffu, acc_g[i][c], 16);
      }
  }
  for (int w = 0; w < WARPS_B; ++w) {
    if (warp == w && lane < LPR) {
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int g = l + LPR * i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 4 * g + c;
          if (g < G && col < D) {
            red[0][col] = (w ? red[0][col] : 0.f) + acc_gz[i][c];
            red[1][col] = (w ? red[1][col] : 0.f) + acc_g[i][c];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < 2 * D; e += BWD_THREADS)
    partial[(long long)blockIdx.x * 2 * D + e] = red[e / D][e % D];
}

// dscale / dbias: column e of the (nblocks, 2D) partial rows, summed in a
// fixed order.  A block takes 32 columns; warp w adds rows w, w + 16, ...
// and the 16 warp sums are added in warp order.
constexpr int RED_WARPS = 16;

__global__ void __launch_bounds__(32 * RED_WARPS) ln_bwd_reduce_kernel(
    const float* __restrict__ partial, int nblocks, int D,
    float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float part[RED_WARPS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < 2 * D) {
#pragma unroll 4
    for (int b = warp; b < nblocks; b += RED_WARPS) s += partial[(long long)b * 2 * D + e];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < 2 * D) {
    float t = part[0][lane];
#pragma unroll
    for (int w = 1; w < RED_WARPS; ++w) t += part[w][lane];
    (e < D ? dscale : dbias)[e % D] = t;
  }
}

// one thread per group of four columns; Philox block = the group's number
template <typename T>
__global__ void __launch_bounds__(256) dropout_kernel(
    const T* __restrict__ in, T* __restrict__ out, long long N, int D, float inv,
    uint32_t thresh, uint32_t seed, int vec, unsigned long long block0) {
  const int G = (D + 3) >> 2;
  const long long total = N * G;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / G;
    const int g = static_cast<int>(t - row * G);
    float v[4];
    load4<T>(in + row * D, 4 * g, D, vec != 0, v);
    const uint32_t k = keep4(seed, thresh, block0, (unsigned long long)t);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = (k >> c) & 1u ? v[c] * inv : 0.f;
    store4<T>(out + row * D, 4 * g, D, vec != 0, v);
  }
}

constexpr int DROP_THREADS = 256;
constexpr int DROP_UNROLL = 2;   // chunks a thread has in flight

// The (N, D) tensor as `total` elements in 16-byte chunks: thread t of the
// grid takes chunks t and t + T (T threads in the grid), loads both, then
// draws the Philox blocks of their groups (group element offset / 4) and
// stores; then the next two.  (Four or eight chunks a thread measured no
// faster: the one wave of blocks keeps enough bytes in flight.)  A bf16 tensor with an
// odd number of groups ends in a half chunk, which load_chunk / store_chunk
// cut to 8 bytes.
template <typename T>
__global__ void __launch_bounds__(DROP_THREADS) dropout_flat_kernel(
    const T* __restrict__ in, T* __restrict__ out, long long total, float inv,
    uint32_t thresh, uint32_t seed, unsigned long long block0) {
  using R = typename Chunk<T>::type;
  constexpr int CE = 16 / sizeof(T), CG = CE / 4;
  const long long chunks = (total + CE - 1) / CE;
  const long long threads = (long long)gridDim.x * DROP_THREADS;
  for (long long c0 = (long long)blockIdx.x * DROP_THREADS + threadIdx.x; c0 < chunks;
       c0 += DROP_UNROLL * threads) {
    R v[DROP_UNROLL];
#pragma unroll
    for (int u = 0; u < DROP_UNROLL; ++u) {
      const long long c = c0 + u * threads;
      if (c < chunks) v[u] = load_chunk<T>(in, c * CE, total);
    }
#pragma unroll
    for (int u = 0; u < DROP_UNROLL; ++u) {
      const long long c = c0 + u * threads;
      if (c < chunks) {
        float f[CE];
        unpack_chunk(v[u], f);
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          const uint32_t k = keep4(seed, thresh, block0, (unsigned long long)c * CG + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) f[4 * j + e] = (k >> e) & 1u ? f[4 * j + e] * inv : 0.f;
        }
        store_chunk<T>(out, c * CE, total, pack_chunk(f));
      }
    }
  }
}

__global__ void __launch_bounds__(256) keep_mask_kernel(
    uint8_t* __restrict__ out, long long N, int D, uint32_t thresh, uint32_t seed,
    unsigned long long block0) {
  const int G = (D + 3) >> 2;
  const long long total = N * G;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / G;
    const int g = static_cast<int>(t - row * G);
    const uint32_t k = keep4(seed, thresh, block0, (unsigned long long)t);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * g + c < D) out[row * D + 4 * g + c] = (k >> c) & 1u;
  }
}

__global__ void random_bits_kernel(uint32_t* __restrict__ out, long long n,
                                   uint32_t seed, uint32_t stream) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = random_bits(seed, stream, (unsigned long long)i);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int flat_grid(long long work, int threads) {
  const long long blocks = (work + threads - 1) / threads;
  return static_cast<int>(blocks < 1 ? 1 : blocks > 132 * 16 ? 132 * 16 : blocks);
}

// the span instance for bf16 rows of D: teams of LPR lanes (fwd_team_lanes),
// NC chunks a lane, LPR NC >= D / 4 (the chunks of a span)
using LnFwdFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const float*,
                         const float*, __nv_bfloat16*, long long, int, float, float,
                         uint32_t, uint32_t, unsigned long long);

LnFwdFn ln_fwd_pick(int D) {
  const int G = D / 4;
  if (fwd_team_lanes(G) == 16) return ln_fwd_span_kernel<16, 5>;
  if (G <= 96) return ln_fwd_span_kernel<32, 3>;
  if (G <= 128) return ln_fwd_span_kernel<32, 4>;
  return ln_fwd_span_kernel<32, 8>;
}

// the span kernel takes more than 48 KB of shared memory only after opting
// in: 544 G bytes with half-warp teams (D <= 320, so at most 43,520), 288 G
// with warp teams (over 48 KB from D 684)
int ln_fwd_smem_opt_in(int D) {
  const size_t bytes = fwd_smem_bytes(D);
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      ln_fwd_pick(D), cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// bf16 rows with D % 4 == 0 on 16-byte boundaries, enough of them for
// FWD_SPAN_MIN_SETS spans a team, run the span kernel on nblocks
// (ln_fwd_grid's count); f32 rows, and other bf16 rows, run ln_fwd_kernel,
// a warp a row
template <typename T>
int ln_fwd(const void* x, const void* h, const void* scale, const void* bias,
           void* y, long long N, int D, float eps, float inv, unsigned thresh,
           unsigned seed, unsigned long long block0, int nblocks, void* stream) {
  if (D < 1 || D > MAXD || N < 1 || nblocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {
    const long long spans = (N + 1) / 2;
    const long long per_block = FWD_THREADS / fwd_team_lanes(D / 4);    // teams
    if (spans >= FWD_SPAN_MIN_SETS * per_block * nblocks && D % 4 == 0 && aligned(x, 16) &&
        aligned(h, 16) && aligned(y, 16) && aligned(scale, 16) && aligned(bias, 16)) {
      const int err = ln_fwd_smem_opt_in(D);
      if (err) return err;
      ln_fwd_pick(D)<<<static_cast<unsigned>(nblocks), FWD_THREADS, fwd_smem_bytes(D), s>>>(
          static_cast<const T*>(x), static_cast<const T*>(h),
          static_cast<const float*>(scale), static_cast<const float*>(bias),
          static_cast<T*>(y), N, D, eps, inv, thresh, seed, block0);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int vec = D % 4 == 0 && aligned(x, 4 * sizeof(T)) &&
                  aligned(h, 4 * sizeof(T)) && aligned(y, 4 * sizeof(T));
  const long long blocks = (N + WARPS - 1) / WARPS;
  auto kernel = D <= 512 ? ln_fwd_kernel<T, 4> : ln_fwd_kernel<T, 8>;
  kernel<<<static_cast<unsigned>(blocks), 32 * WARPS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(y), N, D, eps, inv, thresh, seed, vec, block0);
  return static_cast<int>(cudaGetLastError());
}

// the backward instance for rows of D: LPR lanes a row, NG groups a lane,
// LPR * NG >= G; bf16 rows of up to 320 columns take half warps
template <typename T>
using LnBwdFn = void (*)(const T*, const T*, const float*, const T*, T*, T*, float*,
                         long long, int, float, float, uint32_t, uint32_t, int,
                         unsigned long long);

template <typename T>
LnBwdFn<T> ln_bwd_pick(int D) {
  const int G = (D + 3) / 4;
  if constexpr (sizeof(T) == 2)
    if (G <= 16 * 5) return ln_bwd_kernel<T, 16, 5>;
  if (G <= 32 * 3) return ln_bwd_kernel<T, 32, 3>;
  if (G <= 32 * 4) return ln_bwd_kernel<T, 32, 4>;
  return ln_bwd_kernel<T, 32, 8>;
}

template <typename T>
int ln_bwd_teams(int D) {
  const int G = (D + 3) / 4;
  return sizeof(T) == 2 && G <= 16 * 5 ? BWD_THREADS / 16 : BWD_THREADS / 32;
}

// nblocks: the rows of `partial`, at most ln_bwd_grid's count; fewer
// blocks run when there are fewer rows than teams
template <typename T>
int ln_bwd(const void* x, const void* h, const void* scale, const void* gy,
           void* dx, void* dh, void* partial, void* dscale, void* dbias,
           long long N, int D, float eps, float inv, unsigned thresh,
           unsigned seed, unsigned long long block0, int nblocks, void* stream) {
  if (D < 1 || D > MAXD || N < 1 || nblocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = D % 4 == 0 && aligned(x, 4 * sizeof(T)) &&
                  aligned(h, 4 * sizeof(T)) && aligned(gy, 4 * sizeof(T)) &&
                  aligned(dx, 4 * sizeof(T)) && aligned(dh, 4 * sizeof(T));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long teams = ln_bwd_teams<T>(D);
  const int blocks = static_cast<int>(
      nblocks < (N + teams - 1) / teams ? nblocks : (N + teams - 1) / teams);
  ln_bwd_pick<T>(D)<<<blocks, BWD_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const float*>(scale), static_cast<const T*>(gy),
      static_cast<T*>(dx), static_cast<T*>(dh), static_cast<float*>(partial), N,
      D, eps, inv, thresh, seed, vec, block0);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ln_bwd_reduce_kernel<<<(2 * D + 31) / 32, 32 * RED_WARPS, 0, s>>>(
      static_cast<const float*>(partial), blocks, D,
      static_cast<float*>(dscale), static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}

// nblocks: dropout_grid's count, the flat kernel's one wave (fewer blocks
// run when there are fewer chunks); other shapes run dropout_kernel
template <typename T>
int dropout(const void* in, void* out, long long N, int D, float inv,
            unsigned thresh, unsigned seed, unsigned long long block0, int nblocks,
            void* stream) {
  if (D < 1 || N < 1 || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(in, 16) && aligned(out, 16)) {
    constexpr long long CE = 16 / sizeof(T);
    const long long chunks = (N * D + CE - 1) / CE;
    const long long per_block = (long long)DROP_THREADS * DROP_UNROLL;
    const long long need = (chunks + per_block - 1) / per_block;
    dropout_flat_kernel<T><<<static_cast<unsigned>(need < nblocks ? need : nblocks),
                             DROP_THREADS, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), N * D, inv, thresh, seed, block0);
    return static_cast<int>(cudaGetLastError());
  }
  const int vec = D % 4 == 0 && aligned(in, 4 * sizeof(T)) &&
                  aligned(out, 4 * sizeof(T));
  const long long groups = N * ((D + 3) / 4);
  dropout_kernel<T><<<flat_grid(groups, 256), 256, 0, s>>>(
      static_cast<const T*>(in), static_cast<T*>(out), N, D, inv, thresh, seed, vec,
      block0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

ICEK_EXPORT int ln_fwd_f32(const void* x, const void* h, const void* scale,
                           const void* bias, void* y, long long N, int D,
                           float eps, float inv, unsigned thresh, unsigned seed,
                           unsigned long long block0, int nblocks, void* stream) {
  return ln_fwd<float>(x, h, scale, bias, y, N, D, eps, inv, thresh, seed, block0,
                       nblocks, stream);
}

ICEK_EXPORT int ln_fwd_bf16(const void* x, const void* h, const void* scale,
                            const void* bias, void* y, long long N, int D,
                            float eps, float inv, unsigned thresh, unsigned seed,
                            unsigned long long block0, int nblocks, void* stream) {
  return ln_fwd<__nv_bfloat16>(x, h, scale, bias, y, N, D, eps, inv, thresh, seed,
                               block0, nblocks, stream);
}

// blocks of the forward's bf16 span kernel for rows of D resident on the
// current device at once: its persistent grid.  f32 rows run ln_fwd_kernel,
// whose grid follows the rows: 1.
ICEK_EXPORT int ln_fwd_grid(int D, int bf16, int* blocks) {
  if (D < 1 || D > MAXD) return static_cast<int>(cudaErrorInvalidValue);
  if (!bf16) {
    *blocks = 1;
    return 0;
  }
  const int err = ln_fwd_smem_opt_in(D);
  if (err) return err;
  return resident_blocks(ln_fwd_pick(D), FWD_THREADS, fwd_smem_bytes(D), blocks);
}

ICEK_EXPORT int ln_bwd_f32(const void* x, const void* h, const void* scale,
                           const void* gy, void* dx, void* dh, void* partial,
                           void* dscale, void* dbias, long long N, int D,
                           float eps, float inv, unsigned thresh, unsigned seed,
                           unsigned long long block0, int nblocks, void* stream) {
  return ln_bwd<float>(x, h, scale, gy, dx, dh, partial, dscale, dbias, N, D, eps,
                       inv, thresh, seed, block0, nblocks, stream);
}

ICEK_EXPORT int ln_bwd_bf16(const void* x, const void* h, const void* scale,
                            const void* gy, void* dx, void* dh, void* partial,
                            void* dscale, void* dbias, long long N, int D,
                            float eps, float inv, unsigned thresh, unsigned seed,
                            unsigned long long block0, int nblocks, void* stream) {
  return ln_bwd<__nv_bfloat16>(x, h, scale, gy, dx, dh, partial, dscale, dbias, N,
                               D, eps, inv, thresh, seed, block0, nblocks, stream);
}

// blocks of the backward resident on the current device at once: its
// persistent grid and the rows of its partial sums
ICEK_EXPORT int ln_bwd_grid(int D, int bf16, int* blocks) {
  if (D < 1 || D > MAXD) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? resident_blocks(ln_bwd_pick<__nv_bfloat16>(D), BWD_THREADS, 0, blocks)
              : resident_blocks(ln_bwd_pick<float>(D), BWD_THREADS, 0, blocks);
}

ICEK_EXPORT int dropout_f32(const void* in, void* out, long long N, int D,
                            float inv, unsigned thresh, unsigned seed,
                            unsigned long long block0, int nblocks, void* stream) {
  return dropout<float>(in, out, N, D, inv, thresh, seed, block0, nblocks, stream);
}

ICEK_EXPORT int dropout_bf16(const void* in, void* out, long long N, int D,
                             float inv, unsigned thresh, unsigned seed,
                             unsigned long long block0, int nblocks, void* stream) {
  return dropout<__nv_bfloat16>(in, out, N, D, inv, thresh, seed, block0, nblocks,
                                stream);
}

// blocks of the flat dropout kernel resident on the current device at once:
// its one wave
ICEK_EXPORT int dropout_grid(int bf16, int* blocks) {
  return bf16 ? resident_blocks(dropout_flat_kernel<__nv_bfloat16>, DROP_THREADS, 0, blocks)
              : resident_blocks(dropout_flat_kernel<float>, DROP_THREADS, 0, blocks);
}

// the mask the kernels above use, as (N, D) bytes of 0 / 1
ICEK_EXPORT int norm_keep_mask(void* out, long long N, int D, unsigned thresh,
                               unsigned seed, unsigned long long block0, void* stream) {
  if (D < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  keep_mask_kernel<<<flat_grid(N * ((D + 3) / 4), 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), N, D, thresh, seed, block0);
  return static_cast<int>(cudaGetLastError());
}

// random_bits(seed, stream_id, 0 .. n-1), for known-answer tests
ICEK_EXPORT int philox_random_bits(void* out, long long n, unsigned seed,
                                   unsigned stream_id, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  random_bits_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, seed, stream_id);
  return static_cast<int>(cudaGetLastError());
}
