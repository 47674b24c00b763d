// Fused copy-score head for Hopper (sm_90a): vocab product + top-k +
// logsumexp over the extended vocabulary [V | tail], f32 and bf16 inputs.
//
// Replaces icek_tpu/kernels/copy_scores.py::fused_score_topk.  For rows
// n < N:  scores = [h[n] @ Wv + bv | tail[n]]  (f32 accumulation);
// returns the k best (value, index) pairs in the lax.top_k order (values
// descending, ties to the LOWER index, so vocab wins ties against the
// tail) and the row logsumexp.  Index padding never wins.
//
// The TPU kernel carries its running top-k and online logsumexp across a
// sequential vocab grid; GPU blocks run in no order, so the work is split:
//   pass 1  one block per (64-row tile, vocab chunk of several 64-column
//           tiles) computes its score tiles and keeps per row a top-k
//           (ordered by (value desc, index asc), which IS the lax.top_k
//           order, so the result does not depend on the order of
//           insertion) and an online (max, sum exp) over its chunk;
//   pass 2  one warp per row merges the chunks' partial lists with the
//           tail row and combines the (max, sum exp) pairs into the lse.
// The (N, V) score matrix never reaches device memory.
//
// What bounds it: at the beam-5 geo shapes (N=1280, D=300, V=10000,
// tail 301) the product is ~7.7 GFLOP against ~6 MB of bf16 weights, so
// the card's bound is operations (~8 us on bf16 tensor cores).  Two first
// passes live here:
//   * bf16 on the tensor cores (score_partial_mma_kernel), taken when the
//     operands allow 8- and 16-byte copies (kernels/copy_scores.py::
//     uses_tensor_cores).  A block of four warps holds its 64 rows of h in
//     shared memory, D padded to a multiple of 16 by zero-filling copies,
//     and streams Wv through a three-stage cp.async ring of 64 x 64 tiles;
//     each warp multiplies its 16 rows with mma.sync m16n8k16 (ldmatrix for
//     h, ldmatrix.trans for Wv) into f32 accumulators.  The epilogue stays
//     in registers: bias, the ragged last tile masked, a per-lane online
//     (max, sum 2^x) and a per-lane top-k list (k a template parameter, so
//     the list and its insertion network are registers) that a score
//     enters only if it beats the row's threshold, the best k-th entry of
//     the four lanes' lists, shared by shuffles at each tile's end: about
//     one score in eight takes that path, where the CUDA-core kernel runs
//     k warp-wide arg-max rounds on every tile.  At the chunk's end the
//     four lanes of a row combine their (max, sum) by shuffles and their
//     lists through shared memory.
//   * f32 (and bf16 that misses the alignment) on the CUDA cores
//     (score_partial_kernel): an f32 tiled product from shared memory, each
//     64-column tile merged into the rows' lists by k warp-wide arg-max
//     rounds.  TF32 would break the f32 checks at 1e-4.
//   * k above 16 (beams wider than 16), both dtypes, on the CUDA cores
//     (score_partial_wide_kernel): the same product, with each row's list of
//     kc = min(k, chunk columns) entries in dynamic shared memory, kept
//     sorted; a tile's score enters only if it beats the list's last entry
//     (a ballot), and then the row's warp shifts the worse entries up one
//     slot, 32 at a time from the top.  A block takes 64, 32 or 16 rows, the
//     most whose lists fit in shared memory.
// The merge needs no list of its own: its round j takes the best candidate
// that ranks after round j - 1's pick, so a chunk's entries and the tail
// are scanned k times and nothing is marked taken.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BN = 64;     // rows per block
constexpr int BV = 64;     // vocab columns per tile
constexpr int BD = 32;     // depth per staged tile
constexpr int KMAX = 16;   // largest k of the register lists (beams up to 16)
constexpr int THREADS = 256;

struct Cand {
  float v;
  int i;
};

// a ranks before b in lax.top_k order
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, c.v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, c.i, o);
    if (better(ov, oi, c.v, c.i)) {
      c.v = ov;
      c.i = oi;
    }
  }
  return c;
}

// The (RB x BV) score tile at col0 of rows r0 .. r0 + RB - 1 into sc: h's
// rows times Wv's columns in f32 from shared memory, plus the bias; columns
// at or past c_end are -inf.  A thread holds RB / 16 rows of four columns.
// Every thread of the block calls it; it begins with a barrier, so the
// caller's last reads of sc are done before sc is written again.
template <typename T, int RB>
__device__ __forceinline__ void score_tile(const T* __restrict__ h, const T* __restrict__ wv,
                                           const float* __restrict__ bv, int N, int D, int V,
                                           int r0, int col0, int c_end, float (*hs)[BD + 1],
                                           float (*ws)[BV], float (*sc)[BV + 1]) {
  constexpr int RA = RB / 16;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  float acc[RA][4];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  for (int d0 = 0; d0 < D; d0 += BD) {
    __syncthreads();
    for (int e = tid; e < RB * BD; e += THREADS) {
      const int r = e / BD, dd = e % BD;
      const int gr = r0 + r, gd = d0 + dd;
      hs[r][dd] = (gr < N && gd < D) ? to_f32(h[(long long)gr * D + gd]) : 0.f;
    }
    for (int e = tid; e < BD * BV; e += THREADS) {
      const int dd = e / BV, c = e % BV;
      const int gd = d0 + dd, gc = col0 + c;
      ws[dd][c] = (gd < D && gc < V) ? to_f32(wv[(long long)gd * V + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < BD; ++dd) {
      float a_[RA], b_[4];
#pragma unroll
      for (int a = 0; a < RA; ++a) a_[a] = hs[ty + 16 * a][dd];
#pragma unroll
      for (int c = 0; c < 4; ++c) b_[c] = ws[dd][tx + 16 * c];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(a_[a], b_[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gc = col0 + tx + 16 * c;
      sc[ty + 16 * a][tx + 16 * c] = gc < c_end ? acc[a][c] + bv[gc] : -INFINITY;
    }
  __syncthreads();
}

// a row's two candidates of the tile at col0 for this lane (columns lane and
// lane + 32); padding past c_end
__device__ __forceinline__ void tile_cands(const float* row, int col0, int c_end, int lane,
                                           Cand& c0, Cand& c1) {
  c0 = col0 + lane < c_end ? Cand{row[lane], col0 + lane} : Cand{-INFINITY, INT_MAX};
  c1 = col0 + lane + 32 < c_end ? Cand{row[lane + 32], col0 + lane + 32}
                                : Cand{-INFINITY, INT_MAX};
}

// a row's online (max, sum exp) over the tile's two candidates a lane
__device__ __forceinline__ void online_lse(const Cand& c0, const Cand& c1, int lane,
                                           float& run_m, float& run_s) {
  const float tmax = warp_max(fmaxf(c0.v, c1.v));
  const float m_old = run_m;
  const float m_new = fmaxf(m_old, tmax);
  const float part = warp_sum(__expf(c0.v - m_new) + __expf(c1.v - m_new));
  __syncwarp();
  if (lane == 0) {
    run_s = run_s * __expf(m_old - m_new) + part;
    run_m = m_new;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) score_partial_kernel(
    const T* __restrict__ h, const T* __restrict__ wv,
    const float* __restrict__ bv, int N, int D, int V, int k, int chunk_cols,
    int n_chunks, float* __restrict__ part_v, int* __restrict__ part_i,
    float* __restrict__ part_m, float* __restrict__ part_s) {
  __shared__ float hs[BN][BD + 1];
  __shared__ float ws[BD][BV];
  __shared__ float sc[BN][BV + 1];
  __shared__ float run_v[BN][KMAX];
  __shared__ int run_i[BN][KMAX];
  __shared__ float run_m[BN];
  __shared__ float run_s[BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * BN;
  const int chunk = blockIdx.x;
  const int c_begin = chunk * chunk_cols;
  const int c_end = min(V, c_begin + chunk_cols);

  for (int e = tid; e < BN * KMAX; e += THREADS) {
    run_v[e / KMAX][e % KMAX] = -INFINITY;
    run_i[e / KMAX][e % KMAX] = INT_MAX;
  }
  for (int e = tid; e < BN; e += THREADS) {
    run_m[e] = -INFINITY;
    run_s[e] = 0.f;
  }

  for (int col0 = c_begin; col0 < c_end; col0 += BV) {
    score_tile<T, BN>(h, wv, bv, N, D, V, r0, col0, c_end, hs, ws, sc);
    // merge this tile into each row's running top-k and (max, sum exp)
    for (int r = warp; r < BN; r += THREADS / 32) {
      if (r0 + r >= N) continue;
      Cand c0, c1;
      tile_cands(sc[r], col0, c_end, lane, c0, c1);
      Cand c2{-INFINITY, INT_MAX};
      if (lane < k) c2 = {run_v[r][lane], run_i[r][lane]};
      online_lse(c0, c1, lane, run_m[r], run_s[r]);
      float new_v = -INFINITY;
      int new_i = INT_MAX;
      for (int j = 0; j < k; ++j) {
        Cand mine = c0;
        if (better(c1.v, c1.i, mine.v, mine.i)) mine = c1;
        if (better(c2.v, c2.i, mine.v, mine.i)) mine = c2;
        const Cand best = warp_best(mine);
        if (lane == j) {
          new_v = best.v;
          new_i = best.i;
        }
        if (c0.i == best.i) c0 = {-INFINITY, INT_MAX};
        else if (c1.i == best.i) c1 = {-INFINITY, INT_MAX};
        else if (c2.i == best.i) c2 = {-INFINITY, INT_MAX};
      }
      __syncwarp();
      if (lane < k) {
        run_v[r][lane] = new_v;
        run_i[r][lane] = new_i;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int e = tid; e < BN * k; e += THREADS) {
    const int r = e / k, j = e % k;
    if (r0 + r < N) {
      const long long o = ((long long)(r0 + r) * n_chunks + chunk) * k + j;
      part_v[o] = run_v[r][j];
      part_i[o] = run_i[r][j];
    }
  }
  for (int r = tid; r < BN; r += THREADS) {
    if (r0 + r < N) {
      part_m[(long long)(r0 + r) * n_chunks + chunk] = run_m[r];
      part_s[(long long)(r0 + r) * n_chunks + chunk] = run_s[r];
    }
  }
}

// ---------------------------------------------------------------------------
// k above KMAX: each row's list of kc entries in dynamic shared memory
// ---------------------------------------------------------------------------

// static shared memory of the wide first pass at RB rows a block
__host__ __device__ constexpr size_t wide_static_bytes(int RB) {
  return sizeof(float) * ((size_t)RB * (BD + 1) + BD * BV + (size_t)RB * (BV + 1) + 2 * RB);
}

constexpr size_t SMEM_MAX = 232448;   // a block's shared memory on sm_90

// dynamic shared memory of the lists: (value, index) x RB rows x kc
size_t wide_list_bytes(int RB, int kc) {
  return (sizeof(float) + sizeof(int)) * (size_t)RB * kc;
}

// rows a block of the wide first pass: the most of 64, 32, 16 whose lists
// fit beside the product's buffers; 0 if none does
int wide_rows(int kc) {
  for (int RB = BN; RB >= 16; RB /= 2)
    if (wide_static_bytes(RB) + wide_list_bytes(RB, kc) <= SMEM_MAX) return RB;
  return 0;
}

// insert c, which beats the list's last entry, into the sorted list
// (lv, li) of kc entries: the entries that rank before it stay, the rest
// move up one slot (32 at a time, the top segment first, so no entry is
// overwritten before it has moved) and the last one drops out
__device__ __forceinline__ void list_insert(float* lv, int* li, int kc, Cand c, int lane) {
  int before = 0;
  for (int j = lane; j < kc; j += 32) before += better(lv[j], li[j], c.v, c.i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
  const int p = before;                         // the list is sorted: c's slot
  for (int s = (kc - 2) >> 5; s >= 0 && 32 * s + 31 >= p; --s) {
    const int j = 32 * s + lane;
    const bool move = j >= p && j <= kc - 2;
    float v = 0.f;
    int i = 0;
    if (move) {
      v = lv[j];
      i = li[j];
    }
    __syncwarp();
    if (move) {
      lv[j + 1] = v;
      li[j + 1] = i;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lv[p] = c.v;
    li[p] = c.i;
  }
  __syncwarp();
}

template <typename T, int RB>
__global__ void __launch_bounds__(THREADS) score_partial_wide_kernel(
    const T* __restrict__ h, const T* __restrict__ wv,
    const float* __restrict__ bv, int N, int D, int V, int kc, int chunk_cols,
    int n_chunks, float* __restrict__ part_v, int* __restrict__ part_i,
    float* __restrict__ part_m, float* __restrict__ part_s) {
  __shared__ float hs[RB][BD + 1];
  __shared__ float ws[BD][BV];
  __shared__ float sc[RB][BV + 1];
  __shared__ float run_m[RB];
  __shared__ float run_s[RB];
  extern __shared__ __align__(16) unsigned char lists[];
  float* lvs = reinterpret_cast<float*>(lists);            // [RB][kc]
  int* lis = reinterpret_cast<int*>(lvs + RB * kc);        // [RB][kc]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * RB;
  const int chunk = blockIdx.x;
  const int c_begin = chunk * chunk_cols;
  const int c_end = min(V, c_begin + chunk_cols);

  for (int e = tid; e < RB * kc; e += THREADS) {
    lvs[e] = -INFINITY;
    lis[e] = INT_MAX;
  }
  for (int e = tid; e < RB; e += THREADS) {
    run_m[e] = -INFINITY;
    run_s[e] = 0.f;
  }

  for (int col0 = c_begin; col0 < c_end; col0 += BV) {
    score_tile<T, RB>(h, wv, bv, N, D, V, r0, col0, c_end, hs, ws, sc);
    for (int r = warp; r < RB; r += THREADS / 32) {
      if (r0 + r >= N) continue;
      Cand c0, c1;
      tile_cands(sc[r], col0, c_end, lane, c0, c1);
      online_lse(c0, c1, lane, run_m[r], run_s[r]);
      float* lv = lvs + r * kc;
      int* li = lis + r * kc;
      // candidates that beat the last entry, one at a time in lane order;
      // each is checked again against the last entry, which only rises
      unsigned q0 = __ballot_sync(0xffffffffu,
                                  c0.i != INT_MAX && better(c0.v, c0.i, lv[kc - 1], li[kc - 1]));
      unsigned q1 = __ballot_sync(0xffffffffu,
                                  c1.i != INT_MAX && better(c1.v, c1.i, lv[kc - 1], li[kc - 1]));
      while (q0 | q1) {
        const bool first = q0 != 0u;
        const int src = __ffs(first ? q0 : q1) - 1;
        (first ? q0 : q1) &= ~(1u << src);
        Cand c;
        c.v = __shfl_sync(0xffffffffu, first ? c0.v : c1.v, src);
        c.i = __shfl_sync(0xffffffffu, first ? c0.i : c1.i, src);
        if (better(c.v, c.i, lv[kc - 1], li[kc - 1])) list_insert(lv, li, kc, c, lane);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < RB * kc; e += THREADS) {
    const int r = e / kc, j = e % kc;
    if (r0 + r < N) {
      const long long o = ((long long)(r0 + r) * n_chunks + chunk) * kc + j;
      part_v[o] = lvs[e];
      part_i[o] = lis[e];
    }
  }
  for (int r = tid; r < RB; r += THREADS) {
    if (r0 + r < N) {
      part_m[(long long)(r0 + r) * n_chunks + chunk] = run_m[r];
      part_s[(long long)(r0 + r) * n_chunks + chunk] = run_s[r];
    }
  }
}

// One warp a row: the lse from the chunks' (max, sum exp) pairs and the
// tail; then k rounds over the chunks' lists (kc entries each) and the
// tail, round j taking the best candidate that ranks after round j - 1's
// pick (indices are distinct, so nothing else needs marking; list padding,
// index INT_MAX, never counts).
__global__ void __launch_bounds__(THREADS) score_merge_kernel(
    const float* __restrict__ part_v, const int* __restrict__ part_i,
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    const float* __restrict__ tail, int N, int V, int T, int k, int kc, int n_chunks,
    float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ lse) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int P = n_chunks * kc;  // partial candidates, then T tail entries
  const float* pv = part_v + (long long)n * P;
  const int* pi = part_i + (long long)n * P;
  const float* tr = tail + (long long)n * T;

  // logsumexp over [V | tail] from the chunks' (max, sum exp) pairs
  float m = -INFINITY;
  for (int c = lane; c < n_chunks; c += 32) m = fmaxf(m, part_m[(long long)n * n_chunks + c]);
  for (int t = lane; t < T; t += 32) m = fmaxf(m, tr[t]);
  m = warp_max(m);
  float s = 0.f;
  for (int c = lane; c < n_chunks; c += 32) {
    const long long o = (long long)n * n_chunks + c;
    s += part_s[o] * __expf(part_m[o] - m);
  }
  for (int t = lane; t < T; t += 32) s += __expf(tr[t] - m);
  s = warp_sum(s);

  Cand prev{INFINITY, -1};     // ranks before every candidate
  for (int j = 0; j < k; ++j) {
    Cand mine{-INFINITY, INT_MAX};
    for (int e = lane; e < P + T; e += 32) {
      const Cand c = e < P ? Cand{pv[e], pi[e]} : Cand{tr[e - P], V + (e - P)};
      if (c.i != INT_MAX && better(prev.v, prev.i, c.v, c.i) &&
          better(c.v, c.i, mine.v, mine.i))
        mine = c;
    }
    prev = warp_best(mine);
    if (lane == 0) {
      vals[(long long)n * k + j] = prev.v;
      idx[(long long)n * k + j] = prev.i;
    }
  }
  if (lane == 0) lse[n] = m + logf(s);
}

// ---------------------------------------------------------------------------
// bf16 first pass on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;      // four warps of 16 rows: BN rows a block
constexpr int TC_BK = 64;            // depth of a ring stage
constexpr int TC_STAGES = 3;
constexpr int TC_WPITCH = BV + 8;    // a stage's row pitch in bf16: 144 bytes
constexpr int TC_MAXD = 512;
constexpr float LOG2E = 1.4426950408889634f;

// h's rows in shared memory: D padded to 16, plus 8 so that the eight rows of
// an ldmatrix phase fall on distinct banks
__host__ __device__ constexpr int tc_hpitch(int D) { return ((D + 15) & ~15) + 8; }

// h's rows, then the ring; at the chunk's end the ring holds the four lanes'
// lists of each row ((value, index) x BN x 4 x K), which outgrow it above K 13
size_t tc_smem_bytes(int D, int K) {
  const size_t ring = sizeof(bf16) * (size_t)TC_STAGES * TC_BK * TC_WPITCH;
  const size_t lists = (sizeof(float) + sizeof(int)) * (size_t)BN * 4 * K;
  return sizeof(bf16) * (size_t)BN * tc_hpitch(D) + (ring > lists ? ring : lists);
}

// insert (v, i), which beats the list's last entry, into the sorted list
// lv / li of length K
template <int K>
__device__ __forceinline__ void insert_topk(float (&lv)[K], int (&li)[K], float v, int i) {
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    if (better(v, i, lv[j], li[j])) {
      const int p = j ? j - 1 : 0;
      const bool up = j > 0 && better(v, i, lv[p], li[p]);
      lv[j] = up ? lv[p] : v;
      li[j] = up ? li[p] : i;
    }
  }
}

// One row's part of a tile's epilogue for this lane: H = 0 is row g
// (acc[n][0..1]), H = 1 row g + 8 (acc[n][2..3]); masked scores are -inf.
// (tv, ti) is the row's threshold: the best k-th entry of the quad's four
// lists, so at least k scores of the row already beat it and a score that
// does not can never be among the row's k best.
template <int H, int K>
__device__ __forceinline__ void row_epilogue(const float (&acc)[8][4], int col0, int t,
                                             float& m_run, float& s_run, float (&lv)[K],
                                             int (&li)[K], float& tv, int& ti) {
  float tmax = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) tmax = fmaxf(tmax, fmaxf(acc[n][2 * H], acc[n][2 * H + 1]));
  const float m_new = fmaxf(m_run, tmax);
  if (m_new != -INFINITY) {
    const float mL = m_new * LOG2E;
    float sum = s_run * fast_exp2(fmaf(m_run, LOG2E, -mL));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) sum += fast_exp2(fmaf(acc[n][2 * H + e], LOG2E, -mL));
    s_run = sum;
    m_run = m_new;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = acc[n][2 * H + e];
      const int col = col0 + 8 * n + 2 * t + e;
      if (v != -INFINITY && better(v, col, tv, ti)) {
        insert_topk<K>(lv, li, v, col);
        if (better(lv[K - 1], li[K - 1], tv, ti)) {
          tv = lv[K - 1];
          ti = li[K - 1];
        }
      }
    }
}

// the best (in lax.top_k order) of the quad's four (v, i)
__device__ __forceinline__ void quad_best(float& v, int& i) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(TC_THREADS) score_partial_mma_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ wv,
    const float* __restrict__ bv, int N, int D, int V, int chunk_cols,
    int n_chunks, float* __restrict__ part_v, int* __restrict__ part_i,
    float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = tc_hpitch(D), dpad = hp - 8;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ring = hs + BN * hp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * BN;
  const int chunk = blockIdx.x;
  const int c_begin = chunk * chunk_cols;
  const int c_end = min(V, c_begin + chunk_cols);
  const int kstages = (dpad + TC_BK - 1) / TC_BK;
  const int total = (c_end - c_begin + BV - 1) / BV * kstages;

  // rows [r0, r0 + BN) of h, 8 bytes a copy, zeros past N and past D
  for (int r = warp; r < BN; r += TC_THREADS / 32) {
    const bool row_ok = r0 + r < N;
    const bf16* src = h + (long long)(row_ok ? r0 + r : 0) * D;
    for (int c = lane; 4 * c < dpad; c += 32)
      cp_async8(smem_u32(hs + r * hp + 4 * c), src + 4 * c, row_ok && 4 * c < D);
  }
  // stage s: depth rows [64 (s % kstages), + 64) of tile s / kstages, 16
  // bytes a copy; a thread copies column chunk tid % 8 of rows tid / 8 + 16 i
  const int cc = 8 * (tid & 7), rr = tid >> 3;
  auto issue = [&](int s) {
    if (s < total) {
      const int tile = s / kstages;
      const int d0 = (s - tile * kstages) * TC_BK;
      const int col = c_begin + tile * BV + cc;
      const uint32_t dst =
          smem_u32(ring + (s % TC_STAGES) * TC_BK * TC_WPITCH + rr * TC_WPITCH + cc);
#pragma unroll
      for (int i = 0; i < TC_BK / 16; ++i) {
        const int d = d0 + rr + 16 * i;
        const bool ok = col < V && d < D;
        cp_async16(dst + i * 16 * TC_WPITCH * 2,
                   ok ? wv + (long long)d * V + col : wv, ok);
      }
    }
    cp_async_commit();
  };
  issue(0);          // with h's copies
  issue(1);

  // ldmatrix addresses: A (h) rows warp * 16 + lane % 16, depth 8 (lane / 16);
  // B (a Wv stage) depth lane % 16, columns 8 (lane / 16)
  const bf16* a_src = hs + (warp * 16 + (lane & 15)) * hp + (lane >> 4) * 8;
  const int b_off = (lane & 15) * TC_WPITCH + (lane >> 4) * 8;

  float acc[8][4];
  float lv0[K], lv1[K], m_run[2], s_run[2], tv[2];
  int li0[K], li1[K], ti[2];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    lv0[j] = lv1[j] = -INFINITY;
    li0[j] = li1[j] = INT_MAX;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_run[r] = tv[r] = -INFINITY;
    s_run[r] = 0.f;
    ti[r] = INT_MAX;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int ks = 0, col0 = c_begin;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();                 // stage s is in; stage s - 1's buffer is free
    issue(s + TC_STAGES - 1);
    const bf16* w = ring + (s % TC_STAGES) * TC_BK * TC_WPITCH + b_off;
    const int d0 = ks * TC_BK;
    const int steps = min(TC_BK, dpad - d0) / 16;
#pragma unroll
    for (int q = 0; q < TC_BK / 16; ++q) {
      if (q < steps) {
        uint32_t a[4];
        ldsm_x4(a, a_src + d0 + 16 * q);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, w + 16 * q * TC_WPITCH + 16 * np);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    if (++ks < kstages) continue;

    // the tile at col0 is done: lane holds columns col0 + 8 n + 2 t + {0, 1}
    // of rows g and g + 8; bias, mask, then each row's (max, sum) and list
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * n + 2 * t + e;
        const bool ok = col < c_end;
        const float b = ok ? bv[col] : 0.f;
        acc[n][e] = ok ? acc[n][e] + b : -INFINITY;
        acc[n][2 + e] = ok ? acc[n][2 + e] + b : -INFINITY;
      }
    row_epilogue<0, K>(acc, col0, t, m_run[0], s_run[0], lv0, li0, tv[0], ti[0]);
    row_epilogue<1, K>(acc, col0, t, m_run[1], s_run[1], lv1, li1, tv[1], ti[1]);
    quad_best(tv[0], ti[0]);
    quad_best(tv[1], ti[1]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    ks = 0;
    col0 += BV;
  }

  // the four lanes of a row: (max, sum) by shuffles, lists through shared
  // memory (the ring, which tc_smem_bytes sizes for them, is free once every
  // warp is past its last stage)
  cp_async_wait<0>();
  __syncthreads();
  float* mv = reinterpret_cast<float*>(ring);              // [BN][4][K]
  int* mi = reinterpret_cast<int*>(mv + BN * 4 * K);       // [BN][4][K]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    const float m = quad_max(m_run[r]);
    const float part = m_run[r] == -INFINITY
        ? 0.f : s_run[r] * fast_exp2((m_run[r] - m) * LOG2E);
    const float sum = quad_sum(part);
    if (t == 0 && r0 + row < N) {
      part_m[(long long)(r0 + row) * n_chunks + chunk] = m;
      part_s[(long long)(r0 + row) * n_chunks + chunk] = sum;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      mv[(row * 4 + t) * K + j] = r ? lv1[j] : lv0[j];
      mi[(row * 4 + t) * K + j] = r ? li1[j] : li0[j];
    }
  }
  __syncthreads();
  if (tid < BN && r0 + tid < N) {
    const float* rv = mv + tid * 4 * K;
    const int* ri = mi + tid * 4 * K;
    int head[4] = {0, 0, 0, 0};
    for (int j = 0; j < K; ++j) {
      float bvv = -INFINITY;
      int bi = INT_MAX, bq = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (head[q] < K) {
          const float v = rv[q * K + head[q]];
          const int i = ri[q * K + head[q]];
          if (better(v, i, bvv, bi)) {
            bvv = v;
            bi = i;
            bq = q;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) head[q] += q == bq;
      const long long o = ((long long)(r0 + tid) * n_chunks + chunk) * K + j;
      part_v[o] = bvv;
      part_i[o] = bi;
    }
  }
}

// the tensor-core kernel takes more than 48 KB of shared memory only after
// opting in, once per device
template <int K>
cudaError_t mma_opt_in() {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !opted[dev])) {
    err = cudaFuncSetAttribute(score_partial_mma_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(tc_smem_bytes(TC_MAXD, K)));
    if (err == cudaSuccess && dev < 64) opted[dev] = true;
  }
  return err;
}

// fn(std::integral_constant<int, k>{}) for k in [1, KMAX]: k is a
// compile-time constant of the tensor-core kernel, so its lists and
// insertion network live in registers
template <typename Fn>
int with_k(int k, Fn&& fn) {
  switch (k) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 5: return fn(std::integral_constant<int, 5>{});
    case 6: return fn(std::integral_constant<int, 6>{});
    case 7: return fn(std::integral_constant<int, 7>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    case 9: return fn(std::integral_constant<int, 9>{});
    case 10: return fn(std::integral_constant<int, 10>{});
    case 11: return fn(std::integral_constant<int, 11>{});
    case 12: return fn(std::integral_constant<int, 12>{});
    case 13: return fn(std::integral_constant<int, 13>{});
    case 14: return fn(std::integral_constant<int, 14>{});
    case 15: return fn(std::integral_constant<int, 15>{});
    case 16: return fn(std::integral_constant<int, 16>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_mma(int k, dim3 grid, cudaStream_t s, const bf16* h, const bf16* wv,
               const float* bv, int N, int D, int V, int chunk_cols, int n_chunks,
               float* part_v, int* part_i, float* part_m, float* part_s) {
  return with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = mma_opt_in<K>();
    if (err != cudaSuccess) return static_cast<int>(err);
    score_partial_mma_kernel<K><<<grid, TC_THREADS, tc_smem_bytes(D, K), s>>>(
        h, wv, bv, N, D, V, chunk_cols, n_chunks, part_v, part_i, part_m, part_s);
    return 0;
  });
}

// the wide first pass at RB rows a block as fn(kernel), its shared memory
// opened to the lists' size first
template <typename Scalar, typename Fn>
int with_wide_kernel(int RB, int kc, Fn&& fn) {
  auto call = [&](auto kernel) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(wide_list_bytes(RB, kc)));
    return err != cudaSuccess ? static_cast<int>(err) : fn(kernel);
  };
  switch (RB) {
    case 64: return call(score_partial_wide_kernel<Scalar, 64>);
    case 32: return call(score_partial_wide_kernel<Scalar, 32>);
    case 16: return call(score_partial_wide_kernel<Scalar, 16>);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// TC: the bf16 tensor-core first pass, which needs k <= KMAX, D % 4 == 0,
// D <= 512, V % 8 == 0, h on an 8-byte and wv on a 16-byte boundary.  A
// chunk's list holds kc = min(k, chunk_cols) entries (part_v / part_i are
// (N, n_chunks, kc)); k above KMAX takes the wide first pass.
template <typename Scalar, bool TC>
int run(const void* h, const void* wv, const float* bv, const float* tail,
        float* part_v, int* part_i, float* part_m, float* part_s, float* vals,
        int* idx, float* lse, int N, int D, int V, int T, int k,
        int chunk_cols, int n_chunks, void* stream) {
  if (k < 1 || k > V + T || chunk_cols < BV || chunk_cols % BV != 0 || (TC && k > KMAX))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kc = k < chunk_cols ? k : chunk_cols;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid1(n_chunks, (N + BN - 1) / BN);
  if (k > KMAX) {
    const int RB = wide_rows(kc);
    const int err = with_wide_kernel<Scalar>(RB, kc, [&](auto kernel) {
      kernel<<<dim3(n_chunks, (N + RB - 1) / RB), THREADS, wide_list_bytes(RB, kc), s>>>(
          static_cast<const Scalar*>(h), static_cast<const Scalar*>(wv), bv, N, D, V, kc,
          chunk_cols, n_chunks, part_v, part_i, part_m, part_s);
      return 0;
    });
    if (err) return err;
  } else if constexpr (TC) {
    if (D % 4 || D > TC_MAXD || V % 8 || reinterpret_cast<uintptr_t>(h) % 8 ||
        reinterpret_cast<uintptr_t>(wv) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_mma(k, grid1, s, static_cast<const bf16*>(h),
                               static_cast<const bf16*>(wv), bv, N, D, V, chunk_cols,
                               n_chunks, part_v, part_i, part_m, part_s);
    if (err) return err;
  } else {
    score_partial_kernel<Scalar><<<grid1, THREADS, 0, s>>>(
        static_cast<const Scalar*>(h), static_cast<const Scalar*>(wv), bv, N, D, V, k,
        chunk_cols, n_chunks, part_v, part_i, part_m, part_s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = THREADS / 32;
  score_merge_kernel<<<(N + rows_per_block - 1) / rows_per_block, THREADS, 0, s>>>(
      part_v, part_i, part_m, part_s, tail, N, V, T, k, kc, n_chunks, vals, idx, lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SCORE_ARGS                                                           \
  const void *h, const void *wv, const float *bv, const float *tail,         \
      float *part_v, int *part_i, float *part_m, float *part_s, float *vals, \
      int *idx, float *lse, int N, int D, int V, int T, int k,               \
      int chunk_cols, int n_chunks, void *stream
#define SCORE_PASS                                                            \
  h, wv, bv, tail, part_v, part_i, part_m, part_s, vals, idx, lse, N, D, V, T, \
      k, chunk_cols, n_chunks, stream

ICEK_EXPORT int score_topk_f32(SCORE_ARGS) { return run<float, false>(SCORE_PASS); }
ICEK_EXPORT int score_topk_bf16(SCORE_ARGS) {
  return run<__nv_bfloat16, false>(SCORE_PASS);
}
ICEK_EXPORT int score_topk_bf16_mma(SCORE_ARGS) {
  return run<__nv_bfloat16, true>(SCORE_PASS);
}

// The first pass that score_topk_<dtype>[_mma] launches for lists of kc
// entries and width D: its blocks resident on the current device at once
// (the wrapper splits the vocab so the first pass has about that many) and
// its rows a block (64; fewer for wide lists)
ICEK_EXPORT int score_topk_grid(int bf16, int tc, int kc, int D, int* blocks, int* rows) {
  if (kc < 1 || D < 1 || (tc && (!bf16 || D > TC_MAXD || kc > KMAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  *rows = BN;
  if (kc > KMAX) {
    *rows = wide_rows(kc);
    auto occupancy = [&](auto kernel) {
      return resident_blocks(kernel, THREADS, wide_list_bytes(*rows, kc), blocks);
    };
    return bf16 ? with_wide_kernel<__nv_bfloat16>(*rows, kc, occupancy)
                : with_wide_kernel<float>(*rows, kc, occupancy);
  }
  if (tc)
    return with_k(kc, [&](auto kk) {
      constexpr int K = decltype(kk)::value;
      const cudaError_t err = mma_opt_in<K>();
      if (err != cudaSuccess) return static_cast<int>(err);
      return resident_blocks(score_partial_mma_kernel<K>, TC_THREADS, tc_smem_bytes(D, K),
                             blocks);
    });
  return bf16 ? resident_blocks(score_partial_kernel<__nv_bfloat16>, THREADS, 0, blocks)
              : resident_blocks(score_partial_kernel<float>, THREADS, 0, blocks);
}
