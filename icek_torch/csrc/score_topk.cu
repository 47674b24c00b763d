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
// the card's bound is operations (~8 us on bf16 tensor cores; in f32 0.115
// ms at the CUDA cores' 67 TF/s, 0.047 ms as three TF32 products at 495
// TF/s).  The first passes for k <= 16:
//   * on the tensor cores (score_partial_mma_kernel<T, K>), taken when the
//     operands allow copies of 4 elements of h's rows and 16 bytes of Wv's
//     (kernels/copy_scores.py::route).  A block of four warps holds its 64
//     rows of h in shared memory, D padded by zero-filling copies, and
//     streams Wv through a three-stage cp.async ring of 64-column tiles;
//     each warp multiplies its 16 rows into f32 accumulators: bf16 with
//     mma.sync m16n8k16 (ldmatrix for h, ldmatrix.trans for Wv), f32 as
//     three TF32 m16n8k8 products a product (lo hi + hi lo + hi hi, each
//     operand split into a TF32 high part and its residual, which the
//     tensor cores truncate to TF32: about 2^-21 of relative error a term;
//     one TF32 pass would break the f32 checks at 1e-4, three do not), h
//     split once a k-step in registers, Wv's fragment read by plain shared
//     loads and split per warp (stage_products; splitting each stage once
//     by the block and storing both pieces is the other way).  The
//     epilogue stays in registers: bias, the ragged last tile masked, a per-lane online
//     (max, sum 2^x) and a per-lane top-k list (k a template parameter, so
//     the list and its insertion network are registers) that a score
//     enters only if it beats the row's threshold, the best k-th entry of
//     the four lanes' lists, shared by shuffles at each tile's end: about
//     one score in eight takes that path, where the CUDA-core kernel runs
//     k warp-wide arg-max rounds on every tile.  At the chunk's end the
//     four lanes of a row combine their (max, sum) by shuffles and their
//     lists through shared memory.
//   * on the CUDA cores (score_partial_kernel), for f32 and bf16 that miss
//     the alignment: an f32 tiled product from shared memory, each
//     64-column tile merged into the rows' lists by k warp-wide arg-max
//     rounds.
//   * k above 16 (beams wider than 16): the lists no longer fit registers,
//     so each row keeps one sorted list of kc = min(k, chunk columns)
//     entries (at most LIST_MAX) in shared memory.  The product is the
//     tensor-core one above for aligned bf16 (score_partial_wide_mma_kernel,
//     which shares mma_chunk with score_partial_mma_kernel), and for f32 (and
//     bf16 that misses the alignment) an FMA product whose thread holds an
//     8 x 4 register tile, read from shared memory as float4s: three loads
//     for 32 FMAs (score_partial_wide_kernel).  Either way a warp owns 16
//     rows of the 64-row block, keeps each row's (max, sum 2^x) per lane in
//     registers, and writes a finished tile's scores to its own rows of a
//     shared score tile.  Then, row by row (list_tile): the scores of the tile
//     that beat the row's threshold (its list's last entry, read once a
//     tile) are compacted by ballot and popc into a per-warp buffer, sorted
//     by a bitonic network in registers (32 lanes, or 64 as two a lane), and
//     merged into the list in one parallel step: an entry's new slot is its
//     rank in the list plus its rank among the survivors, both found by
//     binary search, in the lax.top_k order.  A tile costs one sort and one
//     merge a row however many of its scores enter; on random scores about
//     64 + k (1 + ln(tiles - 1)) of a chunk's scores do, 64 of them in its
//     first tile and k / (t - 1) in its tile t, so most tiles have a few:
//     up to FEW survivors are merged by counting instead (few_merge: a
//     shuffle and a ballot a survivor, none waiting on another, where the
//     network's stages and the searches' loads each wait on the last).
//     (Counting for every tile took the list work from 0.17 to 0.32 ms at
//     geo beam 20: a first tile's 64 rounds cost more than the network.)
//     No block barrier separates a warp's list work from another warp's
//     product.
// The merge needs no list of its own: its round j takes the best candidate
// that ranks after round j - 1's pick, so a chunk's entries and the tail
// are scanned k times (from shared memory, where the row's candidates are
// copied first) and nothing is marked taken.
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
// k above KMAX: each row's sorted list of kc entries in shared memory
// ---------------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;
constexpr int LIST_MAX = 128;        // longest list a row keeps (the wrapper's chunks keep to it)
constexpr int SC_PITCH = BV + 8;     // row pitch of a shared score tile: a quad's float2s miss
constexpr float LOG2E = 1.4426950408889634f;

// c takes its partner's candidate (lane ^ stride) where the partner's is the
// better one and c's slot is to hold the better of the two, or the worse one
// and c's slot the worse
__device__ __forceinline__ void exchange(Cand& c, int stride, bool keep_better) {
  const float ov = __shfl_xor_sync(FULL, c.v, stride);
  const int oi = __shfl_xor_sync(FULL, c.i, stride);
  if (keep_better ? better(ov, oi, c.v, c.i) : better(c.v, c.i, ov, oi)) c = Cand{ov, oi};
}

// bitonic sort of 32 candidates, one a lane, best first (lax.top_k order)
__device__ __forceinline__ void sort32(Cand& c, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(c, stride, ((lane & size) == 0) == ((lane & stride) == 0));
}

// bitonic sort of 64 candidates, element e in lane e % 32 (a for e < 32, b
// above), best first
__device__ __forceinline__ void sort64(Cand& a, Cand& b, int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {              // e and e + 32 in one lane; size 64 sorts best first
        if (better(b.v, b.i, a.v, a.i)) {
          const Cand x = a;
          a = b;
          b = x;
        }
      } else {
        const bool lower = (lane & stride) == 0;
        exchange(a, stride, ((lane & size) == 0) == lower);
        exchange(b, stride, (((lane + 32) & size) == 0) == lower);
      }
    }
}

// entries of the sorted (v, i)[0, n) that rank before c
__device__ __forceinline__ int rank_in(const float* v, const int* i, int n, const Cand& c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(v[mid], i[mid], c.v, c.i)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

constexpr int FEW = 8;   // survivors merged by counting, without a sort

// The merge of at most FEW survivors (s in lanes 0 .. cnt - 1) into the
// sorted list (lv, li) of kc <= LIST_MAX entries, without a sort: lane j
// holds entries j + 32 m; for each survivor x (a shuffle from lane x), every
// entry counts whether x ranks before it (how far it moves up) and a ballot
// counts the entries that rank before x (its slot, with the survivors before
// it).  The rounds depend on nothing but their shuffles, where the sort's
// stages each wait on the last.
__device__ __forceinline__ void few_merge(const Cand& s, int cnt, float* lv, int* li, int kc,
                                          int lane) {
  constexpr int M = LIST_MAX / 32;
  Cand e[M];
  int up[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int j = 32 * m + lane;
    e[m] = j < kc ? Cand{lv[j], li[j]} : Cand{-INFINITY, INT_MAX};
    up[m] = 0;
  }
  int q = 0;                   // lane x < cnt: the slot of survivor x
#pragma unroll
  for (int x = 0; x < FEW; ++x) {
    if (x < cnt) {
      const Cand c{__shfl_sync(FULL, s.v, x), __shfl_sync(FULL, s.i, x)};
      q += better(c.v, c.i, s.v, s.i);
      int before = 0;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        up[m] += better(c.v, c.i, e[m].v, e[m].i);
        if (32 * m < kc) before += __popc(__ballot_sync(FULL, better(e[m].v, e[m].i, c.v, c.i)));
      }
      if (lane == x) q += before;
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int to = 32 * m + lane + up[m];
    if (up[m] && to < kc) {
      lv[to] = e[m].v;
      li[to] = e[m].i;
    }
  }
  if (lane < cnt && q < kc) {
    lv[q] = s.v;
    li[q] = s.i;
  }
  __syncwarp();
}

// One row's 64-column tile of scores (sc: columns col0 .., -inf past c_end)
// into its sorted list (lv, li) of kc entries, by the row's warp.  The
// scores that beat the list's last entry are compacted (ballot, popc) into
// the warp's buffer (bv_, bi_: 64 entries) and sorted; every list entry at or
// after the best survivor's slot moves up by the number of survivors that
// rank before it (top segment of 32 first, so nothing is overwritten before
// it has moved), and survivor s goes to s plus the number of list entries
// that rank before it.  Slots past kc drop out.
__device__ __forceinline__ void list_tile(const float* sc, int col0, int c_end, float* lv,
                                          int* li, int kc, float* bv_, int* bi_, int lane) {
  const float tv = lv[kc - 1];
  const int ti = li[kc - 1];
  Cand c0{-INFINITY, INT_MAX}, c1{-INFINITY, INT_MAX};
  if (col0 + lane < c_end) c0 = Cand{sc[lane], col0 + lane};
  if (col0 + lane + 32 < c_end) c1 = Cand{sc[lane + 32], col0 + lane + 32};
  const bool p0 = c0.i != INT_MAX && better(c0.v, c0.i, tv, ti);
  const bool p1 = c1.i != INT_MAX && better(c1.v, c1.i, tv, ti);
  const unsigned b0 = __ballot_sync(FULL, p0), b1 = __ballot_sync(FULL, p1);
  const int n0 = __popc(b0), cnt = n0 + __popc(b1);
  if (cnt == 0) return;
  const unsigned below = (1u << lane) - 1u;
  if (p0) {
    bv_[__popc(b0 & below)] = c0.v;
    bi_[__popc(b0 & below)] = c0.i;
  }
  if (p1) {
    bv_[n0 + __popc(b1 & below)] = c1.v;
    bi_[n0 + __popc(b1 & below)] = c1.i;
  }
  __syncwarp();
  Cand s0{-INFINITY, INT_MAX}, s1{-INFINITY, INT_MAX};
  if (lane < cnt) s0 = Cand{bv_[lane], bi_[lane]};
  if (lane + 32 < cnt) s1 = Cand{bv_[lane + 32], bi_[lane + 32]};
  if (cnt <= FEW) {
    few_merge(s0, cnt, lv, li, kc, lane);
    return;
  }
  if (cnt > 32) sort64(s0, s1, lane);
  else if (cnt > 1) sort32(s0, lane);
  __syncwarp();
  if (lane < cnt) {
    bv_[lane] = s0.v;
    bi_[lane] = s0.i;
  }
  if (lane + 32 < cnt) {
    bv_[lane + 32] = s1.v;
    bi_[lane + 32] = s1.i;
  }
  __syncwarp();
  // survivors' slots, from the list as it stands
  const int q0 = lane < cnt ? lane + rank_in(lv, li, kc, s0) : kc;
  const int q1 = lane + 32 < cnt ? lane + 32 + rank_in(lv, li, kc, s1) : kc;
  const int first = __shfl_sync(FULL, q0, 0);     // entries before it stay
  for (int s = (kc - 1) >> 5; s >= (first >> 5); --s) {
    const int j = 32 * s + lane;
    Cand e{0.f, 0};
    int to = kc;
    if (j >= first && j < kc) {
      e = Cand{lv[j], li[j]};
      to = j + rank_in(bv_, bi_, cnt, e);
    }
    __syncwarp();
    if (to < kc) {
      lv[to] = e.v;
      li[to] = e.i;
    }
    __syncwarp();
  }
  if (q0 < kc) {
    lv[q0] = s0.v;
    li[q0] = s0.i;
  }
  if (q1 < kc) {
    lv[q1] = s1.v;
    li[q1] = s1.i;
  }
  __syncwarp();
}

// a row's online (max, sum 2^x) over n more scores (-inf: masked), in the
// log2 domain as the tensor-core kernel keeps it
template <int NV>
__device__ __forceinline__ void lse_update(float& m_run, float& s_run, const float (&x)[NV]) {
  float tmax = -INFINITY;
#pragma unroll
  for (int e = 0; e < NV; ++e) tmax = fmaxf(tmax, x[e]);
  const float m_new = fmaxf(m_run, tmax);
  if (m_new != -INFINITY) {
    const float mL = m_new * LOG2E;
    float sum = s_run * fast_exp2(fmaf(m_run, LOG2E, -mL));
#pragma unroll
    for (int e = 0; e < NV; ++e) sum += fast_exp2(fmaf(x[e], LOG2E, -mL));
    s_run = sum;
    m_run = m_new;
  }
}

// a lane's (max, sum 2^x) of one row combined with those of the lanes
// lane ^ o for o < WIDTH, as (max, sum exp(x - max))
template <int WIDTH>
__device__ __forceinline__ void lse_combine(float m_run, float s_run, float& m, float& s) {
  m = m_run;
#pragma unroll
  for (int o = 1; o < WIDTH; o <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  s = m_run == -INFINITY ? 0.f : s_run * fast_exp2((m_run - m) * LOG2E);
#pragma unroll
  for (int o = 1; o < WIDTH; o <<= 1) s += __shfl_xor_sync(FULL, s, o);
}

// the wide first passes' dynamic shared memory after their own buffers: the
// score tile (BN x SC_PITCH f32), the lists ((value, index) x BN x kc) and
// the four warps' survivor buffers ((value, index) x 64)
size_t wide_tail_bytes(int kc) {
  return sizeof(float) * (size_t)BN * SC_PITCH + (sizeof(float) + sizeof(int)) * (BN * (size_t)kc + 4 * BV);
}

// The lists' part of that memory, set to empty: (value, index) arrays and
// the survivor buffers after them
struct WideLists {
  float* sc;
  float* lv;
  int* li;
  float* bv;
  int* bi;
  __device__ WideLists(unsigned char* p, int kc) {
    sc = reinterpret_cast<float*>(p);
    lv = sc + BN * SC_PITCH;
    li = reinterpret_cast<int*>(lv + BN * kc);
    bv = reinterpret_cast<float*>(li + BN * kc);
    bi = reinterpret_cast<int*>(bv + 4 * BV);
    for (int e = threadIdx.x; e < BN * kc; e += blockDim.x) {
      lv[e] = -INFINITY;
      li[e] = INT_MAX;
    }
  }
  // warp w's list work on its 16 rows of the tile at col0 (their scores are in sc)
  __device__ __forceinline__ void tile(int warp, int lane, int r0, int N, int col0, int c_end,
                                       int kc) {
    __syncwarp();
    for (int r = warp * 16; r < warp * 16 + 16 && r0 + r < N; ++r)
      list_tile(sc + r * SC_PITCH, col0, c_end, lv + r * kc, li + r * kc, kc, bv + warp * BV,
                bi + warp * BV, lane);
  }
  // after a block barrier: every row's list to (N, n_chunks, kc)
  __device__ void store(int r0, int N, int chunk, int n_chunks, int kc, float* part_v,
                        int* part_i) {
    for (int e = threadIdx.x; e < BN * kc; e += blockDim.x) {
      const int r = e / kc, j = e - r * kc;
      if (r0 + r < N) {
        const long long o = ((long long)(r0 + r) * n_chunks + chunk) * kc + j;
        part_v[o] = lv[e];
        part_i[o] = li[e];
      }
    }
  }
};

constexpr int WIDE_THREADS = 128;    // four warps of 16 rows: BN rows a block

// A thread's share of the wide CUDA-core pass's depth slice [d0, d0 + BD) of
// rows r0 .. of h and of columns col0 .. of Wv, as f32: element i is h row 16
// (i / 4) + 4 warp + lane / 8 at depth 8 (i % 4) + lane % 8 (a warp reads four
// 8-element pieces of rows, and its transposed stores fall on 32 banks), and
// Wv depth 4 (i / 2) + warp at column lane + 32 (i % 2).  Zeros past N, D, V.
template <typename T>
__device__ __forceinline__ void wide_load(float (&hr)[16], float (&wr)[16],
                                          const T* __restrict__ h, const T* __restrict__ wv,
                                          int N, int D, int V, int r0, int d0, int col0,
                                          int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + 16 * (i >> 2) + 4 * warp + (lane >> 3), d = d0 + 8 * (i & 3) + (lane & 7);
    hr[i] = r < N && d < D ? to_f32(h[(long long)r * D + d]) : 0.f;
    const int dw = d0 + 4 * (i >> 1) + warp, c = col0 + lane + 32 * (i & 1);
    wr[i] = dw < D && c < V ? to_f32(wv[(long long)dw * V + c]) : 0.f;
  }
}

// ... into shared memory: h transposed ([depth][row]), Wv as it lies
__device__ __forceinline__ void wide_store(const float (&hr)[16], const float (&wr)[16],
                                           float (*hs)[BN + 4], float (*ws)[BV + 4], int warp,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    hs[8 * (i & 3) + (lane & 7)][16 * (i >> 2) + 4 * warp + (lane >> 3)] = hr[i];
    ws[4 * (i >> 1) + warp][lane + 32 * (i & 1)] = wr[i];
  }
}

// The CUDA-core wide first pass (f32, and bf16 that misses the tensor-core
// alignment).  Thread (ty, tx) = (tid / 16, tid % 16) holds rows 8 ty .. 8 ty
// + 7 and columns 4 tx .. 4 tx + 3 of a 64 x 64 tile: warp w's rows are 16 w
// .. 16 w + 15.  Depth slices of BD pass through shared memory as f32, h
// transposed, the next slice loaded into registers while this one is used.
template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS) score_partial_wide_kernel(
    const T* __restrict__ h, const T* __restrict__ wv,
    const float* __restrict__ bv, int N, int D, int V, int kc, int chunk_cols,
    int n_chunks, float* __restrict__ part_v, int* __restrict__ part_i,
    float* __restrict__ part_m, float* __restrict__ part_s) {
  __shared__ __align__(16) float hs[BD][BN + 4];   // [depth][row]
  __shared__ __align__(16) float ws[BD][BV + 4];   // [depth][column]
  extern __shared__ __align__(16) unsigned char dyn[];
  WideLists lists(dyn, kc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.y * BN;
  const int chunk = blockIdx.x;
  const int c_begin = chunk * chunk_cols;
  const int c_end = min(V, c_begin + chunk_cols);
  const int slices = (D + BD - 1) / BD;
  const int total = (c_end - c_begin + BV - 1) / BV * slices;

  float acc[8][4], m_run[8], s_run[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m_run[a] = -INFINITY;
    s_run[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  }
  float hr[16], wr[16];
  wide_load(hr, wr, h, wv, N, D, V, r0, 0, c_begin, warp, lane);
  int ks = 0, col0 = c_begin;
  for (int s = 0; s < total; ++s) {
    __syncthreads();                 // the last slice's reads are done
    wide_store(hr, wr, hs, ws, warp, lane);
    __syncthreads();
    if (s + 1 < total) {
      const int tile = (s + 1) / slices;
      wide_load(hr, wr, h, wv, N, D, V, r0, (s + 1 - tile * slices) * BD, c_begin + tile * BV,
                warp, lane);
    }
#pragma unroll
    for (int dd = 0; dd < BD; ++dd) {
      const float4 a0 = *reinterpret_cast<const float4*>(&hs[dd][8 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&hs[dd][8 * ty + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[dd][4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], bw[c], acc[a][c]);
    }
    if (++ks < slices) continue;

    // the tile at col0 is done: bias, mask, each row's (max, sum), the rows'
    // scores to the warp's rows of the score tile, then their lists
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + 4 * tx + c;
        x[c] = col < c_end ? acc[a][c] + bv[col] : -INFINITY;
        acc[a][c] = 0.f;
      }
      lse_update<4>(m_run[a], s_run[a], x);
      *reinterpret_cast<float4*>(lists.sc + (8 * ty + a) * SC_PITCH + 4 * tx) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    lists.tile(warp, lane, r0, N, col0, c_end, kc);
    ks = 0;
    col0 += BV;
  }

  // a row's 16 threads (one half-warp) combine their (max, sum)
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float m, sum;
    lse_combine<16>(m_run[a], s_run[a], m, sum);
    const int row = r0 + 8 * ty + a;
    if (tx == 0 && row < N) {
      part_m[(long long)row * n_chunks + chunk] = m;
      part_s[(long long)row * n_chunks + chunk] = sum;
    }
  }
  __syncthreads();
  lists.store(r0, N, chunk, n_chunks, kc, part_v, part_i);
}

// One warp a row, a block a warp: the lse from the chunks' (max, sum exp)
// pairs and the tail; then k rounds over the chunks' lists (kc entries each)
// and the tail, round j taking the best candidate that ranks after round j -
// 1's pick (indices are distinct, so nothing else needs marking; list
// padding, index INT_MAX, never counts).  When they fit (`staged`), the row's
// candidates are first copied to shared memory, so the rounds read it and
// not L2 (each round's loads wait on nothing but the address).
__global__ void __launch_bounds__(32) score_merge_kernel(
    const float* __restrict__ part_v, const int* __restrict__ part_i,
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    const float* __restrict__ tail, int N, int V, int T, int k, int kc, int n_chunks,
    int staged, float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char cand[];
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  const int P = n_chunks * kc;  // partial candidates, then T tail entries
  const float* pv = part_v + (long long)n * P;
  const int* pi = part_i + (long long)n * P;
  const float* tr = tail + (long long)n * T;
  float* sv = reinterpret_cast<float*>(cand);
  int* si = reinterpret_cast<int*>(sv + P + T);
  if (staged) {
    for (int e = lane; e < P; e += 32) {
      sv[e] = pv[e];
      si[e] = pi[e];
    }
    for (int t = lane; t < T; t += 32) {
      sv[P + t] = tr[t];
      si[P + t] = V + t;
    }
    __syncwarp();
    tr = sv + P;
  }

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
      const Cand c = staged ? Cand{sv[e], si[e]}
                            : e < P ? Cand{pv[e], pi[e]} : Cand{tr[e - P], V + (e - P)};
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

constexpr size_t MERGE_SMEM_MAX = 227 * 1024;   // a block's shared memory on sm_90

// the merge's launch: its candidates staged when (value, index) x (P + T)
// fit a block's shared memory (opened to that once per device)
int launch_merge(cudaStream_t s, const float* part_v, const int* part_i, const float* part_m,
                 const float* part_s, const float* tail, int N, int V, int T, int k, int kc,
                 int n_chunks, float* vals, int* idx, float* lse) {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !opted[dev])) {
    err = cudaFuncSetAttribute(score_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(MERGE_SMEM_MAX));
    if (err == cudaSuccess && dev < 64) opted[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = (sizeof(float) + sizeof(int)) * ((size_t)n_chunks * kc + T);
  const bool staged = bytes <= MERGE_SMEM_MAX;
  score_merge_kernel<<<N, 32, staged ? bytes : 0, s>>>(part_v, part_i, part_m, part_s, tail, N,
                                                        V, T, k, kc, n_chunks, staged, vals,
                                                        idx, lse);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// First passes on the tensor cores: bf16 (mma.sync m16n8k16), f32 (three
// TF32 m16n8k8 products a product)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;      // four warps of 16 rows: BN rows a block
constexpr int TC_STAGES = 3;
constexpr int TC_MAXD = 512;

// The tensor-core first pass's layout by element type: KS the depth of one
// mma, BK the depth of a ring stage, WP a stage's row pitch and HP h's row
// pad (elements).  bf16: 64-deep stages of 144-byte rows.  f32: 32-deep
// stages of 288-byte rows, so the ring keeps the bf16 ring's 27 KB and two
// blocks (64 rows of f32 h each, 77 KB at D 300) share an SM.
template <typename T> struct Tc;
template <> struct Tc<bf16> {
  static constexpr int KS = 16, BK = 64, WP = BV + 8, HP = 8;
};
template <> struct Tc<float> {
  static constexpr int KS = 8, BK = 32, WP = BV + 8, HP = 4;
};

// h's rows in shared memory: D padded to KS, plus HP so that the eight rows
// of an ldmatrix phase fall on distinct banks (an odd multiple of 16 bytes)
template <typename T>
__host__ __device__ constexpr int tc_hpitch(int D) {
  return (D + Tc<T>::KS - 1) / Tc<T>::KS * Tc<T>::KS + Tc<T>::HP;
}

// h's rows, then the ring; at the chunk's end the ring holds the four lanes'
// lists of each row ((value, index) x BN x 4 x K), which outgrow it above K 13
template <typename T>
__host__ __device__ constexpr size_t tc_ring_bytes() {
  return sizeof(T) * (size_t)TC_STAGES * Tc<T>::BK * Tc<T>::WP;
}

template <typename T>
size_t tc_smem_bytes(int D, int K) {
  const size_t lists = (sizeof(float) + sizeof(int)) * (size_t)BN * 4 * K;
  const size_t ring = tc_ring_bytes<T>();
  return sizeof(T) * (size_t)BN * tc_hpitch<T>(D) + (ring > lists ? ring : lists);
}

// the wide tensor-core first pass (bf16): h's rows, the ring, then wide_tail_bytes
size_t tc_wide_smem_bytes(int D, int kc) {
  return sizeof(bf16) * (size_t)BN * tc_hpitch<bf16>(D) + tc_ring_bytes<bf16>() +
         wide_tail_bytes(kc);
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

// One ring stage's products of a warp's 16 rows, bf16: mma.sync m16n8k16,
// ldmatrix for h (a_src: row warp * 16 + lane % 16, depth 8 (lane / 16)),
// ldmatrix.trans for the stage (w: depth lane % 16, column 8 (lane / 16)),
// summed in the accumulators
__device__ __forceinline__ void stage_products(float (&acc)[8][4], const bf16* a_src,
                                               const bf16* w, int d0, int steps) {
  constexpr int WP = Tc<bf16>::WP;
#pragma unroll
  for (int q = 0; q < Tc<bf16>::BK / 16; ++q) {
    if (q < steps) {
      uint32_t a[4];
      ldsm_x4(a, a_src + d0 + 16 * q);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, w + 16 * q * WP + 16 * np);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// ... f32: three TF32 m16n8k8 products a product (lo hi + hi lo + hi hi, the
// smallest first), each operand split by integer rounding (split_tf32_bits:
// three instructions an element, where cvt.rna expands into
// compare-and-select code; 0.27 against 0.31 ms at geo beam 5 on an H100).
// h's A fragment comes by ldmatrix, whose 8 x 8 b16 matrices are 8 x 4 f32
// ones as the m16n8k8 TF32 A operand wants them (a_src: row warp * 16 +
// lane % 8 + 8 ((lane / 8) % 2), depth 4 (lane / 16)), and is split once a
// k-step in registers.  The B fragment, depth t and t + 4 of column g, is a
// transposition that ldmatrix (16-bit) cannot do on 32-bit elements, so it
// is read by plain shared loads (w: depth t, column g), conflict-free at the
// 72-float pitch (8 t + g covers the 32 banks), and split per warp.  The
// stage's products are summed by the tensor cores (4 k-steps) and added to
// the accumulators by f32 adds: the tensor cores' accumulation is not round
// to nearest (summed there across stages, the values' error against
// float64 grew from 1.7e-6 to 1.4e-5 at geo beam 5).
__device__ __forceinline__ void stage_products(float (&acc)[8][4], const float* a_src,
                                               const float* w, int d0, int steps) {
  constexpr int WP = Tc<float>::WP;
  float part[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
  for (int q = 0; q < Tc<float>::BK / 8; ++q) {
    if (q < steps) {
      uint32_t a[4];
      ldsm_x4(a, a_src + d0 + 8 * q);
      FragA<2> x;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t p[2];
        split_tf32_bits(__uint_as_float(a[i]), p);
        x.p[0][i] = p[0];
        x.p[1][i] = p[1];
      }
      const float* wq = w + 8 * q * WP;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0[2], b1[2];
        split_tf32_bits(wq[8 * n], b0);
        split_tf32_bits(wq[4 * WP + 8 * n], b1);
        mma_tf32(part[n], x.p[0], b0[1], b1[1]);
        mma_tf32(part[n], x.p[1], b0[0], b1[0]);
        mma_tf32(part[n], x.p[0], b0[0], b1[0]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// 4 elements global -> shared: 8 bytes of bf16, 16 of f32
__device__ __forceinline__ void cp_async_4(uint32_t dst, const bf16* src, bool ok) {
  cp_async8(dst, src, ok);
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src, bool ok) {
  cp_async16(dst, src, ok);
}

// The tensor-core product of one chunk.  A block of four warps holds rows
// [r0, r0 + BN) of h in shared memory (hs; D padded to a multiple of KS by
// zero-filling copies, 4 elements a copy) and streams Wv through a
// three-stage cp.async ring of BK x 64 tiles (16 bytes a copy); each warp
// multiplies its 16 rows into f32 accumulators (stage_products).  When a
// 64-column tile is done, epi(acc, col0) gets it with the bias added and the
// columns at or past c_end at -inf: lane (g, t) holds columns col0 + 8 n + 2 t
// + {0, 1} of rows g (acc[n][0..1]) and g + 8 (acc[n][2..3]) of its warp's
// rows.  Returns after every copy has landed and a block barrier, so the ring
// may be reused.
template <typename T, typename Epi>
__device__ __forceinline__ void mma_chunk(const T* __restrict__ h, const T* __restrict__ wv,
                                          const float* __restrict__ bv, int N, int D, int V,
                                          int r0, int c_begin, int c_end, T* hs, T* ring,
                                          Epi&& epi) {
  constexpr int BK = Tc<T>::BK, WP = Tc<T>::WP, KS = Tc<T>::KS;
  constexpr int CPR = BV * (int)sizeof(T) / 16;   // 16-byte copies a stage row
  constexpr int RPP = TC_THREADS / CPR;           // stage rows a pass of the block
  const int hp = tc_hpitch<T>(D), dpad = hp - Tc<T>::HP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int kstages = (dpad + BK - 1) / BK;
  const int total = (c_end - c_begin + BV - 1) / BV * kstages;

  // rows [r0, r0 + BN) of h, 4 elements a copy, zeros past N and past D
  for (int r = warp; r < BN; r += TC_THREADS / 32) {
    const bool row_ok = r0 + r < N;
    const T* src = h + (long long)(row_ok ? r0 + r : 0) * D;
    for (int c = lane; 4 * c < dpad; c += 32)
      cp_async_4(smem_u32(hs + r * hp + 4 * c), src + 4 * c, row_ok && 4 * c < D);
  }
  // stage s: depth rows [BK (s % kstages), + BK) of tile s / kstages, 16
  // bytes a copy; a thread copies column chunk tid % CPR of rows tid / CPR +
  // RPP i
  const int cc = (16 / (int)sizeof(T)) * (tid % CPR), rr = tid / CPR;
  auto issue = [&](int s) {
    if (s < total) {
      const int tile = s / kstages;
      const int d0 = (s - tile * kstages) * BK;
      const int col = c_begin + tile * BV + cc;
      const uint32_t dst = smem_u32(ring + (s % TC_STAGES) * BK * WP + rr * WP + cc);
#pragma unroll
      for (int i = 0; i < BK / RPP; ++i) {
        const int d = d0 + rr + RPP * i;
        const bool ok = col < V && d < D;
        cp_async16(dst + i * RPP * WP * (int)sizeof(T), ok ? wv + (long long)d * V + col : wv,
                   ok);
      }
    }
    cp_async_commit();
  };
  issue(0);          // with h's copies
  issue(1);

  const T* a_src;
  int b_off;
  if constexpr (KS == 16) {
    a_src = hs + (warp * 16 + (lane & 15)) * hp + (lane >> 4) * 8;
    b_off = (lane & 15) * WP + (lane >> 4) * 8;
  } else {
    a_src = hs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * hp + 4 * (lane >> 4);
    b_off = t * WP + (lane >> 2);
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int ks = 0, col0 = c_begin;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();                 // stage s is in; stage s - 1's buffer is free
    issue(s + TC_STAGES - 1);
    const int d0 = ks * BK;
    stage_products(acc, a_src, ring + (s % TC_STAGES) * BK * WP + b_off, d0,
                   min(BK, dpad - d0) / KS);
    if (++ks < kstages) continue;

    // the tile at col0 is done: bias and mask, then the caller's epilogue
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
    epi(acc, col0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    ks = 0;
    col0 += BV;
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <typename T, int K>
__global__ void __launch_bounds__(TC_THREADS) score_partial_mma_kernel(
    const T* __restrict__ h, const T* __restrict__ wv,
    const float* __restrict__ bv, int N, int D, int V, int chunk_cols,
    int n_chunks, float* __restrict__ part_v, int* __restrict__ part_i,
    float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* hs = reinterpret_cast<T*>(smem);
  T* ring = hs + BN * tc_hpitch<T>(D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * BN;
  const int chunk = blockIdx.x;
  const int c_begin = chunk * chunk_cols;
  const int c_end = min(V, c_begin + chunk_cols);

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

  // each tile: each row's (max, sum) and list
  mma_chunk(h, wv, bv, N, D, V, r0, c_begin, c_end, hs, ring,
            [&](const float (&acc)[8][4], int col0) {
              row_epilogue<0, K>(acc, col0, t, m_run[0], s_run[0], lv0, li0, tv[0], ti[0]);
              row_epilogue<1, K>(acc, col0, t, m_run[1], s_run[1], lv1, li1, tv[1], ti[1]);
              quad_best(tv[0], ti[0]);
              quad_best(tv[1], ti[1]);
            });

  // the four lanes of a row: (max, sum) by shuffles, lists through shared
  // memory (the ring, which tc_smem_bytes sizes for them, is free once every
  // warp is past its last stage, as mma_chunk leaves it)
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

// The wide first pass on the tensor cores (k above KMAX, aligned bf16): the
// product of mma_chunk; after each tile every lane folds its 16 scores of
// rows g and g + 8 into their (max, sum 2^x) and writes them to its warp's
// rows of the score tile, and the warp merges its 16 rows into their lists
// (WideLists::tile).  At the chunk's end the quad's (max, sum) pairs are
// combined by shuffles.
__global__ void __launch_bounds__(TC_THREADS) score_partial_wide_mma_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ wv,
    const float* __restrict__ bv, int N, int D, int V, int kc, int chunk_cols,
    int n_chunks, float* __restrict__ part_v, int* __restrict__ part_i,
    float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ring = hs + BN * tc_hpitch<bf16>(D);
  WideLists lists(reinterpret_cast<unsigned char*>(ring) + tc_ring_bytes<bf16>(), kc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * BN;
  const int chunk = blockIdx.x;
  const int c_begin = chunk * chunk_cols;
  const int c_end = min(V, c_begin + chunk_cols);

  float m_run[2] = {-INFINITY, -INFINITY}, s_run[2] = {0.f, 0.f};
  mma_chunk(h, wv, bv, N, D, V, r0, c_begin, c_end, hs, ring,
            [&](const float (&acc)[8][4], int col0) {
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                float x[16];
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                  x[2 * n] = acc[n][2 * r];
                  x[2 * n + 1] = acc[n][2 * r + 1];
                  *reinterpret_cast<float2*>(lists.sc + (warp * 16 + g + 8 * r) * SC_PITCH +
                                             8 * n + 2 * t) =
                      make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
                }
                lse_update<16>(m_run[r], s_run[r], x);
              }
              lists.tile(warp, lane, r0, N, col0, c_end, kc);
            });

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m, sum;
    lse_combine<4>(m_run[r], s_run[r], m, sum);
    const int row = r0 + warp * 16 + g + 8 * r;
    if (t == 0 && row < N) {
      part_m[(long long)row * n_chunks + chunk] = m;
      part_s[(long long)row * n_chunks + chunk] = sum;
    }
  }
  lists.store(r0, N, chunk, n_chunks, kc, part_v, part_i);
}

// the tensor-core kernel takes more than 48 KB of shared memory only after
// opting in, once per device
template <typename T, int K>
cudaError_t mma_opt_in() {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !opted[dev])) {
    err = cudaFuncSetAttribute(score_partial_mma_kernel<T, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(tc_smem_bytes<T>(TC_MAXD, K)));
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

template <typename T>
int launch_mma(int k, dim3 grid, cudaStream_t s, const T* h, const T* wv,
               const float* bv, int N, int D, int V, int chunk_cols, int n_chunks,
               float* part_v, int* part_i, float* part_m, float* part_s) {
  return with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = mma_opt_in<T, K>();
    if (err != cudaSuccess) return static_cast<int>(err);
    score_partial_mma_kernel<T, K><<<grid, TC_THREADS, tc_smem_bytes<T>(D, K), s>>>(
        h, wv, bv, N, D, V, chunk_cols, n_chunks, part_v, part_i, part_m, part_s);
    return 0;
  });
}

// the wide first pass of this dispatch as fn(kernel, threads, dynamic shared
// memory), its shared memory opened to the longest list first (once per
// device and kernel)
template <typename Scalar, bool TC, typename Fn>
int with_wide_kernel(int D, int kc, Fn&& fn) {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  auto call = [&](auto kernel, int threads, size_t smem, size_t most) {
    if (err == cudaSuccess && (dev >= 64 || !opted[dev])) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(most));
      if (err == cudaSuccess && dev < 64) opted[dev] = true;
    }
    return err != cudaSuccess ? static_cast<int>(err) : fn(kernel, threads, smem);
  };
  if constexpr (TC)
    return call(score_partial_wide_mma_kernel, TC_THREADS, tc_wide_smem_bytes(D, kc),
                tc_wide_smem_bytes(TC_MAXD, LIST_MAX));
  else
    return call(score_partial_wide_kernel<Scalar>, WIDE_THREADS, wide_tail_bytes(kc),
                wide_tail_bytes(LIST_MAX));
}

// TC: the tensor-core first passes, which need D % 4 == 0, D <= 512, Wv's
// rows in 16-byte copies (V % 8 == 0 in bf16, V % 4 in f32), h on a boundary
// of 4 elements (8 bytes, 16) and wv on a 16-byte one; above KMAX bf16 only.
// A chunk's list holds kc = min(k, chunk_cols) entries (part_v / part_i are
// (N, n_chunks, kc)); k above KMAX takes a wide first pass, whose lists hold
// at most LIST_MAX.
template <typename Scalar, bool TC>
int run(const void* h, const void* wv, const float* bv, const float* tail,
        float* part_v, int* part_i, float* part_m, float* part_s, float* vals,
        int* idx, float* lse, int N, int D, int V, int T, int k,
        int chunk_cols, int n_chunks, void* stream) {
  const int kc = k < chunk_cols ? k : chunk_cols;
  if (k < 1 || k > V + T || chunk_cols < BV || chunk_cols % BV != 0 ||
      (k > KMAX && kc > LIST_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (TC) {
    if (D % 4 || D > TC_MAXD || V % (16 / sizeof(Scalar)) ||
        reinterpret_cast<uintptr_t>(h) % (4 * sizeof(Scalar)) ||
        reinterpret_cast<uintptr_t>(wv) % 16 ||
        (k > KMAX && !std::is_same<Scalar, bf16>::value))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid1(n_chunks, (N + BN - 1) / BN);
  if (k > KMAX) {
    constexpr bool WIDE_TC = TC && std::is_same<Scalar, bf16>::value;
    const int err = with_wide_kernel<Scalar, WIDE_TC>(D, kc, [&](auto kernel, int threads,
                                                                  size_t smem) {
      kernel<<<grid1, threads, smem, s>>>(
          static_cast<const Scalar*>(h), static_cast<const Scalar*>(wv), bv, N, D, V, kc,
          chunk_cols, n_chunks, part_v, part_i, part_m, part_s);
      return 0;
    });
    if (err) return err;
  } else if constexpr (TC) {
    const int err = launch_mma<Scalar>(k, grid1, s, static_cast<const Scalar*>(h),
                                       static_cast<const Scalar*>(wv), bv, N, D, V, chunk_cols,
                                       n_chunks, part_v, part_i, part_m, part_s);
    if (err) return err;
  } else {
    score_partial_kernel<Scalar><<<grid1, THREADS, 0, s>>>(
        static_cast<const Scalar*>(h), static_cast<const Scalar*>(wv), bv, N, D, V, k,
        chunk_cols, n_chunks, part_v, part_i, part_m, part_s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge(s, part_v, part_i, part_m, part_s, tail, N, V, T, k, kc, n_chunks, vals,
                      idx, lse);
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
ICEK_EXPORT int score_topk_f32_mma(SCORE_ARGS) { return run<float, true>(SCORE_PASS); }
ICEK_EXPORT int score_topk_bf16(SCORE_ARGS) {
  return run<__nv_bfloat16, false>(SCORE_PASS);
}
ICEK_EXPORT int score_topk_bf16_mma(SCORE_ARGS) {
  return run<__nv_bfloat16, true>(SCORE_PASS);
}

// The first pass that score_topk_<dtype>[_mma] launches for lists of kc
// entries (at most LIST_MAX above KMAX) and width D: its blocks resident on
// the current device at once (the wrapper splits the vocab so the first pass
// has about that many) and its rows a block (64)
ICEK_EXPORT int score_topk_grid(int bf16, int tc, int kc, int D, int* blocks, int* rows) {
  if (kc < 1 || D < 1 || (kc > KMAX && kc > LIST_MAX) ||
      (tc && (D > TC_MAXD || (!bf16 && kc > KMAX))))
    return static_cast<int>(cudaErrorInvalidValue);
  *rows = BN;
  if (kc > KMAX) {
    auto occupancy = [&](auto kernel, int threads, size_t smem) {
      return resident_blocks(kernel, threads, smem, blocks);
    };
    if (tc) return with_wide_kernel<__nv_bfloat16, true>(D, kc, occupancy);
    return bf16 ? with_wide_kernel<__nv_bfloat16, false>(D, kc, occupancy)
                : with_wide_kernel<float, false>(D, kc, occupancy);
  }
  if (tc)
    return with_k(kc, [&](auto kk) {
      constexpr int K = decltype(kk)::value;
      auto occupancy = [&](auto scalar) {
        using T = decltype(scalar);
        const cudaError_t err = mma_opt_in<T, K>();
        if (err != cudaSuccess) return static_cast<int>(err);
        return resident_blocks(score_partial_mma_kernel<T, K>, TC_THREADS,
                               tc_smem_bytes<T>(D, K), blocks);
      };
      return bf16 ? occupancy(__nv_bfloat16{}) : occupancy(float{});
    });
  return bf16 ? resident_blocks(score_partial_kernel<__nv_bfloat16>, THREADS, 0, blocks)
              : resident_blocks(score_partial_kernel<float>, THREADS, 0, blocks);
}
