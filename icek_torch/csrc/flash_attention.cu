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
// Three families of kernels live here.
//
// Every kernel of families 1 and 2 is templated on the padded head dim HDP
// (32, 64 or 128: hd_pad); the pad is zeros in shared memory and registers
// only.  What the head dim changes is said where it matters: the tiles'
// pitch, how many 32-bit (or 16-byte) copies stage a row, the registers a
// warp's fragments and accumulators take (the dK/dV kernel's K and V at HDP
// 128, the TF32 kernels' split A operands above 32), and the shared memory
// (dynamic, allowed above 48 KB per launch).
//
// 1. The tensor-core kernels (flash_*_mma_kernel): bf16 with an even Hd <=
//    128 and 4-byte aligned head rows, which is every attention of the
//    presets (10 heads of Hd 30) and of a --geometry whose head dim is even
//    (512x8: 8 heads of 64).
//    * Alignment.  A head's row is 30 bf16 = 60 bytes at h * 60 bytes
//      inside a row of 600 bytes; a fused-QKV view has a row stride of 1800
//      bytes and starts 600 or 1200 bytes into its buffer.  Global
//      addresses are therefore 4-byte aligned and no more: 16-byte vector
//      loads, 16-byte cp.async and TMA (16-byte aligned addresses and
//      strides) are all out.  Every global access here is one 32-bit word
//      (a bf16 pair), 15 per head row, lanes on neighbouring words; tiles
//      are staged with 4-byte cp.async, whose zero-fill form also writes
//      the pad word (Hd 30 -> 32) and the rows past the end, so the pad
//      lanes exist in shared memory and registers only.  A head row of 64
//      bf16 is 128 bytes: in a D-512 fused projection every view is 16-byte
//      aligned, and tiles are then staged 16 bytes a copy (Shape::vec, set by
//      the entry points from the pointers and strides).
//    * Products.  mma.sync.m16n8k16 (bf16 in, f32 out), Hd padded to HDP =
//      HDP / 16 k-steps.  A warp owns 16 rows; their operand fragments come
//      straight from global memory into HDP / 4 registers.  The other operand
//      is staged in shared memory as bf16, 64 rows a tile with a row pitch of
//      HDP + 8 (80, 144 or 272 bytes: the eight rows of an ldmatrix phase
//      fall on distinct banks), double-buffered so the next tile loads under this
//      tile's products.  K as stored is already the B operand of S = Q K^T
//      and V of dP = dO V^T (plain ldmatrix); V in O = P V and K in dQ =
//      dS K are read through ldmatrix.trans.  Two neighbouring accumulator
//      tiles rounded to bf16 are one A fragment, so P and dS go from the
//      softmax into their second product without touching shared memory.
//      wgmma was not taken for these: it wants 64-row tiles and swizzled
//      operands, two of the three sites of the presets have 32 query rows,
//      and at HDP 32 the kernels are not bound by the matrix unit.  At HDP
//      64 and 128 the backward is a wgmma pair (flash_bwd_{dq,dkv}_wgmma_
//      kernel<HDP, DROP>) and the forward is flash_fwd_wgmma_kernel (each
//      described where it is defined): there the mma.sync kernels were
//      bound by the ldmatrix reads of the staged operands and their issue.
//      The forward takes wgmma at 32-row sites too (the 512x8 decoder's
//      self and cross attention): its half-empty 64-row tiles measured
//      faster than the mma.sync forward's 16-row warps there (PERF.md).
//    * Forward and dQ: a block of four warps (two when Tq <= 32) walks the
//      key tiles; whole tiles beyond kv_len or above the causal diagonal
//      are skipped, the straddling tile is masked element-wise.  The online
//      softmax lives in the log2 domain (one FFMA and one ex2 a score) and
//      reduces over the four lanes of a quad.
//    * dK/dV: a warp owns 16 keys and computes the transposed scores S^T =
//      K Q^T and dP^T = V dO^T over staged query tiles, so P^T and dS^T are
//      again A fragments for dV += P^T dO and dK += dS^T Q.  At HDP 128 the
//      dK and dV accumulators take 128 registers a lane, so K and V are
//      staged once a block and read back by ldmatrix instead of held (the
//      wgmma pair stages them too, and reads them as SS operands).
//    * Above HDP 32 a block has four warps whatever Tq is: each extra
//      instantiation lengthens the build, and the two-warp block is what
//      the narrow decoder sites of the presets needed.
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
// 2. The TF32 kernels (flash_fwd_tf32_kernel, at HDP 32
//    flash_fwd_tf32_hd32_kernel, flash_bwd_dq_tf32_kernel,
//    flash_bwd_dkv_tf32_kernel): f32 at any Hd <= 128, and bf16 inputs that
//    miss the alignment above or have an odd head dim, forward and
//    backward, so both directions of one call run one family.  The work is the bf16 kernels' products in
//    f32: at the geo encoder site 13.9 GFLOP each, 29.7 GFLOP the forward
//    (0.44 ms at the 67 TF/s of the f32 CUDA cores) and 69 GFLOP the
//    backward's seven (1.04 ms), against 0.19 ms of backward bytes.  So the
//    products go on the tensor cores, which take f32 only as TF32 (a 10-bit
//    mantissa, about three decimal digits: one pass breaks the 1e-4 checks).
//    Each f32 operand is split into a TF32 high part (cvt.rna) and the TF32
//    of the residual, and a product is three m16n8k8 TF32 mma.sync (lo hi +
//    hi lo + hi hi; lo lo is below the pieces' own rounding) with f32
//    accumulation: a relative error of about 2^-21 a term ("3xTF32").  bf16
//    values, and P and dS rounded to bf16, are exact in TF32: for bf16
//    inputs one pass is exact.  Three such passes at 495 TF/s (the dense
//    TF32 peak) take 0.18 ms of the forward's work and 0.6 ms of the
//    backward's; what the kernels are bound by in the end is again
//    instructions: each B operand read from shared memory is split per warp
//    (three instructions an element), and a head row of f32 in a fused-QKV
//    view (120 bytes, at a stride of 3600) is 8-byte aligned at best, so
//    tiles are staged by 4-byte cp.async, a warp a row of 32 elements.
//    * The forward is the tensor-core forward's walk (a warp owns 16 query
//      rows, Q split in registers, online softmax in the log2 domain once a
//      tile) over f32 tiles, 8 keys a step; its scores are the backward's
//      to the bit (first_product, then one rounded scale), so a one-hot
//      row's P is the same 1 in both directions.  In P V, V is split by
//      integer rounding (mma_add_bits), the cheaper split; splitting K or V
//      once a tile by the block instead of per warp cost a barrier and a
//      pass more than it saved.
//    * The backward's structure is the bf16 backward's: a warp owns 16 rows
//      with its A operands (Q and dO; K and V) split, the other operand is
//      staged in shared memory as f32 (64 or 32 rows a tile, ftile_of; a
//      pitch of HDP + 4 floats: the eight rows of a fragment load fall on
//      distinct banks), double buffered, and walked 8 keys (queries) at a
//      time; dK/dV works on the transposed scores; no atomics, so launches
//      agree bit for bit.
//    * At HDP 64 and 128 every operand is split by integer rounding
//      (split_as, tf32_bits: three instructions an element, where the
//      cvt.rna pair expands into compare-and-select code), in the forward
//      and both backward kernels alike, so S stays the same bits in all
//      three (the f32 backward at the 512x8 encoder site went from 5.9 to
//      4.9 ms on an H100 that way, the forward from 1.14 to 1.00); HDP 32
//      keeps cvt.rna and its bits.
//    * Where the split A operands live (SplitRows, split_smem): in
//      registers, or in the warp's own region of shared memory, lane-major,
//      each lane reading back the fragments it wrote (two 16-byte loads a
//      d-step), which leaves the registers to the accumulators (dK and dV at
//      HDP 128: 128 a lane).  The backward keeps them in registers up to HDP
//      64 (Q and dO, or K and V, split: 128 registers at 64), the forward up
//      to 32.  The scores are summed over the d-steps in the same order
//      whatever holds the operand, so S stays the backward's to the bit.
//      At HDP 128, where a block of four 16-row groups holds 196 KB of
//      shared memory, two warps share each group's region, each taking half
//      of every tile's 8-key (query) steps (group_warps: eight warps an SM,
//      not four), and a warp reads each split A fragment once for its two
//      steps (first_products_steps), where reading it once a step made the
//      region's loads the kernels' bound; the pair folds its row statistics
//      and its sums in warp order.
//    * P and dS reach their second product without a shuffle: the m16n8k8
//      accumulator holds columns 2 t and 2 t + 1 where the A fragment
//      wants t and t + 4, so the accumulator is taken as A with its k order
//      permuted (column 2 t as k index t, 2 t + 1 as t + 4; acc_as_a), and
//      the B operand of that product reads its rows in the same order.
//    * Consistency.  A decoder's first self-attention sees logits in the
//      hundreds at init, where softmax is one-hot
//      and dS = P (dP - delta) is all cancellation: the exact dS of the
//      winning key is 0.  With the forward's lse and delta = rowsum(dO O),
//      both rounded along another path than this kernel's S and dP, that
//      cancellation left 2^-22 of |dP| (dQ and dK off by 1.1e-4 of a weight
//      gradient against the plain path, the old CUDA-core kernels 1.9e-5,
//      whose S and dP repeated the forward's arithmetic; three TF32 pieces
//      for every product did not help).  So the dQ kernel walks its keys
//      twice: pass 0 takes each row's lse2 = log2 sum 2^x (x = S scale log2
//      e, one rounding) and delta = sum 2^(x - lse2) dP' from its own S and
//      dP', pass 1 uses them, and the dK/dV kernel reads them and forms S^T
//      and dP^T bit for bit as dQ's S and dP (first_products): a one-hot
//      row's P is then exactly 1 and its dS exactly 0, as in the plain
//      version.
//    * Rounding.  O, dQ, dK and dV each sum one product per 8 keys
//      (queries): a step's product is formed apart and added by an f32 add
//      (mma_add), since the tensor cores' accumulation is not round to
//      nearest (summed in the mma it put twice the error into dQ, dK and dV
//      at the geo encoder site).
//    * Dropout: the TF32 forward saves no keep bits, so the three kernels
//      each draw the mask, one Philox block per four scores, shared by the
//      lanes that hold its four keys: in the forward and dQ the two lanes of
//      a row pair (keep4_rows), in dK/dV the four lanes g = 4 u .. 4 u + 3 of
//      one t (keep4_cols).
//
// 3. The CUDA-core forward (flash_fwd_kernel): the first design, on no
//    route since the tensor-core families take every Hd <= 128 (the entries
//    flash_fwd_f32 / flash_fwd_bf16 take any Hd <= 128, and dropout at Hd <=
//    32, so the kernel can be timed beside the kernels that replaced it).
//    One thread owns a query row with its
//    operands in registers and the dot products run in f32, one
//    shared-memory operand per FMA; Hd is padded to a compile-time bound
//    (32 / 64 / 128).
//
// Dropout mask: score (b, h, q, k) keeps iff keep_bits(random_bits(seed,
// STREAM_FLASH, ((b * H + h) * Tq + q) * Tk4 + k)) with Tk4 = Tk rounded up
// to a multiple of 4: the element's absolute position, so every kernel
// can regenerate the forward's mask under its own tiling (the TF32
// backward and keep_mask_kernel do), and four adjacent keys of a row share
// one Philox block.  `block0` (4 * block0 added to every index) places a
// call's batch rows inside a larger batch: a data-parallel rank holding rows
// b0.. of a global batch passes block0 = b0 * H * Tq * Tk4 / 4 and draws the
// global batch's mask.
#include <cstdint>
#include <initializer_list>
#include <type_traits>

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
  int vec;                                        // tiles may be staged 16 bytes a copy
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
// Tensor-core kernels: bf16, even Hd <= 128 and 4-byte aligned head rows.
// The head dim is padded to HDP (32, 64 or 128) with zeros.
// ===========================================================================

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;    // rows of a staged tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// the row pitch in bf16 of a staged tile of head dim HDP: HDP + 8, so the
// eight rows of an ldmatrix phase fall on distinct banks (see the header)
template <int HDP> __host__ __device__ constexpr int pitch_of() { return HDP + 8; }

// the padded head dim of a call: 32, 64 or 128
__host__ __device__ constexpr int hd_pad(int Hd) { return Hd <= 32 ? 32 : Hd <= 64 ? 64 : 128; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// Stage rows [r0, r0 + TILE) of one head into a shared tile.  `src` points at
// (row 0, d 0) of the head and `st` is its row stride in elements; rows >=
// limit and words >= hw (= Hd / 2) are written as zero (their source address
// is formed but not read).  With `vec` above HDP 32 (Hd % 8 == 0 and every
// address and stride 16-byte aligned: a Hd-64 view of a fused projection) a
// copy moves 16 bytes, HDP / 8 lanes a row; else 4 bytes (a bf16 pair), min(HDP / 2, 32)
// lanes a row.  The loops are unrolled with the addresses advanced by
// constants: forming each address anew (a 64-bit multiply, selects and a
// compare per copy) cost more instructions than the tile's arithmetic.
template <int NT, int HDP>
__device__ __forceinline__ void stage_rows(bf16 (*dst)[pitch_of<HDP>()], const bf16* src,
                                           long long st, int r0, int limit, int hw, bool vec) {
  constexpr int PT = pitch_of<HDP>();
  // compiled out at HDP 32, where no call of the presets is aligned and the
  // branch cost the HDP-32 forward 3-5% on an H100 (`_variants` vec32)
  if (HDP > 32 && vec) {
    constexpr int LPR = HDP / 8, STEP = NT / LPR;   // 16-byte chunks a row
    static_assert(TILE % STEP == 0, "a block stages whole passes");
    const int c = threadIdx.x % LPR, r = threadIdx.x / LPR;
    const bool lane_ok = 4 * c < hw;
    const int left = limit - r0 - r;
    const uint32_t d = smem_u32(&dst[r][8 * c]);
    const bf16* p = src + (long long)(r0 + r) * st + (lane_ok ? 8 * c : 0);
    const long long step = STEP * st;
#pragma unroll 8
    for (int i = 0; i < TILE; i += STEP) {
      cp_async16(d + i * PT * 2, p, lane_ok && i < left);
      p += step;
    }
    return;
  }
  constexpr int HW = HDP / 2, LPR = HW < 32 ? HW : 32, WPL = HW / LPR, STEP = NT / LPR;
  static_assert(TILE % STEP == 0, "a block stages whole passes");
  const int w = threadIdx.x % LPR, r = threadIdx.x / LPR;
  const int left = limit - r0 - r;
  const uint32_t d = smem_u32(&dst[r][2 * w]);
  const bf16* p = src + (long long)(r0 + r) * st + (w < hw ? 2 * w : 0);
  const long long step = STEP * st;
#pragma unroll 8   // 16 passes in one piece (64 threads) make ptxas spill
  for (int i = 0; i < TILE; i += STEP) {
#pragma unroll
    for (int e = 0; e < WPL; ++e)   // word w + 32 e: an immediate offset from p
      cp_async4(d + i * PT * 2 + e * LPR * 4, p + 2 * e * LPR, w + e * LPR < hw && i < left);
    p += step;
  }
}

// The A fragments (HDP / 16 k-steps of m16n8k16) of rows [r0, r0 + 16) of
// one head, straight from global memory; `src`, `st`, `limit`, `hw` as above.
// With g = lane / 4, t = lane % 4, register i of k-step s is the bf16 pair at
// row g + 8 (i % 2), word 8 s + 4 (i / 2) + t.
template <int KS>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[KS][4], const bf16* src,
                                             long long st, int r0, int limit, int hw,
                                             int g, int t) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
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
// stores and the dQ kernel loads one coalesced 128-byte line per cell.  The
// layout does not depend on the head dim.
__device__ __forceinline__ long long keep_cell(const Shape& a, int b, int h, int rows16,
                                               int tile) {
  const int cells_q = ((a.Tq + TILE - 1) / TILE) * (TILE / 16);
  const int cells_k = (a.Tk + TILE - 1) / TILE;
  return ((((long long)b * a.H + h) * cells_q + rows16) * cells_k + tile) * 32;
}

// shared memory of the bf16 tensor-core kernels: two double-buffered tiles
// (K and V, or Q and dO), and for dK/dV the per-row lse and delta
template <int HDP>
__host__ __device__ constexpr int mma_tiles_bytes() { return 2 * 2 * TILE * pitch_of<HDP>() * 2; }
template <int HDP>
__host__ __device__ constexpr int dkv_mma_bytes() {
  return mma_tiles_bytes<HDP>() + 2 * 2 * TILE * 4;
}

// Forward.  A block of NW warps owns NW * 16 query rows of one (batch, head);
// a warp keeps its rows' Q fragments, output accumulator and softmax state in
// registers and walks the key tiles.
template <int HDP, int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, uint32_t* __restrict__ keep_words,
    const Shape a) {
  constexpr int BQ = NW * 16, NT = NW * 32, PT = pitch_of<HDP>(), KS = HDP / 16, NO = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*ks)[TILE][PT] = reinterpret_cast<bf16(*)[TILE][PT]>(smem);
  bf16(*vs)[TILE][PT] = ks + 2;
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
    stage_rows<NT, HDP>(ks[it & 1], kp, a.k_st, it * TILE, blk_end, hw, a.vec);
    stage_rows<NT, HDP>(vs[it & 1], vp, a.v_st, it * TILE, blk_end, hw, a.vec);
  };
  stage(0);
  cp_async_commit();

  uint32_t qf[KS][4];
  load_a_frags<KS>(qf, q + b * a.q_sb + (long long)h * a.Hd, a.q_st, row0, a.Tq, hw, g, t);
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
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
      const bf16(*kt)[PT] = ks[it & 1];
      const bf16(*vt)[PT] = vs[it & 1];
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
        for (int d = 0; d < HDP / 32; ++d) {
          uint32_t kb[4];
          ldsm_x4(kb, &kt[8 * j + (lane & 7)][32 * d + 8 * (lane >> 3)]);
          mma_bf16(s[j], qf[2 * d], kb[0], kb[1]);
          mma_bf16(s[j], qf[2 * d + 1], kb[2], kb[3]);
        }
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
      for (int n = 0; n < NO; ++n)
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
        for (int np = 0; np < HDP / 16; ++np) {
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
    for (int n = 0; n < NO; ++n)
      if (4 * n + t < hw)
        op[4 * n + t] = pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0) lse[((long long)b * a.H + h) * a.Tq + row] = (m[r] + log2f(lsum)) * LN2;
  }
}

// dQ, and delta = rowsum(dO * O) for the dK/dV kernel.  The forward's shape:
// a warp owns 16 query rows (Q and dO fragments in registers) and walks the
// key tiles, 32 keys at a time: S and dP from the same K and V tiles, dS
// packed into A fragments, dQ += dS K.
template <int HDP, int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ d_o,
    const float* __restrict__ lse, const uint32_t* __restrict__ keep_words,
    float* __restrict__ delta, bf16* __restrict__ dq, const Shape a) {
  constexpr int BQ = NW * 16, NT = NW * 32, PT = pitch_of<HDP>(), KS = HDP / 16, NO = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*ks)[TILE][PT] = reinterpret_cast<bf16(*)[TILE][PT]>(smem);
  bf16(*vs)[TILE][PT] = ks + 2;
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
    stage_rows<NT, HDP>(ks[it & 1], kp, a.k_st, it * TILE, blk_end, hw, a.vec);
    stage_rows<NT, HDP>(vs[it & 1], vp, a.v_st, it * TILE, blk_end, hw, a.vec);
  };
  stage(0);
  cp_async_commit();

  // o, dO, dq: contiguous (B, Tq, H, Hd)
  const long long obase = ((long long)b * a.Tq * a.H + h) * a.Hd;
  const long long ost = (long long)a.H * a.Hd;
  const long long srow0 = ((long long)b * a.H + h) * a.Tq;
  uint32_t qf[KS][4], gf[KS][4];
  load_a_frags<KS>(qf, q + b * a.q_sb + (long long)h * a.Hd, a.q_st, row0, a.Tq, hw, g, t);
  load_a_frags<KS>(gf, d_o + obase, ost, row0, a.Tq, hw, g, t);
  float dl[2] = {0.f, 0.f}, L2[2];
  {
    uint32_t of[KS][4];
    load_a_frags<KS>(of, o + obase, ost, row0, a.Tq, hw, g, t);
#pragma unroll
    for (int s = 0; s < KS; ++s)
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
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
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
    const bf16(*kt)[PT] = ks[it & 1];
    const bf16(*vt)[PT] = vs[it & 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kc = it * TILE + 32 * half;   // first key of this chunk
      if (kc >= warp_end) continue;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
        for (int d = 0; d < HDP / 32; ++d) {
          uint32_t kb[4], vb[4];
          const int r = 32 * half + 8 * j + (lane & 7), col = 32 * d + 8 * (lane >> 3);
          ldsm_x4(kb, &kt[r][col]);
          ldsm_x4(vb, &vt[r][col]);
          mma_bf16(s[j], qf[2 * d], kb[0], kb[1]);
          mma_bf16(s[j], qf[2 * d + 1], kb[2], kb[3]);
          mma_bf16(dp[j], gf[2 * d], vb[0], vb[1]);
          mma_bf16(dp[j], gf[2 * d + 1], vb[2], vb[3]);
        }
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
        for (int np = 0; np < HDP / 16; ++np) {
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
    for (int n = 0; n < NO; ++n)
      if (4 * n + t < hw)
        dp32[4 * n + t] = pack_bf16(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
  }
}

// dK and dV.  A block of NW warps owns NW * 16 keys of one (batch, head), a
// warp 16 of them; query tiles (q, dO, lse, delta) pass through shared
// memory, 32 queries at a time.  The scores are computed transposed (S^T = K
// Q^T, dP^T = V dO^T), so P^T and dS^T come out as A fragments for dV += P^T
// dO and dK += dS^T Q.  Keys at or beyond kv_len and causally hidden pairs
// add exactly zero.  The warp's K and V fragments stay in registers (up to
// HDP 64: at 128 the dK and dV accumulators alone take 128 registers a lane,
// and the wgmma pair runs there).
template <int HDP, int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint32_t* __restrict__ keep_words,
    bf16* __restrict__ dk, bf16* __restrict__ dv, const Shape a) {
  constexpr int BKT = NW * 16, NT = NW * 32, PT = pitch_of<HDP>(), KS = HDP / 16, NO = HDP / 8;
  static_assert(HDP <= 64, "K and V fragments in registers");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*qs)[TILE][PT] = reinterpret_cast<bf16(*)[TILE][PT]>(smem);
  bf16(*gs)[TILE][PT] = qs + 2;
  float(*ls)[TILE] = reinterpret_cast<float(*)[TILE]>(smem + mma_tiles_bytes<HDP>());
  float(*dls)[TILE] = ls + 2;
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
    stage_rows<NT, HDP>(qs[buf], qp, a.q_st, it * TILE, a.Tq, hw, a.vec);
    stage_rows<NT, HDP>(gs[buf], gp, ost, it * TILE, a.Tq, hw, a.vec);
    for (int i = threadIdx.x; i < TILE; i += NT) {
      const bool ok = it * TILE + i < a.Tq;
      const long long at = srow0 + (ok ? it * TILE + i : 0);
      cp_async4(smem_u32(&ls[buf][i]), lse + at, ok);
      cp_async4(smem_u32(&dls[buf][i]), delta + at, ok);
    }
  };
  const bf16* kbase = k + b * a.k_sb + (long long)h * a.Hd;
  const bf16* vbase = v + b * a.v_sb + (long long)h * a.Hd;
  if (first < last) stage(first);
  cp_async_commit();

  uint32_t kf[KS][4], vf[KS][4];
  load_a_frags<KS>(kf, kbase, a.k_st, key0, a.kv_len, hw, g, t);
  load_a_frags<KS>(vf, vbase, a.v_st, key0, a.kv_len, hw, g, t);
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
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
    const bf16(*qt)[PT] = qs[buf];
    const bf16(*gt)[PT] = gs[buf];
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
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
      // 32 head dims a step, each query tile's k-steps in order
#pragma unroll
      for (int d = 0; d < HDP / 32; ++d) {
        uint32_t ka[2][4], va[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[e][i] = kf[2 * d + e][i];
            va[e][i] = vf[2 * d + e][i];
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t qb[4], gb[4];
          const int r = 32 * half + 8 * j + (lane & 7), col = 32 * d + 8 * (lane >> 3);
          ldsm_x4(qb, &qt[r][col]);
          ldsm_x4(gb, &gt[r][col]);
          mma_bf16(st[j], ka[0], qb[0], qb[1]);
          mma_bf16(st[j], ka[1], qb[2], qb[3]);
          mma_bf16(dpt[j], va[0], gb[0], gb[1]);
          mma_bf16(dpt[j], va[1], gb[2], gb[3]);
        }
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
        for (int np = 0; np < HDP / 16; ++np) {
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
    for (int n = 0; n < NO; ++n)
      if (4 * n + t < hw) {
        dk32[4 * n + t] = pack_bf16(dka[n][2 * r] * a.scale, dka[n][2 * r + 1] * a.scale);
        dv32[4 * n + t] = pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// The HDP-64 backward on wgmma (bf16).  At HDP 64 the mma.sync kernels above
// read every staged operand fragment by ldmatrix for one m16 tile, two
// mma.sync per ldmatrix.x4, four warps each reading the whole tile: the
// shared-memory reads and their issue, not the matrix unit, held them at
// 5.4x their bound at the 512x8 encoder site.  Here a block is one
// warpgroup (four warps, 128 threads) that owns 64 rows (dQ: queries; dK/dV:
// keys), and every product is one wgmma.mma_async m64n64k16 a k-step, whose
// B operand the tensor cores read from shared memory themselves:
//   * the staged tiles are 64 rows of 128 bytes (HDP 64 bf16) in the 128-byte
//     swizzle (16-byte chunk j of row r at chunk j ^ (r % 8); sw128_chunk), on
//     1024-byte boundaries; one descriptor form (sw128_desc) reads such a tile
//     K-major as the B of S = Q K^T (K's rows: d is the reduction) and, with
//     the transpose bit, MN-major as the B of dQ += dS K (keys are the
//     reduction, d the columns), 16 rows (2048 bytes) a k-step;
//   * the A operands come from registers (the .rs form), in mma.sync's A
//     fragment layout, warp w holding rows 16 w .. 16 w + 15: the warp's Q
//     and dO (K and V) fragments straight from global memory, and P, dS (P^T,
//     dS^T) packed from the accumulators, which the m64n64 accumulator holds
//     in mma.sync's C layout, eight n8 tiles a warp;
//   * the first k-step of S and dP writes its accumulator (scale-d 0, an
//     output-only operand), so no zeroing and no register stays live across
//     tiles for it;
//   * a tile's S and dP are one group and its second products another;
//     each is waited for (wait_group 0) before its accumulators are read
//     and before the registers that fed its A may be reused (reg_fence),
//     and the tile buffers are turned over behind a block barrier.  Two
//     blocks an SM overlap each other's groups: splitting a tile's work
//     into more groups, so that its own element-wise work overlapped its
//     wgmma, measured slower on an H100 (more registers live).
// The element-wise work (the masks, P, dS, the keep flags of keep_cell) is
// the mma.sync kernels' per score.
// ---------------------------------------------------------------------------

constexpr int SW_TILE = TILE * 128;   // bytes of a staged 64-row, 128-byte-row tile

// the generic proxy's writes to shared memory (cp.async) made visible to the
// async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are pending
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers the compiler must treat as written here: after wgmma_wait, an
// accumulator is not read earlier, and an A fragment's registers are not
// reused before the group that reads them has completed.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 16-byte chunk j of row r of a 128-byte-row tile, where the swizzle puts it
__device__ __forceinline__ int sw128_chunk(int r, int j) { return j ^ (r & 7); }

// shared-memory matrix descriptor of a tile of 128-byte rows in the 128-byte
// swizzle, 8-row groups 1024 bytes apart: K-major (the leading offset
// unused), or MN-major with one 64-column swizzle span (the leading offset
// unused again, the 1024 bytes the stride between 8-row k groups)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

#define ICEK_WG_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define ICEK_WG_OUT(c)                                                                    \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]),         \
      c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]),       \
      c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]),      \
      c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])

// d (64 x 64 f32 over the warpgroup) = a b (ACC false) or d += a b: a the
// warp's 16 x 16 bf16 A fragment, b (16 x 64) by descriptor, K-major or, with
// TB, MN-major
template <bool ACC, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (ACC) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ICEK_WG_D32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
                 : ICEK_WG_OUT("+f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ICEK_WG_D32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
                 : ICEK_WG_OUT("=f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB), "r"(0));
  }
}

// Stage rows [r0, r0 + TILE) of one head into a swizzled tile at `dst` (a
// 1024-aligned shared address); rows >= limit and words >= hw are zeros.
// With `vec` 16 bytes a copy (8 lanes a row), else 4 (32 lanes a row).
template <int NT>
__device__ __forceinline__ void stage_sw128(uint32_t dst, const bf16* src, long long st, int r0,
                                            int limit, int hw, bool vec) {
  if (vec) {
    constexpr int STEP = NT / 8;
    const int c = threadIdx.x & 7, r = threadIdx.x >> 3;
    const bool lane_ok = 4 * c < hw;
    const int left = limit - r0 - r;
    const bf16* p = src + (long long)(r0 + r) * st + (lane_ok ? 8 * c : 0);
    const long long step = STEP * st;
#pragma unroll
    for (int i = 0; i < TILE; i += STEP) {
      cp_async16(dst + (r + i) * 128 + (sw128_chunk(r + i, c) << 4), p, lane_ok && i < left);
      p += step;
    }
    return;
  }
  constexpr int STEP = NT / 32;
  const int w = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int left = limit - r0 - r;
  const bf16* p = src + (long long)(r0 + r) * st + (w < hw ? 2 * w : 0);
  const long long step = STEP * st;
#pragma unroll 8
  for (int i = 0; i < TILE; i += STEP) {
    cp_async4(dst + (r + i) * 128 + (sw128_chunk(r + i, w >> 2) << 4) + 4 * (w & 3), p,
              w < hw && i < left);
    p += step;
  }
}

// shared memory of the wgmma kernels at HDP 64: four swizzled tiles (two
// buffers of K and V, or Q and dO), for dK/dV the per-row lse and delta, and
// 1024 bytes to align the tiles
constexpr int WG_DQ_BYTES = 4 * SW_TILE + 1024;
constexpr int WG_DKV_BYTES = 4 * SW_TILE + 2 * 2 * TILE * 4 + 1024;
// ... and at HDP 128: every tile two 64-dim halves, and the block's own rows
// (Q and dO, or K and V) staged once besides: 99,328 and 100,352 bytes, two
// blocks an SM
template <int HDP> __host__ __device__ constexpr int wg_dq_bytes() {
  return (HDP > 64 ? 6 : 4) * (HDP / 64) * SW_TILE + 1024;
}
template <int HDP> __host__ __device__ constexpr int wg_dkv_bytes() {
  return (HDP > 64 ? 6 : 4) * (HDP / 64) * SW_TILE + 2 * 2 * TILE * 4 + 1024;
}
static_assert(wg_dq_bytes<64>() == WG_DQ_BYTES && wg_dkv_bytes<64>() == WG_DKV_BYTES,
              "HDP 64 keeps its layout");

// d (64 x 64 f32 over the warpgroup) = a b (ACC false) or d += a b, both
// operands by descriptor, K-major (the SS form): a 64 x 16, b 16 x 64
template <bool ACC>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (ACC) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ICEK_WG_D32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : ICEK_WG_OUT("+f")
                 : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ICEK_WG_D32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : ICEK_WG_OUT("=f")
                 : "l"(a), "l"(b), "r"(0));
  }
}

// d = x y^T over HDP / 16 k-steps, both operands 64-row tiles of HDP / 64
// 64-dim halves by descriptor (x at `xa`, y at `ya`, half h SW_TILE bytes on):
// k-step ks reads 32 bytes at 32 (ks % 4) of half ks / 4
template <int HDP>
__device__ __forceinline__ void wgmma_ss_rows(float (&d)[32], uint32_t xa, uint32_t ya) {
  wgmma_ss<false>(d, sw128_desc(xa), sw128_desc(ya));
#pragma unroll
  for (int ks = 1; ks < HDP / 16; ++ks) {
    const uint32_t at = SW_TILE * (ks >> 2) + 32 * (ks & 3);
    wgmma_ss<true>(d, sw128_desc(xa + at), sw128_desc(ya + at));
  }
}

// dQ (and delta) at HDP 64 and 128: a block owns 64 query rows, warp w rows
// 16 w ..; per 64-key tile S = Q K^T and dP = dO V^T (HDP / 16 k-steps each),
// dS, then dQ += dS K (four k-steps of 16 keys, K's tile read MN-major, one
// m64n64k16 a k-step and 64-dim half).  At HDP 64 Q and dO are A fragments in
// registers (the RS form); at 128 (SS) the block stages its Q and dO rows
// once, swizzled, and S and dP read both operands from shared memory: the
// registers go to the dQ accumulator (64 a lane), S and dP (32 each).
template <int HDP, bool DROP>
__global__ void __launch_bounds__(128) flash_bwd_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ d_o,
    const float* __restrict__ lse, const uint32_t* __restrict__ keep_words,
    float* __restrict__ delta, bf16* __restrict__ dq, const Shape a) {
  constexpr int NT = 128, KS = HDP / 16, NH = HDP / 64;
  constexpr bool SS = HDP > 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto ktile = [&](int buf) { return base + buf * NH * SW_TILE; };
  auto vtile = [&](int buf) { return base + (2 + buf) * NH * SW_TILE; };
  const uint32_t qtile = base + 4 * NH * SW_TILE, gtile = qtile + NH * SW_TILE;   // SS
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int hw = a.Hd >> 1;
  const int row0 = blockIdx.x * TILE + warp * 16;
  const bf16* kp = k + b * a.k_sb + (long long)h * a.Hd;
  const bf16* vp = v + b * a.v_sb + (long long)h * a.Hd;
  const int blk_end = a.causal ? min(a.kv_len, (int)(blockIdx.x + 1) * TILE) : a.kv_len;
  const int ntiles = (blk_end + TILE - 1) / TILE;
  auto stage = [&](int it) {
#pragma unroll
    for (int x = 0; x < NH; ++x) {
      stage_sw128<NT>(ktile(it & 1) + x * SW_TILE, kp + 64 * x, a.k_st, it * TILE, blk_end,
                      hw - 32 * x, a.vec);
      stage_sw128<NT>(vtile(it & 1) + x * SW_TILE, vp + 64 * x, a.v_st, it * TILE, blk_end,
                      hw - 32 * x, a.vec);
    }
  };
  const long long obase = ((long long)b * a.Tq * a.H + h) * a.Hd;
  const long long ost = (long long)a.H * a.Hd;
  const long long srow0 = ((long long)b * a.H + h) * a.Tq;
  const bf16* qp = q + b * a.q_sb + (long long)h * a.Hd;
  if constexpr (SS) {     // the block's Q and dO rows, in the first group
#pragma unroll
    for (int x = 0; x < NH; ++x) {
      stage_sw128<NT>(qtile + x * SW_TILE, qp + 64 * x, a.q_st, blockIdx.x * TILE, a.Tq,
                      hw - 32 * x, a.vec);
      stage_sw128<NT>(gtile + x * SW_TILE, d_o + obase + 64 * x, ost, blockIdx.x * TILE, a.Tq,
                      hw - 32 * x, a.vec);
    }
  }
  stage(0);
  cp_async_commit();

  uint32_t qf[SS ? 1 : KS][4], gf[KS][4];    // dO's fragments: delta, and at HDP 64 dP
  if constexpr (!SS) load_a_frags<KS>(qf, qp, a.q_st, row0, a.Tq, hw, g, t);
  load_a_frags<KS>(gf, d_o + obase, ost, row0, a.Tq, hw, g, t);
  float dl[2] = {0.f, 0.f}, L2[2];
  {
    uint32_t of[KS][4];
    load_a_frags<KS>(of, o + obase, ost, row0, a.Tq, hw, g, t);
#pragma unroll
    for (int s = 0; s < KS; ++s)
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
  float acc[NH][32];
#pragma unroll
  for (int x = 0; x < NH; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  const float c = a.scale * LOG2E;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * TILE;
    if (it + 1 < ntiles) stage(it + 1);
    cp_async_commit();
    const uint32_t word = DROP ? __ldg(keep_words + keep_cell(a, b, h, row0 >> 4, it) + lane)
                               : 0u;
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const uint32_t kt = ktile(it & 1), vt = vtile(it & 1);
    float s[32], dp[32];
    wgmma_fence();
    if constexpr (SS) {
      wgmma_ss_rows<HDP>(s, qtile, kt);
      wgmma_ss_rows<HDP>(dp, gtile, vt);
    } else {
      wgmma_rs<false, 0>(s, qf[0], sw128_desc(kt));
#pragma unroll
      for (int ks = 1; ks < KS; ++ks) wgmma_rs<true, 0>(s, qf[ks], sw128_desc(kt + 32 * ks));
      wgmma_rs<false, 0>(dp, gf[0], sw128_desc(vt));
#pragma unroll
      for (int ks = 1; ks < KS; ++ks) wgmma_rs<true, 0>(dp, gf[ks], sw128_desc(vt + 32 * ks));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    const bool full = k0 + TILE <= a.kv_len && (!a.causal || k0 + TILE <= row0 + 1);
    uint32_t dsf[4][4];   // dS as A fragments: k-step kk holds keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = fast_exp2(fmaf(s[4 * j + i], c, -L2[i >> 1]));
        if (!full) {
          const int key = k0 + 8 * j + 2 * t + (i & 1), row = row0 + g + 8 * (i >> 1);
          const int end = a.causal ? min(a.kv_len, row + 1) : a.kv_len;
          if (key >= end) p = 0.f;
        }
        float d = dp[4 * j + i];
        if (DROP) d = ((word >> (4 * j + i)) & 1u) ? d * a.inv : 0.f;
        ds[i] = p * (d - dl[i >> 1]);
      }
      dsf[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
      dsf[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }
    // k-steps whose 16 keys all lie past the block's end add zeros: skipped
    const int nk = min(4, (blk_end - k0 + 15) / 16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < nk) {
#pragma unroll
        for (int x = 0; x < NH; ++x)
          wgmma_rs<true, 1>(acc[x], dsf[kk], sw128_desc(kt + x * SW_TILE + 2048 * kk));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < NH; ++x) reg_fence(acc[x]);
    reg_fence(dsf);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= a.Tq) continue;
    uint32_t* dp32 = reinterpret_cast<uint32_t*>(dq + obase + (long long)row * ost);
#pragma unroll
    for (int x = 0; x < NH; ++x)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (32 * x + 4 * n + t < hw)
          dp32[32 * x + 4 * n + t] = pack_bf16(acc[x][4 * n + 2 * r] * a.scale,
                                               acc[x][4 * n + 2 * r + 1] * a.scale);
  }
}

// dK and dV at HDP 64 and 128: a block owns 64 keys, warp w keys 16 w ..;
// per 64-query tile S^T = K Q^T and dP^T = V dO^T, P^T and dS^T, then dV +=
// P^T dO and dK += dS^T Q (four k-steps of 16 queries, the dO and Q tiles read
// MN-major, one m64n64k16 a k-step and 64-dim half).  The keep flags are the
// mma.sync dK/dV kernel's, from four 16-row cells a tile.  At HDP 64 K and V
// are A fragments in registers; at 128 the dK and dV accumulators take 128
// registers a lane, so the block stages its K and V rows once, swizzled, and
// S^T and dP^T read both operands from shared memory (SS).
template <int HDP, bool DROP>
__global__ void __launch_bounds__(128) flash_bwd_dkv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint32_t* __restrict__ keep_words,
    bf16* __restrict__ dk, bf16* __restrict__ dv, const Shape a) {
  constexpr int NT = 128, KS = HDP / 16, NH = HDP / 64;
  constexpr bool SS = HDP > 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto qtile = [&](int buf) { return base + buf * NH * SW_TILE; };
  auto gtile = [&](int buf) { return base + (2 + buf) * NH * SW_TILE; };
  float(*ls)[TILE] = reinterpret_cast<float(*)[TILE]>(smem_raw + (base - smem_u32(smem_raw)) +
                                                      4 * NH * SW_TILE);
  float(*dls)[TILE] = ls + 2;
  // SS: the block's K and V rows, after lse and delta (1024 bytes)
  const uint32_t ktile = base + 4 * NH * SW_TILE + 2 * 2 * TILE * 4, vtile = ktile + NH * SW_TILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int hw = a.Hd >> 1;
  const int blk_key0 = blockIdx.x * TILE, key0 = blk_key0 + warp * 16;
  const long long obase = ((long long)b * a.Tq * a.H + h) * a.Hd;   // of d_o
  const long long ost = (long long)a.H * a.Hd;
  const long long srow0 = ((long long)b * a.H + h) * a.Tq;
  const bf16* qp = q + b * a.q_sb + (long long)h * a.Hd;
  const bf16* gp = d_o + obase;
  const int first = a.causal ? blk_key0 / TILE : 0;
  const int last = blk_key0 < a.kv_len ? (a.Tq + TILE - 1) / TILE : first;
  auto stage = [&](int it) {
    const int buf = (it - first) & 1;
#pragma unroll
    for (int x = 0; x < NH; ++x) {
      stage_sw128<NT>(qtile(buf) + x * SW_TILE, qp + 64 * x, a.q_st, it * TILE, a.Tq,
                      hw - 32 * x, a.vec);
      stage_sw128<NT>(gtile(buf) + x * SW_TILE, gp + 64 * x, ost, it * TILE, a.Tq, hw - 32 * x,
                      a.vec);
    }
    for (int i = threadIdx.x; i < TILE; i += NT) {
      const bool ok = it * TILE + i < a.Tq;
      const long long at = srow0 + (ok ? it * TILE + i : 0);
      cp_async4(smem_u32(&ls[buf][i]), lse + at, ok);
      cp_async4(smem_u32(&dls[buf][i]), delta + at, ok);
    }
  };
  const bf16* kbase = k + b * a.k_sb + (long long)h * a.Hd;
  const bf16* vbase = v + b * a.v_sb + (long long)h * a.Hd;
  if constexpr (SS) {     // rows at or beyond kv_len as zeros, in the first group
#pragma unroll
    for (int x = 0; x < NH; ++x) {
      stage_sw128<NT>(ktile + x * SW_TILE, kbase + 64 * x, a.k_st, blk_key0, a.kv_len,
                      hw - 32 * x, a.vec);
      stage_sw128<NT>(vtile + x * SW_TILE, vbase + 64 * x, a.v_st, blk_key0, a.kv_len,
                      hw - 32 * x, a.vec);
    }
  }
  if (first < last) stage(first);
  cp_async_commit();

  uint32_t kf[SS ? 1 : KS][4], vf[SS ? 1 : KS][4];
  if constexpr (!SS) {
    load_a_frags<KS>(kf, kbase, a.k_st, key0, a.kv_len, hw, g, t);
    load_a_frags<KS>(vf, vbase, a.v_st, key0, a.kv_len, hw, g, t);
  }
  float dka[NH][32], dva[NH][32];
#pragma unroll
  for (int x = 0; x < NH; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[x][i] = dva[x][i] = 0.f;
  const float c = a.scale * LOG2E;
  // the forward's keep flags, as in flash_bwd_dkv_mma_kernel: query tile j's
  // register i is in the cell of rows 16 (j / 2) .. of the tile, lane
  // keep_lane + 4 (i % 2), bit keep_bit + 4 (i / 2) + 2 (j % 2)
  const int keep_lane = 8 * t + (g >> 1), keep_bit = 4 * ((key0 & (TILE - 1)) >> 3) + (g & 1);

  for (int it = first; it < last; ++it) {
    if (it + 1 < last) stage(it + 1);
    cp_async_commit();
    uint32_t kw[4][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}, {0u, 0u}};   // [rows 16 rs ..][query parity]
    if (DROP) {
#pragma unroll
      for (int rs = 0; rs < 4; ++rs)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          kw[rs][e] = __ldg(keep_words + keep_cell(a, b, h, 4 * it + rs, blockIdx.x) + keep_lane +
                            4 * e);
    }
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const int buf = (it - first) & 1;
    const int q0 = it * TILE;
    const uint32_t qt = qtile(buf), gt = gtile(buf);
    float st[32], dpt[32];
    wgmma_fence();
    if constexpr (SS) {
      wgmma_ss_rows<HDP>(st, ktile, qt);
      wgmma_ss_rows<HDP>(dpt, vtile, gt);
    } else {
      wgmma_rs<false, 0>(st, kf[0], sw128_desc(qt));
#pragma unroll
      for (int ks = 1; ks < KS; ++ks) wgmma_rs<true, 0>(st, kf[ks], sw128_desc(qt + 32 * ks));
      wgmma_rs<false, 0>(dpt, vf[0], sw128_desc(gt));
#pragma unroll
      for (int ks = 1; ks < KS; ++ks) wgmma_rs<true, 0>(dpt, vf[ks], sw128_desc(gt + 32 * ks));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(st);
    reg_fence(dpt);
    const bool full = q0 + TILE <= a.Tq && key0 + 16 <= a.kv_len && (!a.causal || key0 + 15 <= q0);
    // P^T and dS^T as A fragments: k-step kk holds queries 16 kk .. 16 kk + 15
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = 8 * j + 2 * t;   // in the tile; + (i & 1)
      const float2 L = *reinterpret_cast<const float2*>(&ls[buf][qi]);
      const float2 D = *reinterpret_cast<const float2*>(&dls[buf][qi]);
      float pd[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = fast_exp2(fmaf(st[4 * j + i], c, -LOG2E * ((i & 1) ? L.y : L.x)));
        if (!full) {
          const int query = q0 + qi + (i & 1), key = key0 + g + 8 * (i >> 1);
          if (query >= a.Tq || key >= a.kv_len || (a.causal && key > query)) p = 0.f;
        }
        float d = dpt[4 * j + i];
        pd[i] = p;
        if (DROP) {
          const bool kept = (kw[j >> 1][i & 1] >> (keep_bit + 4 * (i >> 1) + 2 * (j & 1))) & 1u;
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
    // k-steps whose 16 queries all lie past Tq add zeros: skipped
    const int nk = min(4, (a.Tq - q0 + 15) / 16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < nk) {
#pragma unroll
        for (int x = 0; x < NH; ++x)
          wgmma_rs<true, 1>(dva[x], pf[kk], sw128_desc(gt + x * SW_TILE + 2048 * kk));
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < nk) {
#pragma unroll
        for (int x = 0; x < NH; ++x)
          wgmma_rs<true, 1>(dka[x], dsf[kk], sw128_desc(qt + x * SW_TILE + 2048 * kk));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < NH; ++x) {
      reg_fence(dka[x]);
      reg_fence(dva[x]);
    }
    reg_fence(pf);
    reg_fence(dsf);
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
    for (int x = 0; x < NH; ++x)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (32 * x + 4 * n + t < hw) {
          const int e = 4 * n + 2 * r;
          dk32[32 * x + 4 * n + t] = pack_bf16(dka[x][e] * a.scale, dka[x][e + 1] * a.scale);
          dv32[32 * x + 4 * n + t] = pack_bf16(dva[x][e], dva[x][e + 1]);
        }
  }
}

// ---------------------------------------------------------------------------
// The bf16 forward on wgmma at HDP 64 and 128 (flash_fwd_wgmma_kernel), the
// backward pair's pattern with one product fewer.  The mma.sync forward
// above had four warps each read every staged K and V fragment by ldmatrix
// for its own m16 tile, two mma.sync per ldmatrix.x4: at HDP 64 it took
// 2.9x its byte bound at the 512x8 encoder site and lost to SDPA.  Here a
// block is one warpgroup that owns 64 query rows (warp w rows 16 w ..) and
// walks 64-key tiles:
//   * S = Q K^T: HDP / 16 wgmma m64n64k16, Q as A from registers (the warp's
//     fragments straight from global memory, as before), K's tile of the
//     128-byte swizzle K-major by descriptor; at HDP 128 a tile is two
//     64-dim halves, each 64 rows of 128 bytes, k-steps 0-3 in the first;
//   * the online softmax in the log2 domain on the accumulator, which holds
//     mma.sync's m16n8 C layout eight times a warp, so the masks, the keep
//     flags (keep4_rows, keep_cell: the words the backward reads) and the
//     packing of P into A fragments are the mma.sync forward's per score;
//   * O += P V: four k-steps of 16 keys, V's tile read MN-major through the
//     transpose bit (one m64n64k16 a k-step and 64-dim half); k-steps whose
//     keys all lie past the block's end are skipped (their P is 0);
//   * each product group is waited for (wait_group 0) before its
//     accumulators are read and before the registers that fed its A are
//     reused (reg_fence); the next tile is staged by cp.async under this
//     tile's work, double-buffered, and turned over behind a block barrier.
// Two warpgroups a block sharing the staged tiles, and the next tile's S
// issued before this tile's softmax over three buffers, measured slower on
// an H100 (PERF.md).  So did the mma.sync forward at calls of at most 32
// query rows (the 512x8 decoder's self and cross sites), where this
// kernel's 64-row tiles are half empty.
// ---------------------------------------------------------------------------

// shared memory of the wgmma forward: two buffers of K and V, HDP / 64
// swizzled tiles each, and 1024 bytes to align them
template <int HDP> __host__ __device__ constexpr int wg_fwd_bytes() {
  return 4 * (HDP / 64) * SW_TILE + 1024;
}

template <int HDP, bool DROP>
__global__ void __launch_bounds__(128) flash_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, uint32_t* __restrict__ keep_words,
    const Shape a) {
  constexpr int NT = 128, KS = HDP / 16, NH = HDP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto ktile = [&](int buf, int x) { return base + (buf * NH + x) * SW_TILE; };
  auto vtile = [&](int buf, int x) { return base + ((2 + buf) * NH + x) * SW_TILE; };
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int hw = a.Hd >> 1;
  const int row0 = blockIdx.x * TILE + warp * 16;   // this warp's first query row
  const bf16* kp = k + b * a.k_sb + (long long)h * a.Hd;
  const bf16* vp = v + b * a.v_sb + (long long)h * a.Hd;
  // keys the block may see: [0, blk_end)
  const int blk_end = a.causal ? min(a.kv_len, (int)(blockIdx.x + 1) * TILE) : a.kv_len;
  const int ntiles = (blk_end + TILE - 1) / TILE;
  auto stage = [&](int it) {
#pragma unroll
    for (int x = 0; x < NH; ++x) {
      stage_sw128<NT>(ktile(it & 1, x), kp + 64 * x, a.k_st, it * TILE, blk_end, hw - 32 * x,
                      a.vec);
      stage_sw128<NT>(vtile(it & 1, x), vp + 64 * x, a.v_st, it * TILE, blk_end, hw - 32 * x,
                      a.vec);
    }
  };
  stage(0);
  cp_async_commit();

  uint32_t qf[KS][4];
  load_a_frags<KS>(qf, q + b * a.q_sb + (long long)h * a.Hd, a.q_st, row0, a.Tq, hw, g, t);
  float acc[NH][32];
#pragma unroll
  for (int x = 0; x < NH; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  // rows g (index 0) and g + 8 (index 1): running max and this lane's share
  // of the running sum, both of 2^(s * c)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float c = a.scale * LOG2E;
  const unsigned long long mblk =
      DROP ? mask_row_block(a, b, h, row0 + g + ((t & 1) ? 8 : 0)) + (t >> 1) : 0ull;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * TILE, buf = it & 1;
    if (it + 1 < ntiles) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    float s[32];
    wgmma_fence();
    wgmma_rs<false, 0>(s, qf[0], sw128_desc(ktile(buf, 0)));
#pragma unroll
    for (int ks = 1; ks < KS; ++ks)
      wgmma_rs<true, 0>(s, qf[ks], sw128_desc(ktile(buf, ks >> 2) + 32 * (ks & 3)));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    // the tile that straddles kv_len or the diagonal is masked by element
    if (k0 + TILE > a.kv_len || (a.causal && k0 + TILE > row0 + 1)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * j + 2 * t + (i & 1), row = row0 + g + 8 * (i >> 1);
          const int end = a.causal ? min(a.kv_len, row + 1) : a.kv_len;
          if (key >= end) s[4 * j + i] = -INFINITY;
        }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      // finite from the first tile on: key 0 is visible to every row
      const float m_new = fmaxf(m[r], quad_max(mx) * c);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int x = 0; x < NH; ++x)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[x][i] *= alpha[(i >> 1) & 1];
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
        p[i] = fast_exp2(fmaf(s[4 * j + i], c, -m[i >> 1]));   // masked: 2^-inf = 0
        l[i >> 1] += p[i];                                    // the sum takes every key
        if (DROP && !((keep >> i) & 1u)) p[i] = 0.f;
      }
      pf[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
      pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
    }
    if (DROP) keep_words[keep_cell(a, b, h, row0 >> 4, it) + lane] = word;
    // k-steps whose 16 keys all lie past the block's end add zeros: skipped
    const int nk = min(4, (blk_end - k0 + 15) / 16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < nk) {
#pragma unroll
        for (int x = 0; x < NH; ++x)
          wgmma_rs<true, 1>(acc[x], pf[kk], sw128_desc(vtile(buf, x) + 2048 * kk));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < NH; ++x) reg_fence(acc[x]);
    reg_fence(pf);
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
    for (int x = 0; x < NH; ++x)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (32 * x + 4 * n + t < hw)
          op[32 * x + 4 * n + t] =
              pack_bf16(acc[x][4 * n + 2 * r] * inv, acc[x][4 * n + 2 * r + 1] * inv);
    if (t == 0) lse[((long long)b * a.H + h) * a.Tq + row] = (m[r] + log2f(lsum)) * LN2;
  }
}

// ===========================================================================
// The TF32 kernels: f32 (three TF32 products a product, "3xTF32") and bf16
// inputs that miss the 4-byte alignment or have an odd head dim (one TF32
// pass: bf16 values are exact in TF32), any Hd <= 128, padded to HDP.
// ===========================================================================

// the row pitch in floats of an f32 tile: HDP + 4, see the header
template <int HDP> __host__ __device__ constexpr int fpitch_of() { return HDP + 4; }
// Rows of a staged f32 tile, and whether a warp's split A operands live in
// shared memory (SplitRows), by kernel.  The forward walks 32-row tiles
// above HDP 32 and keeps Q's pieces in shared memory; the backward walks
// 64-row tiles up to HDP 64 and keeps its two operands' pieces in registers
// there (the fastest of four layouts timed at 8 heads of 64 on an H100:
// `_variants flash_attention base,bwdtk32,hdp64first,fwdregs`).  At HDP 128
// both take 32-row tiles (two double-buffered tiles of 64
// rows of 132 floats would take 135 KB) and shared memory (16 d-steps of
// pieces would take 128 registers a lane).
template <int HDP, bool BWD>
__host__ __device__ constexpr int ftile_of() { return HDP > (BWD ? 64 : 32) ? 32 : 64; }
template <int HDP, bool BWD>
__host__ __device__ constexpr bool split_smem() { return HDP > (BWD ? 64 : 32); }

// A warp's A operand of 16 rows x HDP (Hd padded with zeros) split into P
// TF32 pieces: HDP / 8 d-steps of FragA<P>, in registers (4 P registers a
// d-step and lane) or, with SMEM, in the warp's own region of shared memory
// (split_smem), lane-major (piece k of d-step s at [s][k][lane], 16 bytes a
// lane: conflict-free 16-byte loads).  Each lane writes and reads only its
// own fragments, so no barrier guards them.
template <int P, int HDP, bool SMEM_>
struct SplitRows {
  static constexpr int DS = HDP / 8;
  static constexpr bool SMEM = SMEM_;
  FragA<P> r[SMEM ? 1 : DS];
  uint4* s;   // this warp's region: DS * P * 32 uint4 (SMEM only)
  int lane;

  __device__ __forceinline__ FragA<P> operator()(int ds) const {
    if constexpr (SMEM) {
      FragA<P> f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const uint4 w = s[(ds * P + k) * 32 + lane];
        f.p[k][0] = w.x;
        f.p[k][1] = w.y;
        f.p[k][2] = w.z;
        f.p[k][3] = w.w;
      }
      return f;
    } else {
      return r[ds];
    }
  }

  __device__ __forceinline__ void set(int ds, const FragA<P>& f) {
    if constexpr (SMEM) {
#pragma unroll
      for (int k = 0; k < P; ++k)
        s[(ds * P + k) * 32 + lane] = make_uint4(f.p[k][0], f.p[k][1], f.p[k][2], f.p[k][3]);
    } else {
      r[ds] = f;
    }
  }
};

// bytes of one warp's SplitRows region (0 where it lives in registers)
template <int P, int HDP, bool SMEM>
__host__ __device__ constexpr int split_rows_bytes() { return SMEM ? (HDP / 8) * P * 32 * 16 : 0; }

// x as P TF32 pieces: split_tf32<P> (cvt.rna), or with BITS (P = 2) by
// integer rounding, split_tf32_bits (hi rounded to nearest, lo left for the
// tensor cores to truncate): three instructions where the cvt.rna pair
// expands into compare-and-select code.  Every operand of a product (A rows
// and B columns alike) is split one way, so S = Q K^T and S^T = K Q^T stay
// alike to the bit.  The HDP-64 and HDP-128 kernels take BITS (tf32_bits),
// HDP 32 keeps cvt.rna, and with it its bits.
template <int P, bool BITS>
__device__ __forceinline__ void split_as(float x, uint32_t (&p)[P]) {
  if constexpr (BITS && P == 2) {
    split_tf32_bits(x, p);
  } else {
    split_tf32<P>(x, p);
  }
}

// whether the TF32 kernels of padded head dim HDP split by integer rounding
template <int HDP> __host__ __device__ constexpr bool tf32_bits() { return HDP >= 64; }

// One 16-row x 8-column step's S = A B^T over HDP: A the warp's split rows
// (SplitRows), B their row g of a staged tile (element 8 ds + t and + 4 of
// d-step ds).  The hi hi, lo hi and hi lo terms are summed in three chains
// over the d-steps and added at the end, hi hi + (lo hi + hi lo): symmetric
// in its operands, so the forward's and the dQ kernel's S = Q K^T and the
// dK/dV kernel's S^T = K Q^T (and dP, dP^T) come out bit for bit alike (an
// mma's sum of its eight products does not depend on which operand is A),
// at every head dim.
template <int P, bool BITS = false, typename Rows>
__device__ __forceinline__ void first_product(float (&s)[4], const Rows& a, const float* bp) {
  static_assert(P == 1 || P == 2, "one piece (bf16) or two (f32)");
  float c[3][4];               // [hi hi, lo hi, hi lo]
#pragma unroll
  for (int w = 0; w < 3; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[w][i] = 0.f;
#pragma unroll
  for (int ds = 0; ds < Rows::DS; ++ds) {
    const FragA<P> f = a(ds);
    uint32_t x[P], y[P];
    split_as<P, BITS>(bp[8 * ds], x);
    split_as<P, BITS>(bp[8 * ds + 4], y);
    mma_tf32(c[0], f.p[0], x[0], y[0]);
    if constexpr (P == 2) {
      mma_tf32(c[1], f.p[1], x[0], y[0]);
      mma_tf32(c[2], f.p[0], x[1], y[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = c[0][i] + (c[1][i] + c[2][i]);
}

// The backward's two first products of a step, S = A1 B1^T and dP = A2 B2^T
template <int P, bool BITS = false, typename Rows>
__device__ __forceinline__ void first_products(float (&s)[4], float (&dp)[4],
                                               const Rows& a1, const Rows& a2,
                                               const float* b1, const float* b2) {
  first_product<P, BITS>(s, a1, b1);
  first_product<P, BITS>(dp, a2, b2);
}

// The warps of a TF32 backward block that share a 16-row group (its split A
// operands, SplitRows), each taking an equal share of every tile's 8-key
// (query) steps: two at HDP 128, where the split operands live in shared
// memory and a block of four groups takes 196 KB of it, so that an SM runs
// eight warps and not four; one elsewhere.
template <int HDP>
__host__ __device__ constexpr int group_warps() { return HDP > 64 ? 2 : 1; }

// The 8-key (query) steps whose first products a TF32 backward kernel forms
// at once (first_products_steps): one where the split A operands live in
// registers (HDP 32 and 64); at HDP 128 a warp's whole share of a 32-row
// tile, two steps (a warp alone in its group formed four in dQ: PERF.md).
template <int HDP>
__host__ __device__ constexpr int steps_at_once() { return HDP > 64 ? 2 : 1; }

// The dQ kernel's pass-0 row statistics of the WG warps that share a 16-row
// group, each over its share of the keys (max m of x, l = sum 2^(x - m), w =
// sum 2^(x - m) dP'), folded into the group's in warp order, so that every
// warp of the group holds the same bits: each warp's lanes t = 0 leave theirs
// in `buf` (free shared memory: the staged tiles between the passes), then
// every warp reads its group's.  Barriers after the writes and after the
// reads (the next pass stages into `buf`).
template <int WG>
__device__ __forceinline__ void fold_group_rows(float (&m)[2], float (&l)[2], float (&w)[2],
                                                float* buf, int warp, int grp, int g, int t) {
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* e = buf + (warp * 16 + g + 8 * r) * 3;
      e[0] = m[r];
      e[1] = l[r];
      e[2] = w[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float M = -INFINITY, L = 0.f, W = 0.f;
#pragma unroll
    for (int p = 0; p < WG; ++p) {
      const float* e = buf + ((grp * WG + p) * 16 + g + 8 * r) * 3;
      if (e[0] == -INFINITY) continue;
      const float mn = fmaxf(M, e[0]);
      const float fo = M == -INFINITY ? 0.f : fast_exp2(M - mn), fp = fast_exp2(e[0] - mn);
      L = fmaf(L, fo, e[1] * fp);
      W = fmaf(W, fo, e[2] * fp);
      M = mn;
    }
    m[r] = M;
    l[r] = L;
    w[r] = W;
  }
  __syncthreads();
}

// An accumulator (DS x 4 floats a lane) of the WG warps that share a 16-row
// group, each summed over its share of the steps, added into the first warp's
// in warp order through `buf` (free shared memory, NW (WG - 1) DS 4 32 floats,
// lane-major); only the first warp of a group then holds the sums.  A barrier
// after the writes; the caller's next use of `buf` needs one more.
template <int WG, int DS>
__device__ __forceinline__ void add_group_sums(float (&acc)[DS][4], float* buf, int grp,
                                               int part, int lane) {
  constexpr int PER = DS * 4 * 32;   // floats a warp leaves
  if (part != 0) {
    float* own = buf + (grp * (WG - 1) + part - 1) * PER;
#pragma unroll
    for (int n = 0; n < DS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) own[(n * 4 + i) * 32 + lane] = acc[n][i];
  }
  __syncthreads();
  if (part == 0) {
#pragma unroll
    for (int p = 1; p < WG; ++p) {
      const float* other = buf + (grp * (WG - 1) + p - 1) * PER;
#pragma unroll
      for (int n = 0; n < DS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] += other[(n * 4 + i) * 32 + lane];
    }
  }
}

// The first products of up to JB consecutive 8-key (query) steps at once:
// S = A1 B1^T and dP = A2 B2^T of step j read B's rows from b1 + 8 j pitch
// (b2 alike; b1, b2 point at step 0's row g, element t); steps from `n` on
// are not formed.  Each split A fragment is read once a d-step for all the
// steps, where first_products reads it once a step: at HDP 128 that is a
// reload from the warp's shared-memory region (SplitRows), four 16-byte
// loads a d-step and step, the reads that held the HDP-128 backward at 2.3x
// the HDP-64 one's time for the same work.  Each step's three chains run
// over the d-steps in first_product's order, so its S and dP are
// first_product's to the bit.
template <int P, bool BITS, int JB, typename Rows>
__device__ __forceinline__ void first_products_steps(float (&s)[JB][4], float (&dp)[JB][4],
                                                     const Rows& a1, const Rows& a2,
                                                     const float* b1, const float* b2,
                                                     int pitch, int n) {
  float c1[JB][3][4], c2[JB][3][4];   // [step][hi hi, lo hi, hi lo]
#pragma unroll
  for (int j = 0; j < JB; ++j)
#pragma unroll
    for (int w = 0; w < 3; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i) c1[j][w][i] = c2[j][w][i] = 0.f;
#pragma unroll
  for (int ds = 0; ds < Rows::DS; ++ds) {
    const FragA<P> f1 = a1(ds), f2 = a2(ds);
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      if (j >= n) break;
      const float* p1 = b1 + 8 * j * pitch + 8 * ds;
      const float* p2 = b2 + 8 * j * pitch + 8 * ds;
      uint32_t x1[P], y1[P], x2[P], y2[P];
      split_as<P, BITS>(p1[0], x1);
      split_as<P, BITS>(p1[4], y1);
      split_as<P, BITS>(p2[0], x2);
      split_as<P, BITS>(p2[4], y2);
      mma_tf32(c1[j][0], f1.p[0], x1[0], y1[0]);
      mma_tf32(c2[j][0], f2.p[0], x2[0], y2[0]);
      if constexpr (P == 2) {
        mma_tf32(c1[j][1], f1.p[1], x1[0], y1[0]);
        mma_tf32(c1[j][2], f1.p[0], x1[1], y1[1]);
        mma_tf32(c2[j][1], f2.p[1], x2[0], y2[0]);
        mma_tf32(c2[j][2], f2.p[0], x2[1], y2[1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < JB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = c1[j][0][i] + (c1[j][1][i] + c1[j][2][i]);
      dp[j][i] = c2[j][0][i] + (c2[j][1][i] + c2[j][2][i]);
    }
}

// The d-steps of an m16n8k8 A operand of rows [r0, r0 + 16) of one head
// (padded with zeros to HDP), straight from global memory as f32 and split
// into `rows`: with g = lane / 4, t = lane % 4, register i of step s is (row
// g + 8 (i % 2), d 8 s + t + 4 (i / 2)).
template <int P, bool BITS = false, typename T, typename Rows>
__device__ __forceinline__ void load_split_rows(Rows& rows, const T* src, long long st, int r0,
                                                int limit, int Hd, int g, int t) {
#pragma unroll
  for (int s = 0; s < Rows::DS; ++s) {
    FragA<P> f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i & 1), d = 8 * s + t + 4 * (i >> 1);
      const float x = row < limit && d < Hd ? to_f32(src[(long long)row * st + d]) : 0.f;
      uint32_t pc[P];
      split_as<P, BITS>(x, pc);
#pragma unroll
      for (int k = 0; k < P; ++k) f.p[k][i] = pc[k];
    }
    rows.set(s, f);
  }
}

// An m16n8 accumulator tile as the A operand of the next product, without a
// shuffle: accumulator registers 0..3 hold (row g, column 2 t), (g, 2 t + 1),
// (g + 8, 2 t), (g + 8, 2 t + 1); as A they take k index t for column 2 t and
// t + 4 for column 2 t + 1, so the B operand of that product reads its rows
// in the same order (row 2 t as k index t, 2 t + 1 as t + 4)
template <int P, bool BITS = false>
__device__ __forceinline__ void acc_as_a(FragA<P>& a, const float (&c)[4]) {
  const float order[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t x[P];
    split_as<P, BITS>(order[i], x);
#pragma unroll
    for (int k = 0; k < P; ++k) a.p[k][i] = x[k];
  }
}

// c += a b as mma_add forms it, with the B fragment (b0, b1) split by
// split_tf32_bits (hi by integer rounding, lo left for the tensor cores to
// truncate): three instructions an element, where split_tf32<2>'s cvt.rna
// pair expands into compare-and-select code (the forward's P V took 0.885
// against 1.019 ms that way at the geo encoder site on an H100).  The
// forward's S keeps split_tf32: its scores are the backward's to the bit.
template <int P>
__device__ __forceinline__ void mma_add_bits(float (&c)[4], const FragA<P>& a, float b0,
                                             float b1) {
  if constexpr (P == 1) {
    mma_add<1>(c, a, b0, b1);
  } else {
    uint32_t x[2], y[2];
    split_tf32_bits(b0, x);
    split_tf32_bits(b1, y);
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(t, a.p[0], x[1], y[1]);
    mma_tf32(t, a.p[1], x[0], y[0]);
    mma_tf32(t, a.p[0], x[0], y[0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += t[i];
  }
}

// a second product (O, dQ, dK, dV), its B split as split_as splits
template <int P, bool BITS>
__device__ __forceinline__ void mma_add_as(float (&c)[4], const FragA<P>& a, float b0,
                                           float b1) {
  if constexpr (BITS) {
    mma_add_bits<P>(c, a, b0, b1);
  } else {
    mma_add<P>(c, a, b0, b1);
  }
}

// Stage rows [r0, r0 + TK) of one head into a shared f32 tile of head dim
// HDP; rows >= limit and elements >= Hd are zeros.  f32 with `vec` above HDP
// 32 (Hd % 4 == 0 and every address and stride 16-byte aligned: a Hd-64 view
// of a fused projection) by 16-byte cp.async, min(HDP / 4, 32) lanes a row; f32
// otherwise by 4-byte cp.async (a Hd-30 head row of a fused-QKV view is
// 8-byte aligned at best), 32 lanes a row; bf16 by loads and stores.
template <typename T, int NT, int HDP, int TK>
__device__ __forceinline__ void stage_rows_f32(float (*dst)[fpitch_of<HDP>()], const T* src,
                                               long long st, int r0, int limit, int Hd,
                                               bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (HDP > 32 && vec) {   // as in stage_rows
      constexpr int CH = HDP / 4, LPR = CH < 32 ? CH : 32, CPL = CH / LPR, STEP = NT / LPR;
      const int c = threadIdx.x % LPR, r = threadIdx.x / LPR;
      const int left = limit - r0 - r;
      const T* p = src + (long long)(r0 + r) * st;
      const long long step = STEP * st;
#pragma unroll 4
      for (int i = 0; i < TK; i += STEP) {
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          const int d = 4 * (c + e * LPR);
          cp_async16(smem_u32(&dst[r + i][d]), p + d, d < Hd && i < left);
        }
        p += step;
      }
      return;
    }
  }
  constexpr int STEP = NT / 32, EPL = HDP / 32;
  const int w = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int left = limit - r0 - r;
  // element w + 32 e of a row: an immediate offset from p
  const T* p = src + (long long)(r0 + r) * st + (w < Hd ? w : 0);
  const long long step = STEP * st;
#pragma unroll 4
  for (int i = 0; i < TK; i += STEP) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const bool ok = w + 32 * e < Hd && i < left;
      if constexpr (std::is_same<T, float>::value) {
        cp_async4(smem_u32(&dst[r + i][w + 32 * e]), p + 32 * e, ok);
      } else {
        float x = 0.f;
        if (ok) x = to_f32(p[32 * e]);
        dst[r + i][w + 32 * e] = x;
      }
    }
    p += step;
  }
}

// Keep flags (bit i for accumulator register i) of one 16-key x 8-query tile
// of the transposed scores: register i of lane (g, t) is (query 2 t + i % 2,
// key g + 8 (i / 2)).  The four keys of a Philox block sit in the lanes g = 4
// u .. 4 u + 3 of one t; lane c = g % 4 draws the block of query 2 t + c % 2
// and keys + 8 (c / 2) (`query`, `kblk`: the block of key 0 of the warp's
// keys plus u plus 2 (c / 2)), and in round x sends word c ^ x of it to lane
// c ^ x, which keeps it as register c ^ x: one Philox block per four scores.
__device__ __forceinline__ uint32_t keep4_cols(const Shape& a, int b, int h, int query,
                                               unsigned long long kblk, int c) {
  const uint4 r = philox4x32_10(a.seed, STREAM_FLASH, mask_row_block(a, b, h, query) + kblk);
  uint32_t keep = 0u;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    uint32_t w = word_of(r, c ^ x);
    if (x) w = __shfl_xor_sync(FULL, w, x << 2);
    keep |= (keep_bits(w, a.thresh) ? 1u : 0u) << (c ^ x);
  }
  return keep;
}

// shared memory of a TF32 kernel (the forward, or with BWD a backward one):
// two double-buffered f32 tiles, (dK/dV) the per-row lse2 and delta, and
// NOPS SplitRows regions a warp
template <int P, int HDP, int NW, int NOPS, bool ROWS, bool BWD>
__host__ __device__ constexpr int tf32_bytes() {
  constexpr int TK = ftile_of<HDP, BWD>();
  return 2 * 2 * TK * fpitch_of<HDP>() * 4 + (ROWS ? 2 * 2 * TK * 4 : 0) +
         NW * NOPS * split_rows_bytes<P, HDP, split_smem<HDP, BWD>()>();
}

// Forward in TF32: the dQ kernel's passes 0 and 1 folded into one online
// pass.  A block of NW warps owns NW * 16 query rows of one (batch, head); a
// warp keeps its rows' Q as split A fragments (SplitRows), its output
// accumulator and its softmax state in registers and walks the staged key
// tiles (whole tiles beyond kv_len or above the causal diagonal skipped, the
// straddling tile masked by element).  A tile's scores come 8 keys at a time
// from first_product and are scaled as the dQ kernel scales them, x = S
// scale log2 e rounded once (__fmul_rn): the forward's x is the backward's to
// the bit.  The online softmax takes a tile at once, in the log2 domain over
// the quad; P = 2^(x - max), rounded to the working dtype, is the A operand
// of O += P V (acc_as_a), V's rows read in its order and split by integer
// rounding, each step's product added by f32 adds (mma_add_bits).  Dropout
// draws keep_mask_kernel's mask (keep4_rows),
// which the TF32 backward draws again.  The body of the kernels below.
template <typename T, int HDP, int NW, bool DROP>
__device__ __forceinline__ void flash_fwd_tf32_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, const Shape& a) {
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;   // bf16 is exact in one piece
  constexpr int BQ = NW * 16, NT = NW * 32, FP = fpitch_of<HDP>(), TK = ftile_of<HDP, false>();
  constexpr int DS = HDP / 8;
  constexpr bool SS = split_smem<HDP, false>(), BITS = tf32_bits<HDP>();
  extern __shared__ __align__(16) unsigned char smem[];
  float(*ks)[TK][FP] = reinterpret_cast<float(*)[TK][FP]>(smem);
  float(*vs)[TK][FP] = ks + 2;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BQ + warp * 16;
  const T* kp = k + b * a.k_sb + (long long)h * a.Hd;
  const T* vp = v + b * a.v_sb + (long long)h * a.Hd;
  const int blk_end = a.causal ? min(a.kv_len, (int)(blockIdx.x + 1) * BQ) : a.kv_len;
  const int warp_end = a.causal ? min(a.kv_len, row0 + 16) : a.kv_len;
  const int ntiles = (blk_end + TK - 1) / TK;
  auto stage = [&](int it) {
    stage_rows_f32<T, NT, HDP, TK>(ks[it & 1], kp, a.k_st, it * TK, blk_end, a.Hd, a.vec);
    stage_rows_f32<T, NT, HDP, TK>(vs[it & 1], vp, a.v_st, it * TK, blk_end, a.Hd, a.vec);
  };
  stage(0);
  cp_async_commit();

  SplitRows<P, HDP, SS> qa;
  qa.lane = lane;
  qa.s = reinterpret_cast<uint4*>(smem + 2 * 2 * TK * FP * 4 + warp * split_rows_bytes<P, HDP, SS>());
  load_split_rows<P, BITS>(qa, q + b * a.q_sb + (long long)h * a.Hd, a.q_st, row0, a.Tq, a.Hd,
                           g, t);
  float acc[DS][4];
#pragma unroll
  for (int n = 0; n < DS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // rows g (index 0) and g + 8 (index 1): running max of x and this lane's
  // share of the running sum of 2^(x - max)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float c = a.scale * LOG2E;
  // this lane's Philox block for keys 0..3 of its 8-key column (keep4_rows)
  const unsigned long long mblk =
      DROP ? mask_row_block(a, b, h, row0 + g + ((t & 1) ? 8 : 0)) + (t >> 1) : 0ull;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * TK;
    if (it + 1 < ntiles) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (k0 < warp_end) {
      const float(*kt)[FP] = ks[it & 1];
      const float(*vt)[FP] = vs[it & 1];
      float x[TK / 8][4];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        first_product<P, BITS>(x[j], qa, &kt[8 * j + g][t]);
#pragma unroll
        for (int i = 0; i < 4; ++i) x[j][i] = __fmul_rn(x[j][i], c);   // as the dQ kernel's
      }
      // the tile that straddles kv_len or the diagonal is masked by element
      if (k0 + TK > a.kv_len || (a.causal && k0 + TK > row0 + 1)) {
#pragma unroll
        for (int j = 0; j < TK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 8 * j + 2 * t + (i & 1), row = row0 + g + 8 * (i >> 1);
            const int end = a.causal ? min(a.kv_len, row + 1) : a.kv_len;
            if (key >= end) x[j][i] = -INFINITY;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < TK / 8; ++j) mx = fmaxf(mx, fmaxf(x[j][2 * r], x[j][2 * r + 1]));
        // finite from the first tile on: key k0 is visible to every row of the warp
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float alpha = fast_exp2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < DS; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        const uint32_t keep = DROP ? keep4_rows(a, mblk + ((k0 + 8 * j) >> 2), t) : 0xfu;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = fast_exp2(x[j][i] - m[i >> 1]);   // masked: 2^-inf = 0
          l[i >> 1] += p[i];                       // the sum takes every key
          if (DROP && !((keep >> i) & 1u)) p[i] = 0.f;
          p[i] = round_to<T>(p[i]);
        }
        FragA<P> pa;
        acc_as_a<P, BITS>(pa, p);
        // O += P V: keys 2 t and 2 t + 1 of the step as k indices t and t + 4
#pragma unroll
        for (int n = 0; n < DS; ++n) {
          const float* vr = &vt[8 * j + 2 * t][8 * n + g];
          mma_add_bits<P>(acc[n], pa, vr[0], vr[FP]);
        }
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
    T* out = o + (((long long)b * a.Tq + row) * a.H + h) * a.Hd;
#pragma unroll
    for (int n = 0; n < DS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < a.Hd) out[d] = from_f32<T>(acc[n][2 * r + e] * inv);
      }
    if (t == 0) lse[((long long)b * a.H + h) * a.Tq + row] = (m[r] + log2f(lsum)) * LN2;
  }
}

// The TF32 forward's kernels.  At HDP 32 it is held to 128 registers, four
// blocks of four warps an SM: left free, ptxas took 153 without dropout
// (three blocks), and that forward ran 5.5% slower on an H100
// (`_variants flash_attention base,nolb 0,0.2 10x30 f32`).  Above HDP 32
// ptxas chooses: a bound of one block moved the HDP-64 forward 4.5% either
// way (slower at rate 0, faster at 0.2).
template <typename T, int HDP, int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32) flash_fwd_tf32_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, const Shape a) {
  flash_fwd_tf32_body<T, HDP, NW, DROP>(q, k, v, o, lse, a);
}

template <typename T, int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32, 16 / NW) flash_fwd_tf32_hd32_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, const Shape a) {
  flash_fwd_tf32_body<T, 32, NW, DROP>(q, k, v, o, lse, a);
}

template <typename T, int HDP, int NW, bool DROP>
auto fwd_tf32_kernel() {
  if constexpr (HDP == 32) {
    return &flash_fwd_tf32_hd32_kernel<T, NW, DROP>;
  } else {
    return &flash_fwd_tf32_kernel<T, HDP, NW, DROP>;
  }
}

// dQ in TF32, and each row's delta and log2-domain logsumexp of the kernel's
// own scores.  The tensor-core dQ kernel's shape: a warp owns 16 query rows (Q
// and dO as split A fragments, SplitRows) and walks the staged key tiles 8
// keys at a time, S and dP in the accumulators (first_products).  It walks
// them twice: pass 0 takes each row's online (max, sum 2^x) of x = S scale
// log2 e and the sum of 2^x dP' (dP' = dP with the dropout applied), so that
// delta = rowsum(P dP') and lse2 = log2 sum 2^x come from the same P and dP'
// the gradient uses (see the header); pass 1 forms P = 2^(x - lse2) and dS =
// P (dP' - delta), and dS as the A operand of dQ += dS K with K's rows read in
// acc_as_a's order.  delta and lse2 go to `rows` (2 x B H Tq) for dK/dV.  At
// HDP 128 two warps share each 16-row group, each taking half of every
// tile's steps (group_warps), and a warp forms its two steps' S and dP at
// once (first_products_steps); the pair folds its row statistics after pass 0
// and its dQ sums at the end, in warp order.
template <typename T, int HDP, int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32 * group_warps<HDP>()) flash_bwd_dq_tf32_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ d_o, float* __restrict__ rows, T* __restrict__ dq, const Shape a) {
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;   // bf16 is exact in one piece
  constexpr int WG = group_warps<HDP>(), BQ = NW * 16, NT = NW * WG * 32;
  constexpr int FP = fpitch_of<HDP>(), TK = ftile_of<HDP, true>();
  constexpr int DS = HDP / 8, SPW = TK / 8 / WG, JB = steps_at_once<HDP>();
  constexpr bool SS = split_smem<HDP, true>(), BITS = tf32_bits<HDP>();
  static_assert(SPW % JB == 0, "a warp's steps of a tile in whole blocks of JB");
  static_assert(NW * WG * 16 * 3 * 4 <= 2 * 2 * TK * FP * 4 &&
                    NW * (WG - 1) * DS * 4 * 32 * 4 <= 2 * 2 * TK * FP * 4,
                "the group's row statistics and dQ sums fit the staged tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  float(*ks)[TK][FP] = reinterpret_cast<float(*)[TK][FP]>(smem);
  float(*vs)[TK][FP] = ks + 2;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp / WG, part = warp % WG;   // the 16-row group, this warp's share
  const int row0 = blockIdx.x * BQ + grp * 16;
  const T* kp = k + b * a.k_sb + (long long)h * a.Hd;
  const T* vp = v + b * a.v_sb + (long long)h * a.Hd;
  const int blk_end = a.causal ? min(a.kv_len, (int)(blockIdx.x + 1) * BQ) : a.kv_len;
  const int warp_end = a.causal ? min(a.kv_len, row0 + 16) : a.kv_len;
  const int ntiles = (blk_end + TK - 1) / TK;
  auto stage = [&](int it) {
    stage_rows_f32<T, NT, HDP, TK>(ks[it & 1], kp, a.k_st, it * TK, blk_end, a.Hd, a.vec);
    stage_rows_f32<T, NT, HDP, TK>(vs[it & 1], vp, a.v_st, it * TK, blk_end, a.Hd, a.vec);
  };

  // dO, dq: contiguous (B, Tq, H, Hd)
  const long long obase = ((long long)b * a.Tq * a.H + h) * a.Hd;
  const long long ost = (long long)a.H * a.Hd;
  const long long srow0 = ((long long)b * a.H + h) * a.Tq;
  SplitRows<P, HDP, SS> qa, ga;
  qa.lane = ga.lane = lane;
  // the group's region: its warps write the same pieces, each lane reading
  // back what it wrote
  unsigned char* own = smem + 2 * 2 * TK * FP * 4 + 2 * grp * split_rows_bytes<P, HDP, SS>();
  qa.s = reinterpret_cast<uint4*>(own);
  ga.s = reinterpret_cast<uint4*>(own + split_rows_bytes<P, HDP, SS>());
  load_split_rows<P, BITS>(qa, q + b * a.q_sb + (long long)h * a.Hd, a.q_st, row0, a.Tq, a.Hd,
                           g, t);
  load_split_rows<P, BITS>(ga, d_o + obase, ost, row0, a.Tq, a.Hd, g, t);
  float acc[DS][4];
#pragma unroll
  for (int n = 0; n < DS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const float c = a.scale * LOG2E;
  // this lane's Philox block for keys 0..3 of its 8-key column (keep4_rows)
  const unsigned long long mblk =
      DROP ? mask_row_block(a, b, h, row0 + g + ((t & 1) ? 8 : 0)) + (t >> 1) : 0ull;
  // rows g and g + 8: this lane's online max, sum 2^(x - max) and sum
  // 2^(x - max) dP' (pass 0), then the quad's delta and lse2 (pass 1)
  float mx[2] = {-INFINITY, -INFINITY}, sl[2] = {0.f, 0.f}, sw[2] = {0.f, 0.f};
  float dl[2] = {0.f, 0.f}, l2[2] = {0.f, 0.f};

  for (int pass = 0; pass < 2; ++pass) {
    stage(0);
    cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles) stage(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float(*kt)[FP] = ks[it & 1];
      const float(*vt)[FP] = vs[it & 1];
      float xb[JB][4], db[JB][4];   // JB > 1: the steps' S and dP, formed at once
#pragma unroll (HDP > 64 ? 4 : 2)
      for (int jj = 0; jj < SPW; ++jj) {
        const int j = part * SPW + jj;      // this warp's share of the tile's steps
        const int kb = it * TK + 8 * j;     // first key of this step
        if (kb >= warp_end) break;
        float x[4], d[4];
        if constexpr (JB > 1) {
          if (jj % JB == 0)
            first_products_steps<P, BITS, JB>(xb, db, qa, ga, &kt[8 * j + g][t],
                                              &vt[8 * j + g][t], FP, (warp_end - kb + 7) >> 3);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[i] = xb[jj % JB][i];
            d[i] = db[jj % JB][i];
          }
        } else {
          first_products<P, BITS>(x, d, qa, ga, &kt[8 * j + g][t], &vt[8 * j + g][t]);
        }
        const bool full = kb + 8 <= a.kv_len && (!a.causal || kb + 8 <= row0 + 1);
        const uint32_t keep = DROP ? keep4_rows(a, mblk + (kb >> 2), t) : 0xfu;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = __fmul_rn(x[i], c);            // the same rounding in both passes and dK/dV
          if (!full) {
            const int key = kb + 2 * t + (i & 1), row = row0 + g + 8 * (i >> 1);
            const int end = a.causal ? min(a.kv_len, row + 1) : a.kv_len;
            if (key >= end) x[i] = -INFINITY;
          }
          if (DROP) d[i] = ((keep >> i) & 1u) ? d[i] * a.inv : 0.f;
        }
        if (pass == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(mx[r], fmaxf(x[2 * r], x[2 * r + 1]));
            if (m_new == -INFINITY) continue;
            const float f = fast_exp2(mx[r] - m_new);
            const float e0 = fast_exp2(x[2 * r] - m_new), e1 = fast_exp2(x[2 * r + 1] - m_new);
            sl[r] = fmaf(sl[r], f, e0 + e1);
            sw[r] = fmaf(sw[r], f, fmaf(e0, d[2 * r], e1 * d[2 * r + 1]));
            mx[r] = m_new;
          }
          continue;
        }
        float ds_[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds_[i] = round_to<T>(fast_exp2(x[i] - l2[i >> 1]) * (d[i] - dl[i >> 1]));
        FragA<P> dsa;
        acc_as_a<P, BITS>(dsa, ds_);
        // dQ += dS K: keys 2 t and 2 t + 1 of the step as k indices t and t + 4
#pragma unroll
        for (int n = 0; n < DS; ++n) {
          const float* kr = &kt[8 * j + 2 * t][8 * n + g];
          mma_add_as<P, BITS>(acc[n], dsa, kr[0], kr[FP]);
        }
      }
      __syncthreads();
    }
    if (pass == 0) {
      float m[2], l[2], w[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = quad_max(mx[r]);
        const float f = mx[r] == -INFINITY ? 0.f : fast_exp2(mx[r] - m[r]);
        l[r] = quad_sum(sl[r] * f);
        w[r] = quad_sum(sw[r] * f);
      }
      if constexpr (WG > 1) fold_group_rows<WG>(m, l, w, reinterpret_cast<float*>(smem), warp,
                                                grp, g, t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        dl[r] = l[r] > 0.f ? w[r] / l[r] : 0.f;
        l2[r] = l[r] > 0.f ? m[r] + log2f(l[r]) : 0.f;
        if (part == 0 && t == 0 && row < a.Tq) {
          rows[srow0 + row] = dl[r];
          rows[(long long)gridDim.z * a.H * a.Tq + srow0 + row] = l2[r];
        }
      }
    }
  }
  if constexpr (WG > 1) add_group_sums<WG, DS>(acc, reinterpret_cast<float*>(smem), grp, part, lane);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (part != 0 || row >= a.Tq) continue;
    T* out = dq + obase + (long long)row * ost;
#pragma unroll
    for (int n = 0; n < DS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < a.Hd) out[d] = from_f32<T>(acc[n][2 * r + e] * a.scale);
      }
  }
}

// dK and dV in TF32.  The tensor-core dK/dV kernel's shape: a warp owns 16
// keys (K and V as split A fragments, SplitRows) and walks the staged query
// tiles 8 queries at a time: S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T
// as A operands of dV += P^T dO and dK += dS^T Q.  Keys at or beyond kv_len
// and causally hidden pairs add exactly zero.  At HDP 128 two warps share each
// 16-key group, each taking half of every tile's query steps (group_warps)
// and forming its two steps' S^T and dP^T at once, and add their dK and dV
// sums at the end in warp order.
template <typename T, int HDP, int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32 * group_warps<HDP>()) flash_bwd_dkv_tf32_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ d_o, const float* __restrict__ rows, T* __restrict__ dk,
    T* __restrict__ dv, const Shape a) {
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;   // bf16 is exact in one piece
  constexpr int WG = group_warps<HDP>(), BKT = NW * 16, NT = NW * WG * 32;
  constexpr int FP = fpitch_of<HDP>(), TK = ftile_of<HDP, true>();
  constexpr int DS = HDP / 8, SPW = TK / 8 / WG, JB = steps_at_once<HDP>();
  constexpr bool SS = split_smem<HDP, true>(), BITS = tf32_bits<HDP>();
  static_assert(SPW % JB == 0, "a warp's steps of a tile in whole blocks of JB");
  static_assert(2 * NW * (WG - 1) * DS * 4 * 32 * 4 <= 2 * 2 * TK * FP * 4,
                "the group's dK and dV sums fit the staged tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  float(*qs)[TK][FP] = reinterpret_cast<float(*)[TK][FP]>(smem);
  float(*gs)[TK][FP] = qs + 2;
  float(*ls)[TK] = reinterpret_cast<float(*)[TK]>(smem + 2 * 2 * TK * FP * 4);
  float(*dls)[TK] = ls + 2;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp / WG, part = warp % WG;   // the 16-key group, this warp's share
  const int blk_key0 = blockIdx.x * BKT, key0 = blk_key0 + grp * 16;
  const long long obase = ((long long)b * a.Tq * a.H + h) * a.Hd;   // of d_o
  const long long ost = (long long)a.H * a.Hd;
  const long long srow0 = ((long long)b * a.H + h) * a.Tq;
  const T* qp = q + b * a.q_sb + (long long)h * a.Hd;
  const T* gp = d_o + obase;
  const float* lse2 = rows + (long long)gridDim.z * a.H * a.Tq;   // the dQ kernel's rows
  const int first = a.causal ? blk_key0 / TK : 0;
  const int last = blk_key0 < a.kv_len ? (a.Tq + TK - 1) / TK : first;
  auto stage = [&](int it) {
    const int buf = (it - first) & 1;
    stage_rows_f32<T, NT, HDP, TK>(qs[buf], qp, a.q_st, it * TK, a.Tq, a.Hd, a.vec);
    stage_rows_f32<T, NT, HDP, TK>(gs[buf], gp, ost, it * TK, a.Tq, a.Hd, a.vec);
    for (int i = threadIdx.x; i < TK; i += NT) {
      const bool ok = it * TK + i < a.Tq;
      const long long at = srow0 + (ok ? it * TK + i : 0);
      cp_async4(smem_u32(&ls[buf][i]), lse2 + at, ok);
      cp_async4(smem_u32(&dls[buf][i]), rows + at, ok);
    }
  };
  if (first < last) stage(first);
  cp_async_commit();

  SplitRows<P, HDP, SS> ka, va;
  ka.lane = va.lane = lane;
  unsigned char* own =   // the group's region, as in the dQ kernel
      smem + 2 * 2 * TK * FP * 4 + 2 * 2 * TK * 4 + 2 * grp * split_rows_bytes<P, HDP, SS>();
  ka.s = reinterpret_cast<uint4*>(own);
  va.s = reinterpret_cast<uint4*>(own + split_rows_bytes<P, HDP, SS>());
  load_split_rows<P, BITS>(ka, k + b * a.k_sb + (long long)h * a.Hd, a.k_st, key0, a.kv_len,
                           a.Hd, g, t);
  load_split_rows<P, BITS>(va, v + b * a.v_sb + (long long)h * a.Hd, a.v_st, key0, a.kv_len,
                           a.Hd, g, t);
  float dka[DS][4], dva[DS][4];
#pragma unroll
  for (int n = 0; n < DS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;
  const float c = a.scale * LOG2E;
  const int cq = g & 3;
  // keep4_cols: the Philox block of key key0 + 8 (cq / 2) + 4 (g / 4), as an
  // offset from a query row's first block
  const unsigned long long kblk = (unsigned long long)((key0 + 8 * (cq >> 1)) >> 2) + (g >> 2);

  for (int it = first; it < last; ++it) {
    if (it + 1 < last) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = (it - first) & 1;
    const float(*qt)[FP] = qs[buf];
    const float(*gt)[FP] = gs[buf];
    float sb[JB][4], pb[JB][4];   // JB > 1: the steps' S^T and dP^T, formed at once
#pragma unroll (HDP > 64 ? 4 : 2)
    for (int jj = 0; jj < SPW; ++jj) {
      const int j = part * SPW + jj;      // this warp's share of the tile's steps
      const int qb = it * TK + 8 * j;     // first query of this step
      if (qb >= a.Tq) break;
      if constexpr (JB > 1) {
        if (jj % JB == 0 && !(a.causal && qb + 8 * JB - 1 < key0))
          first_products_steps<P, BITS, JB>(sb, pb, ka, va, &qt[8 * j + g][t],
                                            &gt[8 * j + g][t], FP, (a.Tq - qb + 7) >> 3);
      }
      if (a.causal && qb + 7 < key0) continue;
      float st[4], dpt[4];
      if constexpr (JB > 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          st[i] = sb[jj % JB][i];
          dpt[i] = pb[jj % JB][i];
        }
      } else {
        first_products<P, BITS>(st, dpt, ka, va, &qt[8 * j + g][t], &gt[8 * j + g][t]);
      }
      const bool full = qb + 8 <= a.Tq && key0 + 16 <= a.kv_len &&
                        (!a.causal || key0 + 15 <= qb);
      const int qi = 8 * j + 2 * t;         // in the tile; + (i & 1)
      const float2 L = *reinterpret_cast<const float2*>(&ls[buf][qi]);
      const float2 D = *reinterpret_cast<const float2*>(&dls[buf][qi]);
      const uint32_t keep =
          DROP ? keep4_cols(a, b, h, it * TK + qi + (cq & 1), kblk, cq) : 0xfu;
      float pd[4], ds_[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // the dQ kernel's P: x rounded alike, its lse2
        float p = fast_exp2(__fmul_rn(st[i], c) - ((i & 1) ? L.y : L.x));
        if (!full) {
          const int query = it * TK + qi + (i & 1), key = key0 + g + 8 * (i >> 1);
          if (query >= a.Tq || key >= a.kv_len || (a.causal && key > query)) p = 0.f;
        }
        float d = dpt[i];
        pd[i] = p;
        if (DROP) {
          const bool kept = (keep >> i) & 1u;
          pd[i] = kept ? p * a.inv : 0.f;
          d = kept ? d * a.inv : 0.f;
        }
        pd[i] = round_to<T>(pd[i]);
        ds_[i] = round_to<T>(p * (d - ((i & 1) ? D.y : D.x)));
      }
      FragA<P> pa, dsa;
      acc_as_a<P, BITS>(pa, pd);
      acc_as_a<P, BITS>(dsa, ds_);
      // dV += P^T dO, dK += dS^T Q: queries 2 t and 2 t + 1 as k indices t, t + 4
#pragma unroll
      for (int n = 0; n < DS; ++n) {
        const float* gr = &gt[qi][8 * n + g];
        const float* qr = &qt[qi][8 * n + g];
        mma_add_as<P, BITS>(dva[n], pa, gr[0], gr[FP]);
        mma_add_as<P, BITS>(dka[n], dsa, qr[0], qr[FP]);
      }
    }
    __syncthreads();
  }
  if constexpr (WG > 1) {   // dK's and dV's sums through the free tiles, one half each
    float* buf = reinterpret_cast<float*>(smem);
    add_group_sums<WG, DS>(dka, buf, grp, part, lane);
    add_group_sums<WG, DS>(dva, buf + NW * (WG - 1) * DS * 4 * 32, grp, part, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    if (part != 0 || key >= a.Tk) continue;
    const long long krow = (((long long)b * a.Tk + key) * a.H + h) * a.Hd;
#pragma unroll
    for (int n = 0; n < DS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < a.Hd) {
          dk[krow + d] = from_f32<T>(dka[n][2 * r + e] * a.scale);
          dv[krow + d] = from_f32<T>(dva[n][2 * r + e]);
        }
      }
  }
}

// The tensor-core kernels take an even Hd <= 128; the wrapper has checked the
// 4-byte alignment of the pointers and strides.
bool mma_shape_ok(const Shape& a) { return a.Hd <= 128 && (a.Hd & 1) == 0; }

// Whether every tile a call stages may move 16 bytes a copy: Hd a multiple of
// a 16-byte chunk, every batch / time stride too, every base 16-byte aligned.
bool vec_ok(int esz, int Hd, std::initializer_list<long long> strides,
            std::initializer_list<const void*> ptrs) {
  const long long u = 16 / esz;
  if (Hd % u) return false;
  for (long long s : strides)
    if (s % u) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// A launch's dynamic shared memory above the default 48 KB must be allowed
// for its kernel first.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// Two warps a block at HDP 32 where there are at most 32 rows to own, four
// otherwise (and at every wider head dim).
template <int HDP, int NW>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                   void* keep_words, int B, const Shape& a, cudaStream_t s) {
  auto kernel = flash_fwd_mma_kernel<HDP, NW, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_fwd_mma_kernel<HDP, NW, true>;
  constexpr int smem = mma_tiles_bytes<HDP>();
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3((a.Tq + NW * 16 - 1) / (NW * 16), a.H, B), NW * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<uint32_t*>(keep_words), a);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP, int NW>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* o,
                  const void* d_o, const void* lse, const void* keep_words, void* delta,
                  void* dq, int B, const Shape& a, cudaStream_t s) {
  auto kernel = flash_bwd_dq_mma_kernel<HDP, NW, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_bwd_dq_mma_kernel<HDP, NW, true>;
  constexpr int smem = mma_tiles_bytes<HDP>();
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3((a.Tq + NW * 16 - 1) / (NW * 16), a.H, B), NW * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<const uint32_t*>(keep_words), static_cast<float*>(delta),
      static_cast<bf16*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP, int NW>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* d_o,
                   const void* lse, const void* delta, const void* keep_words, void* dk,
                   void* dv, int B, const Shape& a, cudaStream_t s) {
  auto kernel = flash_bwd_dkv_mma_kernel<HDP, NW, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_bwd_dkv_mma_kernel<HDP, NW, true>;
  constexpr int smem = dkv_mma_bytes<HDP>();
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3((a.Tk + NW * 16 - 1) / (NW * 16), a.H, B), NW * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint32_t*>(keep_words), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 forward on wgmma at HDP 64 / 128: one warpgroup a block, 64 rows
template <int HDP>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                     void* keep_words, int B, const Shape& a, cudaStream_t s) {
  auto kernel = flash_fwd_wgmma_kernel<HDP, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_fwd_wgmma_kernel<HDP, true>;
  constexpr int smem = wg_fwd_bytes<HDP>();
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3((a.Tq + TILE - 1) / TILE, a.H, B), 128, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<uint32_t*>(keep_words), a);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 backward on wgmma at HDP 64 / 128: one warpgroup a block, 64 rows
template <int HDP>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* o,
                    const void* d_o, const void* lse, const void* keep_words, void* delta,
                    void* dq, int B, const Shape& a, cudaStream_t s) {
  auto kernel = flash_bwd_dq_wgmma_kernel<HDP, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_bwd_dq_wgmma_kernel<HDP, true>;
  constexpr int smem = wg_dq_bytes<HDP>();
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3((a.Tq + TILE - 1) / TILE, a.H, B), 128, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<const uint32_t*>(keep_words), static_cast<float*>(delta),
      static_cast<bf16*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* d_o,
                     const void* lse, const void* delta, const void* keep_words, void* dk,
                     void* dv, int B, const Shape& a, cudaStream_t s) {
  auto kernel = flash_bwd_dkv_wgmma_kernel<HDP, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_bwd_dkv_wgmma_kernel<HDP, true>;
  constexpr int smem = wg_dkv_bytes<HDP>();
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3((a.Tk + TILE - 1) / TILE, a.H, B), 128, smem, s>>>(
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
  // Dropout is built for head dims up to 32 only: the CUDA-core forward runs
  // on no path, and is kept to be timed beside the kernels that replaced it.
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

// The TF32 kernels (f32, and bf16 that misses the tensor-core alignment):
// the forward, and the backward as dQ, then dK/dV; their blocks as the
// tensor-core kernels'.
template <typename T, int HDP, int NW>
int launch_bwd_tf32_dq(const void* q, const void* k, const void* v, const void* d_o, void* rows,
                       void* dq, int B, const Shape& a, cudaStream_t s) {
  auto kernel = flash_bwd_dq_tf32_kernel<T, HDP, NW, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_bwd_dq_tf32_kernel<T, HDP, NW, true>;
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;
  constexpr int smem = tf32_bytes<P, HDP, NW, 2, false, true>();
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3((a.Tq + NW * 16 - 1) / (NW * 16), a.H, B), NW * 32 * group_warps<HDP>(),
           smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(d_o), static_cast<float*>(rows), static_cast<T*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HDP, int NW>
int launch_bwd_tf32_dkv(const void* q, const void* k, const void* v, const void* d_o,
                        const void* rows, void* dk, void* dv, int B, const Shape& a,
                        cudaStream_t s) {
  auto kernel = flash_bwd_dkv_tf32_kernel<T, HDP, NW, false>;
  if (a.thresh < KEEP_ALL) kernel = flash_bwd_dkv_tf32_kernel<T, HDP, NW, true>;
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;
  constexpr int smem = tf32_bytes<P, HDP, NW, 2, true, true>();
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3((a.Tk + NW * 16 - 1) / (NW * 16), a.H, B), NW * 32 * group_warps<HDP>(),
           smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(d_o), static_cast<const float*>(rows), static_cast<T*>(dk),
      static_cast<T*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HDP, int NW>
int launch_fwd_tf32(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                    const Shape& a, cudaStream_t s) {
  auto kernel = fwd_tf32_kernel<T, HDP, NW, false>();
  if (a.thresh < KEEP_ALL) kernel = fwd_tf32_kernel<T, HDP, NW, true>();
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;
  constexpr int smem = tf32_bytes<P, HDP, NW, 1, false, false>();
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3((a.Tq + NW * 16 - 1) / (NW * 16), a.H, B), NW * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward_tf32(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                 const Shape& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.Hd > 128 ? 0 : hd_pad(a.Hd)) {
    case 32:
      return a.Tq > 32 ? launch_fwd_tf32<T, 32, 4>(q, k, v, o, lse, B, a, s)
                       : launch_fwd_tf32<T, 32, 2>(q, k, v, o, lse, B, a, s);
    case 64: return launch_fwd_tf32<T, 64, 4>(q, k, v, o, lse, B, a, s);
    case 128: return launch_fwd_tf32<T, 128, 4>(q, k, v, o, lse, B, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `rows` (the wrapper's `delta`) holds 2 x B H Tq floats here: each row's
// delta, then its lse2, both written by the dQ kernel
template <typename T, int HDP, int NW>
int backward_tf32(const void* q, const void* k, const void* v, const void* d_o, void* rows,
                  void* dq, void* dk, void* dv, int B, const Shape& a, cudaStream_t s) {
  const int err = launch_bwd_tf32_dq<T, HDP, NW>(q, k, v, d_o, rows, dq, B, a, s);
  if (err) return err;
  return launch_bwd_tf32_dkv<T, HDP, NW>(q, k, v, d_o, rows, dk, dv, B, a, s);
}

template <typename T>
int backward(const void* q, const void* k, const void* v, const void* d_o, void* rows,
             void* dq, void* dk, void* dv, int B, const Shape& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.Hd > 128 ? 0 : hd_pad(a.Hd)) {
    case 32: {
      const int err = a.Tq > 32 ? launch_bwd_tf32_dq<T, 32, 4>(q, k, v, d_o, rows, dq, B, a, s)
                                : launch_bwd_tf32_dq<T, 32, 2>(q, k, v, d_o, rows, dq, B, a, s);
      if (err) return err;
      return a.Tk > 32 ? launch_bwd_tf32_dkv<T, 32, 4>(q, k, v, d_o, rows, dk, dv, B, a, s)
                       : launch_bwd_tf32_dkv<T, 32, 2>(q, k, v, d_o, rows, dk, dv, B, a, s);
    }
    case 64: return backward_tf32<T, 64, 4>(q, k, v, d_o, rows, dq, dk, dv, B, a, s);
    case 128: return backward_tf32<T, 128, 4>(q, k, v, d_o, rows, dq, dk, dv, B, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Shape make_shape(int Tq, int Tk, int H, int Hd, long long q_sb, long long q_st,
                 long long k_sb, long long k_st, long long v_sb, long long v_st,
                 int kv_len, int causal, float scale, float inv, unsigned thresh,
                 unsigned seed, unsigned long long block0) {
  return Shape{Tq, Tk, H, Hd, q_sb, q_st, k_sb, k_st, v_sb, v_st,
               kv_len, causal, scale, inv, thresh, seed, block0, 0};
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
#define ICEK_STRIDES {q_sb, q_st, k_sb, k_st, v_sb, v_st}

// Every forward and backward entry point takes `keep_words`, where the
// tensor-core forward leaves its dropout mask for its backward; the TF32 and
// CUDA-core kernels draw the mask anew and ignore it.  flash_fwd_<dtype> is
// the CUDA-core forward, flash_fwd_<dtype>_tf32 the TF32 one (Hd <= 128).
ICEK_EXPORT int flash_fwd_f32(const void* q, const void* k, const void* v,
                              void* o, void* lse, void*, ICEK_SHAPE_PARAMS) {
  return forward<float>(q, k, v, o, lse, B, ICEK_SHAPE_ARGS, stream);
}

ICEK_EXPORT int flash_fwd_bf16(const void* q, const void* k, const void* v,
                               void* o, void* lse, void*, ICEK_SHAPE_PARAMS) {
  return forward<__nv_bfloat16>(q, k, v, o, lse, B, ICEK_SHAPE_ARGS, stream);
}

ICEK_EXPORT int flash_fwd_f32_tf32(const void* q, const void* k, const void* v,
                                   void* o, void* lse, void*, ICEK_SHAPE_PARAMS) {
  Shape a = ICEK_SHAPE_ARGS;
  a.vec = vec_ok(4, Hd, ICEK_STRIDES, {q, k, v});
  return forward_tf32<float>(q, k, v, o, lse, B, a, stream);
}

ICEK_EXPORT int flash_fwd_bf16_tf32(const void* q, const void* k, const void* v,
                                    void* o, void* lse, void*, ICEK_SHAPE_PARAMS) {
  return forward_tf32<__nv_bfloat16>(q, k, v, o, lse, B, ICEK_SHAPE_ARGS, stream);
}

ICEK_EXPORT int flash_bwd_f32(const void* q, const void* k, const void* v, const void*,
                              const void* d_o, const void*, const void*, void* delta,
                              void* dq, void* dk, void* dv, ICEK_SHAPE_PARAMS) {
  Shape a = ICEK_SHAPE_ARGS;
  a.vec = vec_ok(4, Hd, ICEK_STRIDES, {q, k, v, d_o});
  return backward<float>(q, k, v, d_o, delta, dq, dk, dv, B, a, stream);
}

ICEK_EXPORT int flash_bwd_bf16(const void* q, const void* k, const void* v, const void*,
                               const void* d_o, const void*, const void*, void* delta,
                               void* dq, void* dk, void* dv, ICEK_SHAPE_PARAMS) {
  return backward<__nv_bfloat16>(q, k, v, d_o, delta, dq, dk, dv, B, ICEK_SHAPE_ARGS,
                                 stream);
}

// bf16 on the tensor cores (even Hd <= 128, 4-byte aligned rows), two
// designs, one entry each: flash_fwd_bf16_mma runs the mma.sync forward at
// every head dim, flash_fwd_bf16_wgmma the wgmma forward at HDP 64 and 128
// (and refuses HDP 32).  The wrapper picks one by shape (uses_wgmma_forward
// in kernels/flash_attention.py) and counts what it launched.  With dropout,
// `keep_words` (32-bit words, keep_cell's layout: B * H * 4 ceil(Tq / 64) *
// ceil(Tk / 64) * 32 of them, the same from both designs) takes the
// forward's keep flags to the backward; it may be null at rate 0.
static int mma_fwd_shape(Shape& a, const void* k, const void* v, const void* keep_words) {
  if (!mma_shape_ok(a) || (a.thresh < KEEP_ALL && !keep_words))
    return static_cast<int>(cudaErrorInvalidValue);
  a.vec = vec_ok(2, a.Hd, {a.q_sb, a.q_st, a.k_sb, a.k_st, a.v_sb, a.v_st}, {k, v});
  return 0;
}

ICEK_EXPORT int flash_fwd_bf16_mma(const void* q, const void* k, const void* v,
                                   void* o, void* lse, void* keep_words,
                                   ICEK_SHAPE_PARAMS) {
  Shape a = ICEK_SHAPE_ARGS;
  if (int err = mma_fwd_shape(a, k, v, keep_words)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd_pad(a.Hd)) {
    case 32:
      return a.Tq > 32 ? launch_fwd_mma<32, 4>(q, k, v, o, lse, keep_words, B, a, s)
                       : launch_fwd_mma<32, 2>(q, k, v, o, lse, keep_words, B, a, s);
    case 64: return launch_fwd_mma<64, 4>(q, k, v, o, lse, keep_words, B, a, s);
    default: return launch_fwd_mma<128, 4>(q, k, v, o, lse, keep_words, B, a, s);
  }
}

ICEK_EXPORT int flash_fwd_bf16_wgmma(const void* q, const void* k, const void* v,
                                     void* o, void* lse, void* keep_words,
                                     ICEK_SHAPE_PARAMS) {
  Shape a = ICEK_SHAPE_ARGS;
  if (int err = mma_fwd_shape(a, k, v, keep_words)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd_pad(a.Hd)) {
    case 64: return launch_fwd_wgmma<64>(q, k, v, o, lse, keep_words, B, a, s);
    case 128: return launch_fwd_wgmma<128>(q, k, v, o, lse, keep_words, B, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 backward: the mma.sync pair at HDP 32, the wgmma pair at 64 and
// 128
template <int HDP>
int backward_mma(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                 const void* lse, const void* kw, void* delta, void* dq, void* dk, void* dv,
                 int B, const Shape& a, cudaStream_t s) {
  int err;
  if constexpr (HDP == 32) {
    err = a.Tq > 32 ? launch_dq_mma<32, 4>(q, k, v, o, d_o, lse, kw, delta, dq, B, a, s)
                    : launch_dq_mma<32, 2>(q, k, v, o, d_o, lse, kw, delta, dq, B, a, s);
    if (err) return err;
    return a.Tk > 32 ? launch_dkv_mma<32, 4>(q, k, v, d_o, lse, delta, kw, dk, dv, B, a, s)
                     : launch_dkv_mma<32, 2>(q, k, v, d_o, lse, delta, kw, dk, dv, B, a, s);
  } else {   // the wgmma pair
    err = launch_dq_wgmma<HDP>(q, k, v, o, d_o, lse, kw, delta, dq, B, a, s);
    if (err) return err;
    return launch_dkv_wgmma<HDP>(q, k, v, d_o, lse, delta, kw, dk, dv, B, a, s);
  }
}

ICEK_EXPORT int flash_bwd_bf16_mma(const void* q, const void* k, const void* v,
                                   const void* o, const void* d_o, const void* lse,
                                   const void* keep_words, void* delta, void* dq,
                                   void* dk, void* dv, ICEK_SHAPE_PARAMS) {
  Shape a = ICEK_SHAPE_ARGS;
  if (!mma_shape_ok(a) || (a.thresh < KEEP_ALL && !keep_words))
    return static_cast<int>(cudaErrorInvalidValue);
  a.vec = vec_ok(2, Hd, ICEK_STRIDES, {q, k, v, d_o});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd_pad(a.Hd)) {
    case 32: return backward_mma<32>(q, k, v, o, d_o, lse, keep_words, delta, dq, dk, dv, B, a, s);
    case 64: return backward_mma<64>(q, k, v, o, d_o, lse, keep_words, delta, dq, dk, dv, B, a, s);
    default:
      return backward_mma<128>(q, k, v, o, d_o, lse, keep_words, delta, dq, dk, dv, B, a, s);
  }
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
