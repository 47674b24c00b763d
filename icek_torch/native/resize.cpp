// Native (C++) skimage-parity image resize for the offline prep pipeline.
//
// Re-implements the exact float64 numeric path of
// icek_torch/data/images.py::resize_like_reference — which itself reproduces
// skimage.transform.resize as used by the reference prep
// (geo-aware/create_input_files.py:332) — and fuses the surrounding
// /255 -> resize -> clip -> CHW-transpose -> float16 chain of
// images.py::_prepare into one pass over the data.
//
// BIT-EXACTNESS CONTRACT (enforced by tests/test_native.py): the float16
// output is bit-identical to the scipy path.  That requires replicating
// scipy.ndimage's float64 arithmetic to the ulp:
//
//  * correlate1d (symmetric kernel): per output element the sum is
//    accumulated as  center*w[r]  then  (left_j + right_j)*w[r+j]  for
//    j = r (outermost) down to 1 — determined empirically against
//    scipy 1.17 (the symmetric fast path of NI_Correlate1D).
//  * zoom (order=1, grid_mode=True, mode="mirror"): output coordinate
//    cc = zoom*(k + 0.5) - 0.5 with zoom = in/out; interpolation term
//    order is footprint C-order with per-axis weight association
//    ((v * wy) * wx) — the NI_ZoomShift accumulation.
//  * /255 uses a 256-entry table of v/255.0 (same double per value as
//    dividing elementwise).
//  * Gaussian kernel weights are computed by the CALLER (numpy) and
//    passed in, so numpy's pairwise-sum normalization is reproduced by
//    construction.
//  * double -> half uses a single direct conversion (_Float16), which is
//    round-to-nearest-even without an intermediate float32 double-round,
//    matching numpy's astype(float16).
//
// Scheduling (but never per-element op order) is free to differ from
// scipy, and does: the Gaussian prefilter runs lazily per ROW, only for
// the <= 2*outH input rows the zoom stage actually samples — on a
// typical 1066x800 photo -> 256x256 that skips ~half the axis-0/axis-1
// filter work scipy performs on rows the resample never reads.
//
// Build with -ffp-contract=off: FMA contraction would change the bits.

#include <cstdint>
#include <memory>
#include <vector>

namespace {

// mirror boundary ("reflect about edge sample centers, no edge repeat"):
// period 2(n-1); valid for any offset magnitude.
inline int64_t mirror_index(int64_t i, int64_t n) {
  if (n == 1) return 0;
  const int64_t period = 2 * (n - 1);
  int64_t m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - m;
}

// mirror mapping of a real coordinate (scipy map_coordinate, mode mirror).
inline double mirror_coord(double cc, int64_t n) {
  if (n == 1) return 0.0;
  const double p = 2.0 * (double)(n - 1);
  if (cc < 0.0) cc = -cc;
  if (cc > p) {
    // bring into [0, p) — prep coordinates never get here (|cc| < p for
    // any zoom toward out >= 1), but keep it total.
    cc -= p * (double)(int64_t)(cc / p);
  }
  if (cc > (double)(n - 1)) cc = p - cc;
  return cc;
}

// Both filter helpers accumulate per output element exactly like scipy's
// symmetric NI_Correlate1D: center tap first, then symmetric pairs from
// the OUTERMOST tap inward (determined empirically, see header comment).

// Axis-0 filter for ONE output row j of an (n0, row_len) image whose rows
// are contiguous: whole-row vectorized passes over the mirrored window.
void filter_row_axis0(const double* in, double* dst, int64_t n0,
                      int64_t row_len, int64_t j, const double* w,
                      int64_t r) {
  const double* cp = in + mirror_index(j, n0) * row_len;
  const double wc = w[r];
  for (int64_t k = 0; k < row_len; ++k) dst[k] = cp[k] * wc;
  for (int64_t jj = r; jj >= 1; --jj) {
    const double* ap = in + mirror_index(j - jj, n0) * row_len;
    const double* bp = in + mirror_index(j + jj, n0) * row_len;
    const double wj = w[r + jj];
    for (int64_t k = 0; k < row_len; ++k) dst[k] += (ap[k] + bp[k]) * wj;
  }
}

// Axis-1 filter of one (n1, C) row: all C channels of each output column
// computed together (taps step by C within the row).  mir holds the
// precomputed mirrored column indices for offsets -r..n1-1+r.
// Interior columns (where no tap crosses an edge) run as flat shifted
// whole-row passes — identical per-element op order, vectorizable.
void filter_row_axis1(const double* src, double* dst, int64_t n1, int64_t C,
                      const double* w, int64_t r, const int64_t* mir) {
  const double wc = w[r];
  const int64_t lo = r < n1 - r ? r : n1;        // first interior column
  const int64_t hi = n1 - r > lo ? n1 - r : lo;  // one past last interior
  for (int64_t k = 0; k < n1; ++k) {
    if (k == lo && hi > lo) {
      // interior block [lo, hi): contiguous taps, no mirror lookups
      const int64_t i0 = lo * C, i1 = hi * C;
      for (int64_t i = i0; i < i1; ++i) dst[i] = src[i] * wc;
      for (int64_t jj = r; jj >= 1; --jj) {
        const double wj = w[r + jj];
        const double* ap = src - jj * C;
        const double* bp = src + jj * C;
        for (int64_t i = i0; i < i1; ++i)
          dst[i] += (ap[i] + bp[i]) * wj;
      }
      k = hi - 1;
      continue;
    }
    const double* cp = src + mir[k + r] * C;
    for (int64_t ch = 0; ch < C; ++ch) {
      double s = cp[ch] * wc;
      for (int64_t jj = r; jj >= 1; --jj)
        s += (src[mir[k + r - jj] * C + ch] + src[mir[k + r + jj] * C + ch]) *
             w[r + jj];
      dst[k * C + ch] = s;
    }
  }
}

}  // namespace

extern "C" {

// img: (H, W, C) uint8, C-contiguous.  wy/wx: symmetric Gaussian kernels of
// radius ry/rx (length 2r+1) or r<0 to skip that axis' prefilter.  lo/hi:
// clip bounds (the /255 image's global min/max).  out: (C, outH, outW)
// float16 (as uint16 bits), C-contiguous.  Returns 0 on success.
int icek_resize_chw_f16(const uint8_t* img, int64_t H, int64_t W, int64_t C,
                        const double* wy, int64_t ry, const double* wx,
                        int64_t rx, int64_t outH, int64_t outW, double lo,
                        double hi, uint16_t* out) {
  if (H < 1 || W < 1 || C < 1 || outH < 1 || outW < 1) return 1;
  const int64_t row_len = W * C;
  const int64_t n = H * row_len;

  // uint8 -> float64 via a value table (identical doubles to elementwise
  // division, since v/255.0 depends only on v).
  double lut[256];
  for (int i = 0; i < 256; ++i) lut[i] = (double)i / 255.0;
  std::unique_ptr<double[]> a(new double[n]);
  for (int64_t i = 0; i < n; ++i) a[i] = lut[img[i]];

  // zoom order=1, grid_mode, mirror — precompute per-axis sample indices
  // and weights first, so the prefilter below can skip unsampled rows.
  std::vector<int64_t> y0(outH), y1(outH), x0(outW), x1(outW);
  std::vector<double> wy0(outH), wy1(outH), wx0(outW), wx1(outW);
  const double zy = (double)H / (double)outH;
  const double zx = (double)W / (double)outW;
  for (int64_t oy = 0; oy < outH; ++oy) {
    double cc = mirror_coord(zy * ((double)oy + 0.5) - 0.5, H);
    int64_t base = (int64_t)cc;  // cc >= 0 after mirror, so trunc == floor
    double t = cc - (double)base;
    y0[oy] = base;
    y1[oy] = base + 1 < H ? base + 1 : H - 1;
    wy1[oy] = t;
    wy0[oy] = 1.0 - t;
  }
  for (int64_t ox = 0; ox < outW; ++ox) {
    double cc = mirror_coord(zx * ((double)ox + 0.5) - 0.5, W);
    int64_t base = (int64_t)cc;
    double t = cc - (double)base;
    x0[ox] = base;
    x1[ox] = base + 1 < W ? base + 1 : W - 1;
    wx1[ox] = t;
    wx0[ox] = 1.0 - t;
  }

  // Gaussian prefilter, lazily per sampled row.  Per-element semantics are
  // gaussian_filter's sequential axis-0-then-axis-1 passes; rows the zoom
  // never reads are simply not computed.
  const double* filtered = a.get();  // final row source for the zoom stage
  std::unique_ptr<double[]> f;       // per-row filtered storage
  std::unique_ptr<double[]> brow;    // axis-0 scratch row
  if (ry >= 0 || rx >= 0) {
    std::vector<char> needed(H, 0);
    for (int64_t oy = 0; oy < outH; ++oy) needed[y0[oy]] = needed[y1[oy]] = 1;
    f.reset(new double[n]);
    std::vector<int64_t> mirx;
    if (rx >= 0) {
      mirx.resize(W + 2 * rx);
      for (int64_t i = 0; i < (int64_t)mirx.size(); ++i)
        mirx[i] = mirror_index(i - rx, W);
    }
    if (ry >= 0) brow.reset(new double[row_len]);
    for (int64_t j = 0; j < H; ++j) {
      if (!needed[j]) continue;
      double* frow = f.get() + j * row_len;
      if (ry >= 0 && rx >= 0) {
        filter_row_axis0(a.get(), brow.get(), H, row_len, j, wy, ry);
        filter_row_axis1(brow.get(), frow, W, C, wx, rx, mirx.data());
      } else if (ry >= 0) {
        filter_row_axis0(a.get(), frow, H, row_len, j, wy, ry);
      } else {
        filter_row_axis1(a.get() + j * row_len, frow, W, C, wx, rx,
                         mirx.data());
      }
    }
    filtered = f.get();
  }

  for (int64_t oy = 0; oy < outH; ++oy) {
    const double* r0 = filtered + y0[oy] * row_len;
    const double* r1 = filtered + y1[oy] * row_len;
    const double w0 = wy0[oy], w1 = wy1[oy];
    for (int64_t ox = 0; ox < outW; ++ox) {
      const int64_t c0 = x0[ox] * C, c1 = x1[ox] * C;
      const double u0 = wx0[ox], u1 = wx1[ox];
      for (int64_t ch = 0; ch < C; ++ch) {
        // NI_ZoomShift term order: (0,0) (0,1) (1,0) (1,1), each (v*wy)*wx.
        double s = (r0[c0 + ch] * w0) * u0 + (r0[c1 + ch] * w0) * u1 +
                   (r1[c0 + ch] * w1) * u0 + (r1[c1 + ch] * w1) * u1;
        if (s < lo) s = lo;
        if (s > hi) s = hi;
        _Float16 h = (_Float16)s;  // direct f64->f16, RNE (no f32 step)
        uint16_t bits;
        __builtin_memcpy(&bits, &h, 2);
        out[(ch * outH + oy) * outW + ox] = bits;
      }
    }
  }
  return 0;
}
}
