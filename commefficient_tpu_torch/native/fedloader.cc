// Host batch assembly for the federated sampler: fused gather + augment.
//
// A round's batch is W*B sample rows gathered by index from the training
// set and augmented: the CIFAR prep (reflect-pad(4) + random crop + hflip +
// cutout(2*cut_half)) or ImageNet's random-resized-crop (bilinear) + hflip.
// Each is one OpenMP pass over the source array, called from Python through
// ctypes, which releases the GIL for the call: under the sampler's prefetch
// thread the assembly overlaps the device's round.
//
// Semantics contract: the output is BIT-EQUAL to the numpy path of
// commefficient_tpu_torch/data/cifar.py and data/imagenet.py, in float32
// and uint8. The CIFAR prep is pure copies and fills. The RRC does float32
// arithmetic in numpy's order and width: (t + 0.5) * (crop / out) - 0.5,
// clamp, floor, then the lerps a + (b - a) * t, each a separate rounding.
// The library is built with -ffp-contract=off and without -march=native or
// -ffast-math, so no product and sum are fused and nothing is reassociated.
// Pinned by tests/test_torch_native_loader.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// numpy pad(mode="reflect") index map: no edge repeat.
inline int reflect(int t, int n) {
  if (t < 0) return -t;
  if (t >= n) return 2 * n - 2 - t;
  return t;
}

template <typename T>
void gather_augment_impl(const T* data, int H, int W, int C,
                         const int64_t* idx, int64_t n, const int32_t* ys,
                         const int32_t* xs, const uint8_t* flips,
                         const int32_t* cys, const int32_t* cxs, int pad,
                         int cut_half, const float* fill, T* out) {
  const int64_t img = (int64_t)H * W * C;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const T* src = data + idx[i] * img;
    T* dst = out + i * img;
    if (ys == nullptr) {
      std::memcpy(dst, src, (size_t)img * sizeof(T));
      continue;
    }
    const int y0 = ys[i] - pad;
    const int x0 = xs[i] - pad;
    const bool fl = flips[i] != 0;
    const int cy0 = cys[i] - cut_half, cy1 = cys[i] + cut_half;
    const int cx0 = cxs[i] - cut_half, cx1 = cxs[i] + cut_half;
    for (int r = 0; r < H; ++r) {
      const T* srow = src + (int64_t)reflect(y0 + r, H) * W * C;
      T* drow = dst + (int64_t)r * W * C;
      const bool rcut = (r >= cy0 && r < cy1);
      for (int col = 0; col < W; ++col) {
        T* dpix = drow + (int64_t)col * C;
        if (rcut && col >= cx0 && col < cx1) {
          // the cutout fill, per channel in the source dtype's scale
          for (int ch = 0; ch < C; ++ch)
            dpix[ch] = fill ? T(fill[ch]) : T(0);
        } else {
          // numpy's order is crop, flip, cutout: the flip acts on the
          // cropped image, so output column col reads cropped W-1-col
          const int jj = fl ? (W - 1 - col) : col;
          const T* spix = srow + (int64_t)reflect(x0 + jj, W) * C;
          for (int ch = 0; ch < C; ++ch) dpix[ch] = spix[ch];
        }
      }
    }
  }
}

// The bilinear sampling coordinate for resizing a crop_len axis to out_len
// (torch/PIL align_corners=False), as data/imagenet.py::_bilinear_grid
// computes it in float32: g = (t + 0.5) * (crop / out) - 0.5, clamped to
// [0, crop - 1]; lo = floor(g), hi = min(lo + 1, crop - 1), w = g - lo.
inline void bilin(int t, int out_len, int crop_len, int* lo, int* hi,
                  float* w) {
  const float ratio = (float)crop_len / (float)out_len;
  const float at = (float)t + 0.5f;
  const float scaled = at * ratio;
  float g = scaled - 0.5f;
  if (g < 0.0f) g = 0.0f;
  const float mx = (float)crop_len - 1.0f;
  if (g > mx) g = mx;
  *lo = (int)g;  // g >= 0: truncation is the floor
  *hi = *lo + 1 < crop_len ? *lo + 1 : crop_len - 1;
  *w = g - (float)*lo;
}

// Fused gather + random-resized-crop (bilinear) + hflip, as
// data/imagenet.py::ImageNetAugment.apply computes it.
template <typename T>
void gather_rrc_impl(const T* data, int H, int W, int C, const int64_t* idx,
                     int64_t n, const int32_t* ys, const int32_t* xs,
                     const int32_t* hs, const int32_t* ws,
                     const uint8_t* flips, T* out) {
  const int64_t img = (int64_t)H * W * C;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const T* src = data + idx[i] * img;
    T* dst = out + i * img;
    const int ch = hs[i], cw = ws[i];
    const bool fl = flips[i] != 0;
    // the column coordinates depend only on (col, W, cw): computed once an
    // image (on the stack for W <= 4096)
    int x0s[4096], x1s[4096];
    float wxs[4096];
    for (int col = 0; col < W && col < 4096; ++col)
      bilin(col, W, cw, &x0s[col], &x1s[col], &wxs[col]);
    for (int r = 0; r < H; ++r) {
      int y0, y1;
      float wy;
      bilin(r, H, ch, &y0, &y1, &wy);
      const T* row0 = src + (int64_t)(ys[i] + y0) * W * C;
      const T* row1 = src + (int64_t)(ys[i] + y1) * W * C;
      T* drow = dst + (int64_t)r * W * C;
      for (int col = 0; col < W; ++col) {
        // the flip follows the resize: output col reads resized W-1-col
        const int cc = fl ? (W - 1 - col) : col;
        int x0, x1;
        float wx;
        if (cc < 4096) {
          x0 = x0s[cc]; x1 = x1s[cc]; wx = wxs[cc];
        } else {
          bilin(cc, W, cw, &x0, &x1, &wx);
        }
        const T* p00 = row0 + (int64_t)(xs[i] + x0) * C;
        const T* p01 = row0 + (int64_t)(xs[i] + x1) * C;
        const T* p10 = row1 + (int64_t)(xs[i] + x0) * C;
        const T* p11 = row1 + (int64_t)(xs[i] + x1) * C;
        T* dpix = drow + (int64_t)col * C;
        for (int c = 0; c < C; ++c) {
          const float a = (float)p00[c], b = (float)p01[c];
          const float d0 = (float)p10[c], d1 = (float)p11[c];
          const float top = a + (b - a) * wx;
          const float bot = d0 + (d1 - d0) * wx;
          const float v = top + (bot - top) * wy;
          if (sizeof(T) == 1) {
            // np.rint (half to even, the default rounding mode), clip
            float rv = nearbyintf(v);
            if (rv < 0.0f) rv = 0.0f;
            if (rv > 255.0f) rv = 255.0f;
            dpix[c] = (T)rv;
          } else {
            dpix[c] = (T)v;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// The OpenMP threads a parallel region of this library starts from the
// calling thread (1 without OpenMP).
int fedloader_omp_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// data: [N, H, W, C] (contiguous), idx: [n] int64 sample rows (checked in
// Python). out: [n, H, W, C], data's dtype. ys/xs: [n] crop offsets in the
// padded image (0 .. 2*pad); flips: [n] 0/1; cys/cxs: [n] cutout centers.
// ys == nullptr: a plain gather, no augment.
void fedloader_gather_augment(const float* data, int64_t N, int H, int W,
                              int C, const int64_t* idx, int64_t n,
                              const int32_t* ys, const int32_t* xs,
                              const uint8_t* flips, const int32_t* cys,
                              const int32_t* cxs, int pad, int cut_half,
                              const float* fill, float* out) {
  (void)N;
  gather_augment_impl<float>(data, H, W, C, idx, n, ys, xs, flips, cys, cxs,
                             pad, cut_half, fill, out);
}

void fedloader_gather_augment_u8(const uint8_t* data, int64_t N, int H,
                                 int W, int C, const int64_t* idx, int64_t n,
                                 const int32_t* ys, const int32_t* xs,
                                 const uint8_t* flips, const int32_t* cys,
                                 const int32_t* cxs, int pad, int cut_half,
                                 const float* fill, uint8_t* out) {
  (void)N;
  gather_augment_impl<uint8_t>(data, H, W, C, idx, n, ys, xs, flips, cys,
                               cxs, pad, cut_half, fill, out);
}

// data: [N, H, W, C]; idx: [n]; ys/xs/hs/ws: [n] crop boxes (checked in
// Python); flips: [n] 0/1. out: [n, H, W, C], each crop resized to H x W.
void fedloader_gather_rrc(const float* data, int64_t N, int H, int W, int C,
                          const int64_t* idx, int64_t n, const int32_t* ys,
                          const int32_t* xs, const int32_t* hs,
                          const int32_t* ws, const uint8_t* flips,
                          float* out) {
  (void)N;
  gather_rrc_impl<float>(data, H, W, C, idx, n, ys, xs, hs, ws, flips, out);
}

void fedloader_gather_rrc_u8(const uint8_t* data, int64_t N, int H, int W,
                             int C, const int64_t* idx, int64_t n,
                             const int32_t* ys, const int32_t* xs,
                             const int32_t* hs, const int32_t* ws,
                             const uint8_t* flips, uint8_t* out) {
  (void)N;
  gather_rrc_impl<uint8_t>(data, H, W, C, idx, n, ys, xs, hs, ws, flips, out);
}

// A plain indexed gather of fixed-size rows: out[i] = data[idx[i]],
// row_bytes bytes each.
void fedloader_gather_rows(const char* data, const int64_t* idx, int64_t n,
                           int64_t row_bytes, char* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * row_bytes, data + idx[i] * row_bytes,
                (size_t)row_bytes);
  }
}

}  // extern "C"
