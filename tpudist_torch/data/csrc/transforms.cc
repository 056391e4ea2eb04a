// tpudist_torch host data-path kernels: the port's copy of
// native/transforms.cc, built by tpudist_torch/data/native.py with g++ at
// first use (the same flags as native/Makefile) and loaded with ctypes.
//
// A fused crop -> bilinear-resize -> flip -> normalize kernel that turns a
// decoded uint8 HWC image into a normalized float32 HWC tensor in ONE pass
// over the output (PIL does crop, resize, to-float, normalize as separate
// passes over full intermediates). Host code, not a device kernel: the
// loader's worker threads call it with the GIL released (ctypes drops the
// GIL around foreign calls), so batch assembly parallelises across cores.

#include <cstdint>
#include <algorithm>
#include <cmath>

extern "C" {

// Fused: crop box (x0,y0,w,h) from src (H,W,3 uint8, row stride = W*3),
// bilinear-resize to (out_size, out_size), optional horizontal flip,
// normalize ((v/255 - mean)/std), write float32 HWC.
void crop_resize_normalize(const uint8_t* src, int src_h, int src_w,
                           int x0, int y0, int cw, int ch,
                           int out_size, int flip,
                           const float* mean, const float* std_,
                           float* dst) {
  const float sx = (float)cw / out_size;
  const float sy = (float)ch / out_size;
  const float inv255 = 1.0f / 255.0f;
  float inv_std[3], mean_[3];
  for (int c = 0; c < 3; ++c) {
    inv_std[c] = 1.0f / std_[c];
    mean_[c] = mean[c];
  }
  // Per-column sample positions are row-invariant: precompute byte offsets
  // and weights once instead of floor/clamp per pixel per row.
  int* xoff1 = new int[out_size];
  int* xoff2 = new int[out_size];
  float* wxs = new float[out_size];
  for (int ox = 0; ox < out_size; ++ox) {
    float fx = (ox + 0.5f) * sx - 0.5f + x0;
    int x1 = (int)std::floor(fx);
    wxs[ox] = fx - x1;
    xoff1[ox] = std::clamp(x1, 0, src_w - 1) * 3;
    xoff2[ox] = std::clamp(x1 + 1, 0, src_w - 1) * 3;
  }
  for (int oy = 0; oy < out_size; ++oy) {
    // PIL-convention bilinear: sample at pixel centers.
    float fy = (oy + 0.5f) * sy - 0.5f + y0;
    int y1 = (int)std::floor(fy);
    float wy = fy - y1;
    int y1c = std::clamp(y1, 0, src_h - 1);
    int y2c = std::clamp(y1 + 1, 0, src_h - 1);
    const uint8_t* row1 = src + (size_t)y1c * src_w * 3;
    const uint8_t* row2 = src + (size_t)y2c * src_w * 3;
    float* out_row = dst + (size_t)oy * out_size * 3;
    for (int ox = 0; ox < out_size; ++ox) {
      float wx = wxs[ox];
      int o1 = xoff1[ox], o2 = xoff2[ox];
      int out_x = flip ? (out_size - 1 - ox) : ox;
      float* px = out_row + (size_t)out_x * 3;
      for (int c = 0; c < 3; ++c) {
        float v11 = row1[o1 + c], v12 = row1[o2 + c];
        float v21 = row2[o1 + c], v22 = row2[o2 + c];
        float top = v11 + (v12 - v11) * wx;
        float bot = v21 + (v22 - v21) * wx;
        float v = top + (bot - top) * wy;
        px[c] = (v * inv255 - mean_[c]) * inv_std[c];
      }
    }
  }
  delete[] xoff1;
  delete[] xoff2;
  delete[] wxs;
}

// Center-crop + shorter-side-resize + normalize (the val stack,
// distributed.py:171-176) as one call: resize so shorter edge == resize_to,
// then center-crop out_size — expressed as a single crop box in SOURCE
// coordinates so no intermediate image is materialized.
void val_resize_crop_normalize(const uint8_t* src, int src_h, int src_w,
                               int resize_to, int out_size,
                               const float* mean, const float* std_,
                               float* dst) {
  // Scale factor of the virtual Resize(shorter=resize_to).
  float scale = (src_w <= src_h) ? (float)src_w / resize_to
                                 : (float)src_h / resize_to;
  // The out_size×out_size center crop in resized coords maps to a
  // crop_px×crop_px box centered in the source.
  float crop_src = out_size * scale;
  float x0f = (src_w - crop_src) * 0.5f;
  float y0f = (src_h - crop_src) * 0.5f;
  // Reuse the fused kernel with a float-precise box via rounded ints; the
  // sub-pixel residual is within bilinear tolerance.
  crop_resize_normalize(src, src_h, src_w,
                        (int)std::lround(x0f), (int)std::lround(y0f),
                        (int)std::lround(crop_src), (int)std::lround(crop_src),
                        out_size, /*flip=*/0, mean, std_, dst);
}

}  // extern "C"
