// tpudist_torch host JPEG decode: the port's copy of native/jpeg.cc, built
// only where jpeglib.h is found (linked -ljpeg, together with
// transforms.cc) by tpudist_torch/data/native.py.
//
// Decode fused with the transform, so the decode shrinks to what the crop
// needs:
//
// - DCT scaling: decode at 1/2, 1/4 or 1/8 resolution when the sampled crop
//   is much larger than the output size — an 8x8 DCT block can be
//   reconstructed at 4/2/1 pixels directly from its low-frequency
//   coefficients, so a 512px image headed for a 224px crop-resize never
//   materializes at full resolution (PIL decodes all of it, full size).
// - jpeg_crop_scanline / jpeg_skip_scanlines (libjpeg-turbo partial decode):
//   only the iMCU-aligned horizontal band and vertical rows covering the
//   crop are entropy-decoded at all.
// - The decoded band feeds the existing fused crop→bilinear→flip→normalize
//   kernel (transforms.cc) — one intermediate, one output pass.
//
// Anything the fast path cannot handle (CMYK, corrupt files, non-JPEG)
// returns nonzero and the Python caller falls back to PIL.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>

#include <jpeglib.h>

extern "C" {
// transforms.cc
void crop_resize_normalize(const uint8_t* src, int src_h, int src_w,
                           int x0, int y0, int cw, int ch,
                           int out_size, int flip,
                           const float* mean, const float* std_,
                           float* dst);
void val_resize_crop_normalize(const uint8_t* src, int src_h, int src_w,
                               int resize, int out_size,
                               const float* mean, const float* std_,
                               float* dst);
}

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void err_silent(j_common_ptr, int) {}
void err_silent_msg(j_common_ptr) {}

// Decode `data` with scale 1/denom, cropped to the iMCU-aligned band around
// [*xs, *xs+*ws) and rows [*ys, *ys+*hs) (all in SCALED coordinates; the
// box is clamped in place to the scaled frame). On success *out holds a
// malloc'd (*hs, band_w, 3) u8 buffer and *x_in_band is the scaled crop's
// x offset within it. Caller frees *out.
//
// denom <= 0 selects the scale HERE, from this call's own header parse: the
// largest 1/2^k keeping the scaled shorter edge >= auto_min_edge (the val
// stack's Resize target) — so val needs no separate dimension query.
int decode_band(const uint8_t* data, size_t len, int denom, int auto_min_edge,
                int* ys_io, int* hs_io, int* xs_io, int* ws_io,
                uint8_t** out, int* band_w, int* x_in_band) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  // volatile: assigned between setjmp and the longjmp that reads it in the
  // error handler (libjpeg example.c pattern) — without it the -O3 register
  // copy seen after longjmp is indeterminate.
  uint8_t* volatile buf = nullptr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = err_silent;
  jerr.pub.output_message = err_silent_msg;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(buf);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;       // grayscale/YCbCr → RGB; CMYK errors
  if (denom <= 0) {
    int short_edge = (int)std::min(cinfo.image_width, cinfo.image_height);
    denom = 1;
    while (denom < 8 && short_edge / (denom * 2) >= auto_min_edge)
      denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = (unsigned)denom;
  // The decode feeds a bilinear down-resize, which low-passes anyway — the
  // fast integer IDCT and plain (non-fancy) chroma upsampling are visually
  // equivalent here and measurably cheaper than PIL's islow+fancy defaults.
  cinfo.dct_method = JDCT_IFAST;
  cinfo.do_fancy_upsampling = FALSE;
  // Output dims are fixed by the scale — compute them BEFORE start so the
  // partial-decode decision below can feed the upsampling choice (which
  // must be made before jpeg_start_decompress).
  jpeg_calc_output_dimensions(&cinfo);
  int ow = (int)cinfo.output_width, oh = (int)cinfo.output_height;
  int xs = std::clamp(*xs_io, 0, ow - 1);
  int ys = std::clamp(*ys_io, 0, oh - 1);
  int ws = std::clamp(*ws_io, 1, ow - xs);
  int hs = std::clamp(*hs_io, 1, oh - ys);
  *xs_io = xs; *ys_io = ys; *ws_io = ws; *hs_io = hs;
  if (ws < ow || ys > 0) {
    // Partial decode (jpeg_crop_scanline / jpeg_skip_scanlines) combined
    // with MERGED chroma upsampling — the non-fancy 4:2:0 fast path —
    // corrupts the heap in several libjpeg-turbo versions (writes past the
    // crop band; found by the fault-injection suite's data-path stress:
    // free(): invalid next size). Fancy (separable) upsampling uses the
    // well-tested skip/crop implementation, so force it whenever the
    // decode is partial; full-frame decodes keep the fast merged path.
    cinfo.do_fancy_upsampling = TRUE;
  }
  jpeg_start_decompress(&cinfo);
  JDIMENSION xoff = (JDIMENSION)xs, w_adj = (JDIMENSION)ws;
  if (ws < ow)                          // full-width crop needs no realign
    jpeg_crop_scanline(&cinfo, &xoff, &w_adj);
  if (ys > 0)
    jpeg_skip_scanlines(&cinfo, (JDIMENSION)ys);
  buf = (uint8_t*)std::malloc((size_t)hs * w_adj * 3);
  if (!buf)
    longjmp(jerr.jb, 1);
  while ((int)cinfo.output_scanline < ys + hs) {
    JSAMPROW row = buf + (size_t)((int)cinfo.output_scanline - ys) * w_adj * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_abort_decompress(&cinfo);         // legally skip the remaining rows
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  *band_w = (int)w_adj;
  *x_in_band = xs - (int)xoff;
  return 0;
}

}  // namespace

extern "C" {

// Parse only the header; writes full-resolution dims. Returns 0 on success.
int jpeg_header_dims(const uint8_t* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = err_silent;
  jerr.pub.output_message = err_silent_msg;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  *h = (int)cinfo.image_height;
  *w = (int)cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Fused decode → RandomResizedCrop box (FULL-RES coords) → bilinear resize
// to out_size → flip → normalize. Returns 0 on success.
int jpeg_decode_crop_resize_normalize(const uint8_t* data, size_t len,
                                      int x0, int y0, int cw, int ch,
                                      int out_size, int flip,
                                      const float* mean, const float* std_,
                                      float* dst) {
  // Largest 1/2^k scale whose scaled crop still covers the output — never
  // upsample out of a reduced decode.
  int denom = 1;
  while (denom < 8 && cw / (denom * 2) >= out_size
         && ch / (denom * 2) >= out_size)
    denom *= 2;
  // Scaled crop box (floor offset, round extent; decode_band clamps).
  int xs = x0 / denom, ys = y0 / denom;
  int ws = std::max(1, (cw + denom / 2) / denom);
  int hs = std::max(1, (ch + denom / 2) / denom);
  uint8_t* band = nullptr;
  int band_w = 0, x_in_band = 0;
  if (decode_band(data, len, denom, 0, &ys, &hs, &xs, &ws, &band, &band_w,
                  &x_in_band))
    return 1;
  crop_resize_normalize(band, hs, band_w, x_in_band, 0, ws, hs,
                        out_size, flip, mean, std_, dst);
  std::free(band);
  return 0;
}

// Fused decode → Resize(shorter=resize) → CenterCrop(out_size) → normalize
// (the reference's val stack). Returns 0 on success.
int jpeg_decode_val(const uint8_t* data, size_t len, int resize, int out_size,
                    const float* mean, const float* std_, float* dst) {
  // Full-frame box (decode_band clamps to the scaled frame); the scale is
  // chosen inside decode_band from its own header parse — one parse total.
  int ys = 0, xs = 0, oh = 1 << 28, ow = 1 << 28;
  uint8_t* full = nullptr;
  int band_w = 0, x_in_band = 0;
  if (decode_band(data, len, /*denom=*/0, /*auto_min_edge=*/resize,
                  &ys, &oh, &xs, &ow, &full, &band_w, &x_in_band))
    return 1;
  val_resize_crop_normalize(full, oh, band_w, resize, out_size,
                            mean, std_, dst);
  std::free(full);
  return 0;
}

}  // extern "C"
