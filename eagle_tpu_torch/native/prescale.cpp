// Host-side frame prescale: BGR -> packed I420 conversion and the
// letterboxed working-canvas prescales, bit-exact clones of the cv2 ops
// they replace (cv2.cvtColor COLOR_BGR2YUV_I420 and cv2.resize
// INTER_LINEAR): the fused 4:2:0 letterbox (letterbox_i420, downscales
// with img_w % 32 == 0), the unfused one for any geometry
// (letterbox_i420_general) and the BGR one (letterbox_bgr), both over one
// general cv2.resize clone (resize_linear_u8); and the team-vote crops,
// cv2.resize INTER_LINEAR of integer boxes of BGR frames
// (crops_linear_u8c3).
//
// Native counterpart of the reference's OpenCV dependency role
// (SURVEY.md section 2.2: preprocessing / color-space ops, implemented in
// OpenCV C++): this is the per-frame host-serial stage that bounds
// end-to-end throughput once the device side scales over chips
// (docs/architecture.md, "v5e-8 extrapolation"), so it gets a fused
// single-pass implementation instead of three cv2 calls per frame.
//
// Bit-exactness contracts (pinned by tests/test_native_prescale.py):
//  - bgr_to_i420: ITU-R BT.601 fixed-point constants at shift 20, chroma
//    sampled from the top-left pixel of each 2x2 block -- cv2's
//    cvtColor(COLOR_BGR2YUV_I420) byte-for-byte for any even H, W.
//  - resize_u8: cv2 INTER_LINEAR uint8 semantics -- 2048-scale fixed-point
//    coefficients rounded half-to-even, horizontal taps accumulated in
//    int32, and cv2's vectorized vertical descale
//    (((b0*(r0>>4))>>16 + (b1*(r1>>4))>>16 + 2) >> 2).  cv2 descales a
//    sub-16-pixel row tail with different rounding (off by at most 1 LSB),
//    so callers gate the native path on dst_w % 16 == 0 (the working
//    canvas is 960/480 wide) and downscale-only geometry.
//
// C ABI for ctypes.  OpenMP parallelizes over frames when threads > 1;
// single-core hosts run serial (thread pools measured ~8x slower than
// serial on a 1-core box -- the Python side passes threads=1 there).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifdef __SSSE3__
#include <immintrin.h>
#endif

namespace {

// ITU-R BT.601 fixed-point constants, cv2 color_yuv shift 20.
constexpr int SH = 20;
constexpr int HALF = 1 << (SH - 1);
constexpr int CRY = 269484, CGY = 528482, CBY = 102760;
constexpr int CRU = -155188, CGU = -305135, CBU = 460324;
constexpr int CGV = -385875, CBV = -74448;  // V: CBU*r + CGV*g + CBV*b

// Deinterleave one BGR row into planar b/g/r buffers (each >= w bytes).
// SSSE3 shuffle path does 16 px / 48 B per iteration; the byte of channel
// c for pixel j lives at absolute offset 3j + c, split across three
// 16-byte loads.
inline void deinterleave_row(const uint8_t* s, int w, uint8_t* bp,
                             uint8_t* gp, uint8_t* rp) {
  int j = 0;
#ifdef __SSSE3__
  // lane masks: which relative byte of each 16B block feeds output lane k
  // (-1 -> zero), OR-combined across the three blocks.
  alignas(16) static const int8_t mb[3][16] = {
      {0, 3, 6, 9, 12, 15, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1},
      {-1, -1, -1, -1, -1, -1, 2, 5, 8, 11, 14, -1, -1, -1, -1, -1},
      {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 1, 4, 7, 10, 13}};
  alignas(16) static const int8_t mg[3][16] = {
      {1, 4, 7, 10, 13, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1},
      {-1, -1, -1, -1, -1, 0, 3, 6, 9, 12, 15, -1, -1, -1, -1, -1},
      {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 2, 5, 8, 11, 14}};
  alignas(16) static const int8_t mr[3][16] = {
      {2, 5, 8, 11, 14, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1},
      {-1, -1, -1, -1, -1, 1, 4, 7, 10, 13, -1, -1, -1, -1, -1, -1},
      {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 3, 6, 9, 12, 15}};
  for (; j + 16 <= w; j += 16) {
    const __m128i x0 = _mm_loadu_si128((const __m128i*)(s + 3 * j));
    const __m128i x1 = _mm_loadu_si128((const __m128i*)(s + 3 * j + 16));
    const __m128i x2 = _mm_loadu_si128((const __m128i*)(s + 3 * j + 32));
    auto pick = [&](const int8_t(&m)[3][16]) {
      return _mm_or_si128(
          _mm_or_si128(
              _mm_shuffle_epi8(x0, _mm_load_si128((const __m128i*)m[0])),
              _mm_shuffle_epi8(x1, _mm_load_si128((const __m128i*)m[1]))),
          _mm_shuffle_epi8(x2, _mm_load_si128((const __m128i*)m[2])));
    };
    _mm_storeu_si128((__m128i*)(bp + j), pick(mb));
    _mm_storeu_si128((__m128i*)(gp + j), pick(mg));
    _mm_storeu_si128((__m128i*)(rp + j), pick(mr));
  }
#endif
  for (; j < w; ++j) {
    bp[j] = s[3 * j];
    gp[j] = s[3 * j + 1];
    rp[j] = s[3 * j + 2];
  }
}

// Planar math loops: contiguous u8 in / u8 out with constant multipliers,
// auto-vectorized by -O3 -march=native.
inline void y_from_planar(const uint8_t* bp, const uint8_t* gp,
                          const uint8_t* rp, int w, uint8_t* y) {
  for (int j = 0; j < w; ++j) {
    y[j] = (uint8_t)((CRY * rp[j] + CGY * gp[j] + CBY * bp[j] + HALF +
                      (16 << SH)) >>
                     SH);
  }
}

inline void uv_from_planar(const uint8_t* bp, const uint8_t* gp,
                           const uint8_t* rp, int w2, uint8_t* u, uint8_t* v) {
  // inputs are the already-subsampled even columns (w2 = w / 2)
  for (int j = 0; j < w2; ++j) {
    u[j] = (uint8_t)((CRU * rp[j] + CGU * gp[j] + CBU * bp[j] + HALF +
                      (128 << SH)) >>
                     SH);
    v[j] = (uint8_t)((CBU * rp[j] + CGV * gp[j] + CBV * bp[j] + HALF +
                      (128 << SH)) >>
                     SH);
  }
}

// Even-column subsample of a planar u8 row: dst[j] = src[2j].
inline void even_cols(const uint8_t* src, int w2, uint8_t* dst) {
  int j = 0;
#ifdef __SSSE3__
  alignas(16) static const int8_t me[16] = {0, 2, 4,  6,  8,  10, 12, 14,
                                            -1, -1, -1, -1, -1, -1, -1, -1};
  const __m128i m = _mm_load_si128((const __m128i*)me);
  for (; j + 8 <= w2; j += 8) {
    const __m128i x = _mm_loadu_si128((const __m128i*)(src + 2 * j));
    _mm_storel_epi64((__m128i*)(dst + j), _mm_shuffle_epi8(x, m));
  }
#endif
  for (; j < w2; ++j) dst[j] = src[2 * j];
}

struct RowBufs {
  std::vector<uint8_t> b, g, r, b2, g2, r2;
  void ensure(int w) {
    if ((int)b.size() < w) {
      b.resize(w);
      g.resize(w);
      r.resize(w);
      b2.resize(w / 2 + 8);
      g2.resize(w / 2 + 8);
      r2.resize(w / 2 + 8);
    }
  }
};

// Convert one BGR row (w px) to a Y row; when u/v != nullptr also emit
// U/V for the even columns (caller passes them only on even rows).
inline void convert_row(const uint8_t* bgr, int w, RowBufs& rb, uint8_t* y,
                        uint8_t* u, uint8_t* v) {
  rb.ensure(w);
  deinterleave_row(bgr, w, rb.b.data(), rb.g.data(), rb.r.data());
  y_from_planar(rb.b.data(), rb.g.data(), rb.r.data(), w, y);
  if (u != nullptr) {
    const int w2 = w / 2;
    even_cols(rb.b.data(), w2, rb.b2.data());
    even_cols(rb.g.data(), w2, rb.g2.data());
    even_cols(rb.r.data(), w2, rb.r2.data());
    uv_from_planar(rb.b2.data(), rb.g2.data(), rb.r2.data(), w2, u, v);
  }
}

// Convert one full BGR frame into packed I420 planes (h*3/2, w).
inline void convert_frame(const uint8_t* bgr, int h, int w, RowBufs& rb,
                          uint8_t* out) {
  uint8_t* yp = out;
  uint8_t* up = out + (int64_t)h * w;
  uint8_t* vp = up + (int64_t)(h / 2) * (w / 2);
  for (int i = 0; i < h; ++i) {
    const bool even = (i % 2) == 0;
    convert_row(bgr + (int64_t)i * w * 3, w, rb, yp + (int64_t)i * w,
                even ? up + (int64_t)(i / 2) * (w / 2) : nullptr,
                even ? vp + (int64_t)(i / 2) * (w / 2) : nullptr);
  }
}

// cv2 INTER_LINEAR coefficient tables: fixed-point alphas at scale 2048,
// rounded half-to-even (cvRound), with cv2's edge clamping.
//
// For downscales up to ~2.1x both taps of 8 consecutive outputs fall in a
// 16-byte source window, so the horizontal pass precomputes, per 8-output
// chunk, a window base + pshufb mask gathering the (s0, s1) byte pairs +
// 16 int16 weights: one shuffle and one vpmaddwd replace eight scalar
// 2-tap dot products.
struct HChunk {
  int32_t base;
  alignas(16) uint8_t shuf[16];
  alignas(32) int16_t coef[16];
};

struct LinearCoeffs {
  std::vector<int32_t> s0, s1;  // source tap indices
  std::vector<int32_t> a0, a1;  // 2048-scale weights
  std::vector<HChunk> chunks;   // 8-output windows (empty when the scale
                                // is too large for 16-byte windows)
};

LinearCoeffs linear_coeffs(int dst, int src, double scale = 0.0) {
  LinearCoeffs c;
  c.s0.resize(dst);
  c.s1.resize(dst);
  c.a0.resize(dst);
  c.a1.resize(dst);
  if (scale == 0.0) scale = (double)src / dst;
  for (int x = 0; x < dst; ++x) {
    // cv2 computes the fraction in FLOAT32 (resize.cpp: fx = (float)(...)),
    // which snaps values near the 0.5/2048 coefficient boundary -- e.g.
    // 604->476 row 68 rounds 860.5f half-to-even where double math gives
    // 860.504.  Mirror it exactly.
    float fx = (float)((x + 0.5) * scale - 0.5);
    int sx = (int)std::floor(fx);
    fx -= sx;
    if (sx < 0) {
      sx = 0;
      fx = 0.f;
    }
    if (sx >= src - 1) {
      sx = src - 1;
      fx = 0.f;
    }
    c.s0[x] = sx;
    c.s1[x] = sx + 1 < src ? sx + 1 : src - 1;
    // round half to even, like cv2's cvRound
    c.a1[x] = (int32_t)std::nearbyintf(fx * 2048.f);
    c.a0[x] = (int32_t)std::nearbyintf((1.f - fx) * 2048.f);
  }
  // 8-output chunks for the shuffle/madd horizontal pass
  for (int x0 = 0; x0 + 8 <= dst; x0 += 8) {
    HChunk hc;
    hc.base = c.s0[x0];
    bool ok = true;
    for (int k = 0; k < 8; ++k) {
      const int o0 = c.s0[x0 + k] - hc.base, o1 = c.s1[x0 + k] - hc.base;
      if (o1 > 15 || o0 < 0) {
        ok = false;
        break;
      }
      hc.shuf[2 * k] = (uint8_t)o0;
      hc.shuf[2 * k + 1] = (uint8_t)o1;
      hc.coef[2 * k] = (int16_t)c.a0[x0 + k];
      hc.coef[2 * k + 1] = (int16_t)c.a1[x0 + k];
    }
    if (!ok) {
      c.chunks.clear();
      break;
    }
    c.chunks.push_back(hc);
  }
  return c;
}

// Resize one u8 plane with cv2 INTER_LINEAR semantics, writing the result
// into a sub-rectangle of a destination plane of row stride dst_stride.
// Reuses cv2's two-row horizontal cache so each source row is horizontally
// resampled at most once.  ``ensure_row(sy)`` (optional) is invoked before
// a source row is first read -- the fused letterbox converts BGR rows
// lazily so they are still cache-hot here.  Source rows must have 15
// readable bytes past their end (chunked window loads; scratch planes are
// over-allocated).
template <typename EnsureRow>
void resize_u8(const uint8_t* src, int sh, int sw, int dh, int dw,
               const LinearCoeffs& cx, const LinearCoeffs& cy, uint8_t* dst,
               int64_t dst_stride, std::vector<int32_t>& rowbuf,
               EnsureRow&& ensure_row) {
  rowbuf.resize(2 * (size_t)dw);
  int32_t* rows[2] = {rowbuf.data(), rowbuf.data() + dw};
  int cached[2] = {-1, -1};

  auto hresize = [&](int sy, int slot) {
    ensure_row(sy);
    const uint8_t* s = src + (int64_t)sy * sw;
    int32_t* d = rows[slot];
    int x = 0;
#ifdef __AVX2__
    for (size_t ci = 0; ci < cx.chunks.size(); ++ci, x += 8) {
      const HChunk& hc = cx.chunks[ci];
      const __m128i win = _mm_loadu_si128((const __m128i*)(s + hc.base));
      const __m128i pairs =
          _mm_shuffle_epi8(win, _mm_load_si128((const __m128i*)hc.shuf));
      const __m256i p16 = _mm256_cvtepu8_epi16(pairs);
      const __m256i dd = _mm256_madd_epi16(
          p16, _mm256_load_si256((const __m256i*)hc.coef));
      _mm256_storeu_si256((__m256i*)(d + x), dd);
    }
#endif
    for (; x < dw; ++x) {
      d[x] = s[cx.s0[x]] * cx.a0[x] + s[cx.s1[x]] * cx.a1[x];
    }
    cached[slot] = sy;
  };

  for (int y = 0; y < dh; ++y) {
    const int sy0 = cy.s0[y], sy1 = cy.s1[y];
    const int32_t b0 = cy.a0[y], b1 = cy.a1[y];
    int i0 = -1, i1 = -1;
    for (int k = 0; k < 2; ++k) {
      if (cached[k] == sy0) i0 = k;
      if (cached[k] == sy1) i1 = k;
    }
    if (i0 < 0) {
      i0 = (i1 == 0) ? 1 : 0;
      hresize(sy0, i0);
    }
    if (i1 < 0) {
      i1 = (i0 == 0) ? 1 : 0;
      if (sy1 == sy0) {
        i1 = i0;
      } else {
        hresize(sy1, i1);
      }
    }
    const int32_t* r0 = rows[i0];
    const int32_t* r1 = rows[i1];
    uint8_t* d = dst + (int64_t)y * dst_stride;
    // cv2's VResizeLinearVec_32s8u descale (also used by its scalar
    // specialization for 8u): exact for every full 16-wide chunk.
    for (int x = 0; x < dw; ++x) {
      int32_t v = ((b0 * (r0[x] >> 4)) >> 16) + ((b1 * (r1[x] >> 4)) >> 16);
      v = (v + 2) >> 2;
      d[x] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

struct Geom {
  int img_h, img_w, pad_y, pad_x, canvas_h, canvas_w;
};

// One frame of the fused letterbox prescale: BGR rows are converted to
// Y/U/V scratch planes LAZILY, driven by the Y resize's row consumption
// (strictly monotone), so each converted row is still cache-hot when the
// horizontal pass samples it; the chroma planes (1/4 of the bytes) are
// fully populated by the time the Y pass finishes and resize after it.
// Matches host_letterbox_i420's cv2 composition byte-for-byte under the
// caller's gate (downscale, img_w % 32 == 0).
void letterbox_frame(const uint8_t* bgr, int h, int w, const Geom& g,
                     uint8_t y_pad, uint8_t uv_pad, const LinearCoeffs& cxy,
                     const LinearCoeffs& cyy, const LinearCoeffs& cxc,
                     const LinearCoeffs& cyc, RowBufs& rb, uint8_t* scratch,
                     std::vector<int32_t>& rowbuf, uint8_t* out) {
  uint8_t* ys = scratch;
  uint8_t* us = scratch + (int64_t)h * w;
  uint8_t* vs = us + (int64_t)(h / 2) * (w / 2);

  const int ch = g.canvas_h, cw = g.canvas_w;
  uint8_t* yd = out;
  uint8_t* ud = out + (int64_t)ch * cw;
  uint8_t* vd = ud + (int64_t)(ch / 2) * (cw / 2);

  std::memset(yd, y_pad, (size_t)ch * cw);
  std::memset(ud, uv_pad, (size_t)(ch / 2) * (cw / 2));
  std::memset(vd, uv_pad, (size_t)(ch / 2) * (cw / 2));

  int next_row = 0;
  auto convert_upto = [&](int sy) {
    for (; next_row <= sy; ++next_row) {
      const bool even = (next_row % 2) == 0;
      convert_row(bgr + (int64_t)next_row * w * 3, w, rb,
                  ys + (int64_t)next_row * w,
                  even ? us + (int64_t)(next_row / 2) * (w / 2) : nullptr,
                  even ? vs + (int64_t)(next_row / 2) * (w / 2) : nullptr);
    }
  };

  resize_u8(ys, h, w, g.img_h, g.img_w, cxy, cyy,
            yd + (int64_t)g.pad_y * cw + g.pad_x, cw, rowbuf, convert_upto);
  convert_upto(h - 1);  // rows past the last Y tap (bottom crop edge)
  const int64_t coff = (int64_t)(g.pad_y / 2) * (cw / 2) + g.pad_x / 2;
  resize_u8(us, h / 2, w / 2, g.img_h / 2, g.img_w / 2, cxc, cyc, ud + coff,
            cw / 2, rowbuf, [](int) {});
  resize_u8(vs, h / 2, w / 2, g.img_h / 2, g.img_w / 2, cxc, cyc, vd + coff,
            cw / 2, rowbuf, [](int) {});
}

// cv2.resize(src, (dw, dh), INTER_LINEAR) of one uint8 image of cn
// interleaved channels (sh rows of sw pixels, source row stride src_stride
// bytes) into a destination of row stride dst_stride bytes, byte-identical
// to OpenCV at any scale, up or down:
//  - the same size is a copy;
//  - an exact 2x downscale in both axes is cv2's INTER_AREA fast path,
//    (a + b + c + d + 2) >> 2 per channel (cv2 switches INTER_LINEAR to it);
//  - otherwise cv2's fixed-point linear path, scalar: horizontal taps
//    clamped into the row (coefficients too, as cv2 does), vertical
//    coefficients from the UNclamped fraction with only the row indices
//    clamped (cv2 clips the source rows, not the weights), and the
//    vectorized vertical descale.  Every step is exact integer arithmetic,
//    so any row width gives cv2's bytes.  The two horizontally resampled
//    rows in use are cached, as cv2 caches them.
void resize_linear_u8(const uint8_t* src, int sh, int sw, int64_t src_stride,
                      int cn, int dh, int dw, uint8_t* dst, int64_t dst_stride,
                      std::vector<int32_t>& rowbuf) {
  const int row = dw * cn;
  if (sh == dh && sw == dw) {
    for (int y = 0; y < dh; ++y)
      std::memcpy(dst + (int64_t)y * dst_stride, src + y * src_stride,
                  (size_t)row);
    return;
  }
  if (sh == 2 * dh && sw == 2 * dw) {
    for (int y = 0; y < dh; ++y) {
      const uint8_t* r0 = src + (int64_t)(2 * y) * src_stride;
      const uint8_t* r1 = r0 + src_stride;
      uint8_t* d = dst + (int64_t)y * dst_stride;
      for (int x = 0; x < row; ++x) {
        const int j = (x / cn) * 2 * cn + x % cn;
        d[x] = (uint8_t)((r0[j] + r0[j + cn] + r1[j] + r1[j + cn] + 2) >> 2);
      }
    }
    return;
  }
  // cv2 derives the scale from the inverse ratio dst / src
  const LinearCoeffs cx = linear_coeffs(dw, sw, 1.0 / ((double)dw / sw));
  std::vector<int32_t> ys0(dh), ys1(dh), yb0(dh), yb1(dh);
  const double scale_y = 1.0 / ((double)dh / sh);
  for (int y = 0; y < dh; ++y) {
    float fy = (float)((y + 0.5) * scale_y - 0.5);
    const int sy = (int)std::floor(fy);
    fy -= sy;
    ys0[y] = sy < 0 ? 0 : (sy > sh - 1 ? sh - 1 : sy);
    ys1[y] = sy + 1 < 0 ? 0 : (sy + 1 > sh - 1 ? sh - 1 : sy + 1);
    yb1[y] = (int32_t)std::nearbyintf(fy * 2048.f);
    yb0[y] = (int32_t)std::nearbyintf((1.f - fy) * 2048.f);
  }
  rowbuf.resize(2 * (size_t)row);
  int32_t* hr[2] = {rowbuf.data(), rowbuf.data() + row};
  int cached[2] = {-1, -1};
  auto hresize = [&](int sy, int slot) {
    const uint8_t* s = src + sy * src_stride;
    int32_t* d = hr[slot];
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p0 = s + cn * cx.s0[x];
      const uint8_t* p1 = s + cn * cx.s1[x];
      for (int c = 0; c < cn; ++c) d[cn * x + c] = p0[c] * cx.a0[x] + p1[c] * cx.a1[x];
    }
    cached[slot] = sy;
  };
  // the slot holding source row sy, resampled into the slot not holding
  // `keep` when it is not cached
  auto slot_of = [&](int sy, int keep) {
    for (int k = 0; k < 2; ++k)
      if (cached[k] == sy) return k;
    const int k = cached[0] == keep ? 1 : 0;
    hresize(sy, k);
    return k;
  };
  for (int y = 0; y < dh; ++y) {
    const int i0 = slot_of(ys0[y], ys1[y]);
    const int i1 = slot_of(ys1[y], ys0[y]);
    const int32_t* r0 = hr[i0];
    const int32_t* r1 = hr[i1];
    const int32_t b0 = yb0[y], b1 = yb1[y];
    uint8_t* d = dst + (int64_t)y * dst_stride;
    for (int x = 0; x < row; ++x) {
      int32_t v = ((b0 * (r0[x] >> 4)) >> 16) + ((b1 * (r1[x] >> 4)) >> 16);
      v = (v + 2) >> 2;
      d[x] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

}  // namespace

extern "C" {

// Integer-box crops of uint8 BGR frames resized to (gh, gw) as
// cv2.resize(frame[y1:y2, x1:x2], (gw, gh), INTER_LINEAR) gives them.
// frames: one (h, w, 3) frame pointer per frame index; fidx (n,) and
// boxes (n, 4) x1, y1, x2, y2 with 0 <= x1 < x2 <= w, 0 <= y1 < y2 <= h
// (the caller checks both); out (n, gh, gw, 3).
void crops_linear_u8c3(const uint8_t* const* frames, int32_t w,
                       const int32_t* fidx, const int32_t* boxes, int32_t n,
                       int32_t gh, int32_t gw, uint8_t* out, int32_t threads) {
  const int64_t stride = (int64_t)w * 3;
#ifdef _OPENMP
#pragma omp parallel num_threads(threads > 0 ? threads : 1) if (threads > 1)
#endif
  {
    std::vector<int32_t> rowbuf;
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int32_t i = 0; i < n; ++i) {
      const int32_t* b = boxes + 4 * (int64_t)i;
      const uint8_t* src = frames[fidx[i]] + b[1] * stride + (int64_t)b[0] * 3;
      resize_linear_u8(src, b[3] - b[1], b[2] - b[0], stride, 3, gh, gw,
                       out + (int64_t)i * gh * gw * 3, (int64_t)gw * 3, rowbuf);
    }
  }
}

// BGR uint8 (n, h, w, 3) -> packed I420 (n, h*3/2, w); even h, w.
void bgr_to_i420(const uint8_t* bgr, uint8_t* out, int32_t n, int32_t h,
                 int32_t w, int32_t threads) {
#ifdef _OPENMP
#pragma omp parallel num_threads(threads > 0 ? threads : 1) if (threads > 1)
#endif
  {
    RowBufs rb;
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int32_t i = 0; i < n; ++i) {
      convert_frame(bgr + (int64_t)i * h * w * 3, h, w, rb,
                    out + (int64_t)i * (h * 3 / 2) * w);
    }
  }
}

// BGR uint8 (n, h, w, 3) -> letterboxed packed I420 working canvas
// (n, canvas_h*3/2, canvas_w).  Caller gates on downscale geometry with
// img_w % 32 == 0 (Y and chroma widths both multiples of 16).
void letterbox_i420(const uint8_t* bgr, uint8_t* out, int32_t n, int32_t h,
                    int32_t w, int32_t img_h, int32_t img_w, int32_t pad_y,
                    int32_t pad_x, int32_t canvas_h, int32_t canvas_w,
                    int32_t y_pad, int32_t uv_pad, int32_t threads) {
  const Geom g{img_h, img_w, pad_y, pad_x, canvas_h, canvas_w};
  const LinearCoeffs cxy = linear_coeffs(img_w, w);
  const LinearCoeffs cyy = linear_coeffs(img_h, h);
  const LinearCoeffs cxc = linear_coeffs(img_w / 2, w / 2);
  const LinearCoeffs cyc = linear_coeffs(img_h / 2, h / 2);
  const int64_t out_stride = (int64_t)(canvas_h * 3 / 2) * canvas_w;
  // +16: the chunked horizontal pass loads a 16-byte window starting at a
  // row's last tap, reading up to 15 bytes past the final plane row
  const int64_t scratch_sz = (int64_t)(h * 3 / 2) * w + 16;

#ifdef _OPENMP
#pragma omp parallel num_threads(threads > 0 ? threads : 1) if (threads > 1)
#endif
  {
    std::vector<uint8_t> scratch(scratch_sz);
    std::vector<int32_t> rowbuf;
    RowBufs rb;
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int32_t i = 0; i < n; ++i) {
      letterbox_frame(bgr + (int64_t)i * h * w * 3, h, w, g, (uint8_t)y_pad,
                      (uint8_t)uv_pad, cxy, cyy, cxc, cyc, rb, scratch.data(),
                      rowbuf, out + (int64_t)i * out_stride);
    }
  }
}

// BGR uint8 (n, h, w, 3) -> letterboxed packed I420 working canvas
// (n, canvas_h*3/2, canvas_w) for ANY working geometry with the 4:2:0
// placement parity (even offsets and extents, canvas_h % 4 == 0), up- or
// downscaling: each frame converted to I420 planes (cv2.cvtColor
// COLOR_BGR2YUV_I420), then each plane resized onto its padded canvas plane
// (cv2.resize INTER_LINEAR) -- the JAX package's cv2 composition
// (eagle_tpu/ops/preprocess.py::_host_letterbox_i420_cv2), byte for byte.
void letterbox_i420_general(const uint8_t* bgr, uint8_t* out, int32_t n,
                            int32_t h, int32_t w, int32_t img_h, int32_t img_w,
                            int32_t pad_y, int32_t pad_x, int32_t canvas_h,
                            int32_t canvas_w, int32_t y_pad, int32_t uv_pad,
                            int32_t threads) {
  const int64_t out_stride = (int64_t)(canvas_h * 3 / 2) * canvas_w;
  const int ch = canvas_h, cw = canvas_w;
#ifdef _OPENMP
#pragma omp parallel num_threads(threads > 0 ? threads : 1) if (threads > 1)
#endif
  {
    std::vector<uint8_t> planes((size_t)(h * 3 / 2) * w);
    std::vector<int32_t> rowbuf;
    RowBufs rb;
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int32_t i = 0; i < n; ++i) {
      convert_frame(bgr + (int64_t)i * h * w * 3, h, w, rb, planes.data());
      const uint8_t* ys = planes.data();
      const uint8_t* us = ys + (int64_t)h * w;
      const uint8_t* vs = us + (int64_t)(h / 2) * (w / 2);
      uint8_t* yd = out + (int64_t)i * out_stride;
      uint8_t* ud = yd + (int64_t)ch * cw;
      uint8_t* vd = ud + (int64_t)(ch / 2) * (cw / 2);
      std::memset(yd, y_pad, (size_t)ch * cw);
      std::memset(ud, uv_pad, (size_t)(ch / 2) * (cw / 2));
      std::memset(vd, uv_pad, (size_t)(ch / 2) * (cw / 2));
      resize_linear_u8(ys, h, w, w, 1, img_h, img_w,
                       yd + (int64_t)pad_y * cw + pad_x, cw, rowbuf);
      const int64_t coff = (int64_t)(pad_y / 2) * (cw / 2) + pad_x / 2;
      resize_linear_u8(us, h / 2, w / 2, w / 2, 1, img_h / 2, img_w / 2,
                       ud + coff, cw / 2, rowbuf);
      resize_linear_u8(vs, h / 2, w / 2, w / 2, 1, img_h / 2, img_w / 2,
                       vd + coff, cw / 2, rowbuf);
    }
  }
}

// BGR uint8 (n, h, w, 3) -> letterboxed BGR working canvas (n, canvas_h,
// canvas_w, 3): the frame resized to img_h x img_w (cv2.resize
// INTER_LINEAR) at (pad_y, pad_x) on a canvas of `pad` gray, as the JAX
// package's host_letterbox makes it, for any geometry.
void letterbox_bgr(const uint8_t* bgr, uint8_t* out, int32_t n, int32_t h,
                   int32_t w, int32_t img_h, int32_t img_w, int32_t pad_y,
                   int32_t pad_x, int32_t canvas_h, int32_t canvas_w,
                   int32_t pad, int32_t threads) {
  const int64_t out_stride = (int64_t)canvas_h * canvas_w * 3;
#ifdef _OPENMP
#pragma omp parallel num_threads(threads > 0 ? threads : 1) if (threads > 1)
#endif
  {
    std::vector<int32_t> rowbuf;
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int32_t i = 0; i < n; ++i) {
      uint8_t* o = out + (int64_t)i * out_stride;
      std::memset(o, pad, (size_t)out_stride);
      resize_linear_u8(bgr + (int64_t)i * h * w * 3, h, w, (int64_t)w * 3, 3,
                       img_h, img_w, o + ((int64_t)pad_y * canvas_w + pad_x) * 3,
                       (int64_t)canvas_w * 3, rowbuf);
    }
  }
}

}  // extern "C"
