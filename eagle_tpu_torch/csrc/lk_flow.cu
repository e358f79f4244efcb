// Pyramidal Lucas-Kanade optical flow for Hopper (sm_90a): the whole flow
// step in one launch.
//
// Replaces the TPU kernel eagle_tpu/ops/pallas_flow2.py::lk_flow_pallas2
// (body _make_level_kernel, :78-168, launched once per pyramid level by
// pl.pallas_call at :272) together with the gray conversion, ROI gather and
// pyrDown that run around it, and computes what
// eagle_tpu_torch/ops/optical_flow.py::lk_flow_plain computes: cv2
// calcOpticalFlowPyrLK with a 15x15 window, maxLevel 2, 10 iterations, eps
// 0.03, every sample clamped to the point's level ROI (lk_flow's clamp, not
// the TPU kernel's VMEM window).
//
// In: the two (H, W, 3) uint8 BGR frames, pts (K, 2) float32 (x, y), valid
// (K,) bool.  Out: g (K, 2) float32 and status (K,) = ok & inside & valid,
// where ok is det > 1e-6 of the structure tensor at every level.
//
// Clip-batched: one launch can take C frame pairs, one of each of C clips
// (the JAX package's clip-batched step runs lk_flow_pallas2 under vmap, one
// pallas_call with a leading clip axis).  Then the frames are (C, H, W, 3)
// with one clip stride, pts (C, K, 2), valid (C, K), and the outputs
// follow; the grid is (K, C) and blockIdx.y picks the clip, whose frames
// the third coordinate of the rank-3 tensor maps selects.  Every block does
// exactly what it does in a launch of one pair, so a batched launch gives
// the bytes of C single launches.
//
// One block of 256 threads per point, both frames and all levels inside
// it.  The block:
//  1. Computes the ROI origin with roi_origins' integer arithmetic: floor,
//     centre, clamp to the frame, align down to 2**levels.
//  2. Loads the side x side BGR ROI of each frame by TMA, through a tensor
//     map over the frames viewed as a (C, H, 3W) uint8 array.  A box
//     starts only on a 16-byte boundary of a row and spans at most 256
//     bytes, and the ROI's first byte, 3 * x, is a multiple of 4 only; so
//     each half of the ROI's rows (a band) is three boxes of side/2 rows x
//     cw bytes (cw a multiple of 16, 3 cw >= 3 side + 12) from the 16-byte
//     boundary at or before the ROI's first byte: the ROI lies 0-12 bytes
//     into the first box, and each 4-byte word of it within one box.  The
//     four bands (previous frame, then current) pass through a ring of two
//     slots, one mbarrier each, its phase bit flipped per use: a band is
//     converted while the next is in flight, and a slot is refilled as
//     soon as its band is converted.
//  3. Level 0 of each frame is gray as bgr_to_gray rounds it,
//     rint(fma(r, w2, fma(g, w1, b * w0))), stored as uint8 (an integer in
//     [0, 255]).  Level 1 is pyrDown of it with reflect-101 borders at the
//     ROI's edge, computed exactly in 16-bit integer lanes (the 5-tap sums
//     are integers); levels 2.. are pyrDown in float32 in the plain
//     version's order of operations (exact through level 2).  The levels
//     are written over the band slots once the four bands are converted.
//  4. Every level's 17x17 previous patch (bilinear, hat weights rows then
//     columns), its Scharr gradients and the structure tensor; then, per
//     level, coarse to fine, up to 10 Newton steps that sample the current
//     level.  Every tap is read from shared memory.  The Newton state g
//     lives in every thread's registers: each warp reduces its partials by
//     shuffle into a double-buffered shared array, and after one
//     __syncthreads every thread sums the warp partials in the same order
//     and solves the 2x2 system itself, so all threads hold identical
//     values and the freeze test leaves the loop for the whole block at
//     once.  One barrier a step.
//
// What bounds it on this card: latency.  The work at K = 57 on a 544x960
// canvas is ~3.1 MB of ROI bytes and ~41 M float32 instructions (gray,
// pyrDown and the Newton steps), ~1.2 us at the card's peaks,
// while each point walks a dependent chain: its band loads, the pyramids,
// then three levels of up to 10 block-wide reductions.  The design keeps
// that chain in one launch and on chip: each ROI is read once from device
// memory by TMA, the next band loads while one is converted, nothing
// intermediate goes back to device memory (207,120 B of shared memory a
// block at side 192, one block an SM), and a Newton step costs one
// barrier.
//
// No tensor cores: the work is 4-tap gathers and 225-element reductions,
// with no product large enough for wgmma, and TF32 or bf16 arithmetic
// would break the bit-equal status against the plain version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// contraction of a*b+c: every product and sum rounds like the plain
// version's separate operations; the gray's fused multiply-adds are
// explicit).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 4;   // pyramid levels incl. level 0
constexpr int kUnit = 16;       // TMA's alignment: a box starts on a 16-byte boundary
constexpr int kBoxes = 3;       // boxes across a band
constexpr int kAlign = 128;     // TMA destinations and every smem array
constexpr int kRedStride = 4;   // floats a warp writes per reduction (one float4)
constexpr int kMaxTaps = 4;     // window taps a thread holds: window <= 31

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Offsets (bytes) into a block's dynamic shared memory, from side, levels
// and window alone; the host sizes the launch with the same struct.  Frame
// f's (0 previous, 1 current) level 0 starts at gray_off + f * gray_frame,
// its level l >= 1 at level_off[l] + f * level_frame.
struct Layout {
  int side, levels, window;
  int band_rows;    // side / 2: rows of a band
  int box_bytes;    // cw: a box's width, round_up(ceil((3 side + 12) / 3), 16)
  int tile_bytes;   // one box of a band in shared memory (band_rows x cw, 128-B aligned)
  int slot_bytes;   // one band: kBoxes tiles
  int sizes[kMaxLevels];
  int level_off[kMaxLevels];  // levels >= 1: float32 s x s, over the band slots
  int level_frame;  // bytes of one frame's levels >= 1
  int gray_off;     // level 0: uint8 side x side
  int gray_frame;   // bytes of one frame's level 0
  int pext_off;     // every level's previous patch, (window + 2)^2 floats each
  int taps_off;     // per level: the taps' interior, gx, gy (window^2 floats each)
  int taps_stride;  // bytes of one level's taps
  int red_off;      // 2 x kWarps x kRedStride floats
  int bar_off;      // 2 mbarriers, one a band slot
  int total;        // bytes, without the alignment slack
};

__host__ __device__ inline Layout make_layout(int side, int levels, int window) {
  Layout L;
  L.side = side;
  L.levels = levels;
  L.window = window;
  L.band_rows = side / 2;
  L.box_bytes = round_up((3 * side + 12 + kBoxes - 1) / kBoxes, kUnit);
  L.tile_bytes = round_up(L.band_rows * L.box_bytes, kAlign);
  L.slot_bytes = kBoxes * L.tile_bytes;
  int s = side, off = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    L.sizes[l] = s;
    L.level_off[l] = 0;
    if (l >= 1 && l <= levels) {
      L.level_off[l] = off;
      off += round_up(s * s * 4, kAlign);
    }
    s = (s + 1) / 2;
  }
  L.level_frame = off;
  const int region = 2 * off > 2 * L.slot_bytes ? 2 * off : 2 * L.slot_bytes;
  const int ext = window + 2;
  L.gray_off = region;
  L.gray_frame = round_up(side * side, kAlign);
  L.pext_off = L.gray_off + 2 * L.gray_frame;
  L.taps_off = L.pext_off + round_up(kMaxLevels * ext * ext * 4, kAlign);
  L.taps_stride = round_up(3 * window * window * 4, kAlign);
  L.red_off = L.taps_off + (levels + 1) * L.taps_stride;
  L.bar_off = L.red_off + round_up(2 * kWarps * kRedStride * 4, kAlign);
  L.total = L.bar_off + 2 * 8;
  return L;
}

// ---- TMA and mbarrier ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the box at (byte x, row y) of frame `clip` of a (C, H, 3W) frames map; x a
// multiple of 16
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, int x, int y, int clip,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(clip), "r"(smem_u32(bar))
      : "memory");
}

// ---- arithmetic ------------------------------------------------------------

// byte j of w as an exact float: 2^23 + b has b in its low mantissa bits
__device__ __forceinline__ float byte_f(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | j)) - 8388608.f;
}

__device__ __forceinline__ float ld(uint8_t v) { return (float)v; }
__device__ __forceinline__ float ld(float v) { return v; }

// bgr_to_gray's rounding; the returned word holds the gray byte in its low
// 8 bits (adding 2^23 rounds a float in [0, 2^23) to the nearest integer,
// ties to even, as rint does, and leaves it in the low mantissa bits)
__device__ __forceinline__ uint32_t gray_word(float b, float g, float r) {
  const float acc = __fmaf_rn(r, 0.299f, __fmaf_rn(g, 0.587f, __fmul_rn(b, 0.114f)));
  return __float_as_uint(__fadd_rn(acc, 8388608.f));
}

__device__ __forceinline__ int reflect101(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

// ROI start on one axis (roi_origins): floor(p) - side/2 in int64 (wrapping
// as torch's int64 does), clamped to [0, max(0, limit - side)], aligned
// down to a multiple of 2**levels
__device__ __forceinline__ int roi_start(float p, int limit, int side, int levels) {
  const long long fl = (long long)floorf(p);
  const long long a = (long long)((unsigned long long)fl - (unsigned long long)(side / 2));
  const long long hi = limit - side > 0 ? limit - side : 0;
  const long long c = a < 0 ? 0 : (a > hi ? hi : a);
  return (int)((c >> levels) << levels);
}

// Bilinear sample of an s x s level at (py, px), both clamped to [0, s-1]:
// the hat-function weights 1 - |p - grid| of the two neighbouring grid
// lines, rows first, then columns
template <typename T>
__device__ __forceinline__ float sample(const T* img, int s, float py, float px) {
  const float hi = (float)(s - 1);
  py = fminf(fmaxf(py, 0.f), hi);
  px = fminf(fmaxf(px, 0.f), hi);
  const float fy = floorf(py);
  const float fx = floorf(px);
  const int y0 = (int)fy;
  const int x0 = (int)fx;
  const int y1 = min(y0 + 1, s - 1);
  const int x1 = min(x0 + 1, s - 1);
  const float wy0 = 1.f - fabsf(py - fy);
  const float wy1 = fmaxf(0.f, 1.f - fabsf(py - (fy + 1.f)));
  const float wx0 = 1.f - fabsf(px - fx);
  const float wx1 = fmaxf(0.f, 1.f - fabsf(px - (fx + 1.f)));
  const float c0 = wy0 * ld(img[y0 * s + x0]) + wy1 * ld(img[y1 * s + x0]);
  const float c1 = wy0 * ld(img[y0 * s + x1]) + wy1 * ld(img[y1 * s + x1]);
  return c0 * wx0 + c1 * wx1;
}

// Block-wide sums of N values per thread, returned to every thread in v.
// Each warp reduces by shuffle (offsets 16..1) and its lane 0 writes the
// warp's partials into buffer `buf` of red; after one barrier every thread
// adds the partials of the first nw warps, in warp order (the warps past
// them hold no taps, and adding their zeros would change no sum).  The
// buffers alternate between calls, so a warp that runs ahead cannot
// overwrite partials still being read: it writes a buffer again only after
// the next call's barrier.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float4* red, int& buf, int nw) {
  static_assert(N <= 4, "a warp's partials fill one float4");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[n] += __shfl_down_sync(0xffffffffu, v[n], off);
  }
  float4* r = red + buf * kWarps;
  if (lane == 0) {
    float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < N; ++n) q[n] = v[n];
    r[warp] = make_float4(q[0], q[1], q[2], q[3]);
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < nw) {
      const float4 q = r[w];
      const float p[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int n = 0; n < N; ++n) v[n] += p[n];
    }
  }
  buf ^= 1;
}

// Output rows of one pyrDown task: about `per_thread` tasks a thread over
// a level of `cols` task columns and `rows` output rows (runs of >= 2 rows).
__device__ __forceinline__ int pyr_run(int rows, int cols, int per_thread) {
  return max(2, (rows * cols + per_thread * kThreads - 1) / (per_thread * kThreads));
}

// Level 1 from the uint8 gray (s x s, s a multiple of 4), exactly: the
// 5-tap [1 4 6 4 1] sums are integers (rows <= 4080, then columns <=
// 65280), so the level is their sum / 256, which is what pyr_down's
// float32 passes give.  A word of 4 gray bytes yields the row sums of two
// outputs (x = 2m, 2m+1), one in each 16-bit lane, and the column pass
// adds those packed words lane by lane (no lane reaches 2^16).  A task is
// one word column over a run of output rows, sliding the five packed row
// sums down two input rows at a time.
__device__ void pyr_down_gray(const uint8_t* gray, int s, float* dst) {
  const int sd = s / 2;
  const int words = s / 4;
  const int run = pyr_run(sd, words, 3);
  const int tasks = words * ((sd + run - 1) / run);
  const uint32_t* img = reinterpret_cast<const uint32_t*>(gray);
  float2* out = reinterpret_cast<float2*>(dst);
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int m = task % words;
    const int y0 = task / words * run;
    const int y1 = min(sd, y0 + run);
    auto row2 = [&](int r) -> uint32_t {
      const uint32_t* p = img + reflect101(r, s) * words;
      const uint32_t c = p[m];  // columns 4m .. 4m+3
      // bytes 2, 3: columns 4m-2, 4m-1 (reflected to 4m+2, 4m+1 at m = 0)
      const uint32_t l = m > 0 ? p[m - 1] : __byte_perm(c, 0u, 0x1200u);
      // byte 0: column 4m+4 (reflected to 4m+2 at the right edge)
      const uint32_t rt = m + 1 < words ? p[m + 1] : c >> 16;
      const uint32_t t0 = __byte_perm(l, c, 0x0402u) & 0x00FF00FFu;  // (4m-2, 4m)
      const uint32_t t1 = __byte_perm(l, c, 0x0503u) & 0x00FF00FFu;  // (4m-1, 4m+1)
      const uint32_t t2 = __byte_perm(c, 0u, 0x4240u);                 // (4m, 4m+2)
      const uint32_t t3 = __byte_perm(c, 0u, 0x4341u);                 // (4m+1, 4m+3)
      const uint32_t t4 = __byte_perm(c, rt, 0x0402u) & 0x00FF00FFu;  // (4m+2, 4m+4)
      return t0 + t4 + 4u * (t1 + t3) + 6u * t2;
    };
    uint32_t h0 = row2(2 * y0 - 2), h1 = row2(2 * y0 - 1), h2 = row2(2 * y0);
    for (int y = y0; y < y1; ++y) {
      const uint32_t h3 = row2(2 * y + 1);
      const uint32_t h4 = row2(2 * y + 2);
      const uint32_t v = h0 + h4 + 4u * (h1 + h3) + 6u * h2;
      out[(y * sd) / 2 + m] = make_float2((float)(v & 0xFFFFu) * (1.f / 256.f), (float)(v >> 16) * (1.f / 256.f));
      h0 = h2;
      h1 = h3;
      h2 = h4;
    }
  }
}

// pyrDown of a float s x s level into (s+1)/2 x (s+1)/2, as pyr_down
// computes it: 5-tap [1 4 6 4 1] rows, /16, then the same on columns, with
// reflect-101 borders (exact for level 2: multiples of 2^-16 below 256).
// A task is one output column over a run of output rows, sliding the five
// row sums down two rows at a time.
__device__ void pyr_down_float(const float* img, int s, float* out) {
  const int sd = (s + 1) / 2;
  const int run = pyr_run(sd, sd, 2);
  const int tasks = sd * ((sd + run - 1) / run);
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int x = task % sd;
    const int y0 = task / sd * run;
    const int y1 = min(sd, y0 + run);
    const int c0 = reflect101(2 * x - 2, s), c1 = reflect101(2 * x - 1, s), c2 = 2 * x;
    const int c3 = reflect101(2 * x + 1, s), c4 = reflect101(2 * x + 2, s);
    auto row5 = [&](int r) {
      const float* p = img + reflect101(r, s) * s;
      return ((((p[c0] + 4.f * p[c1]) + 6.f * p[c2]) + 4.f * p[c3]) + p[c4]) * 0.0625f;
    };
    float h0 = row5(2 * y0 - 2), h1 = row5(2 * y0 - 1), h2 = row5(2 * y0);
    for (int y = y0; y < y1; ++y) {
      const float h3 = row5(2 * y + 1);
      const float h4 = row5(2 * y + 2);
      out[y * sd + x] = ((((h0 + 4.f * h1) + 6.f * h2) + 4.f * h3) + h4) * 0.0625f;
      h0 = h2;
      h1 = h3;
      h2 = h4;
    }
  }
}

// The (window+2)^2 previous patch around the point on every level, their
// Scharr gradients and structure tensors, in the plain version's order,
// sampled in one pass (one barrier).  The taps' interior values and
// gradients go to `taps` (3 x window^2 floats a level, `taps_stride` bytes
// apart; thread tid writes taps tid, tid + kThreads, ..., the ones it reads
// in newton_level) and every thread gets the tensors (g11, g12, g22) in
// `tensors`.
__device__ __forceinline__ void previous_patches(const Layout& L, const unsigned char* smem, int ox, int oy,
                                                 float ptx, float pty, float* s_pext, float4* red, int& buf,
                                                 float* taps, float4 (&tensors)[kMaxLevels]) {
  const int tid = threadIdx.x;
  const int window = L.window;
  const int ext = window + 2;
  const int n_ext = ext * ext;
  const int n_win = window * window;
  const int stride = L.taps_stride / 4;
  const float half = (float)(window - 1) * 0.5f;
  const float sm[3] = {0.1875f, 0.625f, 0.1875f};  // Scharr smoothing / 16
  const float dv[3] = {-0.5f, 0.f, 0.5f};          // central difference / 2
  const uint8_t* gray = smem + L.gray_off;  // the previous frame's levels

#pragma unroll
  for (int lvl = 0; lvl < kMaxLevels; ++lvl) {
    if (lvl > L.levels) continue;
    const int s = L.sizes[lvl];
    const float scale = (float)(1 << lvl);
    const float sy = (pty / scale - (float)oy / scale) - (half + 1.f);
    const float sx = (ptx / scale - (float)ox / scale) - (half + 1.f);
    const float* lv = reinterpret_cast<const float*>(smem + L.level_off[lvl]);
    for (int t = tid; t < n_ext; t += kThreads) {
      const int i = t / ext;
      const int j = t - i * ext;
      s_pext[lvl * n_ext + t] = lvl == 0 ? sample(gray, s, sy + (float)i, sx + (float)j)
                                         : sample(lv, s, sy + (float)i, sx + (float)j);
    }
  }
  __syncthreads();

#pragma unroll
  for (int lvl = 0; lvl < kMaxLevels; ++lvl) {
    if (lvl > L.levels) continue;
    const float* pe = s_pext + lvl * n_ext;
    float* lt = taps + lvl * stride;
    float acc[3] = {0.f, 0.f, 0.f};
    for (int t = tid; t < n_win; t += kThreads) {
      const int i = t / window;
      const int j = t - i * window;
      float gx = 0.f, gy = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float rx = 0.f, ry = 0.f;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const float p = pe[(i + a) * ext + (j + b)];
          rx = rx + dv[b] * p;
          ry = ry + sm[b] * p;
        }
        gx = gx + sm[a] * rx;
        gy = gy + dv[a] * ry;
      }
      lt[t] = pe[(i + 1) * ext + (j + 1)];
      lt[n_win + t] = gx;
      lt[2 * n_win + t] = gy;
      acc[0] += gx * gx;
      acc[1] += gx * gy;
      acc[2] += gy * gy;
    }
    block_sum<3>(acc, red, buf, min(kWarps, (n_win + 31) / 32));
    tensors[lvl] = make_float4(acc[0], acc[1], acc[2], 0.f);
  }
}

// One level: the Newton steps on the current level from the guess g (x,
// y), updated in place, with the level's previous taps and tensor.  Each
// thread keeps its taps (t = tid + m * kThreads) in registers for the
// level.  Returns whether the structure tensor was invertible.
template <typename T>
__device__ __forceinline__ bool newton_level(const T* curr, int s, int window, const float* taps, float4 tensor,
                                             float4* red, int& buf, float ox, float oy, float& gx_io,
                                             float& gy_io, int iterations, float eps_sq) {
  const int tid = threadIdx.x;
  const int n_win = window * window;
  const int nw = min(kWarps, (n_win + 31) / 32);  // warps that hold taps
  const float half = (float)(window - 1) * 0.5f;
  const float g11 = tensor.x, g12 = tensor.y, g22 = tensor.z;
  const float det = g11 * g22 - g12 * g12;
  if (!(det > 1e-6f)) return false;  // a singular point takes no steps

  float pi[kMaxTaps], tgx[kMaxTaps], tgy[kMaxTaps], ti[kMaxTaps], tj[kMaxTaps];
#pragma unroll
  for (int m = 0; m < kMaxTaps; ++m) {
    const int t = tid + m * kThreads;
    pi[m] = tgx[m] = tgy[m] = ti[m] = tj[m] = 0.f;
    if (t < n_win) {
      const int i = t / window;
      pi[m] = taps[t];
      tgx[m] = taps[n_win + t];
      tgy[m] = taps[2 * n_win + t];
      ti[m] = (float)i;
      tj[m] = (float)(t - i * window);
    }
  }

  float gx = gx_io, gy = gy_io;
  for (int it = 0; it < iterations; ++it) {
    const float cy = (gy - oy) - half;
    const float cx = (gx - ox) - half;
    float bb[2] = {0.f, 0.f};
#pragma unroll
    for (int m = 0; m < kMaxTaps; ++m) {
      if (tid + m * kThreads < n_win) {
        const float diff = sample(curr, s, cy + ti[m], cx + tj[m]) - pi[m];
        bb[0] += diff * tgx[m];
        bb[1] += diff * tgy[m];
      }
    }
    block_sum<2>(bb, red, buf, nw);
    const float b1 = bb[0], b2 = bb[1];
    const float dx = -(g22 * b1 - g12 * b2) / det;
    const float dy = -(-g12 * b1 + g11 * b2) / det;
    gx = gx + dx;
    gy = gy + dy;
    // cv2 TERM_CRITERIA_EPS: the step is applied, then the point freezes
    if (dx * dx + dy * dy <= eps_sq) break;
  }
  gx_io = gx;
  gy_io = gy;
  return true;
}

__global__ void __launch_bounds__(kThreads, 1)
lk_flow_fused(const __grid_constant__ CUtensorMap prev_map, const __grid_constant__ CUtensorMap curr_map,
              const float* __restrict__ pts, const uint8_t* __restrict__ valid, float* __restrict__ out_g,
              uint8_t* __restrict__ out_status, const Layout L, int h, int w, int iterations, float epsilon) {
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic on the shared array, so that the compiler
  // keeps every access derived from it in the shared window (LDS/STS)
  unsigned char* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const int tid = threadIdx.x;
  const int clip = blockIdx.y;
  const int k = clip * gridDim.x + blockIdx.x;  // the point's row of (C, K) pts and outputs
  const int side = L.side;
  const int levels = L.levels;
  const float ptx = pts[2 * k];
  const float pty = pts[2 * k + 1];
  const int ox = roi_start(ptx, w, side, levels);
  const int oy = roi_start(pty, h, side, levels);

  // ---- the ROI pair in: four bands through two slots ------------------------
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  const int x0 = 3 * ox / kUnit * kUnit;  // the first box's byte column
  const int lead = 3 * ox - x0;           // the ROI's offset into it: 0, 4, 8 or 12
  // band j: frame j / 2 (0 previous, 1 current), rows (j % 2) * band_rows..,
  // into slot j % 2 on that slot's barrier (issued by one thread)
  auto load_band = [&](int j) {
    const CUtensorMap* map = j < 2 ? &prev_map : &curr_map;
    const int slot = j % 2;
    mbar_expect_tx(&bar[slot], kBoxes * L.band_rows * L.box_bytes);
    for (int i = 0; i < kBoxes; ++i) {
      tma_load_box(smem + slot * L.slot_bytes + i * L.tile_bytes, map, x0 + i * L.box_bytes,
                   oy + slot * L.band_rows, clip, &bar[slot]);
    }
  };
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the inits, visible to the async proxy
    load_band(0);
    load_band(1);
  }
  __syncthreads();  // the barriers are initialised

  // a thread converts 4 pixels (3 words) of one column group in every
  // rows_step-th row of a band; each word lies within one box
  const int groups = side / 4;
  const int rows_step = kThreads / groups;
  const int my_group = tid % groups;
  const int my_row = tid / groups;
  int word_at[3];  // the group's words: tile offset + column in the tile
  for (int i = 0; i < 3; ++i) {
    const int byte = lead + 12 * my_group + 4 * i;
    word_at[i] = byte / L.box_bytes * L.tile_bytes + byte % L.box_bytes;
  }
  const int c = my_group * 4;
  for (int j = 0; j < 4; ++j) {
    const unsigned char* slot = smem + (j % 2) * L.slot_bytes;
    mbar_wait(&bar[j % 2], j / 2);  // a slot's second band completes its barrier's second phase
    uint8_t* dst = smem + L.gray_off + (j / 2) * L.gray_frame + (j % 2) * L.band_rows * side;
#pragma unroll 4
    for (int r = my_row; my_row < rows_step && r < L.band_rows; r += rows_step) {
      const unsigned char* row = slot + r * L.box_bytes;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(row + word_at[0]);  // B G R B
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(row + word_at[1]);  // G R B G
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(row + word_at[2]);  // R B G R
      const uint32_t q0 = gray_word(byte_f(w0, 0), byte_f(w0, 1), byte_f(w0, 2));
      const uint32_t q1 = gray_word(byte_f(w0, 3), byte_f(w1, 0), byte_f(w1, 1));
      const uint32_t q2 = gray_word(byte_f(w1, 2), byte_f(w1, 3), byte_f(w2, 0));
      const uint32_t q3 = gray_word(byte_f(w2, 1), byte_f(w2, 2), byte_f(w2, 3));
      *reinterpret_cast<uint32_t*>(dst + r * side + c) =
          __byte_perm(__byte_perm(q0, q1, 0x0040u), __byte_perm(q2, q3, 0x0040u), 0x5410u);
    }
    __syncthreads();  // the slot is read (after band 3: level 0 of both frames is complete)
    if (j < 2 && tid == 0) {
      // the block's reads of the slot come before the async proxy's refill
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_band(j + 2);
    }
  }

  // ---- pyramid levels 1.. of both frames, over the band slots (unrolled:
  // L's arrays are read at constant indices, straight from the parameter
  // bank) -------------------------------------------------------------------
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l <= levels) {
      for (int f = 0; f < 2; ++f) {
        float* dst = reinterpret_cast<float*>(smem + L.level_off[l] + f * L.level_frame);
        if (l == 1) {
          pyr_down_gray(smem + L.gray_off + f * L.gray_frame, L.sizes[0], dst);
        } else {
          pyr_down_float(reinterpret_cast<const float*>(smem + L.level_off[l - 1] + f * L.level_frame),
                         L.sizes[l - 1], dst);
        }
      }
      __syncthreads();
    }
  }

  // ---- the previous patches of every level --------------------------------
  float4* red = reinterpret_cast<float4*>(smem + L.red_off);
  float* taps = reinterpret_cast<float*>(smem + L.taps_off);
  float4 tensors[kMaxLevels];
  int buf = 0;
  previous_patches(L, smem, ox, oy, ptx, pty, reinterpret_cast<float*>(smem + L.pext_off), red, buf, taps,
                   tensors);

  // ---- Newton iterations on the current frame, coarse to fine --------------
  const uint8_t* gray = smem + L.gray_off + L.gray_frame;
  const float eps_sq = epsilon * epsilon;
  const float top = (float)(1 << levels);
  float gx = ptx / top;
  float gy = pty / top;
  bool ok = true;
#pragma unroll
  for (int lvl = kMaxLevels - 1; lvl >= 0; --lvl) {
    if (lvl > levels) continue;
    const int s = L.sizes[lvl];
    const float scale = (float)(1 << lvl);
    if (lvl < levels) {
      gx = gx * 2.f;
      gy = gy * 2.f;
    }
    const float* lt = taps + lvl * (L.taps_stride / 4);
    const float lox = (float)ox / scale, loy = (float)oy / scale;
    if (lvl == 0) {
      ok &= newton_level(gray, s, L.window, lt, tensors[lvl], red, buf, lox, loy, gx, gy, iterations, eps_sq);
    } else {
      ok &= newton_level(reinterpret_cast<const float*>(smem + L.level_off[lvl] + L.level_frame), s, L.window, lt,
                         tensors[lvl], red, buf, lox, loy, gx, gy, iterations, eps_sq);
    }
  }

  if (tid == 0) {
    const bool inside = gx >= 0.f && gx <= (float)(w - 1) && gy >= 0.f && gy <= (float)(h - 1);
    out_g[2 * k] = gx;
    out_g[2 * k + 1] = gy;
    out_status[k] = (ok && inside && valid[k]) ? 1 : 0;
  }
}

// ---- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// Error codes besides cudaError_t (> 0): the driver entry point is missing,
// the layout does not fit the card's shared memory, or the tensor map was
// refused (kErrEncode - CUresult).
constexpr int kErrNoEncode = -1;
constexpr int kErrSmem = -2;
constexpr int kErrEncode = -1000;

// Shared memory one block needs (bytes), alignment slack included.
extern "C" int lk_flow_smem_bytes(int side, int levels, int window) {
  return make_layout(side, levels, window).total + kAlign;
}

// C interface for ctypes.  prev/curr: `clips` frames each, frame c at
// c * clip_stride bytes from the pointer, of h rows of w BGR uint8 pixels,
// 16-byte aligned, rows `pitch` bytes apart (a multiple of 16, at least 3w;
// the bytes past 3w are never read); clip_stride a multiple of 16, at least
// h * pitch (any value when clips == 1); pts (clips, k, 2) float32; valid
// (clips, k) bool; out_g (clips, k, 2) float32; out_status (clips, k) bool.
// side: the ROI side (roi_side(h, w), a multiple of 4, at most 192 so that
// a box's width and a band's rows stay within TMA's 256 a dimension).
// Launches one block per point and clip on `stream` and returns
// cudaGetLastError() (0 on success) or one of the codes above.
extern "C" int lk_flow_fused_launch(const uint8_t* prev, const uint8_t* curr, int h, int w, int pitch,
                                    long long clip_stride, int clips, const float* pts, const uint8_t* valid,
                                    float* out_g, uint8_t* out_status, int k, int side, int levels, int window,
                                    int iterations, float epsilon, void* stream) {
  if (k <= 0 || clips <= 0) return 0;
  if (clips == 1) clip_stride = (long long)h * pitch;
  if (levels < 0 || levels >= kMaxLevels || side < 4 || side > 192 || side % 4 != 0 || window < 1 ||
      window * window > kMaxTaps * kThreads || pitch < 3 * w || pitch % 16 != 0 || clips > 65535 ||
      clip_stride % 16 != 0 || clip_stride < (long long)h * pitch) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = make_layout(side, levels, window);
  const int smem = L.total + kAlign;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > optin) return kErrSmem;
  static int attr_set[64] = {0};
  if (dev < 64 && attr_set[dev] < smem) {
    e = cudaFuncSetAttribute(lk_flow_fused, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = smem;
  }

  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  CUtensorMap maps[2];
  const uint8_t* frames[2] = {prev, curr};
  const cuuint64_t dims[3] = {(cuuint64_t)3 * w, (cuuint64_t)h, (cuuint64_t)clips};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch, (cuuint64_t)clip_stride};
  const cuuint32_t box[3] = {(cuuint32_t)L.box_bytes, (cuuint32_t)L.band_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  for (int f = 0; f < 2; ++f) {
    CUresult r = encode(&maps[f], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<uint8_t*>(frames[f]), dims, strides,
                        box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kErrEncode - (int)r;
  }
  lk_flow_fused<<<dim3(k, clips), kThreads, smem, (cudaStream_t)stream>>>(maps[0], maps[1], pts, valid, out_g,
                                                                             out_status, L, h, w, iterations, epsilon);
  return (int)cudaGetLastError();
}
