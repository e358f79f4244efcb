// Greedy NMS suppression for Hopper (sm_90a): the whole fixed point of one
// image inside one block, a batch of images in one launch.
//
// Replaces the suppression loop of eagle_tpu/ops/nms.py::nms, the
// lax.while_loop at :95 (vmapped over the batch by batched_nms, :110).  It
// is not a Pallas kernel: XLA runs the loop as one device program with no
// host round trip, which eager torch cannot keep (its exit test is a host
// sync a pass).  It computes what eagle_tpu_torch/ops/nms.py::suppress_plain
// computes, bit for bit:
//
//   - candidate i (a higher score: a lower index) would suppress candidate
//     j when i < j, both are valid and IoU(i, j) > threshold, with the IoU
//     in box_iou_matrix's own operation order: max / min of the corners,
//     the width and height clamped at 0 (a NaN passes, as torch.clamp's),
//     inter = w * h, the two areas (x2 - x1) * (y2 - y1), union =
//     (area_i + area_j) - inter, inter / max(union, 1e-9), each rounded
//     (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn; built with -fmad=false);
//   - keep starts at valid; a pass sets keep[j] = valid[j] and no kept i
//     suppresses j; the loop stops on the first pass that changes nothing,
//     or after k passes (the JAX while_loop's cond).
//
// In: shifted boxes (B, k, 4) float32 contiguous (xyxy, offset by class),
// valid (B, k) bool, the threshold.  Out: keep (B, k) bool.  k <= 1024.
//
// What bounds it on this card: operations, the k (k - 1) / 2 IoUs of an
// image (~20 float32 instructions each: 131,328 pairs at k = 512), not
// bytes (17 B a candidate in, 1 out).  The design computes each IoU once
// and never writes the (k, k) matrix:
//
//   - one block an image, thread j owns candidate j (k <= 1024 threads);
//     the boxes and the valid words are staged in shared memory;
//   - thread j computes its overlap bits against every i < j once, into
//     W = ceil(k / 32) words in registers (W a template parameter, the
//     smallest power of two that covers k is launched); the lanes of a
//     warp read the same box i at once (a shared-memory broadcast);
//   - keep lives in shared memory as k / 32 words; a pass is an AND-OR of
//     a thread's words with them, a __ballot_sync that makes the warp's
//     new word, a barrier, the word written, and a __syncthreads_or of
//     "my word changed": two block barriers a pass, for the few passes a
//     suppression chain needs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 1024;

template <int W>
__global__ void __launch_bounds__(32 * W) nms_suppress(const float* __restrict__ boxes,
                                                       const uint8_t* __restrict__ valid, int k, float thr,
                                                       uint8_t* __restrict__ keep) {
  __shared__ float4 sbox[32 * W];
  __shared__ unsigned svalid[W];
  __shared__ unsigned skeep[W];
  const int b = blockIdx.x;
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const float* bx = boxes + (size_t)b * k * 4;
  if (j < W) {
    svalid[j] = 0u;
    skeep[j] = 0u;
  }
  float4 me = make_float4(0.f, 0.f, 0.f, 0.f);
  bool vj = false;
  if (j < k) {
    me = make_float4(bx[4 * j], bx[4 * j + 1], bx[4 * j + 2], bx[4 * j + 3]);
    vj = valid[(size_t)b * k + j] != 0;
    sbox[j] = me;
  }
  __syncthreads();
  const unsigned vword = __ballot_sync(kFull, vj);
  if (lane == 0) {
    svalid[warp] = vword;
    skeep[warp] = vword;
  }
  __syncthreads();

  const float area_j = __fmul_rn(__fsub_rn(me.z, me.x), __fsub_rn(me.w, me.y));
  unsigned bits[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    unsigned word = 0u;
    if (vj && w <= warp) {
      const unsigned vi = svalid[w];
      for (int bit = 0; bit < 32; ++bit) {
        const int i = 32 * w + bit;
        if (i >= j) break;
        if (!((vi >> bit) & 1u)) continue;
        const float4 a = sbox[i];
        float iw = __fsub_rn(fminf(a.z, me.z), fmaxf(a.x, me.x));
        float ih = __fsub_rn(fminf(a.w, me.w), fmaxf(a.y, me.y));
        iw = iw < 0.f ? 0.f : iw;
        ih = ih < 0.f ? 0.f : ih;
        const float inter = __fmul_rn(iw, ih);
        const float area_i = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
        float uni = __fsub_rn(__fadd_rn(area_i, area_j), inter);
        uni = uni < 1e-9f ? 1e-9f : uni;
        if (__fdiv_rn(inter, uni) > thr) word |= 1u << bit;
      }
    }
    bits[w] = word;
  }

  for (int pass = 0; pass < k; ++pass) {
    unsigned hit = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) hit |= bits[w] & skeep[w];
    const unsigned word = __ballot_sync(kFull, vj && hit == 0u);
    const int changed = word != skeep[warp];
    __syncthreads();  // every read of skeep is done
    if (lane == 0) skeep[warp] = word;
    if (!__syncthreads_or(changed)) break;
  }
  if (j < k) keep[(size_t)b * k + j] = (uint8_t)((skeep[warp] >> lane) & 1u);
}

template <int W>
cudaError_t launch(const float* boxes, const uint8_t* valid, int b, int k, float thr, uint8_t* keep,
                   cudaStream_t stream) {
  nms_suppress<W><<<b, 32 * ((k + 31) / 32), 0, stream>>>(boxes, valid, k, thr, keep);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  boxes: (b, k, 4) float32 contiguous, valid: (b,
// k) bool, on the current device; keep: (b, k) bool.  Launches b blocks of
// 32 * ceil(k / 32) threads on `stream` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for k > 1024).
extern "C" int nms_launch(const float* boxes, const uint8_t* valid, int b, int k, float thr, uint8_t* keep,
                          void* stream) {
  if (b < 0 || k < 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (b == 0 || k == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int words = (k + 31) / 32;
  cudaError_t e;
  if (words <= 1) e = launch<1>(boxes, valid, b, k, thr, keep, s);
  else if (words <= 2) e = launch<2>(boxes, valid, b, k, thr, keep, s);
  else if (words <= 4) e = launch<4>(boxes, valid, b, k, thr, keep, s);
  else if (words <= 8) e = launch<8>(boxes, valid, b, k, thr, keep, s);
  else if (words <= 16) e = launch<16>(boxes, valid, b, k, thr, keep, s);
  else e = launch<32>(boxes, valid, b, k, thr, keep, s);
  return (int)e;
}
