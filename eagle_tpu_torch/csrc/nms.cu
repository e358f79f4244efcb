// Greedy NMS suppression for Hopper (sm_90a): the overlap bits of every
// pair spread over the card, then the fixed point of each image in one
// block; any number of candidates an image, a batch of images a call.
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
// valid (B, k) bool, the threshold, and a workspace of
// nms_workspace_words(B, k) 32-bit words.  Out: keep (B, k) bool.
//
// What bounds it on this card: operations, the k (k - 1) / 2 IoUs of an
// image (~18 float32 instructions each), at the anchor count (10,710) 57
// million pairs an image; at the main path's 16 x 512 the few valid
// candidates (~90 an image) make it a latency chain of two launches.  The
// design spreads the pairs over the card and keeps the fixed point's
// passes short:
//
//   - nms_suppress_overlap: a grid of (W column blocks, Q row groups, B
//     images), W = ceil(k / 32), Q = ceil(W / 32); warp w of block (tj, q)
//     takes the 32 x 32 tile of rows 32 (32 q + w) .. + 31 against columns
//     32 tj .. + 31 (lane = column, the rows' boxes read from shared
//     memory as broadcasts; only tiles on or above the diagonal, and only
//     valid rows), and writes its lane's word of overlap bits over the
//     tile's rows to ov[b][32 q + w][j] when it is not 0; the block then
//     writes, for each column j, the word summary[b][q][j] whose bit w says
//     that ov[b][32 q + w][j] is not 0.  A 0 word is never written nor
//     read, so the workspace needs no clearing;
//   - nms_suppress_fixed_point, launched as a programmatic dependent of the
//     first grid (its blocks set up while that grid runs, then wait on
//     griddepcontrol.wait): one block an image; keep and valid live in
//     shared memory as W words (keep twice, the pass reading one and
//     writing the other, so a pass needs one block barrier: the
//     __syncthreads_or of "a word changed"); thread t owns the columns
//     t + T m, and a pass ANDs each owned column's nonzero overlap words,
//     found through its summary bits, with keep.
//
// Any k from 1 up to the shared memory's 3 W words (~620,000 candidates).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float4 load_box(const float* __restrict__ bx, int i) {
  return make_float4(bx[4 * i], bx[4 * i + 1], bx[4 * i + 2], bx[4 * i + 3]);
}

__device__ __forceinline__ float box_area(float4 a) { return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y)); }

// IoU(a, m) > thr in box_iou_matrix's operation order (a the row, m the column)
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 m, float area_m, float thr) {
  float iw = __fsub_rn(fminf(a.z, m.z), fmaxf(a.x, m.x));
  float ih = __fsub_rn(fminf(a.w, m.w), fmaxf(a.y, m.y));
  iw = iw < 0.f ? 0.f : iw;
  ih = ih < 0.f ? 0.f : ih;
  const float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(area_a, area_m), inter);
  uni = uni < 1e-9f ? 1e-9f : uni;
  // boxes that do not meet (most pairs): 0 / uni is a zero for any uni but
  // NaN, and a zero numerator sends __fdiv_rn down its slow path
  if (inter == 0.f && uni == uni) return 0.f > thr;
  return __fdiv_rn(inter, uni) > thr;
}

__global__ void __launch_bounds__(kMaxThreads) nms_suppress_overlap(const float* __restrict__ boxes,
                                                                   const uint8_t* __restrict__ valid, int k, int nw,
                                                                   int nq, float thr, unsigned* __restrict__ ov,
                                                                   unsigned* __restrict__ summary) {
  __shared__ float4 sbox[32][32];
  __shared__ float sarea[32][32];
  __shared__ unsigned char snz[32][32];
  // let the dependent fixed-point grid start its set-up now
  asm volatile("griddepcontrol.launch_dependents;");
  const int tj = blockIdx.x, q = blockIdx.y, b = blockIdx.z;
  if (32 * q > tj) return;  // no row of the group lies on or above the diagonal (block-uniform)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wi = 32 * q + warp;  // this warp's row block
  const float* bx = boxes + (size_t)b * k * 4;
  const uint8_t* vb = valid + (size_t)b * k;
  const int j = 32 * tj + lane;
  unsigned word = 0u;
  if (wi <= tj) {  // warp-uniform
    // the row's and the column's boxes and valid bytes, all loads in flight together
    const int i = 32 * wi + lane;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 a = i < k ? load_box(bx, i) : zero;
    const float4 me = j < k ? load_box(bx, j) : zero;
    const bool vi = i < k && vb[i] != 0, vj = j < k && vb[j] != 0;
    sbox[warp][lane] = a;
    sarea[warp][lane] = box_area(a);
    unsigned rows = __ballot_sync(kFull, vi);
    __syncwarp();
    if (wi == tj) rows &= (1u << lane) - 1u;  // the diagonal tile: rows i < j only
    if (vj && rows) {
      const float area_me = box_area(me);
      // every lane walks the same ascending rows (a prefix of them on the
      // diagonal), so each read of sbox is a broadcast
      while (rows) {
        const int r = __ffs(rows) - 1;
        rows &= rows - 1u;
        if (overlaps(sbox[warp][r], sarea[warp][r], me, area_me, thr)) word |= 1u << r;
      }
    }
    if (word) ov[((size_t)b * nw + wi) * k + j] = word;
  }
  snz[warp][lane] = word != 0u;
  __syncthreads();
  if (warp == 0 && j < k) {
    unsigned bits = 0u;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) bits |= (unsigned)snz[w][lane] << w;
    summary[((size_t)b * nq + q) * k + j] = bits;
  }
}

__global__ void __launch_bounds__(kMaxThreads) nms_suppress_fixed_point(const uint8_t* __restrict__ valid, int k,
                                                                       int nw, int nq,
                                                                       const unsigned* __restrict__ ov,
                                                                       const unsigned* __restrict__ summary,
                                                                       uint8_t* __restrict__ keep) {
  extern __shared__ unsigned smem[];  // keep (two buffers of nw words), then valid (nw words)
  unsigned* svalid = smem + 2 * nw;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const int owned = (k + blockDim.x - 1) / blockDim.x;  // columns a thread: tid + blockDim.x * m
  const uint8_t* vb = valid + (size_t)b * k;
  const unsigned* ovb = ov + (size_t)b * nw * k;
  const unsigned* sb = summary + (size_t)b * nq * k;
  for (int m = 0; m < owned; ++m) {
    const int j = tid + blockDim.x * m, w = (tid >> 5) + warps * m;
    const unsigned word = __ballot_sync(kFull, j < k && vb[j] != 0);
    if (lane == 0 && w < nw) {
      svalid[w] = word;
      smem[w] = word;
    }
  }
  // launched as a programmatic dependent of nms_suppress_overlap: the block
  // may start while that grid runs, and waits here for its writes
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncthreads();

  int cur = 0;
  for (int pass = 0; pass < k; ++pass) {
    const unsigned* kp = smem + cur * nw;
    unsigned* next = smem + (cur ^ 1) * nw;
    int changed = 0;
    for (int m = 0; m < owned; ++m) {
      const int j = tid + blockDim.x * m, w = (tid >> 5) + warps * m;
      bool kept = false;
      if (j < k && ((svalid[w] >> lane) & 1u)) {
        unsigned hit = 0u;
        for (int q = 0; q <= (w >> 5) && !hit; ++q) {
          unsigned bits = sb[(size_t)q * k + j];
          while (bits) {
            const int wi = 32 * q + __ffs(bits) - 1;
            bits &= bits - 1u;
            hit |= ovb[(size_t)wi * k + j] & kp[wi];
          }
        }
        kept = hit == 0u;
      }
      const unsigned word = __ballot_sync(kFull, kept);
      if (w < nw) {
        if (lane == 0) next[w] = word;
        changed |= word != kp[w];
      }
    }
    cur ^= 1;
    if (!__syncthreads_or(changed)) break;
  }
  const unsigned* kp = smem + cur * nw;
  for (int m = 0; m < owned; ++m) {
    const int j = tid + blockDim.x * m, w = (tid >> 5) + warps * m;
    if (j < k) keep[(size_t)b * k + j] = (uint8_t)((kp[w] >> lane) & 1u);
  }
}

inline int words(int k) { return (k + 31) / 32; }

}  // namespace

// The workspace a call at (b, k) needs, in 32-bit words: the overlap words
// (b, W, k) and the summaries (b, Q, k), W = ceil(k / 32), Q = ceil(W / 32).
extern "C" long long nms_workspace_words(int b, int k) {
  if (b <= 0 || k <= 0) return 0;
  const long long w = words(k), q = (w + 31) / 32;
  return (long long)b * (w + q) * k;
}

// C interface for ctypes.  boxes: (b, k, 4) float32 contiguous, valid: (b,
// k) bool, on the current device; keep: (b, k) bool; workspace:
// nms_workspace_words(b, k) 32-bit words.  Launches nms_suppress_overlap
// then nms_suppress_fixed_point on `stream` and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue where the fixed point's 3 W words do
// not fit in a block's shared memory).
extern "C" int nms_launch(const float* boxes, const uint8_t* valid, int b, int k, float thr, uint8_t* keep,
                          unsigned* workspace, void* stream) {
  if (b < 0 || k < 0 || b > 65535) return (int)cudaErrorInvalidValue;
  if (b == 0 || k == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nw = words(k), nq = (nw + 31) / 32;
  const size_t dyn = (size_t)3 * nw * sizeof(unsigned);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (dyn > (size_t)optin || nq > 65535) return (int)cudaErrorInvalidValue;
  if (dyn > 48 * 1024) {
    e = cudaFuncSetAttribute(nms_suppress_fixed_point, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  unsigned* ov = workspace;
  unsigned* summary = workspace + (size_t)b * nw * k;
  const dim3 grid(nw, nq, b);
  nms_suppress_overlap<<<grid, 32 * (nw < 32 ? nw : 32), 0, s>>>(boxes, valid, k, nw, nq, thr, ov, summary);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the fixed point as a programmatic dependent launch: its blocks start
  // (and read valid) while the overlap grid runs, its launch's latency hidden
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b);
  cfg.blockDim = dim3(32 * nw < kMaxThreads ? 32 * nw : kMaxThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nms_suppress_fixed_point, (const uint8_t*)valid, k, nw, nq, (const unsigned*)ov,
                         (const unsigned*)summary, keep);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
