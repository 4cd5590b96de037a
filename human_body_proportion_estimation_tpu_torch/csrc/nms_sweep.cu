// Greedy NMS keep-mask sweep, one image per block.
//
// Replaces: human_body_proportion_estimation_tpu/ops/pallas_kernels.py:151
//   (`nms_sweep_pallas_batched`, body `_nms_sweep_kernel` :105-147; the
//   single-image `nms_sweep_pallas` :190 is the same kernel at B = 1).
// Computes, per image: over K boxes (xyxy, sorted by descending score) the
//   K x K overlap matrix, then a row sweep in which box i is kept iff
//   score_i > 0 and no earlier kept box overlaps it.
// Overlap test: IoU > t in the division form of ops/boxes.box_iou,
//   inter / max(union, 1e-12) > t, as the JAX path's `ops/nms.nms_mask`
//   tests it (efficientdet.py:399). The Pallas kernel's `inter > t * union`
//   can disagree with it by one rounding at IoU ~= t. Every product, sum
//   and quotient below is an explicit round-to-nearest intrinsic so that
//   nvcc cannot contract them into FMAs and round differently from the
//   plain version.
// Bound on the H100: latency. The work is K^2 IoUs (16K at K = 128) and
//   K inherently sequential sweep steps; bytes and operations both bound it
//   below a microsecond, so the sweep's dependent steps set the time.
// Design: the overlap matrix is computed by all threads in parallel, one
//   row per thread, and stored as bitmask rows in shared memory (K / 32
//   u32 words a row). One warp then sweeps: lane w owns keep word w, and
//   each step is one AND + one warp vote, with no trip to device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 256;
constexpr int kWords = kMaxK / 32;

__device__ __forceinline__ float area_of(float x1, float y1, float x2,
                                         float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                   fmaxf(__fsub_rn(y2, y1), 0.0f));
}

__global__ void nms_sweep_kernel(const float *__restrict__ boxes,
                                 const float *__restrict__ scores,
                                 uint8_t *__restrict__ keep_out, int k,
                                 float thres) {
  __shared__ float4 s_box[kMaxK];
  __shared__ float s_area[kMaxK];
  __shared__ uint32_t s_ov[kMaxK][kWords];
  const int img = blockIdx.x;
  const float *b = boxes + (size_t)img * k * 4;
  const int words = (k + 31) / 32;

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float4 v = make_float4(b[4 * i], b[4 * i + 1], b[4 * i + 2],
                           b[4 * i + 3]);
    s_box[i] = v;
    s_area[i] = area_of(v.x, v.y, v.z, v.w);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float4 bi = s_box[i];
    const float ai = s_area[i];
    for (int wd = 0; wd < words; ++wd) {
      uint32_t bits = 0;
      for (int t = 0; t < 32; ++t) {
        const int j = wd * 32 + t;
        if (j >= k) break;
        const float4 bj = s_box[j];
        const float iw = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)),
                               0.0f);
        const float ih = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)),
                               0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float uni = __fsub_rn(__fadd_rn(ai, s_area[j]), inter);
        const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-12f));
        if (iou > thres) bits |= 1u << t;
      }
      s_ov[i][wd] = bits;
    }
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float *sc = scores + (size_t)img * k;
    // initial keep: score > 0 (dead padding rows start suppressed)
    uint32_t keep = 0;
    if (lane < words) {
      for (int t = 0; t < 32; ++t) {
        const int j = lane * 32 + t;
        if (j < k && sc[j] > 0.0f) keep |= 1u << t;
      }
    }
    for (int i = 1; i < k; ++i) {
      // bits of boxes j < i in this lane's word
      const int lo = lane * 32;
      uint32_t earlier = 0;
      if (i >= lo + 32) {
        earlier = 0xffffffffu;
      } else if (i > lo) {
        earlier = (1u << (i - lo)) - 1u;
      }
      const uint32_t hit =
          lane < words ? (keep & s_ov[i][lane] & earlier) : 0u;
      const bool suppressed = __any_sync(0xffffffffu, hit != 0u);
      if (suppressed && lane == (i >> 5)) keep &= ~(1u << (i & 31));
    }
    if (lane < words) {
      uint8_t *out = keep_out + (size_t)img * k;
      for (int t = 0; t < 32; ++t) {
        const int j = lane * 32 + t;
        if (j < k) out[j] = (keep >> t) & 1u;
      }
    }
  }
}

}  // namespace

// boxes [B, K, 4] f32 xyxy, scores [B, K] f32 -> keep [B, K] u8 (0/1).
extern "C" int hbpe_nms_sweep(const void *boxes, const void *scores,
                              void *keep, int batch, int k, float thres,
                              void *stream) {
  if (k > kMaxK || k <= 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  nms_sweep_kernel<<<batch, 128, 0, (cudaStream_t)stream>>>(
      (const float *)boxes, (const float *)scores, (uint8_t *)keep, k, thres);
  return (int)cudaGetLastError();
}
