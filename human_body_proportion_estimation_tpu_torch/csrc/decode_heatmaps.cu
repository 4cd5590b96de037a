// Heatmap argmax decode for the person-slot keypoints.
//
// Replaces: human_body_proportion_estimation_tpu/ops/pallas_kernels.py:56
//   (`decode_heatmaps_pallas`, body `_decode_kernel` :27-52).
// Computes, per (slot, keypoint) map of H*W floats:
//   score = max; idx = smallest row-major index equal to the max (numpy's
//   first-occurrence argmax); x = idx % W, y = idx / W, both zeroed where
//   score <= 0.
// Bound on the H100: bytes. Every map is read once (22.6 MB at
//   [48, 17, 96, 72] f32, ~6.7 us at 3.35 TB/s) and the arithmetic is one
//   compare per element.
// Design: one block of 256 threads per map. Each thread walks the map with
//   16-byte loads at a 4096-byte stride, so a warp reads contiguous lines;
//   it keeps one (value, index) pair. The pairs are reduced with warp
//   shuffles, then across the 8 warps in shared memory. The combine rule
//   "greater value, or equal value and lower index" gives the lowest-index
//   tie whatever order the partial results meet in. NaN compares false
//   against everything, so it never wins (a row of NaN reports -inf).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void take_better(float &best, int &idx, float v,
                                            int i) {
  if (v > best || (v == best && i < idx)) {
    best = v;
    idx = i;
  }
}

__global__ void decode_heatmaps_kernel(const float *__restrict__ hm,
                                       float *__restrict__ kp,
                                       float *__restrict__ scores, int hw,
                                       int w, int vec4) {
  const int row = blockIdx.x;
  const float *map = hm + (size_t)row * hw;
  float best = -INFINITY;
  int idx = hw;  // sentinel: no comparable value seen yet

  if (vec4) {
    const float4 *map4 = reinterpret_cast<const float4 *>(map);
    const int n4 = hw >> 2;
    for (int j = threadIdx.x; j < n4; j += kThreads) {
      float4 v = __ldg(map4 + j);
      int i = j << 2;
      take_better(best, idx, v.x, i);
      take_better(best, idx, v.y, i + 1);
      take_better(best, idx, v.z, i + 2);
      take_better(best, idx, v.w, i + 3);
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += kThreads) {
      take_better(best, idx, __ldg(map + i), i);
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, best, off);
    int oi = __shfl_down_sync(0xffffffffu, idx, off);
    take_better(best, idx, ov, oi);
  }

  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kThreads / 32; ++k) {
      take_better(best, idx, s_val[k], s_idx[k]);
    }
    if (idx == hw) idx = 0;
    const float mask = best > 0.0f ? 1.0f : 0.0f;
    kp[2 * row] = (float)(idx % w) * mask;
    kp[2 * row + 1] = (float)(idx / w) * mask;
    scores[row] = best;
  }
}

}  // namespace

// heatmaps [rows, hw] f32 -> kp [rows, 2] f32, scores [rows] f32.
extern "C" int hbpe_decode_heatmaps(const void *heatmaps, void *kp,
                                    void *scores, int rows, int hw, int w,
                                    void *stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const int vec4 =
      (hw % 4 == 0) && ((reinterpret_cast<size_t>(heatmaps) & 15) == 0);
  decode_heatmaps_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const float *)heatmaps, (float *)kp, (float *)scores, hw, w, vec4);
  return (int)cudaGetLastError();
}
