// Greedy NMS keep-mask sweep, one image per cluster of four thread blocks.
//
// Replaces: human_body_proportion_estimation_tpu/ops/pallas_kernels.py:151
//   (`nms_sweep_pallas_batched`, body `_nms_sweep_kernel` :105-147; the
//   single-image `nms_sweep_pallas` :190 is the same kernel at B = 1).
// Computes, per image: over K boxes (xyxy, sorted by descending score) box i
//   is kept iff score_i > 0 and no earlier kept box overlaps it.
// Overlap test: IoU > t in the division form of ops/boxes.box_iou,
//   inter / max(union, 1e-12) > t, as the JAX path's `ops/nms.nms_mask`
//   tests it (efficientdet.py:399); or, in the legacy variant (`plus1`), of
//   ops/nms.box_iou_plus1: widths and heights counted as x2 - x1 + 1, and
//   inter / (area_a + area_b - inter + 1e-16) > t, as `nms_mask(...,
//   legacy_plus1_iou=True)` tests it for `yolo_nms_legacy`. Each variant is
//   its own instantiation. The Pallas kernel's `inter > t * union`
//   can disagree with it by one rounding at IoU ~= t. Every product, sum
//   and quotient below is an explicit round-to-nearest intrinsic so that
//   nvcc cannot contract them into FMAs and round differently from the
//   plain version, and every min, max and clamp is the NaN-propagating
//   `min.NaN` / `max.NaN` (fminf / fmaxf drop a NaN operand; torch.minimum,
//   maximum and clamp_min keep it), so a box with a NaN coordinate overlaps
//   nothing, as in the plain version and the JAX package.
// Bound on the H100: latency. Bytes and operations both bound the work
//   below a tenth of a microsecond; what takes time is the launch, one trip
//   to device memory, the IoUs of one image on one SM's four schedulers, and
//   K dependent sweep steps.
// Design: the K boxes are cut into blocks of 32, and the kernel is compiled
//   for every block count NB = ceil(K / 32) up to 16 (K <= 512; the shared
//   memory at NB = 16 is 8 KB of boxes, 2 KB of areas, 30 KB of overlap
//   words below the diagonal and 2 KB on it, under the 48 KB of static
//   shared memory a thread block may have), so that every loop
//   below is unrolled and no index is computed at run time. An image has a
//   cluster of four thread blocks of 1024 threads, on four SMs: the IoUs of
//   one image keep one SM's schedulers busy for longer than everything else
//   in the kernel together, and a batch leaves most of the 132 SMs idle.
//   Staging: in every thread block, thread j brings box j to shared memory
//   with one 16-byte load, beside its area, and a ballot of score > 0 is
//   its block's live word.
//   The rows from K to 32 NB are NaN boxes with score 0: they overlap
//   nothing and are dead, so nothing later tests an index against K.
//   Overlap bits: the K x K matrix is cut into 32 x 32 tiles, and only the
//   tiles at or below the diagonal are computed (IoU is symmetric, bit for
//   bit). The tiles are dealt to the four thread blocks in turn, and warp r
//   computes row r of every tile of its thread block: lane t tests box
//   32rb + r against box 32w + t, and one `__ballot_sync` is the row's
//   32-bit word, so a thread divides 2 or 3 times at K = 128 (10 tiles)
//   and 34 times at K = 512 (136 tiles).
//   The words go to the shared memory of the cluster's first thread block,
//   from the others through distributed shared memory (the cluster barrier
//   that ends the staging says that the first thread block has started
//   before anyone writes to it): below the diagonal as they are ("which
//   boxes of block w overlap box i"); a diagonal tile keeps only the bits
//   j > i ("which later boxes of its own block box i suppresses"). A
//   second cluster barrier ends the phase. The IEEE division
//   takes a slow path when its numerator is 0, which it is for most pairs;
//   0 / union is 0 unless the union is NaN, and is said so without dividing
//   (the union is >= 1e-12, or >= 1e-16 in the +1 variant, when the
//   intersection is 0, so it is never 0 there).
//   Sweep, by warp 0 of the first thread block, block after block: lane t ANDs the words of box
//   32rb + t with the final keep words of the finished blocks, all lanes at
//   once, and one ballot gives the block's boxes that are dead or
//   suppressed from outside. What stays sequential is 32 steps inside the
//   block: every lane reads the block's 32 diagonal words (broadcast
//   16-byte loads that do not depend on the chain) and runs
//   `if box i is not removed: removed |= suppresses[i]` in registers, with
//   no shared-memory read and no vote on the chain. The chain takes the
//   same time whatever the boxes are.
//   The keep bytes of a block leave by one 32-byte store of the warp.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 512;
constexpr int kThreads = 1024;   // 32 warps: warp r takes row r of every tile
constexpr int kCluster = 4;      // thread blocks an image, one SM each
constexpr uint32_t kFull = 0xffffffffu;

namespace cg = cooperative_groups;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The +1 of the legacy variant on a width or height: x + 1, or x alone.
template <bool PLUS1>
__device__ __forceinline__ float plus1(float x) {
  return PLUS1 ? __fadd_rn(x, 1.0f) : x;
}

template <bool PLUS1>
__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(max_nan(plus1<PLUS1>(__fsub_rn(b.z, b.x)), 0.0f),
                   max_nan(plus1<PLUS1>(__fsub_rn(b.w, b.y)), 0.0f));
}

// ops/boxes.box_iou(a, b) > t, or ops/nms.box_iou_plus1(a, b) > t,
// operation for operation.
template <bool PLUS1>
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float thres) {
  const float iw = max_nan(
      plus1<PLUS1>(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x))), 0.0f);
  const float ih = max_nan(
      plus1<PLUS1>(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y))), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float diff = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float uni = PLUS1 ? __fadd_rn(diff, 1e-16f) : max_nan(diff, 1e-12f);
  // 0 / uni is 0 for every uni but NaN. Said here, because the IEEE division
  // takes its slow path for a zero numerator, and most pairs do not meet.
  const float iou =
      (inter == 0.0f && uni == uni) ? 0.0f : __fdiv_rn(inter, uni);
  return iou > thres;
}

// One step of the chain inside a block: if the box of `bit` is not removed,
// it removes the boxes it suppresses.
__device__ __forceinline__ uint32_t chain_step(uint32_t removed,
                                               uint32_t suppresses,
                                               uint32_t bit) {
  return (removed & bit) ? removed : (removed | suppresses);
}

// NB: the number of 32-box blocks, ceil(K / 32); PLUS1: the legacy IoU.
template <int NB, bool PLUS1>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
        nms_sweep_kernel(const float *__restrict__ boxes,
                         const float *__restrict__ scores,
                         uint8_t *__restrict__ keep_out, int k,
                         float thres) {
  __shared__ float4 s_box[32 * NB];
  __shared__ float s_area[32 * NB];
  __shared__ uint32_t s_live[NB];
  // s_low[w][i]: bit t = box 32w + t overlaps box i, for blocks w before i's
  __shared__ uint32_t s_low[NB > 1 ? NB - 1 : 1][32 * NB];
  // s_diag[rb][r]: bit t = box 32rb + r overlaps box 32rb + t, t > r only
  __shared__ __align__(16) uint32_t s_diag[NB][32];
  const int img = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  // the overlap words of the whole image gather in the first thread block
  uint32_t(*low)[32 * NB] = cluster.map_shared_rank(s_low, 0);
  uint32_t(*diag)[32] = cluster.map_shared_rank(s_diag, 0);

  // thread j stages box j, its area and its live bit. The rows from K to
  // the end of the last block are NaN boxes with score 0: they overlap
  // nothing and are dead, so no loop below tests an index against K.
  if (threadIdx.x < 32 * NB) {
    const int j = threadIdx.x;
    float4 box = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                             CUDART_NAN_F);
    float score = 0.0f;
    if (j < k) {
      box = __ldg(reinterpret_cast<const float4 *>(boxes) +
                  (size_t)img * k + j);
      score = __ldg(scores + (size_t)img * k + j);
    }
    s_box[j] = box;
    s_area[j] = area_of<PLUS1>(box);
    // false for a NaN score too
    const uint32_t live = __ballot_sync(kFull, score > 0.0f);
    if (lane == 0) s_live[warp] = live;
  }
  // Ends the staging, and says that every thread block of the cluster has
  // started: only then may one write to another's shared memory.
  cluster.sync();

#pragma unroll
  for (int rb = 0; rb < NB; ++rb) {
    const float4 bi = s_box[32 * rb + warp];
    const float ai = s_area[32 * rb + warp];
#pragma unroll
    for (int w = 0; w <= rb; ++w) {
      if ((rb * (rb + 1) / 2 + w) % kCluster != rank) continue;
      const uint32_t word = __ballot_sync(
          kFull, overlaps<PLUS1>(s_box[32 * w + lane], s_area[32 * w + lane],
                                 bi, ai, thres));
      if (lane == 0) {
        if (w < rb) {
          low[w][32 * rb + warp] = word;
        } else {
          diag[rb][warp] = word & ~((2u << warp) - 1u);
        }
      }
    }
  }
  cluster.sync();
  if (rank != 0 || warp != 0) return;

  uint32_t keep[NB];
  uint8_t *out = keep_out + (size_t)img * k;
#pragma unroll
  for (int rb = 0; rb < NB; ++rb) {
    const int j = 32 * rb + lane;
    uint32_t hit = 0;
#pragma unroll
    for (int w = 0; w < rb; ++w) hit |= s_low[w][j] & keep[w];
    uint32_t removed =
        ~(s_live[rb] & __ballot_sync(kFull, hit == 0u));
    const uint4 *words = reinterpret_cast<const uint4 *>(s_diag[rb]);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 v = words[q];
      removed = chain_step(removed, v.x, 1u << (4 * q));
      removed = chain_step(removed, v.y, 2u << (4 * q));
      removed = chain_step(removed, v.z, 4u << (4 * q));
      removed = chain_step(removed, v.w, 8u << (4 * q));
    }
    keep[rb] = ~removed;
    if (j < k) out[j] = (uint8_t)((keep[rb] >> lane) & 1u);
  }
}

__global__ void empty_kernel() {}

template <int NB, bool PLUS1>
int launch(const float *boxes, const float *scores, uint8_t *keep, int batch,
           int k, float thres, cudaStream_t stream) {
  if constexpr (NB > 1) {
    if (k <= 32 * (NB - 1)) {
      return launch<NB - 1, PLUS1>(boxes, scores, keep, batch, k, thres,
                                   stream);
    }
  }
  nms_sweep_kernel<NB, PLUS1><<<batch * kCluster, kThreads, 0, stream>>>(
      boxes, scores, keep, k, thres);
  return (int)cudaGetLastError();
}

}  // namespace

// boxes [B, K, 4] f32 xyxy, scores [B, K] f32 -> keep [B, K] u8 (0/1),
// K <= 512; plus1 != 0 takes the legacy +1-pixel IoU.
extern "C" int hbpe_nms_sweep(const void *boxes, const void *scores,
                              void *keep, int batch, int k, float thres,
                              int plus1, void *stream) {
  if (k > kMaxK || k <= 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  const float *b = (const float *)boxes, *s = (const float *)scores;
  uint8_t *out = (uint8_t *)keep;
  cudaStream_t st = (cudaStream_t)stream;
  return plus1 ? launch<kMaxK / 32, true>(b, s, out, batch, k, thres, st)
               : launch<kMaxK / 32, false>(b, s, out, batch, k, thres, st);
}

// The sweep's launch shape: thread blocks an image, threads a thread block.
extern "C" void hbpe_nms_launch_shape(int *blocks_per_image, int *threads) {
  *blocks_per_image = kCluster;
  *threads = kThreads;
}

// A kernel that does nothing: its time is what a launch of that shape alone
// costs, the floor under the sweep's own time.
extern "C" int hbpe_empty_launch(int blocks, int threads, void *stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
