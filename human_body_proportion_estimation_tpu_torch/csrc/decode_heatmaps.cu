// Heatmap argmax decode for the person-slot keypoints.
//
// Replaces: human_body_proportion_estimation_tpu/ops/pallas_kernels.py:56
//   (`decode_heatmaps_pallas`, body `_decode_kernel` :27-52).
// Computes, per (slot, keypoint) map of H*W floats:
//   score = max; idx = smallest row-major index equal to the max (numpy's
//   first-occurrence argmax); x = idx % W, y = idx / W, both zeroed where
//   score <= 0. A map that holds a NaN reports score = NaN and the keypoint
//   (0, 0), as the JAX package does (`jnp.max` is NaN and `NaN > 0` is
//   false); -inf and +inf are ordinary values.
// Bound on the H100: bytes. Every map is read once (22.6 MB at
//   [48, 17, 96, 72] f32, ~6.7 us at 3.35 TB/s) and the arithmetic is one
//   compare per element, so the only thing to win is bytes in flight, and
//   after that the reduction that is left when the last byte has landed.
// Design: persistent blocks of 8 warps, two per SM at the main path's map
//   size; every WARP owns whole maps (map blockIdx + warp * grid, then +
//   the number of warps in the grid) and a private ring of up to 8 buffers
//   in shared memory. A map is contiguous in device memory, and so is the
//   sequence of a warp's maps cut into chunks of about 7 KB: lane 0 fills a
//   buffer with a single `cp.async.bulk` (no tensor map) that reports its
//   bytes to the buffer's mbarrier, and refills it with the chunk `slots`
//   further on as soon as the warp has read it, across map boundaries. So
//   a map's first chunk is reduced while its later chunks, and the next
//   maps, are still in flight; whole-map copies were measured to land
//   together at the end, leaving every reduction for after the last byte.
//   With 27 KB maps (4 chunks) 16 warps x 2 buffers fill an SM's shared
//   memory, and the main path's 816 maps each have a warp of their own.
//   A warp reads a buffer as conflict-free float4 (consecutive lanes,
//   consecutive 16 bytes) into two independent (value, index) pairs and a
//   NaN flag; a lane's 54 vectors a map are a long dependent chain, so each
//   vector is reduced within itself first and costs the chain one step.
//   Pairs are combined with "greater value, or equal value and lower
//   index", which gives the lowest-index tie whatever order the partial
//   results meet in; five shuffle steps finish a map. Nothing is
//   shared between warps: no __syncthreads(), no serial tail.
//   Maps whose byte size is not a multiple of 16 or whose base is
//   unaligned take plain loads from device memory inside the same kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

using namespace hbpe;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSlots = 8;
constexpr int kChunkTarget = 7168;       // bytes; a map is cut into equal
                                         // chunks of about this size
constexpr int kSmemBudget = 224 * 1024;  // of the SM's 227 KB, for the rings
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void take_better(float &best, int &idx, float v,
                                            int i) {
  if (v > best || (v == best && i < idx)) {
    best = v;
    idx = i;
  }
}

// Four consecutive values at indices i .. i + 3 into (best, idx). Calls on
// one (best, idx) pair come with increasing i, so "greater" alone keeps the
// lowest index on ties; the four are first reduced among themselves, which
// leaves one dependent step a call on the running pair. (A NaN may hide its
// neighbours here: the map then reports NaN / (0, 0) whatever idx is.)
__device__ __forceinline__ void take_vec(float &best, int &idx, int &nan,
                                         float4 v, int i) {
  nan |= (v.x != v.x) | (v.y != v.y) | (v.z != v.z) | (v.w != v.w);
  const bool yx = v.y > v.x;
  float a = yx ? v.y : v.x;
  int ai = yx ? i + 1 : i;
  const bool wz = v.w > v.z;
  const float b = wz ? v.w : v.z;
  const int bi = wz ? i + 3 : i + 2;
  const bool ba = b > a;
  a = ba ? b : a;
  ai = ba ? bi : ai;
  if (a > best) {
    best = a;
    idx = ai;
  }
}

// The chunk ring of one warp: which chunk of which map comes next.
struct ChunkCursor {
  int it = 0;  // map of the warp
  int k = 0;   // chunk of the map
  __device__ __forceinline__ void advance(int n_chunks) {
    if (++k == n_chunks) {
      k = 0;
      ++it;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
    decode_heatmaps_kernel(const float *__restrict__ hm,
                           float *__restrict__ kp, float *__restrict__ scores,
                           int rows, int hw, int w, int slots, int n_chunks,
                           int chunk_elems) {
  extern __shared__ __align__(128) unsigned char rings[];
  __shared__ __align__(8) uint64_t full_bars[kWarps * kMaxSlots];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // maps of this warp: first + it * step. Consecutive maps go to different
  // blocks, so a batch of fewer maps than warps still uses every SM.
  const int first = (int)blockIdx.x + warp * (int)gridDim.x;
  const int step = (int)gridDim.x * kWarps;
  if (first >= rows) return;
  const int n_mine = (rows - first + step - 1) / step;
  const int chunk_bytes = chunk_elems * 4;
  unsigned char *ring = rings + (size_t)warp * slots * chunk_bytes;
  uint64_t *full_bar = full_bars + warp * kMaxSlots;

  // lane 0: request chunk `c` (k of map it) into buffer `slot`
  auto request = [&](const ChunkCursor &c, int slot) {
    const int elems =
        c.k + 1 < n_chunks ? chunk_elems : hw - c.k * chunk_elems;
    const float *src = hm + ((size_t)first + (size_t)c.it * step) * hw +
                       (size_t)c.k * chunk_elems;
    mbar_expect_tx(&full_bar[slot], (uint32_t)elems * 4u);
    bulk_load(ring + (size_t)slot * chunk_bytes, src, (uint32_t)elems * 4u,
              &full_bar[slot]);
  };

  ChunkCursor ahead;  // the next chunk to request (lane 0 only)
  if (slots > 0) {
    if (lane == 0) {
      for (int s = 0; s < slots; ++s) mbar_init(&full_bar[s], 1);
      fence_barrier_init();
      for (int s = 0; s < slots && ahead.it < n_mine; ++s) {
        request(ahead, s);
        ahead.advance(n_chunks);
      }
    }
    __syncwarp();
  }

  int slot = 0;
  uint32_t parity = 0;
  for (int it = 0; it < n_mine; ++it) {
    const size_t row = (size_t)first + (size_t)it * step;
    float best = -INFINITY, best2 = -INFINITY;
    int idx = hw, idx2 = hw;  // sentinel: no comparable value seen yet
    int nan = 0;

    if (slots > 0) {
      for (int k = 0; k < n_chunks; ++k) {
        const int base = k * chunk_elems;
        const int n4 = (k + 1 < n_chunks ? chunk_elems : hw - base) >> 2;
        mbar_wait(&full_bar[slot], parity);
        const float4 *buf4 =
            reinterpret_cast<const float4 *>(ring + (size_t)slot * chunk_bytes);
        int j = lane;
        for (; j + 32 < n4; j += 64) {
          const float4 v = buf4[j];
          const float4 u = buf4[j + 32];
          take_vec(best, idx, nan, v, base + (j << 2));
          take_vec(best2, idx2, nan, u, base + ((j + 32) << 2));
        }
        if (j < n4) take_vec(best, idx, nan, buf4[j], base + (j << 2));
        __syncwarp();  // every lane is done with the buffer: refill it
        if (lane == 0 && ahead.it < n_mine) {
          fence_proxy_async();
          request(ahead, slot);
          ahead.advance(n_chunks);
        }
        if (++slot == slots) {
          slot = 0;
          parity ^= 1u;
        }
      }
    } else {
      const float *map = hm + row * hw;
      for (int i = lane; i < hw; i += 32) {
        const float v = __ldg(map + i);
        nan |= (v != v);
        take_better(best, idx, v, i);
      }
    }

    take_better(best, idx, best2, idx2);
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, idx, off);
      take_better(best, idx, ov, oi);
    }
    nan = __any_sync(kFull, nan);
    if (lane == 0) {
      if (idx == hw) idx = 0;
      const float score = nan ? __int_as_float(0x7fc00000) : best;
      const float mask = score > 0.0f ? 1.0f : 0.0f;
      kp[2 * row] = (float)(idx % w) * mask;
      kp[2 * row + 1] = (float)(idx / w) * mask;
      scores[row] = score;
    }
  }
}

}  // namespace

// heatmaps [rows, hw] f32 -> kp [rows, 2] f32, scores [rows] f32.
extern "C" int hbpe_decode_heatmaps(const void *heatmaps, void *kp,
                                    void *scores, int rows, int hw, int w,
                                    void *stream) {
  if (rows <= 0 || hw <= 0) return (int)cudaSuccess;
  static int sms = 0;  // of the current device at the first call
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }

  // A map is cut into n_chunks equal chunks (a multiple of 16 bytes each,
  // the last one the remainder) of about kChunkTarget bytes; every warp
  // rings up to kMaxSlots of them, within half an SM's shared memory so
  // that at least two blocks share an SM (measured: as fast on L2-resident
  // maps as one block with twice the ring, faster on maps from device
  // memory). Maps that cannot be bulk-copied (size or alignment) take the
  // plain-load path (slots = 0).
  const bool bulk_ok = (hw % 4 == 0) &&
                       ((reinterpret_cast<size_t>(heatmaps) & 15) == 0);
  int slots = 0, n_chunks = 1, chunk_elems = hw, blocks_per_sm = 4;
  if (bulk_ok) {
    const long long map_bytes = (long long)hw * 4;
    n_chunks = (int)((map_bytes + kChunkTarget / 2) / kChunkTarget);
    if (n_chunks < 1) n_chunks = 1;
    chunk_elems = ((hw + n_chunks - 1) / n_chunks + 3) / 4 * 4;
    n_chunks = (hw + chunk_elems - 1) / chunk_elems;
    const int ring_unit = kWarps * chunk_elems * 4;  // one slot a warp
    slots = (kSmemBudget / 2) / ring_unit;
    if (slots < 2) slots = 2;  // a chunk is at most 10.5 KB: two always fit
    if (slots > kMaxSlots) slots = kMaxSlots;
    blocks_per_sm = kSmemBudget / (slots * ring_unit);
    if (blocks_per_sm > 4) blocks_per_sm = 4;
  }
  const size_t smem = (size_t)slots * kWarps * chunk_elems * 4;
  // raising the kernel's shared-memory limit costs host time: once a size
  static size_t smem_allowed = 0;
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(decode_heatmaps_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  int blocks = sms * blocks_per_sm;
  if (blocks > rows) blocks = rows;
  decode_heatmaps_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float *)heatmaps, (float *)kp, (float *)scores, rows, hw, w,
      slots, n_chunks, chunk_elems);
  return (int)cudaGetLastError();
}
