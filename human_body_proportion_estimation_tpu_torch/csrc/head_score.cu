// Detection class-head score epilogue: predict conv + per-anchor class max
// + person logit for every pyramid level in one launch, without writing the
// logits to device memory.
//
// Replaces: human_body_proportion_estimation_tpu/ops/pallas_kernels.py:228
//   (`head_score_epilogue`, body `_head_score_kernel` :207-225), called
//   once per pyramid level there; here one launch serves up to 8 levels.
// Computes, for each level's z [M, F] (M = B*H*W head features):
//   y[m, a*C + c] = sum_f bf16(z[m, f]) * bf16(W[a*C + c, f]) + bias[a*C + c]
//   (f32 accumulation), then best[m, a] = max_c y[m, a*C + c] and
//   person[m, a] = y[m, a*C + person0], written straight into the
//   level-major [B, N] buffers the detector returns (row m = image b, cell
//   i of a level goes to best[b, col0 + i*A + a]).
// `person` is the very register that entered the max, never recomputed, so
//   `person <= best` always and `person == best` exactly where the person
//   class wins (what models/efficientdet.person_slots tests). The max
//   propagates NaN like `amax`. Each anchor's C classes are padded to 96
//   columns with zero weights and a -inf bias, which never win (the Pallas
//   kernel's 128-lane, -1e9 padding is not copied), and the pack puts the
//   person class in column 0 of its anchor, so that `person` is a fixed
//   register: the max does not care about the order of the classes.
// Bound on the H100: operations. At B = 16 the five levels hold
//   M = 102400 rows: 2*M*224*810 = 37.2 GFLOP, ~38 us at 989 TFLOP/s,
//   against 46 MB of z, ~14 us at 3.35 TB/s.
// Design: persistent blocks, one per SM, of two consumer warpgroups and one
//   producer warpgroup (one thread of it works; `setmaxnreg` moves its
//   registers to the consumers: 40 / 232 a thread).
//   - W is packed once on the host side of the port (ops/kernels.
//     pack_head_weights) into one slab per anchor: 96 class rows (C real,
//     the rest zero) in the unswizzled core-matrix layout wgmma reads
//     ([K/8 chunks][96 rows][8 bf16], so LBO = 1536 B along K and
//     SBO = 128 B along N). A slab is contiguous, so the producer moves it
//     with ONE `cp.async.bulk` (43 KB at F = 224) that reports to the
//     stage's `full` mbarrier: no tensor map, no per-thread copy
//     operations. Four stages ring the 9 anchors; a stage is handed back
//     through its `empty` mbarrier once every consumer warp's wgmmas on it
//     have completed. All of W (387 KB padded) cannot stay resident, so it
//     streams from L2 once per 128 rows of z.
//   - Each consumer warpgroup owns a 64-row tile of z and holds it as the A
//     operand IN REGISTERS for all anchors (F/16 k-steps x 4 registers), so
//     only B uses the shared-memory port: `wgmma.mma_async.m64n96k16`,
//     bf16 x bf16 -> f32, 48 accumulator registers a thread and anchor. z
//     goes from device memory to registers directly with 16-byte loads; to
//     make that possible the K axis is permuted (thread t of a quad owns 8
//     consecutive features of every 32), and the pack applies the same
//     permutation to W, which a dot product does not notice.
//   - The class max is taken in the accumulator registers: bias added (the
//     pack lays each thread's 24 bias values out contiguously: 6 16-byte
//     loads), max over the thread's 24 columns, two quad shuffles; thread 0
//     of the quad, which holds column 0, writes `person` from that same
//     register. Straight-line code, so that the compiler can overlap its
//     latencies; no accumulator tile goes through shared memory.
//   - A warpgroup keeps two accumulator sets and scores anchor a while the
//     wgmmas of anchor a + 1 run (`wgmma.wait_group 1`): a chain of 14
//     wgmmas alone leaves the tensor cores idle while it fills and drains,
//     and chains of different warpgroups were measured not to overlap.
//   - The two warpgroups start their tiles half an anchor cycle apart (the
//     order of anchors within a tile is free), so one's z loads and drain
//     at a tile's end overlap the other's wgmmas.
//   - While a tile is computed, `prefetch.global.L2` asks for the z rows of
//     the warpgroup's next tile, so that its loads find them in L2.
//   - Tiles are numbered over all levels (a tile never straddles two);
//     ragged last tiles read zero rows and skip their stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

using namespace hbpe;

constexpr int kMaxLevels = 8;
constexpr int kNPad = 96;           // class rows of one anchor's slab
constexpr int kTileM = 64;          // rows of z per warpgroup tile
constexpr int kConsumerWGs = 2;
constexpr int kConsumerWarps = kConsumerWGs * 4;
constexpr int kThreads = (kConsumerWarps + 4) * 32;  // + producer warpgroup
constexpr int kProducerRegs = 40;   // setmaxnreg: 4 x (2*232 + 40) x 32
constexpr int kConsumerRegs = 232;  //   = 64512 of the SM's 65536 registers
constexpr int kStages = 4;
constexpr int kMaxKPairs = 8;       // F <= 256
constexpr int kLBO = kNPad * 16;    // bytes between K-adjacent core matrices
constexpr int kSBO = 128;           // bytes between N-adjacent core matrices
constexpr int kMaxSmem = 232448;    // 227 KB a block

struct Levels {
  const __nv_bfloat16 *z[kMaxLevels];
  int rows[kMaxLevels];       // B * cells
  int cells[kMaxLevels];      // cells per image
  int col0[kMaxLevels];       // first output column of the level
  int tile0[kMaxLevels + 1];  // first tile of the level; [n_levels] = total
  int n_levels;
  int out_stride;             // output columns per image
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving a use of `v` across the asynchronous wgmma
// that reads or writes it.
__device__ __forceinline__ void fence_reg(float &v) {
  asm volatile("" : "+f"(v)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t &v) {
  asm volatile("" : "+r"(v)::"memory");
}

// K-major, unswizzled operand descriptor: start address, LBO and SBO in
// 16-byte units, layout type 0.
__device__ __forceinline__ uint64_t make_desc(const void *smem) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFFu) >> 4) |
         ((uint64_t)(kLBO >> 4) << 16) | ((uint64_t)(kSBO >> 4) << 32);
}

// D[64 x 96] (+)= A[64 x 16] (registers) * B[16 x 96] (shared memory).
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// What a consumer thread needs in every step and never changes.
struct Consumer {
  const Levels *lv;
  const unsigned char *slabs;
  const float *bias_s;
  uint64_t *full_bar, *empty_bar;
  float *best, *person;
  int f, a_count;
  int wg;    // warpgroup
  int wl;    // warp in the warpgroup: rows 16*wl .. +15 of the tile
  int gq;    // row of the warp's 8-row half
  int tq;    // thread of the quad: columns 2*tq, 2*tq + 1 of every 8
  int lane;
};

// A consumer thread's position in the slab stream, and its current tile.
struct Cursor {
  int stage = 0, anchor = 0;
  uint32_t parity = 0;
  bool ok_lo = false, ok_hi = false;  // the tile's rows gq, gq + 8 exist
  size_t out_lo = 0, out_hi = 0;      // their first output element
};

// A new tile: z rows -> A registers, output offsets. No wgmma is in flight.
template <int KP>
__device__ __forceinline__ void load_tile(const Consumer &cx, Cursor &st,
                                          uint32_t (&areg)[KP * 8],
                                          int tile) {
  const Levels &lv = *cx.lv;
  int l = 0;
  while (tile >= lv.tile0[l + 1]) ++l;
  const int rows = lv.rows[l];
  const int cells = lv.cells[l];
  const int r_lo = (tile - lv.tile0[l]) * kTileM + cx.wl * 16 + cx.gq;
  const int r_hi = r_lo + 8;
  st.ok_lo = r_lo < rows;
  st.ok_hi = r_hi < rows;
  const uint4 *z_lo =
      reinterpret_cast<const uint4 *>(lv.z[l] + (size_t)r_lo * cx.f) + cx.tq;
  const uint4 *z_hi =
      reinterpret_cast<const uint4 *>(lv.z[l] + (size_t)r_hi * cx.f) + cx.tq;
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    uint4 lo = make_uint4(0u, 0u, 0u, 0u);
    uint4 hi = make_uint4(0u, 0u, 0u, 0u);
    const bool in_k = 32 * p + 8 * cx.tq < cx.f;
    if (st.ok_lo && in_k) lo = __ldg(z_lo + 4 * p);
    if (st.ok_hi && in_k) hi = __ldg(z_hi + 4 * p);
    // k-step 2p takes features +0..3 of the thread's 8, 2p + 1 takes +4..7
    areg[8 * p + 0] = lo.x;
    areg[8 * p + 1] = hi.x;
    areg[8 * p + 2] = lo.y;
    areg[8 * p + 3] = hi.y;
    areg[8 * p + 4] = lo.z;
    areg[8 * p + 5] = hi.z;
    areg[8 * p + 6] = lo.w;
    areg[8 * p + 7] = hi.w;
  }
  st.out_lo = (size_t)(r_lo / cells) * lv.out_stride + lv.col0[l] +
              (size_t)(r_lo % cells) * cx.a_count;
  st.out_hi = (size_t)(r_hi / cells) * lv.out_stride + lv.col0[l] +
              (size_t)(r_hi % cells) * cx.a_count;
}

// Asks for the z rows of a later tile to be brought into L2, so that
// load_tile finds them there; every 16 bytes of the tile belong to one
// thread, as in load_tile.
__device__ __forceinline__ void prefetch_tile(const Consumer &cx, int tile) {
  const Levels &lv = *cx.lv;
  int l = 0;
  while (tile >= lv.tile0[l + 1]) ++l;
  const int r_lo = (tile - lv.tile0[l]) * kTileM + cx.wl * 16 + cx.gq;
  const int r_hi = r_lo + 8;
  const bool in_k = 64 * cx.tq < cx.f;  // one 128-byte line a thread, 4 a row
  const char *base = reinterpret_cast<const char *>(lv.z[l]);
  if (r_lo < lv.rows[l] && in_k) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
        base + (size_t)r_lo * cx.f * 2 + 128 * cx.tq));
  }
  if (r_hi < lv.rows[l] && in_k) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
        base + (size_t)r_hi * cx.f * 2 + 128 * cx.tq));
  }
}

// One anchor's logits: acc = A (registers) x slab, as one committed group.
template <int KP>
__device__ __forceinline__ void start_anchor(float (&acc)[48],
                                             uint32_t (&areg)[KP * 8],
                                             const unsigned char *slab) {
#pragma unroll
  for (int i = 0; i < KP * 8; ++i) fence_reg(areg[i]);
#pragma unroll
  for (int i = 0; i < 48; ++i) fence_reg(acc[i]);
  wgmma_fence();
  const uint64_t desc = make_desc(slab);
#pragma unroll
  for (int ks = 0; ks < 2 * KP; ++ks) {
    wgmma_m64n96k16(acc, areg[4 * ks], areg[4 * ks + 1], areg[4 * ks + 2],
                    areg[4 * ks + 3],
                    desc + (uint64_t)(ks * ((2 * kLBO) >> 4)), ks > 0 ? 1 : 0);
  }
  wgmma_commit();
}

// Class max in the accumulator registers, after the anchor's group has
// completed. acc[4j .. 4j+3] are columns 8j + 2tq, +1 of rows gq (first
// two) and gq + 8 (last two).
__device__ __forceinline__ void score_anchor(const Consumer &cx,
                                             const Cursor &st,
                                             float (&acc)[48], int anchor) {
#pragma unroll
  for (int i = 0; i < 48; ++i) fence_reg(acc[i]);
  // this thread's 24 bias values, in the order of its accumulator columns
  const float4 *bs = reinterpret_cast<const float4 *>(
      cx.bias_s + (anchor * 4 + cx.tq) * (kNPad / 4));
  float mx_lo = -INFINITY, mx_hi = -INFINITY, p_lo = 0.0f, p_hi = 0.0f;
#pragma unroll
  for (int jj = 0; jj < kNPad / 16; ++jj) {  // two 8-column blocks a load
    const float4 bb = bs[jj];
    const float v0 = acc[8 * jj + 0] + bb.x;
    const float v1 = acc[8 * jj + 1] + bb.y;
    const float v2 = acc[8 * jj + 2] + bb.x;
    const float v3 = acc[8 * jj + 3] + bb.y;
    const float v4 = acc[8 * jj + 4] + bb.z;
    const float v5 = acc[8 * jj + 5] + bb.w;
    const float v6 = acc[8 * jj + 6] + bb.z;
    const float v7 = acc[8 * jj + 7] + bb.w;
    mx_lo = max_nan(mx_lo, max_nan(max_nan(v0, v1), max_nan(v4, v5)));
    mx_hi = max_nan(mx_hi, max_nan(max_nan(v2, v3), max_nan(v6, v7)));
    if (jj == 0) {  // column 0 of the anchor (in quad thread 0): the person
      p_lo = v0;
      p_hi = v2;
    }
  }
  mx_lo = max_nan(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_hi = max_nan(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_lo = max_nan(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = max_nan(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  if (cx.tq == 0) {
    if (st.ok_lo) {
      cx.best[st.out_lo + anchor] = mx_lo;
      cx.person[st.out_lo + anchor] = p_lo;
    }
    if (st.ok_hi) {
      cx.best[st.out_hi + anchor] = mx_hi;
      cx.person[st.out_hi + anchor] = p_hi;
    }
  }
}

// The slab is no longer read by this warp: hand its stage back.
__device__ __forceinline__ void release(const Consumer &cx, int stage) {
  __syncwarp();
  if (cx.lane == 0) mbar_arrive(&cx.empty_bar[stage]);
}

__device__ __forceinline__ void advance(const Consumer &cx, Cursor &st) {
  if (++st.anchor == cx.a_count) st.anchor = 0;
  if (++st.stage == kStages) {
    st.stage = 0;
    st.parity ^= 1u;
  }
}

// Passes `n` slabs of the stream without using them.
__device__ __forceinline__ void idle(const Consumer &cx, Cursor &st, int n) {
  for (int i = 0; i < n; ++i) {
    mbar_wait(&cx.full_bar[st.stage], st.parity);
    release(cx, st.stage);
    advance(cx, st);
  }
}

// Waits for the next slab, starts its anchor's wgmmas into `acc`, moves on.
template <int KP>
__device__ __forceinline__ void next_anchor(const Consumer &cx, Cursor &st,
                                            uint32_t (&areg)[KP * 8],
                                            float (&acc)[48]) {
  constexpr int kSlabBytes = KP * 4 * kLBO;
  mbar_wait(&cx.full_bar[st.stage], st.parity);
  start_anchor<KP>(acc, areg, cx.slabs + st.stage * kSlabBytes);
  advance(cx, st);
}

// The a_count anchors of one tile, from the stream's next a_count slabs.
// Two accumulator sets take the anchors in turns: an anchor's wgmmas stay
// in flight while the one before it is scored, and the tile's last anchor
// is drained before the function returns.
template <int KP>
__device__ __forceinline__ void run_tile(const Consumer &cx, Cursor &st,
                                         uint32_t (&areg)[KP * 8],
                                         float (&acc_a)[48],
                                         float (&acc_b)[48]) {
  int stage_a = st.stage, anchor_a = st.anchor;
  next_anchor<KP>(cx, st, areg, acc_a);
  int started = 1;
  while (started + 2 <= cx.a_count) {
    const int stage_b = st.stage, anchor_b = st.anchor;
    next_anchor<KP>(cx, st, areg, acc_b);
    wgmma_wait<1>();
    release(cx, stage_a);
    score_anchor(cx, st, acc_a, anchor_a);
    stage_a = st.stage;
    anchor_a = st.anchor;
    next_anchor<KP>(cx, st, areg, acc_a);
    wgmma_wait<1>();
    release(cx, stage_b);
    score_anchor(cx, st, acc_b, anchor_b);
    started += 2;
  }
  if (started < cx.a_count) {
    const int stage_b = st.stage, anchor_b = st.anchor;
    next_anchor<KP>(cx, st, areg, acc_b);
    wgmma_wait<1>();
    release(cx, stage_a);
    score_anchor(cx, st, acc_a, anchor_a);
    wgmma_wait<0>();
    release(cx, stage_b);
    score_anchor(cx, st, acc_b, anchor_b);
  } else {
    wgmma_wait<0>();
    release(cx, stage_a);
    score_anchor(cx, st, acc_a, anchor_a);
  }
}

// KP = ceil(F / 32): pairs of k-steps, one 16-byte load of z a thread each.
template <int KP>
__global__ void __launch_bounds__(kThreads, 1)
    head_score_kernel(const __grid_constant__ Levels lv,
                      const unsigned char *__restrict__ w_packed,
                      const float *__restrict__ bias_packed,
                      float *__restrict__ best, float *__restrict__ person,
                      int f, int a_count) {
  constexpr int kSlabBytes = KP * 4 * kLBO;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char *slabs = smem;
  float *bias_s = reinterpret_cast<float *>(smem + kStages * kSlabBytes);
  uint64_t *full_bar = reinterpret_cast<uint64_t *>(bias_s + a_count * kNPad);
  uint64_t *empty_bar = full_bar + kStages;

  const int tid = threadIdx.x;
  // read from lane 0, so that the compiler knows the roles are warp-uniform
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;

  for (int i = tid; i < a_count * kNPad; i += kThreads) {
    bias_s[i] = bias_packed[i];
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Tiles are dealt in rounds of gridDim.x * kConsumerWGs: within a round
  // first one tile to warpgroup 0 of every block, then to warpgroup 1. So
  // a last, partial round spreads over as many SMs as it has tiles, where
  // a warpgroup alone on its SM runs nearly twice as fast. (grid <= tiles)
  const int n_tiles = lv.tile0[lv.n_levels];
  const int round = (int)gridDim.x * kConsumerWGs;
  const int iters = (n_tiles - (int)blockIdx.x + round - 1) / round;
  // Warpgroup g starts its first tile at slab (g * A) / kConsumerWGs of the
  // stream and idles on the slabs before and after its own; every warpgroup
  // passes every slab so that the ring's barriers stay in step.
  const int max_shift = ((kConsumerWGs - 1) * a_count) / kConsumerWGs;
  const int n_slabs = iters * a_count + max_shift;

  if (warp >= kConsumerWarps) {
    // ------------------------------ producer: one thread keeps the ring full
    // (a whole warpgroup, so that it can hand its registers to the consumers)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      int stage = 0, anchor = 0;
      uint32_t parity = 0;
      for (int s = 0; s < n_slabs; ++s) {
        mbar_wait(&empty_bar[stage], parity ^ 1u);
        mbar_expect_tx(&full_bar[stage], kSlabBytes);
        bulk_load(slabs + stage * kSlabBytes,
                  w_packed + (size_t)anchor * kSlabBytes, kSlabBytes,
                  &full_bar[stage]);
        if (++anchor == a_count) anchor = 0;
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1u;
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  Consumer cx;
  cx.lv = &lv;
  cx.slabs = slabs;
  cx.bias_s = bias_s;
  cx.full_bar = full_bar;
  cx.empty_bar = empty_bar;
  cx.best = best;
  cx.person = person;
  cx.f = f;
  cx.a_count = a_count;
  cx.wg = warp >> 2;
  cx.wl = warp & 3;
  cx.gq = lane >> 2;
  cx.tq = lane & 3;
  cx.lane = lane;
  Cursor st;

  uint32_t areg[KP * 8];
  float acc_a[48], acc_b[48];  // two anchors' accumulators, used in turns
#pragma unroll
  for (int i = 0; i < KP * 8; ++i) areg[i] = 0u;
#pragma unroll
  for (int i = 0; i < 48; ++i) acc_a[i] = acc_b[i] = 0.0f;

  const int shift = (cx.wg * a_count) / kConsumerWGs;
  idle(cx, st, shift);
  for (int it = 0; it < iters; ++it) {
    const int tile = it * round + cx.wg * (int)gridDim.x + (int)blockIdx.x;
    if (tile < n_tiles) {
      load_tile<KP>(cx, st, areg, tile);
      const int next_tile = tile + round;
      if (next_tile < n_tiles) prefetch_tile(cx, next_tile);
      run_tile<KP>(cx, st, areg, acc_a, acc_b);
    } else {
      idle(cx, st, a_count);
    }
  }
  idle(cx, st, max_shift - shift);
}

template <int KP>
cudaError_t launch(const Levels &lv, const void *w_packed,
                   const void *bias_packed, void *best, void *person, int f,
                   int a_count, int blocks,
                   cudaStream_t stream) {
  const size_t smem = (size_t)kStages * KP * 4 * kLBO +
                      (size_t)a_count * kNPad * 4 + 2 * kStages * 8;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  // raising the kernel's shared-memory limit costs host time: once a size
  static size_t smem_allowed = 0;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        head_score_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  head_score_kernel<KP><<<blocks, kThreads, smem, stream>>>(
      lv, (const unsigned char *)w_packed, (const float *)bias_packed,
      (float *)best, (float *)person, f, a_count);
  return cudaGetLastError();
}

}  // namespace

// One launch for n_levels <= 8 levels. z[l] [rows[l], F] bf16 with
// rows[l] = B * cells[l]; w_packed [A][ceil(F/32)*4][96][8] bf16 and
// bias_packed [A][4][24] f32 as ops/kernels.pack_head_weights lays them out
// (classes padded to 96 a anchor, the person class first); best, person
// [B, out_stride] f32, level l starting at column col0[l]. F must be a
// multiple of 16 and <= 256; pointers 16-byte aligned.
extern "C" int hbpe_head_score_levels(const void *const *z, const int *rows,
                                      const int *cells, const int *col0,
                                      int n_levels, const void *w_packed,
                                      const void *bias_packed, void *best,
                                      void *person, int out_stride, int f,
                                      int a_count,
                                      void *stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || f <= 0 || f % 16 != 0 ||
      f > 32 * kMaxKPairs || a_count < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  int tiles = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < n_levels;
    if (used && (rows[l] < 0 || cells[l] < 1)) {
      return (int)cudaErrorInvalidValue;
    }
    lv.z[l] = used ? (const __nv_bfloat16 *)z[l] : nullptr;
    lv.rows[l] = used ? rows[l] : 0;
    lv.cells[l] = used ? cells[l] : 1;
    lv.col0[l] = used ? col0[l] : 0;
    lv.tile0[l] = tiles;
    tiles += (lv.rows[l] + kTileM - 1) / kTileM;
  }
  lv.tile0[kMaxLevels] = tiles;
  lv.n_levels = n_levels;
  lv.out_stride = out_stride;
  if (tiles == 0) return (int)cudaSuccess;

  static int sms = 0;  // of the current device at the first call
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = tiles < sms ? tiles : sms;
  cudaStream_t st = (cudaStream_t)stream;

  switch ((f + 31) / 32) {
    case 1:
      err = launch<1>(lv, w_packed, bias_packed, best, person, f, a_count,
                      blocks, st);
      break;
    case 2:
      err = launch<2>(lv, w_packed, bias_packed, best, person, f, a_count,
                      blocks, st);
      break;
    case 3:
      err = launch<3>(lv, w_packed, bias_packed, best, person, f, a_count,
                      blocks, st);
      break;
    case 4:
      err = launch<4>(lv, w_packed, bias_packed, best, person, f, a_count,
                      blocks, st);
      break;
    case 5:
      err = launch<5>(lv, w_packed, bias_packed, best, person, f, a_count,
                      blocks, st);
      break;
    case 6:
      err = launch<6>(lv, w_packed, bias_packed, best, person, f, a_count,
                      blocks, st);
      break;
    case 7:
      err = launch<7>(lv, w_packed, bias_packed, best, person, f, a_count,
                      blocks, st);
      break;
    default:
      err = launch<8>(lv, w_packed, bias_packed, best, person, f, a_count,
                      blocks, st);
      break;
  }
  return (int)err;
}
