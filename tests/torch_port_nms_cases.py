"""Inputs for the NMS sweep, shared by the CPU tests and `chip_smoke.py`.

`nms_cases()` yields (name, boxes [B, K, 4] f32 xyxy, scores [B, K] f32
descending, threshold, expected keep mask or None). The CPU tests hold the
port's plain `nms_sweep` against the JAX package on each case; `chip_smoke.py`
holds the CUDA kernel against the plain version on the same cases on the
card. So what the CPU pins for the plain version, the card pins for the
kernel. numpy only: imports neither torch nor jax.
"""

import numpy as np

NAN, INF = np.nan, np.inf


def random_case(seed, b, k, dead=0):
    """Overlapping random boxes, scores descending, the last `dead` rows of
    every image with score 0 (padding)."""
    rng = np.random.default_rng(seed)
    x1y1 = rng.uniform(0, 300, (b, k, 2))
    wh = rng.uniform(10, 150, (b, k, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0.05, 1, (b, k)).astype(np.float32), -1)
    if dead:
        scores[:, -dead:] = 0.0
    return boxes, scores


def nan_inf_six():
    """A NaN or infinite coordinate among live boxes. Box 1 (NaN x1) and box
    3 (NaN x2) overlap nothing, since every IoU with them is NaN; box 2 is
    suppressed by box 0; box 4 (x2 = +inf) has infinite area, so IoU 0 with
    every finite box."""
    boxes = np.array([[0, 0, 100, 100], [NAN, 0, 100, 100], [0, 0, 100, 90],
                      [5, 5, NAN, 95], [0, 0, INF, 100],
                      [200, 200, 300, 300]], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.6, 0.5, 0.4], np.float32)
    expected = np.array([True, True, False, True, True, True])
    return boxes[None], scores[None], expected[None]


def nan_inf_among_live(seed=11, b=3, k=128):
    """Random overlapping boxes with NaN coordinates, +inf / -inf
    coordinates, all-NaN boxes, all-inf boxes and a NaN score planted in
    every 32-box block of every image."""
    boxes, scores = random_case(seed, b, k, dead=4)
    for img in range(b):
        for blk in range(k // 32):
            at = 32 * blk + 3 * img
            boxes[img, at + 1, 0] = NAN              # NaN x1
            boxes[img, at + 4, 3] = NAN              # NaN y2
            boxes[img, at + 7, 2] = INF              # +inf x2
            boxes[img, at + 9] = NAN                 # all-NaN box
            boxes[img, at + 12, :2] = -INF           # from -inf ...
            boxes[img, at + 12, 2:] = INF            # ... to +inf
            boxes[img, at + 15] = INF                # all +inf: inf - inf
        scores[img, 20 + img] = NAN                  # a NaN score is dead
    return boxes, scores


def cross_block_chain(k=96):
    """A (box 0) suppresses B (box 40); B overlaps C (box 80) but is dead,
    so C stays; A and C do not overlap. A, B and C lie in three different
    32-box blocks; every other box is a small box far from all others."""
    grid = np.arange(k, dtype=np.float32)
    boxes = np.stack([1000 + 20 * grid, 1000 + 0 * grid,
                      1010 + 20 * grid, 1010 + 0 * grid], -1)
    boxes[0] = [0, 0, 100, 100]      # A
    boxes[40] = [0, 30, 100, 130]    # B: IoU(A, B) = 70/130
    boxes[80] = [0, 60, 100, 160]    # C: IoU(B, C) = 70/130, IoU(A, C) = 40/160
    scores = np.linspace(0.9, 0.1, k).astype(np.float32)
    expected = np.ones(k, bool)
    expected[40] = False
    return boxes[None].astype(np.float32), scores[None], expected[None]


MAX_WH = 4096.0       # the class offset of ops/nms.nms_fixed


def class_offset(seed=41, k=128):
    """Candidates as the canonical postprocess's `nms_fixed` sweeps them:
    pixel boxes of several classes (up to class 89) shifted by
    class * 4096, coordinates up to ~3.7e5, where f32 steps by 1/32.
    Boxes overlap inside a class (jittered clusters); box 2j + 1 is box 2j
    of another class, so that equal raw boxes lie 4096 * n apart and never
    suppress each other; boxes 0 and 1 overlap across the shift (the offset moves x and
    y: box 0, class 1, reaches past (4096, 4096) into class 2's range, IoU
    0.592 with box 1, class 2).
    Returns (boxes [1, K, 4], scores [1, K], classes [K])."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([40, 40], [600, 440], (12, 2))
    at = centers[rng.integers(0, 12, k)] + rng.normal(0, 6, (k, 2))
    half = rng.uniform(15, 60, (k, 2))
    raw = np.concatenate([at - half, at + half], -1)
    raw[1::2] = raw[0::2]
    classes = rng.choice([0, 1, 2, 37, 88, 89], k).astype(np.float32)
    classes[1::2] = np.where(classes[0::2] == 89, 88, classes[0::2] + 1)
    raw[0], classes[0] = [4066, 4066, 4196, 4196], 1
    raw[1], classes[1] = [0, 0, 100, 100], 2
    boxes = (raw + classes[:, None] * MAX_WH).astype(np.float32)
    scores = -np.sort(-rng.uniform(0.05, 1, k).astype(np.float32))
    scores[-5:] = 0.0
    return boxes[None], scores[None], classes


def nms_cases():
    """Every case as (name, boxes, scores, threshold, expected or None)."""
    cases = []
    boxes, scores, expected = nan_inf_six()
    cases.append(("NaN and inf boxes, six", boxes, scores, 0.5, expected))
    boxes, scores = nan_inf_among_live()
    for t in (0.5, 0.3):
        cases.append((f"NaN and inf boxes among live ones, t={t}", boxes,
                      scores, t, None))
    boxes, scores, expected = cross_block_chain()
    cases.append(("chain across three blocks", boxes, scores, 0.5, expected))
    for k in (1, 31, 33, 100, 256, 512):
        boxes, scores = random_case(20 + k, 2, k, dead=min(3, k - 1))
        cases.append((f"K={k}", boxes, scores, 0.5, None))
    boxes, scores = random_case(31, 1, 128, dead=9)
    cases.append(("B=1", boxes, scores, 0.5, None))
    boxes, scores = random_case(32, 2, 128)
    cases.append(("all scores 0", boxes, np.zeros_like(scores), 0.5,
                  np.zeros(scores.shape, bool)))
    boxes, scores = random_case(33, 2, 100)
    boxes[:] = boxes[:, :1]
    expected = np.zeros(scores.shape, bool)
    expected[:, 0] = True
    cases.append(("all boxes identical", boxes, scores, 0.5, expected))
    # zero area: IoU = 0 / max(0, 1e-12) = 0, even of a box with itself
    boxes, scores = random_case(34, 2, 64)
    boxes[0, :, 2] = boxes[0, :, 0]          # zero width
    boxes[1, :, 2:] = boxes[1, :1, :2]       # every box the same point
    boxes[1, :, :2] = boxes[1, :1, :2]
    cases.append(("zero-area boxes", boxes, scores, 0.5,
                  np.ones(scores.shape, bool)))
    boxes, scores, _ = class_offset()
    cases.append(("class-offset boxes", boxes, scores, 0.5, None))
    return cases
