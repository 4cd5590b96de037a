"""The work each of the program's hand-written kernels must do at a call's
shapes, counted from the algorithm and not from an implementation: every
input byte read once, every output byte written once (the counts that
`chip_smoke.py`'s kernel phase used). `bound_s` turns a count into the
least time the card could take, and says which of the two bounds it."""

from __future__ import annotations

from typing import Sequence, Tuple

from port_bench import peaks

KERNEL_NAMES = {               # trace name of each kernel's device function
    "head_score": "head_score_kernel",
    "nms_sweep": "nms_sweep_kernel",
}


def head_score(batch: int, level_cells: Sequence[int], features: int,
               anchors: int, classes: int) -> Tuple[float, float, float]:
    """The class head's 1x1 predict conv over every level's cells and the
    per-anchor class max: (bytes, operations, peak ops/s). bf16 z and
    weights in, f32 bias in, f32 best and person logits out."""
    m = batch * sum(level_cells)
    nbytes = (m * features * 2 + anchors * classes * features * 2
              + anchors * classes * 4 + 2 * m * anchors * 4)
    return nbytes, 2.0 * m * features * anchors * classes, \
        peaks.BF16_FLOP_PER_S


def nms_sweep(batch: int, k: int):
    """Greedy keep masks of [batch, k] score-sorted boxes: boxes and scores
    in, one byte a keep flag out; the K (K - 1) / 2 pairs j < i a keep mask
    reads, 14 operations an IoU test."""
    return (batch * k * 4 * 4 + batch * k * 4 + batch * k,
            14.0 * batch * k * (k - 1) / 2, peaks.F32_FLOP_PER_S)


def bound_s(nbytes: float, ops: float, peak_ops: float) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations")."""
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    t_ops = ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_cells(h: int, w: int, levels=(3, 4, 5, 6, 7)):
    return [-(-h // 2 ** l) * -(-w // 2 ** l) for l in levels]
