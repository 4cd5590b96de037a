"""Body-proportion geometry: keypoints -> 11 segment lengths in cm (port of
the JAX package's `ops/proportions.py`).

Each segment endpoint is a fixed weighted combination of the 17 keypoints
(midpoints = 0.5/0.5 rows), so both endpoints of all 11 segments come from
two constant [11, 17] matrices. The left/right mirror of the reference's
segment names (`modules/pose_estimator.py:156-166`) is encoded in them.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Union

import numpy as np
import torch

NUM_KEYPOINTS = 17

# (name, endpoint-1 kp weights, endpoint-2 kp weights); order matches the
# reference dict insertion order so responses enumerate identically
_SEGMENT_SPEC = [
    ("shoulder", {5: 1.0}, {6: 1.0}),
    ("torso", {11: 0.5, 12: 0.5}, {5: 0.5, 6: 0.5}),  # crotch -> chest
    ("lshoulder_lelbow", {5: 1.0}, {7: 1.0}),
    ("rshoulder_relbow", {6: 1.0}, {8: 1.0}),
    ("lwrist_lelbow", {9: 1.0}, {7: 1.0}),
    ("rwrist_relbow", {10: 1.0}, {8: 1.0}),
    ("rhip_lhip", {12: 1.0}, {11: 1.0}),
    ("rhip_rknee", {12: 1.0}, {14: 1.0}),
    ("lhip_lknee", {11: 1.0}, {13: 1.0}),
    ("rankle_rknee", {16: 1.0}, {14: 1.0}),
    ("lankle_lknee", {15: 1.0}, {13: 1.0}),
]

SEGMENT_NAMES: List[str] = [s[0] for s in _SEGMENT_SPEC]
NUM_SEGMENTS = len(_SEGMENT_SPEC)

NOT_VISIBLE = "Part not visible"  # reference modules/pose_estimator.py:198


def _build_matrices():
    p1 = np.zeros((NUM_SEGMENTS, NUM_KEYPOINTS), np.float32)
    p2 = np.zeros((NUM_SEGMENTS, NUM_KEYPOINTS), np.float32)
    req = np.zeros((NUM_SEGMENTS, NUM_KEYPOINTS), bool)
    for s, (_, w1, w2) in enumerate(_SEGMENT_SPEC):
        for k, v in w1.items():
            p1[s, k] = v
            req[s, k] = True
        for k, v in w2.items():
            p2[s, k] = v
            req[s, k] = True
    return p1, p2, req


_P1, _P2, _REQUIRED = _build_matrices()


def segment_matrices(device: torch.device):
    """(endpoint-1 weights [11, 17] f32, endpoint-2 weights, required
    keypoints [11, 17] bool) on `device`: what `segment_lengths` reads, for
    a caller that keeps them there."""
    return tuple(torch.from_numpy(m).to(device)
                 for m in (_P1, _P2, _REQUIRED))


class SegmentLengths(NamedTuple):
    lengths_cm: torch.Tensor  # [..., NUM_SEGMENTS] float32
    visible: torch.Tensor     # [..., NUM_SEGMENTS] bool


def segment_lengths(
    keypoints: torch.Tensor,
    visible: torch.Tensor,
    pixel_to_cm: torch.Tensor,
    matrices=None,
) -> SegmentLengths:
    """The 11 segment lengths in cm with visibility masks.

    keypoints [..., 17, 2] image-space (x, y); visible [..., 17] bool;
    pixel_to_cm [...] = person_height_cm / bbox_pixel_height. A segment is
    visible iff every required keypoint passed its gate and its pixel
    distance is > 0. `matrices`: `segment_matrices` on the keypoints'
    device, if the caller holds them (copied from the host otherwise).
    """
    p1, p2, req = matrices or segment_matrices(keypoints.device)

    kp = keypoints.float()
    e1 = torch.einsum("sk,...kc->...sc", p1, kp)
    e2 = torch.einsum("sk,...kc->...sc", p2, kp)
    dist_px = torch.linalg.vector_norm(e1 - e2, dim=-1)  # [..., 11]

    seg_visible = torch.where(req, visible[..., None, :], True).all(-1)
    seg_visible &= dist_px > 0.0
    lengths_cm = dist_px * pixel_to_cm[..., None]
    return SegmentLengths(
        torch.where(seg_visible, lengths_cm, 0.0), seg_visible
    )


def to_dist_dict(
    lengths_cm: np.ndarray, visible: np.ndarray
) -> Dict[str, Union[float, str]]:
    """One person's segments as the response dict: cm value per segment
    name, or the "Part not visible" sentinel
    (reference `modules/pose_estimator.py:191-200`)."""
    return {
        name: float(lengths_cm[i]) if bool(visible[i]) else NOT_VISIBLE
        for i, name in enumerate(SEGMENT_NAMES)
    }
