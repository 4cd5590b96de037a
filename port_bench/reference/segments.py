"""The 11 body segments of the served answer, in its order: each is the
distance between two endpoints, an endpoint a keypoint or the mean of
two (COCO's 17 keypoints)."""

from __future__ import annotations

import numpy as np

# (endpoint 1 keypoint weights, endpoint 2 keypoint weights) of the 11
# segments, in the order of the served answer
SEGMENTS = (
    ("shoulder", {5: 1.0}, {6: 1.0}),
    ("torso", {11: 0.5, 12: 0.5}, {5: 0.5, 6: 0.5}),
    ("lshoulder_lelbow", {5: 1.0}, {7: 1.0}),
    ("rshoulder_relbow", {6: 1.0}, {8: 1.0}),
    ("lwrist_lelbow", {9: 1.0}, {7: 1.0}),
    ("rwrist_relbow", {10: 1.0}, {8: 1.0}),
    ("rhip_lhip", {12: 1.0}, {11: 1.0}),
    ("rhip_rknee", {12: 1.0}, {14: 1.0}),
    ("lhip_lknee", {11: 1.0}, {13: 1.0}),
    ("rankle_rknee", {16: 1.0}, {14: 1.0}),
    ("lankle_lknee", {15: 1.0}, {13: 1.0}),
)
SEGMENT_NAMES = tuple(s[0] for s in SEGMENTS)


def segment_matrices(k: int = 17):
    """(endpoint-1 weights, endpoint-2 weights, required keypoints), each
    [11, k]."""
    p1 = np.zeros((len(SEGMENTS), k), np.float32)
    p2 = np.zeros_like(p1)
    for s, (_, w1, w2) in enumerate(SEGMENTS):
        for kp, v in w1.items():
            p1[s, kp] = v
        for kp, v in w2.items():
            p2[s, kp] = v
    return p1, p2, (p1 != 0) | (p2 != 0)
