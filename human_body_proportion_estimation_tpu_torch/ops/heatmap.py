"""Heatmap -> keypoint decoding for fixed person slots (port of the JAX
package's `ops/heatmap.py`).

`decode_heatmaps` is the plain version of the decode kernel
(`ops/kernels.decode_heatmaps`): argmax over the flattened maps with
numpy's first-occurrence tie rule, (x, y) recovery, zero-masking of
keypoints whose score is <= 0 (reference `modules/pose_estimator.py:75-99`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


class DecodedKeypoints(NamedTuple):
    keypoints: torch.Tensor  # [..., K, 2] (x, y) in heatmap coords
    scores: torch.Tensor     # [..., K] max heatmap activation


def decode_heatmaps(heatmaps: torch.Tensor) -> DecodedKeypoints:
    """Argmax-decode keypoints from heatmaps [..., K, H, W].

    x = idx % W, y = idx // W, score = max; keypoints with score <= 0 are
    zeroed. The index is the smallest row-major position equal to the
    max (`torch.argmax` does not promise which tie it returns). A map that
    holds a NaN reports a NaN score and the keypoint (0, 0), as the JAX
    package does (`amax` propagates NaN and `NaN > 0` is false), so the
    visibility gate `score >= t` fails for it; the other maps of the batch
    are unaffected, and -inf / +inf are ordinary values.
    """
    w = heatmaps.shape[-1]
    flat = heatmaps.flatten(-2).float()
    scores = flat.amax(-1)
    n = flat.shape[-1]
    lin = torch.arange(n, device=flat.device)
    # nothing equals a NaN score: such a map falls to index 0
    idx = torch.where(flat == scores[..., None], lin, n).amin(-1)
    idx = torch.where(idx == n, 0, idx)
    x = (idx % w).float()
    y = torch.div(idx, w, rounding_mode="floor").float()
    kpts = torch.stack([x, y], dim=-1)
    kpts = torch.where(scores[..., None] > 0.0, kpts, 0.0)
    return DecodedKeypoints(kpts, scores)


def refine_subpixel(
    keypoints: torch.Tensor, heatmaps: torch.Tensor, delta: float = 0.25
) -> torch.Tensor:
    """Quarter-pixel refinement toward the higher neighbor along each axis
    (opt-in standard HRNet post-process; interior maxima only)."""
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    x = keypoints[..., 0].long()
    y = keypoints[..., 1].long()
    flat = heatmaps.flatten(-2)

    def at(dy, dx):
        yy = (y + dy).clamp(0, h - 1)
        xx = (x + dx).clamp(0, w - 1)
        return torch.gather(flat, -1, (yy * w + xx)[..., None])[..., 0]

    dx_sign = torch.sign(at(0, 1) - at(0, -1))
    dy_sign = torch.sign(at(1, 0) - at(-1, 0))
    refined = keypoints + delta * torch.stack([dx_sign, dy_sign], dim=-1)
    interior = ((x > 0) & (x < w - 1) & (y > 0) & (y < h - 1))[..., None]
    return torch.where(interior, refined, keypoints)


def remap_to_image(
    keypoints_hm: torch.Tensor,
    boxes_yxyx_px: torch.Tensor,
    heatmap_hw: Tuple[int, int],
) -> torch.Tensor:
    """Heatmap-space keypoints [..., K, 2] -> original-image pixels, via the
    int-truncated box corners [..., 4] (reference
    `person_det_pose_edet4_trtserver.py:151-160`)."""
    hm_h, hm_w = heatmap_hw
    b = torch.trunc(boxes_yxyx_px)
    x1, y1 = b[..., 1], b[..., 0]
    crop_w = b[..., 3] - b[..., 1]
    crop_h = b[..., 2] - b[..., 0]
    scale = torch.stack([crop_w / hm_w, crop_h / hm_h], dim=-1)
    offset = torch.stack([x1, y1], dim=-1)
    return keypoints_hm * scale[..., None, :] + offset[..., None, :]


def gate_keypoints(
    scores: torch.Tensor, thresholds: Sequence[float] | torch.Tensor
) -> torch.Tensor:
    """Visibility mask [..., K]: score >= per-keypoint threshold.
    `thresholds`: a sequence, or a [K] f32 tensor already on the scores'
    device (a sequence is copied there from the host)."""
    if not isinstance(thresholds, torch.Tensor):
        thresholds = torch.as_tensor(thresholds, dtype=torch.float32,
                                     device=scores.device)
    return scores >= thresholds
