"""Person-crop extraction: crop_and_resize with TF semantics as two dense
matmuls (port of the JAX package's `ops/crop.py`).

Bilinear interpolation along an axis is a linear map, so a crop is
``Wy @ image @ Wx^T`` with interpolation-weight matrices Wy [crop_h, H]
and Wx [crop_w, W] (corner-aligned sampling over normalized y1x1y2x2 boxes,
zero extrapolation — `tf.image.crop_and_resize`, reference
`models/conv.py:59-70`).

The crop is float32 end to end. On CUDA the caller must keep TF32 off for
matmuls (`torch.backends.cuda.matmul.allow_tf32 = False`, the PyTorch
default; `pipeline/host.InferencePipeline` sets it): TF32 keeps ~3 decimal
digits, and the crop feeds keypoint localization.
"""

from __future__ import annotations

import torch


def _axis_weights(
    lo: torch.Tensor, hi: torch.Tensor, out_size: int, in_size: int
) -> torch.Tensor:
    """Bilinear sampling weights [..., out_size, in_size] for one axis.

    TF crop_and_resize maps output index i to input coordinate
        scale  = (hi-lo) * (in-1) / (out-1)
        pos(i) = lo*(in-1) + i * scale          (out > 1)
        pos    = 0.5*(lo+hi)*(in-1)             (out == 1)
    in the same f32 operation order as the JAX version. The hat function
    max(0, 1-|pos - j|) is the interpolation row; positions outside
    [0, in-1] give all-zero rows (TF's extrapolation value 0).
    """
    dev = lo.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    lo, hi = lo[..., None], hi[..., None]
    if out_size > 1:
        scale = (hi - lo) * (in_size - 1) / (out_size - 1)
        pos = lo * (in_size - 1) + i * scale
    else:
        pos = 0.5 * (lo + hi) * (in_size - 1) + i * 0.0
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = (1.0 - (pos[..., :, None] - j).abs()).clamp_min(0.0)
    in_range = (pos >= 0.0) & (pos <= in_size - 1)
    return w * in_range[..., :, None]


def crop_and_resize(
    image: torch.Tensor,
    boxes_yxyx: torch.Tensor,
    crop_h: int,
    crop_w: int,
) -> torch.Tensor:
    """Crop N normalized boxes per image and resize bilinearly.

    Args:
        image: [H, W, C] or [B, H, W, C] float.
        boxes_yxyx: [N, 4] or [B, N, 4] normalized (y1, x1, y2, x2); may
            exceed [0, 1], out-of-image samples read as 0.

    Returns:
        [N, crop_h, crop_w, C] (or [B, N, crop_h, crop_w, C]) float32.
    """
    batched = image.dim() == 4
    if not batched:
        image, boxes_yxyx = image[None], boxes_yxyx[None]
    h, w = image.shape[1], image.shape[2]
    img = image.float()
    boxes = boxes_yxyx.float()
    wy = _axis_weights(boxes[..., 0], boxes[..., 2], crop_h, h)  # [B,N,ch,H]
    wx = _axis_weights(boxes[..., 1], boxes[..., 3], crop_w, w)  # [B,N,cw,W]
    tmp = torch.einsum("bnyh,bhwc->bnywc", wy, img)
    out = torch.einsum("bnxw,bnywc->bnyxc", wx, tmp)
    return out if batched else out[0]
