"""Image preprocessing ops (port of the JAX package's `ops/image.py`).

All functions take NHWC (or HWC) tensors and static output sizes, as the
JAX functions do. The resizes are the JAX package's `jax.image.resize`
written out: for every spatial dimension whose size changes, a weight
matrix [in, out] built as `jax.image.scale_and_translate` builds it
(half-pixel centres, the kernel widened by the downscale factor when
`antialias`, weights renormalized to sum 1 at the borders), applied as an
f32 matrix product; a dimension whose size does not change is left as it
is. `torch.nn.functional.interpolate` is not used: its bicubic kernel is
Keys a = -0.75 without antialias, and its border rules differ.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def aspect_resize_shape(
    in_h: int, in_w: int, width: int | None, height: int | None
) -> Tuple[int, int]:
    """Output (h, w) of the reference's aspect-preserving resize rules
    (`modules/utils.py:140-159`, `resize_maintaining_aspect`): both dims
    given are used; one None is scaled from the other by integer floor
    division; both None keep the input size."""
    if width is not None and height is not None:
        return height, width
    if width is None and height is not None:
        return height, (in_w * height) // in_h
    if width is not None and height is None:
        return (width * in_h) // in_w, width
    return in_h, in_w


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic convolution kernel, a = -0.5 (jax.image's CUBIC)."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str,
                  antialias: bool) -> np.ndarray:
    """[in_size, out_size] f32 resampling weights of one dimension, the
    `compute_weight_mat` of `jax.image` in its f32 operation order."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = _KERNELS[method](x.astype(f32))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def _resize(x: torch.Tensor, out_h: int, out_w: int, method: str,
            antialias: bool) -> torch.Tensor:
    """f32 [..., H, W, C] -> [..., out_h, out_w, C] (jax.image.resize)."""
    in_h, in_w = x.shape[-3], x.shape[-2]
    if in_h != out_h:
        w = torch.from_numpy(weight_matrix(in_h, out_h, method, antialias))
        x = torch.einsum("...hwc,hk->...kwc", x, w.to(x.device))
    if in_w != out_w:
        w = torch.from_numpy(weight_matrix(in_w, out_w, method, antialias))
        x = torch.einsum("...hwc,wk->...hkc", x, w.to(x.device))
    return x


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex)


def resize_bilinear(img: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centres and no antialias (the
    cv2.INTER_LINEAR convention; `jax.image.resize(method="linear",
    antialias=False)`). Integer images are rounded (half to even) and
    clipped to [0, 255]; the dtype is kept."""
    out = _resize(img.float(), out_h, out_w, "linear", False)
    if _is_int(img):
        out = out.round().clamp(0, 255)
    return out.to(img.dtype)


def letterbox(
    img: torch.Tensor,
    out_h: int,
    out_w: int,
    in_h: int | None = None,
    in_w: int | None = None,
    pad_value: float = 128.0,
) -> torch.Tensor:
    """Resize keeping aspect, then pad to (out_h, out_w) with gray.

    The reference YOLOv5 preprocess (`modules/onnx_utils.py:225-235`):
    scale = min(W / iw, H / ih), bicubic resize (Keys a = -0.5, antialiased
    when shrinking, as jax.image's "cubic"), centred paste on a gray
    canvas with the reference's floor arithmetic, so that
    `ops/boxes.scale_coords_letterbox` inverts it. At 480x640 -> 640x640
    the scale is 1: no resize, 80 rows of padding above and below.
    """
    if in_h is None:
        in_h = img.shape[-3]
    if in_w is None:
        in_w = img.shape[-2]
    scale = min(out_w / in_w, out_h / in_h)
    new_w, new_h = int(in_w * scale), int(in_h * scale)

    resized = _resize(img.float(), new_h, new_w, "cubic", True)
    if _is_int(img):
        resized = resized.round().clamp(0, 255)
    pad_top = (out_h - new_h) // 2
    pad_left = (out_w - new_w) // 2
    out = torch.full((*img.shape[:-3], out_h, out_w, img.shape[-1]),
                     float(pad_value), dtype=torch.float32, device=img.device)
    out[..., pad_top:pad_top + new_h, pad_left:pad_left + new_w, :] = resized
    return out.to(img.dtype)


def normalize_uint8(img: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0, 255] -> float [0, 1] (reference `models/conv.py:59-60`)."""
    return img.to(dtype) / torch.tensor(255.0, dtype=dtype)


def bgr_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """Channel flip (the reference uses cv2.cvtColor BGR2RGB)."""
    return img.flip(-1)


def hwc_to_chw(img: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW / HWC -> CHW."""
    return img.movedim(-1, -3)
