"""Wrappers of the port's three CUDA kernels, their plain PyTorch versions,
and their launch counters.

Port of the JAX package's `ops/pallas_kernels.py`:

  JAX (Pallas, TPU)                         port (CUDA, sm_90a)
  decode_heatmaps_pallas  :56               decode_heatmaps  csrc/decode_heatmaps.cu
  head_score_epilogue     :228              head_score       csrc/head_score.cu
  nms_sweep_pallas_batched :151 (+ :190)    nms_sweep        csrc/nms_sweep.cu

Dispatch is by the device of the input and nothing else: a CPU tensor goes
to the plain version (the CPU tests), a CUDA tensor launches the kernel or
raises. There is no fallback from a failed launch to the plain version.
Every launch adds one to `LAUNCHES[name]`, so a run can show that it went
through the kernels (`reset_launch_counts` / `launch_counts`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from human_body_proportion_estimation_tpu_torch.ops import (
    heatmap as hm_ops,
    nms as nms_ops,
)

LAUNCHES: Dict[str, int] = {
    "decode_heatmaps": 0, "head_score": 0, "nms_sweep": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors must all be on cpu or all on cuda: {devs}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _launch(name: str, fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def _lib():
    from human_body_proportion_estimation_tpu_torch.ops.build import (
        load_library,
    )

    return load_library()


# --------------------------------------------------------------------- #
# heatmap decode


def decode_heatmaps_plain(
    heatmaps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return tuple(hm_ops.decode_heatmaps(heatmaps))


def decode_heatmaps(
    heatmaps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, K, H, W] f32 -> (keypoints [N, K, 2] (x, y), scores [N, K])."""
    if _on_cpu(heatmaps):
        return decode_heatmaps_plain(heatmaps)
    _check(heatmaps, "heatmaps", torch.float32, 4)
    n, k, h, w = heatmaps.shape
    kp = torch.empty((n, k, 2), dtype=torch.float32, device=heatmaps.device)
    scores = torch.empty((n, k), dtype=torch.float32, device=heatmaps.device)
    _launch("decode_heatmaps", _lib().hbpe_decode_heatmaps,
            heatmaps.data_ptr(), kp.data_ptr(), scores.data_ptr(),
            n * k, h * w, w)
    return kp, scores


# --------------------------------------------------------------------- #
# detection-head score epilogue


def head_score_plain(
    z: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    anchors_per_cell: int,
    num_classes: int,
    person_class0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as the kernel with the logits materialized:
    bf16-rounded inputs, f32 products and sums, + bias, then the per-anchor
    class max and the person logit taken from the same tensor."""
    b, h, w, f = z.shape
    zf = z.reshape(-1, f).to(torch.bfloat16).float()
    wf = weight.to(torch.bfloat16).float()
    y = zf @ wf.t() + bias.float()
    y = y.reshape(b, h, w, anchors_per_cell, num_classes)
    return y.amax(-1), y[..., person_class0].contiguous()


def head_score(
    z: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    anchors_per_cell: int,
    num_classes: int,
    person_class0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused class-head predict conv + score reduction.

    z [B, H, W, F] head features (NHWC, as the JAX function takes them),
    weight [A*C, F] (the 1x1 predict conv's OIHW weight without its unit
    spatial dims), bias [A*C]. On CUDA, z and weight must already be bf16
    and bias f32. Returns (best_logit, person_logit), each [B, H, W, A] f32.
    """
    if _on_cpu(z, weight, bias):
        return head_score_plain(z, weight, bias, anchors_per_cell,
                                num_classes, person_class0)
    a, c = anchors_per_cell, num_classes
    _check(z, "z", torch.bfloat16, 4)
    _check(weight, "weight", torch.bfloat16, 2)
    _check(bias, "bias", torch.float32, 1)
    b, h, w, f = z.shape
    if weight.shape != (a * c, f) or bias.shape != (a * c,):
        raise ValueError(
            f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} do not "
            f"match {a} anchors x {c} classes over {f} features"
        )
    m = b * h * w
    best = torch.empty((b, h, w, a), dtype=torch.float32, device=z.device)
    person = torch.empty_like(best)
    _launch("head_score", _lib().hbpe_head_score,
            z.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            best.data_ptr(), person.data_ptr(), m, f, a, c, person_class0)
    return best, person


# --------------------------------------------------------------------- #
# NMS sweep


def nms_sweep_plain(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    return nms_ops.nms_mask(boxes, scores, iou_threshold)


def nms_sweep(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Batched greedy-NMS keep masks: boxes [B, K, 4] xyxy sorted by
    descending score, scores [B, K] -> keep [B, K] bool. K <= 256."""
    if _on_cpu(boxes, scores):
        return nms_sweep_plain(boxes, scores, iou_threshold)
    _check(boxes, "boxes", torch.float32, 3)
    _check(scores, "scores", torch.float32, 2)
    b, k, _ = boxes.shape
    if boxes.shape[2] != 4 or scores.shape != (b, k) or k > 256:
        raise ValueError(
            f"boxes {tuple(boxes.shape)} / scores {tuple(scores.shape)}: "
            "expected [B, K, 4] / [B, K] with K <= 256"
        )
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    _launch("nms_sweep", _lib().hbpe_nms_sweep,
            boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), b, k,
            float(iou_threshold))
    return keep
