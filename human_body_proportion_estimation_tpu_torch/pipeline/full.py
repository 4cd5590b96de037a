"""The fused image -> body-proportions forward (port of the JAX package's
`pipeline/full.py`).

    uint8 image -> EfficientDet person slots -> bbox expand -> crop
    -> HRNet -> heatmap argmax decode (CUDA kernel) -> confidence gating
    -> coord remap -> pixel->cm -> 11 segment lengths

Fixed shapes throughout: persons are padded to `max_persons` slots with
validity masks. Detection and crops live in det-input space; keypoints
and pixel heights are de-normalized to each image's original size
(`orig_hw`). The four stages are profiler spans (`utils.profiling.span`:
`hbpe.detector`, `hbpe.crop`, `hbpe.pose`, `hbpe.decode_cm`, each tagged
with the batch its thread serves) that a `torch.profiler` run reads
(`chip_smoke.py --profile`, the benchmark's traced slice).

`ServingProgram` is the serving forward as an `nn.Module` over the
backend's and the pose model's modules: what `torch.export` takes to make
the deployable artifact (`pipeline/export.py`). An export keeps neither
the spans nor `torch.inference_mode`: they are not operations of the
graph.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from human_body_proportion_estimation_tpu_torch.ops import (
    boxes as box_ops,
    crop as crop_ops,
    heatmap as hm_ops,
    kernels,
    proportions as prop_ops,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    PipelineConfig,
)
from human_body_proportion_estimation_tpu_torch.utils.profiling import span


class PipelineOutputs(NamedTuple):
    """Fixed-shape outputs for a batch of B images."""

    boxes_norm: torch.Tensor     # [B, P, 4] normalized yxyx (expanded)
    boxes_orig: torch.Tensor     # [B, P, 4] yxyx in ORIGINAL image pixels
    person_valid: torch.Tensor   # [B, P] bool
    det_scores: torch.Tensor     # [B, P] person detection scores
    keypoints: torch.Tensor      # [B, P, 17, 2] (x, y) in ORIGINAL image px
    kp_scores: torch.Tensor      # [B, P, 17] heatmap confidences
    kp_visible: torch.Tensor     # [B, P, 17] bool (threshold-gated)
    lengths_cm: torch.Tensor     # [B, P, 11]
    seg_visible: torch.Tensor    # [B, P, 11] bool
    heatmaps: Optional[torch.Tensor]  # [B, P, 17, Hm, Wm] (debug variant)


def select_persons(
    boxes_yxyx: torch.Tensor,   # [B, D, 4]
    scores: torch.Tensor,       # [B, D]
    classes: torch.Tensor,      # [B, D]
    valid: torch.Tensor,        # [B, D]
    det_threshold: torch.Tensor,  # [B]
    person_class_id: int,
    max_persons: int,
):
    """Person-class filter + score threshold + top-K slots (reference
    `models/conv.py:22-35`). The top-K is a stable descending sort, as
    `jax.lax.top_k` keeps the lower index first on ties."""
    is_person = (
        valid
        & (classes == float(person_class_id))
        & (scores >= det_threshold[:, None])
    )
    masked = torch.where(is_person, scores, 0.0)
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top, idx = top[:, :max_persons], idx[:, :max_persons]
    boxes = torch.gather(boxes_yxyx, 1, idx[..., None].expand(-1, -1, 4))
    return boxes, top, top > 0.0


def pack_serving(person_valid: torch.Tensor, lengths_cm: torch.Tensor,
                 seg_visible: torch.Tensor) -> torch.Tensor:
    """Everything the HTTP response needs, packed into one [B, P, 23] f32
    tensor (valid | 11 lengths | 11 visibility): one readback."""
    return torch.cat([person_valid.float()[..., None], lengths_cm,
                      seg_visible.float()], dim=-1)


class ServingProgram(torch.nn.Module):
    """The fused forward as a module over a detector backend and a pose
    model (both `nn.Module`s, registered as its submodules: their
    parameters and buffers are its own, shared and not copied). `forward`
    is the serving forward: (images u8 [B, H, W, 3], thresholds [B],
    heights [B, P], orig_hw [B, 2]) -> packed [B, P, 23]."""

    def __init__(self, config: PipelineConfig, backend: torch.nn.Module,
                 pose: torch.nn.Module):
        super().__init__()
        self.config = config
        self.backend = backend
        self.pose = pose

    def forward(self, images, det_threshold, person_heights, orig_hw):
        out = self.outputs(images, det_threshold, person_heights, orig_hw)
        return pack_serving(out.person_valid, out.lengths_cm,
                            out.seg_visible)

    def outputs(
        self,
        images: torch.Tensor,          # [B, H, W, 3] uint8 RGB (det size)
        det_threshold: torch.Tensor,   # [B] f32
        person_heights: torch.Tensor,  # [B, P] cm
        orig_hw: torch.Tensor,         # [B, 2] original (h, w) per image
        with_heatmaps: bool = False,
    ) -> PipelineOutputs:
        cfg = self.config
        h, w = cfg.detector.input_height, cfg.detector.input_width
        p = cfg.detector.max_persons
        k = cfg.pose.num_keypoints
        b = images.shape[0]
        images_f32 = images.float()

        with span("detector"):
            boxes_px, det_scores, person_valid = self.backend(
                images_f32, det_threshold)

        with span("crop"):
            # bbox expand + normalize (x expand w//17, y expand 0)
            boxes_norm = box_ops.expand_clip_normalize_yxyx(
                boxes_px, float(cfg.x_expand), 0.0, h, w)
            # person crops from the /255 image, f32
            crops = crop_ops.crop_and_resize(
                images_f32 / 255.0, boxes_norm, cfg.pose.crop_height,
                cfg.pose.crop_width)                  # [B, P, ch, cw, 3]
            crops = crops.reshape(b * p, cfg.pose.crop_height,
                                  cfg.pose.crop_width, 3).permute(0, 3, 1, 2)

        with span("pose"):
            heatmaps = self.pose(crops).contiguous()  # [B*P, K, Hm, Wm] f32
        hm_h, hm_w = heatmaps.shape[-2:]

        with span("decode_cm"):
            kp_flat, sc_flat = kernels.decode_heatmaps(heatmaps)
            kp_hm = kp_flat.reshape(b, p, k, 2)
            kp_scores = sc_flat.reshape(b, p, k)
            heatmaps = heatmaps.reshape(b, p, k, hm_h, hm_w)
            if cfg.pose.subpixel_refine:
                kp_hm = hm_ops.refine_subpixel(kp_hm, heatmaps)
            kp_visible = hm_ops.gate_keypoints(
                kp_scores, cfg.pose.keypoint_thresholds)

            # de-normalize boxes to ORIGINAL image space + remap keypoints
            scale = torch.cat([orig_hw, orig_hw], dim=-1)   # [B, 4] hwhw
            boxes_orig = boxes_norm * scale[:, None, :]
            kp_img = hm_ops.remap_to_image(kp_hm, boxes_orig, (hm_h, hm_w))

            # pixel -> cm + segments
            bt = torch.trunc(boxes_orig)
            pixel_height = bt[..., 2] - bt[..., 0]
            pixel_to_cm = person_heights / pixel_height.clamp_min(1.0)
            seg = prop_ops.segment_lengths(kp_img, kp_visible, pixel_to_cm)
            seg_visible = seg.visible & person_valid[..., None]

        return PipelineOutputs(
            boxes_norm=boxes_norm,
            boxes_orig=boxes_orig,
            person_valid=person_valid,
            det_scores=det_scores,
            keypoints=kp_img,
            kp_scores=kp_scores,
            kp_visible=kp_visible,
            lengths_cm=torch.where(seg_visible, seg.lengths_cm, 0.0),
            seg_visible=seg_visible,
            heatmaps=heatmaps if with_heatmaps else None,
        )
