"""EfficientDet-Lite detector with the fused person-score head (port of the
JAX package's `models/efficientdet.py`, score-kernel serving path).

EfficientNet-Lite trunk -> BiFPN (unweighted-sum fusion, ReLU6) -> shared
separable-conv class/box heads over P3..P7 (9 anchors per cell). The class
head's final 1x1 predict conv is the CUDA head-score kernel
(`ops/kernels.head_score_levels`, one launch for the five levels), which
reduces the 90 class logits of each anchor to the best logit and the
person logit without writing the logits out. `forward` returns
`(best_logit [B, N], person_logit [B, N], box_flat [B, N, 4])`,
level-major like the anchors, which is the flax
`EfficientDet(score_kernel=True)(..., prescored=True)` contract.

`forward(images, all_classes=True)` is the canonical head of the same
module and parameters (flax `EfficientDet(score_kernel=False)`): the class
predict conv runs in f32 over all classes and `(cls_flat [B, N, C],
box_flat [B, N, 4])` come back; `postprocess` turns one image of them into
the 100-slot detection tensors (all-class greedy NMS through
`ops/nms.nms_fixed`). The model registry serves that path, so it adds no
second copy of the weights.

`model.train()` (flax `train=True`) trains through the canonical head
(`training/detection.py`): every BatchNorm takes batch statistics
(`layers.batch_norm`). The head-score kernel's packed weights are keyed on
the predict conv's version counter, which every in-place optimizer update
moves, so a serving forward after training scores with the trained weights.

Traps handled here:
  * `jax.image.resize(..., "nearest")` (BiFPN top-down path) samples like
    `F.interpolate(mode="nearest-exact")`, not `mode="nearest"`: at
    8x10 -> 15x20 the two pick different source rows.
  * The 3x3/s2 max pool with flax "SAME" pads TF-style with -inf
    (`layers.max_pool_same`).
  * HeadNet shares its conv weights across levels but keeps one BN per
    level (`bn{r}_l{li}`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from human_body_proportion_estimation_tpu_torch.models.anchors import (
    AnchorConfig,
    decode_boxes,
    generate_anchors,
)
from human_body_proportion_estimation_tpu_torch.models.efficientnet_lite import (
    LITE0,
    LITE4,
    EfficientNetLite,
    EfficientNetLiteConfig,
)
from human_body_proportion_estimation_tpu_torch.models.layers import (
    Conv2d,
    ConvBN,
    SeparableConvBN,
    batch_norm,
    max_pool_same,
    relu6,
)
from human_body_proportion_estimation_tpu_torch.ops import (
    kernels,
    nms as nms_ops,
)


@dataclasses.dataclass(frozen=True)
class EfficientDetConfig:
    backbone: EfficientNetLiteConfig = LITE4
    fpn_channels: int = 224
    fpn_repeats: int = 7
    head_repeats: int = 4
    num_classes: int = 90
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    max_detections: int = 100


EFFICIENTDET_LITE4 = EfficientDetConfig()
EFFICIENTDET_LITE0 = EfficientDetConfig(
    backbone=LITE0, fpn_channels=64, fpn_repeats=3, head_repeats=3
)


class ResampleDown(nn.Module):
    """1x1 channel adapt (conv+BN, only when channels differ) + stride-2
    max pool (P5 -> P6 -> P7)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.adapt = (
            ConvBN(cin, features, 1, act=None, bn_eps=1e-3)
            if cin != features else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.adapt is not None:
            x = self.adapt(x)
        return max_pool_same(x)


class BiFPNLayer(nn.Module):
    """One bidirectional FPN pass (top-down then bottom-up), sum fusion.

    Every node that consumes a feature whose channel count differs from the
    FPN width owns its own 1x1 conv+BN resample (`td_resample_{i}`,
    `bu_resample_{i}`), as in the automl topology the flax module mirrors.
    """

    def __init__(self, in_channels: List[int], features: int):
        super().__init__()
        n = len(in_channels)
        self.n = n
        for i in range(n - 2, -1, -1):
            if in_channels[i] != features:
                self.add_module(f"td_resample_{i}", ConvBN(
                    in_channels[i], features, 1, act=None, bn_eps=1e-3))
            self.add_module(f"td_{i}", SeparableConvBN(features, features))
        for i in range(1, n):
            if i < n - 1 and in_channels[i] != features:
                self.add_module(f"bu_resample_{i}", ConvBN(
                    in_channels[i], features, 1, act=None, bn_eps=1e-3))
            self.add_module(f"bu_{i}", SeparableConvBN(features, features))

    def _resample(self, x: torch.Tensor, name: str) -> torch.Tensor:
        conv = getattr(self, name, None)
        return x if conv is None else conv(x)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        n = self.n
        td = [None] * n
        td[n - 1] = feats[n - 1]
        for i in range(n - 2, -1, -1):
            # nearest resize to the exact level shape (odd level dims make
            # a fixed 2x upsample overshoot); "nearest-exact" is the
            # sampling rule of jax.image.resize's "nearest"
            up = F.interpolate(td[i + 1], size=feats[i].shape[-2:],
                               mode="nearest-exact")
            lat = self._resample(feats[i], f"td_resample_{i}")
            td[i] = getattr(self, f"td_{i}")(relu6(lat + up))
        out = [None] * n
        out[0] = td[0]
        for i in range(1, n):
            s = td[i] + max_pool_same(out[i - 1])
            if i < n - 1:
                s = s + self._resample(feats[i], f"bu_resample_{i}")
            out[i] = getattr(self, f"bu_{i}")(relu6(s))
        return out


class HeadNet(nn.Module):
    """Class/box head: repeated separable convs with weights shared across
    pyramid levels and one BatchNorm per level, then a shared depthwise +
    1x1 prediction conv."""

    def __init__(self, out_channels: int, repeats: int, features: int,
                 num_levels: int):
        super().__init__()
        self.repeats = repeats
        for r in range(repeats):
            self.add_module(f"dw{r}", Conv2d(features, features, 3,
                                             groups=features))
            self.add_module(f"pw{r}", Conv2d(features, features, 1,
                                             bias=True))
            for li in range(num_levels):
                self.add_module(f"bn{r}_l{li}",
                                nn.BatchNorm2d(features, eps=1e-3))
        self.predict_dw = Conv2d(features, features, 3, groups=features)
        self.predict_pw = Conv2d(features, out_channels, 1, bias=True)

    def features(self, x: torch.Tensor, li: int) -> torch.Tensor:
        """Level `li` through the shared repeats and predict_dw -> z."""
        for r in range(self.repeats):
            x = getattr(self, f"pw{r}")(getattr(self, f"dw{r}")(x))
            x = relu6(batch_norm(getattr(self, f"bn{r}_l{li}"), x))
        return self.predict_dw(x)


class EfficientDet(nn.Module):
    """[B, H, W, 3] uint8/float image -> (best_logit [B, N],
    person_logit [B, N], box_regs [B, N, 4])."""

    def __init__(self, config: EfficientDetConfig = EFFICIENTDET_LITE4,
                 dtype: torch.dtype = torch.bfloat16,
                 person_class0: int = 0):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.person_class0 = person_class0
        self.backbone = EfficientNetLite(cfg.backbone)
        c3, c4, c5 = self.backbone.out_channels
        fpn = cfg.fpn_channels
        self.p6_down = ResampleDown(c5, fpn)
        self.p7_down = ResampleDown(fpn, fpn)
        chans = [c3, c4, c5, fpn, fpn]
        for i in range(cfg.fpn_repeats):
            self.add_module(f"bifpn{i}", BiFPNLayer(chans, fpn))
            chans = [fpn] * 5
        na = cfg.anchors.anchors_per_cell
        self.class_net = HeadNet(na * cfg.num_classes, cfg.head_repeats,
                                 fpn, 5)
        self.box_net = HeadNet(na * 4, cfg.head_repeats, fpn, 5)
        self.eval()     # flax's train=False default (layers.batch_norm)

    def forward(self, images: torch.Tensor, all_classes: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        """Score-kernel path: (best_logit [B, N], person_logit [B, N],
        box_flat [B, N, 4]). `all_classes=True`: the canonical head,
        (cls_flat [B, N, C] f32 logits, box_flat [B, N, 4])."""
        cfg = self.config
        if self.training and not all_classes:
            # the JAX model takes the kernel only when not training
            # (efficientdet.py:273); the kernel has no backward
            raise ValueError("a training forward runs the canonical head: "
                             "pass all_classes=True")
        b = images.shape[0]
        na, nc = cfg.anchors.anchors_per_cell, cfg.num_classes
        # automl lite preprocessing: scale to [-1, 1]
        x = (images.float() - 127.0) / 128.0
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        c3, c4, c5 = self.backbone(x)
        p6 = self.p6_down(c5)
        feats = [c3, c4, c5, p6, self.p7_down(p6)]
        for i in range(cfg.fpn_repeats):
            feats = getattr(self, f"bifpn{i}")(feats)

        zs, classes, boxes = [], [], []
        for li, f in enumerate(feats):
            z = self.class_net.features(f, li)
            if all_classes:
                # the canonical head's class predict conv runs in f32 (flax
                # dtype=float32), as the box head's does
                o = self.class_net.predict_pw(z.float())
                classes.append(o.permute(0, 2, 3, 1).reshape(b, -1, nc))
            else:
                zs.append(
                    z.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous())
            zb = self.box_net.features(f, li).float()
            o = self.box_net.predict_pw(zb)
            boxes.append(o.permute(0, 2, 3, 1).reshape(b, -1, 4))
        if all_classes:
            return torch.cat(classes, 1), torch.cat(boxes, 1)
        # one launch scores all five levels into the final [B, N] buffers
        w_cls, b_cls = self._class_predict_params()
        best, person = kernels.head_score_levels(
            zs, w_cls, b_cls, na, nc, self.person_class0)
        return best, person, torch.cat(boxes, 1)

    def _class_predict_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The class head's shared predict conv as the head-score kernel
        takes it: its own weight, viewed as [A*C, F], and bias. Views of
        the parameters keep their addresses and version counters, so the
        kernel's cache of packed weights (keyed on both) packs once for
        every forward and every thread, and again after an in-place
        update; an exported program (`pipeline/export.py`) passes its own
        persistent copies the same way. Casting here would hand the
        kernel a new tensor, and a new packing, on every call."""
        conv = self.class_net.predict_pw
        w = conv.weight.detach()
        return w.reshape(w.shape[0], -1), conv.bias.detach()


def person_slots(
    best_logit: torch.Tensor,     # [B, N] per-anchor winning-class logit
    person_logit: torch.Tensor,   # [B, N] per-anchor person-class logit
    box_regs: torch.Tensor,       # [B, N, 4]
    anchors: torch.Tensor,        # [N, 4] (cy, cx, h, w) pixel anchors
    limit: torch.Tensor,          # [4] (h, w, h, w) of the image, f32
    det_threshold: torch.Tensor,  # [B]
    iou_threshold: float = 0.5,
    top_k: int = 128,
    max_persons: int = 3,
):
    """Person-only detection slots from the head-score outputs, for a batch.

    An anchor is a person candidate iff `person_logit >= best_logit`
    (person is its argmax class, first-wins on ties); the person-score
    top-K candidates are decoded, clipped, and swept by greedy NMS (the
    CUDA sweep kernel, `ops/kernels.nms_sweep`); the `max_persons` best
    survivors above the threshold fill the slots.

    `jax.lax.top_k` is stable (lower index first on ties) and most scores
    are exactly 0, so both top-k cuts use a stable descending sort: with
    `torch.topk` dead slots would pick other boxes than the JAX package.

    `limit` (`ops.boxes.hw_scale` of the image size) lives on the
    boxes' device: a copy from the host would wait for the device.

    Returns (boxes [B, P, 4] pixel yxyx, scores [B, P], valid [B, P]).
    """
    is_person = person_logit >= best_logit
    scores = torch.where(is_person, torch.sigmoid(person_logit), 0.0)
    top_scores, idx = torch.sort(scores, dim=-1, descending=True,
                                 stable=True)
    top_scores, idx = top_scores[:, :top_k], idx[:, :top_k]

    regs = torch.gather(box_regs, 1, idx[..., None].expand(-1, -1, 4))
    boxes_yxyx = decode_boxes(regs, anchors[idx])
    boxes_yxyx = boxes_yxyx.clamp_min(0.0).minimum(limit)
    # (y, x) pairs swapped: a flip, where a list index would be copied
    # from the host
    boxes_xyxy = boxes_yxyx.unflatten(-1, (2, 2)).flip(-1).flatten(-2)
    keep = kernels.nms_sweep(boxes_xyxy, top_scores.contiguous(),
                             iou_threshold)

    final = torch.where(
        keep & (top_scores >= det_threshold[:, None]) & (top_scores > 0.0),
        top_scores, 0.0,
    )
    sel_scores, sel = torch.sort(final, dim=-1, descending=True, stable=True)
    sel_scores, sel = sel_scores[:, :max_persons], sel[:, :max_persons]
    sel_boxes = torch.gather(boxes_yxyx, 1, sel[..., None].expand(-1, -1, 4))
    return sel_boxes, sel_scores, sel_scores > 0.0


def postprocess(
    cls_logits: torch.Tensor,     # [N, C] class logits of one image
    box_regs: torch.Tensor,       # [N, 4]       (or [B, N, ...]: a batch)
    image_hw: Tuple[int, int],
    anchors: torch.Tensor,        # [N, 4] (cy, cx, h, w)
    config: EfficientDetConfig = EFFICIENTDET_LITE4,
    iou_threshold: float = 0.5,
    top_k: int = 128,
):
    """Canonical head outputs -> the reference's detection tensors for one
    image: (boxes [100, 4] pixel yxyx, scores [100], classes [100] 1-based,
    valid [100]) (the served SavedModel's outputs, `models/conv.py:16-18`).
    A batch ([B, N, C] logits) gets [B, 100, ...] back from ONE NMS sweep.

    sigmoid is monotone, so the class max and argmax are taken over the
    logits and only the winner is activated. `anchors` lie on the logits'
    device.
    """
    best_logit, best_class = cls_logits.max(-1)
    return postprocess_prescored(
        best_logit, best_class, box_regs, image_hw, config,
        iou_threshold=iou_threshold, top_k=top_k, anchors=anchors,
    )


def postprocess_prescored(
    best_logit: torch.Tensor,     # [(B,) N] winning-class logit per anchor
    best_class: torch.Tensor,     # [(B,) N] winning class (0-based int)
    box_regs: torch.Tensor,       # [(B,) N, 4]
    image_hw: Tuple[int, int],
    config: EfficientDetConfig = EFFICIENTDET_LITE4,
    score_threshold: float = 0.0,
    iou_threshold: float = 0.5,
    top_k: int = 128,
    anchors: Optional[torch.Tensor] = None,
):
    """`postprocess` for class scores already reduced to the winner: decode,
    clip to the image, class-wise greedy NMS (`ops/nms.nms_fixed`, the NMS
    sweep kernel on CUDA), 1-based classes."""
    h, w = image_hw
    if anchors is None:
        anchors = torch.from_numpy(generate_anchors(config.anchors, h, w))
        anchors = anchors.to(box_regs.device)
    best_score = torch.sigmoid(best_logit)
    boxes_yxyx = decode_boxes(box_regs, anchors)
    limit = torch.tensor([h, w, h, w], dtype=torch.float32,
                         device=boxes_yxyx.device)
    boxes_yxyx = boxes_yxyx.clamp_min(0.0).minimum(limit)
    # the NMS takes xyxy: swap, run class-wise NMS, swap back
    boxes_xyxy = boxes_yxyx[..., [1, 0, 3, 2]]
    masked_scores = torch.where(best_score > score_threshold, best_score, 0.0)
    res = nms_ops.nms_fixed(
        boxes_xyxy, masked_scores, iou_threshold=iou_threshold,
        max_det=config.max_detections, top_k=top_k,
        classes=best_class.float(), class_agnostic=False,
    )
    out_yxyx = res.boxes[..., [1, 0, 3, 2]]
    classes_1based = torch.where(res.valid, res.classes + 1.0, 0.0)
    return out_yxyx, res.scores, classes_1based, res.valid
