"""MobileNetV1-SSD person detector (port of the JAX package's
`models/ssd_mobilenet.py`).

The reference ships this detector as a quantized tflite blob
(`modules/mnetv1_sdd_tflite/ssd.tflite`: ssd_mobilenet_v1 COCO, depth
multiplier 0.75, 300x300 uint8, BatchNorm folded into the conv biases).
Here it is an `nn.Module` whose weights are dequantized out of that blob
by `models/tflite_import.py`.

Structure: Conv0 (3x3 s2) + 13 depthwise-separable blocks (ReLU6), the SSD
extra layers off Conv13 (4x {1x1 squeeze, 3x3 s2}), and 6 box / class
predictor pairs over feature maps [19^2, 10^2, 5^2, 3^2, 2^2, 1^2] with
[3, 6, 6, 6, 6, 6] anchors a cell = 1917 anchors. `ssd_postprocess` is
the TFLite_Detection_PostProcess op: faster-rcnn box decode with scales
(10, 10, 5, 5) against the blob's anchor table, sigmoid scores,
background class 0 dropped, class-wise greedy NMS to 10 slots, for a
whole batch in one launch of the NMS sweep kernel.

As in the flax model: the input goes through (x - 128) / 128 in f32, the
trunk runs in `dtype` (bf16 by default), and the box and class heads run
in f32 on f32 features. Module names equal the flax module names
(`conv0.conv`, `dw1.conv`, ...), so `models/weights.flax_to_state_dict`
converts a flax tree key for key (a depthwise HWIO [3, 3, 1, C] kernel
becomes the [C, 1, 3, 3] weight of a conv with groups=C). Flax "SAME" at
stride 2 pads 0 before and 1 after (300 -> 150): `layers.Conv2d` pads so.
A head's NHWC [B, H, W, na*k] output is read as [B, H*W*na, k] (anchor
index (h*W + w)*na + a): the NCHW output is permuted before the reshape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from human_body_proportion_estimation_tpu_torch.models.layers import (
    Conv2d,
    relu6,
)
from human_body_proportion_estimation_tpu_torch.ops import nms as nms_ops

# (pointwise_channels, stride) per depthwise block, BASE depth (multiplier
# 1.0); the checked-in blob uses multiplier 0.75
_MOBILENET_BLOCKS = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),  # blocks 1..11
    (1024, 2), (1024, 1),                               # blocks 12, 13
)
# SSD extra layers: (squeeze_1x1, out_3x3) base channels
_EXTRA_LAYERS = ((256, 512), (128, 256), (128, 256), (64, 128))
ANCHORS_PER_CELL = (3, 6, 6, 6, 6, 6)
NUM_CLASSES_WITH_BG = 91
BOX_SCALES = (10.0, 10.0, 5.0, 5.0)  # y, x, h, w


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    depth_multiplier: float = 0.75
    num_classes_with_bg: int = NUM_CLASSES_WITH_BG
    input_size: int = 300

    def depth(self, base: int) -> int:
        return max(8, int(base * self.depth_multiplier + 0.5) // 8 * 8)


SSD_MOBILENET_V1_075 = SSDConfig(0.75)


class _Conv(nn.Module):
    """Conv + bias (+ ReLU6): BatchNorm is folded in the source blob."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 depthwise: bool = False, act: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride,
                           groups=cin if depthwise else 1, bias=True)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return relu6(x) if self.act else x


class SSDMobileNetV1(nn.Module):
    """uint8 / float NHWC [B, 300, 300, 3] -> (box_regs [B, 1917, 4],
    logits [B, 1917, 91]), both f32."""

    def __init__(self, config: SSDConfig = SSD_MOBILENET_V1_075,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.config = cfg = config
        self.dtype = dtype
        cin = cfg.depth(32)
        self.conv0 = _Conv(3, cin, 3, 2)
        feat_ch = []
        for i, (ch, stride) in enumerate(_MOBILENET_BLOCKS, start=1):
            self.add_module(f"dw{i}", _Conv(cin, cin, 3, stride,
                                            depthwise=True))
            self.add_module(f"pw{i}", _Conv(cin, cfg.depth(ch)))
            cin = cfg.depth(ch)
            if i in (11, 13):
                feat_ch.append(cin)
        for j, (squeeze, out) in enumerate(_EXTRA_LAYERS, start=2):
            self.add_module(f"extra{j}_1x1", _Conv(cin, cfg.depth(squeeze)))
            self.add_module(f"extra{j}_3x3", _Conv(
                cfg.depth(squeeze), cfg.depth(out), 3, 2))
            cin = cfg.depth(out)
            feat_ch.append(cin)
        nc = cfg.num_classes_with_bg
        for li, (c, na) in enumerate(zip(feat_ch, ANCHORS_PER_CELL)):
            self.add_module(f"box{li}", _Conv(c, na * 4, act=False))
            self.add_module(f"cls{li}", _Conv(c, na * nc, act=False))

    def forward(self, images: torch.Tensor):
        x = (images.float() - 128.0) / 128.0  # tflite input zp 128, 1/128
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.conv0(x)
        feats = []
        for i in range(1, len(_MOBILENET_BLOCKS) + 1):
            x = getattr(self, f"pw{i}")(getattr(self, f"dw{i}")(x))
            if i == 11:
                feats.append(x)   # 19x19
        feats.append(x)           # 10x10 (conv13)
        for j in range(2, 2 + len(_EXTRA_LAYERS)):
            x = getattr(self, f"extra{j}_3x3")(
                getattr(self, f"extra{j}_1x1")(x))
            feats.append(x)

        b = images.shape[0]
        nc = self.config.num_classes_with_bg
        boxes, logits = [], []
        for li, f in enumerate(feats):
            f = f.float()
            # NCHW -> NHWC before the reshape: anchor (h*W + w)*na + a
            br = getattr(self, f"box{li}")(f).permute(0, 2, 3, 1)
            cl = getattr(self, f"cls{li}")(f).permute(0, 2, 3, 1)
            boxes.append(br.reshape(b, -1, 4))
            logits.append(cl.reshape(b, -1, nc))
        return torch.cat(boxes, 1), torch.cat(logits, 1)


class SSDDetections(NamedTuple):
    boxes: torch.Tensor    # [..., 10, 4] normalized (y1, x1, y2, x2)
    classes: torch.Tensor  # [..., 10] 0-based, background dropped
    scores: torch.Tensor   # [..., 10]
    valid: torch.Tensor    # [..., 10] bool


def ssd_postprocess(
    box_regs: torch.Tensor,       # [B, 1917, 4] (or one image, [1917, 4])
    logits: torch.Tensor,         # [B, 1917, 91]
    anchors_ycxhw: torch.Tensor,  # [1917, 4], from the blob
    score_threshold: float = 1e-8,
    iou_threshold: float = 0.6,
    max_detections: int = 10,
    top_k: int = 128,
) -> SSDDetections:
    """TFLite_Detection_PostProcess semantics, fixed-shape, for a batch in
    one NMS launch ([B, top_k] candidates, each box shifted by its class
    times `ops.nms.MAX_WH` so that the sweep suppresses within a class).
    Each image's result equals the JAX function's on that image."""
    ya, xa, ha, wa = anchors_ycxhw.unbind(-1)
    ty, tx, th, tw = box_regs.unbind(-1)
    ycenter = ty / BOX_SCALES[0] * ha + ya
    xcenter = tx / BOX_SCALES[1] * wa + xa
    h = torch.exp(th / BOX_SCALES[2]) * ha
    w = torch.exp(tw / BOX_SCALES[3]) * wa
    boxes_xyxy = torch.stack([xcenter - w / 2, ycenter - h / 2,
                              xcenter + w / 2, ycenter + h / 2], -1)

    scores_all = torch.sigmoid(logits[..., 1:])   # drop background class 0
    best_score, best_class = scores_all.max(-1)   # first index on ties
    masked = torch.where(best_score > score_threshold, best_score, 0.0)
    res = nms_ops.nms_fixed(
        boxes_xyxy, masked, iou_threshold=iou_threshold,
        max_det=max_detections, top_k=top_k,
        classes=best_class.float(), class_agnostic=False,
    )
    return SSDDetections(res.boxes[..., [1, 0, 3, 2]], res.classes,
                         res.scores, res.valid)


def ssd_state_dict(variables: Mapping, anchors) -> Dict[str, torch.Tensor]:
    """The port's SSD state: the `state_dict` of a flax SSD tree
    ({'params': ...}, as `models.tflite_import.load_ssd_weights` or flax's
    `init` give it) plus its anchor table under "anchors" ([1917, 4]
    normalized (cy, cx, h, w)), the pair the JAX package's SSD detector
    variables hold as {'params', 'anchors'}."""
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        flax_to_state_dict,
    )

    state = flax_to_state_dict({"params": variables["params"]})
    state["anchors"] = torch.from_numpy(np.array(anchors, np.float32))
    return state


def load_ssd(
    state: Optional[Mapping[str, torch.Tensor]] = None,
    path: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> Tuple[SSDMobileNetV1, torch.Tensor]:
    """The SSD in eval mode on `device` and its anchor table there, from
    `state` (`ssd_state_dict`'s form, "anchors" included) or, given none,
    from the tflite at `path` (the reference's ssd.tflite by default;
    ValueError naming the file when it is absent)."""
    from human_body_proportion_estimation_tpu_torch.models.tflite_import import (  # noqa: E501
        DEFAULT_TFLITE_PATH,
        load_ssd_weights,
    )

    if state is None:
        state = ssd_state_dict(*load_ssd_weights(path or DEFAULT_TFLITE_PATH))
    state = dict(state)
    anchors = state.pop("anchors")
    model = SSDMobileNetV1(dtype=dtype)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval(), anchors.to(device)
