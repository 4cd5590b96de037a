"""The SSD slot's test recipe, shared by the CPU tests, the goldens generator
(tests/test_torch_port_ssd_goldens.py) and `chip_smoke.py` phase S, which
loads this file by path. Port + numpy only.

  * `ssd_anchors()`: the [1917, 4] normalized (cy, cx, h, w) anchor table
    of the SSD MobileNetV1 COCO config's multiple-grid generator
    (object_detection `multiple_grid_anchor_generator.create_ssd_anchors`:
    6 layers over [19, 10, 5, 3, 2, 1] grids, scales 0.2-0.95, aspect
    ratios {1, 2, 1/2, 3, 1/3} plus the interpolated scale at ratio 1, 3
    anchors (0.1 @ 1, scale @ 2 and 1/2) in the lowest layer:
    19*19*3 + (100 + 25 + 9 + 4 + 1)*6 = 1917). The reference's ssd.tflite
    carries such a table; the JAX package has no generator.
  * `seeded_ssd(seed, images, person_bias)`: SSD weights that are not
    degenerate. flax's init of the SSD (no BatchNorm, biases 0) shrinks
    the signal by ~2x a ReLU6 layer: its box and class outputs are
    ~1e-4, every score sigmoid(~0) = 0.5 to within 1e-4, and the ranking
    of candidates is f32 noise. So flax's draw at `seed`
    (`models.flax_init`) gets a calibrated BatchNorm folded into every
    trunk conv, as the blob's weights have theirs (`Conv2D_Fold_bias`):
    each output channel scaled to unit standard deviation and shifted to
    mean 1 on `images` (float64, on the CPU, the port's own module, one
    layer after the other), which keeps most ReLU6 units linear; each
    head is divided by the standard deviation of its outputs, and
    `person_bias` is added to the person logit (class 1 with the
    background) of every anchor.
  * `ssd_inputs(images)`: the 300x300 f32 inputs the SSD slot gives its
    model (`SSDBackend`'s resize).
  * `decision_margins(...)`: how far each decision of the postprocess and
    the person slots lies from flipping.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

GRIDS = (19, 10, 5, 3, 2, 1)
MIN_SCALE, MAX_SCALE = 0.2, 0.95
ASPECT_RATIOS = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)


def ssd_anchors() -> np.ndarray:
    """[1917, 4] f32 (cy, cx, h, w), anchor index (h*W + w)*na + a."""
    n = len(GRIDS)
    scales = [MIN_SCALE + (MAX_SCALE - MIN_SCALE) * i / (n - 1)
              for i in range(n)] + [1.0]
    out = []
    for layer, grid in enumerate(GRIDS):
        scale, scale_next = scales[layer], scales[layer + 1]
        if layer == 0:
            specs = [(0.1, 1.0), (scale, 2.0), (scale, 0.5)]
        else:
            specs = [(scale, ar) for ar in ASPECT_RATIOS]
            specs.append((math.sqrt(scale * scale_next), 1.0))
        stride = 1.0 / grid
        for i in range(grid):
            for j in range(grid):
                cy, cx = (i + 0.5) * stride, (j + 0.5) * stride
                for s, ar in specs:
                    r = math.sqrt(ar)
                    out.append((cy, cx, s / r, s * r))
    return np.asarray(out, np.float32)


def ssd_inputs(images: np.ndarray) -> np.ndarray:
    """uint8 [B, H, W, 3] det-input images -> the f32 [B, 300, 300, 3]
    the SSD slot feeds its model (`SSDBackend`)."""
    from human_body_proportion_estimation_tpu_torch.ops import image as ops

    x = torch.from_numpy(np.asarray(images)).float()
    return ops._resize(x, 300, 300, "linear", False).numpy()


def seeded_ssd(seed: int, images: np.ndarray,
               person_bias: float = 0.0) -> Dict[str, Dict]:
    """{'params': ...} flax tree (f32 numpy) of calibrated seeded SSD
    weights (module docstring); `images`: uint8 det-input images."""
    from human_body_proportion_estimation_tpu_torch.models.flax_init import (
        init_state_dict,
    )
    from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (  # noqa: E501
        NUM_CLASSES_WITH_BG,
        SSDMobileNetV1,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        state_dict_to_flax,
    )

    model = SSDMobileNetV1(dtype=torch.float64)
    model.load_state_dict(init_state_dict(model, seed))
    model = model.double().eval()
    heads = {n for n, _ in model.named_children()
             if n.startswith(("box", "cls"))}

    def calibrate(conv, args, out, name):
        """Rescales the conv in place; returns its output as the new
        weights give it (the conv is affine in its weights)."""
        w, b = conv.weight, conv.bias
        if name in heads:
            std = out.std()
            w /= std
            b /= std
            out = out / std
        else:
            mean = out.mean((0, 2, 3))
            std = out.std((0, 2, 3)).clamp_min(1e-12)
            w /= std[:, None, None, None]
            b.copy_((b - mean) / std + 1.0)
            out = (out - mean[:, None, None]) / std[:, None, None] + 1.0
        if name.startswith("cls"):
            b[1::NUM_CLASSES_WITH_BG] += person_bias
            out = out.clone()
            out[:, 1::NUM_CLASSES_WITH_BG] += person_bias
        return out

    hooks = [mod.conv.register_forward_hook(
        lambda conv, args, out, name=name: calibrate(conv, args, out, name))
        for name, mod in model.named_children()]
    try:
        with torch.no_grad():
            model(torch.from_numpy(ssd_inputs(images)).double())
    finally:
        for h in hooks:
            h.remove()
    state = {k: v.float() for k, v in model.state_dict().items()}
    return {"params": state_dict_to_flax(state)["params"]}


def _iou(a, b):
    """IoU of xyxy boxes a [4] and b [4] (division form)."""
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    inter = np.prod(np.clip(rb - lt, 0, None))
    area = lambda x: np.prod(np.clip(x[2:] - x[:2], 0, None))  # noqa: E731
    return inter / (area(a) + area(b) - inter)


def decision_margins(box_regs: np.ndarray, logits: np.ndarray,
                     anchors: np.ndarray, det_threshold: float,
                     iou_threshold: float = 0.6, top_k: int = 128,
                     max_det: int = 10) -> Dict[str, float]:
    """For one image's raw outputs (from an f32 forward): how far each
    decision that shapes the 10 SSD slots and the person slots lies from
    flipping, over the candidates up to the one that fills the last slot
    (R). Scores are compared through their logits (sigmoid is monotone,
    and near 1 it squeezes a logit's rounding into nothing):

      score_gap   min logit gap between consecutive sorted candidates up
                  to R + 1 (the order the greedy sweep sees, the top-k
                  cut);
      class_lead  min over those candidates of the best class's logit
                  minus the second best's (the argmax);
      iou         min |IoU - t| over the same-class pairs among them;
      threshold   min |logit - logit(det_threshold)| over the persons in
                  the 10 slots;
      persons     the persons in the 10 slots at or above det_threshold.
    """
    from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (  # noqa: E501
        BOX_SCALES,
    )

    a = anchors.astype(np.float64)
    r = box_regs.astype(np.float64)
    yc = r[:, 0] / BOX_SCALES[0] * a[:, 2] + a[:, 0]
    xc = r[:, 1] / BOX_SCALES[1] * a[:, 3] + a[:, 1]
    h = np.exp(r[:, 2] / BOX_SCALES[2]) * a[:, 2]
    w = np.exp(r[:, 3] / BOX_SCALES[3]) * a[:, 3]
    boxes = np.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], -1)
    lg = logits[:, 1:].astype(np.float64)
    sorted_lg = np.sort(lg, -1)
    best, second = sorted_lg[:, -1], sorted_lg[:, -2]
    cls = lg.argmax(-1)
    order = np.argsort(-best, kind="stable")[:top_k + 1]
    kept = []
    last = len(order) - 2
    for rank, i in enumerate(order[:top_k]):
        if all(cls[j] != cls[i] or _iou(boxes[j], boxes[i]) <= iou_threshold
               for j in kept):
            kept.append(i)
            if len(kept) == max_det:
                last = rank
                break
    cand = order[:last + 1]
    s = best[order[:last + 2]]
    m = {"score_gap": float(np.min(s[:-1] - s[1:])),
         "class_lead": float(np.min(best[cand] - second[cand]))}
    ious = [abs(_iou(boxes[i], boxes[j]) - iou_threshold)
            for x, i in enumerate(cand) for j in cand[:x] if cls[i] == cls[j]]
    m["iou"] = float(min(ious)) if ious else 1.0
    persons = [i for i in kept if cls[i] == 0]
    t = np.log(det_threshold / (1.0 - det_threshold))
    m["threshold"] = float(min([abs(best[i] - t) for i in persons] or [1.0]))
    m["persons"] = int(sum(best[i] >= t for i in persons))
    return m
