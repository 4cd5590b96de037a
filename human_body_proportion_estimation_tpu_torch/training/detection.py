"""Detector training: anchor matching + focal/Huber losses (port of the JAX
package's `training/detection.py`).

RetinaNet/EfficientDet-style training of the EfficientDet family, with
fixed-shape anchor matching (masks, no boolean indexing): anchors with
IoU >= 0.5 against a ground-truth box are positive for that box, IoU < 0.4
negative, in-between ignored; each ground truth also claims its best
anchor. Classification is sigmoid focal loss (alpha 0.25, gamma 1.5)
normalized by the positive count; box regression is Huber (delta 0.1) on
the (ty, tx, th, tw) parameterization that `anchors.decode_boxes` inverts.

The losses are batched where JAX maps one image at a time (`jax.vmap`);
each image's sums are the same. Ties and masks follow JAX: `argmax` takes
the first index (over a uint8 cast of the bool hit matrix, which torch's
`argmax` refuses as bool), and masks multiply, so a NaN or inf poisons a
sum as it does in JAX. The train step runs the detector's canonical head
(`EfficientDet.forward(all_classes=True)`, flax `train=True`), never the
head-score kernel. `make_sharded_det_train_step` runs it over a mesh of
processes (`training/sharded.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from human_body_proportion_estimation_tpu_torch.models.anchors import (
    generate_anchors,
)
from human_body_proportion_estimation_tpu_torch.models.layers import (
    init_flax_default,
)
from human_body_proportion_estimation_tpu_torch.ops.boxes import box_iou
from human_body_proportion_estimation_tpu_torch.training.trainer import (
    PoseTrainState,
    apply_updates,
    create_train_state,
)

# focal prior pi = 0.01 (RetinaNet arxiv 1708.02002 §4.1), in f32 as JAX
# computes it
FOCAL_PRIOR_BIAS = float(torch.log(torch.tensor(0.01 / 0.99)))


@dataclasses.dataclass
class DetTrainState(PoseTrainState):
    """`PoseTrainState` with the global-norm clip of the gradients (0: no
    clip) and the anchors of each input size the steps have seen, made
    once on the images' device."""

    clip_norm: float = 0.0
    anchors: Dict[Tuple[int, int], torch.Tensor] = dataclasses.field(
        default_factory=dict)


def create_det_train_state(
    model: nn.Module,
    seed: Optional[int],
    learning_rate: float = 1e-3,
    total_steps: int | None = None,
    warmup_steps: int = 0,
    clip_norm: float = 0.0,
) -> DetTrainState:
    """Init the detector as flax's `init` does with `PRNGKey(seed)`, with the
    class head's prediction bias at the focal prior log(0.01 / 0.99) (with
    a zero bias every anchor starts at p = 0.5 and the first epochs go to
    suppressing background), and give it Adam. `seed` None keeps the
    weights the model has, bias included. `total_steps` switches to warmup
    + cosine decay; `clip_norm` > 0 clips the gradients' global norm
    first."""
    if seed is not None:
        init_det_flax(model, seed)
    pose_state = create_train_state(model, None, learning_rate,
                                    total_steps, warmup_steps)
    return DetTrainState(**vars(pose_state), clip_norm=clip_norm)


def init_det_flax(model: nn.Module, seed: int) -> nn.Module:
    """flax's default init of the detector with `PRNGKey(seed)`
    (`models.layers.init_flax_default`), then the class head's prediction
    bias at the focal prior (detection.py:69-72)."""
    init_flax_default(model, seed)
    head = getattr(getattr(model, "class_net", None), "predict_pw", None)
    if head is not None and head.bias is not None:
        with torch.no_grad():
            head.bias.fill_(FOCAL_PRIOR_BIAS)
    return model


def _cycxhw_to_yxyx(a: torch.Tensor) -> torch.Tensor:
    cy, cx, h, w = a.unbind(-1)
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)


def match_anchors(
    anchors_cycxhw: torch.Tensor,  # [N, 4] pixel anchors
    gt_boxes_yxyx: torch.Tensor,   # [..., G, 4] pixel ground truth (padded)
    gt_valid: torch.Tensor,        # [..., G] bool padding mask
    pos_iou: float = 0.5,
    neg_iou: float = 0.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape RetinaNet assignment, for one image or a batch (leading
    dims of the ground truth).

    Returns (matched_gt [..., N] int64 — index into the G slots,
    meaningful only where state != 0 —, state [..., N] int32: 1 positive,
    0 background, -1 ignored). Padded ground-truth slots never match.
    """
    iou = box_iou(_cycxhw_to_yxyx(anchors_cycxhw), gt_boxes_yxyx)
    iou = torch.where(gt_valid[..., None, :], iou, -1.0)       # [..., N, G]

    best_iou, best_gt = iou.amax(-1), iou.argmax(-1)
    state = torch.where(best_iou >= pos_iou, 1,
                        torch.where(best_iou < neg_iou, 0, -1))

    # force-match: every valid gt claims its best anchor (argmax over N)
    gt_best_anchor = iou.argmax(-2)                            # [..., G]
    n = anchors_cycxhw.shape[0]
    lin = torch.arange(n, device=iou.device)
    hit = ((lin[:, None] == gt_best_anchor[..., None, :])
           & gt_valid[..., None, :])                           # [..., N, G]
    forced = hit.any(-1)
    forced_gt = hit.to(torch.uint8).argmax(-1)
    state = torch.where(forced, 1, state).to(torch.int32)
    matched_gt = torch.where(forced, forced_gt, best_gt)
    return matched_gt, state


def regression_targets(
    anchors_cycxhw: torch.Tensor,  # [N, 4]
    gt_boxes_yxyx: torch.Tensor,   # [..., N, 4] matched gt per anchor
) -> torch.Tensor:
    """Inverse of `anchors.decode_boxes`: pixel yxyx gt -> (ty,tx,th,tw)."""
    cy_a, cx_a, h_a, w_a = anchors_cycxhw.unbind(-1)
    y1, x1, y2, x2 = gt_boxes_yxyx.unbind(-1)
    h_g = torch.clamp_min(y2 - y1, 1e-6)
    w_g = torch.clamp_min(x2 - x1, 1e-6)
    cy_g = (y1 + y2) / 2
    cx_g = (x1 + x2) / 2
    return torch.stack([
        (cy_g - cy_a) / h_a,
        (cx_g - cx_a) / w_a,
        torch.log(h_g / h_a),
        torch.log(w_g / w_a),
    ], -1)


def sigmoid_binary_cross_entropy(logits, labels):
    """optax `sigmoid_binary_cross_entropy`."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(
        -logits)


def huber_loss(predictions, targets, delta: float = 1.0):
    """optax `huber_loss`."""
    abs_errors = torch.abs(predictions - targets)
    quadratic = torch.clamp_max(abs_errors, delta)
    linear = abs_errors - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def focal_loss(
    logits: torch.Tensor,    # [..., N, C]
    targets: torch.Tensor,   # [..., N, C] one-hot (all-zero for background)
    weight: torch.Tensor,    # [..., N] 1 for pos+neg anchors, 0 for ignored
    alpha: float = 0.25,
    gamma: float = 1.5,
) -> torch.Tensor:
    """Sigmoid focal loss summed over anchors and classes (per image when
    the inputs have a batch dim)."""
    p = torch.sigmoid(logits)
    ce = sigmoid_binary_cross_entropy(logits, targets)
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    a_t = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return torch.sum(a_t * (1.0 - p_t) ** gamma * ce * weight[..., None],
                     dim=(-2, -1))


def detection_loss(
    cls_logits: torch.Tensor,   # [B, N, C]
    box_regs: torch.Tensor,     # [B, N, 4]
    anchors: torch.Tensor,      # [N, 4] cycxhw
    gt_boxes: torch.Tensor,     # [B, G, 4] yxyx pixel, padded
    gt_classes: torch.Tensor,   # [B, G] int 0-based class ids
    gt_valid: torch.Tensor,     # [B, G] bool
    num_classes: int,
    box_loss_weight: float = 50.0,  # automl hparams default
) -> torch.Tensor:
    """Batch focal + Huber detection loss, normalized by positive count."""
    matched, state = match_anchors(anchors, gt_boxes, gt_valid)
    matched_boxes = torch.gather(
        gt_boxes, 1, matched[..., None].expand(-1, -1, 4))   # [B, N, 4]
    matched_cls = torch.gather(gt_classes.long(), 1, matched)  # [B, N]
    pos = (state == 1).to(cls_logits.dtype)
    # jax.nn.one_hot: a class outside [0, C) is all zeros
    classes = torch.arange(num_classes, device=cls_logits.device)
    one_hot = (matched_cls[..., None] == classes).to(cls_logits.dtype)
    one_hot = one_hot * pos[..., None]
    cls_l = focal_loss(cls_logits, one_hot,
                       (state != -1).to(cls_logits.dtype))
    t = regression_targets(anchors, matched_boxes)
    huber = huber_loss(box_regs, t, delta=0.1).sum(-1)
    box_l = torch.sum(huber * pos, dim=-1)
    n_pos = torch.clamp_min(torch.sum(state == 1, dim=-1), 1)
    return torch.mean((cls_l + box_loss_weight * box_l / 4.0) / n_pos)


def _det_loss(state, images: torch.Tensor, gt_boxes, gt_classes,
              gt_valid) -> torch.Tensor:
    """The detection loss of `state.model` (in train mode) on a batch, the
    anchors of the images' size made once on their device."""
    model = state.model
    cfg = model.config
    hw = (images.shape[1], images.shape[2])
    if hw not in state.anchors:
        state.anchors[hw] = torch.from_numpy(
            generate_anchors(cfg.anchors, *hw)).to(images.device)
    model.train()
    cls_logits, box_regs = model(images, all_classes=True)
    return detection_loss(
        cls_logits.float(), box_regs.float(), state.anchors[hw], gt_boxes,
        gt_classes, gt_valid, cfg.num_classes)


def train_step(
    state: DetTrainState,
    images: torch.Tensor,      # [B, H, W, 3] uint8
    gt_boxes: torch.Tensor,    # [B, G, 4] yxyx pixel
    gt_classes: torch.Tensor,  # [B, G] int 0-based
    gt_valid: torch.Tensor,    # [B, G] bool
):
    """One optimizer step; returns (state, loss) with the loss detached."""
    loss = _det_loss(state, images, gt_boxes, gt_classes, gt_valid)
    apply_updates(state, loss, state.clip_norm)
    return state, loss.detach()


def make_sharded_det_train_step(state: DetTrainState, mesh):
    """`train_step` over a ("data", "model") mesh of processes
    (`training/sharded.py`, the state's clip included): returns (step,
    sharded state); `step(sstate, images, gt_boxes, gt_classes,
    gt_valid)` takes the GLOBAL batch in every rank and returns (sstate,
    the global loss)."""
    from human_body_proportion_estimation_tpu_torch.training.sharded import (
        apply_sharded_updates,
        shard_state,
    )

    def step(sstate, images, gt_boxes, gt_classes, gt_valid):
        rows = sstate.rows(images, gt_boxes, gt_classes, gt_valid)
        with sstate.batch_statistics():
            loss = _det_loss(sstate, *rows)
        return sstate, apply_sharded_updates(sstate, loss)

    return step, shard_state(state, mesh)
