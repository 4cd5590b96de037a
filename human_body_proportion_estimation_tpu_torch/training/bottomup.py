"""Bottom-up (HigherHRNet) training: multi-person heatmap targets and the
associative-embedding grouping loss (port of the JAX package's
`training/bottomup.py`).

  * `multi_person_heatmap_targets`: per-joint gaussian maps max-combined
    over the person slots (fixed [B, P, K, 2] keypoints + validity mask);
  * `ae_loss`: pull each person's tags toward their mean, push different
    persons' means apart (exp(-d^2/2)), mask-based so padded person slots
    add nothing (Newell et al. NeurIPS'17, the HigherHRNet variant);
  * `bottomup_train_step`: MSE on the 1/2-res "output_2" heatmaps, MSE on
    the 1/4-res "output_1" heatmap half, and the AE loss on the "output_1"
    tag half, one optimizer step.

NCHW throughout (JAX: NHWC). `make_sharded_bottomup_step` is ROADMAP.md
item 16.
"""

from __future__ import annotations

import torch

from human_body_proportion_estimation_tpu_torch.training.trainer import (
    PoseTrainState,
    apply_updates,
)


def multi_person_heatmap_targets(
    keypoints: torch.Tensor,   # [B, P, K, 2] (x, y) in target heatmap coords
    visible: torch.Tensor,     # [B, P, K] bool
    hm_h: int,
    hm_w: int,
    sigma: float = 2.0,
) -> torch.Tensor:
    """Gaussian targets [B, K, hm_h, hm_w]: max over person slots."""
    dev = keypoints.device
    ys = torch.arange(hm_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(hm_w, dtype=torch.float32, device=dev)[None, :]
    d2 = ((ys - keypoints[..., 1, None, None]) ** 2
          + (xs - keypoints[..., 0, None, None]) ** 2)  # [B, P, K, H, W]
    g = torch.exp(-d2 / (2.0 * sigma ** 2)) * visible[..., None, None]
    return g.amax(1)                                     # combine persons


def ae_loss(
    tags: torch.Tensor,        # [B, K, H, W] predicted tag maps
    keypoints: torch.Tensor,   # [B, P, K, 2] (x, y) tag coords
    visible: torch.Tensor,     # [B, P, K] bool
) -> torch.Tensor:
    """Grouping loss (Newell'17 eq. 1-3, the 'exp' push variant of
    HigherHRNet): mean pull + mean push per image, averaged. A keypoint's
    coordinates become its tag pixel as JAX's int32 cast makes them
    (truncated toward zero), then clipped to the map."""
    b, p, k, _ = keypoints.shape
    h, w = tags.shape[2:]
    xi = keypoints[..., 0].to(torch.int32).clamp(0, w - 1).long()
    yi = keypoints[..., 1].to(torch.int32).clamp(0, h - 1).long()
    dev = tags.device
    kk = torch.arange(k, device=dev)[None, None, :].expand(b, p, k)
    bb = torch.arange(b, device=dev)[:, None, None].expand(b, p, k)
    t = tags[bb, kk, yi, xi]                                   # [B, P, K]

    vis = visible.to(torch.float32)
    n_joints = vis.sum(-1)                                     # [B, P]
    person_valid = n_joints > 0
    mean = (t * vis).sum(-1) / n_joints.clamp_min(1.0)         # [B, P]

    # pull: joints toward their person's reference tag
    pull = (((t - mean[..., None]) ** 2) * vis).sum((-1, -2))
    pull = pull / vis.sum((-1, -2)).clamp_min(1.0)             # [B]

    # push: distinct valid persons' means repel
    pv = person_valid.to(torch.float32)
    pair = pv[:, :, None] * pv[:, None, :]
    pair = pair * (1.0 - torch.eye(p, device=dev)[None])
    d2 = (mean[:, :, None] - mean[:, None, :]) ** 2
    push = (torch.exp(-d2 / 2.0) * pair).sum((-1, -2))
    n_pairs = pair.sum((-1, -2)).clamp_min(1.0)
    push = push / n_pairs                                      # [B]

    return torch.mean(pull + 0.5 * push)


def bottomup_loss(
    outputs,                   # HigherHRNet's {"output_1", "output_2"}
    keypoints: torch.Tensor,   # [B, P, K, 2] (x, y) in IMAGE coords
    visible: torch.Tensor,     # [B, P, K] bool
    ae_weight: float = 1e-3,
    fg_weight: float = 0.0,
) -> torch.Tensor:
    """Both heads' peak-weighted heatmap MSE plus the weighted AE loss."""
    k = keypoints.shape[2]
    out1, out2 = outputs["output_1"], outputs["output_2"]
    loss = torch.zeros((), dtype=torch.float32, device=out1.device)
    for hm, scale in ((out1[:, :k], 0.25), (out2, 0.5)):
        tgt = multi_person_heatmap_targets(
            keypoints * scale, visible, hm.shape[2], hm.shape[3])
        wgt = 1.0 + fg_weight * tgt
        loss = loss + torch.mean(wgt * (hm.float() - tgt) ** 2)
    return loss + ae_weight * ae_loss(out1[:, k:].float(), keypoints * 0.25,
                                      visible)


def bottomup_train_step(
    state: PoseTrainState,     # over a HigherHRNet
    images: torch.Tensor,      # [B, 3, H, W] float in [0, 1]
    keypoints: torch.Tensor,   # [B, P, K, 2] (x, y) in IMAGE coords
    visible: torch.Tensor,     # [B, P, K] bool
    ae_weight: float = 1e-3,
    fg_weight: float = 0.0,
):
    """One jointly supervised optimizer step (both heads + AE); returns
    (state, loss) with the loss detached. `fg_weight` is the peak-pixel
    up-weight of the top-down trainer (`trainer.train_step`)."""
    state.model.train()
    loss = bottomup_loss(state.model(images), keypoints, visible,
                         ae_weight, fg_weight)
    apply_updates(state, loss)
    return state, loss.detach()


def make_sharded_bottomup_step(*args, **kwargs):
    raise NotImplementedError(
        "make_sharded_bottomup_step (a dp x tp mesh) is not ported yet: "
        "ROADMAP.md item 16")
