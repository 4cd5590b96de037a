"""Pose-model training: heatmap-MSE train step (port of the JAX package's
`training/trainer.py`).

Top-down pose training with per-keypoint gaussian heatmap targets and a
peak-weighted MSE (the standard HRNet recipe). PyTorch idiom in place of
the JAX package's pure functions:
  * `PoseTrainState` holds the module, its `torch.optim.Adam` and its
    schedule, and the step count, in place of the NamedTuple of
    (step, params, batch_stats, opt_state). `train_step` updates it in
    place and returns it, so call sites read as in JAX.
  * `model.train()` is flax's `train=True`: batch statistics in every
    BatchNorm, the running statistics moved as flax moves them
    (`models/layers.batch_norm`).
  * Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0).
    The optional warmup + cosine schedule is optax's
    `warmup_cosine_decay_schedule` (`warmup_cosine_lambda`): optax reads
    the schedule at the update count BEFORE the update, so with a warmup
    the first step moves nothing; a `LambdaLR` stepped after each
    `optimizer.step()` does the same because the lambda is 0 at 0.

Tensors are NCHW, the port's layout: heatmaps and targets [B, K, H, W]
(JAX: NHWC, trainer.py:80). `make_sharded_train_step` runs the step over
a dp x tp mesh of processes (`training/sharded.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from human_body_proportion_estimation_tpu_torch.models.layers import (
    init_flax_default,
)


@dataclasses.dataclass
class PoseTrainState:
    """The module being trained, its optimizer and schedule, and the number
    of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    step: int = 0


def warmup_cosine_lambda(total_steps: int, warmup_steps: int,
                         end_fraction: float = 0.03
                         ) -> Callable[[int], float]:
    """optax `warmup_cosine_decay_schedule(init_value=0, peak_value=1,
    warmup_steps, decay_steps=total_steps, end_value=end_fraction)` as a
    multiplier of the peak rate: linear from 0 over `warmup_steps`, then a
    cosine to `end_fraction` at `total_steps`, flat after it."""
    decay = total_steps - warmup_steps
    if decay <= 0:
        raise ValueError("the cosine decay needs total_steps > warmup_steps")

    def multiplier(count: int) -> float:
        if count < warmup_steps:
            return count / warmup_steps
        t = min(count - warmup_steps, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return (1.0 - end_fraction) * cosine + end_fraction

    return multiplier


def make_optimizer(model: nn.Module, learning_rate: float,
                   total_steps: int | None = None, warmup_steps: int = 0):
    """(Adam over every parameter of `model` with optax's defaults, the
    warmup + cosine `LambdaLR` when `total_steps` is given, else None)."""
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8, foreach=True)
    scheduler = None
    if total_steps is not None:
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, warmup_cosine_lambda(total_steps, warmup_steps))
    return optimizer, scheduler


def create_train_state(
    model: nn.Module,
    seed: Optional[int],
    learning_rate: float = 1e-3,
    total_steps: int | None = None,
    warmup_steps: int = 0,
) -> PoseTrainState:
    """Init `model` as flax's `init` does with `PRNGKey(seed)`
    (`models.layers.init_flax_default`; None keeps the weights it has, to
    fine-tune), and give it Adam. `total_steps` switches the constant rate
    to linear warmup + cosine decay over the run, the HRNet fine-tune
    schedule. The JAX `input_shape` argument is gone: a torch module has
    its parameters from construction."""
    if seed is not None:
        init_flax_default(model, seed)
    optimizer, scheduler = make_optimizer(model, learning_rate, total_steps,
                                          warmup_steps)
    return PoseTrainState(model, optimizer, scheduler)


def heatmap_targets(
    keypoints: torch.Tensor,   # [B, K, 2] (x, y) in heatmap coords
    visible: torch.Tensor,     # [B, K] bool
    hm_h: int,
    hm_w: int,
    sigma: float = 2.0,
) -> torch.Tensor:
    """Gaussian target heatmaps [B, K, hm_h, hm_w] (NCHW like the model)."""
    dev = keypoints.device
    ys = torch.arange(hm_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(hm_w, dtype=torch.float32, device=dev)[None, :]
    d2 = ((ys - keypoints[..., 1, None, None]) ** 2
          + (xs - keypoints[..., 0, None, None]) ** 2)    # [B, K, H, W]
    g = torch.exp(-d2 / (2.0 * sigma ** 2))
    return g * visible[..., None, None]


def apply_updates(state, loss: torch.Tensor, clip_norm: float = 0.0):
    """Backward of `loss`, then `optimizer_step`."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer_step(state, clip_norm)


def optimizer_step(state, clip_norm: float = 0.0):
    """On the gradients the parameters hold: the optional global-norm clip,
    one Adam step and one schedule step; `state.step` += 1."""
    if clip_norm > 0:
        clip_by_global_norm(state.model.parameters(), clip_norm)
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1


def clip_by_global_norm(parameters, max_norm: float) -> torch.Tensor:
    """optax `clip_by_global_norm(max_norm)` on the gradients, in place:
    g -> g / norm * max_norm when the global norm is >= max_norm, no
    epsilon (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6).
    Computed on the device, with no host sync. Returns the norm."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads)))
    clip = norm >= max_norm
    scale = torch.where(clip, max_norm / norm, torch.ones_like(norm))
    torch._foreach_mul_(grads, scale)
    return norm


def pose_loss(
    model: nn.Module,
    images: torch.Tensor,      # [B, 3, H, W] float in [0, 1]
    targets: torch.Tensor,     # [B, K, H/4, W/4]
    target_weight: torch.Tensor | None = None,  # [B, K] visibility weights
    fg_weight: float = 0.0,
) -> torch.Tensor:
    """The peak-weighted heatmap MSE of `model` on a batch (its mean over
    the batch, keypoints and pixels)."""
    out = model(images)
    err = (out - targets) ** 2
    if fg_weight:
        err = err * (1.0 + fg_weight * targets)
    if target_weight is not None:
        err = err * target_weight[:, :, None, None]
    return torch.mean(err)


def train_step(
    state: PoseTrainState,
    images: torch.Tensor,      # [B, 3, H, W] float in [0, 1]
    targets: torch.Tensor,     # [B, K, H/4, W/4]
    target_weight: torch.Tensor | None = None,  # [B, K] visibility weights
    fg_weight: float = 0.0,
):
    """One optimizer step; returns (state, loss) with the loss detached.

    `fg_weight` up-weights the Gaussian-peak pixels in the MSE by
    ``1 + fg_weight * target``: with plain MSE the ~17x96x72 background
    pixels dominate the gradient and the head settles on wide,
    low-amplitude peaks, below the reference's per-keypoint serving gates
    (up to 0.46, `person_det_pose_edet4_trtserver.py:162-163`).
    """
    state.model.train()
    loss = pose_loss(state.model, images, targets, target_weight, fg_weight)
    apply_updates(state, loss)
    return state, loss.detach()


def make_sharded_train_step(state: PoseTrainState, mesh):
    """`train_step` over a ("data", "model") mesh of processes
    (`training/sharded.py`): returns (step, sharded state); `step(sstate,
    images, targets, target_weight=None, fg_weight=0.0)` takes the GLOBAL
    batch in every rank and returns (sstate, the global loss), the
    one-process step's math."""
    from human_body_proportion_estimation_tpu_torch.training.sharded import (
        apply_sharded_updates,
        shard_state,
    )

    def step(sstate, images, targets, target_weight=None, fg_weight=0.0):
        rows = sstate.rows(images, targets, *(
            () if target_weight is None else (target_weight,)))
        sstate.model.train()
        with sstate.batch_statistics():
            loss = pose_loss(sstate.model, rows[0], rows[1],
                             rows[2] if len(rows) > 2 else None, fg_weight)
        return sstate, apply_sharded_updates(sstate, loss)

    return step, shard_state(state, mesh)
