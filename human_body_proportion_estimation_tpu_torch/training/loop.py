"""Training loop: data pipeline -> train step -> checkpoints (port of the
JAX package's `training/loop.py`).

Pulls augmented batches from `training/data`, builds heatmap targets,
drives `trainer.train_step` on the model's device, logs losses, and
checkpoints through `models/weights.save_training_checkpoint` (an f32
`.npz` of `{params, batch_stats, step}` per checkpoint, in place of the
JAX package's Orbax directory). `mesh=` (the dp x tp sharded step) is
ROADMAP.md item 16.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.models.weights import (
    save_training_checkpoint,
)
from human_body_proportion_estimation_tpu_torch.training import (
    data as data_lib,
    trainer as trainer_lib,
)
from human_body_proportion_estimation_tpu_torch.utils.logging import (
    get_logger,
)

log = get_logger("train")


def train_pose(
    model,
    samples: Sequence[data_lib.PoseSample],
    steps: int = 1000,
    batch_size: int = 16,
    learning_rate: float = 1e-3,
    crop_hw=(384, 288),
    mesh=None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 500,
    log_every: int = 50,
    seed: int = 0,
    augment: bool = True,
):
    """Train a pose model from flax's default init (drawn from `seed`) on
    the device it lives on; returns (train state, per-step losses)."""
    if mesh is not None:
        raise NotImplementedError(
            "train_pose(mesh=...) is not ported yet: ROADMAP.md item 16")
    h, w = crop_hw
    device = next(model.parameters()).device
    state = trainer_lib.create_train_state(
        model, torch.Generator().manual_seed(seed), learning_rate)

    hm_h, hm_w = h // 4, w // 4
    batches = data_lib.batch_iterator(
        samples, batch_size, crop_hw, augment=augment, seed=seed
    )
    losses = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        images, kp_hm, visible = next(batches)
        targets = trainer_lib.heatmap_targets(
            torch.from_numpy(kp_hm).to(device),
            torch.from_numpy(visible).to(device), hm_h, hm_w)
        images = torch.from_numpy(images).to(device).permute(0, 3, 1, 2)
        state, loss = trainer_lib.train_step(state, images, targets)
        losses.append(float(loss))
        if step % log_every == 0:
            rate = log_every * batch_size / (time.perf_counter() - t0)
            log.info("train_step", step=step,
                     loss=float(np.mean(losses[-log_every:])),
                     imgs_per_sec=round(rate, 2))
            t0 = time.perf_counter()
        if checkpoint_dir and step % checkpoint_every == 0:
            _save(checkpoint_dir, state, step)
    if checkpoint_dir:
        _save(checkpoint_dir, state, steps)
    return state, losses


def _save(directory: str, state, step: int):
    path = os.path.join(os.path.abspath(directory), f"step_{step}.npz")
    save_training_checkpoint(path, state.model.state_dict(), step)
    log.info("checkpoint_saved", step=step, directory=directory)
