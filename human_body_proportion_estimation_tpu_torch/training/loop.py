"""Training loop: data pipeline -> train step -> checkpoints (port of the
JAX package's `training/loop.py`).

Pulls augmented batches from `training/data`, builds heatmap targets,
drives `trainer.train_step` on the model's device, logs losses, and
checkpoints as the JAX package does: an Orbax PyTree checkpoint
`step_N/` of `{params, batch_stats, step}` in flax's layout
(`models/orbax_store.save_tree`; `step` a scalar int32). `mesh=` trains with the sharded step over
a dp x tp mesh of processes (`trainer.make_sharded_train_step`): every
process draws the same batches and takes its rows, and process 0 writes
the checkpoints.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.models import orbax_store
from human_body_proportion_estimation_tpu_torch.models.weights import (
    state_dict_to_flax,
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
    the device it lives on, or over `mesh` (a `parallel.mesh.Mesh` of
    processes); returns (train state, per-step losses)."""
    h, w = crop_hw
    state = trainer_lib.create_train_state(model, seed, learning_rate)
    step_fn = trainer_lib.train_step
    writer = True
    if mesh is not None:
        step_fn, state = trainer_lib.make_sharded_train_step(state, mesh)
        writer = state.cell == (0, 0)
    device = next(model.parameters()).device

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
        state, loss = step_fn(state, images, targets)
        losses.append(float(loss))
        if step % log_every == 0:
            rate = log_every * batch_size / (time.perf_counter() - t0)
            log.info("train_step", step=step,
                     loss=float(np.mean(losses[-log_every:])),
                     imgs_per_sec=round(rate, 2))
            t0 = time.perf_counter()
        if checkpoint_dir and writer and step % checkpoint_every == 0:
            _save(checkpoint_dir, state, step)
    if checkpoint_dir and writer:
        _save(checkpoint_dir, state, steps)
    return state, losses


def _save(directory: str, state, step: int):
    tree = state_dict_to_flax(state.model.state_dict())
    tree["step"] = np.asarray(step, np.int32)
    orbax_store.save_tree(
        os.path.join(os.path.abspath(directory), f"step_{step}"), tree)
    log.info("checkpoint_saved", step=step, directory=directory)
