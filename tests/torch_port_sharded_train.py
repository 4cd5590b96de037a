"""The cases of the port's sharded train-step test
(tests/test_torch_port_sharded_train.py), shared by the test (the
one-process steps) and its worker processes
(tests/torch_port_sharded_train_worker.py, the sharded steps); torch and
the port only.

Tiny models in float64 (HRNet and HigherHRNet of the train-step tests'
POSE config, the tiny EfficientDet of the caller's config), flax's init
from seed 0, a global batch of 4 made from a seed, two optimizer steps.
"""

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
    EfficientDet,
)
from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
    HigherHRNet,
)
from human_body_proportion_estimation_tpu_torch.models.hrnet import (
    HRNet,
    HRNetConfig,
)
from human_body_proportion_estimation_tpu_torch.models.layers import (
    init_flax_default,
)
from human_body_proportion_estimation_tpu_torch.training import (
    bottomup as BU,
    detection as D,
    trainer as T,
)

POSE = dict(width=16, stage_modules=(1, 1, 1), blocks_per_branch=1,
            stem_channels=16, bottleneck_channels=16)
BATCH, STEPS, LR = 4, 2, 1e-3
CROP_HW, DET_HW, BU_HW = (64, 32), (128, 128), (64, 64)
F64 = torch.float64


def _model(kind, det_config):
    if kind == "det":
        return EfficientDet(det_config, dtype=F64)
    if kind == "bottomup":
        return HigherHRNet(HRNetConfig(**POSE), num_deconv_blocks=1,
                           dtype=F64)
    return HRNet(HRNetConfig(**POSE), dtype=F64)


def build(kind: str, det_config=None):
    """(train state, global batch) of a case: "pose", "det" (with the
    certify recipe's schedule and clip) or "bottomup"."""
    model = init_flax_default(_model(kind, det_config), 0).double()
    rng = np.random.default_rng({"pose": 1, "det": 2, "bottomup": 3}[kind])
    if kind == "det":
        state = D.create_det_train_state(model, None, LR, total_steps=10,
                                         warmup_steps=1, clip_norm=10.0)
        images = torch.from_numpy(rng.integers(
            0, 256, (BATCH, *DET_HW, 3), dtype=np.uint8))
        boxes = np.zeros((BATCH, 2, 4), np.float32)
        for b in range(BATCH):
            y, x = rng.uniform(10, 60, 2)
            boxes[b, 0] = (y, x, y + rng.uniform(30, 60),
                           x + rng.uniform(20, 50))
        classes = np.zeros((BATCH, 2), np.int32)
        valid = np.zeros((BATCH, 2), bool)
        valid[:, 0] = True
        return state, (images, torch.from_numpy(boxes),
                       torch.from_numpy(classes), torch.from_numpy(valid))
    state = T.create_train_state(model, None, LR)
    if kind == "bottomup":
        x = torch.from_numpy(rng.uniform(0, 1, (BATCH, 3, *BU_HW)))
        kp = torch.from_numpy(rng.uniform(0, 63, (BATCH, 3, 17, 2)))
        vis = torch.from_numpy(rng.random((BATCH, 3, 17)) < 0.8)
        return state, (x, kp, vis)
    x = torch.from_numpy(rng.uniform(0, 1, (BATCH, 3, *CROP_HW)))
    kp = torch.from_numpy(rng.uniform(0, 1, (BATCH, 17, 2))
                          * np.array([CROP_HW[1] / 4, CROP_HW[0] / 4]))
    vis = torch.from_numpy(rng.random((BATCH, 17)) < 0.8)
    targets = T.heatmap_targets(kp, vis, CROP_HW[0] // 4,
                                CROP_HW[1] // 4).double()
    return state, (x, targets)


ONE_PROCESS_STEP = {"pose": T.train_step, "det": D.train_step,
                    "bottomup": BU.bottomup_train_step}


def sharded_step(kind, state, mesh):
    """(step, sharded state) of a case over `mesh`."""
    return {"pose": T.make_sharded_train_step,
            "det": D.make_sharded_det_train_step,
            "bottomup": BU.make_sharded_bottomup_step}[kind](state, mesh)


def run(kind, state, batch, step=None) -> dict:
    """STEPS steps of `step` (the one-process step by default): the
    losses, every parameter's gradient of the first step, and the state
    after the last."""
    step = step or ONE_PROCESS_STEP[kind]
    losses, grads = [], None
    for i in range(STEPS):
        state, loss = step(state, *batch)
        losses.append(float(loss))
        if i == 0:
            grads = {n: p.grad.detach().clone()
                     for n, p in state.model.named_parameters()
                     if p.grad is not None}
    return {"losses": losses, "grads": grads,
            "state": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()}}
