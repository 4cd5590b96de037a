"""The yardstick's counts: model FLOPs from a configuration's widths agree
with `torch.utils.flop_counter` on the plain reference, and the kernel
bounds follow their formulas."""

from __future__ import annotations

import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import bench, peaks
from port_bench.counts import edet_lite_hrnet as arch, kernels, model
from port_bench.reference import models


def config(name):
    return bench.read_json(os.path.join(bench.ROOT, bench.PACKAGE,
                                        "configs", name + ".json"))


def counted(module, x):
    with FlopCounterMode(display=False) as fc:
        module(x)
    return fc.get_total_flops()


@pytest.mark.parametrize("name,det_g,pose_g,params_m", [
    ("lite4_w32", 30.268, 34.403, (15.130, 29.306)),
    ("lite4_w48", 30.268, 70.613, (15.130, 65.326)),
])
def test_model_flops_match_flop_counter(name, det_g, pose_g, params_m):
    c = config(name)
    d, p = c["detector"], c["pose"]
    with torch.device("meta"):
        det = models.EfficientDet(d["width_mult"], d["depth_mult"],
                                  d["fpn_channels"], d["fpn_repeats"],
                                  d["head_repeats"], d["num_classes"])
        pose = models.HRNet(p["width"], p["num_keypoints"])
        images = torch.zeros(1, d["input_height"], d["input_width"], 3)
        crops = torch.zeros(1, 3, p["crop_height"], p["crop_width"])
    assert model.detector_flops(d) == counted(det, images)
    assert model.pose_flops(p) == counted(pose, crops)
    assert model.detector_flops(d) / 1e9 == pytest.approx(det_g, abs=1e-3)
    assert model.pose_flops(p) / 1e9 == pytest.approx(pose_g, abs=1e-3)
    assert arch.image_flops(c) == model.detector_flops(d) + \
        3 * model.pose_flops(p)
    n = [sum(t.numel() for t in m.parameters()) / 1e6 for m in (det, pose)]
    assert n == pytest.approx(params_m, abs=1e-3)


def test_kernel_bounds_at_the_serving_shapes():
    calls = arch.serving_calls(config("lite4_w32"), 16)
    # head-score: 16 x 6400 cells x 224 features into 9 x 90 logits
    nbytes, ops, peak = calls["head_score"]
    m = 16 * 6400
    assert ops == 2.0 * m * 224 * 9 * 90 and peak == peaks.BF16_FLOP_PER_S
    assert nbytes == m * 224 * 2 + 810 * 224 * 2 + 810 * 4 + 2 * m * 9 * 4
    t, by = kernels.bound_s(*calls["head_score"])
    assert by == "operations" and t == pytest.approx(3.757e-5, rel=1e-3)
    t, by = kernels.bound_s(*calls["nms_sweep"])
    assert t == pytest.approx(2.72e-8, rel=1e-2)
