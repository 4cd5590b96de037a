"""YOLOv5 weights: the official ultralytics `state_dict` names <-> the
port's names (port of the JAX package's `models/yolo_weights.py`), and a
seeded random initialization.

The converters are numpy only. Both sides are OIHW, so only names move:

  official (v6.0 layout)            port (= the flax module names)
  model.{i}.conv.weight             {name}.conv.weight
  model.{i}.bn.{weight,bias,        {name}.bn.{weight,bias,
            running_mean,var}                  running_mean,var}
  model.{i}.cv{1,2,3}.*             {name}.cv{1,2,3}.*   (C3, SPPF)
  model.{i}.m.{k}.cv{1,2}.*         {name}.m{k}.cv{1,2}.*
  model.24.m.{l}.{weight,bias}      detect{l}.{weight,bias}

with the layer indices 0 stem | 1 down1 | 2 c3_1 | 3 down2 | 4 c3_2 |
5 down3 | 6 c3_3 | 7 down4 | 8 c3_4 | 9 sppf | 10 head_cv1 | 13 head_c3_1 |
14 head_cv2 | 17 head_c3_2 | 18 head_cv3 | 20 head_c3_3 | 21 head_cv4 |
23 head_c3_4 | 24 Detect (11/15 upsample and 12/16/19/22 concat own no
parameters).

No YOLO weights are in the repository and none are fetched: a detector
built without a state dict comes from `seeded_state`, a numpy generator
seeded explicitly, and is labelled "random" where weights are reported.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np

from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
    YOLOV5M,
    YoloV5Config,
)

# (port module name, official index, kind): "conv" = ConvBnSiLU,
# "c3" = C3 block, "sppf" = SPPF
_LAYOUT: List[Tuple[str, int, str]] = [
    ("stem", 0, "conv"),
    ("down1", 1, "conv"),
    ("c3_1", 2, "c3"),
    ("down2", 3, "conv"),
    ("c3_2", 4, "c3"),
    ("down3", 5, "conv"),
    ("c3_3", 6, "c3"),
    ("down4", 7, "conv"),
    ("c3_4", 8, "c3"),
    ("sppf", 9, "sppf"),
    ("head_cv1", 10, "conv"),
    ("head_c3_1", 13, "c3"),
    ("head_cv2", 14, "conv"),
    ("head_c3_2", 17, "c3"),
    ("head_cv3", 18, "conv"),
    ("head_c3_3", 20, "c3"),
    ("head_cv4", 21, "conv"),
    ("head_c3_4", 23, "c3"),
]
# base C3 depths per slot (scaled by config.depth)
_C3_BASE_DEPTH = {
    "c3_1": 3, "c3_2": 6, "c3_3": 9, "c3_4": 3,
    "head_c3_1": 3, "head_c3_2": 3, "head_c3_3": 3, "head_c3_4": 3,
}
_CONV_LEAVES = ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean",
                "bn.running_var")


def _convbn_pairs(cfg: YoloV5Config) -> List[Tuple[str, str]]:
    """[(port ConvBnSiLU prefix, official prefix)] for every conv + bn."""
    pairs: List[Tuple[str, str]] = []
    for name, idx, kind in _LAYOUT:
        t = f"model.{idx}"
        if kind == "conv":
            pairs.append((name, t))
        elif kind == "sppf":
            pairs += [(f"{name}.cv1", f"{t}.cv1"), (f"{name}.cv2", f"{t}.cv2")]
        else:
            pairs += [(f"{name}.{cv}", f"{t}.{cv}")
                      for cv in ("cv1", "cv2", "cv3")]
            for k in range(cfg.depth(_C3_BASE_DEPTH[name])):
                pairs += [(f"{name}.m{k}.{cv}", f"{t}.m.{k}.{cv}")
                          for cv in ("cv1", "cv2")]
    return pairs


def _name_map(cfg: YoloV5Config) -> List[Tuple[str, str]]:
    """[(port key, official key)] for every parameter and statistic."""
    out = [(f"{ours}.{leaf}", f"{theirs}.{leaf}")
           for ours, theirs in _convbn_pairs(cfg) for leaf in _CONV_LEAVES]
    out += [(f"detect{li}.{leaf}", f"model.24.m.{li}.{leaf}")
            for li in range(3) for leaf in ("weight", "bias")]
    return out


def import_torch_yolov5(
    state_dict: Mapping[str, np.ndarray],
    config: YoloV5Config = YOLOV5M,
    strict: bool = True,
) -> Dict[str, np.ndarray]:
    """Official state_dict (numpy values) -> the port's `state_dict` (f32
    numpy, with the zero `num_batches_tracked` every BatchNorm carries).
    A missing official key raises when `strict`, and is left out
    otherwise."""
    out: Dict[str, np.ndarray] = {}
    for ours, theirs in _name_map(config):
        if theirs not in state_dict:
            if strict:
                raise KeyError(theirs)
            continue
        out[ours] = np.asarray(state_dict[theirs], np.float32)
        if ours.endswith(".bn.running_var"):
            out[ours[:-len("running_var")] + "num_batches_tracked"] = (
                np.zeros((), np.int64))
    return out


def export_torch_yolov5(
    state_dict: Mapping[str, np.ndarray], config: YoloV5Config = YOLOV5M
) -> Dict[str, np.ndarray]:
    """The port's `state_dict` (numpy or CPU tensors) -> official names
    (the inverse mapping, for round trips and torch tooling)."""
    return {theirs: np.asarray(state_dict[ours])
            for ours, theirs in _name_map(config)}


def seeded_state(
    config: YoloV5Config,
    seed: int,
    calibration: np.ndarray,
    obj_bias: float = 0.0,
    person_bias: float = 0.0,
) -> Dict[str, np.ndarray]:
    """A random port `state_dict` (f32 numpy) made from
    `np.random.default_rng(seed)` and calibrated on `calibration`, model
    inputs NCHW in [0, 1] (e.g. letterboxed images / 255).

    1. Draws, key after key in the module's order: LeCun-normal conv
       weights (std fan_in^-1/2, as flax initializes them), BatchNorm
       scales uniform in [0.5, 1.5] and shifts normal with std 0.1, Detect
       biases 0.
    2. Calibrates: one float64 forward on the CPU over `calibration` sets
       every BatchNorm's running mean to its conv's per-channel mean there
       and its running variance to the per-channel variance, floored at
       the layer's mean variance; each Detect conv's weights are then
       scaled so that its logits have standard deviation 1 there.
       A deep random network is chaotic: with statistics drawn at random,
       or calibrated on other images, its signal dies out or grows by
       orders of magnitude on the way to the heads; calibrated on the
       images it will see, its logits stay near 1 and depend on the
       image.
    3. Adds `obj_bias` to the objectness logit and `person_bias` to the
       person-class logit (class 0) of every anchor, so that random
       weights give person candidates above the postprocess's 0.4
       confidence.

    float64 on the CPU makes the result the same on every machine to far
    below what an f32 forward can resolve."""
    import torch

    from human_body_proportion_estimation_tpu_torch.models.layers import (
        ConvBN,
    )
    from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
        YoloV5,
    )

    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = YoloV5(config, dtype=torch.float64)
    state = {}
    for key, value in model.state_dict().items():
        leaf, shape = key.rsplit(".", 1)[1], tuple(value.shape)
        if leaf == "num_batches_tracked":
            state[key] = np.zeros(shape, np.int64)
        elif leaf == "weight" and len(shape) == 4:
            state[key] = rng.normal(0.0, int(np.prod(shape[1:])) ** -0.5,
                                    shape)
        elif leaf == "weight":
            state[key] = rng.uniform(0.5, 1.5, shape)
        elif leaf == "bias" and not key.startswith("detect"):
            state[key] = rng.normal(0.0, 0.1, shape)
        else:           # Detect biases; statistics, set by the calibration
            state[key] = np.zeros(shape) if leaf != "running_var" \
                else np.ones(shape)
    model = model.to_empty(device="cpu").double().eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})

    def set_stats(bn, out):
        var = out.var((0, 2, 3))
        bn.running_mean.copy_(out.mean((0, 2, 3)))
        bn.running_var.copy_(var.clamp_min(float(var.mean())))

    detect_std: Dict[str, float] = {}
    hooks = []
    for name, module in model.named_modules():
        if isinstance(module, ConvBN):
            hooks.append(module.conv.register_forward_hook(
                lambda m, i, o, bn=module.bn: set_stats(bn, o)))
        elif name.startswith("detect"):
            hooks.append(module.register_forward_hook(
                lambda m, i, o, name=name: detect_std.__setitem__(
                    name, float(o.std()))))
    with torch.no_grad():
        model(torch.from_numpy(np.asarray(calibration, np.float64)))
    for h in hooks:
        h.remove()

    no = 5 + config.num_classes
    out: Dict[str, np.ndarray] = {}
    for key, value in model.state_dict().items():
        arr = value.numpy().copy()
        module = key.rsplit(".", 1)[0]
        if module in detect_std:
            if key.endswith("weight"):
                arr /= detect_std[module]
            else:
                arr[4::no] += obj_bias
                arr[5::no] += person_bias
        out[key] = arr if arr.dtype == np.int64 else arr.astype(np.float32)
    return out
