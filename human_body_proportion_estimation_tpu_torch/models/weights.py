"""Checkpoint loading: the compact `.npz` format and the flax-tree ->
`state_dict` converter.

`load_compact_checkpoint` is this package's own copy of the JAX package's
reader (`models/weights.py:103-118`): keys are '/'-joined flax pytree
paths, float16 at rest, float32 on load.

The port names its modules after the flax modules, so a flax leaf path maps
to a `state_dict` key one to one:
  params/.../kernel  [kh, kw, in, out] (HWIO)   -> .../weight  OIHW
                     depthwise [kh, kw, 1, C]   -> .../weight  [C, 1, kh, kw]
  params/.../deconv/kernel (flax ConvTranspose, [kh, kw, in, out],
                     unflipped)                 -> .../deconv.weight
                     [in, out, kh, kw], spatially flipped (torch's
                     transposed conv is the adjoint of a conv; the JAX
                     package's `_deconv_to_torch`, weights.py:338)
  params/.../bias                               -> .../bias
  params/.../scale   (BatchNorm)                -> .../weight
  batch_stats/.../mean, var                     -> .../running_mean, running_var
(+ a zero `num_batches_tracked` per BatchNorm, which inference never
reads). Loaded with `load_state_dict(..., strict=True)`, a flax leaf the
port has no place for, or a port tensor the checkpoint does not fill,
raises. `state_dict_to_flax` is the exact inverse.

Writers, for the trainers (`training/`):
  * `save_compact_checkpoint`: the JAX package's compact `.npz`
    (weights.py:85-100): f16 leaves under '/'-joined flax paths, in the
    order of flax's sorted trees, so the JAX `load_compact_checkpoint`
    reads what the port writes.
  * `save_training_checkpoint` / `load_training_checkpoint`: the
    `{params, batch_stats, step}` tree the JAX trainers checkpoint, as an
    f32 `.npz`. The JAX package writes it with Orbax
    (weights.py:39-66, training/loop.py:81-94), and `orbax.checkpoint`
    imports jax; reading Orbax checkpoints is ROADMAP.md item 17.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_certified_checkpoint() -> str:
    """The committed synthetic-certified EfficientDet-Lite4 @ 480x640 +
    HRNet-W32 @ 384x288 weights (read in place, never copied)."""
    return os.path.join(
        _REPO_DIR, "human_body_proportion_estimation_tpu", "checkpoints",
        "certified_lite4_w32.npz",
    )


def default_certified_bottomup_checkpoint() -> str:
    """Where the JAX package keeps its synthetic-certified bottom-up
    checkpoint (HigherHRNet @ 512x512, pose slot only), the weights
    `serve.server --bottom-up` serves when the file is there."""
    return os.path.join(
        _REPO_DIR, "human_body_proportion_estimation_tpu", "checkpoints",
        "certified_higherhrnet.npz",
    )


def maybe_load_certified(bottom_up: bool = False):
    """(det_state, pose_state) port `state_dict`s of the committed
    synthetic-certified checkpoint (the bottom-up one with `bottom_up`,
    whose detector slot is empty: None), or (None, None) when the file is
    absent or HBPE_DISABLE_CERTIFIED_FALLBACK is set. The rule of the JAX
    package's `maybe_load_certified`; callers label the slots they use
    "synthetic-certified"."""
    if os.environ.get("HBPE_DISABLE_CERTIFIED_FALLBACK"):
        return None, None
    path = (default_certified_bottomup_checkpoint() if bottom_up
            else default_certified_checkpoint())
    if not os.path.exists(path):
        return None, None
    return tuple(flax_to_state_dict(tree) if tree else None
                 for tree in load_compact_checkpoint(path))


def load_compact_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """(det_vars, pose_vars) flax-style trees of float32 numpy arrays."""
    data = np.load(path)
    trees: Dict[str, Dict] = {"det": {}, "pose": {}}
    for name in data.files:
        parts = name.split("/")
        node = trees[parts[0]]
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        arr = data[name]
        if arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        node[parts[-1]] = arr
    return trees["det"], trees["pose"]


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
# flax modules that are transposed convs (HigherHRNet's `deconv`)
_TRANSPOSED_CONVS = ("deconv",)
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} flax tree (numpy leaves) -> the
    port's `state_dict` (float32)."""
    sd: Dict[str, torch.Tensor] = {}
    for collection, mapping in (("params", _PARAM_LEAF),
                                ("batch_stats", _STAT_LEAF)):
        for path, leaf in _leaves(variables.get(collection, {})):
            arr = np.array(leaf, np.float32)  # a writable copy
            if path[-1] not in mapping:
                raise KeyError(f"{collection}/{'/'.join(path)}: unknown leaf")
            if path[-1] == "kernel" and path[-2] in _TRANSPOSED_CONVS:
                arr = np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            elif path[-1] == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))   # HWIO -> OIHW
            key = ".".join(path[:-1] + (mapping[path[-1]],))
            if key in sd:
                raise KeyError(f"{key}: two flax leaves map to one key")
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
            if path[-1] == "mean":
                sd[".".join(path[:-1] + ("num_batches_tracked",))] = (
                    torch.zeros((), dtype=torch.long))
    return sd


def state_dict_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The port's `state_dict` -> {'params': ..., 'batch_stats': ...} flax
    tree of f32 numpy arrays: the exact inverse of `flax_to_state_dict`
    (OIHW -> HWIO, the transposed conv's flip undone, BatchNorm weight ->
    scale, running statistics -> batch_stats; `num_batches_tracked`, which
    flax has no leaf for, is dropped)."""
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if leaf == "num_batches_tracked":
            continue
        arr = value.detach().to("cpu", torch.float32).numpy()
        is_bn = f"{module}.running_mean" in state
        if leaf in ("running_mean", "running_var"):
            collection, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and is_bn:
            collection, name = "params", "scale"
        elif leaf == "weight":
            collection, name = "params", "kernel"
            if module.rsplit(".", 1)[-1] in _TRANSPOSED_CONVS:
                arr = np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 0, 1))
            else:
                arr = np.transpose(arr, (2, 3, 1, 0))   # OIHW -> HWIO
        elif leaf == "bias":
            collection, name = "params", "bias"
        else:
            raise KeyError(f"{key}: unknown leaf")
        node = tree[collection]
        for part in module.split(".") if module else ():
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr, np.float32)
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return tree


def _flat_flax(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """'/'-joined leaf paths of a flax tree in the order of
    `jax.tree_util.tree_flatten_with_path` (dict keys sorted)."""
    out: Dict[str, np.ndarray] = {}
    for k in sorted(tree):
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], Mapping):
            out.update(_flat_flax(tree[k], name))
        else:
            out[name] = np.asarray(tree[k])
    return out


def save_compact_checkpoint(path: str, det_state, pose_state) -> None:
    """Write the detector and pose slots (port `state_dict`s; None or {}
    for an empty slot) into one compressed `.npz` that the JAX package's
    `load_compact_checkpoint` reads: float leaves stored float16 under
    'det/...' and 'pose/...' flax paths."""
    flat: Dict[str, np.ndarray] = {}
    for prefix, slot in (("det", det_state), ("pose", pose_state)):
        tree = state_dict_to_flax(slot) if slot else {}
        for name, arr in _flat_flax(tree, prefix).items():
            if arr.dtype in (np.float32, np.float64):
                arr = arr.astype(np.float16)
            flat[name] = arr
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def save_training_checkpoint(path: str, state: Mapping[str, torch.Tensor],
                             step: int = 0) -> None:
    """Write one model's `state_dict` as the `{params, batch_stats, step}`
    tree, an f32 `.npz`, exactly."""
    flat = _flat_flax(state_dict_to_flax(state))
    flat["step"] = np.asarray(step, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_training_checkpoint(path: str) -> Tuple[Dict, int]:
    """(flax tree {'params', 'batch_stats'} of f32 numpy arrays, step) of a
    `save_training_checkpoint` file; `flax_to_state_dict` turns the tree
    into the port's `state_dict`."""
    data = np.load(path)
    tree: Dict[str, Dict] = {}
    for name in data.files:
        if name == "step":
            continue
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[name]
    return tree, int(data["step"])


@contextlib.contextmanager
def _calibrating_batch_norm():
    """While inside, every inference BatchNorm of the port (all go through
    `F.batch_norm`, `models/layers.batch_norm`) first sets its running
    mean to its input's per-channel mean and its running variance to the
    per-channel variance, floored at that layer's mean variance."""
    plain = F.batch_norm

    def calibrate(x, mean, var, *args, **kwargs):
        dims = [d for d in range(x.dim()) if d != 1]
        v = x.var(dims)
        mean.copy_(x.mean(dims))
        var.copy_(v.clamp_min(float(v.mean())))
        return plain(x, mean, var, *args, **kwargs)

    F.batch_norm = calibrate
    try:
        yield
    finally:
        F.batch_norm = plain


def seeded_state(
    model: nn.Module,
    seed: int,
    calibrate: Callable[[nn.Module], Any],
    heads: Sequence[str] = (),
    bias: Optional[Mapping[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """A random `state_dict` for `model` (f32 numpy) made from
    `np.random.default_rng(seed)` and calibrated by `calibrate(model)`, a
    forward of the float64 model on the CPU over the inputs it will see.

    1. Draws, key after key in the module's order: LeCun-normal conv and
       transposed-conv weights (std fan_in^-1/2, fan_in the inputs one
       output sums over at stride 1, as flax initializes them), BatchNorm
       scales uniform in [0.5, 1.5] and shifts normal with mean 1 and std
       0.1, conv biases 0. The shifts keep most units of the ReLU / ReLU6
       that follow in their linear range: a calibrated network whose
       units are cut half the time amplifies rounding by ~1.2x a layer
       (EfficientDet-Lite0's f32 logits were 1.1e-3 off its float64 ones
       at shift 0, 2.7e-5 at shift 1), and two f32 stacks could then not
       be held to each other.
    2. Calibrates: in the forward, every BatchNorm's running statistics
       become its input's per-channel mean and variance (the variance
       floored at the layer's mean), so that every normalized activation
       has the drawn scale and shift on these inputs: a deep random
       network's signal dies out or grows by orders of magnitude on the
       way to its heads otherwise. Each module named in `heads` then has
       its weight divided by its outputs' standard deviation there.
    3. Adds `bias[key]` to every entry of the bias tensor `key`.

    float64 on the CPU makes the result the same on every machine to far
    below what an f32 forward can resolve (the heads that compute in f32
    whatever the trunk's dtype are calibrated in f32). The same recipe as
    `models/yolo_weights.seeded_state`, for any module of the port."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, value in model.state_dict().items():
        module_name, leaf = key.rsplit(".", 1)
        module, shape = model.get_submodule(module_name), tuple(value.shape)
        if leaf == "num_batches_tracked":
            state[key] = np.zeros(shape, np.int64)
        elif isinstance(module, nn.BatchNorm2d) and leaf == "weight":
            state[key] = rng.uniform(0.5, 1.5, shape)
        elif isinstance(module, nn.BatchNorm2d) and leaf == "bias":
            state[key] = rng.normal(1.0, 0.1, shape)
        elif leaf == "weight":
            fan_in = int(np.prod(shape[1:]))
            if isinstance(module, nn.ConvTranspose2d):
                fan_in = shape[0] * shape[2] * shape[3] // (
                    module.stride[0] * module.stride[1])
            state[key] = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf == "running_var":
            state[key] = np.ones(shape)
        else:       # conv biases, running means
            state[key] = np.zeros(shape)
    model = model.to(device="cpu", dtype=torch.float64).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})

    moments: Dict[str, list] = {name: [0.0, 0.0, 0] for name in heads}

    def record(name, out):
        out = out.double()
        m = moments[name]
        m[0] += float(out.sum())
        m[1] += float((out * out).sum())
        m[2] += out.numel()

    hooks = [model.get_submodule(name).register_forward_hook(
        lambda mod, i, o, name=name: record(name, o)) for name in heads]
    try:
        with torch.no_grad(), _calibrating_batch_norm():
            calibrate(model)
    finally:
        for h in hooks:
            h.remove()
    out: Dict[str, np.ndarray] = {}
    for key, value in model.state_dict().items():
        arr = value.numpy().copy()
        module_name = key.rsplit(".", 1)[0]
        if module_name in moments and key.endswith(".weight"):
            s1, s2, n = moments[module_name]
            arr /= np.sqrt(s2 / n - (s1 / n) ** 2)
        if bias and key in bias:
            arr += bias[key]
        out[key] = arr if arr.dtype == np.int64 else arr.astype(np.float32)
    return out
