"""Checkpoint loading: the compact `.npz` format and the flax-tree ->
`state_dict` converter.

`load_compact_checkpoint` is this package's own copy of the JAX package's
reader (`models/weights.py:103-118`): keys are '/'-joined flax pytree
paths, float16 at rest, float32 on load.

The port names its modules after the flax modules, so a flax leaf path maps
to a `state_dict` key one to one:
  params/.../kernel  [kh, kw, in, out] (HWIO)   -> .../weight  OIHW
                     depthwise [kh, kw, 1, C]   -> .../weight  [C, 1, kh, kw]
  params/.../bias                               -> .../bias
  params/.../scale   (BatchNorm)                -> .../weight
  batch_stats/.../mean, var                     -> .../running_mean, running_var
(+ a zero `num_batches_tracked` per BatchNorm, which inference never
reads). Loaded with `load_state_dict(..., strict=True)`, a flax leaf the
port has no place for, or a port tensor the checkpoint does not fill,
raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_certified_checkpoint() -> str:
    """The committed synthetic-certified EfficientDet-Lite4 @ 480x640 +
    HRNet-W32 @ 384x288 weights (read in place, never copied)."""
    return os.path.join(
        _REPO_DIR, "human_body_proportion_estimation_tpu", "checkpoints",
        "certified_lite4_w32.npz",
    )


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
            if path[-1] == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))   # HWIO -> OIHW
            key = ".".join(path[:-1] + (mapping[path[-1]],))
            if key in sd:
                raise KeyError(f"{key}: two flax leaves map to one key")
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
            if path[-1] == "mean":
                sd[".".join(path[:-1] + ("num_batches_tracked",))] = (
                    torch.zeros((), dtype=torch.long))
    return sd

