"""Weights for both sides of the check, read and made by the benchmark.

`read_compact` reads a compact `.npz` of flax variables (keys
`det|pose/params|batch_stats/<module path>/<leaf>`, float16 or float32)
into two `state_dict`s named as the modules of `reference.models` (and of
the measured program, which names its modules alike): kernels HWIO ->
OIHW, `scale` -> `weight`, `mean` / `var` -> `running_mean` /
`running_var`.

`widen_hrnet` makes the pose weights of a wider HRNet from a narrower
one's (`lite4_w48`): each tensor of the wide net holds the narrow net's
in its leading channels; the other channels are drawn from a seed on the
device; weights from the added input channels into the narrow net's
output channels are zero. The wide net then computes the narrow net's
heatmaps exactly, while every convolution runs at the wide widths on
values that are not zero.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_PARAM = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT = {"mean": "running_mean", "var": "running_var"}


def read_compact(path: str) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """(detector state, pose state), float32 CPU tensors."""
    states = {"det": {}, "pose": {}}
    with np.load(path) as data:
        for name in data.files:
            slot, collection, *path_, leaf = name.split("/")
            arr = data[name].astype(np.float32)
            names = _PARAM if collection == "params" else _STAT
            if leaf not in names:
                raise KeyError(f"{name}: unknown leaf")
            if leaf == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))
            key = ".".join(path_ + [names[leaf]])
            states[slot][key] = torch.from_numpy(np.ascontiguousarray(arr))
            if leaf == "mean":
                states[slot][".".join(path_ + ["num_batches_tracked"])] = (
                    torch.zeros((), dtype=torch.long))
    return states["det"], states["pose"]


def widen_hrnet(narrow: Dict[str, torch.Tensor], wide_shapes: Dict[str, tuple],
                seed: int, device) -> Dict[str, torch.Tensor]:
    """The wide net's state (float32, on `device`) from the narrow net's
    state and the wide net's shapes (both keyed alike). Added output
    channels: LeCun-normal convolution weights over the whole wide input,
    BatchNorm scale uniform in [0.5, 1.5], shift normal(0, 0.1), mean 0,
    variance 1; conv biases copied (the head's outputs do not widen). All
    drawn from `seed` by one generator on the device, in key order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    keys = sorted(k for k in wide_shapes
                  if not k.endswith("num_batches_tracked"))
    # one draw for every tensor: normal and uniform numbers in two calls
    sizes = [int(np.prod(wide_shapes[k])) for k in keys]
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for key, size in zip(keys, sizes):
        shape = wide_shapes[key]
        small = narrow[key].to(device)
        n, u = normal[at:at + size].view(shape), uniform[at:at + size]
        u = u.view(shape)
        at += size
        leaf = key.rsplit(".", 1)[1]
        if leaf == "weight" and len(shape) == 4:
            t = n * float(np.prod(shape[1:])) ** -0.5
            o, i = small.shape[:2]
            t[:o] = 0.0
            t[:o, :i] = small
        else:
            if leaf == "weight":       # BatchNorm scale
                t = 0.5 + u
            elif leaf == "bias" and key.rsplit(".", 2)[-2] == "bn":
                t = 0.1 * n
            elif leaf == "running_var":
                t = torch.ones(shape, device=device)
            else:                      # running means, conv biases
                t = torch.zeros(shape, device=device)
            t[:small.shape[0]] = small
        out[key] = t.contiguous()
    for key in wide_shapes:
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.long, device=device)
    return out
