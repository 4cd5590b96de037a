"""Device mesh and placement rules for multi-device serving and training
(port of the JAX package's `parallel/mesh.py`).

A `Mesh` is a (dp, tp) grid of `torch.device`s with the JAX axis names
("data", "model"):

- `data`: serving batches and training batches are cut into dp
  contiguous row shards, one per data index; the weights are replicated.
- `model`: the tensor-parallel rule of JAX `param_shardings` says which
  parameters are stored sharded over the model axis (the last dim of the
  flax leaf, its output channels, when that dim is >= 64 and divisible by
  tp). The port applies it to its OIHW `state_dict` through the flax names
  of `models/weights.state_dict_to_flax`, so a conv's sharded dim is OIHW
  dim 0 (a transposed conv's dim 1), a bias's or a BatchNorm vector's
  dim 0.

In one process a mesh may list a device more than once: two shards on one
card, or on the CPU, run one after the other on that device (the tests and
the one-card check build a dp = 2 mesh so). Across processes
(`torch.distributed`), rank r is the mesh cell (r // tp, r % tp).
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import weakref
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, tp) array of `torch.device`s over the axes ("data",
    "model")."""

    devices: np.ndarray   # object array [dp, tp] of torch.device
    axis_names: tuple = AXES

    @property
    def shape(self) -> Dict[str, int]:
        dp, tp = self.devices.shape
        return {"data": int(dp), "model": int(tp)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data shard (model index 0), in order."""
        return list(self.devices[:, 0])

    def cell(self, rank: int) -> tuple:
        """(data index, model index) of process `rank`."""
        tp = self.shape["model"]
        return rank // tp, rank % tp


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ("data", "model") mesh over the first `n_devices` of `devices`
    (default: every CUDA device), dp = n / model_parallel rows of
    `model_parallel` devices. `devices` may repeat a device."""
    kind = "CUDA " if devices is None else ""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if n_devices < 1 or len(devices) < n_devices:
        raise ValueError(f"{n_devices} devices asked for, "
                         f"{len(devices)} {kind}devices available")
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by model_parallel="
            f"{model_parallel}"
        )
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n_devices // model_parallel, model_parallel))


def batch_sharding(mesh: Mesh, ndim: int = 4) -> tuple:
    """The placement of a batch: its leading axis over 'data', the rest
    replicated (a JAX PartitionSpec as a tuple)."""
    return ("data",) + (None,) * (ndim - 1)


def replicated(mesh: Mesh) -> tuple:
    """The placement of a replicated value (JAX `P()`)."""
    return ()


def _flax_dim(key: str, state: Mapping[str, torch.Tensor]) -> int:
    """The torch dim of `state[key]` that is the last dim of its flax
    leaf: OIHW dim 0 for a conv kernel (HWIO last = O), dim 1 for a
    transposed conv's (in, out, kh, kw) (flax (kh, kw, in, out)), dim 0
    for a vector."""
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        _TRANSPOSED_CONVS,
    )

    module, leaf = key.rsplit(".", 1) if "." in key else ("", key)
    if (state[key].dim() == 4 and leaf == "weight"
            and module.rsplit(".", 1)[-1] in _TRANSPOSED_CONVS):
        return 1
    return 0


def param_shardings(state: Mapping[str, torch.Tensor], mesh: Mesh,
                    min_dim: int = 64) -> Dict[str, Optional[int]]:
    """JAX `param_shardings` on a port `state_dict`: for each key, the
    torch dim stored sharded over 'model', or None (replicated). A leaf is
    sharded when the last dim of its flax shape (its output channels) is
    >= `min_dim` and divisible by the model axis; `num_batches_tracked`
    (no flax leaf) is replicated."""
    model_size = mesh.shape["model"]
    out: Dict[str, Optional[int]] = {}
    for key, value in state.items():
        out[key] = None
        if model_size <= 1 or key.endswith("num_batches_tracked") \
                or value.dim() == 0:
            continue
        dim = _flax_dim(key, state)
        size = value.shape[dim]
        if size >= min_dim and size % model_size == 0:
            out[key] = dim
    return out


def shard_tree(state: Mapping[str, torch.Tensor],
               shardings: Mapping[str, Optional[int]], mesh: Mesh,
               model_index: int) -> Dict[str, torch.Tensor]:
    """The slice of each leaf that model index `model_index` stores: a
    sharded leaf's `model_index`-th chunk along its sharded dim, a
    replicated leaf whole (JAX `shard_tree`, one device's view)."""
    tp = mesh.shape["model"]
    return {k: v if shardings.get(k) is None
            else v.chunk(tp, dim=shardings[k])[model_index]
            for k, v in state.items()}


# --------------------------------------------------------------------- #
# data-parallel helpers of the serving pipelines


def pad_to_shards(b: int, dp: int) -> int:
    """A batch of `b` rows padded for `dp` shards: at least dp rows, a
    multiple of dp (JAX `InferencePipeline._prepare`)."""
    b = max(b, dp)
    return -(-b // dp) * dp


def split_rows(arrays: Sequence, dp: int) -> List[list]:
    """Each array's rows cut into `dp` contiguous equal shards:
    [[shard 0 of each array], [shard 1 ...], ...]."""
    b = len(arrays[0])
    if b % dp:
        raise ValueError(f"{b} rows do not split into {dp} shards")
    per = b // dp
    return [[a[i * per:(i + 1) * per] for a in arrays] for i in range(dp)]


def to_shards(arrays: Sequence[np.ndarray],
              devices: Sequence[torch.device]) -> List[list]:
    """Host arrays -> [per device: the arrays' contiguous rows on it], the
    copies finished when it returns."""
    shards = [[torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in part]
              for d, part in zip(devices, split_rows(arrays, len(devices)))]
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()
    return shards


_REPLICAS: "weakref.WeakKeyDictionary[nn.Module, Dict[str, nn.Module]]" = (
    weakref.WeakKeyDictionary())
_REPLICAS_LOCK = threading.Lock()


def replica(module: nn.Module, device: torch.device) -> nn.Module:
    """`module` itself where it lives on `device`, else its copy there,
    made once per (module, device) and shared by every caller. A
    submodule already copied to `device` is shared by the copy, and the
    copy's submodules become those modules' own copies, so the serving
    pipeline's program and the registry's pose model hold one pose per
    device, whichever is replicated first. A copy is made once: weights
    changed in place afterwards do not reach it (load them first)."""
    device = torch.device(device)
    first = next(module.parameters(), None)
    if first is None or same_device(first.device, device):
        return module
    key = str(device)
    with _REPLICAS_LOCK:
        found = _REPLICAS.get(module, {}).get(key)
        if found is None:
            memo = {id(sub): _REPLICAS[sub][key] for sub in module.modules()
                    if key in _REPLICAS.get(sub, {})}
            found = copy.deepcopy(module, memo).to(device)
            for sub, twin in zip(module.modules(), found.modules()):
                _REPLICAS.setdefault(sub, {}).setdefault(key, twin)
        return found


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (a CUDA device without an index is the
    current one)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    index = lambda d: d.index if d.index is not None \
        else torch.cuda.current_device()   # noqa: E731
    return index(a) == index(b)
