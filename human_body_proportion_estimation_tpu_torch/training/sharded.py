"""The train steps over a ("data", "model") mesh of processes (the port of
what `jax.jit` with sharded inputs does for the JAX package's
`make_sharded_train_step`, `make_sharded_det_train_step` and
`make_sharded_bottomup_step`).

One process per mesh cell: rank r is cell (r // tp, r % tp) of `mesh`
(`torch.distributed` initialized by the caller, world size dp x tp), on
the device the mesh names for it. A sharded step is the same math as the
one-process step on the whole (global) batch:

- every rank is given the same global batch (the same index draws) and
  takes the rows of its data index;
- BatchNorm in train mode takes the mean and biased variance of the
  global batch (`models.layers.global_batch_statistics`: the per-channel
  sums are summed over the data group, differentiably), which plain
  DistributedDataParallel does not;
- each rank's loss is the mean over its rows, so the global loss (the
  one-process loss) is their mean over the data group; the gradients are
  summed over the data group of each rank's loss / dp;
- the parameters and the Adam state are stored per the 'model' rule of
  `parallel.mesh.param_shardings`: a rank keeps its 1 / tp slice of a
  sharded leaf, updates it, and the slices are all-gathered over the
  model group into the full parameters of the next step (Adam and the
  clip are elementwise given the global norm, so the slices update as
  the whole would). BatchNorm running statistics come out of the forward
  the same in every rank and stay whole.

Collectives go through `_sum` / `_gather`: CPU tensors as they are, CUDA
tensors staged through the host when the group's backend is gloo (two
processes on one card: NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from human_body_proportion_estimation_tpu_torch.models.layers import (
    global_batch_statistics,
)
from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
    Mesh,
    param_shardings,
)
from human_body_proportion_estimation_tpu_torch.training.trainer import (
    clip_by_global_norm,
)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of `t` over `group` (no autograd)."""
    if group is None:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


class _SumOver(torch.autograd.Function):
    """Differentiable sum over a group: the backward sums the output's
    gradients over it too (every rank's loss depends on every shard)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad.clone(), ctx.group), None


def _gather(shard: torch.Tensor, dim: int, group,
            size: int) -> torch.Tensor:
    """The `size` slices of `group` concatenated along `dim`."""
    src = shard.cpu() if _staged(shard, group) else shard.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(shard.device)


@dataclasses.dataclass
class ShardedTrainState:
    """A train state over a mesh of processes: `model` holds the full
    parameters between steps; `optimizer` (and `scheduler`) update
    `stored`, this rank's slices of the sharded leaves and the replicated
    leaves themselves."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR]
    step: int
    mesh: Mesh
    cell: tuple                        # (data index, model index)
    device: torch.device
    shardings: Dict[str, Optional[int]]
    stored: Dict[str, torch.Tensor]
    data_group: object = None
    model_group: object = None
    clip_norm: float = 0.0
    anchors: Dict = dataclasses.field(default_factory=dict)

    @property
    def dp(self) -> int:
        return self.mesh.shape["data"]

    def rows(self, *tensors: torch.Tensor) -> List[torch.Tensor]:
        """This rank's contiguous rows of each global-batch tensor, on its
        device."""
        b = tensors[0].shape[0]
        if b % self.dp:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{self.dp} data shards")
        per = b // self.dp
        lo = self.cell[0] * per
        return [t[lo:lo + per].to(self.device) for t in tensors]

    def batch_statistics(self):
        """The context of a forward: BatchNorm over the global batch (a
        mesh with one data shard: the batch this process holds)."""
        group = self.data_group
        if group is None:
            return contextlib.nullcontext()
        return global_batch_statistics(lambda t: _SumOver.apply(t, group))


def _groups(mesh: Mesh):
    """(data group, model group) of this rank: every rank creates every
    group, in one order, as `dist.new_group` requires."""
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    rank = dist.get_rank()
    data_group = model_group = None
    for j in range(tp):
        g = dist.new_group([i * tp + j for i in range(dp)])
        if rank % tp == j:
            data_group = g
    for i in range(dp):
        g = dist.new_group([i * tp + j for j in range(tp)])
        if rank // tp == i:
            model_group = g
    return data_group, model_group


def shard_state(state, mesh: Mesh) -> ShardedTrainState:
    """`state` (a `PoseTrainState` or `DetTrainState`) over `mesh`: the
    model moved to this rank's device, a new optimizer of the same kind
    and settings over the stored slices (any Adam moments sliced
    likewise), the schedule carried over. A one-device mesh needs no
    process group."""
    if mesh.size > 1 and (not dist.is_initialized()
                          or dist.get_world_size() != mesh.size):
        raise ValueError(
            f"a mesh of {mesh.size} devices needs torch.distributed "
            f"initialized with world size {mesh.size} (one process a "
            "device); see parallel.multihost.init_multihost")
    rank = dist.get_rank() if mesh.size > 1 else 0
    cell = mesh.cell(rank)
    data_group, model_group = _groups(mesh) if mesh.size > 1 else (None,
                                                                   None)
    device = mesh.devices[cell]
    model = state.model.to(device)
    names = {p: n for n, p in model.named_parameters()}
    shardings = param_shardings(model.state_dict(), mesh)
    tp = mesh.shape["model"]

    def local(name, full: torch.Tensor) -> torch.Tensor:
        dim = shardings.get(name)
        return full if dim is None else \
            full.detach().chunk(tp, dim)[cell[1]].clone()

    stored = {n: (p if shardings.get(n) is None
                  else nn.Parameter(local(n, p)))
              for n, p in model.named_parameters()}
    old = state.optimizer
    optimizer = type(old)(list(stored.values()), **old.defaults)
    for p, moments in old.state.items():
        name = names[p]
        optimizer.state[stored[name]] = {
            k: local(name, v) if torch.is_tensor(v) and v.shape == p.shape
            else v for k, v in moments.items()}
    scheduler = None
    if state.scheduler is not None:
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, state.scheduler.lr_lambdas[0])
        for _ in range(state.scheduler.last_epoch):
            scheduler.step()
    return ShardedTrainState(
        model=model, optimizer=optimizer, scheduler=scheduler,
        step=state.step, mesh=mesh, cell=cell, device=device,
        shardings=shardings, stored=stored, data_group=data_group,
        model_group=model_group,
        clip_norm=getattr(state, "clip_norm", 0.0),
        anchors=getattr(state, "anchors", {}))


def apply_sharded_updates(sstate: ShardedTrainState,
                          loss: torch.Tensor) -> torch.Tensor:
    """Backward of this rank's mean loss over its rows, the gradients
    summed over the data group (of loss / dp: the global mean's), the
    optional global-norm clip, one optimizer (and schedule) step on the
    stored slices, then the slices gathered into the full parameters.
    Returns the global loss (the mean over the data group), detached."""
    dp = sstate.dp
    params = list(sstate.model.parameters())
    for p in params:
        p.grad = None
    (loss / dp).backward()
    for p in params:
        if p.grad is not None:
            _sum(p.grad, sstate.data_group)
    if sstate.clip_norm > 0:
        clip_by_global_norm(params, sstate.clip_norm)
    tp = sstate.mesh.shape["model"]
    for name, p in sstate.model.named_parameters():
        dim = sstate.shardings.get(name)
        if dim is not None and p.grad is not None:
            sstate.stored[name].grad = p.grad.chunk(tp, dim)[
                sstate.cell[1]].clone()
    sstate.optimizer.step()
    if sstate.scheduler is not None:
        sstate.scheduler.step()
    sstate.step += 1
    with torch.no_grad():
        for name, p in sstate.model.named_parameters():
            dim = sstate.shardings.get(name)
            if dim is not None:
                p.copy_(_gather(sstate.stored[name], dim,
                                sstate.model_group, tp))
    return _sum(loss.detach().clone(), sstate.data_group) / dp
