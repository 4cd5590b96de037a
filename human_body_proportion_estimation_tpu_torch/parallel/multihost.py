"""Lockstep serving of one pipeline over several processes (port of the
JAX package's `parallel/multihost.py`).

Every process runs the same program in lockstep over `torch.distributed`:

- process 0 owns the HTTP / gRPC edge and the batcher, and prepares each
  batch on the host;
- each step, process 0 broadcasts the prepared uint8 batch with its
  thresholds, heights and original sizes; every process runs its
  contiguous shard of the global batch on its own device(s); the packed
  [B, P, 23] rows are all-gathered, so every process holds the answer;
- workers sit in `worker_loop`, which is the same broadcast / run /
  gather with no edge; a zero-row batch is the shutdown sentinel.

The host-side tensors travel over a gloo group (CPU tensors), which works
on the CPU and for two processes sharing one card, where NCCL refuses two
ranks on one device. `init_multihost` joins the default group over TCP
(`tcp://host:port`) or from the environment (`env://`); give it the
address, world size and rank explicitly, nothing discovers a cluster.

Failure model, as in JAX: if a process dies mid-collective the others'
next collective fails or hangs until the group's timeout; nothing here
recovers. For elastic serving, run independent single-process replicas
behind a load balancer instead.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
)


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the default (gloo) process group: over TCP at
    `coordinator_address` ("host:port") as rank `process_id` of
    `num_processes`, or, with no address, from the `env://` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). Call once per process,
    before any collective."""
    if coordinator_address is None:
        dist.init_process_group("gloo", init_method="env://")
    else:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)


def _local_devices(local_devices: Optional[Sequence]) -> list:
    """This process's devices: the given ones, else its current CUDA
    device (raises when there is none; the CPU only when asked for)."""
    if local_devices:
        return [torch.device(d) for d in local_devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible to this process; pass "
                           "local_devices=['cpu'] to serve on the CPU")
    return [torch.device("cuda", torch.cuda.current_device())]


def global_data_mesh(local_devices: Optional[Sequence] = None) -> Mesh:
    """A 'data' mesh over every process's devices, grouped by process:
    shard i of a global batch is process i // L's local shard i % L (L
    local devices each, the same count in every process), so the only
    traffic between processes is the batch broadcast and the row gather.
    Entries of other processes name their device as seen from there
    (this process's device list, by the same-count contract)."""
    local = _local_devices(local_devices)
    return make_mesh(devices=local * dist.get_world_size())


def replicate_to_global(state):
    """A state_dict (or any picklable value) made the same in every
    process: process 0's copy, broadcast. JAX's contract is that every
    process already holds the same values (same seed or the same
    checkpoint); this makes it so."""
    box = [state if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class MultiHostServing:
    """Lockstep executor of one serving program over the processes of the
    default group.

    `program(batch, thresholds, heights, orig_hw)` takes this process's
    contiguous rows of a prepared host batch (`pipeline.host.
    prepare_batch` arrays) and returns their packed [rows, P, 23] numpy
    rows (`InferencePipeline.serving_rows` over the process's own mesh,
    `ServingArtifact.__call__`). The global batch must be a multiple of
    the mesh size; process 0 prepares full batches."""

    def __init__(self, mesh: Mesh, program: Callable, max_batch: int,
                 max_persons: int = 3):
        self.mesh = mesh
        self.program = program
        self.max_batch = max_batch
        self.max_persons = max_persons
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        if mesh.size % self.world:
            raise ValueError(f"a mesh of {mesh.size} devices does not "
                             f"split over {self.world} processes")
        # meet before any heavy first call, so that a slow first forward
        # in one process does not eat another's collective deadline
        dist.barrier()

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def _broadcast(self, *arrays: np.ndarray) -> list:
        out = []
        for a in arrays:
            t = torch.from_numpy(np.array(a))   # a writable copy
            dist.broadcast(t, src=0)
            out.append(t.numpy())
        return out

    def step(self, batch, thresholds, heights, orig_hw) -> np.ndarray:
        """One lockstep step over the global batch (process 0's data
        reaches the rest by broadcast); every process gets every row."""
        arrays = self._broadcast(batch, thresholds, heights, orig_hw)
        b = arrays[0].shape[0]
        if b % self.world:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{self.world} processes")
        per = b // self.world
        lo = self.rank * per
        local = torch.from_numpy(np.ascontiguousarray(self.program(
            *(a[lo:lo + per] for a in arrays)), np.float32))
        rows = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(rows, local)
        return torch.cat(rows).numpy()

    def worker_loop(self) -> None:
        """A non-coordinator process: mirror every coordinator step until
        the zero-row sentinel arrives."""
        assert not self.is_coordinator
        while True:
            shape = self._broadcast(np.zeros(4, np.int64))[0]
            b, h, w, _ = (int(x) for x in shape)
            if b == 0:
                return
            self.step(
                np.zeros((b, h, w, 3), np.uint8),
                np.zeros((b,), np.float32),
                np.zeros((b, self.max_persons), np.float32),
                np.ones((b, 2), np.float32),
            )

    def coordinator_step(self, batch, thresholds, heights,
                         orig_hw) -> np.ndarray:
        """Process 0's step: announce the batch shape (the workers
        allocate matching buffers that the broadcast fills), then step."""
        assert self.is_coordinator
        self._broadcast(np.asarray(batch.shape, np.int64))
        return self.step(batch, thresholds, heights, orig_hw)

    def shutdown(self) -> None:
        """Release the workers (the zero-row sentinel)."""
        if self.is_coordinator:
            self._broadcast(np.zeros(4, np.int64))


def make_multihost_pipeline(
    config=None, det_config=None, det_state=None, pose_state=None,
    detector: Optional[str] = None, local_devices: Optional[Sequence] = None,
    dtype: torch.dtype = torch.bfloat16, pose_config=None,
):
    """(InferencePipeline over this process's devices, MultiHostServing
    over the global mesh). Every process calls it with the same
    arguments; given states are process 0's in every process
    (`replicate_to_global`), and a slot given none loads the same
    checkpoint or seeded init everywhere."""
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )

    local = _local_devices(local_devices)
    pipe = InferencePipeline(
        config=config, det_config=det_config,
        det_state=replicate_to_global(det_state),
        pose_state=replicate_to_global(pose_state), detector=detector,
        dtype=dtype, pose_config=pose_config,
        mesh=make_mesh(devices=local))
    serving = MultiHostServing(
        global_data_mesh(local), pipe.serving_rows,
        max_batch=pipe.config.serve.max_batch,
        max_persons=pipe.config.detector.max_persons)
    return pipe, serving


def make_multihost_artifact_serving(directory: str,
                                    local_devices: Optional[Sequence] = None):
    """Restore a serving artifact (`pipeline/export.py`) on this process's
    devices and serve it lockstep over the global mesh. Every process must
    see the same artifact directory. The global batch of a step is
    `batch_size` x the mesh size. Returns (ServingArtifact,
    MultiHostServing)."""
    from human_body_proportion_estimation_tpu_torch.pipeline.export import (
        ServingArtifact,
    )

    local = _local_devices(local_devices)
    art = ServingArtifact(directory, mesh=make_mesh(devices=local))
    mesh = global_data_mesh(local)
    serving = MultiHostServing(
        mesh, art, max_batch=art.batch_size * mesh.size,
        max_persons=art.meta["max_persons"])
    return art, serving
