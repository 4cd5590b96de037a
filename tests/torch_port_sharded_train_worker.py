"""One process of the port's sharded train-step test
(tests/test_torch_port_sharded_train.py); torch and the port only.

Usage:
    python -m tests.torch_port_sharded_train_worker <rank> <world> \
        <model_parallel> <port> <dir> <case> [<case> ...]

Joins a gloo group of `world` processes on localhost, builds the
("data", "model") mesh of `world` CPU entries with `model_parallel`
columns, and runs each case of tests/torch_port_sharded_train.py with the
sharded step (`<dir>/det_config.pkl` holds the tiny EfficientDet's port
configuration). A case named "<kind>_per_shard_bn" is the planted fault:
BatchNorm takes each shard's own statistics (what plain
DistributedDataParallel does). Rank 0 writes `<dir>/<case>.pt` (the
losses, the first step's gradients, the final state, and the shapes each
rank stores).
"""

import contextlib
import os
import pickle
import sys

import torch
import torch.distributed as dist


def main():
    rank, world, tp, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4], sys.argv[5])
    cases = sys.argv[6:]
    torch.set_num_threads(1)
    from human_body_proportion_estimation_tpu_torch.parallel import (
        multihost as mh,
    )
    from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from human_body_proportion_estimation_tpu_torch.training import sharded
    from tests import torch_port_sharded_train as cases_lib

    with open(os.path.join(out, "det_config.pkl"), "rb") as f:
        det_config = pickle.load(f)
    mh.init_multihost(f"127.0.0.1:{port}", world, rank)
    mesh = make_mesh(devices=["cpu"] * world, model_parallel=tp)
    for case in cases:
        kind = case.split("_")[0]
        fault = case.endswith("_per_shard_bn")
        real = sharded.ShardedTrainState.batch_statistics
        if fault:
            sharded.ShardedTrainState.batch_statistics = (
                lambda self: contextlib.nullcontext())
        try:
            state, batch = cases_lib.build(kind, det_config)
            step, sstate = cases_lib.sharded_step(kind, state, mesh)
            result = cases_lib.run(kind, sstate, batch, step)
        finally:
            sharded.ShardedTrainState.batch_statistics = real
        shapes = [None] * world
        dist.all_gather_object(shapes, {k: tuple(v.shape)
                                        for k, v in sstate.stored.items()})
        result["stored_shapes"] = shapes
        result["shardings"] = sstate.shardings
        if rank == 0:
            torch.save(result, os.path.join(out, f"{case}.pt"))
        print(f"rank {rank} {case} OK", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
