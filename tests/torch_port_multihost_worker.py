"""One process of the port's two-process lockstep serving test
(tests/test_torch_port_sharded_serving.py); torch and the port only.

Usage:
    python -m tests.torch_port_multihost_worker <process_id> \
        <num_processes> <port> <dir>

`<dir>/spec.pkl` holds the tiny pipeline's configuration and weights, the
artifact directory and a prepared batch. Joins a gloo group on localhost
and runs both phases in one process lifetime: (1) the live pipeline over
the global mesh (`make_multihost_pipeline`): the coordinator serves the
batch, writes `<dir>/live.npy` and sends the shutdown sentinel; (2) the
restored artifact (`make_multihost_artifact_serving`), two rows, into
`<dir>/art.npy`. Workers mirror each phase in `worker_loop`.
"""

import os
import pickle
import sys

import numpy as np
import torch


def main():
    pid, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    from human_body_proportion_estimation_tpu_torch.parallel import (
        multihost as mh,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        config_from_dict,
    )

    with open(os.path.join(out, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    mh.init_multihost(f"127.0.0.1:{port}", nproc, pid)

    pipe, serving = mh.make_multihost_pipeline(
        config=config_from_dict(spec["config"]),
        det_config=spec["det_config"], pose_config=spec["pose_config"],
        det_state=spec["det_state"] if pid == 0 else None,
        pose_state=spec["pose_state"] if pid == 0 else None,
        local_devices=["cpu"], dtype=torch.float32)
    assert serving.mesh.size == nproc
    if serving.is_coordinator:
        packed = serving.coordinator_step(*spec["batch"])
        serving.shutdown()
        np.save(os.path.join(out, "live.npy"), packed)
        print("coordinator live OK", flush=True)
    else:
        serving.worker_loop()
        print("worker live OK", flush=True)

    art, serving = mh.make_multihost_artifact_serving(
        spec["artifact_dir"], local_devices=["cpu"])
    if serving.is_coordinator:
        rows = art.batch_size * serving.mesh.size
        packed = serving.coordinator_step(*(a[:rows] for a in spec["batch"]))
        serving.shutdown()
        np.save(os.path.join(out, "art.npy"), packed)
        print("coordinator artifact OK", flush=True)
    else:
        serving.worker_loop()
        print("worker artifact OK", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
