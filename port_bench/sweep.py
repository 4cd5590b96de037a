"""The sweep that found a serving cell's knee (`knee_per_s` of its cell
file): one process, one pipeline and one batcher, and a window of
Poisson single-image requests at each rate in turn, driven by the cell's
loop (`loops/open.py`).

    python -m port_bench.sweep --workload <open-loop cell> --seed <n> \
        --seconds 10 --rates 60 90 120 150 180 210 240

Prints one JSON line a rate: offered and answered requests a second, the
latency p50 / p95 / p99 from the due time, the p95 of the window's first
and second halves (a backlog that grows shows as a second half far above
the first) and the batcher's rows a forward. Card only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from port_bench import bench, load, programs, run as run_mod


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    run_mod.set_cache_dirs()
    print(run_mod.card_line(), file=sys.stderr, flush=True)
    c = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    programs.enable_build_dir(run_mod.BUILD_DIR)
    program, loop = c.module("programs"), c.module("loops")
    det = c.config["detector"]
    pool, heights = load.render_pool(
        args.seed, c.mix["pool"], (det["input_height"], det["input_width"]))
    states = program.weights(c.config, args.seed, "cuda")
    pipe = program.pipeline(c.config, states, "cuda")
    loop.warm_up(program, pipe, pool, heights, c)
    for rate in args.rates:
        steady = dataclasses.replace(c, mix=dict(c.mix, x_knee=1.0),
                                     cell=dict(c.cell, knee_per_s=rate))
        state = run_mod.RunState(steady, 0.0)
        driven = loop.drive(program, pipe, state, pool, heights, steady,
                            args.seed, args.seconds, False)
        lat, late = state.latencies, state.late
        half = len(lat) // 2
        print(json.dumps({
            "rate": rate, "attempted": driven.attempted,
            "answered": len(lat),
            "answered_per_s": len(lat) / args.seconds,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "p95_first_half_ms": float(np.percentile(lat[:half], 95) * 1e3),
            "p95_second_half_ms": float(np.percentile(lat[half:], 95) * 1e3),
            "late_p99_ms": float(np.percentile(late, 99) * 1e3),
            "rows_per_forward": state.batcher["mean_batch_size"],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
