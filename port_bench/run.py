"""One run of one benchmark cell of the PyTorch / CUDA port:

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in `setup_s`, from the process's start): the build
directory `port_bench/.build/` (the program's kernel library and batcher
core are built there by the first run of a checkout and found by every
later one), the pool of seeded scenes, the weights, the system that the
configuration's "arch" names (`programs/<arch>.py`), and a warm-up of
every batch size the cell's traffic makes. Then the window: `--seconds`
of the cell's traffic, driven as its mix's "loop" says
(`loops/<loop>.py`) and timed by the host clock. With
`--trace 1` a traced slice of the same traffic follows the window under
`torch.profiler`, and the per-layer metrics are printed instead of the
end-to-end ones. Once the window has closed and the device's peak memory
has been read, the program is freed and the plain reference
(`reference/<arch>.py`) judges every answer that the timed path gave
(`judge`).

The last line of standard output is the result, a JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a CUDA device (or with fewer than the cell asks for), or with a
JAX module loaded once the window has closed, the run prints no result
and exits with 1.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

from port_bench import bench, load

BUILD_DIR = os.path.join(bench.ROOT, bench.PACKAGE, ".build")
BANNED = ("jax", "jaxlib", "flax", "human_body_proportion_estimation_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock)."""
    with open("/proc/self/stat") as fh:
        start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"unavailable ({e})"
    return "nvidia-smi: " + (out or "no answer")


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(BUILD_DIR, sub)


class RunState:
    """What the window recorded, as the per-layer readers see it."""

    def __init__(self, c: bench.Cell, image_flops: float):
        self.cell = c
        self.config, self.mix = c.config, c.mix
        self.image_flops = image_flops
        self.window_start = 0.0       # host clock (perf_counter)
        self.window_s = 0.0
        self.images = 0               # answered in the window
        # (start, end, rows run, pool indices, packed rows) a forward
        self.forwards: List[tuple] = []
        self.stages = {}              # StageTimer snapshot of the window
        self.batcher: Optional[dict] = None
        self.late = self.latencies = None   # open loop: [s] a request
        self.trace: Optional[dict] = None
        self.kernel_calls = {}        # kernel -> (bytes, ops, peak) a call


def run(c: bench.Cell, seed: int, seconds: float, trace: bool, device: str,
        program=None) -> dict:
    """Set-up, window and check of cell `c`; returns the result object.
    `program`: the module that builds the system under test (the cell's
    `programs/<arch>.py` unless a test hands in another)."""
    import torch

    from port_bench import judge, programs

    program = program or c.module("programs")
    loop, counts = c.module("loops"), c.module("counts")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    programs.enable_build_dir(BUILD_DIR)
    config, mix = c.config, c.mix
    det = config["detector"]
    parts, t = [f"imports {process_age_s():.3f}"], time.perf_counter()

    def part(name):
        nonlocal t
        now = time.perf_counter()
        parts.append(f"{name} {now - t:.3f}")
        t = now

    pool, heights = load.render_pool(
        seed, mix["pool"], (det["input_height"], det["input_width"]))
    part("scenes")
    states = program.weights(config, seed, device)
    part("weights")
    pipe = program.pipeline(config, states, device)
    part("program")
    state = RunState(c, counts.image_flops(config))
    loop.warm_up(program, pipe, pool, heights, c)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    part("warm-up")
    setup_s = process_age_s()
    log(f"setup_s {setup_s:.3f} ({', '.join(parts)} s)")

    handle = program.record_forwards(pipe, pool, state.forwards)
    driven = loop.drive(program, pipe, state, pool, heights, c, seed,
                        seconds, trace)
    handle.remove()
    metrics = dict(driven.metrics, setup_s=setup_s)
    state.kernel_calls = counts.serving_calls(config, driven.batch_size)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    name = torch.cuda.get_device_name(0) if on_card else "cpu"

    # the check: the program freed, the reference on the same device
    del pipe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = c.module("reference").Reference(config, states, device)
    answers = ref.answers(pool, heights, mix["threshold"])
    del ref
    numbers = loop.numbers(driven.answers, answers)
    numbers["missing"] = float(driven.missing)
    numbers["repeat_gap"] = judge.repeat_gap(
        [(f[3], f[2], f[4]) for f in state.forwards])
    log(f"reference check {time.perf_counter() - t:.3f} s, "
        f"{numbers['compared']} segments compared; not compared: cm_max "
        f"{numbers['cm_max']!r}, cm_mean {numbers['cm_mean']!r}")
    correct, checks = judge.verdict(numbers, c.cell["limits"])

    if trace:
        out_metrics = bench.read_per_layer(c, state)
    else:
        out_metrics = {m["name"]: {"value": metrics[m["name"]],
                                   "unit": m["unit"]}
                       for m in c.end_to_end}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(driven.attempted),
              "failed": int(driven.failed), "metrics": out_metrics,
              "device": dev}
    if trace and state.trace is not None:
        dev["busy_s"] = state.trace["busy_s"]
        dev["window_s"] = state.trace["window_s"]
        result["breakdown"] = state.trace["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        log(f"check {n} {v!r} limit {lim!r}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    log(card_line())
    c = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c.chips:
        log(f"needs {c.chips} CUDA device(s); "
            f"{torch.cuda.device_count()} available")
        return 1
    result = run(c, args.seed, args.seconds, bool(args.trace), "cuda")
    found = banned_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
