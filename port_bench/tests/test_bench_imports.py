"""Nothing the harness runs loads JAX, flax or the JAX package: the
check compares whole top-level module names (the port's own name begins
with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys

from port_bench import bench, run

PROGRAM = """
import json, sys
from port_bench import bench, judge, load, programs, readings, run, sweep
from port_bench.reference import models, segments, weights
for w in bench.benchmark()["workloads"]:
    c = bench.cell(w["name"])
    for kind in ("programs", "reference", "counts", "loops"):
        c.module(kind)
import human_body_proportion_estimation_tpu_torch.pipeline.host
import human_body_proportion_estimation_tpu_torch.serve.server
import human_body_proportion_estimation_tpu_torch.utils.compile_cache
import human_body_proportion_estimation_tpu_torch.utils.profiling
for m in bench.benchmark()["per_layer"]:
    bench.metric_reader(m["name"])
print(json.dumps(run.banned_modules()))
"""


def test_harness_and_program_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROGRAM], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_free", sys)
    monkeypatch.setitem(sys.modules, "human_body_proportion_estimation_"
                        "tpu_torch_extra", sys)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    monkeypatch.setitem(sys.modules,
                        "human_body_proportion_estimation_tpu.ops", sys)
    assert run.banned_modules() == ["flax",
                                    "human_body_proportion_estimation_tpu"]
