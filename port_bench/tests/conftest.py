"""Fixtures of the benchmark's own tests (`python -m pytest port_bench/tests`).

Tests marked `card` need a CUDA device: the `card` fixture skips them
where there is none (decided at run time, never at import). The CPU
tests drive the harness on `data/tiny.json`: the certified Lite4 + W32 at
the detector's size, pose crops of 256x192, float32 trunks, buckets up to
4, in a copy of the benchmark with cells of its own added as new files.
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

from port_bench import bench

HERE = os.path.dirname(os.path.abspath(__file__))
# float32 on both sides: the same arithmetic, so lengths may not differ;
# the shares of flipped slots and segments are held to the cells' limits
TINY_LIMITS = dict(bench.cell("lite4_w32.batch16").cell["limits"],
                   cm_median=1e-3)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: runs on the card")


def copy_benchmark(dest: str) -> str:
    """A copy of BENCHMARK.json and port_bench/ (without its build
    directory) under `dest`; returns `dest`."""
    shutil.copytree(os.path.join(bench.ROOT, bench.PACKAGE),
                    os.path.join(dest, bench.PACKAGE),
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    shutil.copy(os.path.join(bench.ROOT, "BENCHMARK.json"), dest)
    return dest


def add_cell(root: str, name: str, config: str, traffic: str, mix=None,
             cell=None, config_file=None, like=None) -> None:
    """Add a cell (and, where given, its mix and configuration) to the
    copy at `root` as new files and BENCHMARK.json entries; it reports
    the metrics of the cells whose name ends in `like` (by default those
    of its loop's kind: "batch16" closed, "serve_open" open)."""
    here = os.path.join(root, bench.PACKAGE)
    spec = bench.benchmark(root)
    if config_file is not None:
        spec["configs"].append({"name": config, "source": "test",
                                "file": config_file, "reduced": [],
                                "why": "test"})
    if mix is not None:
        with open(os.path.join(here, "traffic", traffic + ".json"),
                  "w") as fh:
            json.dump(mix, fh)
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1,
                              "why": "test"})
    if like is None:
        loop = (mix or bench.read_json(os.path.join(
            here, "traffic", traffic + ".json")))["loop"]
        like = "batch16" if loop == "closed" else "serve_open"
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and any(w.endswith(like)
                                    for w in m["workloads"]):
            m["workloads"].append(name)
    with open(os.path.join(here, "cells", name + ".json"), "w") as fh:
        json.dump(dict(cell or {}, config=config, traffic=traffic), fh)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with two tiny cells: `tiny.batch`
    (closed loop, 2 images a forward) and `tiny.serve` (open loop, 2
    requests a second), on a pool of 4 scenes."""
    root = copy_benchmark(str(tmp_path_factory.mktemp("bench")))
    shutil.copy(os.path.join(HERE, "data", "tiny.json"),
                os.path.join(root, bench.PACKAGE, "configs", "tiny.json"))
    add_cell(root, "tiny.batch", "tiny", "tiny_batch",
             mix={"loop": "closed", "callers": 1, "batch": 2, "pool": 4,
                  "threshold": 0.70, "trace_seconds": 1.0},
             cell={"limits": TINY_LIMITS},
             config_file="port_bench/configs/tiny.json")
    add_cell(root, "tiny.serve", "tiny", "tiny_serve",
             mix={"loop": "open", "pool": 4, "threshold": 0.70,
                  "trace_seconds": 1.0, "x_knee": 1.0,
                  "block_seconds": 1.0},
             cell={"knee_per_s": 2.0, "limits": TINY_LIMITS})
    return root
