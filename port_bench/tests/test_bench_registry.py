"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric is found by its name, a new one is added as new files, and the
file keeps to the format that BENCHMARK.json must have."""

from __future__ import annotations

import json
import os
import re

import pytest

from port_bench import bench, run
from port_bench.tests.conftest import HERE, TINY_LIMITS, add_cell, \
    copy_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_workload_resolves():
    spec = bench.benchmark()
    for w in spec["workloads"]:
        c = bench.cell(w["name"])
        assert c.config["name"] == w["config"]
        for kind in ("programs", "reference", "counts", "loops"):
            assert c.module(kind) is c.module(kind)
        assert c.end_to_end and c.per_layer
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        if c.mix["loop"] == "open":
            assert c.cell["knee_per_s"] > 0
        for m in c.per_layer:
            assert callable(bench.metric_reader(m["name"]))


def test_benchmark_file_format():
    spec = bench.benchmark()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert spec["paths"] == ["port_bench"]
    names = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[kind]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names.get(kind, set())
            names.setdefault(kind, set()).add(e["name"])
    for c in spec["configs"]:
        assert c["file"].startswith("port_bench/")
        assert os.path.exists(os.path.join(bench.ROOT, c["file"]))
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", names["workloads"]):
            assert bench.reports(moved, w), (m["name"], w)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert any(bench.reports(m, w["name"]) for m in spec["per_layer"])
        assert len([m for m in spec["end_to_end"]
                    if bench.reports(m, w["name"])]) >= 2
    assert len(json.dumps(spec)) < 64 * 1024


def test_new_cell_config_mix_and_metric_as_new_files(tmp_path):
    root = copy_benchmark(str(tmp_path))
    here = os.path.join(root, bench.PACKAGE)
    with open(os.path.join(here, "configs", "lite4_w32.json")) as fh:
        config = json.load(fh)
    config["name"] = "lite4_w32_640"
    config["detector"]["input_height"] = 640
    with open(os.path.join(here, "configs", "lite4_w32_640.json"),
              "w") as fh:
        json.dump(config, fh)
    add_cell(root, "lite4_w32_640.batch8", "lite4_w32_640", "batch8",
             mix={"loop": "closed", "callers": 1, "batch": 8, "pool": 32,
                  "threshold": 0.7, "trace_seconds": 2.0},
             cell={"limits": {"cm_max": 1}},
             config_file="port_bench/configs/lite4_w32_640.json")
    with open(os.path.join(here, "metrics", "pool.images.py"), "w") as fh:
        fh.write("def read(run):\n    return float(run.mix['pool'])\n")
    spec = bench.benchmark(root)
    spec["per_layer"].append({
        "name": "pool.images", "unit": "imgs", "better": "higher",
        "source": "program_counter", "layer": "pipeline host",
        "moves": "imgs_per_s", "workloads": ["lite4_w32_640.batch8"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)

    c = bench.cell("lite4_w32_640.batch8", root)
    assert c.config["detector"]["input_height"] == 640
    assert c.mix["batch"] == 8 and c.root == root

    class Seen:
        mix, trace, batcher, stages = c.mix, None, None, {}
        images = 0

    got = bench.read_per_layer(c, Seen())
    assert got == {"pool.images": {"value": 32.0, "unit": "imgs"}}
    # the cells already there are found as before
    assert bench.cell("lite4_w32.batch16", root).mix["batch"] == 16


def write(path: str, text: str) -> None:
    with open(path, "w") as fh:
        fh.write(text)


def test_new_arch_and_loop_as_new_files(tmp_path):
    """A kind of system (`programs/`, `reference/`, `counts/` files named
    by a configuration's "arch") and a way of driving it (a `loops/` file
    named by a mix's "loop"), added as new files, run end to end."""
    root = copy_benchmark(str(tmp_path))
    here = os.path.join(root, bench.PACKAGE)
    for kind in ("programs", "reference", "counts"):
        write(os.path.join(here, kind, "other_arch.py"),
              f"from port_bench.{kind}.edet_lite_hrnet import *  # noqa\n")
    write(os.path.join(here, "loops", "closed_counted.py"),
          "from port_bench.loops import closed\n"
          "from port_bench.loops.closed import *  # noqa\n"
          "DRIVEN = []\n\n\n"
          "def drive(*args):\n"
          "    DRIVEN.append(args[-1])\n"
          "    return closed.drive(*args)\n")
    config = bench.read_json(os.path.join(HERE, "data", "tiny.json"))
    config.update(name="other", arch="other_arch")
    with open(os.path.join(here, "configs", "other.json"), "w") as fh:
        json.dump(config, fh)
    add_cell(root, "other.counted", "other", "counted",
             mix={"loop": "closed_counted", "callers": 1, "batch": 2,
                  "pool": 4, "threshold": 0.70, "trace_seconds": 1.0},
             cell={"limits": TINY_LIMITS},
             config_file="port_bench/configs/other.json", like="batch16")
    c = bench.cell("other.counted", root)
    assert c.module("programs").__name__ != \
        bench.cell("lite4_w32.batch16", root).module("programs").__name__
    r = run.run(c, 2**31 + 3, 1.0, False, "cpu")
    assert r["correct"] is True, r["checks"]
    assert c.module("loops").DRIVEN == [False]


def test_cell_file_must_agree_with_benchmark(tmp_path):
    root = copy_benchmark(str(tmp_path))
    path = os.path.join(root, bench.PACKAGE, "cells",
                        "lite4_w48.batch16.json")
    with open(path) as fh:
        own = json.load(fh)
    own["config"] = "lite4_w32"
    with open(path, "w") as fh:
        json.dump(own, fh)
    with pytest.raises(ValueError, match="config"):
        bench.cell("lite4_w48.batch16", root)
    with pytest.raises(KeyError):
        bench.cell("no_such.cell", root)
