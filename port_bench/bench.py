"""Finding a cell's parts by name: `BENCHMARK.json` at the root of the
checkout names every configuration, cell and metric; each has a file of
its own under `port_bench/`, found by that name.

    configs/<config>.json    sizes, weights, precision (the entry's "file")
                             and "arch", the kind of system they describe
    traffic/<traffic>.json   a mix's parameters, read by `load`, and
                             "loop", the way its requests are driven
    cells/<workload>.json    the cell's config and traffic (checked against
                             BENCHMARK.json), its rate where the mix is
                             open, and the limits of its correctness check
    metrics/<metric>.py      a per-layer metric's reader: `read(run)`
                             returns the number, or None where it finds
                             nothing to read

and, by a configuration's "arch" or a mix's "loop":

    programs/<arch>.py       builds the system under test from the
                             configuration (the only files that import the
                             measured program)
    reference/<arch>.py      its plain reference (`Reference`)
    counts/<arch>.py         its model FLOPs and its kernels' work
    loops/<loop>.py          `warm_up`, `drive` (the measured window) and
                             `numbers` (the comparison of what it answered)

A later change adds a cell, a configuration, a mix, a kind of system, a
way of driving it or a metric by adding files and entries, and edits
none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "port_bench"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    cell: dict
    end_to_end: List[dict]      # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    chips: int
    root: str                   # the checkout the cell was found in

    def module(self, kind: str):
        """This cell's file of `kind`: `loops/` by its mix's "loop";
        `programs/`, `reference/` and `counts/` by its configuration's
        "arch"."""
        name = self.mix["loop"] if kind == "loops" else self.config["arch"]
        return load_file(kind, name, self.root)


def read_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    spec = benchmark(root)
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(os.path.join(root, configs[entry["config"]]["file"]))
    here = os.path.join(root, PACKAGE)
    mix = read_json(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    own = read_json(os.path.join(here, "cells", name + ".json"))
    for key in ("config", "traffic"):
        if own[key] != entry[key]:
            raise ValueError(f"cells/{name}.json: {key} {own[key]!r} is not "
                             f"BENCHMARK.json's {entry[key]!r}")
    return Cell(name, config, mix, own,
                [m for m in spec["end_to_end"] if reports(m, name)],
                [m for m in spec["per_layer"] if reports(m, name)],
                entry["chips"], root)


def load_file(kind: str, name: str, root: str = ROOT):
    """The module `port_bench/<kind>/<name>.py` of the checkout at `root`
    (loaded once a process)."""
    key = f"{PACKAGE}_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}_" \
        f"{abs(hash(root))}"
    if key not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(root, PACKAGE, kind, name + ".py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
        _LOADED[key] = module
    return _LOADED[key]


_LOADED: Dict[str, object] = {}


def metric_reader(name: str, root: str = ROOT) -> Callable:
    """`read(run)` of `metrics/<name>.py`."""
    return load_file("metrics", name, root).read


def read_per_layer(c: Cell, run) -> Dict[str, dict]:
    """The per-layer metrics of cell `c` that find something in `run`."""
    out = {}
    for m in c.per_layer:
        value = metric_reader(m["name"], c.root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
