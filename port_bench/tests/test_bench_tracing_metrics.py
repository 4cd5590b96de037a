"""The per-layer metrics read from the program's own spans and counters
(`StageTimer` snapshot of the un-profiled window): each returns its number
from a run carrying the stage, and None outside its loop or where the
program has no such stage (a program without these spans)."""

from __future__ import annotations

import pytest

from port_bench import bench, run

CLOSED = bench.cell("lite4_w32.batch16")
OPEN = bench.cell("lite4_w32.serve_open")


def stage(mean_ms, p95_ms):
    return {"count": 8, "mean_ms": mean_ms, "p50_ms": mean_ms,
            "p95_ms": p95_ms}


SNAPSHOT = {
    "host_prepare": stage(4.0, 5.0),
    "device_upload": stage(1.0, 1.5),
    "device_compute_readback": stage(90.0, 120.0),
    "device_issue": stage(70.0, 95.0),
    "device_readback": stage(19.0, 24.0),
    "batcher_slot_wait": stage(40.0, 180.0),
    "batcher_forward": stage(100.0, 210.0),
    "batcher_answer": stage(0.2, 0.4),
    "rows_real": {"count": 8, "total": 51},
    "rows_run": {"count": 8, "total": 68},
}

# metric -> (the cell whose loop it reads, its stage or counters, value)
METRICS = {
    "forward.issue_ms.batch": (CLOSED, ("device_issue",), 70.0),
    "forward.readback_ms.batch": (CLOSED, ("device_readback",), 19.0),
    "forward.issue_ms.serve": (OPEN, ("device_issue",), 70.0),
    "batcher.slot_wait_p95_ms": (OPEN, ("batcher_slot_wait",), 180.0),
    "batcher.forward_p95_ms": (OPEN, ("batcher_forward",), 210.0),
    "batcher.padded_rows_pct": (OPEN, ("rows_run", "rows_real"),
                                100.0 * 17 / 68),
}


def state(c, stages):
    s = run.RunState(c, 1.0)
    s.stages = stages
    return s


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reads_its_stage_in_its_loop(name):
    c, _, want = METRICS[name]
    got = bench.metric_reader(name)(state(c, dict(SNAPSHOT)))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_nothing_outside_its_loop(name):
    c, _, _ = METRICS[name]
    other = OPEN if c is CLOSED else CLOSED
    assert bench.metric_reader(name)(state(other, dict(SNAPSHOT))) is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_nothing_without_the_stage(name):
    """A program without the span or counter (the parent of the change
    that added them) gives nothing to read, and the reader does not
    raise."""
    c, keys, _ = METRICS[name]
    for key in keys:
        snap = {k: v for k, v in SNAPSHOT.items() if k != key}
        assert bench.metric_reader(name)(state(c, snap)) is None
    assert bench.metric_reader(name)(state(c, {})) is None


def test_no_padding_share_without_rows():
    snap = dict(SNAPSHOT, rows_run={"count": 0, "total": 0})
    assert bench.metric_reader("batcher.padded_rows_pct")(
        state(OPEN, snap)) is None


def test_each_metric_is_listed_for_its_cells():
    per_layer = {m["name"]: m for m in bench.benchmark()["per_layer"]}
    for name, (c, _, _) in METRICS.items():
        cells = per_layer[name]["workloads"]
        loop = c.mix["loop"]
        assert cells and all(bench.cell(w).mix["loop"] == loop
                             for w in cells), name


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.serve"])
def test_traced_run_reads_the_program_spans(tiny_root, cell):
    """The harness reads them from a short traced CPU run of the program
    (the tiny cells report what the cells of their loop report)."""
    c = bench.cell(cell, tiny_root)
    r = run.run(c, 2**31 + 9, 2.0, True, "cpu")
    mine = {n for n, (m, _, _) in METRICS.items()
            if m.mix["loop"] == c.mix["loop"]}
    assert mine <= set(r["metrics"]), r["metrics"]
    for n in mine:
        assert r["metrics"][n]["value"] >= 0
