"""`forward.graphed_pct.batch` / `.serve`: the share of the window's
forwards that replayed CUDA graphs, from the pipeline's counters
`forward_graphed` and `forward_eager` (a `StageTimer` snapshot): a
counter snapshot in, the share out; nothing outside the metric's loop or
where the program keeps neither counter (the parent of the change that
added them)."""

from __future__ import annotations

import pytest

from port_bench import bench, run

CLOSED = bench.cell("lite4_w32.batch16")
OPEN = bench.cell("lite4_w32.serve_open")
METRICS = {"forward.graphed_pct.batch": CLOSED,
           "forward.graphed_pct.serve": OPEN}


def state(c, stages):
    s = run.RunState(c, 1.0)
    s.stages = stages
    return s


def counters(graphed=None, eager=None):
    snap = {"device_issue": {"count": 8, "mean_ms": 1.0, "p50_ms": 1.0,
                             "p95_ms": 1.0},
            "rows_run": {"count": 8, "total": 64}}
    for name, n in (("forward_graphed", graphed), ("forward_eager", eager)):
        if n is not None:
            snap[name] = {"count": n, "total": n}
    return snap


@pytest.mark.parametrize("name", sorted(METRICS))
@pytest.mark.parametrize("graphed, eager, share", [
    (30, None, 100.0), (30, 0, 100.0), (3, 1, 75.0), (None, 5, 0.0),
    (0, 5, 0.0)])
def test_share_of_graphed_forwards(name, graphed, eager, share):
    read = bench.metric_reader(name)
    assert read(state(METRICS[name], counters(graphed, eager))) == \
        pytest.approx(share)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_nothing_without_the_counters_or_outside_the_loop(name):
    read = bench.metric_reader(name)
    c = METRICS[name]
    other = OPEN if c is CLOSED else CLOSED
    assert read(state(c, counters())) is None
    assert read(state(c, {})) is None
    assert read(state(c, counters(0, 0))) is None
    assert read(state(other, counters(30, 0))) is None


def test_each_share_is_listed_for_the_cells_of_its_loop():
    per_layer = {m["name"]: m for m in bench.benchmark()["per_layer"]}
    for name, c in METRICS.items():
        m = per_layer[name]
        assert m["source"] == "program_counter" and m["unit"] == "%"
        assert m["layer"] == "model step"
        cells = m["workloads"]
        assert cells and all(bench.cell(w).mix["loop"] == c.mix["loop"]
                             for w in cells), name
        assert m["moves"] == ("imgs_per_s" if c is CLOSED
                              else "latency_p95_ms")


def test_a_cpu_run_reads_every_forward_eager(tiny_root):
    """The program on the CPU replays no graph: a short traced run of the
    tiny closed-loop cell (per-layer metrics are read in traced runs)
    reads a share of 0. The open loop's snapshot is taken when its trace
    begins, which on the CPU may come before any forward has ended, so
    the serve share is held to its counters above only."""
    c = bench.cell("tiny.batch", tiny_root)
    r = run.run(c, 2**31 + 9, 2.0, True, "cpu")
    assert r["metrics"]["forward.graphed_pct.batch"]["value"] == 0.0
