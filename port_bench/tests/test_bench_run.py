"""The harness driven end to end on the CPU (the look for a card skipped):
the result line's keys, the traced run's per-layer metrics, and the check
coming out false when the timed path is broken underneath."""

from __future__ import annotations

import types

import numpy as np
import pytest

from port_bench import bench, run

REAL = bench.load_file("programs", "edet_lite_hrnet")


def broken_program(fault: str):
    """The cell's program with the served rows broken where they are
    produced: "half" leaves out the second half of every batch (its rows
    repeat the first half's); "zeroed" answers the second half of every
    batch with no person; "empty" answers every other image with no
    person; "hidden" hides every segment of every other image's persons;
    "alter" gives one answer (the first of the fourth forward, warm-up
    included) the answer to the last request of its batch; "alter_all"
    makes the first answer of every forward half as long again."""
    fake = types.SimpleNamespace(**{k: getattr(REAL, k) for k in (
        "weights", "serving_app", "record_forwards")})
    calls, images = [], []

    def pipeline(config, states, device):
        pipe = REAL.pipeline(config, states, device)
        plain = pipe.infer_serving

        def infer_serving(images_, person_heights, det_threshold):
            if fault == "half" and len(images_) > 1:
                half = len(images_) // 2
                rows = plain(images_[:half], person_heights[:half],
                             det_threshold)
                return np.concatenate([rows, rows])[:len(images_)]
            rows = plain(images_, person_heights, det_threshold).copy()
            calls.append(1)
            every_other = (len(images) + np.arange(len(rows))) % 2 == 1
            images.extend(range(len(rows)))
            if fault == "zeroed":
                rows[len(rows) // 2 + len(rows) % 2:] = 0.0
            elif fault == "empty":
                rows[every_other] = 0.0
            elif fault == "hidden":
                rows[every_other, :, 1:] = 0.0
            elif fault == "alter" and len(calls) == 4:
                rows[0] = rows[-1]
            elif fault == "alter_all":
                rows[0, :, 1:12] *= 1.5
            return rows

        pipe.infer_serving = infer_serving
        return pipe

    fake.pipeline = pipeline
    return fake


def test_result_line(tiny_root):
    c = bench.cell("tiny.batch", tiny_root)
    r = run.run(c, 2**31 + 5, 1.0, False, "cpu")
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"imgs_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert list(r["checks"]) == ["valid_flip_share", "vis_flip_share",
                                 "cm_median", "repeat_gap", "missing"]
    assert r["attempted"] >= 2 and r["metrics"]["imgs_per_s"]["value"] > 0


@pytest.mark.parametrize("cell,expected", [
    ("tiny.batch", {"mfu.batch", "host.prepare_ms.batch",
                    "forward.host_ms.batch"}),
    ("tiny.serve", {"mfu.serve", "host.prepare_ms.serve",
                    "batcher.rows_per_forward",
                    "batcher.queue_wait_p95_ms"}),
])
def test_traced_run_reads_per_layer_metrics(tiny_root, cell, expected):
    c = bench.cell(cell, tiny_root)
    r = run.run(c, 11, 2.0, True, "cpu")
    assert r["correct"] is True
    assert set(r["metrics"]) <= {m["name"] for m in c.per_layer}
    # no device on the CPU: what only the card's trace gives is left out,
    # never reported as 0
    assert expected <= set(r["metrics"])
    assert not any(k.endswith("_roofline") for k in r["metrics"])
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_open_loop_run(tiny_root):
    c = bench.cell("tiny.serve", tiny_root)
    r = run.run(c, 2**31 + 6, 2.0, False, "cpu")
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"latency_p50_ms", "latency_p95_ms",
                                 "setup_s"}
    assert r["attempted"] == 4


@pytest.mark.parametrize("cell,fault,caught_by", [
    ("tiny.batch", "half", "repeat_gap"),
    ("tiny.batch", "zeroed", "valid_flip_share"),
    ("tiny.batch", "hidden", "vis_flip_share"),
    ("tiny.batch", "alter", "repeat_gap"),
    ("tiny.serve", "empty", "valid_flip_share"),
    ("tiny.serve", "hidden", "vis_flip_share"),
    ("tiny.serve", "alter_all", "cm_median"),
])
def test_broken_timed_path_is_not_correct(tiny_root, cell, fault,
                                          caught_by):
    c = bench.cell(cell, tiny_root)
    r = run.run(c, 2**31 + 7, 5.0, False, "cpu",
                program=broken_program(fault))
    assert r["correct"] is False, r["checks"]
    check = r["checks"][caught_by]
    assert check["value"] > check["limit"], r["checks"]


def test_main_needs_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", "lite4_w32.batch16", "--seed", "1",
                     "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""
