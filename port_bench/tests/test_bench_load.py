"""The traffic generator: seeded schedules repeat exactly, offer the
stated rates, and give every seed the same set of gaps."""

from __future__ import annotations

import itertools
import os

import numpy as np
import pytest

from port_bench import bench, load

SEEDS = (3, 2**31 + 17)


def mix(name):
    return bench.read_json(os.path.join(bench.ROOT, bench.PACKAGE,
                                        "traffic", name + ".json"))


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_batches_repeat_and_cover_the_pool(seed):
    take = lambda s: list(itertools.islice(  # noqa: E731
        load.closed_batches(s, 64, 16), 12))
    a, b = take(seed), take(seed)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for k in range(0, 12, 4):        # every 4 batches of 16: the pool once
        assert sorted(np.concatenate(a[k:k + 4])) == list(range(64))
    assert not all(np.array_equal(x, y) for x, y in zip(a, take(seed + 1)))


@pytest.mark.parametrize("seed", SEEDS)
def test_open_schedule_repeats_at_the_stated_rate(seed):
    m, knee, seconds = mix("serve_open"), 150.0, 20.0
    rate = m["x_knee"] * knee
    sched = lambda s: load.open_schedule(  # noqa: E731
        s, rate, m["block_seconds"], seconds, 64)
    due, which = sched(seed)
    due2, which2 = sched(seed)
    assert np.array_equal(due, due2) and np.array_equal(which, which2)
    assert abs(len(due) / seconds - rate) <= 1.0
    assert np.all(np.diff(due) > 0) and due[0] >= 0 and due[-1] < seconds
    assert which.min() >= 0 and which.max() < 64
    other, _ = sched(seed + 1)
    assert len(other) == len(due) and not np.array_equal(other, due)
    # every block of block_seconds holds its share of the arrivals
    blocks = np.bincount((due // m["block_seconds"]).astype(int))
    assert np.all(blocks == round(rate * m["block_seconds"]))


def test_every_seed_gets_the_same_gaps_in_another_order():
    a = load.block_gaps(120.0, 1.0, load.rng(SEEDS[0], 2))
    b = load.block_gaps(120.0, 1.0, load.rng(SEEDS[1], 2))
    assert len(a) == 120 and not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert a.sum() == pytest.approx(1.0)


def test_pool_is_seeded():
    a, ha = load.render_pool(SEEDS[1], 2, (480, 640))
    b, hb = load.render_pool(SEEDS[1], 2, (480, 640))
    assert a.shape == (2, 480, 640, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and np.array_equal(ha, hb)
    assert np.all((ha >= 150) & (ha <= 200))
