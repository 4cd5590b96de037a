"""The one traffic generator: every mix is a data file of `traffic/` that
this module reads.

A mix says how requests are made; the cell adds the rate where the mix
is open (`knee_per_s`: the sweep's highest sustained rate, of which the
mix offers a share `x_knee`). Everything is drawn from the run's seed:
the pool of scenes (`pool` one-person scenes at the detector's size), the
order in which a closed loop takes them, and an open loop's arrivals.

Open loop: blocks of `block_seconds` follow one another until the window
and the traced slice after it are covered. A block at rate r holds n =
round(r * block_seconds) arrivals whose gaps are the n quantiles
(i + 1/2) / n of the exponential distribution of mean 1 / r, scaled to
fill the block and put in an order drawn from the seed: every seed
offers the same set of gaps, so the same work, in another order.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from port_bench import scenes


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run (0 pool, 1 order, 2 arrivals,
    3 scene of each arrival)."""
    return np.random.default_rng([int(seed), stream])


def render_pool(seed: int, n: int, hw: Tuple[int, int]):
    """(images uint8 [n, H, W, 3], heights cm [n]): n seeded scenes."""
    r = rng(seed, 0)
    made = [scenes.generate_scene(r, img_hw=hw) for _ in range(n)]
    return (np.stack([s.image for s in made]),
            np.array([s.height_cm for s in made], np.float64))


def closed_batches(seed: int, pool: int, batch: int
                   ) -> Iterator[np.ndarray]:
    """Batches of pool indices without end: the pool in seeded orders, one
    permutation after another, cut into batches."""
    r = rng(seed, 1)
    order = np.zeros(0, np.int64)
    while True:
        while len(order) < batch:
            order = np.concatenate([order, r.permutation(pool)])
        yield order[:batch]
        order = order[batch:]


def block_gaps(rate: float, seconds: float, r: np.random.Generator
               ) -> np.ndarray:
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    return r.permutation(gaps * (seconds / gaps.sum()))


def open_schedule(seed: int, rate: float, block_seconds: float,
                  seconds: float, pool: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(due times in seconds from the window's start [n], pool index of
    each request [n]) for every arrival at `rate` a second due before
    `seconds`."""
    r = rng(seed, 2)
    due, t = [], 0.0
    while t < seconds:
        gaps = block_gaps(rate, block_seconds, r)
        due.append(t + np.concatenate([[0.0], np.cumsum(gaps[:-1])]))
        t += block_seconds
    due = np.concatenate(due)
    due = due[due < seconds]
    return due, rng(seed, 3).integers(0, pool, len(due))
