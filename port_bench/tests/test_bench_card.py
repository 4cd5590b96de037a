"""The control of the correctness check: the plain reference with its
trunk convolutions in float8 (the precision below the configurations'
bfloat16) fails the cells' limits, where the program passes them.

On the CPU at a size a test run holds (`data/tiny.json`); on the card at
the cells' own size (marked `card`), three seeds each."""

from __future__ import annotations

import os

import numpy as np
import pytest

from port_bench import bench, judge, load
from port_bench.tests.conftest import HERE


def control_numbers(c, config, seed, pool_size, device):
    """The numbers of cell `c`'s check with the control answering in the
    program's place, on `config` (the cell's own, or a smaller one)."""
    det = config["detector"]
    pool, heights = load.render_pool(
        seed, pool_size, (det["input_height"], det["input_width"]))
    states = c.module("programs").weights(config, seed, device)
    answers = {}
    for precision in (None, "fp8"):
        ref = c.module("reference").Reference(config, states, device,
                                              precision)
        answers[precision] = ref.answers(pool, heights, 0.70)
    numbers = c.module("loops").control_numbers(answers["fp8"],
                                                answers[None])
    # the control is the reference itself: nothing repeats or goes missing
    return dict(numbers, repeat_gap=0.0, missing=0.0)


CELLS = ["lite4_w32.batch16", "lite4_w32.serve_open", "lite4_w48.batch16"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_a_test_size(cell):
    c = bench.cell(cell)
    config = bench.read_json(os.path.join(HERE, "data", "tiny.json"))
    numbers = control_numbers(c, config, 2**31 + 9, 4, "cpu")
    assert not judge.verdict(numbers, c.cell["limits"])[0], numbers


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22, 2**31 + 23])
def test_control_fails_at_the_cell_size(card, cell, seed):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = bench.cell(cell)
    numbers = control_numbers(c, c.config, seed, c.mix["pool"], "cuda")
    assert numbers["compared"] > 0
    assert not judge.verdict(numbers, c.cell["limits"])[0], numbers
    assert np.isfinite(numbers["cm_mean"])
