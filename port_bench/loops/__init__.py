"""Ways of driving the system under test. `loops/<loop>.py`, named by a
mix's "loop", gives:

    warm_up(program, pipe, pool, heights, c)
                    runs every shape the cell's traffic will use
    drive(program, pipe, state, pool, heights, c, seed, seconds, trace)
                    the measured window (and with `trace` a traced slice
                    after it); returns a `Driven`
    numbers(answers, ref)
                    the comparison of `Driven.answers` with the plain
                    reference's answers of the pool (`judge`)
    control_numbers(low, ref)
                    the same comparison for the control: the reference at
                    a lower precision answering in the program's place
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass
class Driven:
    metrics: Dict[str, float]   # the window's end-to-end metrics
    attempted: int
    failed: int
    answers: Any                # what `numbers` compares
    missing: int                # accepted requests whose answer never came
    batch_size: int             # the largest batch a forward ran


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)
