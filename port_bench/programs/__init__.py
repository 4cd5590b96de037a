"""The system under test. `programs/<arch>.py` builds one kind of system
from a configuration file whose "arch" names it:

    weights(config, seed, device)   {"det": state, "pose": state}: what
                                    both sides of the check are given
    pipeline(config, states, device)
                                    the port's pipeline, ready to serve
    serving_app(pipe)               the server's app over it (its batcher)
    record_forwards(pipe, pool, forwards)
                                    notes every forward of the window

This package is the only part of the benchmark that imports the measured
program, and it imports nothing else of the repository. The hooks below
are the program's own and serve every kind of system.
"""

from __future__ import annotations


def enable_build_dir(directory: str) -> str:
    """Point the program's builds (kernel library, batcher core) at
    `directory`, before the first build of the process."""
    from human_body_proportion_estimation_tpu_torch.utils import (
        compile_cache,
    )

    return compile_cache.enable(directory)


def stage_timer():
    from human_body_proportion_estimation_tpu_torch.utils.profiling import (
        StageTimer,
    )

    return StageTimer()
