"""batcher.forward_p95_ms: 95th percentile of a batch's forward on a
batcher thread, from the runner's call to its return (prepare, upload,
issue and readback, with the other batch in flight beside it): the
batcher's `batcher_forward` stage over the window (`StageTimer`, no
profiler running)."""


def read(run):
    if run.mix["loop"] != "open" or "batcher_forward" not in run.stages:
        return None
    return run.stages["batcher_forward"]["p95_ms"]
