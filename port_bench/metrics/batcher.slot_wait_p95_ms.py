"""batcher.slot_wait_p95_ms: 95th percentile of the time a formed batch
waited for one of the batcher's in-flight slots before its forward could
start: the batcher's `batcher_slot_wait` stage over the window
(`StageTimer`, no profiler running)."""


def read(run):
    if run.mix["loop"] != "open" or \
            "batcher_slot_wait" not in run.stages:
        return None
    return run.stages["batcher_slot_wait"]["p95_ms"]
