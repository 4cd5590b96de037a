"""forward.readback_ms.batch: milliseconds of the final copy of a
forward's packed rows to the host, once the serving program has returned,
in the closed-loop cells: whatever of the forward's device work is still
queued after its last synchronization, and the copy. The pipeline's
`device_readback` stage, mean over the window (`StageTimer`, no profiler
running)."""


def read(run):
    if run.mix["loop"] != "closed" or "device_readback" not in run.stages:
        return None
    return run.stages["device_readback"]["mean_ms"]
