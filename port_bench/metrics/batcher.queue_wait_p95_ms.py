"""batcher.queue_wait_p95_ms: 95th percentile of the time a request waited
in the batcher's queue before its batch formed (the native core's
histogram, over the run)."""


def read(run):
    if run.batcher is None or not run.batcher.get("batches"):
        return None
    return float(run.batcher["queue_wait_ms_p95"])
