"""batcher.rows_per_forward: requests the server's batcher put in one
forward, mean over the run (the native core's `mean_batch_size`)."""


def read(run):
    if run.batcher is None or not run.batcher.get("batches"):
        return None
    return float(run.batcher["mean_batch_size"])
