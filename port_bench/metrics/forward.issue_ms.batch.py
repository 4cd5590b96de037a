"""forward.issue_ms.batch: milliseconds of the serving program's call, up
to its return, in the closed-loop cells: the host's issue of the forward
plus its waits for the card at the synchronizations inside the forward
(host values copied to the card), not host time alone. The pipeline's
`device_issue` stage, mean over the window (`StageTimer`, no profiler
running)."""


def read(run):
    if run.mix["loop"] != "closed" or "device_issue" not in run.stages:
        return None
    return run.stages["device_issue"]["mean_ms"]
