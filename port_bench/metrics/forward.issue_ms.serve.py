"""forward.issue_ms.serve: milliseconds of the serving program's call, up
to its return, in the open-loop cells: the host's issue of the forward
plus its waits at the synchronizations inside the forward, which there
also wait for the kernels of the other forward in flight on the stream.
The pipeline's `device_issue` stage, mean over the window (`StageTimer`,
no profiler running)."""


def read(run):
    if run.mix["loop"] != "open" or "device_issue" not in run.stages:
        return None
    return run.stages["device_issue"]["mean_ms"]
