"""device_idle_pct.batch: the share of the traced slice in which no device
activity ran (1 - the union of kernel, copy and set intervals over the
slice), in the closed-loop cells."""


def read(run):
    if run.trace is None or run.mix["loop"] != "closed":
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
