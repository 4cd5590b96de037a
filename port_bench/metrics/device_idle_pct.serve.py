"""device_idle_pct.serve: the share of the traced slice in which no device
activity ran (1 - the union of kernel, copy and set intervals over the
slice), in the open-loop cells."""


def read(run):
    if run.trace is None or run.mix["loop"] != "open":
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
