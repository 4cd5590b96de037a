"""pose.device_ms: device milliseconds of the kernels under the program's
`hbpe.pose` range, a batch, from the traced slice."""


def read(run):
    if run.trace is None or run.mix["loop"] != "closed":
        return None
    r = run.trace["ranges"].get("hbpe.pose")
    if not r or not r["calls"] or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["calls"]
