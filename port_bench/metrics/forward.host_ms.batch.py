"""forward.host_ms.batch: host (CPU) milliseconds a batch spends inside the
program's four stages (`hbpe.detector`, `.crop`, `.pose`, `.decode_cm`),
from the traced slice: the time the host needs to issue a forward."""

STAGES = ("hbpe.detector", "hbpe.crop", "hbpe.pose", "hbpe.decode_cm")


def read(run):
    if run.trace is None or run.mix["loop"] != "closed":
        return None
    r = run.trace["ranges"]
    if not all(s in r for s in STAGES):
        return None
    return 1e3 * sum(r[s]["host_s"] for s in STAGES) / \
        r["hbpe.detector"]["calls"]
