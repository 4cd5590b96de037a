"""host.prepare_ms.batch: host milliseconds a forward spends before the
device computes, in the closed-loop cells: the pipeline's `host_prepare`
(resize, pad to the bucket) plus `device_upload` (copies to the card
until they have finished), means over the window (`StageTimer`)."""


def read(run):
    if run.mix["loop"] != "closed":
        return None
    st = run.stages
    if "host_prepare" not in st or "device_upload" not in st:
        return None
    return st["host_prepare"]["mean_ms"] + st["device_upload"]["mean_ms"]
