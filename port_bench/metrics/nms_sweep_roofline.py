"""nms_sweep_roofline: the least time the card could take for one call of the
`nms_sweep` kernel at the cell's shapes (`counts/kernels.py`: the larger of
bytes over HBM bandwidth and operations over the work's peak) over the
kernel's mean time a launch on the traced slice, in percent."""

from port_bench.counts import kernels
from port_bench.trace import kernel_time


def read(run):
    if run.trace is None or "nms_sweep" not in run.kernel_calls:
        return None
    n, s = kernel_time(run.trace, kernels.KERNEL_NAMES["nms_sweep"])
    if not n or s <= 0:
        return None
    least, _ = kernels.bound_s(*run.kernel_calls["nms_sweep"])
    return 100.0 * least / (s / n)
