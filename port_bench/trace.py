"""Reduction of one `torch.profiler` trace of the traced slice to what the
per-layer metrics read.

    busy_s       union of the intervals in which any device activity
                 (kernel, copy, set) ran, within the traced window
    window_s     the traced window's length: the `bench.window` span
    ranges       per `record_function` range (the program's `hbpe.*`
                 stages and the benchmark's own `bench.*` spans): calls,
                 host seconds and device seconds of the kernels under it
    kernels      per device activity name: launches and device seconds
    breakdown    the device operations that took most time, and the idle
                 gaps of the device by what the host was in: the innermost
                 range, else one of the benchmark's host spans (a forward
                 under way on a batcher thread, which the profiler's ranges
                 do not see), else nothing
"""

from __future__ import annotations

import collections
import re
from typing import List, Tuple

WINDOW = "bench.window"     # the span around the whole traced slice
IDLE_OUTSIDE = "host outside any range"


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(covered length, gaps between covered stretches as (start, end))."""
    total, gaps = 0.0, []
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total, gaps


def short_name(name: str) -> str:
    """A device function's name without return type, template arguments
    and parameters."""
    name = name.replace("(anonymous namespace)", "anon")
    while True:
        stripped = re.sub(r"<[^<>]*>", "", name)
        if stripped == name:
            break
        name = stripped
    return re.sub(r"^void ", "", name.split("(")[0]).strip()


def summarize(prof, host_spans=(), window_host_start: float = 0.0) -> dict:
    """`prof`: a finished `torch.profiler.profile` over CPU and CUDA whose
    traced slice lies in a `record_function(WINDOW)` span, opened at
    `window_host_start` on the host clock (`time.perf_counter`);
    `host_spans`: (start, end, label) on that clock."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = [e for e in events if e.name == WINDOW]
    if len(spans) != 1:
        raise RuntimeError(f"expected one {WINDOW} span, found {len(spans)}")
    t0, t1 = spans[0].time_range.start, spans[0].time_range.end
    device, annotations = [], []
    ranges = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for e in events:
        mine = e.name.startswith(("hbpe.", "bench."))
        if e.device_type == DeviceType.CUDA:
            # a range's own device-side annotation is no device activity
            if mine or getattr(e, "is_user_annotation", False):
                continue
            a, b = e.time_range.start, e.time_range.end
            if b > t0 and a < t1:
                device.append((max(a, t0), min(b, t1), short_name(e.name)))
        elif mine and e.name != WINDOW:
            r = ranges[e.name]
            r[0] += 1
            r[1] += e.cpu_time_total / 1e6
            r[2] += e.device_time_total / 1e6
            annotations.append((e.time_range.start, e.time_range.end,
                                e.name))
    hosts = [(t0 + (a - window_host_start) * 1e6,
              t0 + (b - window_host_start) * 1e6, n)
             for a, b, n in host_spans]
    busy, gaps = _union([(a, b) for a, b, _ in device])
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for a, b, name in device:
        kernels[name][0] += 1
        kernels[name][1] += (b - a) / 1e6
    # the lead-in before the first device activity and the tail after the
    # last are idle too
    if device:
        first = min(a for a, _, _ in device)
        last = max(b for _, b, _ in device)
        gaps = [(t0, first)] + gaps + [(last, t1)]
    else:
        gaps = [(t0, t1)]
    idle_by = collections.defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = [(s, n) for s, e, n in annotations if s <= mid < e]
        if not inner:
            inner = [(s, n) for s, e, n in hosts if s <= mid < e]
        label = max(inner)[1] if inner else IDLE_OUTSIDE
        idle_by[label] += (b - a) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy / 1e6,
        "ranges": {k: {"calls": v[0], "host_s": v[1], "device_s": v[2]}
                   for k, v in ranges.items()},
        "kernels": {k: {"launches": v[0], "device_s": v[1]}
                    for k, v in kernels.items()},
        "breakdown": {
            "device_ops": [[k, v[1]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle_by.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def kernel_time(summary: dict, fragment: str) -> Tuple[int, float]:
    """(launches, device seconds) of the device functions whose name holds
    `fragment`."""
    n, s = 0, 0.0
    for name, v in summary["kernels"].items():
        if fragment in name:
            n += v["launches"]
            s += v["device_s"]
    return n, s
