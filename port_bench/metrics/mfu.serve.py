"""mfu.serve: the model FLOPs of every row the batcher's forwards ran in
the window, padding rows included, over the time in which a forward was
under way (the union of their host-clock intervals), as a share of one
H100's dense bf16 peak."""

from port_bench import peaks


def read(run):
    if run.mix["loop"] != "open":
        return None
    end = run.window_start + run.window_s
    spans = sorted(f[:3] for f in run.forwards if f[0] < end)
    if not spans:
        return None
    rows = sum(n for _, _, n in spans)
    busy, reach = 0.0, None
    for a, b, _ in spans:
        if reach is None or a > reach:
            busy += b - a
            reach = b
        elif b > reach:
            busy += b - reach
            reach = b
    return 100.0 * run.image_flops * rows / (busy * peaks.BF16_FLOP_PER_S)
