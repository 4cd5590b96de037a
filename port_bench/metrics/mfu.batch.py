"""mfu.batch: the model FLOPs of the images answered in the window (the
configuration's count, `counts/model.py`) over the window's seconds, as a
share of one H100's dense bf16 peak (`peaks.py`)."""

from port_bench import peaks


def read(run):
    if run.mix["loop"] != "closed" or not run.images:
        return None
    return 100.0 * run.image_flops * run.images / (
        run.window_s * peaks.BF16_FLOP_PER_S)
