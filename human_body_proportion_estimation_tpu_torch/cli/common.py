"""Shared CLI helpers (the port of the JAX package's `cli/common.py`)."""

from __future__ import annotations

import sys

from human_body_proportion_estimation_tpu_torch.pipeline.host import (
    InferencePipeline,
)


# detector slots the port has not ported yet, and the ROADMAP.md item of each
NOT_PORTED_DETECTORS = {
    "ssd_mobilenet": "item 10 (SSD)",
}


def build_pipeline(args=None) -> InferencePipeline:
    """Pipeline for the top-down CLIs, on the GPU, with the JAX package's
    default weights when no --checkpoint-dir is given: the committed
    synthetic-certified HRNet-W32 pose, before the certified
    EfficientDet-Lite4, or, for `--detector efficientdet_lite0` (and the
    YOLOv5 slots), a detector at random, flax's init with PRNGKey(0) (no
    weights for it are in the repository; /health and the log say
    "random"). Options the port does not serve yet exit with code 2 and
    the ROADMAP.md item that brings them."""
    not_yet = []
    if getattr(args, "checkpoint_dir", None):
        not_yet.append("--checkpoint-dir (orbax checkpoints): ROADMAP.md "
                       "item 17")
    detector = getattr(args, "detector", None) or "efficientdet_lite4"
    if detector in NOT_PORTED_DETECTORS:
        not_yet.append(f"--detector {detector}: ROADMAP.md "
                       f"{NOT_PORTED_DETECTORS[detector]}")
    if not_yet:
        for msg in not_yet:
            print(f"not ported yet: {msg}", file=sys.stderr)
        raise SystemExit(2)
    return InferencePipeline(device="cuda", detector=detector)
