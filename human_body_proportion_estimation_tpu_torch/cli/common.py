"""Shared CLI helpers (the port of the JAX package's `cli/common.py`)."""

from __future__ import annotations

import sys

from human_body_proportion_estimation_tpu_torch.pipeline.host import (
    InferencePipeline,
)


# detector slots the port has not ported yet, and the ROADMAP.md item of each
NOT_PORTED_DETECTORS = {
    "ssd_mobilenet": "item 10 (SSD)",
    "efficientdet_lite0": "item 12 (EfficientDet-Lite0)",
}


def build_pipeline(args=None) -> InferencePipeline:
    """Pipeline for the top-down CLIs, on the GPU: the committed
    synthetic-certified EfficientDet-Lite4 + HRNet-W32 weights (the JAX
    package's default when no --checkpoint-dir is given), or, for
    `--detector yolov5s|yolov5m`, a YOLOv5 detector at random (no YOLO
    weights are in the repository; /health and the log say "random")
    before the certified HRNet-W32. Options the port does not serve yet
    exit with code 2 and the ROADMAP.md item that brings them."""
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
