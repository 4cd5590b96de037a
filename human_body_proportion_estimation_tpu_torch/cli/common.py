"""Shared CLI helpers (the port of the JAX package's `cli/common.py`)."""

from __future__ import annotations

import sys

from human_body_proportion_estimation_tpu_torch.pipeline.host import (
    InferencePipeline,
)


def build_pipeline(args=None) -> InferencePipeline:
    """Pipeline for the top-down CLIs, on the GPU, with the committed
    synthetic-certified EfficientDet-Lite4 + HRNet-W32 weights (the JAX
    package's default when no --checkpoint-dir is given). Options the port
    does not serve yet exit with code 2 and the ROADMAP.md item that brings
    them."""
    not_yet = []
    if getattr(args, "checkpoint_dir", None):
        not_yet.append("--checkpoint-dir (orbax checkpoints): ROADMAP.md "
                       "item 17")
    if getattr(args, "detector", "efficientdet_lite4") != "efficientdet_lite4":
        not_yet.append(f"--detector {args.detector}: ROADMAP.md items "
                       "10-12 (slice 6: the other slots)")
    if not_yet:
        for msg in not_yet:
            print(f"not ported yet: {msg}", file=sys.stderr)
        raise SystemExit(2)
    return InferencePipeline(device="cuda")
