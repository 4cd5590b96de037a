"""Shared CLI helpers (the port of the JAX package's `cli/common.py`)."""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

from human_body_proportion_estimation_tpu_torch.pipeline.host import (
    InferencePipeline,
)


def option_problems(detector: Optional[str],
                    bottom_up: bool = False) -> List[str]:
    """Why this machine cannot serve the options given, before anything is
    built (empty when it can): the SSD slot with the reference's
    ssd.tflite absent (JAX's SSD is never random: no fallback to random
    weights)."""
    from human_body_proportion_estimation_tpu_torch.models.tflite_import import (  # noqa: E501
        DEFAULT_TFLITE_PATH,
    )

    msgs = []
    if (detector == "ssd_mobilenet" and not bottom_up
            and not os.path.exists(DEFAULT_TFLITE_PATH)):
        msgs.append(f"--detector ssd_mobilenet: the SSD weights "
                    f"{DEFAULT_TFLITE_PATH} are absent (the SSD slot "
                    "serves only the real weights of that file)")
    return msgs


def exit_on_problems(msgs: List[str]) -> None:
    """Print each message and exit with code 2 when there is one."""
    if msgs:
        for msg in msgs:
            print(f"cannot serve: {msg}", file=sys.stderr)
        raise SystemExit(2)


def checkpoint_states(checkpoint_dir: str, detector: Optional[str] = None
                      ) -> Tuple[Optional[dict], dict]:
    """(det_state, pose_state) port `state_dict`s of an Orbax pipeline
    checkpoint directory (`models.weights.load_pipeline_checkpoint`). The
    SSD slot takes only the pose side (det_state None), as the JAX
    entry points do: it serves the tflite's weights."""
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        flax_to_state_dict,
        load_pipeline_checkpoint,
    )

    det_vars, pose_vars = load_pipeline_checkpoint(checkpoint_dir)
    det_state = (None if detector == "ssd_mobilenet" or not det_vars
                 else flax_to_state_dict(det_vars))
    return det_state, flax_to_state_dict(pose_vars)


def build_pipeline(args=None) -> InferencePipeline:
    """Pipeline for the top-down CLIs, on the GPU. With `--checkpoint-dir`
    its slots (the pose slot alone for the SSD detector); else the JAX
    package's default weights: the committed synthetic-certified HRNet-W32
    pose, before the certified EfficientDet-Lite4, the SSD's real weights
    (ssd.tflite), or, for `--detector efficientdet_lite0` (and the YOLOv5
    slots), a detector at random, flax's init with PRNGKey(0) (no weights
    for it are in the repository; /health and the log say "random").
    Options this machine cannot serve exit with code 2 (`option_problems`)
    before anything is built."""
    detector = getattr(args, "detector", None) or "efficientdet_lite4"
    checkpoint_dir = getattr(args, "checkpoint_dir", None)
    exit_on_problems(option_problems(detector))
    det_state = pose_state = None
    if checkpoint_dir:
        det_state, pose_state = checkpoint_states(checkpoint_dir, detector)
    return InferencePipeline(device="cuda", detector=detector,
                             det_state=det_state, pose_state=pose_state)
