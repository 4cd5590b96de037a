"""Bottom-up multi-person CLI: one HigherHRNet pass, associative-embedding
grouping, no detector (the port of the JAX package's
`cli/detect_pose_bottomup.py`, on the GPU).

    python3 -m human_body_proportion_estimation_tpu_torch.cli.detect_pose_bottomup \\
        -i <image, image directory or video> [-m video] [-o output_dir]

The output mirrors the main driver's nested list
(`person_det_pose_edet4_trtserver.py:131-171`) without heatmaps:
``[[boxes, dist_dict_p0, dist_dict_p1, ...], ...]``; renderings go to
`<output_dir>/tpu_bottomup_pose/` (the JAX package's directory name, so
either package's runs land in the same place).
"""

from __future__ import annotations

import os
import time
from typing import Any, List

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.cli.args import build_parser
from human_body_proportion_estimation_tpu_torch.ops import (
    proportions as prop_ops,
)
from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
    BottomUpPipeline,
    build_default,
)
from human_body_proportion_estimation_tpu_torch.utils import (
    draw,
    io as media_io,
)

PERSON_COLORS = [(255, 255, 0), (0, 0, 255)]


def run_bottomup(
    media_filename: str,
    person_height: float = 175.0,
    inference_mode: str = "image",
    save_result_dir: str | None = None,
    pipeline: BottomUpPipeline | None = None,
    debug: bool = True,
    batch_size: int = 8,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> List[List[Any]]:
    """Run the bottom-up pipeline over media. `device` / `dtype` build the
    pipeline when none is given (`pipeline.bottomup.build_default`: the
    card and bf16 by default)."""
    pipe = pipeline if pipeline is not None else build_default(device, dtype)
    start = time.time()
    save_dir = None
    if save_result_dir:
        save_dir = os.path.join(save_result_dir, "tpu_bottomup_pose")
        os.makedirs(save_dir, exist_ok=True)

    if inference_mode == "video":
        frames, _fps = media_io.stream_video(media_filename)
    else:
        frames = media_io.stream_images(media_filename)

    results: List[List[Any]] = []
    counter = 0
    batch: List[np.ndarray] = []

    def flush(batch):
        nonlocal counter
        if not batch:
            return
        out = pipe.infer_images(batch, person_heights=person_height)
        for i in range(len(batch)):
            # bottom-up valid slots are NOT a prefix (a slot is cleared
            # when its group has < 2 visible joints, leaving gaps), unlike
            # the top-down select_persons, which sorts its slots
            valid_slots = [s for s in range(out.person_valid.shape[1])
                           if out.person_valid[i, s]]
            entry: List[Any] = [out.boxes_orig[i][valid_slots]]
            for slot in valid_slots:
                entry.append(prop_ops.to_dist_dict(
                    out.lengths_cm[i, slot], out.seg_visible[i, slot]))
            results.append(entry)
            if save_dir is not None:
                frame = batch[i].copy()
                for slot in valid_slots:
                    color = PERSON_COLORS[slot % 2]
                    y1, x1, y2, x2 = out.boxes_orig[i, slot]
                    draw.draw_box(frame, [x1, y1, x2, y2], color=color)
                    draw.draw_skeleton(frame, out.keypoints[i, slot],
                                       out.seg_visible[i, slot], color=color)
                    draw.draw_keypoints(frame, out.keypoints[i, slot],
                                        out.kp_visible[i, slot], color)
                media_io.save_image(
                    os.path.join(save_dir, f"frame_{counter:06d}.jpg"), frame)
            counter += 1

    for frame in frames:
        batch.append(frame)
        if len(batch) >= batch_size:
            flush(batch)
            batch = []
    flush(batch)

    if debug:
        print(f"Time to process {counter} image(s)={time.time()-start:.3f}s")
    return results


def main():
    args = build_parser(
        "Bottom-up Multi-person Pose Estimation (PyTorch/CUDA, HigherHRNet "
        "+ AE)").parse_args()
    # like the JAX CLI, it reads neither --checkpoint-dir nor --detector
    results = run_bottomup(
        args.input_path,
        person_height=args.person_height,
        inference_mode=args.media_type,
        save_result_dir=args.output_dir or None,
        debug=args.debug,
    )
    print(results)


if __name__ == "__main__":
    main()
