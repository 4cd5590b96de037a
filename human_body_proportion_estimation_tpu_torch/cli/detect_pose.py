"""Full-pipeline CLI: person detection + pose + body-proportion lengths
(the port of the JAX package's `cli/detect_pose.py`, on the GPU).

    python3 -m human_body_proportion_estimation_tpu_torch.cli.detect_pose \\
        -i <image, image directory or video> [-m video] [-o output_dir]

The counterpart of the reference's main driver
(`person_det_pose_edet4_trtserver.py`): same inputs (image/dir/video, det
threshold, person height), same nested return structure
``[[boxes, heatmaps, dist_dict_p0, ...], ...]``, same renderings and file
names under `<output_dir>/tpu_pdet_pose/` when an output dir is given
(boxes, skeletons, numbered keypoints, summed-heatmap plots, frame/video
files, two-color person cycle). As in the JAX package, every frame is
saved (the reference's `counter += 1` sits outside its response loop,
:196, so its multi-image runs overwrite frame 0).
"""

from __future__ import annotations

import os
import time
from typing import Any, List

import numpy as np

from human_body_proportion_estimation_tpu_torch.cli.args import build_parser
from human_body_proportion_estimation_tpu_torch.pipeline.host import (
    InferencePipeline,
    decode_image_bytes,
    format_image_result,
)
from human_body_proportion_estimation_tpu_torch.utils import (
    draw,
    io as media_io,
)

PERSON_COLORS = [(255, 255, 0), (0, 0, 255)]  # driver :147


def _render(
    frame: np.ndarray, out, img_idx: int, save_dir: str, frame_idx: int
):
    for slot in range(out.person_valid.shape[1]):
        if not bool(out.person_valid[img_idx, slot]):
            continue
        color = PERSON_COLORS[slot % 2]
        y1, x1, y2, x2 = np.asarray(out.boxes_orig[img_idx, slot])
        draw.draw_box(frame, [x1, y1, x2, y2], color=color)
        kp = np.asarray(out.keypoints[img_idx, slot])
        draw.draw_skeleton(
            frame, kp, np.asarray(out.seg_visible[img_idx, slot]),
            color=color, thickness=max(int(x2 - x1) // 150, 1),
        )
        draw.draw_keypoints(
            frame, kp, np.asarray(out.kp_visible[img_idx, slot]), color
        )
        if out.heatmaps is not None:
            draw.save_heatmap_plot(
                np.asarray(out.heatmaps[img_idx, slot]),
                os.path.join(
                    save_dir, f"heatmap_{slot}_{frame_idx:06d}.jpg"
                ),
            )


def run_pdet_pose(
    media_filename: str | bytes,
    person_height: List[float] | float = 175.0,
    inference_mode: str = "image",
    det_threshold: float = 0.70,
    save_result_dir: str | None = None,
    pipeline: InferencePipeline | None = None,
    debug: bool = True,
    batch_size: int = 8,
) -> List[List[Any]]:
    """Run the fused pipeline over media; returns the reference-parity
    nested result list (`run_pdet_pose`, driver :29-201)."""
    if pipeline is None:
        from human_body_proportion_estimation_tpu_torch.cli.common import (
            build_pipeline,
        )

        pipeline = build_pipeline()
    pipe = pipeline
    start = time.time()
    save_dir = None
    if save_result_dir:
        save_dir = os.path.join(save_result_dir, "tpu_pdet_pose")
        os.makedirs(save_dir, exist_ok=True)

    heights = person_height if isinstance(person_height, (list, tuple)) \
        else [person_height]

    # gather frames
    writer = None
    if isinstance(media_filename, bytes):
        frames = iter([decode_image_bytes(media_filename)])
        fps = 1.0
    elif inference_mode == "video":
        frames, fps = media_io.stream_video(media_filename)
    else:
        frames = media_io.stream_images(media_filename)
        fps = 1.0

    results: List[List[Any]] = []
    counter = 0
    batch: List[np.ndarray] = []

    def flush(batch):
        nonlocal counter, writer
        if not batch:
            return
        out = pipe.infer_images(
            batch, person_heights=[heights] * len(batch),
            det_threshold=det_threshold, with_heatmaps=save_dir is not None,
        )
        for i in range(len(batch)):
            results.append(format_image_result(out, i))
            if save_dir is not None:
                frame = batch[i].copy()
                _render(frame, out, i, save_dir, counter)
                if inference_mode == "video":
                    if writer is None:
                        writer = media_io.VideoWriter(
                            os.path.join(save_dir, "res_video.mp4"),
                            max(fps - 10, 1.0),  # reference fps-10 quirk
                            frame.shape[1], frame.shape[0],
                        )
                    writer.write(frame)
                else:
                    media_io.save_image(
                        os.path.join(save_dir, f"frame_{counter:06d}.jpg"),
                        frame,
                    )
            counter += 1

    for frame in frames:
        batch.append(frame)
        if len(batch) >= batch_size:
            flush(batch)
            batch = []
    flush(batch)
    if writer is not None:
        writer.close()

    if debug:
        print(f"Time to process {counter} image(s)={time.time()-start:.3f}s")
    return results


def main():
    args = build_parser(
        "Person Detection and Pose Estimation (PyTorch/CUDA)").parse_args()
    from human_body_proportion_estimation_tpu_torch.cli.common import (
        build_pipeline,
    )

    results = run_pdet_pose(
        args.input_path,
        person_height=[args.person_height],
        inference_mode=args.media_type,
        det_threshold=args.detection_threshold,
        save_result_dir=args.output_dir or None,
        pipeline=build_pipeline(args),
        debug=args.debug,
    )
    print(results)


if __name__ == "__main__":
    main()
