"""EfficientDet detection-only CLI (the port of the JAX package's
`cli/detect_edet.py`, on the GPU).

    python3 -m human_body_proportion_estimation_tpu_torch.cli.detect_edet \\
        -i <image, image directory or video> \\
        [--detector efficientdet_lite4|efficientdet_lite0] [-g PORT]

Counterpart of the reference EfficientDet demo
(`obj_det_edet4_trtserver.py`): uint8 640x480 input, detection tensors in
the "modified-model" schema (pixel y1x1y2x2 + scores + 1-based classes,
:22-37), box drawing, frame/video outputs. Detections are scaled from the
model input size to the displayed image (:136-141) when drawn.

In process, `EdetDetectPipeline` runs on the GPU: the canonical all-class
head and one NMS sweep kernel launch a frame. No weights for this CLI
are in the repository: the detector (Lite4 or Lite0) is initialized at
random (`models.layers.init_random`) as the JAX CLI initializes its flax
model, from `PRNGKey(0)`.

`-g/--grpc_port` switches to remote mode: the CLI calls the serving
edge's named `edetlite4` model over the tensor-level ModelInfer RPC, the
reference's client/Triton split (`obj_det_edet4_trtserver.py:53`).

Its `main` also prints one "frame i: N detections" line a frame (the JAX
CLI prints only its timing), so that a subprocess run can be checked.
"""

from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.cli.args import (
    COCO_CLASSES,
    build_parser,
)
from human_body_proportion_estimation_tpu_torch.pipeline.detect import (
    EdetDetectPipeline,
)
from human_body_proportion_estimation_tpu_torch.pipeline.host import (
    resize_for_detector,
)
from human_body_proportion_estimation_tpu_torch.utils import (
    draw,
    io as media_io,
)


def _remote_infer_fn(grpc_target: str):
    """Per-frame closure against the serving edge's named `edetlite4`
    model via ModelInfer (the reference's Triton-client architecture,
    `obj_det_edet4_trtserver.py:53` + triton_utils): boxes come back in
    the sent image's pixel space, scores 0 on empty slots."""
    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        GrpcClient,
    )

    if ":" not in grpc_target:
        grpc_target = f"127.0.0.1:{grpc_target}"
    client = GrpcClient(grpc_target)

    def infer(model_in_u8: np.ndarray):
        out = client.infer("edetlite4", {"image": model_in_u8[None]})
        boxes = out["output_0"][0]
        scores = out["output_1"][0]
        classes = out["output_2"][0]
        return boxes, scores, classes, scores > 0.0

    return infer


def _local_infer_fn(detector_name: str, input_hw, device: str,
                    dtype: torch.dtype):
    """Per-frame closure of the in-process program: a seeded random
    EfficientDet of the named slot on `device`."""
    from human_body_proportion_estimation_tpu_torch.models import (
        efficientdet as edet,
        layers,
    )

    if device == "cuda":
        # the canonical head and box head are f32 convs: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = (edet.EFFICIENTDET_LITE0 if detector_name == "efficientdet_lite0"
           else edet.EFFICIENTDET_LITE4)
    model = layers.init_random(edet.EfficientDet(cfg, dtype=dtype))
    program = EdetDetectPipeline(model.to(device).eval(), input_hw)

    def infer(model_in_u8: np.ndarray):
        dets = program(torch.from_numpy(model_in_u8[None]).to(device))
        return tuple(t[0].cpu().numpy() for t in
                     (dets.boxes, dets.scores, dets.classes, dets.valid))

    return infer


def run_demo_odet(
    media_filename: str,
    inference_mode: str = "image",
    det_threshold: float = 0.55,
    save_result_dir: str | None = None,
    detector_name: str = "efficientdet_lite4",
    debug: bool = True,
    input_hw=(480, 640),
    grpc_target: str | None = None,
    device: str = "cuda",
    dtype: torch.dtype = torch.bfloat16,
):
    """Detection demo; returns per-frame (boxes, scores, classes) numpy.
    `device` / `dtype`: where and in what the in-process detector runs
    (the GPU in bf16 unless the caller asks otherwise)."""
    start = time.time()
    if grpc_target:
        infer_fn = _remote_infer_fn(grpc_target)
    else:
        infer_fn = _local_infer_fn(detector_name, input_hw, device, dtype)

    save_dir = None
    if save_result_dir:
        save_dir = os.path.join(save_result_dir, f"tpu_{detector_name}")
        os.makedirs(save_dir, exist_ok=True)

    if inference_mode == "video":
        frames, fps = media_io.stream_video(media_filename)
    else:
        frames = media_io.stream_images(media_filename)
        fps = 1.0

    writer = None
    outputs: List = []
    h, w = input_hw
    for counter, frame in enumerate(frames):
        model_in = resize_for_detector(frame, w, h)
        boxes, scores, classes, valid = infer_fn(model_in)
        valid = valid & (scores >= det_threshold)
        outputs.append((boxes[valid], scores[valid], classes[valid]))

        if save_dir is not None:
            oh, ow = frame.shape[:2]
            # scale det-input pixel coords to the original image (:136-141)
            sy, sx = oh / h, ow / w
            for (y1, x1, y2, x2), sc, cl in zip(
                boxes[valid], scores[valid], classes[valid]
            ):
                name = COCO_CLASSES[int(cl) - 1] \
                    if 1 <= int(cl) <= len(COCO_CLASSES) else str(int(cl))
                draw.draw_box(
                    frame, [x1 * sx, y1 * sy, x2 * sx, y2 * sy],
                    color=(255, 0, 0), label=f"{name} {sc:.2f}",
                )
            if inference_mode == "video":
                if writer is None:
                    writer = media_io.VideoWriter(
                        os.path.join(save_dir, "res_video.mp4"),
                        max(fps - 10, 1.0), frame.shape[1], frame.shape[0],
                    )
                writer.write(frame)
            else:
                media_io.save_image(
                    os.path.join(save_dir, f"frame_{counter:06d}.jpg"), frame
                )
    if writer is not None:
        writer.close()
    if debug:
        print(f"Time to process {len(outputs)} image(s)="
              f"{time.time()-start:.3f}s")
    return outputs


def main():
    args = build_parser("EfficientDet Object Detection (GPU)").parse_args()
    outputs = run_demo_odet(
        args.input_path,
        inference_mode=args.media_type,
        det_threshold=args.detection_threshold,
        save_result_dir=args.output_dir or None,
        detector_name=args.detector,
        debug=args.debug,
        grpc_target=args.grpc_port,
    )
    for i, (boxes, scores, classes) in enumerate(outputs):
        print(f"frame {i}: {len(boxes)} detections")
        for bx, sc, cl in zip(boxes, scores, classes):
            print(f"  {int(cl)} {float(sc):.6f} "
                  f"{[round(float(v), 3) for v in bx]}")


if __name__ == "__main__":
    main()
