"""YOLOv5 detection CLI (the port of the JAX package's `cli/detect_yolo.py`,
on the GPU).

    python3 -m human_body_proportion_estimation_tpu_torch.cli.detect_yolo \\
        -i <image, image directory or video> [--model yolov5s|yolov5m]
        [--legacy-nms] [--cpu] [-g PORT]

Counterpart of both reference YOLOv5 demos — the Triton one
(`obj_det_yolov5_trtserver.py`: letterbox 640, conf 0.4 / IoU 0.5 NMS,
scale_coords back, :30-44,153-154) and the serverless onnxruntime one
(`obj_det_yolov5_onnx.py`). In process, the detector runs on the GPU, or
on the CPU with `--cpu` (f32, the caller's choice; nothing moves to the
CPU by itself), with the JAX package's 512 candidates: on the GPU one
NMS sweep kernel launch a frame (`--legacy-nms`: the kernel's +1-pixel IoU
variant). No YOLO weights are in the repository: the detector is
initialized at random as the JAX CLI initializes its flax model, from
`PRNGKey(0)` (`models.layers.init_random`).

`-g/--grpc_port` switches to remote mode — the reference's split: the
named `yolov5m`/`yolov5s` model runs server-side (ModelInfer returning the
[N, 25200, 85] prediction tensor) and NMS runs CLIENT-side, here the same
`yolo_nms` the in-process path uses, on the GPU (the CPU with `--cpu`).
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
    YoloDetectPipeline,
    letterbox_host,
    scale_boxes_to_original,
)
from human_body_proportion_estimation_tpu_torch.utils import (
    draw,
    io as media_io,
)

MODEL_SIZE = 640
TOP_K = 512


def _numpy(res):
    return tuple(t[0].cpu().numpy() for t in
                 (res.valid, res.boxes, res.scores, res.classes))


def _remote_infer_fn(grpc_target: str, model_name: str,
                     det_threshold: float, iou_threshold: float,
                     legacy_nms: bool = False, num_classes: int = 80,
                     device: str = "cuda"):
    """Remote per-frame closure: model forward + decode server-side via
    ModelInfer, NMS client-side on `device` (the reference's Triton
    split)."""
    from human_body_proportion_estimation_tpu_torch.ops.nms import (
        yolo_nms,
        yolo_nms_legacy,
    )
    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        GrpcClient,
    )

    if ":" not in grpc_target:
        grpc_target = f"127.0.0.1:{grpc_target}"
    client = GrpcClient(grpc_target)

    def infer(model_in: np.ndarray):  # [S, S, 3] f32 letterboxed /255
        nchw = np.ascontiguousarray(
            np.transpose(model_in[None], (0, 3, 1, 2)), dtype=np.float32)
        preds = client.infer(model_name, {"images": nchw})["output"]
        p = torch.from_numpy(np.array(preds[:1], np.float32)).to(device)
        if legacy_nms:
            res = yolo_nms_legacy(p, num_classes, det_threshold,
                                  iou_threshold, 300, TOP_K)
        else:
            res = yolo_nms(p, det_threshold, iou_threshold, 300, TOP_K)
        return _numpy(res)

    return infer


def run_demo_odet(
    media_filename: str,
    inference_mode: str = "image",
    det_threshold: float = 0.4,
    iou_threshold: float = 0.5,
    save_result_dir: str | None = None,
    model_name: str = "yolov5m",
    use_cpu: bool = False,
    debug: bool = True,
    grpc_target: str | None = None,
    legacy_nms: bool = False,
    num_classes: int = 80,
):
    from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
        YOLOV5M,
        YOLOV5S,
        YoloV5,
        init_random,
    )

    start = time.time()
    device = "cpu" if use_cpu else "cuda"
    if grpc_target:
        infer_fn = _remote_infer_fn(
            grpc_target, model_name, det_threshold, iou_threshold,
            legacy_nms=legacy_nms, num_classes=num_classes, device=device,
        )
    else:
        if device == "cuda":
            # the Detect convs and the decode are f32: no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        cfg = YOLOV5S if model_name == "yolov5s" else YOLOV5M
        model = YoloV5(cfg, dtype=torch.float32 if use_cpu
                       else torch.bfloat16)
        model = init_random(model).to(device).eval()
        program = YoloDetectPipeline(
            model, conf_thres=det_threshold, iou_thres=iou_threshold,
            top_k=TOP_K, legacy_nms=legacy_nms, num_classes=num_classes,
        )

        def infer_fn(model_in: np.ndarray):
            return _numpy(program(torch.from_numpy(model_in[None]).to(
                device)))

    save_dir = None
    if save_result_dir:
        save_dir = os.path.join(save_result_dir, f"tpu_{model_name}")
        os.makedirs(save_dir, exist_ok=True)

    if inference_mode == "video":
        frames, fps = media_io.stream_video(media_filename)
    else:
        frames = media_io.stream_images(media_filename)
        fps = 1.0

    writer = None
    outputs: List = []
    for counter, frame in enumerate(frames):
        model_in = letterbox_host(frame, MODEL_SIZE)
        valid, boxes, scores, classes = infer_fn(model_in)
        boxes = boxes[valid]
        scores = scores[valid]
        classes = classes[valid]
        boxes = scale_boxes_to_original(
            boxes, MODEL_SIZE, frame.shape[:2]
        ) if len(boxes) else boxes
        outputs.append((boxes, scores, classes))

        if save_dir is not None:
            for bx, sc, cl in zip(boxes, scores, classes):
                name = COCO_CLASSES[int(cl)] \
                    if 0 <= int(cl) < len(COCO_CLASSES) else str(int(cl))
                # per-class seeded color, reference scheme
                # (`obj_det_yolov5_onnx.py:56-57`)
                draw.draw_box(frame, bx, color=draw.class_color(int(cl)),
                              label=f"{name} {sc:.2f}")
            if inference_mode == "video":
                if writer is None:
                    writer = media_io.VideoWriter(
                        os.path.join(save_dir, "res_video.mp4"),
                        max(fps - 10, 1.0), frame.shape[1], frame.shape[0],
                    )
                writer.write(frame)
            else:
                media_io.save_image(
                    os.path.join(save_dir, f"frame_{counter:05d}.jpg"), frame
                )
    if writer is not None:
        writer.close()
    if debug:
        print(f"Inference time ({device}): {time.time() - start:.2f}s")
    return outputs


def main():
    parser = build_parser("YOLOv5 Object Detection (GPU)")
    parser.add_argument("--model", default="yolov5m",
                        choices=("yolov5s", "yolov5m"))
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (f32) instead of the GPU")
    parser.add_argument("--legacy-nms", action="store_true",
                        help="use the reference's second YOLO postprocess "
                             "(`w_non_max_suppression`, modules/"
                             "onnx_utils.py:39-95: obj-conf gating + "
                             "per-class +1-IoU NMS); -c/--num_classes sets "
                             "its class-column count")
    args = parser.parse_args()
    outputs = run_demo_odet(
        args.input_path,
        inference_mode=args.media_type,
        det_threshold=args.detection_threshold,
        save_result_dir=args.output_dir or None,
        model_name=args.model,
        use_cpu=args.cpu,
        debug=args.debug,
        grpc_target=args.grpc_port,
        legacy_nms=args.legacy_nms,
        num_classes=args.num_classes,
    )
    for i, (boxes, scores, classes) in enumerate(outputs):
        print(f"frame {i}: {len(boxes)} detections")
        for bx, sc, cl in zip(boxes, scores, classes):
            print(f"  {COCO_CLASSES[int(cl)] if 0 <= int(cl) < 80 else int(cl)}"
                  f" {float(sc):.4f} {[round(float(v), 2) for v in bx]}")


if __name__ == "__main__":
    main()
