"""Shared CLI argument surface of the port: the JAX package's
`cli/args.py` flags, option for option (the reference's flags,
`modules/utils.py:85-113`), so one command line works with either package.

The `-g/--grpc_port` flag keeps the reference's Triton-port semantics:
`pose_est`, `detect_edet` and `detect_yolo` dial the serving edge's named
model over the tensor-level ModelInfer RPC (serve/registry.py); without
it, and in `detect_pose` (which ignores it in the JAX package too), the
models run in-process on the GPU.
"""

from __future__ import annotations

import argparse

# 80 COCO class names (YOLO ordering; public dataset metadata)
COCO_CLASSES = (
    "person bicycle car motorcycle airplane bus train truck boat "
    "traffic_light fire_hydrant stop_sign parking_meter bench bird cat dog "
    "horse sheep cow elephant bear zebra giraffe backpack umbrella handbag "
    "tie suitcase frisbee skis snowboard sports_ball kite baseball_bat "
    "baseball_glove skateboard surfboard tennis_racket bottle wine_glass "
    "cup fork knife spoon bowl banana apple sandwich orange broccoli "
    "carrot hot_dog pizza donut cake chair couch potted_plant bed "
    "dining_table toilet tv laptop mouse remote keyboard cell_phone "
    "microwave oven toaster sink refrigerator book clock vase scissors "
    "teddy_bear hair_drier toothbrush"
).split()


def build_parser(description: str) -> argparse.ArgumentParser:
    # the JAX package's parser also turns on its XLA compilation cache
    # here; the port has no program cache, so that step is left out
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-i", "--input_path", required=True,
                   help="image file, image directory, or video file")
    p.add_argument("-m", "--media_type", default="image",
                   choices=("image", "video"))
    p.add_argument("-o", "--output_dir", default="output",
                   help="result directory (set to '' to disable saving)")
    p.add_argument("-t", "--detection_threshold", type=float, default=0.6)
    p.add_argument("-ox", "--onnx_path", default=None,
                   help="accepted for reference CLI compatibility "
                        "(`modules/utils.py:94-96`) and ignored: there is "
                        "no ONNX runtime here — the same architecture runs "
                        "as a PyTorch forward on the GPU")
    p.add_argument("-c", "--num_classes", type=int, default=80,
                   help="number of classes for the legacy w-NMS decode "
                        "(`modules/utils.py:100-102`); only consulted by "
                        "detect_yolo --legacy-nms")
    p.add_argument("-p", "--person_height", type=float, default=175.0,
                   help="subject height in cm for pixel->cm scaling")
    p.add_argument("-g", "--grpc_port", default=None,
                   help="serving-edge gRPC port or host:port — when set, "
                        "pose_est, detect_edet, and detect_yolo call the "
                        "named model over the tensor-level ModelInfer RPC "
                        "instead of running in-process (the reference's "
                        "Triton-port semantics); the remaining CLIs "
                        "ignore it")
    p.add_argument("--detector", default="efficientdet_lite4",
                   choices=("efficientdet_lite4", "efficientdet_lite0"))
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--debug", action="store_true", default=True)
    p.add_argument("--compile-cache-dir", default="",
                   help="accepted for the JAX package's command lines; "
                        "the port has no program cache (its kernels' "
                        "build cache persists anyway)")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted and ignored, as --compile-cache-dir")
    return p
