"""The system under test of arch `edet_lite_hrnet`: the port's top-down
`InferencePipeline`, an EfficientDet-Lite detector and an HRNet pose
slot (and, for the open-loop mixes, its `ServingApp` batcher), with the
weights the benchmark made or read.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def weights(config: dict, seed: int, device) -> Dict[str, dict]:
    """{"det": state, "pose": state} (float32 tensors) for both sides of
    the check: read from the configuration's file, the pose slot widened
    where the configuration says so (drawn from `seed` on `device`)."""
    from port_bench import bench
    from port_bench.reference import models, weights as ref_weights

    w = config["weights"]
    det, pose = ref_weights.read_compact(os.path.join(bench.ROOT, w["file"]))
    if w["pose"] == "widened_from_file":
        p = config["pose"]
        with torch.device("meta"):
            wide = models.HRNet(p["width"], p["num_keypoints"])
        shapes = {k: tuple(v.shape) for k, v in wide.state_dict().items()}
        pose = {k: v.cpu() for k, v in ref_weights.widen_hrnet(
            pose, shapes, seed, device).items()}
    elif w["pose"] != "file":
        raise ValueError(f"unknown pose weights {w['pose']!r}")
    return {"det": det, "pose": pose}


def pipeline(config: dict, states: Dict[str, dict], device):
    """The port's `InferencePipeline` for `config` on `device`."""
    from human_body_proportion_estimation_tpu_torch.models import (
        efficientdet,
        efficientnet_lite,
        hrnet,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        DetectorConfig,
        PipelineConfig,
        PoseConfig,
        ServeConfig,
    )

    det, pose = config["detector"], config["pose"]
    cfg = PipelineConfig(
        detector=DetectorConfig(
            name="efficientdet_lite4", input_height=det["input_height"],
            input_width=det["input_width"],
            person_class_id=det["person_class_id"],
            max_persons=det["max_persons"],
            iou_threshold=det["iou_threshold"], nms_top_k=det["nms_top_k"]),
        pose=PoseConfig(
            name=f"hrnet_w{pose['width']}", crop_height=pose["crop_height"],
            crop_width=pose["crop_width"],
            num_keypoints=pose["num_keypoints"],
            heatmap_height=pose["crop_height"] // 4,
            heatmap_width=pose["crop_width"] // 4,
            keypoint_thresholds=tuple(pose["keypoint_thresholds"])),
        serve=ServeConfig(**config.get("serve", {})),
        bbox_x_expand_divisor=det["x_expand_divisor"],
    )
    det_config = efficientdet.EfficientDetConfig(
        backbone=efficientnet_lite.EfficientNetLiteConfig(
            det["width_mult"], det["depth_mult"]),
        fpn_channels=det["fpn_channels"], fpn_repeats=det["fpn_repeats"],
        head_repeats=det["head_repeats"], num_classes=det["num_classes"])
    return InferencePipeline(
        cfg, det_state=states["det"], pose_state=states["pose"],
        device=device, det_config=det_config,
        pose_config=hrnet.HRNetConfig(width=pose["width"],
                                      num_keypoints=pose["num_keypoints"]),
        dtype=DTYPES[config["precision"]["trunks"]])


def serving_app(pipe):
    """The server's `ServingApp` over `pipe`: its batcher (the native C++
    core at the server's defaults) is what the open-loop mixes submit to.
    """
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )

    return ServingApp(pipe)


def record_forwards(pipe, pool: np.ndarray, forwards: list):
    """Wrap `pipe.infer_serving` to note, for every forward, (start, end,
    rows run, pool indices, packed rows): rows run is the padded batch the
    program ran (read by a forward pre-hook on its serving program), the
    indices those of the pool images it was given. Returns the hook's
    handle; `handle.remove()` ends the noting of rows."""
    rows = threading.local()

    def pre_hook(module, args):
        rows.n = int(args[0].shape[0])

    handle = pipe.program.register_forward_pre_hook(pre_hook)
    plain = pipe.infer_serving
    base, size = pool.ctypes.data, pool[0].nbytes

    def timed(images, *args, **kwargs):
        t0 = time.perf_counter()
        out = plain(images, *args, **kwargs)
        idx = [(im.ctypes.data - base) // size for im in images]
        forwards.append((t0, time.perf_counter(), rows.n, idx, out))
        return out

    pipe.infer_serving = timed
    return handle


@torch.no_grad()
def detector_outputs(pipe, images: np.ndarray):
    """The program's detector on uint8 images [B, H, W, 3] at its input
    size, as its serving forward runs it: (best_logit [B, N],
    person_logit [B, N], box_regs [B, N, 4]), before its NMS. For the
    readings' look at a slot that one side keeps and the other not."""
    x = torch.from_numpy(np.ascontiguousarray(images)).to(pipe.device)
    return pipe.program.backend.detector(x.float())
