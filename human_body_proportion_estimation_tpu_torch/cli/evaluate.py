"""Evaluate a pipeline against COCO-format annotations: person-box mAP and
keypoint OKS-AP (and PCK), printed as one JSON object (the port of the
JAX package's `cli/evaluate.py`, on the GPU).

    python3 -m human_body_proportion_estimation_tpu_torch.cli.evaluate \\
        --annotations person_keypoints_val.json --images-dir val2017/ \\
        --detector efficientdet_lite4

The reference has no evaluation entry point; its accuracy claim is the
upstream zoos' published COCO numbers (SURVEY §6). The flags are the JAX
CLI's. `--detector` defaults to `ssd_mobilenet` as there (the real
weights of the reference's ssd.tflite; exit code 2 naming the file when
it is absent); `--checkpoint-dir` reads an Orbax checkpoint
(`cli/common.build_pipeline`, `models/orbax_store`);
`--compile-cache-dir` and `--no-compile-cache` say where the CUDA kernels
are built and found (`utils/compile_cache`).

Caveat (by design, shared with the reference): the fused pipeline keeps
at most `max_persons` (3) slots an image, the reference's top-3 ensemble
contract (`models/conv.py:36-40`), so AP on images with more people is a
lower bound. Evaluation runs with detection threshold 0.05 so the AP
sweep sees low-confidence detections.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from human_body_proportion_estimation_tpu_torch.utils import compile_cache


def load_coco(path: str):
    """COCO-format dict -> (images [(id, file_name)], per-image gt:
    boxes xyxy, keypoints [M,17,2], visible [M,17], areas [M])."""
    with open(path) as f:
        coco = json.load(f)
    person_cat = {
        c["id"] for c in coco.get("categories", [])
        if c.get("name") == "person"
    } or {1}
    gt = defaultdict(lambda: {"boxes": [], "kps": [], "vis": [],
                              "areas": []})
    for a in coco["annotations"]:
        if a.get("category_id") not in person_cat or a.get("iscrowd"):
            continue
        x, y, w, h = a["bbox"]
        g = gt[a["image_id"]]
        g["boxes"].append([x, y, x + w, y + h])
        g["areas"].append(a.get("area", w * h))
        kp = np.asarray(a.get("keypoints", [0] * 51),
                        np.float32).reshape(-1, 3)
        g["kps"].append(kp[:, :2])
        g["vis"].append(kp[:, 2] > 0)
    images = [(im["id"], im["file_name"]) for im in coco["images"]]
    return images, gt


def run_eval(
    pipe,
    annotations: str,
    images_dir: str,
    limit: int = 0,
    batch_size: int = 8,
) -> dict:
    """Evaluate an already-built pipeline (`InferencePipeline`) over a
    COCO-format val set."""
    import cv2

    from human_body_proportion_estimation_tpu_torch.metrics import (
        detection_ap,
        oks_ap,
        pck,
    )

    images, gt = load_coco(annotations)
    if limit:
        images = images[:limit]

    det_preds, det_gts = [], []
    kp_preds, kp_gts = [], []
    pck_scores = []
    n_missing = 0
    for start in range(0, len(images), batch_size):
        chunk = images[start:start + batch_size]
        frames, ids = [], []
        for img_id, fname in chunk:
            bgr = cv2.imread(os.path.join(images_dir, fname))
            if bgr is None:
                n_missing += 1
                continue
            frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
            ids.append(img_id)
        if not frames:
            continue
        out = pipe.infer_images(frames, person_heights=175.0,
                                det_threshold=0.05)
        for i, img_id in enumerate(ids):
            valid = np.asarray(out.person_valid[i], bool)
            yxyx = np.asarray(out.boxes_orig[i], np.float32)[valid]
            boxes = yxyx[:, [1, 0, 3, 2]]  # -> xyxy like COCO gt
            scores = np.asarray(out.det_scores[i], np.float32)[valid]
            g = gt[img_id]
            g_boxes = np.asarray(g["boxes"], np.float32).reshape(-1, 4)
            det_preds.append((boxes, scores))
            det_gts.append(g_boxes)

            if g["kps"]:
                kps = np.asarray(out.keypoints[i], np.float32)[valid]
                kp_preds.append((kps, scores))
                g_kps = np.stack(g["kps"])
                g_vis = np.stack(g["vis"])
                g_area = np.asarray(g["areas"], np.float32)
                kp_gts.append((g_kps, g_vis, g_area))
                # PCK of prediction slot p against gt slot p (index
                # aligned after both are filtered to persons), bbox-
                # diagonal normalization
                m = min(len(kps), len(g_kps))
                if m:
                    diag = np.linalg.norm(
                        g_boxes[:m, 2:] - g_boxes[:m, :2], axis=-1
                    )
                    v = pck(kps[:m], g_kps[:m], g_vis[:m], diag,
                            threshold=0.1)
                    if np.isfinite(v):
                        pck_scores.append(v)

    det = detection_ap(det_preds, det_gts)
    result = {
        "weights": dict(pipe.weights_origin),
        "images": len(det_preds),
        "missing_files": n_missing,
        "box_mAP": det["mAP"], "box_AP50": det["AP50"],
        "box_AP75": det["AP75"],
    }
    if kp_preds:
        kp = oks_ap(kp_preds, kp_gts)
        result.update({
            "kp_mAP": kp["mAP"], "kp_AP50": kp["AP50"],
            "kp_AP75": kp["AP75"],
            "PCK@0.1diag": (float(np.mean(pck_scores))
                            if pck_scores else float("nan")),
        })
    return result


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, option for option."""
    parser = argparse.ArgumentParser(
        description="COCO-protocol evaluation of the fused pipeline "
                    "(PyTorch/CUDA)"
    )
    parser.add_argument("--annotations", required=True,
                        help="COCO-format JSON (bbox and/or keypoints)")
    parser.add_argument("--images-dir", required=True)
    parser.add_argument(
        "--detector", default="ssd_mobilenet",
        choices=["efficientdet_lite4", "efficientdet_lite0",
                 "ssd_mobilenet", "yolov5s", "yolov5m"],
        help="default ssd_mobilenet, as the JAX CLI (the real weights of "
             "the reference's ssd.tflite; exits 2 naming the file when it "
             "is absent)",
    )
    parser.add_argument("--checkpoint-dir", default=None,
                        help="orbax checkpoint dir (the SSD detector "
                             "takes only its pose slot)")
    parser.add_argument("--limit", type=int, default=0,
                        help="evaluate only the first N images (0 = all)")
    parser.add_argument("--batch-size", type=int, default=8)
    compile_cache.add_flags(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from human_body_proportion_estimation_tpu_torch.cli.common import (
        build_pipeline,
    )
    compile_cache.apply_flags(args)

    pipe = build_pipeline(args)
    result = {"detector": args.detector}
    result.update(run_eval(
        pipe, args.annotations, args.images_dir,
        limit=args.limit, batch_size=args.batch_size,
    ))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
