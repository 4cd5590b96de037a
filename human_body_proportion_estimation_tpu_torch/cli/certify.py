"""Production-shape synthetic-supervised end-to-end certification (the port
of the JAX package's `cli/certify.py`, on the GPU).

  1. trains HRNet-W32 @ 384x288 (pose) and EfficientDet-Lite0 or -Lite4 @
     480x640 (person detection) on the card, on rendered scenes whose
     keypoints, tight person box and true segment lengths in cm are
     analytic (`training/synthetic.py`);
  2. writes the trained states (`models/weights.save_training_checkpoint`,
     f32 `.npz` under --workdir/ckpt) and reloads them through the serving
     load path (`flax_to_state_dict` -> `InferencePipeline`), checking that
     the reload equals the trained state;
  3. drives the full served stack (multipart HTTP POST -> batcher -> the
     fused forward with its head-score, NMS and decode kernels -> cm) with
     held-out renders and compares every returned cm segment with analytic
     truth;
  4. fills the accuracy table over a synthetic-COCO val set
     (`cli/evaluate.run_eval`);
  5. also sweeps the real-weight SSD detector (the reference's checked-in
     ssd.tflite) before the trained pose model, reported but not gated
     (`served_ssd`).

    python3 -m human_body_proportion_estimation_tpu_torch.cli.certify \\
        --det-arch lite4 --workdir OUT --emit-compact OUT/certified.npz

The flags are the JAX CLI's, plus `--cpu` (the device, as in
`cli/detect_yolo`; f32 there, bf16 on the GPU). `--smoke` shrinks shapes
and budgets as in JAX (tiny models, marker scenes; its detector's FPN is
32 wide where JAX's is 24, because the head-score kernel takes widths in
multiples of 16) but does not pick the device. `--detector ssd` trains
no detector and serves the SSD (the real weights of the reference's
ssd.tflite) as the primary sweep; with the file absent it exits 2 naming
the file before anything is built. The secondary real-SSD sweep runs
where the file is; where it is absent the report records
`served_ssd: {"skipped": "<path> absent"}` (JAX would fail there, after
the training). A bare `--emit-compact` exits 2 (JAX writes the reference
package's committed checkpoint then: give a path). `--compile-cache-dir`
and `--no-compile-cache` say where the CUDA kernels are built and found
(`utils/compile_cache`).

Exit status is non-zero when a gate fails (detection and segment
coverage, mean / p95 served-cm error vs analytic truth).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np

from human_body_proportion_estimation_tpu_torch.utils import compile_cache


# --------------------------------------------------------------------- #
# synthetic-COCO val set writer (consumed by cli/evaluate.run_eval)


def write_coco_valset(scenes, out_dir: str) -> tuple[str, str]:
    """Render a COCO-format person-keypoints val set from scenes.

    Returns (annotations_json_path, images_dir). v=2 (visible) for every
    keypoint: the renderer draws frontal standing figures with no
    occlusion."""
    import cv2

    images_dir = os.path.join(out_dir, "images")
    os.makedirs(images_dir, exist_ok=True)
    images, annotations = [], []
    for i, sc in enumerate(scenes):
        fname = f"scene_{i:04d}.png"
        cv2.imwrite(os.path.join(images_dir, fname), sc.image[..., ::-1])
        h, w = sc.image.shape[:2]
        images.append({"id": i, "file_name": fname,
                       "height": h, "width": w})
        x1, y1, x2, y2 = [float(v) for v in sc.bbox_xyxy]
        kps = []
        for k in range(17):
            kps += [float(sc.keypoints[k, 0]), float(sc.keypoints[k, 1]),
                    2 if sc.visible[k] else 0]
        annotations.append({
            "id": i, "image_id": i, "category_id": 1,
            "bbox": [x1, y1, x2 - x1, y2 - y1],
            "area": (x2 - x1) * (y2 - y1),
            "keypoints": kps, "num_keypoints": int(sc.visible.sum()),
            "iscrowd": 0,
        })
    ann_path = os.path.join(out_dir, "annotations.json")
    with open(ann_path, "w") as f:
        json.dump({
            "images": images,
            "annotations": annotations,
            "categories": [{"id": 1, "name": "person"}],
        }, f)
    return ann_path, images_dir


# --------------------------------------------------------------------- #
# sweeps


def detector_val_report(pipeline, scenes, det_threshold: float) -> dict:
    """Direct (pre-HTTP) detector quality on held-out scenes: coverage,
    IoU, and the relative box-HEIGHT error that bounds the cm scale
    (pixel->cm = declared_height / detected box height, reference
    `person_det_pose_edet4_trtserver.py:166-168`)."""
    ious, herrs, scores, miss = [], [], [], 0
    for sc in scenes:
        out = pipeline.infer_images([sc.image],
                                    det_threshold=det_threshold)
        valid = np.asarray(out.person_valid[0], bool)
        if not valid.any():
            miss += 1
            continue
        j = int(np.argmax(np.where(valid, np.asarray(out.det_scores[0]),
                                   -1.0)))
        by1, bx1, by2, bx2 = np.asarray(out.boxes_orig[0][j], np.float64)
        # undo the serving x-expand (w//17 each side) to compare against
        # the tight analytic box
        bx1 += pipeline.config.x_expand
        bx2 -= pipeline.config.x_expand
        x1, y1, x2, y2 = sc.bbox_xyxy.astype(np.float64)
        ix = max(0.0, min(bx2, x2) - max(bx1, x1))
        iy = max(0.0, min(by2, y2) - max(by1, y1))
        inter = ix * iy
        union = ((bx2 - bx1) * (by2 - by1) + (x2 - x1) * (y2 - y1)
                 - inter)
        ious.append(inter / max(union, 1e-6))
        herrs.append(((by2 - by1) - (y2 - y1)) / (y2 - y1))
        scores.append(float(out.det_scores[0][j]))
    return {
        "scenes": len(scenes),
        "missed": miss,
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        "median_abs_rel_height_err": (
            float(np.median(np.abs(herrs))) if herrs else 1.0),
        "max_abs_rel_height_err": (
            float(np.max(np.abs(herrs))) if herrs else 1.0),
        "mean_score": float(np.mean(scores)) if scores else 0.0,
    }


def serve_sweep(pipeline, scenes, det_threshold: float) -> dict:
    """Drive the full HTTP stack against held-out scenes; compare every
    served cm segment to analytic truth (scaled to the declared integer
    height) and to the argmax-quantized truth."""
    import cv2

    from human_body_proportion_estimation_tpu_torch.ops.proportions import (
        NOT_VISIBLE,
        SEGMENT_NAMES,
    )
    from human_body_proportion_estimation_tpu_torch.serve.client import (
        HttpClient,
    )
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
        create_server,
    )
    from human_body_proportion_estimation_tpu_torch.training.certify import (
        quantized_truth_cm,
    )
    from human_body_proportion_estimation_tpu_torch.training.synthetic import (
        segment_truth_cm,
    )

    app = ServingApp(pipeline)
    server = create_server(app, "127.0.0.1", 0)
    client = HttpClient("127.0.0.1", server.server_address[1],
                        timeout=1800)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    errs_analytic, errs_quant = [], []
    per_segment: dict[str, list] = {n: [] for n in SEGMENT_NAMES}
    latencies = []
    n_detected = 0
    segs_served = 0
    segs_possible = 0
    try:
        for sc in scenes:
            ok, png = cv2.imencode(".png", sc.image[..., ::-1])
            assert ok
            declared = int(round(sc.height_cm))
            scale = declared / sc.height_cm
            t0 = time.perf_counter()
            data = client.estimate_image(png.tobytes(), declared,
                                         det_threshold)
            latencies.append(time.perf_counter() - t0)
            truth, t_vis = segment_truth_cm(sc)
            q_truth, q_vis = quantized_truth_cm(sc, pipeline.config)
            if data.get("code") != "success":
                continue
            served = data["body_proportion_lengths_(cm)"]
            n_detected += 1
            for i, name in enumerate(SEGMENT_NAMES):
                if not (t_vis[i] and q_vis[i]):
                    continue
                segs_possible += 1
                v = served.get(name)
                if v is None or v == NOT_VISIBLE:
                    continue
                segs_served += 1
                ea = abs(v - truth[i] * scale)
                eq = abs(v - q_truth[i] * scale)
                errs_analytic.append(ea)
                errs_quant.append(eq)
                per_segment[name].append(ea)
    finally:
        server.shutdown()
        server.server_close()
        app.shutdown()
    ea = np.asarray(errs_analytic, np.float64)
    return {
        "scenes": len(scenes),
        "detected": n_detected,
        "segments_served": segs_served,
        "segments_possible": segs_possible,
        "mean_abs_cm_err": float(ea.mean()) if ea.size else float("inf"),
        "median_abs_cm_err": (float(np.median(ea)) if ea.size
                              else float("inf")),
        "p95_abs_cm_err": (float(np.percentile(ea, 95)) if ea.size
                           else float("inf")),
        "max_abs_cm_err": float(ea.max()) if ea.size else float("inf"),
        "mean_abs_cm_err_vs_quantized": (
            float(np.mean(errs_quant)) if errs_quant else float("inf")),
        "per_segment_mean_cm_err": {
            n: float(np.mean(v)) for n, v in per_segment.items() if v
        },
        "mean_http_latency_s": float(np.mean(latencies)),
    }


def pose_val_report(model, pose_state, scenes, cfg) -> dict:
    """Direct pose quality on held-out crops (tight boxes, no jitter): mean
    / p95 / max keypoint error in heatmap px after the argmax decode (the
    decode kernel on the GPU), with `pose_state` loaded into `model`."""
    import torch

    from human_body_proportion_estimation_tpu_torch.ops import kernels
    from human_body_proportion_estimation_tpu_torch.training.certify import (
        pose_crop_arrays,
    )

    crops, kp_hm, vis, _ = pose_crop_arrays(scenes, cfg, seed=99,
                                            box_jitter=0.0)
    model.load_state_dict(pose_state, strict=True)
    model.eval()
    dev = next(model.parameters()).device
    errs = []
    with torch.no_grad():
        for s in range(0, len(crops), 8):
            x = torch.from_numpy(crops[s:s + 8]).to(dev)
            hm = model(x.permute(0, 3, 1, 2).float() / 255.0)
            xy, _ = kernels.decode_heatmaps(hm.contiguous())
            e = np.linalg.norm(xy.cpu().numpy() - kp_hm[s:s + 8],
                               axis=-1)[vis[s:s + 8]]
            errs.append(e)
    e = np.concatenate(errs)
    return {
        "crops": len(crops),
        "mean_kp_err_hm_px": float(e.mean()),
        "p95_kp_err_hm_px": float(np.percentile(e, 95)),
        "max_kp_err_hm_px": float(e.max()),
    }


# --------------------------------------------------------------------- #


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, option for option, and `--cpu`."""
    parser = argparse.ArgumentParser(
        description="train-on-synthetic -> serve -> assert cm "
                    "(production shapes, PyTorch/CUDA)"
    )
    parser.add_argument("--workdir", default="/tmp/hbpe_certify")
    parser.add_argument("--train-scenes", type=int, default=640)
    parser.add_argument("--det-scenes", type=int, default=256)
    parser.add_argument("--val-scenes", type=int, default=24)
    parser.add_argument("--coco-scenes", type=int, default=64)
    parser.add_argument("--pose-steps", type=int, default=4000)
    parser.add_argument("--pose-batch", type=int, default=16)
    parser.add_argument("--pose-lr", type=float, default=1e-3)
    parser.add_argument("--pose-fg-weight", type=float, default=12.0,
                        help="peak-pixel MSE up-weight (1 + w*target): "
                             "plain MSE leaves heatmap amplitudes at "
                             "0.1-0.3, under the reference's serving "
                             "gates (up to 0.46)")
    parser.add_argument("--no-calibrate", action="store_true",
                        help="skip the per-keypoint head-amplitude gate "
                             "calibration after pose training")
    parser.add_argument("--det-steps", type=int, default=1600)
    parser.add_argument("--det-batch", type=int, default=8)
    parser.add_argument("--det-lr", type=float, default=5e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--detector", default="trained", choices=("trained", "ssd"),
        help="primary detection slot: 'trained' trains EfficientDet on the "
             "renders; 'ssd' skips detector training and serves the "
             "real-weight SSD (reference ssd.tflite; exits 2 naming the "
             "file when it is absent)",
    )
    parser.add_argument(
        "--det-arch", default="lite0", choices=("lite0", "lite4"),
        help="trained-detector architecture: lite0 (fast) or lite4, the "
             "reference's production detector",
    )
    parser.add_argument("--det-threshold", type=float, default=0.35,
                        help="serving form threshold for the trained "
                             "detector (focal-trained sigmoid scores run "
                             "lower than the reference's 0.70 default)")
    parser.add_argument("--tolerance-cm", type=float, default=4.0,
                        help="gate: mean |served - analytic| cm")
    parser.add_argument("--reuse-checkpoint", action="store_true",
                        help="skip training; certify the checkpoint "
                             "already in --workdir/ckpt")
    parser.add_argument("--skip-coco", action="store_true")
    parser.add_argument("--skip-ssd", action="store_true",
                        help="skip the secondary real-SSD + trained-pose "
                             "sweep (recorded as skipped when ssd.tflite is "
                             "absent)")
    parser.add_argument("--smoke", action="store_true",
                        help="wiring check: reduced shapes, tiny models, "
                             "marker scenes (on the CPU with --cpu)")
    compile_cache.add_flags(parser)
    parser.add_argument(
        "--emit-compact", nargs="?", const="default", default="",
        metavar="PATH",
        help="on a CERTIFIED run, also write the compact .npz checkpoint "
             "(models/weights.save_compact_checkpoint), which the JAX "
             "package reads too, to PATH; a bare --emit-compact exits 2 "
             "(JAX overwrites its committed checkpoint there)",
    )
    parser.add_argument("--cpu", action="store_true",
                        help="train and serve on the CPU in f32 (default: "
                             "the GPU, bf16)")
    return parser


def check_not_ported(parser, args) -> None:
    """Exit 2 (argparse's usage error) for the options this run cannot
    serve: `--detector ssd` without ssd.tflite (and not `--smoke`, as in
    JAX), a bare `--emit-compact`."""
    from human_body_proportion_estimation_tpu_torch.cli.common import (
        option_problems,
    )

    if args.detector == "ssd":
        problems = option_problems("ssd_mobilenet", None)
        if problems:
            parser.error("; ".join(problems))
        if args.smoke:
            parser.error("--detector ssd needs production shapes "
                         "(not --smoke)")
    if args.emit_compact == "default":
        parser.error("--emit-compact needs a PATH: without one the JAX CLI "
                     "overwrites the reference package's committed "
                     "checkpoint")


def device_and_dtype(use_cpu: bool):
    """("cpu", f32) or ("cuda", bf16); an unusable device fails here."""
    import torch

    device = torch.device("cpu" if use_cpu else "cuda")
    torch.empty(0, device=device)
    if device.type == "cuda":
        # the crop, the heads and the losses are f32: keep TF32 off, as
        # the JAX package computes them in full f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device, torch.float32 if use_cpu else torch.bfloat16


def reload_state(path: str, trained=None) -> dict:
    """A training checkpoint through the serving load path
    (`load_training_checkpoint` -> `flax_to_state_dict`); when the state
    just trained is given, the reload must equal it."""
    import torch

    from human_body_proportion_estimation_tpu_torch.models import weights

    tree, _ = weights.load_training_checkpoint(path)
    state = weights.flax_to_state_dict(tree)
    if trained is not None:
        bad = [k for k, v in trained.items()
               if not torch.equal(state[k], v.to(state[k].dtype))]
        if bad or set(state) != set(trained):
            raise RuntimeError(f"reloaded checkpoint {path} differs from "
                               f"the trained state: {bad[:5]}")
    return state


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    check_not_ported(parser, args)

    import torch

    compile_cache.apply_flags(args)

    from human_body_proportion_estimation_tpu_torch.cli.evaluate import (
        run_eval,
    )
    from human_body_proportion_estimation_tpu_torch.models import weights
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
        EFFICIENTDET_LITE0,
        EFFICIENTDET_LITE4,
        EfficientDet,
        EfficientDetConfig,
    )
    from human_body_proportion_estimation_tpu_torch.models.efficientnet_lite import (  # noqa: E501
        EfficientNetLiteConfig,
    )
    from human_body_proportion_estimation_tpu_torch.models.hrnet import (
        HRNET_W32,
        HRNet,
        HRNetConfig,
    )
    from human_body_proportion_estimation_tpu_torch.models.layers import (
        init_flax_default,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )
    from human_body_proportion_estimation_tpu_torch.training import (
        certify as C,
    )
    from human_body_proportion_estimation_tpu_torch.training.detection import (
        init_det_flax,
    )
    from human_body_proportion_estimation_tpu_torch.training.synthetic import (
        generate_scene,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        DetectorConfig,
        PipelineConfig,
        PoseConfig,
        ServeConfig,
    )

    device, dtype = device_and_dtype(args.cpu)
    t_start = time.time()
    os.makedirs(args.workdir, exist_ok=True)
    ckpt_dir = os.path.join(args.workdir, "ckpt")

    if args.smoke:
        cfg = PipelineConfig(
            detector=DetectorConfig(input_height=160, input_width=128,
                                    name="efficientdet_lite0"),
            pose=PoseConfig(crop_height=64, crop_width=32,
                            heatmap_height=16, heatmap_width=8),
            serve=ServeConfig(max_batch=4, batch_timeout_ms=5),
        )
        pose_config = HRNetConfig(
            width=16, stage_modules=(1, 1, 1), blocks_per_branch=2,
            stem_channels=16, bottleneck_channels=16,
        )
        # a sub-lite0 backbone (width 0.25, ~1 block a stage), as in JAX
        det_config = EfficientDetConfig(
            backbone=EfficientNetLiteConfig(0.25, 0.05),
            fpn_channels=32, fpn_repeats=1, head_repeats=1, num_classes=8,
        )
        scene_kwargs = dict(fixed_pose=True, keypoint_markers=True)
        args.train_scenes = min(args.train_scenes, 32)
        args.det_scenes = min(args.det_scenes, 32)
        args.val_scenes = min(args.val_scenes, 4)
        args.coco_scenes = min(args.coco_scenes, 8)
        args.pose_steps = min(args.pose_steps, 400)
        args.det_steps = min(args.det_steps, 300)
        args.pose_batch = 8
        args.pose_lr = 2e-3
        args.det_lr = 1e-3
        args.tolerance_cm = max(args.tolerance_cm, 8.0)
    else:
        cfg = PipelineConfig(
            detector=DetectorConfig(name=f"efficientdet_{args.det_arch}"))
        pose_config = HRNET_W32
        det_config = (EFFICIENTDET_LITE0 if args.det_arch == "lite0"
                      else EFFICIENTDET_LITE4)
        scene_kwargs = {}
    pose_model = HRNet(pose_config, dtype=dtype).to(device)
    det_model = EfficientDet(
        det_config, dtype=dtype,
        person_class0=cfg.detector.person_class_id - 1).to(device)

    img_hw = (cfg.detector.input_height, cfg.detector.input_width)
    report: dict = {
        "mode": "smoke" if args.smoke else "chip",
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "img_hw": list(img_hw),
        "crop_hw": [cfg.pose.crop_height, cfg.pose.crop_width],
    }

    def log(msg):
        print(f"[certify +{time.time() - t_start:7.1f}s] {msg}",
              flush=True)

    rng = np.random.default_rng(args.seed)
    log(f"rendering {args.train_scenes} train / {args.val_scenes} val "
        f"scenes at {img_hw}")
    train_scenes = [generate_scene(rng, img_hw, **scene_kwargs)
                    for _ in range(args.train_scenes)]
    val_rng = np.random.default_rng(args.seed + 10_000)
    val_scenes = [generate_scene(val_rng, img_hw, **scene_kwargs)
                  for _ in range(args.val_scenes)]

    det_path = os.path.join(ckpt_dir, "det.npz")
    pose_path = os.path.join(ckpt_dir, "pose.npz")
    det_state = pose_state = None
    if args.reuse_checkpoint:
        log(f"reusing checkpoint {ckpt_dir}")
    else:
        # ------------------- pose training (on the device) ---------------
        crops, kp_hm, vis, _ = C.pose_crop_arrays(
            train_scenes, cfg, seed=args.seed + 1,
            box_jitter=0.0 if args.smoke else 0.08,
        )
        log(f"pose dataset {crops.shape} "
            f"({crops.nbytes / 1e6:.0f} MB on the device); training "
            f"{args.pose_steps} steps @ batch {args.pose_batch}")
        init_flax_default(pose_model, args.seed)
        t0 = time.perf_counter()
        pose_state, pose_losses = C.train_pose_resident(
            pose_model, crops, kp_hm, vis,
            steps=args.pose_steps, batch=args.pose_batch,
            learning_rate=args.pose_lr, seed=args.seed,
            chunk=100, sigma=1.5 if args.smoke else 2.0,
            log_fn=lambda s, z: log(f"  pose step {s}: loss {z:.5f}"),
            # constant rate: the JAX package's chip run measured warmup +
            # cosine regressing pose val 5x at this budget
            cosine=False,
            fg_weight=args.pose_fg_weight,
        )
        log(f"pose training: {args.pose_steps * args.pose_batch / (time.perf_counter() - t0):.1f} imgs/s")  # noqa: E501
        report["pose_loss_first"] = pose_losses[0]
        report["pose_loss_last"] = pose_losses[-1]

        if not args.no_calibrate:
            # gate-amplitude calibration on a training-crop slice (the
            # val scenes stay held out for the accuracy numbers)
            cal = C.pose_peak_scores(pose_model, crops[:256])
            pose_state, gamma = C.calibrate_pose_gates(
                pose_state, cal, vis[:256], cfg.pose.keypoint_thresholds)
            report["gate_gamma"] = [round(float(g), 3) for g in gamma]
            log(f"gate calibration gamma: {report['gate_gamma']}")

        # ------------------- detector training (on the device) -----------
        # (none for --detector ssd: the SSD serves its own real weights)
        if args.detector == "trained":
            det_subset = train_scenes[:args.det_scenes]
            imgs, gt_boxes, gt_classes, gt_valid = C.det_arrays(det_subset)
            log(f"det dataset {imgs.shape} ({imgs.nbytes / 1e6:.0f} MB); "
                f"training {args.det_steps} steps @ batch "
                f"{args.det_batch}")
            init_det_flax(det_model, args.seed)
            t0 = time.perf_counter()
            det_state, det_losses = C.train_det_resident(
                det_model, imgs, gt_boxes, gt_classes, gt_valid,
                steps=args.det_steps, batch=args.det_batch,
                learning_rate=args.det_lr, seed=args.seed,
                chunk=100,
                log_fn=lambda s, z: log(f"  det step {s}: loss {z:.5f}"),
                cosine=not args.smoke,
            )
            log(f"det training: {args.det_steps * args.det_batch / (time.perf_counter() - t0):.1f} imgs/s")  # noqa: E501
            report["det_loss_first"] = det_losses[0]
            report["det_loss_last"] = det_losses[-1]
            weights.save_training_checkpoint(det_path, det_state,
                                             args.det_steps)
        weights.save_training_checkpoint(pose_path, pose_state,
                                         args.pose_steps)
        log(f"checkpoint saved to {ckpt_dir}")

    # ------------------- reload via the serving load path ----------------
    det_r = (reload_state(det_path, det_state) if args.detector == "trained"
             else None)
    pose_r = reload_state(pose_path, pose_state)

    # direct pose sanity on held-out crops (fail fast pre-serving)
    report["pose_val"] = pose_val_report(pose_model, pose_r, val_scenes,
                                         cfg)
    log(f"pose val: {report['pose_val']}")

    if args.detector == "ssd":
        pipeline = InferencePipeline(
            config=PipelineConfig(
                detector=DetectorConfig(name="ssd_mobilenet")),
            detector="ssd_mobilenet", pose_state=pose_r, device=device,
            dtype=dtype)
        args.skip_ssd = True  # it IS the primary sweep
    else:
        pipeline = InferencePipeline(
            config=cfg, det_state=det_r, pose_state=pose_r, device=device,
            det_config=det_config, pose_config=pose_config, dtype=dtype,
        )
    del pose_model, det_model

    report["det_val"] = detector_val_report(pipeline, val_scenes,
                                            args.det_threshold)
    log(f"det val: {report['det_val']}")

    # ------------------- the served-cm certification ---------------------
    log("serving sweep (" + ("real-weight SSD" if args.detector == "ssd" else
                             f"trained EfficientDet-{args.det_arch.title()}")
        + " + trained HRNet)")
    report["served"] = serve_sweep(pipeline, val_scenes,
                                   args.det_threshold)
    log(f"served: {report['served']}")

    # ------------------- accuracy table ----------------------------------
    if not args.skip_coco:
        coco_rng = np.random.default_rng(args.seed + 20_000)
        coco_scenes = [generate_scene(coco_rng, img_hw, **scene_kwargs)
                       for _ in range(args.coco_scenes)]
        ann, imdir = write_coco_valset(
            coco_scenes, os.path.join(args.workdir, "coco_val")
        )
        log(f"COCO-protocol eval over {args.coco_scenes} scenes")
        report["coco_eval"] = run_eval(pipeline, ann, imdir, batch_size=8)
        log(f"coco: {report['coco_eval']}")

    # ------------------- secondary: real-SSD + trained pose --------------
    if not (args.skip_ssd or args.smoke):
        from human_body_proportion_estimation_tpu_torch.models.tflite_import import (  # noqa: E501
            DEFAULT_TFLITE_PATH,
        )

        if os.path.exists(DEFAULT_TFLITE_PATH):
            log("secondary sweep: real-weight SSD + trained pose")
            ssd_pipe = InferencePipeline(
                config=PipelineConfig(
                    detector=DetectorConfig(name="ssd_mobilenet")),
                detector="ssd_mobilenet", pose_state=pose_r, device=device,
                dtype=dtype)
            report["served_ssd"] = serve_sweep(ssd_pipe, val_scenes,
                                               det_threshold=0.40)
            log(f"served (ssd): {report['served_ssd']}")
        else:
            # kept on purpose: after the training, where JAX would raise
            report["served_ssd"] = {
                "skipped": f"{DEFAULT_TFLITE_PATH} absent"}
            log(f"secondary sweep (real-weight SSD + trained pose) "
                f"skipped: {DEFAULT_TFLITE_PATH} absent")

    # ------------------- gates -------------------------------------------
    served = report["served"]
    gates = {
        "detection_coverage": served["detected"] >= 0.9 * len(val_scenes),
        "segment_coverage": (
            served["segments_served"]
            >= 0.85 * max(served["segments_possible"], 1)),
    }
    if args.smoke:
        # smoke certifies the CLI's wiring (train -> checkpoint -> serve ->
        # measure -> report), not accuracy: the accuracy gates bind on
        # the production-shape run
        gates["pose_converged"] = (
            report.get("pose_loss_last", 0.0)
            < 0.25 * report.get("pose_loss_first", 1.0))
        if "det_loss_first" in report:
            gates["det_converged"] = (
                report["det_loss_last"] < 0.1 * report["det_loss_first"])
    else:
        gates["mean_cm_err"] = (
            served["mean_abs_cm_err"] <= args.tolerance_cm)
        gates["p95_cm_err"] = (
            served["p95_abs_cm_err"] <= 2.0 * args.tolerance_cm)
    report["gates"] = gates
    report["certified"] = all(gates.values())
    report["wall_s"] = time.time() - t_start

    if args.emit_compact and report["certified"]:
        weights.save_compact_checkpoint(args.emit_compact, det_r, pose_r)
        report["compact_checkpoint"] = args.emit_compact
        log(f"compact certified checkpoint written to {args.emit_compact} "
            f"({os.path.getsize(args.emit_compact) / 1e6:.1f} MB)")
    elif args.emit_compact:
        log("certification FAILED — compact checkpoint NOT written")

    with open(os.path.join(args.workdir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return 0 if report["certified"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
