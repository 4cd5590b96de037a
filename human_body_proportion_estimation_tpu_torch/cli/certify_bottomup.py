"""Bottom-up (HigherHRNet + AE grouping) synthetic-supervised
certification: train on multi-person renders, serve, assert cm (the port
of the JAX package's `cli/certify_bottomup.py`, on the GPU).

  1. trains HigherHRNet (W32 trunk) @ 512x512 on the card on rendered
     multi-person scenes (1-3 disjoint figures) with the joint
     peak-weighted heatmap MSE + AE grouping loss (`training/bottomup.py`);
  2. writes the trained state as the JAX package's Orbax pose checkpoint
     (`models/weights.save_pose_checkpoint`, --workdir/ckpt/pose) and
     reloads it through the serving load path (`load_pose_checkpoint`),
     checking that the reload equals the trained state;
  3. direct sweep: `BottomUpPipeline.infer_images` on held-out
     multi-person scenes, IoU-matching predicted persons to truth, and
     per-person per-segment cm against the PATH truth
     (`training/certify_bottomup.bottomup_path_truth_cm`);
  4. HTTP sweep: the full served edge on held-out single-person scenes.

    python3 -m human_body_proportion_estimation_tpu_torch.cli.certify_bottomup \\
        --workdir OUT --emit-compact OUT/certified_higherhrnet.npz

The flags are the JAX CLI's, plus `--cpu` (f32 on the CPU; bf16 on the
GPU by default). `--smoke` shrinks shapes and budgets as in JAX; a bare
`--emit-compact` exits 2 (JAX writes the reference package's checkpoint
then: give a path); `--compile-cache-dir` / `--no-compile-cache` say
where the native batcher core is built and found (`utils/compile_cache`).
The bottom-up path launches
none of the port's CUDA kernels, as JAX's reaches no Pallas kernel.

Exit status is non-zero when a gate fails (person coverage, segment
coverage, mean / p95 served-cm error vs path truth).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np

from human_body_proportion_estimation_tpu_torch.utils import compile_cache


def bottomup_direct_sweep(pipeline, scenes) -> dict:
    """infer_images over multi-person scenes; IoU-match persons; cm errors
    vs path truth (and vs raw analytic truth, reported unGated — the
    keypoint-extent pixel->cm convention biases it, see module doc)."""
    from human_body_proportion_estimation_tpu_torch.training.certify_bottomup import (  # noqa: E501
        bottomup_path_truth_cm,
        match_persons_iou,
    )
    from human_body_proportion_estimation_tpu_torch.training.synthetic import (
        SyntheticScene,
        segment_truth_cm,
    )

    errs_path, errs_analytic = [], []
    persons_total = persons_matched = 0
    segs_possible = segs_served = 0
    spurious = 0
    input_hw = type(pipeline).INPUT_HW
    for sc in scenes:
        declared = int(round(float(sc.heights_cm[0])))
        out = pipeline.infer_images([sc.image], person_heights=declared)
        valid = np.asarray(out.person_valid[0], bool)
        boxes = np.asarray(out.boxes_orig[0])
        match = match_persons_iou(boxes, valid, sc.bboxes_xyxy)
        persons_total += sc.keypoints.shape[0]
        spurious += int(valid.sum()) - sum(1 for j in match if j >= 0)
        for t_idx, j in enumerate(match):
            if j < 0:
                continue
            persons_matched += 1
            truth_path, vis_path = bottomup_path_truth_cm(
                sc.keypoints[t_idx], sc.visible[t_idx], declared,
                input_hw, sc.image.shape[:2],
            )
            # raw analytic truth under the top-down scaling rule, for
            # context only (single-person SyntheticScene shim)
            shim = SyntheticScene(
                image=sc.image, keypoints=sc.keypoints[t_idx],
                visible=sc.visible[t_idx],
                bbox_xyxy=sc.bboxes_xyxy[t_idx],
                height_cm=float(sc.heights_cm[t_idx]),
            )
            truth_a, vis_a = segment_truth_cm(shim)
            scale_a = declared / float(sc.heights_cm[t_idx])
            served = np.asarray(out.lengths_cm[0][j])
            served_vis = np.asarray(out.seg_visible[0][j], bool)
            for s in range(11):
                if not vis_path[s]:
                    continue
                segs_possible += 1
                if not served_vis[s]:
                    continue
                segs_served += 1
                errs_path.append(abs(served[s] - truth_path[s]))
                if vis_a[s]:
                    errs_analytic.append(
                        abs(served[s] - truth_a[s] * scale_a)
                    )
    ep = np.asarray(errs_path, np.float64)
    ea = np.asarray(errs_analytic, np.float64)
    return {
        "scenes": len(scenes),
        "persons_total": persons_total,
        "persons_matched": persons_matched,
        "spurious_persons": spurious,
        "segments_possible": segs_possible,
        "segments_served": segs_served,
        "mean_abs_cm_err_vs_path": (
            float(ep.mean()) if ep.size else float("inf")),
        "median_abs_cm_err_vs_path": (
            float(np.median(ep)) if ep.size else float("inf")),
        "p95_abs_cm_err_vs_path": (
            float(np.percentile(ep, 95)) if ep.size else float("inf")),
        "max_abs_cm_err_vs_path": (
            float(ep.max()) if ep.size else float("inf")),
        "mean_abs_cm_err_vs_analytic": (
            float(ea.mean()) if ea.size else float("inf")),
    }


def bottomup_http_sweep(pipeline, scenes) -> dict:
    """Full HTTP edge on single-person scenes (first-valid-slot response
    contract); cm vs path truth."""
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
    from human_body_proportion_estimation_tpu_torch.training.certify_bottomup import (  # noqa: E501
        bottomup_path_truth_cm,
    )

    app = ServingApp(pipeline)
    server = create_server(app, "127.0.0.1", 0)
    client = HttpClient("127.0.0.1", server.server_address[1],
                        timeout=1800)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    errs, latencies = [], []
    n_detected = segs_possible = segs_served = 0
    input_hw = type(pipeline).INPUT_HW
    try:
        for sc in scenes:
            ok, png = cv2.imencode(".png", sc.image[..., ::-1])
            assert ok
            declared = int(round(float(sc.heights_cm[0])))
            t0 = time.perf_counter()
            data = client.estimate_image(png.tobytes(), declared, 0.0)
            latencies.append(time.perf_counter() - t0)
            if data.get("code") != "success":
                continue
            served = data["body_proportion_lengths_(cm)"]
            if not served:
                continue
            n_detected += 1
            truth, vis = bottomup_path_truth_cm(
                sc.keypoints[0], sc.visible[0], declared,
                input_hw, sc.image.shape[:2],
            )
            for i, name in enumerate(SEGMENT_NAMES):
                if not vis[i]:
                    continue
                segs_possible += 1
                v = served.get(name)
                if v is None or v == NOT_VISIBLE:
                    continue
                segs_served += 1
                errs.append(abs(v - truth[i]))
    finally:
        server.shutdown()
        server.server_close()
        app.shutdown()
    e = np.asarray(errs, np.float64)
    return {
        "scenes": len(scenes),
        "detected": n_detected,
        "segments_possible": segs_possible,
        "segments_served": segs_served,
        "mean_abs_cm_err_vs_path": (
            float(e.mean()) if e.size else float("inf")),
        "p95_abs_cm_err_vs_path": (
            float(np.percentile(e, 95)) if e.size else float("inf")),
        "mean_http_latency_s": float(np.mean(latencies)),
    }


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, option for option, and `--cpu`."""
    parser = argparse.ArgumentParser(
        description="bottom-up train-on-synthetic -> serve -> assert cm "
                    "(PyTorch/CUDA)"
    )
    parser.add_argument("--workdir", default="/tmp/hbpe_certify_bu")
    parser.add_argument("--train-scenes", type=int, default=480)
    parser.add_argument("--val-scenes", type=int, default=16,
                        help="held-out MULTI-person scenes (direct sweep)")
    parser.add_argument("--http-scenes", type=int, default=8,
                        help="held-out SINGLE-person scenes (HTTP sweep)")
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--ae-weight", type=float, default=1e-3)
    parser.add_argument("--fg-weight", type=float, default=12.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tolerance-cm", type=float, default=4.0)
    parser.add_argument("--max-people", type=int, default=3)
    parser.add_argument("--reuse-checkpoint", action="store_true")
    parser.add_argument("--smoke", action="store_true",
                        help="wiring check: tiny HigherHRNet, 128x128 "
                             "marker scenes (on the CPU with --cpu)")
    parser.add_argument(
        "--emit-compact", nargs="?", const="default", default="",
        metavar="PATH",
        help="on a CERTIFIED run, write the compact .npz (pose slot only) "
             "to PATH; a bare --emit-compact exits 2 (JAX overwrites the "
             "reference package's checkpoint there)",
    )
    compile_cache.add_flags(parser)
    parser.add_argument("--cpu", action="store_true",
                        help="train and serve on the CPU in f32 (default: "
                             "the GPU, bf16)")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.emit_compact == "default":
        parser.error("--emit-compact needs a PATH: without one the JAX CLI "
                     "overwrites the reference package's committed "
                     "checkpoint")

    import torch

    compile_cache.apply_flags(args)

    from human_body_proportion_estimation_tpu_torch.cli.certify import (
        device_and_dtype,
        reload_state,
    )
    from human_body_proportion_estimation_tpu_torch.models import weights
    from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
        HigherHRNet,
    )
    from human_body_proportion_estimation_tpu_torch.models.layers import (
        init_flax_default,
    )
    from human_body_proportion_estimation_tpu_torch.models.hrnet import (
        HRNET_W32,
        HRNetConfig,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
        BottomUpPipeline,
    )
    from human_body_proportion_estimation_tpu_torch.training import (
        certify_bottomup as CB,
    )

    device, dtype = device_and_dtype(args.cpu)
    t_start = time.time()
    os.makedirs(args.workdir, exist_ok=True)
    ckpt_dir = os.path.join(args.workdir, "ckpt")

    def log(msg):
        print(f"[certify-bu +{time.time() - t_start:7.1f}s] {msg}",
              flush=True)

    if args.smoke:
        input_hw = (128, 128)
        hr_config = HRNetConfig(
            width=16, stage_modules=(1, 1, 1), blocks_per_branch=2,
            stem_channels=16, bottleneck_channels=16,
        )
        deconv_blocks = 1
        scene_kwargs = dict(fixed_pose=True, keypoint_markers=True)
        args.train_scenes = min(args.train_scenes, 48)
        args.val_scenes = min(args.val_scenes, 4)
        args.http_scenes = min(args.http_scenes, 2)
        args.steps = min(args.steps, 500)
        args.batch = min(args.batch, 8)
        args.lr = 2e-3
        args.tolerance_cm = max(args.tolerance_cm, 10.0)
    else:
        input_hw = BottomUpPipeline.INPUT_HW
        hr_config, deconv_blocks = HRNET_W32, 4
        scene_kwargs = {}

    def make_model():
        return HigherHRNet(hr_config, num_deconv_blocks=deconv_blocks,
                           dtype=dtype)

    class _Pipe(BottomUpPipeline):
        INPUT_HW = input_hw

    report: dict = {
        "mode": "smoke" if args.smoke else "chip",
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "input_hw": list(input_hw),
        "max_people": args.max_people,
    }

    log(f"rendering {args.train_scenes} train / {args.val_scenes} val "
        f"multi-person scenes at {input_hw}")
    train_scenes = CB.make_multi_scenes(
        args.train_scenes, args.seed, input_hw,
        max_people=args.max_people, **scene_kwargs,
    )
    val_scenes = CB.make_multi_scenes(
        args.val_scenes, args.seed + 10_000, input_hw,
        max_people=args.max_people, **scene_kwargs,
    )
    http_scenes = CB.make_multi_scenes(
        args.http_scenes, args.seed + 20_000, input_hw, n_people=1,
        **scene_kwargs,
    )

    pose_state = None
    if args.reuse_checkpoint:
        log(f"reusing checkpoint {ckpt_dir}")
    else:
        imgs, kp, vis = CB.bottomup_arrays(train_scenes, args.max_people)
        log(f"dataset {imgs.shape} ({imgs.nbytes / 1e6:.0f} MB on the "
            f"device); training {args.steps} steps @ batch {args.batch}")
        model = make_model().to(device)
        init_flax_default(model, args.seed)
        t0 = time.perf_counter()
        pose_state, losses = CB.train_bottomup_resident(
            model, imgs, kp, vis,
            steps=args.steps, batch=args.batch, learning_rate=args.lr,
            seed=args.seed, chunk=100, ae_weight=args.ae_weight,
            fg_weight=args.fg_weight,
            log_fn=lambda s, z: log(f"  step {s}: loss {z:.5f}"),
        )
        log(f"training: {args.steps * args.batch / (time.perf_counter() - t0):.1f} imgs/s")  # noqa: E501
        report["loss_first"] = losses[0]
        report["loss_last"] = losses[-1]
        weights.save_pose_checkpoint(ckpt_dir,
                                     weights.state_dict_to_flax(pose_state))
        log(f"checkpoint saved to {ckpt_dir}")

    pose_r = reload_state(weights.load_pose_checkpoint(ckpt_dir), pose_state)
    pipeline = _Pipe(pose_state=pose_r, max_people=args.max_people,
                     model=make_model(), device=device, dtype=dtype)

    log("direct sweep (multi-person, IoU-matched)")
    report["direct"] = bottomup_direct_sweep(pipeline, val_scenes)
    log(f"direct: {report['direct']}")

    log("HTTP sweep (single-person, full served edge)")
    report["http"] = bottomup_http_sweep(pipeline, http_scenes)
    log(f"http: {report['http']}")

    d = report["direct"]
    gates = {
        "person_coverage": (
            d["persons_matched"] >= 0.9 * max(d["persons_total"], 1)),
        "no_spurious_flood": (
            d["spurious_persons"] <= 0.2 * max(d["persons_total"], 1)),
        "segment_coverage": (
            d["segments_served"]
            >= 0.85 * max(d["segments_possible"], 1)),
        "mean_cm_err": (
            d["mean_abs_cm_err_vs_path"] <= args.tolerance_cm),
        "p95_cm_err": (
            d["p95_abs_cm_err_vs_path"] <= 2.0 * args.tolerance_cm),
        "http_detected": (
            report["http"]["detected"]
            >= 0.9 * report["http"]["scenes"]),
    }
    report["gates"] = gates
    report["certified"] = all(gates.values())
    report["wall_s"] = time.time() - t_start

    if args.emit_compact and report["certified"]:
        weights.save_compact_checkpoint(args.emit_compact, {}, pose_r)
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
