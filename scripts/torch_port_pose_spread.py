"""Where the PyTorch port's certification error comes from: the pose model's
training precision, its seed, or the draw of held-out scenes.

Takes one HRNet-W32 pose model, either
  * `--pose certified`: the committed certified weights (trained by the JAX
    package's `cli.certify`), or
  * `--pose bf16` / `--pose f32`: trained by the port on the card with
    `cli.certify`'s recipe (640 scenes from `--seed`, box jitter 0.08, 4000
    steps at batch 16, constant rate 1e-3, peak weight 12, flax's init from
    `--seed` or JAX's own from `--init-from`, the gate calibration), in
    that compute dtype (f32 with TF32 off),
and reports for each held-out set `--val-seeds` (the 24 scenes that
`cli.certify --seed S` holds out):
  1. per-keypoint errors of the argmax decode on the tight-box crops (what
     `cli.certify`'s pose_val reports, keypoint by keypoint, served in
     bf16), and
  2. the served sweep: `cli.certify --reuse-checkpoint --seed S` over HTTP
     with this pose model behind the committed certified EfficientDet-Lite4,
     so that only the pose model differs between runs.

One JSON object goes to `--out`. Needs the card (the port's entry points run
there); several runs can share one card, each in its own process. Build the
kernels once before starting them in parallel:

    python3 -c "from human_body_proportion_estimation_tpu_torch.ops \
import build; build.build()"
    python3 scripts/torch_port_pose_spread.py --pose certified \
        --val-seeds 0 1 2 3 --out chiprun_out/spread/certified.json
    python3 scripts/torch_port_pose_spread.py --pose bf16 --seed 0 \
        --val-seeds 0 1 2 3 --out chiprun_out/spread/bf16_s0.json
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from human_body_proportion_estimation_tpu_torch.cli import (  # noqa: E402
    certify as cli,
)
from human_body_proportion_estimation_tpu_torch.models import (  # noqa: E402
    weights,
)
from human_body_proportion_estimation_tpu_torch.models.hrnet import (  # noqa: E402,E501
    HRNET_W32,
    HRNet,
)
from human_body_proportion_estimation_tpu_torch.models.layers import (  # noqa: E402,E501
    init_flax_default,
)
from human_body_proportion_estimation_tpu_torch.ops import (  # noqa: E402
    kernels,
)
from human_body_proportion_estimation_tpu_torch.training import (  # noqa: E402,E501
    certify as C,
)
from human_body_proportion_estimation_tpu_torch.training.synthetic import (  # noqa: E402,E501
    generate_scene,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (  # noqa: E402,E501
    DetectorConfig,
    PipelineConfig,
)

# the reference's keypoint names (`ops.proportions`: index 5 is the
# subject's right shoulder)
KEYPOINTS = ["nose", "reye", "leye", "rear", "lear", "rshoulder",
             "lshoulder", "relbow", "lelbow", "rwrist", "lwrist", "rhip",
             "lhip", "rknee", "lknee", "rankle", "lankle"]
SERVED_KEYS = ["detected", "segments_served", "segments_possible",
               "mean_abs_cm_err", "median_abs_cm_err", "p95_abs_cm_err",
               "max_abs_cm_err", "per_segment_mean_cm_err"]


def config() -> PipelineConfig:
    return PipelineConfig(detector=DetectorConfig(name="efficientdet_lite4"))


def train_pose(kind: str, seed: int, steps: int, log,
               init_from: str = "") -> dict:
    """`cli.certify`'s pose training on the card in `kind`'s dtype, from
    flax's init drawn by the port or from the pose slot of the Orbax
    checkpoint directory `init_from`; returns the calibrated state and the
    run's figures."""
    cfg = config()
    img_hw = (cfg.detector.input_height, cfg.detector.input_width)
    rng = np.random.default_rng(seed)
    scenes = [generate_scene(rng, img_hw) for _ in range(640)]
    crops, kp_hm, vis, _ = C.pose_crop_arrays(scenes, cfg, seed=seed + 1,
                                              box_jitter=0.08)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    model = HRNet(HRNET_W32, dtype=dtype).to("cuda")
    if init_from:
        model.load_state_dict(weights.flax_to_state_dict(
            weights.load_pose_checkpoint(init_from)))
    else:
        init_flax_default(model, seed)
    t0 = time.perf_counter()
    state, losses = C.train_pose_resident(
        model, crops, kp_hm, vis, steps=steps, batch=16,
        learning_rate=1e-3, seed=seed, chunk=100, sigma=2.0,
        cosine=False, fg_weight=12.0,
        log_fn=lambda s, z: log(f"pose step {s}: loss {z:.5f}"))
    train_s = time.perf_counter() - t0
    cal = C.pose_peak_scores(model, crops[:256])
    state, gamma = C.calibrate_pose_gates(state, cal, vis[:256],
                                          cfg.pose.keypoint_thresholds)
    return {"state": state, "losses": losses, "train_s": train_s,
            "imgs_per_s": steps * 16 / train_s,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2**30,
            "gamma": [float(g) for g in gamma]}


@torch.no_grad()
def keypoint_errors(state: dict, val_seed: int) -> tuple:
    """(errors [24, 17] heatmap px, visible [24, 17]) of the bf16-served
    pose model on the tight-box crops of `cli.certify --seed val_seed`'s
    held-out scenes (its pose_val, keypoint by keypoint)."""
    cfg = config()
    img_hw = (cfg.detector.input_height, cfg.detector.input_width)
    rng = np.random.default_rng(val_seed + 10_000)
    scenes = [generate_scene(rng, img_hw) for _ in range(24)]
    crops, kp_hm, vis, _ = C.pose_crop_arrays(scenes, cfg, seed=99,
                                              box_jitter=0.0)
    model = HRNet(HRNET_W32, dtype=torch.bfloat16).to("cuda")
    model.load_state_dict(state, strict=True)
    model.eval()
    errs = []
    for s in range(0, len(crops), 8):
        x = torch.from_numpy(crops[s:s + 8]).to("cuda")
        hm = model(x.permute(0, 3, 1, 2).float() / 255.0)
        xy, _ = kernels.decode_heatmaps(hm.contiguous())
        errs.append(np.linalg.norm(xy.cpu().numpy() - kp_hm[s:s + 8],
                                   axis=-1))
    return np.concatenate(errs), vis


def summary(e: np.ndarray) -> dict:
    return {"n": int(e.size), "mean": float(e.mean()),
            "p95": float(np.percentile(e, 95)), "max": float(e.max()),
            "n_over_5px": int((e > 5.0).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pose", choices=("certified", "bf16", "f32"),
                    required=True)
    ap.add_argument("--seed", type=int, default=0,
                    help="the training run's seed (bf16 / f32)")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--init-from", default="",
                    help="train from the pose slot of this Orbax "
                         "checkpoint directory (JAX's own init: python -m "
                         "tests.test_torch_port_train_goldens --pose-init "
                         "DIR) instead of the port's draw of flax's init")
    ap.add_argument("--val-seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cli.device_and_dtype(False)     # TF32 off, as cli.certify trains
    tag = args.pose if args.pose == "certified" else \
        f"{args.pose}_s{args.seed}{'_jaxinit' if args.init_from else ''}"
    t_start = time.time()

    def log(msg):
        print(f"[{tag} +{time.time() - t_start:7.1f}s] {msg}", flush=True)

    det_tree, pose_tree = weights.load_compact_checkpoint(
        weights.default_certified_checkpoint())
    result = {"pose": args.pose, "val_seeds": args.val_seeds,
              "card": subprocess.run(
                  ["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True,
                  text=True).stdout.strip()}
    if args.pose == "certified":
        pose_state = weights.flax_to_state_dict(pose_tree)
    else:
        run = train_pose(args.pose, args.seed, args.steps, log,
                         args.init_from)
        pose_state = run.pop("state")
        result.update(seed=args.seed, steps=args.steps,
                      init_from=args.init_from, **run)
        log(f"trained: {run['imgs_per_s']:.1f} imgs/s, last loss "
            f"{run['losses'][-1]:.5f}")

    errs, vis = zip(*(keypoint_errors(pose_state, s)
                      for s in args.val_seeds))
    errs, vis = np.concatenate(errs), np.concatenate(vis)
    result["pose_val"] = {
        str(s): summary(e[v]) for s, e, v in zip(
            args.val_seeds, np.split(errs, len(args.val_seeds)),
            np.split(vis, len(args.val_seeds)))}
    result["pose_val_pooled"] = summary(errs[vis])
    result["per_keypoint"] = {
        name: summary(errs[vis[:, k], k]) for k, name in enumerate(KEYPOINTS)
        if vis[:, k].any()}
    log(f"pose val pooled: {result['pose_val_pooled']}")

    with tempfile.TemporaryDirectory() as work:
        ckpt = os.path.join(work, "ckpt")
        weights.save_pipeline_checkpoint(
            ckpt, det_tree, weights.state_dict_to_flax(pose_state))
        result["served"] = {}
        for s in args.val_seeds:
            code = cli.main(["--det-arch", "lite4", "--reuse-checkpoint",
                             "--workdir", work, "--seed", str(s),
                             "--train-scenes", "1", "--skip-ssd",
                             "--skip-coco"])
            with open(os.path.join(work, "report.json")) as f:
                report = json.load(f)
            result["served"][str(s)] = {
                "certified": report["certified"], "exit": code,
                **{k: report["served"][k] for k in SERVED_KEYS}}
            log(f"served seed {s}: {result['served'][str(s)]}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("pose", "pose_val_pooled",
                                             "served")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
