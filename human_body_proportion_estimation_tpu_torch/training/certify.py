"""Synthetic-supervised end-to-end certification: dataset functions that
replicate the serving geometry exactly, and resident-dataset training
loops (port of the JAX package's `training/certify.py`).

Geometry fidelity (why training matches serving), as in the JAX module:
  * pose crops are cut with the serving crop's corner-aligned TF
    `crop_and_resize` mapping (`crop_corner_aligned_np`, numpy);
  * the detector box is expanded/clipped/normalized with the pipeline's
    rule (x expand = width//17, y 0) before cropping;
  * heatmap targets are the inverse of the serving decode's remap, so a
    model that nails its targets decodes to the true image keypoints;
  * training jitters the box as an imperfect detector would.

The dataset functions are the JAX module's numpy code, copied. The
resident loops keep the whole dataset on the model's device as uint8 and
draw each chunk's [chunk, batch] indices from `np.random.default_rng(seed
+ 1)` exactly as JAX draws them (certify.py:323-328, :468-473); a Python
loop over the steps replaces `lax.fori_loop`, and each chunk reads its
mean loss back once. A loop trains the weights the model holds: the
caller initializes it (flax's default init is
`models.layers.init_flax_default`, as the CLIs call it).
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.training.synthetic import (
    SyntheticScene,
    generate_scene,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    PipelineConfig,
)


def make_scenes(
    n: int,
    seed: int,
    img_hw: Tuple[int, int],
    fixed_pose: bool = False,
) -> List[SyntheticScene]:
    rng = np.random.default_rng(seed)
    return [generate_scene(rng, img_hw, fixed_pose=fixed_pose)
            for _ in range(n)]


# ---------------------------------------------------------------------- #
# numpy twin of ops.crop.crop_and_resize (corner-aligned, zero-extrapolate)


def crop_corner_aligned_np(
    img: np.ndarray,        # [H, W, C] float32
    box_norm: np.ndarray,   # [4] normalized (y1, x1, y2, x2)
    out_h: int,
    out_w: int,
) -> np.ndarray:
    """TF crop_and_resize semantics in numpy (one box): direct bilinear
    gather, the serving crop's mapping (`ops/crop.py`)."""
    h, w = img.shape[:2]
    y1, x1, y2, x2 = [float(v) for v in box_norm]

    def positions(lo, hi, out, size):
        i = np.arange(out, dtype=np.float64)
        if out > 1:
            pos = lo * (size - 1) + i * (hi - lo) * (size - 1) / (out - 1)
        else:
            pos = np.full(out, 0.5 * (lo + hi) * (size - 1))
        in_range = (pos >= 0.0) & (pos <= size - 1)
        return np.clip(pos, 0.0, size - 1), in_range

    py, my = positions(y1, y2, out_h, h)
    px, mx = positions(x1, x2, out_w, w)
    y0 = np.floor(py).astype(np.int64)
    x0 = np.floor(px).astype(np.int64)
    y1i = np.minimum(y0 + 1, h - 1)
    x1i = np.minimum(x0 + 1, w - 1)
    wy = (py - y0).astype(np.float32)[:, None, None]
    wx = (px - x0).astype(np.float32)[None, :, None]

    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1i] * wx
    bot = img[y1i][:, x0] * (1 - wx) + img[y1i][:, x1i] * wx
    out = top * (1 - wy) + bot * wy
    out *= my[:, None, None] * mx[None, :, None]
    return out.astype(np.float32)


def expand_clip_normalize_np(
    box_yxyx_px: np.ndarray, x_expand: float, img_hw: Tuple[int, int]
) -> np.ndarray:
    """numpy twin of `ops.boxes.expand_clip_normalize_yxyx` (y expand 0)."""
    h, w = img_hw
    y1 = np.clip(box_yxyx_px[0], 0.0, h)
    x1 = np.clip(box_yxyx_px[1] - x_expand, 0.0, w)
    y2 = np.clip(box_yxyx_px[2], 0.0, h)
    x2 = np.clip(box_yxyx_px[3] + x_expand, 0.0, w)
    return np.array([y1 / h, x1 / w, y2 / h, x2 / w], np.float64)


def quantized_truth_cm(
    scene: SyntheticScene,
    cfg: PipelineConfig,
    subpixel: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """The cm values a PERFECT pose model at cfg's heatmap resolution would
    return through the serving path — i.e. analytic truth with the serving
    stack's argmax quantization applied.

    Mirrors the serving chain exactly: true tight box -> expand/clip/
    normalize (`ops.boxes`, x expand w//17) -> true keypoints to heatmap
    coords (the inverse of `ops.heatmap.remap_to_image` over the truncated
    box) -> rounded to the argmax grid (the decode can only emit integer
    bins; `subpixel` models `PoseConfig.subpixel_refine`'s quarter-pixel
    grid) -> remapped back -> 11 segments scaled by
    height_cm / truncated-box height (reference `person_det_pose_edet4_trtserver.py`
    :151-168).

    Reduced-shape certification asserts served cm against THIS value
    tightly; against raw analytic truth only within the quantization bound
    that the coarse test heatmap implies. At the production 96x72 heatmap
    the two differ by well under a centimeter.
    """
    from human_body_proportion_estimation_tpu_torch.ops.proportions import (
        _P1, _P2,
    )

    img_hw = scene.image.shape[:2]
    hm_h = cfg.pose.heatmap_height
    hm_w = cfg.pose.heatmap_width
    x1, y1, x2, y2 = scene.bbox_xyxy.astype(np.float64)
    box_norm = expand_clip_normalize_np(
        np.array([y1, x1, y2, x2]), cfg.x_expand, img_hw
    )
    bt = np.trunc(box_norm * np.array(
        [img_hw[0], img_hw[1], img_hw[0], img_hw[1]]
    ))
    bw = max(bt[3] - bt[1], 1.0)
    bh = max(bt[2] - bt[0], 1.0)
    kp = scene.keypoints.astype(np.float64)
    kp_hm = np.stack(
        [(kp[:, 0] - bt[1]) * hm_w / bw, (kp[:, 1] - bt[0]) * hm_h / bh],
        axis=-1,
    )
    grid = 4.0 if subpixel else 1.0
    kp_q = np.round(kp_hm * grid) / grid
    kp_q[:, 0] = np.clip(kp_q[:, 0], 0, hm_w - 1)
    kp_q[:, 1] = np.clip(kp_q[:, 1], 0, hm_h - 1)
    kp_img = np.stack(
        [kp_q[:, 0] * bw / hm_w + bt[1], kp_q[:, 1] * bh / hm_h + bt[0]],
        axis=-1,
    )
    e1 = _P1 @ kp_img
    e2 = _P2 @ kp_img
    dist_px = np.linalg.norm(e1 - e2, axis=-1)
    lengths = dist_px * scene.height_cm / bh
    return lengths.astype(np.float32), dist_px > 0


# ---------------------------------------------------------------------- #
# dataset functions


def pose_crop_arrays(
    scenes: Sequence[SyntheticScene],
    cfg: PipelineConfig,
    seed: int = 0,
    box_jitter: float = 0.08,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Scenes -> (crops u8 [N,ch,cw,3], kp_hm f32 [N,17,2], vis bool,
    boxes_norm f64 [N,4]).

    Crops are cut with the serving pipeline's exact box->crop mapping from
    a JITTERED tight box (scale/shift noise emulating detector error);
    targets are in heatmap coordinates via the serving remap's inverse, so
    argmax-decode + remap with the same box recovers the true image-space
    keypoints. `boxes_norm` is the expanded/clipped/normalized yxyx box
    each crop was cut with — what evaluation needs to remap predictions
    back to image space the way the serving path does.
    """
    rng = np.random.default_rng(seed)
    ch, cw = cfg.pose.crop_height, cfg.pose.crop_width
    hm_h, hm_w = cfg.pose.heatmap_height, cfg.pose.heatmap_width
    img_hw = (cfg.detector.input_height, cfg.detector.input_width)

    crops = np.zeros((len(scenes), ch, cw, 3), np.uint8)
    kp_hm = np.zeros((len(scenes), 17, 2), np.float32)
    vis = np.zeros((len(scenes), 17), bool)
    boxes_norm = np.zeros((len(scenes), 4), np.float64)
    for i, sc in enumerate(scenes):
        assert sc.image.shape[:2] == img_hw, (
            "scenes must be rendered at the detector input size"
        )
        x1, y1, x2, y2 = sc.bbox_xyxy.astype(np.float64)
        if box_jitter:
            w, h = x2 - x1, y2 - y1
            sx = rng.uniform(1 - box_jitter, 1 + box_jitter)
            sy = rng.uniform(1 - box_jitter, 1 + box_jitter)
            cx = (x1 + x2) / 2 + rng.uniform(-box_jitter, box_jitter) * w / 2
            cy = (y1 + y2) / 2 + rng.uniform(-box_jitter, box_jitter) * h / 2
            x1, x2 = cx - w * sx / 2, cx + w * sx / 2
            y1, y2 = cy - h * sy / 2, cy + h * sy / 2
        box_norm = expand_clip_normalize_np(
            np.array([y1, x1, y2, x2]), cfg.x_expand, img_hw
        )
        boxes_norm[i] = box_norm
        crop = crop_corner_aligned_np(
            sc.image.astype(np.float32) / 255.0, box_norm, ch, cw
        )
        crops[i] = np.clip(np.round(crop * 255.0), 0, 255).astype(np.uint8)

        # serving remap inverse over the truncated ORIGINAL-space box
        # (orig == det space for these scenes)
        bt = np.trunc(box_norm * np.array(
            [img_hw[0], img_hw[1], img_hw[0], img_hw[1]]
        ))
        bw = max(bt[3] - bt[1], 1.0)
        bh = max(bt[2] - bt[0], 1.0)
        kp_hm[i, :, 0] = (sc.keypoints[:, 0] - bt[1]) * hm_w / bw
        kp_hm[i, :, 1] = (sc.keypoints[:, 1] - bt[0]) * hm_h / bh
        vis[i] = (
            sc.visible
            & (kp_hm[i, :, 0] >= 0) & (kp_hm[i, :, 0] <= hm_w - 1)
            & (kp_hm[i, :, 1] >= 0) & (kp_hm[i, :, 1] <= hm_h - 1)
        )
    return crops, kp_hm, vis, boxes_norm


def det_arrays(
    scenes: Sequence[SyntheticScene],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Scenes -> (images u8 [N,H,W,3], gt_boxes yxyx px [N,1,4],
    gt_classes [N,1] i32 (0-based person), gt_valid [N,1])."""
    imgs = np.stack([s.image for s in scenes])
    boxes = np.stack([
        s.bbox_xyxy[np.asarray([1, 0, 3, 2])] for s in scenes
    ])[:, None, :].astype(np.float32)
    classes = np.zeros((len(scenes), 1), np.int32)  # 0-based person
    valid = np.ones((len(scenes), 1), bool)
    return imgs, boxes, classes, valid


# ---------------------------------------------------------------------- #
# resident-dataset training on the model's device


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _warmup(steps: int) -> int:
    """certify.py:290-291: min(max(steps // 20, 20), 500)."""
    return min(max(steps // 20, 20), 500)


def _run_chunks(steps: int, batch: int, n: int, seed: int, chunk: int,
                step_fn: Callable[[torch.Tensor], torch.Tensor],
                device, log_fn=None) -> List[float]:
    """Draw the indices as JAX draws them and run `step_fn(sel)` (one
    optimizer step on dataset rows `sel`, returning its loss) `steps`
    times; returns the per-chunk mean losses."""
    rng = np.random.default_rng(seed + 1)
    losses: List[float] = []
    done = 0
    while done < steps:
        k = min(chunk, steps - done)
        idx = torch.from_numpy(
            rng.integers(0, n, (k, batch)).astype(np.int64)).to(device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(k):
            loss_sum = loss_sum + step_fn(idx[i])
        losses.append(float(loss_sum / k))
        done += k
        if log_fn:
            log_fn(done, losses[-1])
    return losses


def _host_state(model) -> dict:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def train_pose_resident(
    model,
    crops_u8: np.ndarray,
    kp_hm: np.ndarray,
    vis: np.ndarray,
    steps: int,
    batch: int,
    learning_rate: float = 1e-3,
    seed: int = 0,
    chunk: int = 50,
    sigma: float = 2.0,
    log_fn=None,
    cosine: bool = False,
    fg_weight: float = 0.0,
) -> Tuple[dict, List[float]]:
    """Train the pose model, from the weights it holds, with the whole
    dataset on its device.

    Returns (pose_state: the trained `state_dict` on the host, per-chunk
    mean losses). `cosine` switches to warmup + cosine decay over `steps`
    (short runs converge better at a constant rate)."""
    from human_body_proportion_estimation_tpu_torch.training import (
        trainer as T,
    )

    n, ch, cw = crops_u8.shape[0], crops_u8.shape[1], crops_u8.shape[2]
    hm_h, hm_w = ch // 4, cw // 4
    state = T.create_train_state(
        model, None, learning_rate,
        total_steps=steps if cosine else None,
        warmup_steps=_warmup(steps) if cosine else 0,
    )
    dev = _device(model)
    d_crops = torch.from_numpy(np.ascontiguousarray(crops_u8)).to(dev)
    d_kp = torch.from_numpy(kp_hm.astype(np.float32)).to(dev)
    d_vis = torch.from_numpy(np.asarray(vis, bool)).to(dev)

    def step(sel):
        imgs = d_crops[sel].permute(0, 3, 1, 2).float() / 255.0
        tgt = T.heatmap_targets(d_kp[sel], d_vis[sel], hm_h, hm_w, sigma)
        _, loss = T.train_step(state, imgs, tgt, d_vis[sel].float(),
                               fg_weight=fg_weight)
        return loss

    losses = _run_chunks(steps, batch, n, seed, chunk, step, dev, log_fn)
    model.eval()
    return _host_state(model), losses


@torch.no_grad()
def pose_peak_scores(model, crops_u8: np.ndarray,
                     batch: int = 8) -> np.ndarray:
    """Per-keypoint heatmap max scores [N, 17] of `model` (eval mode) on
    the crops, the quantity the serving path gates on (reference
    `person_det_pose_edet4_trtserver.py:162-163`). A short last chunk is
    padded to `batch` with its first crop, as JAX pads to its jit shape."""
    model.eval()
    dev = _device(model)
    out = []
    for s in range(0, len(crops_u8), batch):
        chunk = crops_u8[s:s + batch]
        n = len(chunk)
        if n < batch:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[:1], batch - n, axis=0)])
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
        hm = model(x.permute(0, 3, 1, 2).float() / 255.0)
        out.append(hm.amax((2, 3)).cpu().numpy()[:n])
    return np.concatenate(out)


def calibrate_pose_gates(
    pose_state: Mapping[str, torch.Tensor],
    scores: np.ndarray,        # [N, 17] peak scores on calibration crops
    visible: np.ndarray,       # [N, 17] bool
    thresholds: Sequence[float],
    quantile: float = 5.0,
    margin: float = 1.3,
    max_gamma: float = 4.0,
) -> Tuple[dict, np.ndarray]:
    """Per-keypoint amplitude calibration of the HRNet head.

    The reference's per-keypoint confidence gates (0.10-0.46) were tuned to
    the upstream model's score distribution; a synthetic-trained head
    localizes as well but its peaks sit lower. Scaling keypoint k's head
    channel (`head.weight` [K, C, 1, 1] row k, and `head.bias[k]`) by
    gamma_k scales its heatmap, and so its gate score, by gamma_k while the
    argmax stays where it is. gamma_k lifts the `quantile`-th percentile of
    VISIBLE-keypoint scores over the gate by `margin`, clipped to
    [1, max_gamma]. Returns (calibrated pose_state, gamma [17])."""
    thr = np.asarray(thresholds, np.float64)
    k_n = thr.shape[0]
    gamma = np.ones(k_n)
    for k in range(k_n):
        vis_scores = scores[visible[:, k], k]
        if vis_scores.size == 0:
            continue
        q = float(np.percentile(vis_scores, quantile))
        gamma[k] = float(np.clip(margin * thr[k] / max(q, 1e-6),
                                 1.0, max_gamma))
    new_state = dict(pose_state)
    w, b = pose_state["head.weight"], pose_state["head.bias"]
    g = torch.from_numpy(gamma.astype(np.float32)).to(w.device)
    new_state["head.weight"] = w * g.to(w.dtype)[:, None, None, None]
    new_state["head.bias"] = b * g.to(b.dtype)
    return new_state, gamma


def train_det_resident(
    model,
    images_u8: np.ndarray,
    gt_boxes: np.ndarray,
    gt_classes: np.ndarray,
    gt_valid: np.ndarray,
    steps: int,
    batch: int,
    learning_rate: float = 5e-4,
    seed: int = 0,
    chunk: int = 50,
    log_fn=None,
    cosine: bool = True,
) -> Tuple[dict, List[float]]:
    """Train the EfficientDet detector, from the weights it holds (the focal
    prior included: `detection.init_det_flax`), with the dataset on its
    device (the scheme of `train_pose_resident`). `cosine` (default on:
    the production recipe) uses warmup + cosine decay over `steps` plus
    global-norm gradient clipping at 10. Returns (det_state on the host,
    per-chunk mean losses)."""
    from human_body_proportion_estimation_tpu_torch.training import (
        detection as D,
    )

    n = images_u8.shape[0]
    state = D.create_det_train_state(
        model, None, learning_rate,
        total_steps=steps if cosine else None,
        warmup_steps=_warmup(steps) if cosine else 0,
        clip_norm=10.0 if cosine else 0.0,
    )
    dev = _device(model)
    d_imgs = torch.from_numpy(np.ascontiguousarray(images_u8)).to(dev)
    d_boxes = torch.from_numpy(gt_boxes.astype(np.float32)).to(dev)
    d_cls = torch.from_numpy(gt_classes.astype(np.int64)).to(dev)
    d_valid = torch.from_numpy(np.asarray(gt_valid, bool)).to(dev)

    def step(sel):
        _, loss = D.train_step(state, d_imgs[sel], d_boxes[sel], d_cls[sel],
                               d_valid[sel])
        return loss

    losses = _run_chunks(steps, batch, n, seed, chunk, step, dev, log_fn)
    model.eval()
    return _host_state(model), losses
