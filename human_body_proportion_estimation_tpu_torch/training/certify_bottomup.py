"""Bottom-up (HigherHRNet + AE grouping) synthetic certification:
multi-person dataset functions, a resident-dataset training loop, and the
serving-path analytic truth (port of the JAX package's
`training/certify_bottomup.py`).

The bottom-up pipeline is capability beyond the reference, so its
certification asserts against the PATH truth, the cm values a perfect
model pushed through `pipeline/bottomup.py`'s decode would return:
keypoints quantized to the aggregated heatmap's grid (1/2 the input),
and pixel->cm from the declared height over the visible keypoints'
vertical extent (the bottom-up path has no detector box).

The dataset functions and the truth are the JAX module's numpy code, copied;
training follows `training/certify.py`'s resident pattern.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.training.synthetic import (
    MultiPersonScene,
    generate_multi_scene,
)


def make_multi_scenes(
    n: int,
    seed: int,
    img_hw: Tuple[int, int] = (512, 512),
    n_people: int | None = None,
    max_people: int = 3,
    shared_height: bool = True,
    **scene_kwargs,
) -> List[MultiPersonScene]:
    """`shared_height=True` draws ONE height per scene and renders every
    figure at it — matching the HTTP edge's one-height-per-request form
    contract (the serving path applies the declared height to every
    person slot, pipeline/bottomup.py heights[i, :])."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h = float(rng.uniform(150.0, 200.0)) if shared_height else None
        out.append(generate_multi_scene(
            rng, img_hw, n_people=n_people, max_people=max_people,
            height_cm=h, **scene_kwargs,
        ))
    return out


# ---------------------------------------------------------------------- #
# dataset functions


def bottomup_arrays(
    scenes: Sequence[MultiPersonScene],
    max_people: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scenes -> (images u8 [N,H,W,3], kp f32 [N,P,17,2] image px,
    vis bool [N,P,17]); person slots padded to `max_people`."""
    n = len(scenes)
    h, w = scenes[0].image.shape[:2]
    imgs = np.zeros((n, h, w, 3), np.uint8)
    kp = np.zeros((n, max_people, 17, 2), np.float32)
    vis = np.zeros((n, max_people, 17), bool)
    for i, sc in enumerate(scenes):
        assert sc.image.shape[:2] == (h, w)
        p = min(sc.keypoints.shape[0], max_people)
        imgs[i] = sc.image
        kp[i, :p] = sc.keypoints[:p]
        vis[i, :p] = sc.visible[:p]
    return imgs, kp, vis


# ---------------------------------------------------------------------- #
# resident-dataset training on the model's device


def train_bottomup_resident(
    model,
    images_u8: np.ndarray,   # [N, H, W, 3]
    kp: np.ndarray,          # [N, P, 17, 2] image px
    vis: np.ndarray,         # [N, P, 17] bool
    steps: int,
    batch: int,
    learning_rate: float = 1e-3,
    seed: int = 0,
    chunk: int = 50,
    ae_weight: float = 1e-3,
    fg_weight: float = 12.0,
    log_fn=None,
) -> Tuple[dict, List[float]]:
    """Train HigherHRNet, from the weights it holds, with the whole
    multi-person dataset on its device;
    returns (pose_state on the host, per-chunk mean losses). Constant Adam
    rate, as in JAX."""
    from human_body_proportion_estimation_tpu_torch.training import (
        bottomup as BU,
        trainer as T,
    )
    from human_body_proportion_estimation_tpu_torch.training.certify import (
        _device,
        _host_state,
        _run_chunks,
    )

    n = images_u8.shape[0]
    state = T.create_train_state(model, None, learning_rate)
    dev = _device(model)
    d_imgs = torch.from_numpy(np.ascontiguousarray(images_u8)).to(dev)
    d_kp = torch.from_numpy(kp.astype(np.float32)).to(dev)
    d_vis = torch.from_numpy(np.asarray(vis, bool)).to(dev)

    def step(sel):
        imgs = d_imgs[sel].permute(0, 3, 1, 2).float() / 255.0
        _, loss = BU.bottomup_train_step(
            state, imgs, d_kp[sel], d_vis[sel], ae_weight=ae_weight,
            fg_weight=fg_weight)
        return loss

    losses = _run_chunks(steps, batch, n, seed, chunk, step, dev, log_fn)
    model.eval()
    return _host_state(model), losses


# ---------------------------------------------------------------------- #
# serving-path analytic truth


def bottomup_path_truth_cm(
    kp_img: np.ndarray,        # [17, 2] true keypoints, image px
    visible: np.ndarray,       # [17] bool
    declared_height_cm: float,
    input_hw: Tuple[int, int],   # pipeline INPUT_HW (512, 512)
    orig_hw: Tuple[int, int],    # posted image size
) -> Tuple[np.ndarray, np.ndarray]:
    """The 11 segment cm values a PERFECT model through the bottom-up
    decode returns for one person: keypoints snapped to the aggregated
    heatmap's integer grid (1/2 the pipeline input res), remapped to
    original coords, scaled by declared_height / visible-keypoint
    y-extent — `pipeline/bottomup.py` forward() line by line, in numpy."""
    from human_body_proportion_estimation_tpu_torch.ops.proportions import (
        _P1, _P2,
    )

    hm_h, hm_w = input_hw[0] // 2, input_hw[1] // 2
    oh, ow = float(orig_hw[0]), float(orig_hw[1])
    # original px -> heatmap bins (the model sees the image resized to
    # input_hw; heatmaps are 1/2 that; forward() scales peaks back by
    # orig_hw / hm_hw)
    sx, sy = ow / hm_w, oh / hm_h
    kx = np.clip(np.round(kp_img[:, 0] / sx), 0, hm_w - 1)
    ky = np.clip(np.round(kp_img[:, 1] / sy), 0, hm_h - 1)
    kq = np.stack([kx * sx, ky * sy], axis=-1)      # back to original px

    vis = visible.astype(bool)
    ys = kq[vis, 1]
    pixel_height = max(float(ys.max() - ys.min()), 1.0)
    pixel_to_cm = declared_height_cm / pixel_height

    e1 = _P1 @ kq
    e2 = _P2 @ kq
    dist_px = np.linalg.norm(e1 - e2, axis=-1)
    seg_vis = ((np.abs(_P1) @ vis.astype(np.float64) > 0)
               & (np.abs(_P2) @ vis.astype(np.float64) > 0)
               & (dist_px > 0))
    return (dist_px * pixel_to_cm).astype(np.float32), seg_vis


def match_persons_iou(
    pred_boxes: np.ndarray,   # [P, 4] yxyx
    pred_valid: np.ndarray,   # [P] bool
    true_boxes: np.ndarray,   # [T, 4] xyxy
) -> List[int]:
    """Greedy IoU matching: for each true person, the best unused valid
    predicted slot (index) or -1. Boxes come in the two conventions the
    two sides emit (pipeline yxyx vs scene xyxy)."""
    t = true_boxes.shape[0]
    used: set = set()
    out = []
    for i in range(t):
        x1, y1, x2, y2 = [float(v) for v in true_boxes[i]]
        best_j, best_iou = -1, 0.0
        for j in range(pred_boxes.shape[0]):
            if j in used or not pred_valid[j]:
                continue
            by1, bx1, by2, bx2 = [float(v) for v in pred_boxes[j]]
            ix = max(0.0, min(bx2, x2) - max(bx1, x1))
            iy = max(0.0, min(by2, y2) - max(by1, y1))
            inter = ix * iy
            union = ((bx2 - bx1) * (by2 - by1)
                     + (x2 - x1) * (y2 - y1) - inter)
            iou = inter / max(union, 1e-6)
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_iou > 0.1:
            used.add(best_j)
            out.append(best_j)
        else:
            out.append(-1)
    return out
