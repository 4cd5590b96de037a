"""The plain reference of arch `edet_lite_hrnet`, the served answer:
uint8 image + person height
-> person slots, keypoint confidences and 11 segment lengths in cm.

    EfficientDet-Lite (all 90 class logits) -> person candidates (person
    is the anchor's best class) -> top-K by score, decode, clip, greedy NMS
    -> the best `slots` above the threshold -> box grown by W // 17 in x,
    normalized -> bilinear crop (TF crop_and_resize) of the /255 image ->
    HRNet heatmaps -> argmax (first of equal maxima) -> per-keypoint gates
    -> keypoints to image pixels through the truncated box -> lengths
    scaled by height / truncated box height.

The same steps as the served program (reference repository
`person_det_pose_edet4_trtserver.py` and `models/conv.py`), written out
in plain PyTorch from the published definitions; float32 unless the
control asks for a lower precision (`reference.models.set_precision`).
It imports nothing of the program and takes only what the benchmark made:
images, heights, thresholds and weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from port_bench.reference import models
from port_bench.reference.segments import segment_matrices

def anchors(h: int, w: int, levels=(3, 4, 5, 6, 7), scales=3,
            ratios=(1.0, 2.0, 0.5), anchor_scale=3.0) -> np.ndarray:
    """[N, 4] pixel (cy, cx, h, w), level-major, 9 anchors a cell."""
    out = []
    for level in levels:
        stride = 2 ** level
        fh, fw = -(-h // stride), -(-w // stride)
        sizes = []
        for s in range(scales):
            base = anchor_scale * stride * (2 ** (s / scales))
            for ar in ratios:
                sizes.append((base / np.sqrt(ar), base * np.sqrt(ar)))
        sizes = np.array(sizes, np.float32)
        cy, cx = np.meshgrid((np.arange(fh) + 0.5) * stride,
                             (np.arange(fw) + 0.5) * stride, indexing="ij")
        centers = np.stack([cy, cx], -1).reshape(fh, fw, 1, 2)
        hw = np.broadcast_to(sizes, (fh, fw, len(sizes), 2))
        out.append(np.concatenate([np.broadcast_to(centers, hw.shape), hw],
                                  -1).reshape(-1, 4))
    return np.concatenate(out, 0).astype(np.float32)


def iou(a, b):
    """Pairwise IoU of xyxy boxes [..., N, 4] x [..., M, 4]."""
    area_a = (a[..., 2:] - a[..., :2]).clamp_min(0.0).prod(-1)
    area_b = (b[..., 2:] - b[..., :2]).clamp_min(0.0).prod(-1)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp_min(0.0).prod(-1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-12)


def greedy_nms(boxes_xyxy, scores, threshold):
    """Keep mask over candidates sorted by descending score: a box stays
    if its score is > 0 and no earlier kept box overlaps it by IoU >
    threshold."""
    over = iou(boxes_xyxy, boxes_xyxy) > threshold
    keep = scores > 0.0
    for i in range(1, boxes_xyxy.shape[-2]):
        keep[..., i] &= ~(keep[..., :i] & over[..., :i, i]).any(-1)
    return keep


def crop_weights(lo, hi, out_size: int, in_size: int):
    """Bilinear sampling rows [..., out, in] of TF crop_and_resize for
    normalized [lo, hi] (corner-aligned; outside the image reads 0)."""
    i = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    lo, hi = lo[..., None], hi[..., None]
    scale = (hi - lo) * (in_size - 1) / (out_size - 1)
    pos = lo * (in_size - 1) + i * scale
    j = torch.arange(in_size, dtype=torch.float32, device=lo.device)
    w = (1.0 - (pos[..., :, None] - j).abs()).clamp_min(0.0)
    return w * ((pos >= 0.0) & (pos <= in_size - 1))[..., :, None]


class Reference:
    """The reference of one configuration (`config`: the parsed
    configuration file) on `device`, with the given `state_dict`s."""

    def __init__(self, config: dict, states: Dict[str, dict], device,
                 precision: Optional[str] = None):
        det, pose = config["detector"], config["pose"]
        self.config = config
        self.device = torch.device(device)
        self.det = models.EfficientDet(
            det["width_mult"], det["depth_mult"], det["fpn_channels"],
            det["fpn_repeats"], det["head_repeats"], det["num_classes"])
        self.pose = models.HRNet(pose["width"], pose["num_keypoints"])
        for model, state in ((self.det, states["det"]),
                             (self.pose, states["pose"])):
            model.load_state_dict(state, strict=True)
            model.to(self.device).eval()
            models.set_precision(model, precision)
        self.hw = (det["input_height"], det["input_width"])
        self.anchors = torch.from_numpy(anchors(*self.hw)).to(self.device)
        p1, p2, req = segment_matrices(pose["num_keypoints"])
        self.p1, self.p2, self.req = (torch.from_numpy(a).to(self.device)
                                      for a in (p1, p2, req))
        self.kp_thresholds = torch.tensor(pose["keypoint_thresholds"],
                                          device=self.device)

    def person_slots(self, images, threshold: float):
        det = self.config["detector"]
        logits, regs = self.det(images)
        return self.slots_from_logits(
            logits.amax(-1), logits[..., det["person_class_id"] - 1], regs,
            threshold)

    def slots_from_logits(self, best, person, regs, threshold: float):
        """(boxes [B, P, 4] pixel yxyx, valid [B, P], deciding score
        [B, P]) from each anchor's best and person logits and box
        regressions [B, N, 4]."""
        det = self.config["detector"]
        scores = torch.where(person >= best, torch.sigmoid(person), 0.0)
        top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        top, idx = top[:, :det["nms_top_k"]], idx[:, :det["nms_top_k"]]
        r = torch.gather(regs, 1, idx[..., None].expand(-1, -1, 4))
        a = self.anchors[idx]
        cy, cx = r[..., 0] * a[..., 2] + a[..., 0], r[..., 1] * a[..., 3] + \
            a[..., 1]
        bh, bw = torch.exp(r[..., 2]) * a[..., 2], torch.exp(r[..., 3]) * \
            a[..., 3]
        boxes = torch.stack([cy - bh / 2, cx - bw / 2, cy + bh / 2,
                             cx + bw / 2], -1)
        h, w = self.hw
        limit = torch.tensor([h, w, h, w], dtype=torch.float32,
                             device=boxes.device)
        boxes = boxes.clamp_min(0.0).minimum(limit)
        keep = greedy_nms(boxes[..., [1, 0, 3, 2]], top,
                          det["iou_threshold"])
        final = torch.where(keep & (top >= threshold) & (top > 0.0), top,
                            0.0)
        p = det["max_persons"]
        sel = torch.sort(final, dim=-1, descending=True,
                         stable=True)[1][:, :p]
        # the score that decided each slot: the best remaining candidate's,
        # also where it fell under the threshold
        cand = torch.where(keep & (top > 0.0), top, 0.0)
        decided = torch.sort(cand, dim=-1, descending=True,
                             stable=True)[0][:, :p]
        sel_boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
        return sel_boxes, decided >= threshold, decided

    @torch.no_grad()
    def answers(self, images: np.ndarray, heights: np.ndarray,
                threshold: float, block: int = 16) -> Dict[str, np.ndarray]:
        """Per image [N, H, W, 3] uint8 at the detector's input size and
        height in cm: valid [N, P], score [N, P] (the score each slot was
        decided on), kp_conf [N, P, K], lengths [N, P, 11] (0 where not
        visible), visible [N, P, 11]."""
        parts = [self._answers(images[i:i + block], heights[i:i + block],
                               threshold)
                 for i in range(0, len(images), block)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def _answers(self, images, heights, threshold):
        pose = self.config["pose"]
        ch, cw = pose["crop_height"], pose["crop_width"]
        h, w = self.hw
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        b = x.shape[0]
        boxes, valid, decided = self.person_slots(x, threshold)
        p = boxes.shape[1]
        xe = float(w // self.config["detector"]["x_expand_divisor"])
        norm = torch.stack([boxes[..., 0].clamp(0.0, h) / h,
                            (boxes[..., 1] - xe).clamp(0.0, w) / w,
                            boxes[..., 2].clamp(0.0, h) / h,
                            (boxes[..., 3] + xe).clamp(0.0, w) / w], -1)
        wy = crop_weights(norm[..., 0], norm[..., 2], ch, h)
        wx = crop_weights(norm[..., 1], norm[..., 3], cw, w)
        img = x.float() / 255.0
        crops = torch.einsum("bnyh,bhwc->bnywc", wy, img)
        crops = torch.einsum("bnxw,bnywc->bnyxc", wx, crops)
        crops = crops.reshape(b * p, ch, cw, 3).permute(0, 3, 1, 2)
        hm = self.pose(crops)
        k, hh, hw_ = hm.shape[1:]
        flat = hm.reshape(b, p, k, hh * hw_)
        conf = flat.amax(-1)
        n = flat.shape[-1]
        lin = torch.arange(n, device=flat.device)
        idx = torch.where(flat == conf[..., None], lin, n).amin(-1)
        idx = torch.where(idx == n, 0, idx)
        kp = torch.stack([(idx % hw_).float(),
                          torch.div(idx, hw_, rounding_mode="floor").float()],
                         -1)
        kp = torch.where(conf[..., None] > 0.0, kp, 0.0)
        visible = conf >= self.kp_thresholds
        # to image pixels (the images are at the detector size) through the
        # truncated box corners
        scale = torch.tensor([h, w, h, w], dtype=torch.float32,
                             device=x.device)
        bt = torch.trunc(norm * scale)
        scale = torch.stack([(bt[..., 3] - bt[..., 1]) / hw_,
                             (bt[..., 2] - bt[..., 0]) / hh], -1)
        kp = kp * scale[..., None, :] + \
            torch.stack([bt[..., 1], bt[..., 0]], -1)[..., None, :]
        px_height = (bt[..., 2] - bt[..., 0]).clamp_min(1.0)
        hgt = torch.as_tensor(np.asarray(heights, np.float32),
                              device=x.device)
        to_cm = hgt[:, None] / px_height
        e1 = torch.einsum("sk,bpkc->bpsc", self.p1, kp)
        e2 = torch.einsum("sk,bpkc->bpsc", self.p2, kp)
        dist = torch.linalg.vector_norm(e1 - e2, dim=-1)
        seg_vis = torch.where(self.req, visible[..., None, :], True).all(-1)
        seg_vis = seg_vis & (dist > 0.0) & valid[..., None]
        lengths = torch.where(seg_vis, dist * to_cm[..., None], 0.0)
        out = dict(valid=valid, score=decided, kp_conf=conf,
                   lengths=lengths, visible=seg_vis, boxes=boxes)
        return {key: v.cpu().numpy() for key, v in out.items()}
