"""YOLOv5 weights and inputs shared by the port's YOLO tests
(tests/test_torch_port_yolo.py) and the goldens generator
(tests/test_torch_port_yolo_goldens.py).

Both sides load the same numbers: `seeded` makes a port `state_dict` with
`models.yolo_weights.seeded_state` (numpy generator, BatchNorm statistics
calibrated on the images the test feeds, Detect objectness and person
biases shaped so that persons come out), and `to_flax` lays it out as the
flax variable tree of the JAX `YoloV5`.
"""

import numpy as np
import torch

from human_body_proportion_estimation_tpu.models import yolov5 as jyolo
from human_body_proportion_estimation_tpu_torch.models import yolov5 as tyolo
from human_body_proportion_estimation_tpu_torch.models.yolo_weights import (
    seeded_state,
)
from human_body_proportion_estimation_tpu_torch.ops import (
    boxes as tboxes,
    image as timage,
    nms as tnms,
)

# a reduced YOLOv5: C3 depths 1/2/3/1, widths 8..128, at 128x128 input
TINY = dict(depth_mult=0.33, width_mult=0.125)
TINY_SIZE = 128


def configs(**kw):
    """(JAX config, port config) with the same fields."""
    return jyolo.YoloV5Config(**kw), tyolo.YoloV5Config(**kw)


def model_inputs(images_u8: np.ndarray, size: int) -> np.ndarray:
    """uint8 NHWC images -> the model inputs the YOLO backend makes of
    them: letterboxed to size x size with gray 128, / 255, NCHW f32."""
    boxed = timage.letterbox(torch.from_numpy(images_u8).float(), size, size)
    return (boxed / 255.0).permute(0, 3, 1, 2).numpy()


def seeded(config, seed, calibration, obj_bias=-2.0, person_bias=3.0):
    """numpy state dict from `seeded_state`."""
    return seeded_state(config, seed, calibration, obj_bias, person_bias)


def to_torch(state):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}


def to_flax(state):
    """The port's state dict (numpy) -> {'params', 'batch_stats'} of the
    flax model: OIHW -> HWIO kernels (a `deconv`'s transposed-conv weight
    flipped back), BatchNorm weight -> scale, running statistics ->
    batch_stats (the inverse of `models.weights.flax_to_state_dict`)."""
    tree = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        *path, leaf = key.split(".")
        value = np.asarray(value)
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            col, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight":
            col, name = "params", "kernel" if value.ndim == 4 else "scale"
        else:
            col, name = "params", "bias"
        node = tree[col]
        for p in path:
            node = node.setdefault(p, {})
        if path[-1] == "deconv":
            # torch's transposed conv [in, out, kh, kw] -> flax
            # ConvTranspose (kh, kw, in, out), spatially flipped
            value = np.transpose(value[:, :, ::-1, ::-1], (2, 3, 0, 1))
        elif value.ndim == 4:
            value = np.transpose(value, (2, 3, 1, 0))
        node[name] = np.ascontiguousarray(value, dtype=np.float32)
    return tree


def port_model(config, state, dtype=torch.float32):
    model = tyolo.YoloV5(config, dtype=dtype)
    model.load_state_dict(to_torch(state), strict=True)
    return model.eval()


def decision_margins(heads, det_threshold, top_k=128, max_persons=3,
                     conf_thres=0.4, iou_thres=0.5):
    """How far each decision of the YOLO person path lies from flipping,
    image by image, from the raw heads of the port's f32 forward on the
    CPU: the smallest distance of an anchor's objectness and confidence
    from `conf_thres` (over the anchors whose objectness could pass), of
    the person logit from the best other class logit (over the anchors
    that could pass), of the top-k cut (the score gap at it), of a
    deciding IoU from `iou_thres` (every pair of a kept box and a later
    live one), of a kept person's score from `det_threshold`, and the
    gaps between the first four kept scores (the slot order and the cut
    after the third). Returns a list of dicts of floats (inf where a
    decision does not arise) and the number of persons per image."""
    no = heads[0].shape[-1] // 3
    near = 1e-3
    bxywh, obj, best_cls, best_logit = tyolo.decode_scored(heads)
    person = torch.cat([h.reshape(*h.shape[:3], 3, no)[..., 5].reshape(
        h.shape[0], -1) for h in heads], 1)
    other = torch.cat([h.reshape(*h.shape[:3], 3, no)[..., 6:].amax(-1)
                       .reshape(h.shape[0], -1) for h in heads], 1)
    conf = torch.sigmoid(best_logit) * obj
    out, persons = [], []
    inf = float("inf")
    for i in range(obj.shape[0]):
        m = {}
        m["objectness"] = float((obj[i] - conf_thres).abs().min())
        may = obj[i] > conf_thres - near
        m["confidence"] = float((conf[i][may] - conf_thres).abs().min()) \
            if may.any() else inf
        may = may & (torch.sigmoid(person[i]) * obj[i] > conf_thres - near)
        m["person_class"] = float((person[i][may] - other[i][may]).abs()
                                  .min()) if may.any() else inf
        res = tnms.yolo_nms_scored(bxywh[i], obj[i], best_cls[i],
                                   best_logit[i], conf_thres, iou_thres,
                                   100, top_k, class_filter=0)
        valid = (obj[i] > conf_thres) & (conf[i] > conf_thres) & (
            best_cls[i] == 0)
        scores = torch.sort(torch.where(valid, conf[i], 0.0),
                            descending=True).values
        n = int(valid.sum())
        m["top_k_cut"] = float(scores[top_k - 1] - scores[top_k]) \
            if n > top_k else inf
        top = scores[:min(n, top_k)]
        boxes = tboxes.xywh2xyxy(bxywh[i])[torch.argsort(
            torch.where(valid, conf[i], 0.0), descending=True,
            stable=True)[:len(top)]]
        keep = tnms.nms_mask(boxes, top, iou_thres)
        iou = tboxes.box_iou(boxes, boxes)
        later = torch.triu(torch.ones_like(iou, dtype=torch.bool), 1)
        deciding = keep[:, None] & later
        m["iou"] = float((iou[deciding] - iou_thres).abs().min()) \
            if deciding.any() else inf
        kept = res.scores[res.valid]
        m["det_threshold"] = float((kept - det_threshold).abs().min()) \
            if len(kept) else inf
        lead = torch.sort(kept, descending=True).values[:max_persons + 1]
        m["slot_order"] = float((lead[:-1] - lead[1:]).min()) \
            if len(lead) > 1 else inf
        out.append(m)
        persons.append(int((kept >= det_threshold).sum()))
    return out, persons
