"""The full-width train-step cases of tests/data/torch_port/train_goldens.json,
shared by its generator (tests/test_torch_port_train_goldens.py) and by
`chip_smoke.py` phase T, which loads this file by path: it imports only
torch, numpy and the port.

Three models at full width and depth, batch 2, on rendered scenes
(`training/synthetic.py`, the same bytes on every machine):
  * pose: HRNet-W32 at 384x288 on the committed certified weights, the
    certify recipe's loss (sigma 2, peak weight 12, visibility weights);
  * det: EfficientDet-Lite0 at 480x640 from a flax-like init drawn with
    numpy (`flax_like_state`: LeCun-normal kernels, zero biases, BN at
    (1, 0, 0, 1), the focal prior on the class head), the detection loss;
  * bottomup: HigherHRNet-W32 at 512x512 from the same kind of init, the
    joint heatmap + AE loss (peak weight 12, AE weight 1e-3).
Each case takes three Adam steps at its certify rate and reports the
losses before each step, the global gradient norm and the norms of a few
named gradients of the first step, and two BatchNorms' running statistics
after it (`run_port`).
"""

import numpy as np
import torch

SEED = 0
BATCH = 2
STEPS = 3
LR = {"pose": 1e-3, "det": 5e-4, "bottomup": 1e-3}
GRADS = {
    "pose": ["stem1.conv.weight", "layer1_0.conv2.bn.weight",
             "stage4_module2.fuse.up_1_0.conv.weight", "head.weight",
             "head.bias"],
    "det": ["backbone.stem.conv.weight", "bifpn2.bu_4.pointwise.weight",
            "class_net.predict_pw.weight", "class_net.predict_pw.bias",
            "box_net.predict_pw.weight"],
    "bottomup": ["stem1.conv.weight", "head1.weight", "deconv.weight",
                 "deconv_bn.weight", "head2.weight"],
}
# two BatchNorms a case: the first layer's (most values a channel) and one
# of the coarsest maps (fewest: 216, 40 and 512 a channel at batch 2), where
# the unbiased variance n / (n - 1) that torch's own train-mode update
# would take shows (4.6e-3, 2.6e-2 and 2.0e-3 relative)
BN = {"pose": ("stem1.bn", "stage4_module2.branch3_block3.conv2.bn"),
      "det": ("backbone.stem.bn", "class_net.bn2_l4"),
      "bottomup": ("deconv_bn", "stage4_module2.branch3_block3.conv2.bn")}


def flax_like_state(model, seed):
    """A `state_dict` for `model` drawn from `np.random.default_rng(seed)`,
    key after key: LeCun-normal conv and transposed-conv kernels (std
    fan_in^-1/2, the fan flax counts), zero biases, BatchNorm at unit
    scale, zero shift, mean 0, variance 1 (f32 numpy)."""
    from human_body_proportion_estimation_tpu_torch.models.layers import (
        _fan_in,
    )

    rng = np.random.default_rng(seed)
    state = {}
    for key, value in model.state_dict().items():
        module_name, leaf = key.rsplit(".", 1)
        module = model.get_submodule(module_name)
        shape = tuple(value.shape)
        if leaf == "num_batches_tracked":
            state[key] = np.zeros(shape, np.int64)
        elif leaf == "weight" and value.dim() == 4:
            state[key] = rng.normal(0.0, _fan_in(module) ** -0.5,
                                    shape).astype(np.float32)
        elif leaf in ("weight", "running_var"):
            state[key] = np.ones(shape, np.float32)
        else:
            state[key] = np.zeros(shape, np.float32)
    return state


def model_and_state(kind, dtype=torch.float32):
    """(port model in eval mode on the CPU, its f32 numpy state) of a case."""
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
        EFFICIENTDET_LITE0,
        EfficientDet,
    )
    from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
        HigherHRNet,
    )
    from human_body_proportion_estimation_tpu_torch.models.hrnet import HRNet
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        default_certified_checkpoint,
        flax_to_state_dict,
        load_compact_checkpoint,
    )
    from human_body_proportion_estimation_tpu_torch.training.detection import (
        FOCAL_PRIOR_BIAS,
    )

    if kind == "pose":
        model = HRNet(dtype=dtype)
        _, pose = load_compact_checkpoint(default_certified_checkpoint())
        state = {k: v.numpy() for k, v in flax_to_state_dict(pose).items()}
    elif kind == "det":
        model = EfficientDet(EFFICIENTDET_LITE0, dtype=dtype)
        state = flax_like_state(model, SEED)
        state["class_net.predict_pw.bias"][:] = FOCAL_PRIOR_BIAS
    else:
        model = HigherHRNet(dtype=dtype)
        state = flax_like_state(model, SEED + 1)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                          strict=True)
    return model, state


def inputs(kind, batch=BATCH):
    """The case's batch as numpy arrays (NHWC uint8 images), made from
    `SEED` with the port's scene generator."""
    from human_body_proportion_estimation_tpu_torch.training import (
        certify,
        certify_bottomup,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        PipelineConfig,
    )

    if kind == "bottomup":
        scenes = certify_bottomup.make_multi_scenes(batch, SEED, (512, 512))
        imgs, kp, vis = certify_bottomup.bottomup_arrays(scenes, 3)
        return {"images": imgs, "keypoints": kp, "visible": vis}
    scenes = certify.make_scenes(batch, SEED, (480, 640))
    if kind == "pose":
        crops, kp_hm, vis, _ = certify.pose_crop_arrays(
            scenes, PipelineConfig(), seed=SEED + 1)
        return {"images": crops, "kp_hm": kp_hm, "visible": vis}
    imgs, boxes, classes, valid = certify.det_arrays(scenes)
    return {"images": imgs, "gt_boxes": boxes, "gt_classes": classes,
            "gt_valid": valid}


def make_state(kind, model):
    """The case's train state over `model` (its weights kept): Adam at the
    case's rate."""
    from human_body_proportion_estimation_tpu_torch.training import (
        detection as D,
        trainer as T,
    )

    if kind == "det":
        return D.create_det_train_state(model, None, LR[kind])
    return T.create_train_state(model, None, LR[kind])


def to_device(batch, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train_once(kind, state, t):
    """One train step of the case on the device batch `t`; the loss."""
    from human_body_proportion_estimation_tpu_torch.training import (
        bottomup as BU,
        detection as D,
        trainer as T,
    )

    dtype = next(state.model.parameters()).dtype
    if kind == "det":
        return D.train_step(state, t["images"], t["gt_boxes"],
                            t["gt_classes"].long(), t["gt_valid"])[1]
    imgs = t["images"].permute(0, 3, 1, 2).to(dtype) / 255.0
    if kind == "pose":
        tgt = T.heatmap_targets(t["kp_hm"], t["visible"], 96, 72, 2.0)
        return T.train_step(state, imgs, tgt, t["visible"].float(),
                            fg_weight=12.0)[1]
    return BU.bottomup_train_step(state, imgs, t["keypoints"], t["visible"],
                                  ae_weight=1e-3, fg_weight=12.0)[1]


def run_port(kind, model, batch, device):
    """Three Adam steps of the port's train step for the case on `model`
    (any dtype, moved to `device`): {"losses": [3], "grad_norm",
    "grad_norms": {name: norm}, "bn_mean", "bn_var", "bn_low_mean",
    "bn_low_var"} (the first step's gradients, the two BatchNorms' running
    statistics after it)."""
    state = make_state(kind, model.to(device))
    t = to_device(batch, device)
    out = {"losses": []}
    for i in range(STEPS):
        out["losses"].append(float(train_once(kind, state, t)))
        if i == 0:
            grads = {n: p.grad.double() for n, p in model.named_parameters()
                     if p.grad is not None}
            out["grad_norm"] = float(torch.sqrt(sum(
                (g * g).sum() for g in grads.values())))
            out["grad_norms"] = {n: float(grads[n].norm())
                                 for n in GRADS[kind]}
            for prefix, name in zip(("bn", "bn_low"), BN[kind]):
                bn = model.get_submodule(name)
                out[f"{prefix}_mean"] = bn.running_mean.double().cpu().tolist()
                out[f"{prefix}_var"] = bn.running_var.double().cpu().tolist()
    model.eval()
    return out


def compare(got, ref):
    """The largest relative difference of every recorded quantity of a case
    (vectors: over the vector's largest magnitude). `losses_after_adam`
    are the losses after the first and second Adam steps, which move every
    parameter by about +-lr whatever the size of its gradient: elements
    whose gradient lies within rounding of 0 move apart between two
    stacks, so they are held to their own tolerance."""
    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    out = {"loss_0": rel(got["losses"][0], ref["losses"][0]),
           "losses_after_adam": max(rel(a, b) for a, b in zip(
               got["losses"][1:], ref["losses"][1:])),
           "grad_norm": rel(got["grad_norm"], ref["grad_norm"])}
    for key in ("bn_mean", "bn_var", "bn_low_mean", "bn_low_var"):
        out[key] = rel(got[key], ref[key])
    for name, v in ref["grad_norms"].items():
        out[name] = rel(got["grad_norms"][name], v)
    return out


def group(err):
    """A case's relative differences by what holds them: the first step's
    loss and gradients, the BatchNorm statistics after it, and the losses
    after the Adam steps (the largest of each group)."""
    return {
        "first_step": max(v for k, v in err.items()
                          if k != "losses_after_adam"
                          and not k.startswith("bn_")),
        "bn": max(v for k, v in err.items() if k.startswith("bn_")),
        "after_adam": err["losses_after_adam"]}
