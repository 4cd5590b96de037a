"""The port's training (`models/layers.batch_norm` in train mode,
`init_flax_default`, `training/{trainer,detection,bottomup,certify}.py`)
against the JAX package's, on tiny models on the CPU.

Precision. Flax's train-mode BatchNorm takes the variance as
E[x^2] - E[x]^2 in f32 (flax 0.12 `use_fast_variance`), which loses
digits to cancellation when a channel's mean is large beside its spread
(1.6e-5 of the output against float64 on N(0.7, 0.4) inputs, where the
port's BatchNorm is 5.7e-7 off), and a stack of train-mode BatchNorms on
tiny batches amplifies that noise into the gradients (up to 8% of a
tensor's largest gradient on the tiny HRNet at batch 2). So the model
gradients are held in float64 on both sides, where the two frameworks
compute the same function: the JAX modules at dtype float64 under
`jax.enable_x64`, the port modules in double, on the same f32-valued
weights (the heads and the losses stay f32 on both sides, as in the
models). Losses are held in f32 too: the resident loops' first losses at
1e-5 relative, the later ones at 1e-4 with the loops run at rate 1e-5.
Adam's first steps move every parameter by about +-lr whatever the size
of its gradient, so the elements whose f32 gradients lie within rounding
of 0 move apart between two stacks, and even between torch on one CPU
thread and on eight; the loss feels that as lr^2 and the steps' own
progress as lr (measured at 1e-4: up to 5.3e-4 apart, at 1e-3 up to
1.2e-2; at 1e-5 2.4e-5 on either thread count). Functional pieces
(targets,
BatchNorm on zero-mean inputs, the losses, the optimizer fed JAX's own
gradients) are held in f32.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from human_body_proportion_estimation_tpu.models import efficientdet as jedet
from human_body_proportion_estimation_tpu.models.anchors import (
    generate_anchors,
)
from human_body_proportion_estimation_tpu.models.higherhrnet import (
    HigherHRNet as JHigher,
)
from human_body_proportion_estimation_tpu.models.hrnet import (
    HRNet as JHRNet,
    HRNetConfig as JHRConfig,
)
from human_body_proportion_estimation_tpu.training import (
    bottomup as JBU,
    certify as JC,
    detection as JD,
    trainer as JT,
)
from human_body_proportion_estimation_tpu.utils.config import (
    DetectorConfig as JDetectorConfig,
    PipelineConfig as JPipelineConfig,
    PoseConfig as JPoseConfig,
)
from human_body_proportion_estimation_tpu_torch.models import (
    efficientdet as tedet,
    layers,
)
from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
    HigherHRNet,
)
from human_body_proportion_estimation_tpu_torch.models.hrnet import (
    HRNet,
    HRNetConfig,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from human_body_proportion_estimation_tpu_torch.training import (
    bottomup as BU,
    certify as C,
    detection as D,
    trainer as T,
)
from tests.test_torch_port_models import _port_edet_config
from tests.tiny_models import tiny_edet_config

POSE = dict(width=16, stage_modules=(1, 1, 1), blocks_per_branch=1,
            stem_channels=16, bottleneck_channels=16)
CROP_HW, HM_HW, DET_HW, BU_HW = (64, 32), (16, 8), (128, 128), (64, 64)
LOSS_RTOL = 1e-5
RESIDENT_RTOL = 1e-4  # losses after Adam steps at rate 1e-5, f32
# how far the loops move the state against JAX's moves: sound runs read
# <= 0.076 (parameters) and <= 5.3e-5 (running statistics) on the CPU, a
# step that never updates the weights 1.0, torch's unbiased running
# variance 0.022-0.069 and statistics left unchanged 1.0
# (`python -m tests.torch_port_train_faults`)
UPDATE_RTOL = {"params": 0.3, "stats": 1e-3}
GRAD_TOL = 1e-4      # of each tensor's largest |g|


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tiny models gain nothing from torch's intra-op threads, and
    beside the suite's other workers those threads oversubscribe the CPU
    (each op's parallel region waits for all of them): one thread a test,
    the process's setting restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


_INITS = {}


def init_vars(model, hw, seed=0):
    """flax `init` of `model` at [1, *hw, 3], jitted (a non-jitted init of
    these models costs ~10 s on the CPU), made once a module."""
    key = (repr(model), hw, seed)
    if key not in _INITS:
        _INITS[key] = np_tree(jax.jit(model.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3), jnp.float32)))
    return _INITS[key]


def jitted_init(model):
    """`model` with a jitted `init`, for the JAX functions that init the
    model they are given (`create_train_state`, the resident loops)."""
    return types.SimpleNamespace(init=jax.jit(model.init), apply=model.apply,
                                 config=getattr(model, "config", None))


def capture_tx():
    """An optax transformation whose updates are 0 and whose state becomes
    the gradients: JAX's own train step then hands back (loss, grads,
    batch_stats) of one step."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def to64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def port_double(model, variables):
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model.double()


def assert_grads(model, jax_grads, tol=GRAD_TOL):
    """Every parameter's gradient against JAX's, at `tol` of the tensor's
    largest |g| (a parameter with no gradient counts as 0, as JAX's). A
    tensor whose gradient is 0 in exact arithmetic (the bias of a conv
    that a train-mode BatchNorm follows: the batch mean takes any shift
    out) holds only rounding noise, ~1e-17 of the model's gradients in
    float64 on both sides; such tensors are held at 1e-10 of the model's
    largest |g|."""
    ref = flax_to_state_dict({"params": jax_grads})
    floor = 1e-10 / tol * max(float(v.abs().max()) for k, v in ref.items()
                              if "running" not in k)
    worst = {}
    for name, p in model.named_parameters():
        g = (p.grad.double().numpy() if p.grad is not None
             else np.zeros(p.shape))
        r = ref[name].double().numpy()
        scale = max(float(np.abs(r).max()), floor)
        worst[name] = float(np.abs(g - r).max()) / scale
    bad = {k: v for k, v in worst.items() if v > tol}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    assert len(worst) == len(ref) - sum(
        k.endswith(("running_mean", "running_var", "num_batches_tracked"))
        for k in ref)


def assert_stats(model, jax_stats, rtol=1e-6):
    ref = flax_to_state_dict({"batch_stats": jax_stats})
    n = 0
    for key, value in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            r = ref[key].double().numpy()
            # a running mean that is 0 in exact arithmetic (a conv of
            # BatchNorm-centred inputs) holds ~1e-17 of rounding
            np.testing.assert_allclose(
                value.double().numpy(), r, rtol=rtol,
                atol=rtol * max(np.abs(r).max(), 1e-6), err_msg=key)
            n += 1
    assert n == len([k for k in ref if "running" in k]) > 0


def update_rel_errs(model, initial, port_state, jax_vars):
    """How far the port's loop moved the state from `initial` against how
    far JAX's moved it: |d_port - d_jax| / |d_jax| over the parameters,
    and over the running statistics. A step that never updates the
    parameters (or the statistics) reads 1."""
    ref = flax_to_state_dict(np_tree(jax_vars))
    params = {n for n, _ in model.named_parameters()}
    out = {}
    for group, keys in (
            ("params", params),
            ("stats", {k for k in ref if k.endswith(("running_mean",
                                                     "running_var"))})):
        d_port = np.concatenate([(port_state[k] - initial[k]).double()
                                 .numpy().ravel() for k in sorted(keys)])
        d_jax = np.concatenate([(ref[k] - initial[k]).double().numpy()
                                .ravel() for k in sorted(keys)])
        out[group] = float(np.linalg.norm(d_port - d_jax)
                           / np.linalg.norm(d_jax))
    return out


# --------------------------------------------------------------------- #
# BatchNorm and init


def test_train_mode_batch_norm_matches_flax():
    """N*H*W = 128 zero-mean inputs: output and running statistics at
    1e-6; the running variance moves with the BIASED variance, as flax's
    does (torch's own update would be n / (n - 1) = 0.8% larger)."""
    rng = np.random.default_rng(0)
    c = 8
    x = rng.normal(0.0, 1.0, (2, 8, 8, c)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-3, dtype=jnp.float32)
    v = np_tree(bn.init(jax.random.PRNGKey(0), x))
    v["params"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    v["params"]["bias"] = rng.normal(0, 0.3, c).astype(np.float32)
    v["batch_stats"]["mean"] = rng.normal(0, 0.3, c).astype(np.float32)
    v["batch_stats"]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jy, upd = bn.apply(v, x, mutable=["batch_stats"])

    tb = torch.nn.BatchNorm2d(c, eps=1e-3)
    tb.load_state_dict(flax_to_state_dict(v))
    tb.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ty = layers.batch_norm(tb, xt).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ty, np.asarray(jy), rtol=1e-6, atol=1e-6)
    stats = np_tree(upd["batch_stats"])
    np.testing.assert_allclose(tb.running_mean.numpy(), stats["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb.running_var.numpy(), stats["var"],
                               rtol=1e-6, atol=1e-7)
    # torch's own train-mode update (unbiased variance) misses by ~0.8%
    # of the batch variance's share
    plain = torch.nn.BatchNorm2d(c, eps=1e-3, momentum=0.1)
    plain.load_state_dict(flax_to_state_dict(v))
    plain.train()(xt)
    gap = np.abs(plain.running_var.numpy() - stats["var"])
    biased = x.reshape(-1, c).var(0)
    np.testing.assert_allclose(gap, 0.1 * biased / 127, rtol=1e-3)
    assert gap.min() > 100 * np.abs(tb.running_var.numpy()
                                    - stats["var"]).max()
    # eval mode reads the (moved) running statistics
    tb.eval()
    jev = bn.clone(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": stats}, x)
    np.testing.assert_allclose(
        layers.batch_norm(tb, xt).detach().permute(0, 2, 3, 1).numpy(),
        np.asarray(jev), rtol=1e-5, atol=1e-5)


def test_init_flax_default_matches_flax_statistics():
    """The port's init with seed 0 is flax's `init` with PRNGKey(0), leaf
    for leaf (`models/flax_init`): kernels within 4 float32 ulps, biases
    0, BN (1, 0, 0, 1) exactly; so every statistic of it is flax's."""
    jv = init_vars(JHigher(config=JHRConfig(**POSE), num_deconv_blocks=1,
                           dtype=jnp.float32), BU_HW)
    ref = flax_to_state_dict(jv)
    model = HigherHRNet(HRNetConfig(**POSE), num_deconv_blocks=1)
    sd = layers.init_flax_default(model, 0).state_dict()
    assert sd.keys() == ref.keys()
    checked = 0
    for key, value in sd.items():
        r = ref[key].numpy()
        if key.endswith("weight") and value.dim() == 4:
            ulps = np.abs(value.numpy().view(np.int32).astype(np.int64)
                          - r.view(np.int32))
            assert ulps.max() <= 4, key
            checked += 1
        elif key.endswith("num_batches_tracked"):
            continue
        else:
            np.testing.assert_array_equal(value.numpy(), r, err_msg=key)
    assert checked > 20


# --------------------------------------------------------------------- #
# targets and losses (functional, f32)


def test_heatmap_targets_match():
    rng = np.random.default_rng(1)
    kp = rng.uniform(-2, 20, (3, 17, 2)).astype(np.float32)
    vis = rng.random((3, 17)) < 0.7
    j = np.asarray(JT.heatmap_targets(jnp.asarray(kp), jnp.asarray(vis),
                                      16, 12, 1.5))
    t = T.heatmap_targets(torch.from_numpy(kp), torch.from_numpy(vis), 16,
                          12, 1.5).numpy()
    np.testing.assert_allclose(t.transpose(0, 2, 3, 1), j, atol=1e-6)

    kp = rng.uniform(-2, 40, (2, 3, 17, 2)).astype(np.float32)
    vis = rng.random((2, 3, 17)) < 0.7
    j = np.asarray(JBU.multi_person_heatmap_targets(
        jnp.asarray(kp), jnp.asarray(vis), 32, 24))
    t = BU.multi_person_heatmap_targets(
        torch.from_numpy(kp), torch.from_numpy(vis), 32, 24).numpy()
    np.testing.assert_allclose(t.transpose(0, 2, 3, 1), j, atol=1e-6)


def det_anchors(hw=DET_HW):
    return generate_anchors(tiny_edet_config().anchors, *hw)


def gt_cases():
    """Ground truth of three images, padded to G = 4: an ordinary box and
    a padded slot; two identical boxes (ties between ground truths) and a
    box too small for IoU 0.5 (forced match); a padded slot that holds a
    box, and a NaN box."""
    boxes = np.array([
        [[20, 30, 90, 70], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
        [[10, 10, 60, 60], [10, 10, 60, 60], [70, 70, 73, 72],
         [0, 0, 0, 0]],
        [[30, 40, 100, 120], [5, 5, 50, 50], [np.nan, 0, 10, 10],
         [0, 0, 0, 0]],
    ], np.float32)
    valid = np.array([[1, 0, 0, 0], [1, 1, 1, 0], [1, 0, 1, 0]], bool)
    classes = np.array([[0, 3, 0, 0], [0, 5, 2, 0], [7, 0, 1, 0]], np.int32)
    return boxes, classes, valid


def test_match_anchors_exact():
    anchors = det_anchors()
    boxes, _, valid = gt_cases()
    got_m, got_s = D.match_anchors(torch.from_numpy(anchors),
                                   torch.from_numpy(boxes),
                                   torch.from_numpy(valid))
    for i in range(len(boxes)):
        m, s = JD.match_anchors(jnp.asarray(anchors), jnp.asarray(boxes[i]),
                                jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got_s[i].numpy(), np.asarray(s))
        np.testing.assert_array_equal(got_m[i].numpy(), np.asarray(m))
        one = D.match_anchors(torch.from_numpy(anchors),
                              torch.from_numpy(boxes[i]),
                              torch.from_numpy(valid[i]))
        np.testing.assert_array_equal(one[1].numpy(), np.asarray(s))
    # the forced match and both ground truths of the tie are used
    s1 = got_s[1].numpy()
    assert set(got_m[1].numpy()[s1 == 1]) >= {0, 2}


def test_regression_and_focal_losses_match():
    rng = np.random.default_rng(2)
    anchors = det_anchors()
    n = anchors.shape[0]
    gt = np.concatenate([rng.uniform(0, 60, (n, 2)),
                         rng.uniform(61, 128, (n, 2))], 1).astype(np.float32)
    gt[:5, 2:] = gt[:5, :2]     # degenerate boxes: the 1e-6 floor
    j = np.asarray(JD.regression_targets(jnp.asarray(anchors),
                                         jnp.asarray(gt)))
    t = D.regression_targets(torch.from_numpy(anchors),
                             torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)

    logits = rng.normal(0, 3, (n, 90)).astype(np.float32)
    targets = (rng.random((n, 90)) < 0.01).astype(np.float32)
    weight = (rng.random(n) < 0.9).astype(np.float32)
    j = float(JD.focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                            jnp.asarray(weight)))
    t = float(D.focal_loss(torch.from_numpy(logits),
                           torch.from_numpy(targets),
                           torch.from_numpy(weight)))
    assert abs(t - j) <= 1e-6 * abs(j)


def test_detection_loss_and_grads_match():
    rng = np.random.default_rng(3)
    anchors = det_anchors()
    n = anchors.shape[0]
    boxes, classes, valid = gt_cases()
    boxes, classes, valid = boxes[:2], classes[:2], valid[:2]
    logits = rng.normal(-3, 2, (2, n, 90)).astype(np.float32)
    regs = rng.normal(0, 0.3, (2, n, 4)).astype(np.float32)

    def jloss(lg, rg):
        return JD.detection_loss(lg, rg, jnp.asarray(anchors),
                                 jnp.asarray(boxes), jnp.asarray(classes),
                                 jnp.asarray(valid), 90)

    jl, (jgl, jgr) = jax.value_and_grad(jloss, (0, 1))(
        jnp.asarray(logits), jnp.asarray(regs))
    lg = torch.from_numpy(logits).requires_grad_()
    rg = torch.from_numpy(regs).requires_grad_()
    tl = D.detection_loss(lg, rg, torch.from_numpy(anchors),
                          torch.from_numpy(boxes), torch.from_numpy(classes),
                          torch.from_numpy(valid), 90)
    tl.backward()
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for g, r in ((lg.grad, jgl), (rg.grad, jgr)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max())


def test_ae_loss_and_grads_match():
    """Keypoints below 0 and beyond the map: JAX's int32 cast truncates
    toward zero (-0.7 -> 0, -1.5 -> -1) and then clips; a person with no
    visible joint and padded slots add nothing."""
    rng = np.random.default_rng(4)
    tags = rng.normal(0, 1, (2, 17, 16, 12)).astype(np.float32)
    kp = rng.uniform(-3, 16, (2, 3, 17, 2)).astype(np.float32)
    kp[0, 0, :3, 0] = [-0.7, -1.5, 11.99]
    vis = rng.random((2, 3, 17)) < 0.7
    vis[1, 2] = False

    jl, jg = jax.value_and_grad(lambda t: JBU.ae_loss(
        t, jnp.asarray(kp), jnp.asarray(vis)))(
            jnp.asarray(tags.transpose(0, 2, 3, 1)))
    tt = torch.from_numpy(tags).requires_grad_()
    tl = BU.ae_loss(tt, torch.from_numpy(kp), torch.from_numpy(vis))
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    np.testing.assert_allclose(tt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jg), atol=1e-6)


# --------------------------------------------------------------------- #
# model losses and gradients (float64, see the module docstring)


def pose_batch():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, *CROP_HW, 3)).astype(np.float32)
    kp = rng.uniform(0, 8, (2, 17, 2)).astype(np.float32)
    vis = rng.random((2, 17)) < 0.8
    return x, kp, vis


def test_pose_train_step_loss_grads_and_stats_match():
    x, kp, vis = pose_batch()
    variables = init_vars(JHRNet(config=JHRConfig(**POSE),
                                 dtype=jnp.float32), CROP_HW)
    with jax.enable_x64(True):
        jm = JHRNet(config=JHRConfig(**POSE), dtype=jnp.float64,
                    param_dtype=jnp.float64)
        v64, tx = to64(variables), capture_tx()
        st = JT.PoseTrainState(jnp.zeros((), jnp.int32), v64["params"],
                               v64["batch_stats"], tx.init(v64["params"]))
        tgt = JT.heatmap_targets(jnp.asarray(kp, jnp.float64),
                                 jnp.asarray(vis), *HM_HW)
        new, jl = jax.jit(lambda s, i, t, w: JT.train_step(
            jm, tx, s, i, t, w, fg_weight=12.0))(
                st, jnp.asarray(x, jnp.float64), tgt,
                jnp.asarray(vis, jnp.float64))
        jl, grads, stats = float(jl), np_tree(new.opt_state), np_tree(
            new.batch_stats)

    tm = port_double(HRNet(HRNetConfig(**POSE), dtype=torch.float64),
                     variables)
    state = T.create_train_state(tm, None, learning_rate=0.0)
    ttgt = T.heatmap_targets(torch.from_numpy(kp).double(),
                             torch.from_numpy(vis), *HM_HW)
    _, tl = T.train_step(state, torch.from_numpy(x).double().permute(
        0, 3, 1, 2), ttgt, torch.from_numpy(vis).double(), fg_weight=12.0)
    assert abs(float(tl) - jl) <= LOSS_RTOL * abs(jl)
    assert_grads(tm, grads)
    assert_stats(tm, stats)
    assert state.step == 1


def test_detector_train_step_loss_grads_and_stats_match():
    jcfg = tiny_edet_config()
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (2, *DET_HW, 3), dtype=np.uint8)
    boxes, classes, valid = (a[:2] for a in gt_cases())
    variables = init_vars(jedet.EfficientDet(config=jcfg, dtype=jnp.float32),
                          DET_HW)
    with jax.enable_x64(True):
        jm = jedet.EfficientDet(config=jcfg, dtype=jnp.float64,
                                param_dtype=jnp.float64)
        v64, tx = to64(variables), capture_tx()
        st = JD.DetTrainState(jnp.zeros((), jnp.int32), v64["params"],
                              v64["batch_stats"], tx.init(v64["params"]))
        new, jl = jax.jit(lambda s, *a: JD.train_step(jm, tx, s, *a))(
            st, jnp.asarray(images), jnp.asarray(boxes),
            jnp.asarray(classes), jnp.asarray(valid))
        jl, grads, stats = float(jl), np_tree(new.opt_state), np_tree(
            new.batch_stats)

    tm = port_double(tedet.EfficientDet(_port_edet_config(jcfg),
                                        dtype=torch.float64), variables)
    state = D.create_det_train_state(tm, None, learning_rate=0.0)
    _, tl = D.train_step(state, torch.from_numpy(images),
                         torch.from_numpy(boxes), torch.from_numpy(classes),
                         torch.from_numpy(valid))
    assert abs(float(tl) - jl) <= LOSS_RTOL * abs(jl)
    assert_grads(tm, grads)
    assert_stats(tm, stats)
    # the score-kernel path has no backward: a training forward refuses it
    with pytest.raises(ValueError, match="all_classes"):
        tm(torch.from_numpy(images))


def test_bottomup_train_step_loss_grads_and_stats_match():
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, *BU_HW, 3)).astype(np.float32)
    kp = rng.uniform(0, 63, (2, 3, 17, 2)).astype(np.float32)
    vis = rng.random((2, 3, 17)) < 0.8
    vis[1, 2] = False
    variables = init_vars(JHigher(config=JHRConfig(**POSE),
                                  num_deconv_blocks=1, dtype=jnp.float32),
                          BU_HW)
    with jax.enable_x64(True):
        jm = JHigher(config=JHRConfig(**POSE), num_deconv_blocks=1,
                     dtype=jnp.float64, param_dtype=jnp.float64)
        v64, tx = to64(variables), capture_tx()
        st = JT.PoseTrainState(jnp.zeros((), jnp.int32), v64["params"],
                               v64["batch_stats"], tx.init(v64["params"]))
        new, jl = jax.jit(lambda s, i, k, v: JBU.bottomup_train_step(
            jm, tx, s, i, k, v, ae_weight=1e-3, fg_weight=12.0))(
                st, jnp.asarray(x, jnp.float64), jnp.asarray(kp),
                jnp.asarray(vis))
        jl, grads, stats = float(jl), np_tree(new.opt_state), np_tree(
            new.batch_stats)

    tm = port_double(HigherHRNet(HRNetConfig(**POSE), num_deconv_blocks=1,
                                 dtype=torch.float64), variables)
    state = T.create_train_state(tm, None, learning_rate=0.0)
    _, tl = BU.bottomup_train_step(
        state, torch.from_numpy(x).double().permute(0, 3, 1, 2),
        torch.from_numpy(kp), torch.from_numpy(vis), ae_weight=1e-3,
        fg_weight=12.0)
    assert abs(float(tl) - jl) <= LOSS_RTOL * abs(jl)
    assert_grads(tm, grads)
    assert_stats(tm, stats)


# --------------------------------------------------------------------- #
# the optimizer, fed JAX's own gradients (f32)


def test_adam_schedule_and_clip_match_optax():
    """Adam with the warmup + cosine schedule and the global-norm clip at
    10, four steps on JAX gradients of the tiny HRNet rescaled to global
    norms 5, 50, 0.5 and 20 (clipped twice): parameters at 1e-6 after
    every step, none moved by the first (lr 0), and the rate at every
    count at 1e-6 of optax's."""
    variables = init_vars(JHRNet(config=JHRConfig(**POSE),
                                 dtype=jnp.float32), CROP_HW)
    params = variables["params"]
    x, kp, vis = pose_batch()
    jm = JHRNet(config=JHRConfig(**POSE), dtype=jnp.float32)
    grads = jax.jit(jax.grad(lambda p: jnp.mean((jm.apply(
        {"params": p, "batch_stats": variables["batch_stats"]},
        jnp.asarray(x)) - JT.heatmap_targets(
            jnp.asarray(kp), jnp.asarray(vis), *HM_HW)) ** 2)))(params)
    gnorm = float(optax.global_norm(grads))

    schedule = optax.warmup_cosine_decay_schedule(
        0.0, 5e-4, 2, 10, end_value=0.03 * 5e-4)
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(schedule))
    opt_state = tx.init(params)

    tm = HRNet(HRNetConfig(**POSE), dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    state = D.create_det_train_state(tm, None, 5e-4, total_steps=10,
                                     warmup_steps=2, clip_norm=10.0)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    for i, norm in enumerate((5.0, 50.0, 0.5, 20.0)):
        g = jax.tree.map(lambda a: a * (norm / gnorm), grads)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        tg = flax_to_state_dict({"params": np_tree(g)})
        for name, p in tm.named_parameters():
            p.grad = tg[name].clone()
        T.optimizer_step(state, state.clip_norm)
        ref = flax_to_state_dict({"params": np_tree(params)})
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
        if i == 0:
            assert all(torch.equal(p, before[n])
                       for n, p in tm.named_parameters())
    lrs = []
    sched_state = D.create_det_train_state(
        HRNet(HRNetConfig(**POSE)), None, 5e-4, total_steps=10,
        warmup_steps=2)
    for count in range(14):
        lrs.append(sched_state.optimizer.param_groups[0]["lr"])
        sched_state.scheduler.step()
    ref = [float(schedule(c)) for c in range(14)]
    assert lrs[0] == 0.0 == ref[0]
    np.testing.assert_allclose(lrs, ref, rtol=1e-6, atol=1e-12)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(8)
    tree = {"a": rng.normal(0, 3, (5, 4)).astype(np.float32),
            "b": rng.normal(0, 3, (7,)).astype(np.float32)}
    for max_norm in (1.0, 1e3):
        ref, _ = optax.clip_by_global_norm(max_norm).update(tree, None)
        ps = [torch.nn.Parameter(torch.zeros(v.shape)) for v in tree.values()]
        for p, v in zip(ps, tree.values()):
            p.grad = torch.from_numpy(v.copy())
        norm = T.clip_by_global_norm(ps, max_norm)
        assert abs(float(norm) - float(optax.global_norm(tree))) < 1e-5
        for p, k in zip(ps, tree):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------- #
# the resident loops, three steps at loss level (f32)


def test_train_pose_resident_matches_jax():
    """128x96 crops: at 64x32 the last branch's BatchNorms see 2x1 maps,
    so at batch 2 (or one crop drawn twice) they normalize 2-4 values and
    one Adam step at any rate moves the loss by ~10% on either side."""
    crop_hw = (128, 96)
    jcfg = JPipelineConfig(
        detector=JDetectorConfig(input_height=192, input_width=160),
        pose=JPoseConfig(crop_height=crop_hw[0], crop_width=crop_hw[1],
                         heatmap_height=crop_hw[0] // 4,
                         heatmap_width=crop_hw[1] // 4))
    scenes = JC.make_scenes(6, 0, (192, 160))
    crops, kp_hm, vis, _ = JC.pose_crop_arrays(scenes, jcfg, box_jitter=0.0)
    jm = JHRNet(config=JHRConfig(**POSE), dtype=jnp.float32)
    kw = dict(steps=3, batch=2, learning_rate=1e-5, seed=0, chunk=1,
              sigma=2.0, fg_weight=12.0)
    jvars, jlosses = JC.train_pose_resident(jitted_init(jm), crops, kp_hm,
                                            vis, **kw)
    tm = HRNet(HRNetConfig(**POSE), dtype=torch.float32)
    initial = flax_to_state_dict(init_vars(jm, crop_hw))
    tm.load_state_dict(initial)
    state, tlosses = C.train_pose_resident(tm, crops, kp_hm, vis, **kw)
    err = update_rel_errs(tm, initial, state, jvars)
    assert len(tlosses) == len(jlosses) == 3
    assert abs(tlosses[0] - jlosses[0]) <= LOSS_RTOL * jlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=RESIDENT_RTOL)
    assert set(state) == set(flax_to_state_dict(np_tree(jvars)))
    assert all(err[k] <= UPDATE_RTOL[k] for k in err), err


def test_train_det_resident_matches_jax_and_sets_the_focal_prior():
    jcfg = tiny_edet_config()
    scenes = JC.make_scenes(4, 1, DET_HW)
    imgs, boxes, classes, valid = JC.det_arrays(scenes)
    jm = jedet.EfficientDet(config=jcfg, dtype=jnp.float32)
    kw = dict(steps=3, batch=2, learning_rate=5e-6, seed=0, chunk=1,
              cosine=False)
    wrapped = jitted_init(jm)
    jvars, jlosses = JC.train_det_resident(wrapped, imgs, boxes, classes,
                                           valid, **kw)
    # JAX's initial state: its init from the seed, with the focal prior
    jstate, _ = JD.create_det_train_state(wrapped, jax.random.PRNGKey(0),
                                          (1, *DET_HW, 3))
    initial = flax_to_state_dict(np_tree({"params": jstate.params,
                                          "batch_stats": jstate.batch_stats}))
    prior = float(jnp.log(jnp.asarray(0.01 / 0.99)))
    assert D.FOCAL_PRIOR_BIAS == prior
    assert torch.all(initial["class_net.predict_pw.bias"] == prior)

    tm = tedet.EfficientDet(_port_edet_config(jcfg), dtype=torch.float32)
    tm.load_state_dict(initial)
    state, tlosses = C.train_det_resident(tm, imgs, boxes, classes, valid,
                                          **kw)
    err = update_rel_errs(tm, initial, state, jvars)
    assert abs(tlosses[0] - jlosses[0]) <= LOSS_RTOL * jlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=RESIDENT_RTOL)
    assert all(err[k] <= UPDATE_RTOL[k] for k in err), err

    # the port's own init: flax's, with the prior on the class head only
    fresh = tedet.EfficientDet(_port_edet_config(jcfg))
    D.init_det_flax(fresh, 0)
    assert torch.all(fresh.class_net.predict_pw.bias == prior)
    assert torch.all(fresh.box_net.predict_pw.bias == 0.0)


def test_sharded_steps_and_mesh_raise_naming_item_16():
    """The sharded steps of item 16 are ported
    (tests/test_torch_port_sharded_train.py holds them); a mesh of two
    devices without a process group of that size raises, naming
    torch.distributed, in each of them and in `train_pose(mesh=)`."""
    from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from human_body_proportion_estimation_tpu_torch.training import loop

    mesh = make_mesh(devices=["cpu", "cpu"])
    state = T.create_train_state(HRNet(HRNetConfig(**POSE)), None)
    for fn in (T.make_sharded_train_step, D.make_sharded_det_train_step,
               BU.make_sharded_bottomup_step):
        with pytest.raises(ValueError, match="torch.distributed"):
            fn(state, mesh)
    with pytest.raises(ValueError, match="torch.distributed"):
        loop.train_pose(HRNet(HRNetConfig(**POSE)), [], mesh=mesh)


def test_state_dict_to_flax_inverts_the_converter():
    variables = init_vars(JHigher(config=JHRConfig(**POSE),
                                  num_deconv_blocks=1, dtype=jnp.float32),
                          BU_HW)
    sd = flax_to_state_dict(variables)
    back = state_dict_to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_train_pose_loop_trains_and_checkpoints(tmp_path, monkeypatch):
    """`training/loop.train_pose` on two samples: augmented batches from
    `training/data`, finite losses, and an Orbax checkpoint `step_N/` at
    every `checkpoint_every` steps and at the end, which JAX's
    `PyTreeCheckpointer` restores to the port reader's tree and which
    reloads into the model."""
    import orbax.checkpoint as ocp

    from human_body_proportion_estimation_tpu_torch.models import (
        orbax_store,
    )
    from human_body_proportion_estimation_tpu_torch.training import (
        data,
        loop,
    )
    from tests.torch_port_orbax import assert_bit_equal, block_tensorstore

    samples = []
    for sc in JC.make_scenes(2, 3, (192, 160)):
        x1, y1, x2, y2 = sc.bbox_xyxy
        samples.append(data.PoseSample(sc.image, sc.keypoints, sc.visible,
                                       np.array([x1, y1, x2 - x1, y2 - y1],
                                                np.float32)))
    model = HRNet(HRNetConfig(**POSE), dtype=torch.float32)
    block_tensorstore(monkeypatch)
    state, losses = loop.train_pose(
        model, samples, steps=3, batch_size=2, crop_hw=CROP_HW,
        checkpoint_dir=str(tmp_path), checkpoint_every=2, log_every=1)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert state.step == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2",
                                                          "step_3"]
    tree = orbax_store.load_tree(str(tmp_path / "step_3"))
    ref = ocp.PyTreeCheckpointer().restore(str(tmp_path / "step_3"))
    assert_bit_equal(tree, jax.tree.map(np.asarray, ref))
    assert int(tree["step"]) == 3
    back = flax_to_state_dict({k: tree[k] for k in ("params",
                                                    "batch_stats")})
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v.to(back[k].dtype)), k
