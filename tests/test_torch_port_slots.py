"""The port's other slots (ROADMAP item 12) against the JAX package on the
CPU: EfficientDet-Lite0 (the detector at full width, its head-score plain
path at F = 64, `EdetDetectPipeline`), HRNet-W48 (reduced depth),
`preprocess_crop_host`, and the slot resolution of `InferencePipeline`.
The HigherHRNet slot's tests are in tests/test_torch_port_pose_slots.py.

The flax variable trees come from `jax.eval_shape` of `init`, filled from
a seed with numpy as flax initializes them (tests/torch_port_tiny.py),
with random BatchNorm statistics and affines; the port loads them through
`models/weights.flax_to_state_dict`. Both sides compute in float32 (flax
`dtype=float32`, port `dtype=torch.float32`), except the head-score
epilogue, whose product rounds z and W to bf16 on both sides by design.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_body_proportion_estimation_tpu.models import (
    efficientdet as jedet,
    efficientnet_lite as jlite,
    hrnet as jhrnet,
)
from human_body_proportion_estimation_tpu_torch.models import (
    efficientdet as tedet,
    efficientnet_lite as tlite,
    higherhrnet as thh,
    hrnet as thrnet,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from human_body_proportion_estimation_tpu_torch.ops import kernels
from tests.test_torch_port_models import (
    _port_edet_config,
    _port_hrnet_config,
    _randomize_bn,
)
from tests.torch_port_tiny import _filled

TOL = dict(rtol=1e-4, atol=1e-4)
DET_HW = (128, 128)
PERSON_BIAS = 4.0


def _images(seed, n, hw=DET_HW):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)

# --------------------------------------------------------------------- #
# configurations


def test_lite0_and_w48_configs_match_jax():
    assert tlite.LITE0.stages == jlite.LITE0.stages
    for got, ref in ((tedet.EFFICIENTDET_LITE0, jedet.EFFICIENTDET_LITE0),
                     (tedet.EFFICIENTDET_LITE4, jedet.EFFICIENTDET_LITE4)):
        assert _port_edet_config(ref) == got
        assert got.backbone.stages == ref.backbone.stages
    assert (tedet.EFFICIENTDET_LITE0.fpn_channels,
            tedet.EFFICIENTDET_LITE0.fpn_repeats,
            tedet.EFFICIENTDET_LITE0.head_repeats) == (64, 3, 3)
    for name in ("hrnet_w32", "hrnet_w48"):
        got = thrnet.create_hrnet(name, dtype=torch.float32).config
        ref = jhrnet.create_hrnet(name).config
        assert got == _port_hrnet_config(ref)
        assert got.branch_channels == ref.branch_channels
    with pytest.raises(KeyError):
        thrnet.create_hrnet("higherhrnet")

# --------------------------------------------------------------------- #
# EfficientDet-Lite0


@pytest.fixture(scope="module")
def lite0():
    """JAX EfficientDet-Lite0 (canonical head, f32) at full width, its
    filled variables (person bias raised) and the port model on them."""
    jm = jedet.EfficientDet(config=jedet.EFFICIENTDET_LITE0,
                            dtype=jnp.float32)
    variables = _randomize_bn(_filled(jm, DET_HW, 20), 21)
    nc = jedet.EFFICIENTDET_LITE0.num_classes
    variables["params"]["class_net"]["predict_pw"]["bias"][::nc] += \
        PERSON_BIAS
    tm = tedet.EfficientDet(tedet.EFFICIENTDET_LITE0, dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jm, variables, tm.eval()


def test_lite0_forward_matches_jax_at_full_width(lite0):
    """The canonical head, all classes: logits and box regressions to
    1e-4 (f32 on both sides)."""
    jm, variables, tm = lite0
    x = _images(22, 2)
    ref_cls, ref_box = jax.jit(jm.apply)(variables,
                                         jnp.asarray(x, jnp.float32))
    with torch.no_grad():
        cls, box = tm(torch.from_numpy(x), all_classes=True)
    assert cls.shape == (2, 9 * (256 + 64 + 16 + 4 + 1), 90)
    np.testing.assert_allclose(cls.numpy(), np.asarray(ref_cls), **TOL)
    np.testing.assert_allclose(box.numpy(), np.asarray(ref_box), **TOL)


def test_lite0_head_score_plain_path_at_f64_matches_pallas(lite0):
    """F = 64 (Lite0's head width, the kernel's `launch<2>`): the plain
    head-score path on the forward's own level features against the
    Pallas epilogue in interpret mode, level by level (bf16 product on
    both sides: 2e-2)."""
    from human_body_proportion_estimation_tpu.ops.pallas_kernels import (
        head_score_epilogue,
    )

    _, variables, tm = lite0
    x = torch.from_numpy(_images(23, 2)).float()
    zs = []

    def grab(module, inputs, output):
        zs.append(output.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous())

    hook = tm.class_net.predict_dw.register_forward_hook(grab)
    try:
        with torch.no_grad():
            best, person, _ = tm(x)
    finally:
        hook.remove()
    assert [z.shape[-1] for z in zs] == [64] * 5
    w_cls, b_cls = tm._class_predict_params()
    kernel = variables["params"]["class_net"]["predict_pw"]["kernel"]
    bias = variables["params"]["class_net"]["predict_pw"]["bias"]
    refs = [head_score_epilogue(
        jnp.asarray(z.float().numpy(), jnp.bfloat16), jnp.asarray(kernel),
        jnp.asarray(bias), 9, 90, person_class0=0, tile_m=128,
        interpret=True) for z in zs]
    ref_best = np.concatenate([np.asarray(r[0]).reshape(2, -1) for r in refs],
                              1)
    ref_person = np.concatenate([np.asarray(r[1]).reshape(2, -1)
                                 for r in refs], 1)
    np.testing.assert_allclose(best.numpy(), ref_best, rtol=0, atol=2e-2)
    np.testing.assert_allclose(person.numpy(), ref_person, rtol=0, atol=2e-2)
    grouped = kernels.head_score_levels(zs, w_cls, b_cls, 9, 90, 0)
    np.testing.assert_array_equal(grouped[0].numpy(), best.numpy())
    assert int((person >= best).sum()) > 0


def test_edet_detect_pipeline_matches_jax(lite0, monkeypatch):
    """uint8 [B, H, W, 3] -> 100 yxyx detections a image, both packages:
    the same valid slots and classes, boxes to 1e-3 (rtol and atol),
    scores to 1e-4; the batch goes through ONE NMS sweep."""
    from human_body_proportion_estimation_tpu.pipeline.detect import (
        EdetDetectPipeline as JEdetDetect,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.detect import (
        EdetDetectPipeline,
    )

    jm, variables, tm = lite0
    x = _images(24, 3)
    ref = JEdetDetect(jm, DET_HW).jit()(variables, jnp.asarray(x))
    sweeps = []
    sweep = kernels.nms_sweep
    monkeypatch.setattr(kernels, "nms_sweep",
                        lambda *a, **k: sweeps.append(1) or sweep(*a, **k))
    got = EdetDetectPipeline(tm, DET_HW)(torch.from_numpy(x))
    assert len(sweeps) == 1
    valid = np.asarray(ref.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               rtol=0, atol=1e-4)
    # the batch's rows are the images' own detections
    one = EdetDetectPipeline(tm, DET_HW)(torch.from_numpy(x[1:2]))
    np.testing.assert_array_equal(one.valid[0].numpy(), valid[1])
    np.testing.assert_array_equal(one.classes[0].numpy(), got.classes[1])
    np.testing.assert_allclose(one.boxes[0].numpy(), got.boxes[1].numpy(),
                               rtol=1e-3, atol=1e-3)

# --------------------------------------------------------------------- #
# HRNet-W48


def test_hrnet_w48_matches_jax_at_reduced_depth():
    """HRNet-W48's widths (48..384) at one module a stage and one block a
    branch (tests/tiny_models.py's cut), 1e-4 in f32."""
    jcfg = dataclasses.replace(jhrnet.HRNET_W48, stage_modules=(1, 1, 1),
                               blocks_per_branch=1)
    jm = jhrnet.HRNet(config=jcfg, dtype=jnp.float32)
    variables = _randomize_bn(_filled(jm, (64, 64), 36), 37)
    x = np.random.default_rng(38).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = thrnet.HRNet(_port_hrnet_config(jcfg), dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).transpose(0, 3, 1, 2), **TOL)

# --------------------------------------------------------------------- #
# pipeline/pose.py


def test_preprocess_crop_host_divides_before_resizing():
    """/255 first, then the f32 cv2 resize, as the JAX function and the
    reference do; a /255 after a uint8 resize rounds otherwise."""
    import cv2

    from human_body_proportion_estimation_tpu.pipeline.pose import (
        preprocess_crop_host as jprep,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.pose import (
        preprocess_crop_host,
    )

    img = _images(40, 1, (157, 101))[0]
    got = preprocess_crop_host(img, 72, 96)
    assert got.shape == (96, 72, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jprep(img, 72, 96))
    late = cv2.resize(img, (72, 96)).astype(np.float32) / 255.0
    assert np.abs(late - got).max() > 1e-3

# --------------------------------------------------------------------- #
# pipeline/host.py: the slots


@pytest.mark.parametrize("detector,pose,origin", [
    ("efficientdet_lite0", "hrnet_w32",
     {"detector": "random", "pose": "synthetic-certified"}),
    ("efficientdet_lite4", "hrnet_w48",
     {"detector": "synthetic-certified", "pose": "random"}),
    ("efficientdet_lite0", "higherhrnet",
     {"detector": "random", "pose": "random"}),
])
def test_pipeline_resolves_the_slots_as_jax(capfd, detector, pose, origin):
    """The detector architecture follows the slot name (a Lite0 slot never
    gets the Lite4 graph), the pose model `cfg.pose.name`; a slot with no
    weights in the repository is random, seeded (two pipelines agree),
    and labelled so with the JAX package's warning."""
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        PipelineConfig,
        PoseConfig,
    )

    from human_body_proportion_estimation_tpu_torch.models.layers import (
        init_random,
    )

    cfg = PipelineConfig(pose=PoseConfig(name=pose))
    pipe = InferencePipeline(cfg, device="cpu", detector=detector)
    assert pipe.weights_origin == origin
    assert pipe.backend.detector.config == (
        tedet.EFFICIENTDET_LITE0 if detector == "efficientdet_lite0"
        else tedet.EFFICIENTDET_LITE4)
    if pose == "higherhrnet":
        assert isinstance(pipe.pose, thh.HigherHRNetHeatmaps)
    else:
        assert pipe.pose.config == thrnet.create_hrnet(pose).config
    # a random slot is the same on every construction
    slot = (pipe.backend.detector if origin["detector"] == "random"
            else pipe.pose)
    fresh = init_random(type(slot)(slot.config) if not isinstance(
        slot, thh.HigherHRNetHeatmaps) else thh.HigherHRNetHeatmaps())
    ref = fresh.state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in slot.state_dict().items())
    assert "RANDOM-INIT WEIGHTS IN USE" in capfd.readouterr().err
