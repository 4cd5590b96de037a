"""The port's HigherHRNet pose slot (ROADMAP item 12) against the JAX
package on the CPU: HigherHRNet and its heatmap wrapper at full width,
the transposed conv through the converter, `PosePipeline` (HRNet and
HigherHRNet), the fused pipeline with the HigherHRNet pose slot, and the
registry's `higherhrnet`.

The flax variable trees come from `jax.eval_shape` of `init`, filled from
a seed with numpy as flax initializes them (tests/torch_port_tiny.py),
with random BatchNorm statistics and affines; the port loads them through
`models/weights.flax_to_state_dict`. Both sides compute in float32 (flax
`dtype=float32`, port `dtype=torch.float32`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_body_proportion_estimation_tpu.models import (
    higherhrnet as jhh,
    hrnet as jhrnet,
)
from human_body_proportion_estimation_tpu_torch.models import (
    higherhrnet as thh,
    hrnet as thrnet,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from tests.test_torch_port_models import (
    _port_hrnet_config,
    _randomize_bn,
)
from tests.tiny_models import tiny_w32_config
from tests.torch_port_tiny import _filled

TOL = dict(rtol=1e-4, atol=1e-4)


def _images(seed, n, hw=(128, 128)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)

# --------------------------------------------------------------------- #
# HigherHRNet

# HigherHRNet, HRNet-W48


@pytest.fixture(scope="module")
def higher():
    """JAX HigherHRNet (W32, f32) at full width, its filled variables with
    an asymmetric random deconv kernel, the port model on them, an input
    and the JAX outputs on it."""
    jm = jhh.HigherHRNet(dtype=jnp.float32)
    variables = _randomize_bn(_filled(jm, (128, 128), 30), 31)
    deconv = variables["params"]["deconv"]
    deconv["kernel"] = np.random.default_rng(32).normal(
        0.0, 0.05, deconv["kernel"].shape).astype(np.float32)
    tm = thh.HigherHRNet(dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    x = np.random.default_rng(33).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    ref = {k: np.asarray(v).transpose(0, 3, 1, 2) for k, v in ref.items()}
    return variables, tm.eval(), torch.from_numpy(x).permute(0, 3, 1, 2), ref


def close_to_scale(got, ref, what=""):
    """Elementwise within 1e-4 of the output's largest magnitude: the
    random full-depth trunk (BatchNorm statistics not calibrated) reaches
    values in the thousands, where a near-zero element carries the f32
    rounding of its large neighbours."""
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max(), err_msg=what)


def test_higherhrnet_matches_jax_at_full_width(higher):
    """Both outputs on a 128x128 input, NCHW: output_1 [N, 34, 32, 32],
    output_2 [N, 17, 64, 64], f32."""
    _, tm, x, ref = higher
    with torch.no_grad():
        got = tm(x)
    assert got["output_1"].shape == (2, 34, 32, 32)
    assert got["output_2"].shape == (2, 17, 64, 64)
    for name in ("output_1", "output_2"):
        close_to_scale(got[name].numpy(), ref[name], name)


def test_higherhrnet_heatmaps_keeps_the_flax_name(higher):
    """`HigherHRNetHeatmaps` loads the flax wrapper's tree (submodule
    `higher`, the JAX `HigherHRNetHeatmaps` layout) and returns output_2
    only."""
    variables, _, x, ref = higher
    wrapped = {col: {"higher": tree} for col, tree in variables.items()}
    abstract = jax.eval_shape(
        jhh.HigherHRNetHeatmaps(dtype=jnp.float32).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    assert jax.tree.structure(abstract) == jax.tree.structure(wrapped)
    heat = thh.HigherHRNetHeatmaps(dtype=torch.float32)
    heat.load_state_dict(flax_to_state_dict(wrapped), strict=True)
    with torch.no_grad():
        got = heat.eval()(x)
    close_to_scale(got.numpy(), ref["output_2"])


def test_deconv_converter_flips_an_asymmetric_kernel():
    """flax `ConvTranspose((4, 4), (2, 2), "SAME")` with a kernel of one
    off-centre tap a channel pair against the port's `deconv` loaded
    through the converter: equal, and a transpose without the spatial
    flip (same shapes, so a strict load takes it) is not."""
    from flax import linen as nn

    rng = np.random.default_rng(35)
    kernel = np.zeros((4, 4, 3, 2), np.float32)
    kernel[0, 3, 0, 0], kernel[1, 0, 1, 1], kernel[3, 2, 2, 0] = 1.0, 2.0, -1.5
    x = rng.normal(size=(1, 6, 5, 3)).astype(np.float32)
    ref = nn.ConvTranspose(2, (4, 4), strides=(2, 2), padding="SAME",
                           use_bias=False).apply(
        {"params": {"kernel": kernel}}, jnp.asarray(x))
    sd = flax_to_state_dict({"params": {"deconv": {"kernel": kernel}}})
    deconv = thh.ConvTranspose2d(3, 2, 4, stride=2, padding=1, bias=False)
    deconv.load_state_dict({"weight": sd["deconv.weight"]}, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = deconv(xt).permute(0, 2, 3, 1).numpy()
        deconv.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
        unflipped = deconv(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == np.asarray(ref).shape == (1, 12, 10, 2)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert np.abs(unflipped - np.asarray(ref)).max() > 0.5

@pytest.mark.parametrize("name", ["hrnet_w32", "higherhrnet"])
def test_pose_pipeline_matches_jax(name):
    """`PosePipeline` on an HRNet (reduced depth) or a HigherHRNet wrapper
    (reduced-depth trunk): heatmaps [B, K, Hm, Wm] to 1e-4, keypoints
    exact, scores to 1e-4, against the JAX pipeline whose decode is the
    JAX package's reference (`ops/heatmap.decode_heatmaps`)."""
    from human_body_proportion_estimation_tpu.pipeline.pose import (
        PosePipeline as JPose,
        preprocess_crop_host,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.pose import (
        PosePipeline,
    )

    jcfg = tiny_w32_config()
    if name == "higherhrnet":
        jm = jhh.HigherHRNetHeatmaps(config=jcfg, dtype=jnp.float32)
        tm = thh.HigherHRNetHeatmaps(_port_hrnet_config(jcfg),
                                     dtype=torch.float32)
    else:
        jm = jhrnet.HRNet(config=jcfg, dtype=jnp.float32)
        tm = thrnet.HRNet(_port_hrnet_config(jcfg), dtype=torch.float32)
    variables = _randomize_bn(_filled(jm, (64, 64), 41), 42)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    crops = np.stack([preprocess_crop_host(img, 64, 96)
                      for img in _images(43, 2, (120, 90))])
    ref = JPose(jm).jit()(variables, jnp.asarray(crops))
    got = PosePipeline(tm.eval())(torch.from_numpy(crops))
    scale = 2 if name == "higherhrnet" else 4
    assert got.heatmaps.shape == (2, 17, 96 // scale, 64 // scale)
    np.testing.assert_allclose(got.heatmaps.numpy(),
                               np.asarray(ref.heatmaps), **TOL)
    np.testing.assert_array_equal(got.keypoints.numpy(),
                                  np.asarray(ref.keypoints))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               **TOL)


# --------------------------------------------------------------------- #
# the fused pipeline with the HigherHRNet pose slot


@pytest.fixture(scope="module")
def higher_pipelines():
    """The fused pipeline with the HigherHRNet pose slot (reduced-depth
    trunk, heatmaps at 1/2 the 64x64 crop), both packages, on the tiny
    detector of tests/torch_port_tiny.py."""
    from human_body_proportion_estimation_tpu.pipeline.backends import (
        EfficientDetBackend,
    )
    from human_body_proportion_estimation_tpu.pipeline.host import (
        InferencePipeline as JPipeline,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )
    from tests import torch_port_tiny as tiny

    jcfg, tcfg = tiny.configs()
    pose = dict(name="higherhrnet", heatmap_height=32, heatmap_width=32)
    jcfg = dataclasses.replace(jcfg, pose=dataclasses.replace(jcfg.pose,
                                                              **pose))
    tcfg = dataclasses.replace(tcfg, pose=dataclasses.replace(tcfg.pose,
                                                              **pose))
    m = tiny.tiny_models()
    jpose = jhh.HigherHRNetHeatmaps(config=tiny_w32_config(),
                                    dtype=jnp.float32)
    pose_vars = _randomize_bn(_filled(jpose, tiny.CROP_HW, 50), 51)
    jpipe = JPipeline(config=jcfg,
                      backend=EfficientDetBackend(m.jdet_kernel, jcfg),
                      pose=jpose, det_vars=m.det_vars, pose_vars=pose_vars)
    tpipe = InferencePipeline(
        tcfg, flax_to_state_dict(m.det_vars), flax_to_state_dict(pose_vars),
        device="cpu", det_config=m.tpipe.backend.detector.config,
        pose_config=_port_hrnet_config(tiny_w32_config()),
        dtype=torch.float32)
    return jpipe, tpipe, pose_vars


def test_pipeline_with_the_higherhrnet_slot_matches_jax(higher_pipelines):
    """infer_images on the HigherHRNet slot: persons, boxes, heatmaps at
    [B, P, 17, 32, 32] (1e-3), decisive keypoints (1e-3) and the
    segments they carry."""
    from tests.test_torch_port_pipeline import _decisive

    jpipe, tpipe, _ = higher_pipelines
    assert isinstance(tpipe.pose, thh.HigherHRNetHeatmaps)
    images = list(_images(12, 3))
    heights = [[170.0], [180.0, 160.0], [175.0]]
    ref = jpipe.infer_images(images, heights, 0.5, with_heatmaps=True)
    got = tpipe.infer_images(images, heights, 0.5, with_heatmaps=True)
    valid = np.asarray(ref.person_valid)
    assert valid.sum() >= 3
    np.testing.assert_array_equal(got.person_valid, valid)
    np.testing.assert_allclose(got.boxes_orig, np.asarray(ref.boxes_orig),
                               rtol=1e-3, atol=1e-3)
    assert got.heatmaps.shape[-2:] == (32, 32)
    off_edge = np.all(np.asarray(ref.boxes_norm)[..., 2:] < 1.0, -1)
    assert (valid & off_edge).sum() >= 1
    np.testing.assert_allclose(got.heatmaps[off_edge],
                               np.asarray(ref.heatmaps)[off_edge],
                               rtol=1e-3, atol=1e-3)
    kp_ok, seg_ok = _decisive(ref)
    np.testing.assert_allclose(got.keypoints[kp_ok],
                               np.asarray(ref.keypoints)[kp_ok],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.lengths_cm[seg_ok],
                               np.asarray(ref.lengths_cm)[seg_ok],
                               rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------- #
# serve/registry.py: higherhrnet


def test_registry_higherhrnet_matches_jax(higher_pipelines):
    """`higherhrnet` on the serving pipeline's HigherHRNet (the JAX
    registry shares a bottom-up pipeline's): the documents (`platform`
    apart) and both outputs of a 3-row request padded to the bucket of 4,
    f32 to 1e-4; the hrnet model, with no HRNet to share, builds its own
    at random on both sides."""
    import types

    from human_body_proportion_estimation_tpu.serve.registry import (
        build_registry as jbuild,
    )
    from human_body_proportion_estimation_tpu_torch.serve.registry import (
        build_registry,
    )

    jpipe, tpipe, pose_vars = higher_pipelines
    stand_in = types.SimpleNamespace(
        config=jpipe.config, weights_origin={"detector": "real",
                                             "pose": "real"},
        pose=None,
        model=jhh.HigherHRNet(config=tiny_w32_config(), dtype=jnp.float32),
        pose_vars={col: tree["higher"] for col, tree in pose_vars.items()},
        det_vars=None, mesh=None, backend=None)
    jreg = jbuild(stand_in, include=("higherhrnet", "hrnet"))
    treg = build_registry(tpipe)
    for doc in ("metadata", "config"):
        ref = getattr(jreg, doc)("higherhrnet")
        got = getattr(treg, doc)("higherhrnet")
        assert got.pop("platform") == "pytorch"
        assert ref.pop("platform") == "jax_xla"
        assert got == ref, doc
    ref_idx = {r["name"]: r["weights"] for r in jreg.index()}
    got_idx = {r["name"]: r["weights"] for r in treg.index()}
    assert got_idx["higherhrnet"] == ref_idx["higherhrnet"] == "real"
    assert got_idx["hrnet"] == ref_idx["hrnet"] == "random"
    x = np.random.default_rng(52).uniform(0, 1, (3, 3, 64, 64)).astype(
        np.float32)
    ref = jreg.infer("higherhrnet", {"input": x})
    got = treg.infer("higherhrnet", {"input": x})
    assert got["output_1"].shape == (3, 34, 16, 16)
    assert got["output_2"].shape == (3, 17, 32, 32)
    for name in ("output_1", "output_2"):
        np.testing.assert_allclose(got[name], ref[name], **TOL)
    treg.shutdown()
    jreg.shutdown()
