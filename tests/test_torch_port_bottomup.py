"""The port's bottom-up pipeline (`pipeline/bottomup.py`, ROADMAP item 13)
against the JAX package's on the CPU, at 128x128 with the depth-reduced
HigherHRNet of tests/tiny_models.py in float32 on both sides (flax
variables filled from a seed as tests/torch_port_tiny.py fills them, with
random BatchNorm statistics, carried across by `flax_to_state_dict`).

- the aggregated heat and tag maps: within 2e-6 of the maps' largest
  magnitude (f32 rounding through ~40 convs and the upsample);
- the AE decode fed JAX's own aggregated maps: exact;
- the whole forward fed model outputs that both upsample without rounding
  (heat half of output_1 zero, tag half small integers, output_2 the JAX
  model's): every output exact but the cm lengths (1e-6 relative: the
  segment einsum's rounding);
- `infer_images`, `forward_serving` / `infer_serving` (packed [n, P, 23],
  padded to the power-of-two bucket) on real images: validity, keypoints
  and visibility exact, scores 1e-5 relative, cm 1e-4 relative;
- the weights rules (`maybe_load_certified(bottom_up=True)`, random init
  labelled so), `prewarm_serving`, and `cli/detect_pose_bottomup.run_bottomup`.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_body_proportion_estimation_tpu.ops import ae_grouping as jae
from human_body_proportion_estimation_tpu.pipeline.bottomup import (
    BottomUpPipeline as JBottomUp,
)
from human_body_proportion_estimation_tpu.utils.config import (
    PipelineConfig as JPipelineConfig,
    ServeConfig as JServeConfig,
)
from human_body_proportion_estimation_tpu_torch.models import (
    higherhrnet as thh,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from human_body_proportion_estimation_tpu_torch.ops import ae_grouping as tae
from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
    BottomUpPipeline,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    PipelineConfig,
    ServeConfig,
)
from tests.test_torch_port_models import _port_hrnet_config, _randomize_bn
from tests.tiny_models import tiny_higherhrnet, tiny_w32_config
from tests.torch_port_tiny import _filled

INPUT_HW = (128, 128)
MAX_BATCH = 4
K = 17


def port_tiny_model():
    return thh.HigherHRNet(_port_hrnet_config(tiny_w32_config()),
                           dtype=torch.float32)


def make_pipelines(seed=40, **decode):
    """(JAX pipeline, port pipeline on the CPU, flax variables): the same
    tiny HigherHRNet weights, f32, 128x128 inputs, max batch 4, and the
    same decode parameters `decode` (the defaults unless given)."""
    jm = tiny_higherhrnet(jnp.float32)
    variables = _randomize_bn(_filled(jm, INPUT_HW, seed), seed + 1)
    jpipe = JBottomUp(JPipelineConfig(serve=JServeConfig(max_batch=MAX_BATCH)),
                      pose_vars=variables, model=jm, **decode)
    tpipe = BottomUpPipeline(
        PipelineConfig(serve=ServeConfig(max_batch=MAX_BATCH)),
        pose_state=flax_to_state_dict(variables), model=port_tiny_model(),
        device="cpu", dtype=torch.float32, **decode)
    jpipe.INPUT_HW = tpipe.INPUT_HW = INPUT_HW
    return jpipe, tpipe, variables


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines()


def sample_images(n=3):
    """Seeded RGB images of different sizes (resized to 128x128)."""
    return [np.random.default_rng(60 + i).integers(
        0, 256, (150 + 10 * i, 130 - 5 * i, 3), dtype=np.uint8)
        for i in range(n)]


def batch_inputs(images):
    """The forward's inputs as the pipelines build them: uint8 NHWC at
    128x128, heights [n, P], orig_hw [n, 2]."""
    from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
        prepare_batch_bottomup,
    )

    batch, heights, orig_hw, _ = prepare_batch_bottomup(
        images, [[170.0], [180.0, 160.0], [150.0]], len(images), 3, INPUT_HW)
    return batch, heights, orig_hw


def jax_maps(jpipe, variables, batch):
    """JAX's aggregated (heat, tags), NCHW: the JAX forward's own lines."""
    def maps(v, images):
        outs = jpipe.model.apply(v, images.astype(jnp.float32) / 255.0)
        out1, out2 = outs["output_1"], outs["output_2"]
        b, hh, hw = out2.shape[:3]
        up = functools.partial(jax.image.resize, shape=(b, hh, hw, K),
                               method="bilinear")
        heat = (up(out1[..., :K]) + out2) / 2.0
        return (jnp.moveaxis(heat, -1, 1),
                jnp.moveaxis(up(out1[..., K:]), -1, 1))

    heat, tags = jax.jit(maps)(variables, jnp.asarray(batch))
    return np.array(heat), np.array(tags)


def test_aggregated_maps_match_jax(pipelines):
    jpipe, tpipe, variables = pipelines
    batch, _, _ = batch_inputs(sample_images())
    ref_heat, ref_tags = jax_maps(jpipe, variables, batch)
    with torch.inference_mode():
        heat, tags = tpipe.aggregate(torch.from_numpy(batch))
    assert heat.shape == tags.shape == (3, K, 64, 64)
    for got, ref, what in ((heat, ref_heat, "heat"), (tags, ref_tags, "tags")):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=2e-6 * np.abs(ref).max(),
                                   err_msg=what)


def test_decode_of_jax_maps_is_exact(pipelines):
    """The port's decode on JAX's aggregated maps of real images, at the
    pipeline's parameters, against JAX's vmapped decode: bit for bit."""
    jpipe, tpipe, variables = pipelines
    batch, _, _ = batch_inputs(sample_images())
    heat, tags = jax_maps(jpipe, variables, batch)
    kw = dict(max_people=3, max_cands=8, score_threshold=0.1,
              tag_threshold=1.0, person_score_threshold=0.25)
    ref = jax.jit(jax.vmap(functools.partial(jae.decode_bottom_up, **kw)))(
        jnp.asarray(heat), jnp.asarray(tags))
    got = tae.decode_bottom_up(torch.from_numpy(heat), torch.from_numpy(tags),
                               **kw)
    assert int(np.asarray(ref.valid).sum()) >= 3
    for field in ("keypoints", "scores", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


class _JaxStub:
    def __init__(self, outs):
        self.outs = outs

    def apply(self, _vars, _x):
        return self.outs


def test_forward_is_exact_on_shared_model_outputs(pipelines):
    """Both forwards on the same model outputs, chosen so that the 2x
    upsample rounds nowhere: output_1's heat half zero (heat = output_2 /
    2) and its tag half small integers; output_2 the JAX model's own. Then
    boxes, validity, keypoints, scores and visibility are bit for bit
    JAX's, and the cm lengths within 1e-6 relative."""
    jpipe, tpipe, variables = pipelines
    batch, heights, orig_hw = batch_inputs(sample_images())
    out2 = jpipe.model.apply(variables,
                             jnp.asarray(batch, jnp.float32) / 255.0)[
        "output_2"]
    rng = np.random.default_rng(3)
    tag_half = rng.integers(-2, 3, (3, 32, 32, K)).astype(np.float32)
    out1 = np.concatenate([np.zeros_like(tag_half), tag_half], -1)
    stub = JBottomUp.__new__(JBottomUp)
    stub.__dict__.update(jpipe.__dict__)
    stub.model = _JaxStub({"output_1": jnp.asarray(out1),
                           "output_2": out2})
    ref = jax.jit(stub.forward)(None, jnp.asarray(batch),
                                jnp.asarray(heights), jnp.asarray(orig_hw))
    t_outs = {"output_1": torch.from_numpy(out1.transpose(0, 3, 1, 2)),
              "output_2": torch.from_numpy(
                  np.asarray(out2).transpose(0, 3, 1, 2).copy())}
    model = tpipe.model
    tpipe.model = lambda _x: t_outs
    try:
        got = tpipe.forward(*(torch.from_numpy(a)
                              for a in (batch, heights, orig_hw)))
    finally:
        tpipe.model = model
    assert int(np.asarray(ref.person_valid).sum()) >= 2
    for field in got._fields:
        g, r = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        if field == "lengths_cm":
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g, r, err_msg=field)


def assert_outputs_close(got, ref):
    """Validity, keypoints and visibility exact; scores 1e-5 relative to
    the largest, boxes 1e-4 px, cm 1e-4 relative."""
    for field in ("person_valid", "keypoints", "kp_visible", "seg_visible"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    ref_scores = np.asarray(ref.kp_scores)
    np.testing.assert_allclose(got.kp_scores, ref_scores, rtol=0,
                               atol=1e-5 * np.abs(ref_scores).max())
    np.testing.assert_allclose(got.boxes_orig, np.asarray(ref.boxes_orig),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.lengths_cm, np.asarray(ref.lengths_cm),
                               rtol=1e-4, atol=1e-4)


def test_infer_images_matches_jax(pipelines):
    jpipe, tpipe, _ = pipelines
    images = sample_images()
    ref = jpipe.infer_images(images, person_heights=[170.0, 180.0, 160.0])
    got = tpipe.infer_images(images, person_heights=[170.0, 180.0, 160.0])
    assert got.keypoints.shape == (3, 3, K, 2)
    assert int(got.person_valid.sum()) >= 3
    assert np.isfinite(got.lengths_cm).all()
    assert (got.lengths_cm[~got.seg_visible] == 0).all()
    assert not got.seg_visible[~got.person_valid].any()
    assert_outputs_close(got, ref)


def test_forward_serving_and_infer_serving_match_jax(pipelines):
    """The packed [n, P, 23] rows: `infer_serving` pads 3 images to the
    bucket of 4 and cuts the answer back to 3, on both sides; its rows are
    the direct `forward_serving` at the padded batch."""
    jpipe, tpipe, _ = pipelines
    images = sample_images()
    heights = [[170.0], [180.0, 160.0], [150.0]]
    ref = jpipe.infer_serving(images, person_heights=heights)
    got = tpipe.infer_serving(images, person_heights=heights)
    assert got.shape == ref.shape == (3, 3, 23)
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_array_equal(got[..., 12:], ref[..., 12:])
    np.testing.assert_allclose(got[..., 1:12], ref[..., 1:12], rtol=1e-4,
                               atol=1e-4)
    from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
        prepare_batch_bottomup,
    )

    batch, h, hw, n = prepare_batch_bottomup(images, heights, 4, 3, INPUT_HW)
    direct = tpipe.forward_serving(*(torch.from_numpy(a)
                                     for a in (batch, h, hw))).numpy()
    np.testing.assert_array_equal(direct[:n], got)


def test_weights_rules(monkeypatch, tmp_path, caplog):
    """No state: the HigherHRNet is random from the seeded generator (the
    same twice), labelled "random" with the warning; a mesh of the CPU
    listed twice shares the one model between its two shards;
    `maybe_load_certified(bottom_up=True)` follows the JAX rule: None
    under HBPE_DISABLE_CERTIFIED_FALLBACK or without the file, else the
    file's pose slot as a port state dict (no detector slot) equal to the
    JAX package's tree converted."""
    from human_body_proportion_estimation_tpu.models import weights as jw
    from human_body_proportion_estimation_tpu_torch.models import (
        weights as tw,
    )

    pipes = [BottomUpPipeline(model=port_tiny_model(), device="cpu",
                              dtype=torch.float32) for _ in range(2)]
    assert pipes[0].weights_origin == {"pose": "random"}
    for (k0, a), (k1, b) in zip(pipes[0].model.state_dict().items(),
                                pipes[1].model.state_dict().items()):
        assert k0 == k1 and torch.equal(a, b), k0
    from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
        make_mesh,
    )

    sharded = BottomUpPipeline(model=port_tiny_model(), dtype=torch.float32,
                               mesh=make_mesh(devices=["cpu", "cpu"]))
    assert sharded.shard_models == [sharded.model] * 2
    assert sharded.device == torch.device("cpu")

    assert tw.maybe_load_certified(bottom_up=True) == (None, None)
    monkeypatch.delenv("HBPE_DISABLE_CERTIFIED_FALLBACK")
    missing = str(tmp_path / "absent.npz")
    monkeypatch.setattr(tw, "default_certified_bottomup_checkpoint",
                        lambda: missing)
    assert tw.maybe_load_certified(bottom_up=True) == (None, None)
    _, _, variables = make_pipelines(seed=50)
    path = str(tmp_path / "certified_higherhrnet.npz")
    jw.save_compact_checkpoint(path, {}, variables)
    for mod in (tw, jw):
        monkeypatch.setattr(mod, "default_certified_bottomup_checkpoint",
                            lambda: path)
    det, pose = tw.maybe_load_certified(bottom_up=True)
    j_det, j_pose = jw.maybe_load_certified(bottom_up=True)
    assert det is None and j_det == {}
    ref = flax_to_state_dict(j_pose)
    assert list(pose) == list(ref)
    for key in ref:
        assert torch.equal(pose[key], ref[key]), key
    pipe = BottomUpPipeline(pose_state=pose, model=port_tiny_model(),
                            device="cpu", dtype=torch.float32)
    assert pipe.weights_origin == {"pose": "real"}


def test_prewarm_serving_runs_every_bucket(pipelines):
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        prewarm_serving,
    )

    _, tpipe, _ = pipelines
    assert prewarm_serving(tpipe) == [1, 2, 4]
    assert tpipe.prewarmed


# --------------------------------------------------------------------- #
# cli/detect_pose_bottomup.py


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("imgs")
    for i, img in enumerate(sample_images()):
        cv2.imwrite(str(d / f"img_{i}.png"), img[..., ::-1])
    return d


def test_run_bottomup_matches_jax(pipelines, image_dir, tmp_path):
    """Both CLIs over a directory of 3 PNGs in batches of 2: the same
    entries (boxes of the valid slots, one cm dict a valid slot, gaps in
    the slot order kept), and one rendered frame an image under
    tpu_bottomup_pose/."""
    from human_body_proportion_estimation_tpu.cli import (
        detect_pose_bottomup as jcli,
    )
    from human_body_proportion_estimation_tpu_torch.cli import (
        detect_pose_bottomup as tcli,
    )

    jpipe, tpipe, _ = pipelines
    ref = jcli.run_bottomup(str(image_dir), person_height=172.0,
                            pipeline=jpipe, batch_size=2, debug=False)
    got = tcli.run_bottomup(str(image_dir), person_height=172.0,
                            pipeline=tpipe, batch_size=2, debug=False,
                            save_result_dir=str(tmp_path))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        np.testing.assert_allclose(g[0], np.asarray(r[0]), rtol=0, atol=1e-4)
        for gd, rd in zip(g[1:], r[1:]):
            assert list(gd) == list(rd)
            for name in rd:
                if isinstance(rd[name], str):
                    assert gd[name] == rd[name]
                else:
                    assert gd[name] == pytest.approx(rd[name], rel=1e-4,
                                                     abs=1e-4)
    frames = sorted(os.listdir(tmp_path / "tpu_bottomup_pose"))
    assert frames == [f"frame_{i:06d}.jpg" for i in range(3)]


def test_run_bottomup_builds_its_pipeline_on_the_device_asked(
        image_dir, monkeypatch):
    """With no pipeline, `run_bottomup(device="cpu")` builds the
    full-width HigherHRNet itself (random here: no certified bottom-up
    checkpoint is read under the tests' environment) in the dtype asked;
    the input size is cut to 64x64 to keep the CPU forward short."""
    from human_body_proportion_estimation_tpu_torch.cli import (
        detect_pose_bottomup as tcli,
    )

    built = []
    plain = tcli.build_default

    def spy(device, dtype):
        pipe = plain(device, dtype)
        built.append(pipe)
        return pipe

    monkeypatch.setattr(tcli, "build_default", spy)
    monkeypatch.setattr(BottomUpPipeline, "INPUT_HW", (64, 64))
    out = tcli.run_bottomup(str(image_dir), device="cpu",
                            dtype=torch.float32, debug=False)
    (pipe,) = built
    assert pipe.device.type == "cpu" and pipe.weights_origin == {
        "pose": "random"}
    assert pipe.model.dtype == torch.float32
    assert pipe.model.head1.weight.shape == (34, 32, 1, 1)
    assert len(out) == 3
    for entry in out:
        assert entry[0].shape == (len(entry) - 1, 4)
