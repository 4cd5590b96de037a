"""The port's HRNet and EfficientDet against the flax models, at tiny depth
(tests/tiny_models.py), with the same weights carried across by the port's
converter (`models/weights.flax_to_state_dict`).

Both sides compute in float32 here (flax `dtype=float32`, port
`dtype=torch.float32`), so the models agree to float32 round-off of two
different convolution implementations; the tolerances say how much. The
EfficientDet class head goes through the head-score kernel on both sides
(Pallas in interpret mode; the port's plain version on the CPU), whose
product rounds z and W to bf16 on both sides by design.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_body_proportion_estimation_tpu.models import efficientdet as jedet
from human_body_proportion_estimation_tpu.models.hrnet import HRNet as JHRNet
from human_body_proportion_estimation_tpu_torch.models import (
    efficientdet as tedet,
    hrnet as thrnet,
)
from human_body_proportion_estimation_tpu_torch.models.efficientnet_lite import (
    EfficientNetLiteConfig,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from tests.tiny_models import tiny_edet_config, tiny_w32_config


def _np_tree(variables):
    return jax.tree.map(np.array, variables)  # writable copies


def _randomize_bn(variables, seed):
    """Non-trivial BN statistics/affines, so a BN wiring or epsilon error
    shows in the outputs (flax init leaves mean 0 / var 1 / scale 1)."""
    rng = np.random.default_rng(seed)
    tree = _np_tree(variables)

    def walk(params, stats):
        for k, v in params.items():
            if isinstance(v, dict) and "scale" in v and k in stats:
                v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(
                    np.float32)
                v["bias"] = rng.normal(0, 0.1, v["bias"].shape).astype(
                    np.float32)
                stats[k]["mean"] = rng.normal(
                    0, 0.1, stats[k]["mean"].shape).astype(np.float32)
                stats[k]["var"] = rng.uniform(
                    0.5, 1.5, stats[k]["var"].shape).astype(np.float32)
            elif isinstance(v, dict) and k in stats:
                walk(v, stats[k])

    walk(tree["params"], tree["batch_stats"])
    return tree


def _port_edet_config(jcfg):
    bb = jcfg.backbone
    return tedet.EfficientDetConfig(
        backbone=EfficientNetLiteConfig(bb.width_mult, bb.depth_mult,
                                        bb.stem_channels),
        fpn_channels=jcfg.fpn_channels,
        fpn_repeats=jcfg.fpn_repeats,
        head_repeats=jcfg.head_repeats,
        num_classes=jcfg.num_classes,
        max_detections=jcfg.max_detections,
    )


def _port_hrnet_config(jcfg):
    return thrnet.HRNetConfig(
        width=jcfg.width, num_keypoints=jcfg.num_keypoints,
        stage_modules=jcfg.stage_modules,
        blocks_per_branch=jcfg.blocks_per_branch,
        stem_channels=jcfg.stem_channels,
        bottleneck_channels=jcfg.bottleneck_channels,
    )


def test_hrnet_tiny_matches_flax():
    """Tolerance 1e-4 abs on heatmaps of magnitude ~1: f32 round-off
    through ~40 convs (observed ~1e-6)."""
    jcfg = tiny_w32_config()
    jm = JHRNet(config=jcfg, dtype=jnp.float32)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    variables = _randomize_bn(jm.init(jax.random.PRNGKey(0), x[:1]), 1)
    ref = np.asarray(jm.apply(variables, x))                 # [N, H, W, K]

    tm = thrnet.HRNet(_port_hrnet_config(jcfg), dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref,
                               rtol=1e-4, atol=1e-4)


def test_hrnet_tiny_bf16_error_matches_flax_bf16():
    """bf16 compute on both sides. The frameworks round at different
    places, so the two bf16 outputs are not held to each other elementwise;
    instead each is held against the f32 flax output, and the port's bf16
    error must be of the same size as flax's own bf16 error (mean within
    1.5x; observed ~0.0127 for both on heatmaps of mean magnitude ~1.4)."""
    jcfg = tiny_w32_config()
    x = np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    jm = JHRNet(config=jcfg)
    variables = _randomize_bn(jm.init(jax.random.PRNGKey(1), x), 3)
    ref_bf16 = np.asarray(jm.apply(variables, x))
    ref_f32 = np.asarray(
        JHRNet(config=jcfg, dtype=jnp.float32).apply(variables, x))
    tm = thrnet.HRNet(_port_hrnet_config(jcfg))
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.dtype == np.float32
    err_port = np.abs(got.transpose(0, 2, 3, 1) - ref_f32)
    err_flax = np.abs(ref_bf16 - ref_f32)
    assert err_port.mean() <= 1.5 * err_flax.mean()
    assert err_port.max() <= 3.0 * err_flax.max()


@pytest.fixture(scope="module")
def edet_pair():
    jcfg = tiny_edet_config()
    jm = jedet.EfficientDet(config=jcfg, dtype=jnp.float32,
                            score_kernel=True, score_kernel_interpret=True)
    imgs = np.random.default_rng(4).integers(
        0, 256, (2, 128, 96, 3)).astype(np.uint8)
    variables = _randomize_bn(
        jm.init(jax.random.PRNGKey(2), jnp.asarray(imgs[:1])), 5)
    ref = jax.tree.map(np.asarray, jm.apply(variables, jnp.asarray(imgs),
                                            prescored=True))
    tm = tedet.EfficientDet(_port_edet_config(jcfg), dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = [t.numpy() for t in tm(torch.from_numpy(imgs))]
    return ref, got


def test_efficientdet_tiny_box_head_matches_flax(edet_pair):
    """Box regressions: f32 end to end on both sides, 1e-4."""
    (_, _, ref_box), (_, _, got_box) = edet_pair
    assert got_box.shape == ref_box.shape
    np.testing.assert_allclose(got_box, ref_box, rtol=1e-4, atol=1e-4)


def test_efficientdet_tiny_scores_match_flax(edet_pair):
    """best/person logits through the head-score kernel: z is rounded to
    bf16 on both sides, so an f32 round-off difference in z can flip one
    bf16 rounding (a 2^-8 relative step of one input to a 64-term sum).
    Tolerance 2e-2 abs on logits of magnitude ~1; most entries agree to
    1e-5."""
    (ref_best, ref_person, _), (got_best, got_person, _) = edet_pair
    assert got_best.shape == ref_best.shape
    np.testing.assert_allclose(got_best, ref_best, atol=2e-2)
    np.testing.assert_allclose(got_person, ref_person, atol=2e-2)
    assert np.mean(np.abs(got_best - ref_best) < 1e-4) > 0.95
    # the person logit is one of the values the max was taken over
    assert np.all(got_person <= got_best)
