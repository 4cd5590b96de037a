"""The port's associative-embedding decode (`ops/ae_grouping.py`, ROADMAP
item 13) against the JAX package's on the CPU, EXACTLY: the peaks, the
greedy assignment and the grouped outputs of every case of
tests/torch_port_bottomup.py (seeded random maps, bf16 and coarser maps
full of ties, flat plateaus, NaN and infinite pixels, the synthetic people
and the phantom group of tests/test_ae_grouping.py), the JAX side
`vmap`ped over the batch as its pipeline runs it; the port against the
plain-numpy oracle of tests/test_ae_grouping.py; and the pipeline's 2x
bilinear upsample against `jax.image.resize` to 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_body_proportion_estimation_tpu.ops import ae_grouping as jae
from human_body_proportion_estimation_tpu_torch.ops import ae_grouping as tae
from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
    upsample2x,
)
from tests import torch_port_bottomup as cases_mod
from tests.test_ae_grouping import oracle_group

CASES = {name: (heat, tags, kw)
         for name, heat, tags, kw in cases_mod.decode_cases()}


def assert_exact(got: torch.Tensor, ref, what=""):
    """Equal element for element, NaN where NaN, dtype kind included."""
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(got, ref.astype(got.dtype), err_msg=what)


def jax_decode(heat, tags, **kw):
    return jax.jit(jax.vmap(functools.partial(jae.decode_bottom_up, **kw)))(
        jnp.asarray(heat), jnp.asarray(tags))


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_jax_exactly(name):
    """Keypoints, scores (NaN where JAX has NaN) and validity of every
    case, bit for bit."""
    heat, tags, kw = CASES[name]
    ref = jax_decode(heat, tags, **kw)
    got = tae.decode_bottom_up(torch.from_numpy(heat), torch.from_numpy(tags),
                               **kw)
    for field in ("keypoints", "scores", "valid"):
        assert_exact(getattr(got, field), getattr(ref, field),
                     f"{name}: {field}")


@pytest.mark.parametrize("name", ["random", "bf16", "ties", "plateau",
                                  "nan_inf"])
def test_find_peaks_and_tags_match_jax(name):
    """The top-M peaks (coords and scores, ties in index order, -1e9 for
    the non-peaks that fill a short list) and the tags gathered at them."""
    heat, tags, kw = CASES[name]
    m = kw["max_cands"]

    def one(h, t):
        peaks = jae.find_peaks(h, m)
        return peaks.coords, peaks.scores, jae.gather_tags(t, peaks.coords)

    coords, scores, tag_values = jax.jit(jax.vmap(one))(jnp.asarray(heat),
                                                        jnp.asarray(tags))
    peaks = tae.find_peaks(torch.from_numpy(heat), m)
    assert_exact(peaks.coords, coords, "coords")
    assert_exact(peaks.scores, scores, "scores")
    assert_exact(tae.gather_tags(torch.from_numpy(tags), peaks.coords),
                 tag_values, "tags")


@pytest.mark.parametrize("p,m", [(3, 8), (6, 4), (5, 5)])
def test_greedy_assign_matches_jax(p, m):
    """Masked argmins over cost matrices with exact ties and forbidden
    (1e9) entries: the first flat index wins, as in JAX."""
    rng = np.random.default_rng(p * 10 + m)
    cost = (rng.integers(0, 4, (6, p, m)) / 2).astype(np.float32)
    cost[rng.uniform(size=cost.shape) < 0.3] = 1e9
    ref = jax.jit(jax.vmap(
        lambda c: jae._greedy_assign(c, min(p, m))))(jnp.asarray(cost))
    got = tae._greedy_assign(torch.from_numpy(cost), min(p, m))
    assigned = np.asarray(ref[1])
    np.testing.assert_array_equal(got[1].numpy(), assigned)
    np.testing.assert_array_equal(got[0].numpy()[assigned],
                                  np.asarray(ref[0])[assigned])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouping_matches_numpy_oracle(seed):
    """The seeded cases of tests/test_ae_grouping.py through the port's
    `group_keypoints` (batch of one) against the plain-numpy oracle."""
    rng = np.random.default_rng(seed)
    k, m, p = 6, 5, 4
    coords = rng.integers(0, 48, (k, m, 2)).astype(np.int32)
    scores = np.sort(rng.random((k, m)).astype(np.float32))[:, ::-1].copy()
    tags = (rng.integers(0, 4, (k, m)) * 3.0
            + rng.normal(0, 0.05, (k, m))).astype(np.float32)
    got = tae.group_keypoints(
        tae.Peaks(torch.from_numpy(coords)[None],
                  torch.from_numpy(scores)[None]),
        torch.from_numpy(tags)[None], p, score_threshold=0.3,
        tag_threshold=1.0)
    ref_kp, ref_s, ref_valid = oracle_group(
        coords.astype(np.float32), scores, tags, p, 0.3, 1.0)
    np.testing.assert_array_equal(got.valid[0].numpy(), ref_valid)
    np.testing.assert_allclose(got.keypoints[0].numpy(), ref_kp, atol=1e-5)
    np.testing.assert_allclose(got.scores[0].numpy(), ref_s, atol=1e-5)


def test_synthetic_people_and_phantom_gate():
    """Two synthetic people come back at their joints; the phantom group
    opens without the person gate and is killed by it."""
    heat, tags, kw = CASES["people"]
    out = tae.decode_bottom_up(torch.from_numpy(heat), torch.from_numpy(tags),
                               **kw)
    assert out.valid[0].tolist() == [True, True, False]
    got = {tuple(map(tuple, out.keypoints[0, i].int().tolist()))
           for i in range(2)}
    assert got == {((10, 12), (14, 20), (9, 30), (15, 40)),
                   ((34, 12), (30, 22), (36, 31), (33, 42))}
    for gate, n in ((0.0, 2), (0.5, 1)):
        heat, tags, kw = CASES[f"phantom_gate_{gate}"]
        out = tae.decode_bottom_up(torch.from_numpy(heat),
                                   torch.from_numpy(tags), **kw)
        assert int(out.valid.sum()) == n


@pytest.mark.parametrize("shape", [(2, 34, 32, 32), (1, 3, 7, 5),
                                   (1, 2, 1, 4)])
def test_upsample_matches_jax_image_resize(shape):
    """`F.interpolate(bilinear, align_corners=False, antialias=False)` at
    2x equals `jax.image.resize(..., "bilinear")` to 1e-6, the border rows
    and columns included (JAX renormalizes its border weights; torch
    clamps the source index: the same values)."""
    x = np.random.default_rng(sum(shape)).normal(0, 1, shape).astype(
        np.float32)
    n, c, h, w = shape
    ref = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)),
                           (n, 2 * h, 2 * w, c), method="bilinear")
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    got = upsample2x(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., 0, :], ref[..., 0, :], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[..., :, -1], ref[..., :, -1], rtol=0,
                               atol=1e-6)


def test_upsample_keeps_a_non_finite_pixel_local():
    """The one divergence from `jax.image.resize` (ROADMAP.md section 3):
    JAX applies dense weight matrices, so 0 x NaN and 0 x inf poison the
    whole upsampled map; the port's bilinear touches the 4x4 output pixels
    around the input pixel only. Measured on a 16x16 map: JAX 1024 and
    1008 NaN pixels, the port 16 and 0."""
    x = np.random.default_rng(0).normal(0, 1, (1, 2, 16, 16)).astype(
        np.float32)
    x[0, 0, 5, 7], x[0, 1, 3, 3] = np.nan, np.inf
    ref = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                      (1, 32, 32, 2), method="bilinear"))
    got = upsample2x(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    assert [int(np.isnan(ref[..., c]).sum()) for c in (0, 1)] == [1024, 1008]
    assert [int(np.isnan(got[..., c]).sum()) for c in (0, 1)] == [16, 0]
    assert int(np.isinf(got[..., 1]).sum()) == 16
