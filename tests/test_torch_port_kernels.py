"""Plain versions of the port's three CUDA kernels against the JAX package's
Pallas kernels, run in interpret mode on the CPU (the kernels themselves
need the card; `chip_smoke.py` holds each against its plain version
there). Also: CPU tensors dispatch to the plain version without counting a
launch, and the wrappers refuse what the kernels do not take."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_body_proportion_estimation_tpu.ops.nms import nms_mask as jnms
from human_body_proportion_estimation_tpu.ops.pallas_kernels import (
    decode_heatmaps_pallas,
    head_score_epilogue,
    nms_sweep_pallas,
    nms_sweep_pallas_batched,
)
from human_body_proportion_estimation_tpu_torch.ops import kernels


def _planted_heatmaps(seed, shape=(6, 17, 96, 72)):
    rng = np.random.default_rng(seed)
    hm = rng.normal(0, 1, shape).astype(np.float32)
    flat = hm.reshape(-1, shape[-2] * shape[-1])
    for r in range(0, flat.shape[0], 5):       # ties: the max twice
        top = flat[r].max() + 1.0
        flat[r, 4000] = top
        flat[r, 17 + r] = top
    flat[1::7] = -np.abs(flat[1::7]) - 0.1      # all-negative maps
    flat[2::9] = 0.5                            # all-equal maps
    return hm


def test_decode_plain_matches_pallas_exactly():
    """Exact: argmax index, first occurrence on ties, score = max, (x, y)
    zeroed where score <= 0."""
    hm = _planted_heatmaps(0)
    kp_ref, sc_ref = decode_heatmaps_pallas(jnp.asarray(hm), interpret=True)
    kp, sc = kernels.decode_heatmaps(torch.from_numpy(hm))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kp_ref))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_ref))


def test_decode_plain_all_negative_maps_zeroed():
    hm = np.full((2, 17, 16, 12), -1.0, np.float32)
    kp_ref, sc_ref = decode_heatmaps_pallas(jnp.asarray(hm), interpret=True)
    kp, sc = kernels.decode_heatmaps(torch.from_numpy(hm))
    np.testing.assert_array_equal(kp.numpy(), 0.0)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kp_ref))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_ref))


@pytest.mark.parametrize("hw,f,a,c", [((12, 16), 64, 9, 90),
                                      ((7, 5), 32, 3, 11)])
def test_head_score_plain_matches_pallas(hw, f, a, c):
    """1e-4: both round z and W to bf16 and sum exact bf16 products in f32,
    in different orders. The person logit is the value the max ran over:
    person <= best everywhere, and equal wherever person is the argmax."""
    rng = np.random.default_rng(0)
    h, w = hw
    z = rng.normal(0, 1, (2, h, w, f)).astype(np.float32)
    kernel = rng.normal(0, 0.1, (1, 1, f, a * c)).astype(np.float32)
    bias = rng.normal(0, 0.5, (a * c,)).astype(np.float32)
    best_ref, person_ref = head_score_epilogue(
        jnp.asarray(z), jnp.asarray(kernel), jnp.asarray(bias), a, c,
        person_class0=0, tile_m=128, interpret=True)

    weight = torch.from_numpy(kernel.reshape(f, a * c).T.copy())  # [A*C, F]
    best, person = kernels.head_score(
        torch.from_numpy(z), weight, torch.from_numpy(bias), a, c, 0)
    assert best.shape == (2, h, w, a) and person.shape == (2, h, w, a)
    np.testing.assert_allclose(best.numpy(), np.asarray(best_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(person.numpy(), np.asarray(person_ref),
                               rtol=1e-4, atol=1e-4)
    assert torch.all(person <= best)
    is_person = np.asarray(person_ref) >= np.asarray(best_ref)
    assert is_person.any()
    np.testing.assert_array_equal(
        person.numpy()[is_person], best.numpy()[is_person])


def _nms_case(seed, n=128, dead=5):
    rng = np.random.default_rng(seed)
    x1y1 = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(10, 150, (n, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, n).astype(np.float32))[::-1].copy()
    scores[-dead:] = 0.0  # dead padding rows
    return boxes, scores


@pytest.mark.parametrize("t", [0.5, 0.3])
def test_nms_plain_matches_pallas_and_nms_mask(t):
    """Exact keep masks, batched over 3 images, against both the Pallas
    sweep (interpret) and the JAX path's `nms_mask`."""
    cases = [_nms_case(s) for s in range(3)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    got = kernels.nms_sweep(torch.from_numpy(boxes),
                            torch.from_numpy(scores), t).numpy()
    ref_pallas = np.asarray(nms_sweep_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(scores), t, interpret=True))
    np.testing.assert_array_equal(got, ref_pallas)
    for i in range(3):
        ref = np.asarray(jnms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                              t))
        np.testing.assert_array_equal(got[i], ref)
        np.testing.assert_array_equal(got[i], np.asarray(nms_sweep_pallas(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), t,
            interpret=True)))


def _division_vs_product_pair(t=0.3):
    """Two boxes whose f32 IoU test differs between `inter / union > t`
    (ops/nms.nms_mask, the JAX path) and `inter > t * union` (the Pallas
    kernel): same width, heights ha and hb ~= t * ha (IoU ~= hb / ha),
    found by a seeded vectorized search."""
    rng = np.random.default_rng(7)
    t32 = np.float32(t)
    w = rng.uniform(20, 400, 4096).astype(np.float32)
    ha = rng.uniform(20, 400, 4096).astype(np.float32)
    hb = (ha * t32).astype(np.float32)
    inter = (w * hb).astype(np.float32)
    union = ((w * ha).astype(np.float32) + inter) - inter
    div = (inter / np.maximum(union, np.float32(1e-12))) > t32
    prod = inter > (t32 * union).astype(np.float32)
    i = int(np.nonzero(div != prod)[0][0])
    box_a = np.array([0.0, 0.0, w[i], ha[i]], np.float32)
    box_b = np.array([0.0, 0.0, w[i], hb[i]], np.float32)
    return box_a, box_b, bool(div[i])


def test_nms_at_threshold_follows_division_form():
    """At IoU == t exactly both boxes survive (IoU > t is required), and
    where the division and product forms round apart, the port follows the
    JAX path's division form."""
    boxes = np.array([[0, 0, 100, 100], [0, 0, 100, 50]], np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    keep = kernels.nms_sweep(torch.from_numpy(boxes[None]),
                             torch.from_numpy(scores[None]), 0.5)[0]
    assert keep.tolist() == [True, True]           # IoU exactly 0.5
    assert np.asarray(jnms(jnp.asarray(boxes), jnp.asarray(scores),
                           0.5)).tolist() == [True, True]

    box_a, box_b, overlaps = _division_vs_product_pair()
    pair = np.stack([box_a, box_b])
    keep = kernels.nms_sweep(torch.from_numpy(pair[None]),
                             torch.from_numpy(scores[None]), 0.3)[0]
    ref = np.asarray(jnms(jnp.asarray(pair), jnp.asarray(scores), 0.3))
    assert keep.tolist() == ref.tolist() == [True, not overlaps]


def test_cpu_tensors_take_the_plain_version_without_counting():
    kernels.reset_launch_counts()
    kernels.decode_heatmaps(torch.zeros((1, 17, 8, 8)))
    kernels.nms_sweep(torch.zeros((1, 4, 4)), torch.zeros((1, 4)), 0.5)
    kernels.head_score(torch.zeros((1, 2, 2, 16)), torch.zeros((9 * 4, 16)),
                       torch.zeros(9 * 4), 9, 4, 0)
    assert kernels.launch_counts() == {
        "decode_heatmaps": 0, "head_score": 0, "nms_sweep": 0}


def test_mixed_devices_are_refused():
    with pytest.raises(ValueError):
        kernels._on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))
