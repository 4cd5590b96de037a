"""Plain versions of the port's three CUDA kernels against the JAX package's
Pallas kernels, run in interpret mode on the CPU (the kernels themselves
need the card; `chip_smoke.py` holds each against its plain version
there). Also: CPU tensors dispatch to the plain version without counting a
launch, and the wrappers refuse what the kernels do not take."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_body_proportion_estimation_tpu.ops.heatmap import (
    decode_heatmaps as jdecode,
)
from human_body_proportion_estimation_tpu.ops.nms import nms_mask as jnms
from human_body_proportion_estimation_tpu.ops.pallas_kernels import (
    decode_heatmaps_pallas,
    head_score_epilogue,
    nms_sweep_pallas,
    nms_sweep_pallas_batched,
)
from human_body_proportion_estimation_tpu_torch.ops import kernels
from human_body_proportion_estimation_tpu_torch.ops.heatmap import (
    gate_keypoints,
)
from tests.torch_port_nms_cases import nms_cases


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


def _nan_maps(case):
    """[2, 17, 16, 12] finite maps with NaN planted in map (0, 3) only."""
    hm = np.random.default_rng(3).normal(0.5, 1, (2, 17, 16, 12)).astype(
        np.float32)
    if case == "one NaN in a map":
        hm[0, 3, 5, 7] = np.nan
    elif case == "all-NaN map":
        hm[0, 3] = np.nan
    else:  # NaN beside +inf
        hm[0, 3, 2, 2] = np.inf
        hm[0, 3, 2, 3] = np.nan
    hm[1, 4, 6, 6] = np.inf        # +inf alone stays an ordinary maximum
    hm[1, 5] = -np.inf             # and an all -inf map an ordinary map
    return hm


@pytest.mark.parametrize(
    "case", ["one NaN in a map", "all-NaN map", "NaN beside +inf"])
def test_decode_nan_map_follows_the_jax_package(case):
    """A map that holds a NaN: score NaN, keypoint (0, 0), invisible at any
    threshold; every other map decodes as if the NaN were not there. Exact
    (NaN-aware) against the Pallas kernel and `ops.heatmap.decode_heatmaps`
    of the JAX package."""
    hm = _nan_maps(case)
    kp, sc = kernels.decode_heatmaps(torch.from_numpy(hm))
    for ref in (decode_heatmaps_pallas(jnp.asarray(hm), interpret=True),
                jdecode(jnp.asarray(hm))):
        np.testing.assert_array_equal(kp.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(ref[1]))
    nan_at = np.zeros((2, 17), bool)
    nan_at[0, 3] = True
    np.testing.assert_array_equal(np.isnan(sc.numpy()), nan_at)
    np.testing.assert_array_equal(kp.numpy()[0, 3], [0.0, 0.0])
    visible = gate_keypoints(sc, [-np.inf] * 17).numpy()
    np.testing.assert_array_equal(visible, ~nan_at)
    # the other maps are those of the same batch without the NaN map
    clean = hm.copy()
    clean[0, 3] = 0.0
    kp_c, sc_c = kernels.decode_heatmaps(torch.from_numpy(clean))
    np.testing.assert_array_equal(kp.numpy()[~nan_at], kp_c.numpy()[~nan_at])
    np.testing.assert_array_equal(sc.numpy()[~nan_at], sc_c.numpy()[~nan_at])
    assert sc.numpy()[1, 4] == np.inf and tuple(kp.numpy()[1, 4]) == (6, 6)
    assert sc.numpy()[1, 5] == -np.inf and tuple(kp.numpy()[1, 5]) == (0, 0)


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


def _head_case(seed, f, a, c, level_hw, batch=2):
    rng = np.random.default_rng(seed)
    zs = [rng.normal(0, 1, (batch, h, w, f)).astype(np.float32)
          for h, w in level_hw]
    kernel = rng.normal(0, 0.1, (1, 1, f, a * c)).astype(np.float32)
    bias = rng.normal(0, 0.5, (a * c,)).astype(np.float32)
    weight = torch.from_numpy(kernel.reshape(f, a * c).T.copy())  # [A*C, F]
    return zs, kernel, bias, weight


def test_head_score_levels_matches_pallas_level_by_level():
    """The grouped entry point on three levels (the last a 20-cell level,
    ragged against any tile) equals the per-level Pallas outputs flattened
    and concatenated level-major. 1e-4: both sum exact bf16 products in
    f32, in different orders."""
    f, a, c = 64, 9, 90
    zs, kernel, bias, weight = _head_case(1, f, a, c,
                                          [(6, 8), (3, 4), (4, 5)])
    refs = [head_score_epilogue(
        jnp.asarray(z), jnp.asarray(kernel), jnp.asarray(bias), a, c,
        person_class0=0, tile_m=128, interpret=True) for z in zs]
    best_ref = np.concatenate(
        [np.asarray(r[0]).reshape(2, -1) for r in refs], 1)
    person_ref = np.concatenate(
        [np.asarray(r[1]).reshape(2, -1) for r in refs], 1)

    best, person = kernels.head_score_levels(
        [torch.from_numpy(z) for z in zs], weight, torch.from_numpy(bias),
        a, c, 0)
    assert best.shape == person.shape == (2, (48 + 12 + 20) * a)
    np.testing.assert_allclose(best.numpy(), best_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(person.numpy(), person_ref,
                               rtol=1e-4, atol=1e-4)
    assert torch.all(person <= best)
    is_person = person_ref >= best_ref
    assert is_person.any()
    np.testing.assert_array_equal(
        person.numpy()[is_person], best.numpy()[is_person])
    # the one-level wrapper is the same function on each level
    col = 0
    for z in zs:
        lb, lp = kernels.head_score(torch.from_numpy(z), weight,
                                    torch.from_numpy(bias), a, c, 0)
        n = lb[0].numel()
        assert torch.equal(lb.reshape(2, -1), best[:, col:col + n])
        assert torch.equal(lp.reshape(2, -1), person[:, col:col + n])
        col += n


@pytest.mark.parametrize("what,level_f,a,c", [
    ("more than 8 levels", [32] * 9, 3, 11),
    ("levels with different F", [32, 48], 3, 11),
    ("F not a multiple of 16", [40], 3, 11),
    ("F above 256", [272], 3, 11),
    ("C above 96", [32], 2, 97),
])
def test_head_score_levels_refuses_what_the_kernel_does_not_take(
        what, level_f, a, c):
    """Checked on the arguments alone, so on CPU tensors too."""
    zs = [torch.zeros((1, 2, 2, f)) for f in level_f]
    weight = torch.zeros((a * c, level_f[0]))
    with pytest.raises(ValueError):
        kernels.head_score_levels(zs, weight, torch.zeros(a * c), a, c, 0)


@pytest.mark.parametrize("f,a,c,person0", [(224, 9, 90, 0), (48, 3, 11, 4),
                                           (16, 2, 96, 95)])
def test_pack_head_weights_is_the_operand_order_the_kernel_reads(
        f, a, c, person0):
    """`pack_head_weights` against the addressing of csrc/head_score.cu,
    replayed in numpy: k-step ks reads the K chunks 2ks and 2ks + 1 of an
    anchor's slab as B[96, 16]; thread t of a quad feeds A's columns 2t,
    2t+1, 2t+8, 2t+9 from features 32p + 8t + (0..3 | 4..7) for the k-steps
    2p | 2p + 1, and adds to its accumulator columns 8j + 2t, 8j + 2t + 1
    the bias values 2j, 2j + 1 of its own 24. The result must be
    z @ W^T + bias exactly (f64 sums of bf16 products) with the person
    class and class 0 exchanged, and -inf in the pad columns."""
    rng = np.random.default_rng(5)
    weight = torch.from_numpy(rng.normal(0, 1, (a * c, f)).astype(
        np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.normal(0, 1, (a * c,)).astype(np.float32))
    z = torch.from_numpy(rng.normal(0, 1, (64, f)).astype(np.float32)).to(
        torch.bfloat16).float().numpy().astype(np.float64)
    slabs, bias_p = kernels.pack_head_weights(weight, bias, a, c, person0)
    kp = -(-f // 32)
    assert slabs.shape == (a, kp * 4, 96, 8) and slabs.is_contiguous()
    assert bias_p.shape == (a, 4, 24) and bias_p.is_contiguous()
    slabs = slabs.float().numpy().astype(np.float64)
    y = np.zeros((a, 64, 96))
    for ks in range(2 * kp):
        p, odd = divmod(ks, 2)
        a_frag = np.zeros((64, 16))
        for t in range(4):
            feats = 32 * p + 8 * t + 4 * odd + np.arange(4)
            vals = np.where(feats < f, z[:, np.minimum(feats, f - 1)], 0.0)
            a_frag[:, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = vals
        for an in range(a):
            b_frag = np.concatenate(
                [slabs[an, 2 * ks], slabs[an, 2 * ks + 1]], axis=1)
            y[an] += a_frag @ b_frag.T
    for t in range(4):
        for j in range(12):
            for i in range(2):
                y[:, :, 8 * j + 2 * t + i] += (
                    bias_p[:, t, 2 * j + i].numpy().astype(np.float64)[:, None])
    ref = (z @ weight.float().numpy().astype(np.float64).T
           + bias.numpy().astype(np.float64)).reshape(64, a, c)
    order = np.arange(c)
    order[0], order[person0] = person0, 0
    np.testing.assert_array_equal(y.transpose(1, 0, 2)[:, :, :c],
                                  ref[:, :, order])
    np.testing.assert_array_equal(y[:, :, c:], -np.inf)


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


_NMS_CASES = nms_cases()


@pytest.mark.parametrize("case", _NMS_CASES, ids=[c[0] for c in _NMS_CASES])
def test_nms_plain_on_the_shared_cases_follows_the_jax_package(case):
    """The cases `chip_smoke.py` holds the CUDA kernel to on the card, here
    for the plain version: exact keep masks against the JAX path's
    `nms_mask` image by image, against the Pallas sweep (interpret mode,
    batched), and against the mask the case states. NaN coordinates make
    every IoU with their box NaN, so such a box overlaps nothing; a NaN
    score is dead."""
    _, boxes, scores, t, expected = case
    got = kernels.nms_sweep(torch.from_numpy(boxes),
                            torch.from_numpy(scores), t).numpy()
    assert got.dtype == np.bool_ and got.shape == scores.shape
    for i in range(boxes.shape[0]):
        ref = np.asarray(jnms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                              t))
        np.testing.assert_array_equal(got[i], ref)
    np.testing.assert_array_equal(got, np.asarray(nms_sweep_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(scores), t, interpret=True)))
    if expected is not None:
        np.testing.assert_array_equal(got, expected)


def _block_sweep_replay(overlapping, alive):
    """A Python MODEL of the order of work of csrc/nms_sweep.cu on one image
    (it runs none of the CUDA code; the kernel itself is held against the
    plain version on the card by chip_smoke.py), on a given K x K overlap
    matrix: 32-box blocks; for a block, the words of the
    tiles below the diagonal ANDed with the finished blocks' keep words,
    then 32 chain steps over the diagonal tile's bits j > i."""
    k = len(alive)
    nb = (k + 31) // 32

    def word(i, w, lo=0):
        """Bits t >= lo of 'box 32w + t overlaps box i', t < 32, in range."""
        return sum(1 << t for t in range(lo, 32)
                   if 32 * w + t < k and overlapping[i, 32 * w + t])

    keep = []
    for rb in range(nb):
        rows = [min(32 * rb + r, k - 1) for r in range(32)]
        live = 0
        for lane, i in enumerate(rows):
            hit = 0
            for w in range(rb):
                hit |= word(i, w) & keep[w]
            if 32 * rb + lane < k and alive[i] and hit == 0:
                live |= 1 << lane
        removed = ~live & 0xFFFFFFFF
        for r, i in enumerate(rows):
            if not (removed >> r) & 1:
                removed |= word(i, rb, lo=r + 1)
        keep.append(~removed & 0xFFFFFFFF)
    return np.array([(keep[j // 32] >> (j % 32)) & 1 for j in range(k)], bool)


@pytest.mark.parametrize("case", _NMS_CASES, ids=[c[0] for c in _NMS_CASES])
def test_nms_block_sweep_of_the_cuda_kernel_equals_the_row_sweep(case):
    """A check of the algorithm, not of the kernel: the CUDA kernel's design
    never computes the tiles above the diagonal and resolves 32 boxes at a
    time, and on the plain version's overlap matrix a Python model of that
    order of work gives the plain version's masks, on every shared case. No
    edit to the .cu can fail this; it documents why the design is sound."""
    from human_body_proportion_estimation_tpu_torch.ops.boxes import box_iou

    _, boxes, scores, t, _ = case
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    ref = kernels.nms_sweep(tb, ts, t).numpy()
    overlapping = (box_iou(tb, tb) > t).numpy()
    for img in range(boxes.shape[0]):
        np.testing.assert_array_equal(
            _block_sweep_replay(overlapping[img], scores[img] > 0), ref[img])


def test_nms_shared_cases_cover_what_they_name():
    """The planted values are where the cases say: NaN and infinite
    coordinates among live boxes that do get suppressed or kept around them,
    and a chain whose three boxes lie in three 32-box blocks."""
    by_name = {c[0]: c for c in _NMS_CASES}
    _, boxes, scores, t, _ = by_name[
        "NaN and inf boxes among live ones, t=0.5"]
    assert np.isnan(boxes).any() and np.isinf(boxes).any()
    assert np.isnan(scores).sum() == boxes.shape[0]
    keep = kernels.nms_sweep(torch.from_numpy(boxes),
                             torch.from_numpy(scores), t).numpy()
    nan_box = np.isnan(boxes).any(-1) & (scores > 0)
    assert nan_box.sum() >= 3 * 4 * 3 and keep[nan_box].all()
    assert not keep[np.isnan(scores)].any()
    finite = np.isfinite(boxes).all(-1) & (scores > 0)
    assert keep[finite].any() and not keep[finite].all()
    # without the NaN rule (NaN dropped by min / max, as C's fmaxf does) the
    # six-box case would lose boxes 1 and 3
    _, boxes, scores, t, expected = by_name["NaN and inf boxes, six"]
    assert expected.tolist() == [[True, True, False, True, True, True]]
    _, boxes, _, _, expected = by_name["chain across three blocks"]
    assert {0 // 32, 40 // 32, 80 // 32} == {0, 1, 2}
    assert expected[0, [0, 40, 80]].tolist() == [True, False, True]


def test_nms_class_offset_case_covers_what_it_names():
    """The class-offset case: coordinates in the 1e5 range, equal raw boxes
    of two classes that the shift keeps apart, boxes of one class
    suppressing each other, and the pair that overlaps across the shift."""
    from human_body_proportion_estimation_tpu_torch.ops.boxes import box_iou
    from tests.torch_port_nms_cases import MAX_WH, class_offset

    boxes, scores, classes = class_offset()
    assert boxes.max() > 3.6e5 and len(set(classes.tolist())) >= 6
    tb = torch.from_numpy(boxes)
    keep = kernels.nms_sweep(tb, torch.from_numpy(scores), 0.5).numpy()[0]
    raw = boxes[0] - classes[:, None] * MAX_WH
    np.testing.assert_allclose(raw[3::2], raw[2::2], atol=2 ** -4)  # f32 at 1e5
    iou = box_iou(tb, tb)[0].numpy()
    k = len(classes)
    assert (iou[np.arange(2, k, 2), np.arange(3, k, 2)] == 0).all()
    assert iou[0, 1] > 0.5 and keep[0] and not keep[1]   # across the shift
    live = scores[0] > 0
    assert keep[live].sum() < live.sum() - 1             # inside a class
    assert keep[3::2][keep[2::2] & live[3::2]].mean() > 0.5


def test_cpu_tensors_take_the_plain_version_without_counting():
    kernels.reset_launch_counts()
    kernels.decode_heatmaps(torch.zeros((1, 17, 8, 8)))
    kernels.nms_sweep(torch.zeros((1, 4, 4)), torch.zeros((1, 4)), 0.5)
    kernels.head_score(torch.zeros((1, 2, 2, 16)), torch.zeros((9 * 4, 16)),
                       torch.zeros(9 * 4), 9, 4, 0)
    kernels.head_score_levels(
        [torch.zeros((1, 2, 2, 16)), torch.zeros((1, 1, 1, 16))],
        torch.zeros((9 * 4, 16)), torch.zeros(9 * 4), 9, 4, 0)
    assert kernels.launch_counts() == {
        "decode_heatmaps": 0, "head_score": 0, "nms_sweep": 0}


def test_mixed_devices_are_refused():
    with pytest.raises(ValueError):
        kernels._on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))
