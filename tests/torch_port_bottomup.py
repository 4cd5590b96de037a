"""Seeded inputs of the port's bottom-up decode and pipeline, shared by the
CPU tests (tests/test_torch_port_ae_grouping.py,
tests/test_torch_port_bottomup.py), the goldens generator
(tests/test_torch_port_bottomup_goldens.py) and `chip_smoke.py` phase U,
which loads this file by its path: it imports numpy only, nothing of
JAX.

`decode_cases()` are the aggregated heat / tag maps the AE decode is held
to the JAX package on, exactly: seeded random maps, maps rounded to bf16
and coarser (full of ties), flat plateaus, NaN and infinite pixels, and
the synthetic people of tests/test_ae_grouping.py (two people; a phantom
group that the person gate kills).
"""

import numpy as np

K = 17
# the pipeline's decode parameters (BottomUpPipeline's defaults)
DEFAULTS = dict(max_people=3, max_cands=8, score_threshold=0.1,
                tag_threshold=1.0, person_score_threshold=0.25)


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), kept in float32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32)


def _gaussian(h, w, cx, cy, sigma=1.5):
    y, x = np.mgrid[0:h, 0:w]
    return np.exp(-((x - cx) ** 2 + (y - cy) ** 2)
                  / (2 * sigma ** 2)).astype(np.float32)


def _people(h=64, w=48, phantom=False):
    """[1, 4, h, w] heat and tags: two people with tags -2 and 2 (or one
    person and a weak phantom bump with a far tag), as in
    tests/test_ae_grouping.py."""
    k = 4
    heat = np.zeros((1, k, h, w), np.float32)
    tags = np.zeros((1, k, h, w), np.float32)
    people = [(-2.0, [(10, 12), (14, 20), (9, 30), (15, 40)])]
    if not phantom:
        people.append((2.0, [(34, 12), (30, 22), (36, 31), (33, 42)]))
    for tag, joints in people:
        for j, (cx, cy) in enumerate(joints):
            heat[0, j] = np.maximum(heat[0, j], _gaussian(h, w, cx, cy))
            tags[0, j, cy, cx] = tag
    if phantom:
        heat[0, 0] = np.maximum(heat[0, 0], 0.2 * _gaussian(h, w, 40, 50))
        tags[0, 0, 50, 40] = 3.0
    return heat, tags


def decode_cases(seed: int = 0):
    """[(name, heat [B, K, H, W] f32, tags f32, decode kwargs)]."""
    rng = np.random.default_rng(seed)
    cases = []
    b, h, w = 2, 24, 20

    heat = rng.normal(0.3, 0.4, (b, K, h, w)).astype(np.float32)
    tags = rng.normal(0.0, 1.5, (b, K, h, w)).astype(np.float32)
    cases.append(("random", heat, tags, dict(DEFAULTS)))
    cases.append(("random_p6_m4", heat, tags,
                  dict(DEFAULTS, max_people=6, max_cands=4,
                       person_score_threshold=0.0)))

    # bf16 maps, then a coarser grid still: equal peaks in every map, equal
    # tag costs between groups
    heat = bf16_round(rng.uniform(0.0, 1.0, (b, K, h, w)))
    cases.append(("bf16", heat,
                  bf16_round(rng.normal(0.0, 1.0, (b, K, h, w))),
                  dict(DEFAULTS)))
    heat = (np.round(rng.uniform(0.0, 1.0, (b, K, h, w)) * 4) / 4).astype(
        np.float32)
    tags = (np.round(rng.normal(0.0, 1.0, (b, K, h, w)) * 2) / 2).astype(
        np.float32)
    cases.append(("ties", heat, tags, dict(DEFAULTS, max_people=5)))

    # plateaus: constant maps (every pixel a peak), and a constant block
    # on a zero map whose every pixel ties
    heat = np.zeros((b, K, h, w), np.float32)
    heat[0, :] = 0.5
    heat[1, :, 4:10, 6:9] = 0.75
    heat[1, ::2, 15:18, 2:5] = 0.625
    tags = np.zeros((b, K, h, w), np.float32)
    tags[1, :, 15:, :] = 3.0
    cases.append(("plateau", heat, tags, dict(DEFAULTS)))

    # NaN and infinite pixels: an all-NaN map, single NaN pixels (peaks
    # nearby), a NaN tag at a peak, +inf and -inf pixels, a -inf map
    heat = rng.normal(0.4, 0.3, (b, K, h, w)).astype(np.float32)
    tags = rng.normal(0.0, 1.0, (b, K, h, w)).astype(np.float32)
    heat[0, 3] = np.nan
    heat[0, 5, 7, 7] = np.nan
    heat[1, 0, 0, 0] = np.nan
    heat[1, 6, 10, 10] = np.inf
    heat[1, 8, 3:6, 3:6] = -np.inf
    heat[1, 9] = -np.inf
    flat = heat[0, 1].argmax()
    tags[0, 1].flat[flat] = np.nan
    cases.append(("nan_inf", heat, tags, dict(DEFAULTS)))

    heat, tags = _people()
    cases.append(("people", heat, tags,
                  dict(max_people=3, max_cands=4, score_threshold=0.5,
                       tag_threshold=1.0, person_score_threshold=0.0)))
    heat, tags = _people(phantom=True)
    for gate in (0.0, 0.5):
        cases.append((f"phantom_gate_{gate}", heat, tags,
                      dict(max_people=3, max_cands=4, score_threshold=0.1,
                           tag_threshold=1.0, person_score_threshold=gate)))
    return cases

