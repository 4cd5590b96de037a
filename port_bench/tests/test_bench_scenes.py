"""The benchmark's frozen copy of the scene renderer gives the measured
program's pixels and truth for a seed."""

from __future__ import annotations

import numpy as np
import pytest

from human_body_proportion_estimation_tpu_torch.training import synthetic
from port_bench import scenes


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_copied_renderer_matches_the_program(seed):
    a = scenes.generate_scene(np.random.default_rng(seed))
    b = synthetic.generate_scene(np.random.default_rng(seed))
    assert np.array_equal(a.image, b.image)
    assert np.array_equal(a.keypoints, b.keypoints)
    assert np.array_equal(a.bbox_xyxy, b.bbox_xyxy)
    assert a.height_cm == b.height_cm
