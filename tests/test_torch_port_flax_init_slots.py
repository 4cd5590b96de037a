"""`models/flax_init` against flax `init` for the other two slots the JAX
package initializes (EfficientDet-Lite0 and HigherHRNet-W32), full width,
at seeds 0 and 1: the checks of tests/test_torch_port_flax_init.py, in a
file of their own so that the suite's workers take the two side by side.
"""

import pytest

from tests.test_torch_port_flax_init import SEEDS, check_bits, check_draw

SLOTS = ("efficientdet_lite0", "higherhrnet")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SLOTS)
def test_port_draw_is_flax_init(name, seed):
    check_draw(name, seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SLOTS)
def test_leaf_bits_are_jax_random_bits(name, seed):
    check_bits(name, seed)
