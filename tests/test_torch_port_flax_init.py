"""`models/flax_init` (the port's draw of flax's `init`, without JAX) held
against jax.random and flax.

For the full-width HRNet-W32, EfficientDet-Lite4, EfficientDet-Lite0 and
HigherHRNet-W32, at seeds 0 and 1: the port's `init_state_dict` of the
port model is flax's `init` of the JAX model with PRNGKey(seed), leaf by
leaf: each kernel's uint32 threefry bits are `jax.random.bits` of the key
flax gives that leaf, each float within 4 float32 ulps (on the CPU with
jax 0.9.0 and flax 0.12.3 all are bit-equal), the constant leaves
exact. flax's `lazy_init` gives `init`'s values without running the
forward (~5-25 s a model on the CPU); each model is initialized once a
seed, for the module. The certify CLIs' two models are held here, the
other two slots in tests/test_torch_port_flax_init_slots.py (two files,
so that the suite's workers take them side by side).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.core import scope as flax_scope

from human_body_proportion_estimation_tpu.models import efficientdet as jedet
from human_body_proportion_estimation_tpu.models import higherhrnet as jhh
from human_body_proportion_estimation_tpu.models import hrnet as jhrnet
from human_body_proportion_estimation_tpu_torch.models import (
    efficientdet as tedet,
    flax_init as fi,
    higherhrnet as thh,
    hrnet as thrnet,
    layers,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)

MODELS = {
    # name: (JAX model, its input hw, the port model)
    "hrnet_w32": (lambda: jhrnet.create_hrnet("hrnet_w32"), (64, 64),
                  lambda: thrnet.create_hrnet("hrnet_w32")),
    "efficientdet_lite4": (
        lambda: jedet.EfficientDet(config=jedet.EFFICIENTDET_LITE4),
        (128, 128), lambda: tedet.EfficientDet(tedet.EFFICIENTDET_LITE4)),
    "efficientdet_lite0": (
        lambda: jedet.EfficientDet(config=jedet.EFFICIENTDET_LITE0),
        (128, 128), lambda: tedet.EfficientDet(tedet.EFFICIENTDET_LITE0)),
    "higherhrnet": (jhh.HigherHRNet, (64, 64), thh.HigherHRNet),
}
SEEDS = (0, 1)
MAX_ULPS = 4
CERTIFY_MODELS = ("efficientdet_lite4", "hrnet_w32")


@functools.lru_cache(maxsize=None)
def flax_variables(name, seed):
    jmodel, hw, _ = MODELS[name]
    return jax.tree.map(np.asarray, jmodel().lazy_init(
        jax.random.PRNGKey(seed),
        jax.ShapeDtypeStruct((1, *hw, 3), jnp.uint8)))


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


def check_draw(name, seed):
    """Every leaf of the port's draw against flax `init`'s."""
    ref = flax_to_state_dict(flax_variables(name, seed))
    model = MODELS[name][2]()
    got = fi.init_state_dict(model, seed)
    assert got.keys() == ref.keys() == model.state_dict().keys()
    drawn = bit_equal = 0
    for key, value in got.items():
        r = ref[key].numpy()
        assert value.shape == r.shape, key
        if key.endswith("weight") and value.dim() == 4:
            ulps = _ulps(value.numpy(), r)
            assert ulps.max() <= MAX_ULPS, (key, int(ulps.max()))
            drawn += 1
            bit_equal += int(ulps.max() == 0)
        else:
            np.testing.assert_array_equal(value.numpy(), r, err_msg=key)
    assert drawn > 30
    assert bit_equal >= 0.9 * drawn, (bit_equal, drawn)


def check_bits(name, seed):
    """Each kernel's key is the one flax folds from its module path and
    param count (flax's own `_fold_in_static`), and its bits are
    `jax.random.bits` of that key over the leaf's flax shape (the first
    40 kernels)."""
    params = state_dict_to_flax({
        k: v for k, v in MODELS[name][2]().state_dict().items()
        if v.is_floating_point()})["params"]
    root = jax.random.PRNGKey(seed)
    checked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = tuple(p.key for p in path)
        if names[-1] != "kernel" or checked >= 40:
            continue
        jkey = flax_scope._fold_in_static(root, names[:-1] + (1,))
        pkey = fi.param_key(fi.prng_key(seed), names[:-1], 1)
        np.testing.assert_array_equal(np.asarray(jkey), pkey)
        jbits = np.asarray(jax.random.bits(jkey, (leaf.size,), jnp.uint32))
        np.testing.assert_array_equal(jbits.reshape(leaf.shape),
                                      fi.random_bits(pkey, leaf.shape))
        checked += 1
    assert checked == 40


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CERTIFY_MODELS)
def test_port_draw_is_flax_init(name, seed):
    check_draw(name, seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CERTIFY_MODELS)
def test_leaf_bits_are_jax_random_bits(name, seed):
    check_bits(name, seed)


def test_fold_in_split_and_prng_key_are_exact():
    keys = [0, 1, 7, 42, 2**31 - 1, 2**32 - 1]
    datas = [0, 1, 5, 123456789, 2**32 - 1]
    for seed in keys:
        jk = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(np.asarray(jk), fi.prng_key(seed))
        for d in datas:
            np.testing.assert_array_equal(
                np.asarray(jax.random.fold_in(jk, d)),
                fi.fold_in(fi.prng_key(seed), d))
        for num in (2, 3, 8):
            np.testing.assert_array_equal(
                np.asarray(jax.random.split(jk, num)),
                fi.split(fi.prng_key(seed), num))


def test_random_bits_uniform_truncated_normal_and_erf_inv():
    """The sampling chain one step at a time, on 200 000 draws: bits and
    the uniform exactly, XLA's erf_inv and the truncated normal within
    the stated ulps (bit-equal on the CPU), lecun_normal on a conv shape."""
    key = jax.random.PRNGKey(3)
    pkey = fi.prng_key(3)
    shape = (200, 1000)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, shape, jnp.uint32)),
        fi.random_bits(pkey, shape))
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32, fi._ERF_LO,
                                      fi._ERF_HI))
    np.testing.assert_array_equal(u, fi.uniform(pkey, shape, fi._ERF_LO,
                                                 fi._ERF_HI))
    assert _ulps(jax.jit(jax.lax.erf_inv)(u), fi.erf_inv(u)).max() \
        <= MAX_ULPS
    assert _ulps(jax.random.truncated_normal(key, -2, 2, shape),
                 fi.truncated_normal(pkey, shape)).max() <= MAX_ULPS
    from flax import linen as nn
    conv = (3, 3, 64, 32)
    assert _ulps(nn.initializers.lecun_normal()(key, conv, jnp.float32),
                 fi.lecun_normal(pkey, conv)).max() <= MAX_ULPS
    # the erf constants are XLA's float32 erf(-+2 / sqrt 2)
    s2 = np.float32(np.sqrt(2))
    assert np.asarray(jax.lax.erf(jnp.float32(-2) / s2)) == fi._ERF_LO
    assert np.asarray(jax.lax.erf(jnp.float32(2) / s2)) == fi._ERF_HI


def test_init_flax_default_loads_the_draw_into_the_module():
    model = thrnet.create_hrnet("hrnet_w32")
    layers.init_flax_default(model, 1)
    ref = flax_to_state_dict(flax_variables("hrnet_w32", 1))
    for key, value in model.state_dict().items():
        if value.is_floating_point():
            assert _ulps(value.numpy(), ref[key].numpy()).max() \
                <= MAX_ULPS, key
