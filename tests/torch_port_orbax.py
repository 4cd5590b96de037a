"""Shared by the port's Orbax tests: small flax trees, a pipeline
checkpoint of them written by the JAX package, tensorstore kept from the
port, and leaf-for-leaf bit equality of two trees."""

import sys

import numpy as np
import torch


def small_trees(seed: int = 0):
    """(det, pose) flax trees of f32 numpy arrays, leaves above and below
    the inline limit."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    det = {"params": {"head": {"kernel": f32(3, 3, 8, 16), "bias": f32(16)}},
           "batch_stats": {"head_bn": {"mean": f32(16), "var": f32(16)}}}
    pose = {"params": {"head": {"kernel": f32(1, 1, 8, 17),
                                "bias": f32(17)}}}
    return det, pose


def jax_checkpoint(directory: str, seed: int = 0):
    """`small_trees` written by the JAX package's `save_pipeline_checkpoint`
    into `directory`; returns the trees."""
    from human_body_proportion_estimation_tpu.models import weights as jw

    det, pose = small_trees(seed)
    jw.save_pipeline_checkpoint(directory, det, pose)
    return det, pose


def block_tensorstore(monkeypatch) -> None:
    """The port may not import tensorstore from here on (the JAX package's
    Orbax, imported before, keeps its own reference)."""
    import orbax.checkpoint  # noqa: F401  (imported while it still can)

    monkeypatch.setitem(sys.modules, "tensorstore", None)


def leaf_bits(leaf):
    """(dtype name, shape, bytes) of a leaf: numpy, jax, torch (bfloat16
    included) or a Python number."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16", tuple(leaf.shape), leaf.view(
                torch.int16).numpy().tobytes()
        leaf = leaf.numpy()
    if isinstance(leaf, (int, float, bool)):
        return type(leaf).__name__, (), repr(leaf).encode()
    arr = np.asarray(leaf)
    return arr.dtype.name, arr.shape, arr.tobytes()


def flat(tree, prefix=()):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], prefix + (k,)))
        else:
            out[prefix + (k,)] = tree[k]
    return out


def assert_bit_equal(got, want):
    """Same keys, and every leaf of the same dtype, shape and bytes."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        assert leaf_bits(got[k]) == leaf_bits(want[k]), k


def states_equal(a, b) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
