"""Writes the committed Orbax fixture `tests/data/torch_port/orbax_jax/` and
its twin `orbax_jax.npz`, with the JAX package (on the CPU):

    JAX_PLATFORMS=cpu python -m tests.torch_port_orbax_fixture

A pipeline checkpoint from the JAX package's `save_pipeline_checkpoint`
(Orbax, OCDBT, zarr v2), made from seeded numpy arrays: every dtype the
port's reader takes (`<f4`, `<f2`, `<f8`, `<i4`, `<i8`, `|b1`, `|u1`, and
bfloat16 as a jax.Array), a 0-d int32 `step` and a numpy scalar, leaves
above and below the 1024-byte inline limit, and in the pose slot one leaf
that tensorstore's zarr support writes into the same OCDBT store in 4x4
chunks: an edge chunk in each dimension and one chunk absent (read as
the fill value, -1.5). The twin holds what the JAX package's
`load_pipeline_checkpoint` restores, leaf by leaf under 'det/...' and
'pose/...' paths (bfloat16 as its uint16 bits), and for the multi-chunk
leaf, which Orbax's restore refuses (it does not read absent chunks as the
fill value), what tensorstore's zarr support reads. The card has no JAX:
there, this fixture shows that the port reads what JAX writes.
"""

import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "torch_port", "orbax_jax")
TWIN = os.path.join(HERE, "data", "torch_port", "orbax_jax.npz")
MULTI_SHAPE, MULTI_CHUNKS, MULTI_FILL = (10, 7), (4, 4), -1.5


def trees(seed: int = 0):
    """(det, pose) trees of numpy arrays (bfloat16 leaves as float32, cast
    by `generate`)."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    det = {"params": {"conv": {"kernel": f32(3, 3, 8, 16),    # 4.6 KB
                               "bias": f32(16)},             # inline
                      "half": rng.normal(size=600).astype(np.float16),
                      "wide": rng.normal(size=5)},           # float64
           "batch_stats": {"conv": {"mean": f32(16), "var": f32(16)}},
           "step": np.asarray(7, np.int32)}
    pose = {"params": {"bf16": f32(40, 8),
                       "i4": rng.integers(-9, 9, 7).astype(np.int32),
                       "i8": rng.integers(-2**40, 2**40, 300),  # 2.4 KB
                       "b1": rng.random(10) < 0.5,
                       "u1": rng.integers(0, 256, 2000).astype(np.uint8)},
            "count": np.int32(3)}
    return det, pose


def flat(tree, prefix):
    out = {}
    for k in sorted(tree):
        name = f"{prefix}/{k}"
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], name))
        else:
            out[name] = tree[k]
    return out


def generate():
    import jax
    import jax.numpy as jnp
    import tensorstore as ts

    from human_body_proportion_estimation_tpu.models.weights import (
        load_pipeline_checkpoint,
        save_pipeline_checkpoint,
    )

    jax.config.update("jax_platforms", "cpu")
    det, pose = trees()
    pose["params"]["bf16"] = jnp.asarray(pose["params"]["bf16"],
                                         jnp.bfloat16)
    shutil.rmtree(FIXTURE, ignore_errors=True)
    save_pipeline_checkpoint(FIXTURE, det, pose)
    got_det, got_pose = load_pipeline_checkpoint(FIXTURE)
    twin = {}
    for name, leaf in {**flat(got_det, "det"),
                       **flat(got_pose, "pose")}.items():
        leaf = np.asarray(leaf)
        if leaf.dtype.name == "bfloat16":
            leaf = leaf.view(np.uint16)
        twin[name] = leaf

    # a multi-chunk leaf, written by tensorstore's zarr support into the
    # pose slot's OCDBT store, as Orbax lays a leaf out; chunk (2, 1)
    # (rows 8-9, columns 4-6) is never written
    slot = os.path.join(FIXTURE, "pose")
    arr = ts.open({
        "driver": "zarr",
        "kvstore": {"driver": "ocdbt", "base": f"file://{slot}/",
                    "path": "params.multi/"},
        "metadata": {"shape": list(MULTI_SHAPE),
                     "chunks": list(MULTI_CHUNKS), "dtype": "<f4",
                     "fill_value": MULTI_FILL,
                     "compressor": {"id": "zstd", "level": 1},
                     "dimension_separator": "."},
    }, create=True).result()
    values = np.arange(70, dtype=np.float32).reshape(MULTI_SHAPE) / 8
    arr[0:8, :].write(values[0:8]).result()
    arr[8:10, 0:4].write(values[8:10, 0:4]).result()
    with open(os.path.join(slot, "_METADATA")) as fh:
        meta = json.load(fh)
    meta["tree_metadata"][str(("params", "multi"))] = {
        "key_metadata": [{"key": "params", "key_type": 2},
                         {"key": "multi", "key_type": 2}],
        "value_metadata": {"value_type": "np.ndarray",
                           "skip_deserialize": False}}
    with open(os.path.join(slot, "_METADATA"), "w") as fh:
        json.dump(meta, fh)

    multi = arr.read().result()
    twin["pose/params/multi"] = multi
    assert (multi[8:, 4:] == MULTI_FILL).all() and (
        multi[:8] == values[:8]).all()
    np.savez(TWIN, **twin)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    print(f"wrote {FIXTURE} ({size} bytes) and {TWIN} ({len(twin)} leaves)")


if __name__ == "__main__":
    generate()
