"""The port's Orbax store (`models/orbax_store.py`) and zstd decoder
(`utils/zstd.py`, `utils/zstd_decompress.cpp`) against the JAX package's
Orbax (tensorstore) and the `zstandard` package, on the CPU, with
tensorstore kept from the port in every test:

- the certified Lite4 + W32 pipeline: JAX's `save_pipeline_checkpoint` ->
  the port's `load_pipeline_checkpoint`, and the port's writer -> JAX's
  loader, every leaf bit-equal;
- the committed JAX-written fixture (every dtype, scalars, inline and
  indirect values, a multi-chunk leaf with an edge and an absent chunk)
  against its `.npz` twin;
- a store of 5 000 keys written by tensorstore's OCDBT key-value store
  with small nodes (interior B-tree nodes, version-tree nodes in the
  manifest);
- a flipped byte in a node or a manifest raises a CRC32C error;
- the decoder against `zstandard` (levels -5 to 19, checksums, frames
  with and without a content size, multi-block and concatenated frames,
  random / constant / weight-like / text inputs up to 1 MiB), and the
  writer's raw-block frames read by `zstandard`.
"""

import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch
import zstandard

import jax
import orbax.checkpoint as ocp  # noqa: F401  (before tensorstore is blocked)
import tensorstore as ts

from human_body_proportion_estimation_tpu.models import weights as jw
from human_body_proportion_estimation_tpu_torch.models import (
    orbax_store,
    weights as tw,
)
from human_body_proportion_estimation_tpu_torch.utils import zstd
from tests.torch_port_orbax import (
    assert_bit_equal,
    block_tensorstore,
    flat,
    leaf_bits,
    small_trees,
)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")


@pytest.fixture(scope="module")
def certified(tmp_path_factory):
    """The certified Lite4 + W32 trees (f32), written once by JAX."""
    det, pose = tw.load_compact_checkpoint(tw.default_certified_checkpoint())
    root = tmp_path_factory.mktemp("certified")
    jw.save_pipeline_checkpoint(str(root / "jax"), det, pose)
    return det, pose, root


def test_port_reads_the_jax_written_certified_pipeline(certified,
                                                       monkeypatch):
    det, pose, root = certified
    block_tensorstore(monkeypatch)
    got_det, got_pose = tw.load_pipeline_checkpoint(str(root / "jax"))
    assert (len(flat(got_det)), len(flat(got_pose))) == (1062, 1527)
    assert_bit_equal(got_det, det)
    assert_bit_equal(got_pose, pose)


def test_jax_reads_the_port_written_certified_pipeline(certified,
                                                       monkeypatch):
    det, pose, root = certified
    block_tensorstore(monkeypatch)
    tw.save_pipeline_checkpoint(str(root / "port"), det, pose)
    # the port reads its own output too, and a second save replaces it
    tw.save_pipeline_checkpoint(str(root / "port"), det, pose)
    assert sorted(os.listdir(root)) == ["jax", "port"]
    ref_det, ref_pose = jw.load_pipeline_checkpoint(str(root / "port"))
    assert_bit_equal(jax.tree.map(np.asarray, ref_det), det)
    assert_bit_equal(jax.tree.map(np.asarray, ref_pose), pose)


def test_port_reads_the_committed_jax_fixture(monkeypatch):
    """Every leaf of `orbax_jax/` (written by JAX and tensorstore, see
    tests/torch_port_orbax_fixture.py) equals its twin bit for bit."""
    block_tensorstore(monkeypatch)
    det, pose = tw.load_pipeline_checkpoint(os.path.join(DATA, "orbax_jax"))
    twin = np.load(os.path.join(DATA, "orbax_jax.npz"))
    got = {"/".join(("det",) + k): v for k, v in flat(det).items()}
    got.update({"/".join(("pose",) + k): v for k, v in flat(pose).items()})
    assert sorted(got) == sorted(twin.files)
    for name, leaf in got.items():
        want = twin[name]
        if isinstance(leaf, torch.Tensor):       # bfloat16
            assert leaf.dtype == torch.bfloat16
            leaf = leaf.view(torch.int16).numpy().view(np.uint16)
        if name == "pose/count":                 # saved as a numpy scalar
            assert leaf == 3 and isinstance(leaf, int)
            continue
        assert leaf_bits(leaf) == leaf_bits(want), name
    multi = got["pose/params/multi"]
    assert multi.shape == (10, 7) and (multi[8:, 4:] == -1.5).all()
    # the store's layout: the root manifest reaches the process layer
    manifest = orbax_store.read_manifest(os.path.join(DATA, "orbax_jax",
                                                      "det"))
    assert manifest["config"]["max_inline_value_bytes"] == 1024


def test_port_reads_many_keys_through_interior_nodes(tmp_path, monkeypatch):
    """5 000 keys (2 500 zarr leaves) written by tensorstore's OCDBT
    key-value store with 4 KiB nodes, then 20 more generations (so the
    manifest lists version-tree nodes): the port reads every key and
    every leaf."""
    rng = np.random.default_rng(3)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 4096}}
                         ).result()
    comp = zstandard.ZstdCompressor(level=1)
    leaves, meta, txn = {}, {}, ts.Transaction()
    for i in range(2500):
        arr = rng.normal(size=int(rng.integers(1, 400))).astype(np.float32)
        name = f"params.layer{i:04d}.kernel"
        leaves[("params", f"layer{i:04d}", "kernel")] = arr
        zarray = {"chunks": [arr.size], "compressor": {"id": "zstd",
                  "level": 1}, "dimension_separator": ".", "dtype": "<f4",
                  "fill_value": None, "filters": None, "order": "C",
                  "shape": [arr.size], "zarr_format": 2}
        kv.with_transaction(txn).write(f"{name}/.zarray",
                                       json.dumps(zarray)).result()
        kv.with_transaction(txn).write(f"{name}/0",
                                       comp.compress(arr.tobytes())).result()
        meta[str(("params", f"layer{i:04d}", "kernel"))] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in
                             ("params", f"layer{i:04d}", "kernel")],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    txn.commit_sync()
    for g in range(20):
        kv.write(f"zz/{g}", b"x" * (g * 100)).result()
    with open(tmp_path / "_METADATA", "w") as fh:
        json.dump({"tree_metadata": meta, "use_ocdbt": True,
                   "use_zarr3": False}, fh)
    want = {k: kv.read(k).result().value for k in kv.list().result()}

    block_tensorstore(monkeypatch)
    manifest = orbax_store.read_manifest(str(tmp_path))
    assert manifest["height"] >= 1 and manifest["generation"] > 16
    assert orbax_store.read_kvstore(str(tmp_path)) == want
    tree = orbax_store.load_tree(str(tmp_path))
    assert_bit_equal(tree, {"params": {k[1]: {"kernel": v}
                                       for k, v in leaves.items()}})


def test_port_writer_splits_nodes_that_tensorstore_reads(tmp_path,
                                                         monkeypatch):
    """The port's B-tree with small nodes (three levels) reads back, in the
    port and in tensorstore, key for key."""
    rng = np.random.default_rng(4)
    items = {f"k{i:05d}/{'x' * (i % 7)}".encode():
             rng.integers(0, 256, int(rng.integers(0, 2000)),
                          dtype=np.uint8).tobytes() for i in range(3000)}
    with pytest.MonkeyPatch.context() as m:
        block_tensorstore(m)
        orbax_store.write_kvstore(str(tmp_path), items,
                                  max_decoded_node_bytes=2048)
        assert orbax_store.read_manifest(str(tmp_path))["height"] == 2
        assert orbax_store.read_kvstore(str(tmp_path)) == items
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}/"}).result()
    assert sorted(kv.list().result()) == sorted(items)
    for k, v in items.items():
        assert kv.read(k).result().value == v


@pytest.mark.parametrize("where", ["manifest", "node", "jax_node"])
def test_a_flipped_byte_raises_a_crc_error(where, tmp_path, monkeypatch):
    if where == "jax_node":
        shutil.copytree(os.path.join(DATA, "orbax_jax"), tmp_path / "c")
    else:
        det, pose = small_trees()
        tw.save_pipeline_checkpoint(str(tmp_path / "c"), det, pose)
    block_tensorstore(monkeypatch)
    slot = str(tmp_path / "c" / "det")
    if where == "manifest":
        path, at = os.path.join(slot, "manifest.ocdbt"), 30
    else:
        (file, _), offset, length = orbax_store.read_manifest(slot)["root"]
        path, at = os.path.join(slot, file), offset + length // 2
    with open(path, "r+b") as fh:
        fh.seek(at)
        b = fh.read(1)
        fh.seek(at)
        fh.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(ValueError, match="CRC32C mismatch"):
        tw.load_pipeline_checkpoint(str(tmp_path / "c"))


def test_the_store_refuses_what_it_does_not_read(tmp_path, monkeypatch):
    block_tensorstore(monkeypatch)
    tw.save_pose_checkpoint(str(tmp_path), small_trees()[1])
    assert_bit_equal(tw.load_pose_checkpoint(str(tmp_path)),
                     small_trees()[1])
    values = orbax_store.read_kvstore(str(tmp_path / "pose"))
    key = b"params.head.bias/.zarray"
    for field, value in (("order", "F"), ("compressor", {"id": "blosc"}),
                         ("dtype", "<c8"), ("filters", [{"id": "delta"}])):
        meta = json.loads(values[key])
        meta[field] = value
        bad = {**values, key: json.dumps(meta).encode()}
        with pytest.raises(ValueError, match=field):
            orbax_store._zarr_array("params.head.bias", bad)


# --------------------------------------------------------------------- #
# zstd


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "random": rng.integers(0, 256, 1 << 18, dtype=np.uint8).tobytes(),
        "constant": b"\x07" * (1 << 20),
        "f32": (rng.normal(size=1 << 18) * 0.05).astype(
            np.float32).tobytes(),
        "text": (b"the quick brown fox jumps over the lazy dog %d\n"
                 * 30000)[:1 << 20],
        "small": b"abc",
    }


@pytest.mark.parametrize("kind", ["random", "constant", "f32", "text",
                                  "small"])
def test_zstd_decoder_matches_zstandard(kind, monkeypatch):
    block_tensorstore(monkeypatch)
    data = _inputs()[kind]
    for level in (-5, 1, 3, 19):
        if level == 19 and len(data) > 1 << 18:
            data = data[:1 << 18]       # level 19 is slow to compress
        for checksum in (False, True):
            for size in (False, True):
                frame = zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum,
                    write_content_size=size).compress(data)
                got = zstd.decompress(frame, None if size else len(data))
                assert got.tobytes() == data, (level, checksum, size)
                if not size:   # the decoder finds the size on its own
                    assert zstd.decompress(frame).tobytes() == data


def test_zstd_frames_in_a_row_and_errors(monkeypatch):
    block_tensorstore(monkeypatch)
    inputs = _inputs()
    comp = zstandard.ZstdCompressor(level=3, write_checksum=True)
    skippable = struct.pack("<II", 0x184D2A50, 3) + b"abc"
    src = comp.compress(inputs["f32"]) + skippable + comp.compress(
        inputs["text"])
    assert zstd.decompress(src).tobytes() == inputs["f32"] + inputs["text"]
    # a changed byte in the content fails the checksum; a short buffer,
    # a dictionary id and a truncated frame raise too
    frame = bytearray(zstandard.ZstdCompressor(
        level=1, write_checksum=True).compress(inputs["text"][:5000]))
    frame[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(frame))
    with pytest.raises(ValueError, match="larger than the buffer"):
        zstd.decompress_into(comp.compress(b"x" * 100),
                             np.empty(50, np.uint8))
    # single segment, dictionary id 5 (one byte), content size 3, one raw
    # block "abc"
    with_dict = struct.pack("<IBBB", zstd.MAGIC, 0x21, 5, 3) + \
        struct.pack("<I", (3 << 3) | 1)[:3] + b"abc"
    with pytest.raises(ValueError, match="dictionaries are not supported"):
        zstd.decompress(with_dict)
    with pytest.raises(ValueError, match="truncated"):
        zstd.decompress(comp.compress(inputs["text"])[:-10], 1 << 20)


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 17) + 1, 3 << 18])
def test_zstd_raw_frames_read_by_zstandard(n, monkeypatch):
    block_tensorstore(monkeypatch)
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    frame = zstd.frame(data)
    assert zstd.content_size(frame) == n
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame).tobytes() == data
