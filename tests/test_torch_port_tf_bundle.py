"""The port's TensorBundle reader (`models/tf_bundle.py`), its TF readers
(`models/tf_import.py`) and its C++ CRC32C (`utils/crc32c.cpp`) against
TensorFlow and the JAX package's readers, on the CPU. The inputs are
written by TensorFlow here; the port then runs with TensorFlow blocked.

- a TF1 checkpoint (EMA shadows, a Momentum slot, an int64 global_step,
  every numeric dtype read, strings, a partitioned variable), read by its
  directory and by its prefix; a TF2 object-based checkpoint sharded by
  `MaxShardSizePolicy` (tensors sliced across its data files); a
  SavedModel whose root's `variables` leaves one variable out: every
  tensor equal to `tf.train.load_checkpoint`'s, and the readers' dicts to
  the JAX package's, bit for bit;
- the committed fixtures (tests/data/torch_port/tf_bundles/) against their
  twins;
- refusals: a flipped data byte, a flipped block byte, compression,
  a slice that is absent, a big-endian header, an unknown dtype, absent
  paths; TF1 SavedModels that are not read (a local variable with a
  random initializer, several MetaGraphs, a global variable the saver
  does not restore, a partitioned variable without a SaverDef; the TF1
  SavedModels that are read: test_torch_port_tf1_saved_model.py);
- the CRC32C against a Python table and TensorFlow's stored values;
- the test writer (tests/torch_port_tfbundle.py) against TensorFlow.
"""

import os
import shutil
import struct
import sys

import numpy as np
import pytest

import tensorflow as tf

from human_body_proportion_estimation_tpu.models import tf_import as jtf
from human_body_proportion_estimation_tpu_torch.models import (
    tf_bundle,
    tf_import as ttf,
)
from human_body_proportion_estimation_tpu_torch.utils.crc32c import crc32c
from tests import torch_port_tf_fixture as fixture
from tests.torch_port_tfbundle import (
    entry_proto,
    table_bytes,
    write_checkpoint,
)

STRINGS = np.array([b"ab", b"", b"xyz\x00\xff"], dtype=object)


def block_tensorflow(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def same(got, want) -> bool:
    """The same type, dtype, shape and contents, as TensorFlow's reader
    returns them (arrays, numpy scalars, bytes)."""
    if type(got) is not type(want):
        return False
    if isinstance(want, bytes):
        return got == want
    got, want = np.asarray(got), np.asarray(want)
    if (got.dtype, got.shape) != (want.dtype, want.shape):
        return False
    if want.dtype == object:
        return got.tolist() == want.tolist()
    return got.tobytes() == want.tobytes()


def tf_saved_model_variables(directory):
    return [(v.name.split(":")[0], v.numpy())
            for v in tf.saved_model.load(directory).variables]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each case's path and what TensorFlow and the JAX package read."""
    root = tmp_path_factory.mktemp("tf_bundles")
    tf1 = fixture.write_tf1(str(root / "tf1"), seed=3,
                            extra={"net/names": STRINGS,
                                   "net/title": np.array(b"lite4")})
    tf2 = fixture.write_tf2_sharded(str(root / "tf2"), seed=4)
    sm = fixture.write_saved_model(str(root / "sm"), seed=5)
    cases = {"tf1_dir": str(root / "tf1"), "tf1_prefix": tf1,
             "tf2_sharded": tf2, "saved_model": sm}
    refs = {}
    for case, path in cases.items():
        if case == "saved_model":
            refs[case] = (tf_saved_model_variables(path),
                          jtf.load_saved_model_arrays(path))
        else:
            refs[case] = (fixture.tf_reader_tensors(path),
                          jtf.load_tf_checkpoint_arrays(path))
    return cases, refs


@pytest.mark.parametrize("case", ["tf1_dir", "tf1_prefix", "tf2_sharded",
                                  "saved_model"])
def test_reader_matches_tensorflow_and_jax(written, case, monkeypatch):
    cases, refs = written
    path, (tf_ref, jax_ref) = cases[case], refs[case]
    block_tensorflow(monkeypatch)
    if case == "saved_model":
        got = ttf.load_saved_model_arrays(path)
        assert list(got) == [k for k, _ in tf_ref] == ["net/b", "net/a"]
        assert all(same(got[k], v) for k, v in tf_ref)
        assert list(got) == list(jax_ref)
    else:
        bundle = tf_bundle.open_checkpoint(path)
        tensors = bundle.read()
        assert sorted(tensors) == sorted(tf_ref)
        assert [k for k in tensors if not same(tensors[k], tf_ref[k])] == []
        got = ttf.load_tf_checkpoint_arrays(path)
        if case.startswith("tf1"):
            assert got["net/conv/kernel"].tobytes() == tf_ref[
                "net/conv/kernel/ExponentialMovingAverage"].tobytes()
            assert bundle.entries["net/part"].slices
            assert "global_step" not in got and "net/names" in got
        else:
            assert len({e.shard for e in bundle.entries.values()}) >= 2
            assert any(e.slices for e in bundle.entries.values())
    assert sorted(got) == sorted(jax_ref)
    assert [k for k in jax_ref if not same(got[k], jax_ref[k])] == []


def test_committed_fixtures_match_their_twins(monkeypatch):
    for case, where in fixture.CASES.items():
        if case in fixture.SAVED_MODELS:
            continue
        twin = np.load(os.path.join(fixture.FIXTURES, f"{case}.npz"))
        for k, v in fixture.tf_reader_tensors(
                os.path.join(fixture.FIXTURES, where)).items():
            assert np.asarray(v).tobytes() == twin[f"tensor/{k}"].tobytes()
    block_tensorflow(monkeypatch)
    assert fixture.check_fixtures() == {"tf1": 26, "tf2_sharded": 10,
                                        "saved_model": 2,
                                        "tf1_saved_model": 6}


def _copy_tf1(tmp_path):
    shutil.copytree(os.path.join(fixture.FIXTURES, "tf1"), tmp_path / "c")
    bundle = tf_bundle.open_checkpoint(str(tmp_path / "c"))
    return bundle.prefix, tf_bundle.read_table(bundle.index)


def _rewrite_index(prefix, rows):
    with open(prefix + ".index", "wb") as fh:
        fh.write(table_bytes(rows))


def _flip(path, at):
    with open(path, "r+b") as fh:
        fh.seek(at)
        b = fh.read(1)[0]
        fh.seek(at)
        fh.write(bytes([b ^ 0x10]))


def _break(kind, tmp_path):
    """Break a copy of the TF1 fixture as `kind` says; returns (what to
    call, the exception, a pattern its message matches)."""
    prefix, rows = _copy_tf1(tmp_path)
    read = lambda: tf_bundle.open_checkpoint(prefix).read()  # noqa: E731
    if kind == "data_byte":
        ent = tf_bundle.TensorBundle(prefix).entries["net/count"]
        _flip(f"{prefix}.data-00000-of-00001", ent.offset + 2)
        return read, ValueError, "CRC32C mismatch in 'net/count'"
    if kind == "block_byte":
        _flip(prefix + ".index", 7)
        return read, ValueError, r"\.index: CRC32C mismatch in the block at 0"
    if kind == "compression":
        data = bytearray(open(prefix + ".index", "rb").read())
        footer = bytes(data[-48:])
        _, at = tf_bundle._varint(footer, 0, "")   # skip the metaindex
        _, at = tf_bundle._varint(footer, at, "")
        index = tf_bundle._block(bytes(data), footer[at:40], "")
        handle = next(tf_bundle._block_entries(index, ""))[1]
        start, at = tf_bundle._varint(handle, 0, "")
        end = start + tf_bundle._varint(handle, at, "")[0]
        assert start == 0
        data[end] = 1
        data[end + 1:end + 5] = struct.pack(
            "<I", tf_bundle.mask(crc32c(bytes(data[:end + 1]))))
        open(prefix + ".index", "wb").write(bytes(data))
        return read, ValueError, r"\.index: the block at 0 has compression " \
                                 "type 1"
    if kind == "absent_slice":
        keys = [k for k, _ in rows if k.startswith(b"\0")]
        _rewrite_index(prefix, [r for r in rows if r[0] != keys[-1]])
        return read, ValueError, r"'net/part' lists the slice \(\(75, 75\)"
    if kind == "big_endian":
        _rewrite_index(prefix, [(b"", rows[0][1] + b"\x10\x01")] + rows[1:])
        return read, ValueError, "a big-endian bundle"
    if kind == "dtype":
        rows = rows + [(b"zz", entry_proto(14, (2,), 0, 0, 4, 0))]
        _rewrite_index(prefix, rows)
        return read, ValueError, "'zz' has TensorFlow dtype 14"
    if kind == "absent_prefix":
        return (lambda: ttf.load_tf_checkpoint_arrays(prefix + "-9"),
                FileNotFoundError, "no TF checkpoint matches .*-9")
    if kind == "absent_state":
        os.remove(tmp_path / "c" / "checkpoint")
        return (lambda: ttf.load_tf_checkpoint_arrays(str(tmp_path / "c")),
                FileNotFoundError, "no 'checkpoint' file in the directory")
    if kind == "stale_state":
        os.remove(prefix + ".index")
        return (lambda: ttf.load_tf_checkpoint_arrays(str(tmp_path / "c")),
                FileNotFoundError, "names the checkpoint .*model.ckpt-1234")
    if kind == "absent_saved_model":
        return (lambda: ttf.load_saved_model_arrays(str(tmp_path / "c")),
                FileNotFoundError, "no saved_model.pb")
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [
    "data_byte", "block_byte", "compression", "absent_slice", "big_endian",
    "dtype", "absent_prefix", "absent_state", "stale_state",
    "absent_saved_model"])
def test_refusals_name_what_is_wrong(kind, tmp_path, monkeypatch):
    call, error, pattern = _break(kind, tmp_path)
    block_tensorflow(monkeypatch)
    with pytest.raises(error, match=pattern):
        call()


def _tf1_export(directory, kind):
    """A TF1 SavedModel that the port refuses, as `kind` says; returns a
    pattern the refusal's message matches."""
    tf1 = tf.compat.v1
    graph = tf1.Graph()
    with graph.as_default():
        a = tf1.get_variable("net/a", initializer=tf.constant([1.0, 2.0]))
        if kind == "random_local":
            tf1.get_variable("metric/r", shape=(3,),
                             initializer=tf1.random_uniform_initializer(),
                             collections=[tf1.GraphKeys.LOCAL_VARIABLES])
        if kind in ("unrestored", "no_saver_partitioned"):
            tf1.get_variable("net/b", initializer=tf.constant([3.0]))
        if kind == "no_saver_partitioned":
            tf1.get_variable("net/p", shape=(4, 2),
                             partitioner=tf1.fixed_size_partitioner(2))
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            builder = tf1.saved_model.Builder(directory)
            saver = (tf1.train.Saver([a]) if kind == "unrestored" else None)
            builder.add_meta_graph_and_variables(sess, ["serve"],
                                                 saver=saver)
            if kind == "several_metagraphs":
                builder.add_meta_graph(["eval"])
            builder.save()
    if kind == "no_saver_partitioned":
        from tests.test_torch_port_tf1_saved_model import drop_saver_def

        drop_saver_def(directory)
    return {"random_local": "'metric/r' is computed by .* "
                            "'metric/r/Initializer/random_uniform'",
            "several_metagraphs": "2 MetaGraphs",
            "unrestored": "the global variable 'net/b' has no value: the "
                          "saver does not restore it",
            "no_saver_partitioned": "the partitioned variable "
                                    "'net/p/part_0' is not read"}[kind]


@pytest.mark.parametrize("kind", ["random_local", "several_metagraphs",
                                  "unrestored", "no_saver_partitioned"])
def test_tf1_saved_model_is_refused_naming_the_format(kind, tmp_path,
                                                      monkeypatch):
    directory = str(tmp_path / "v1")
    pattern = _tf1_export(directory, kind)
    if kind == "random_local":
        # TensorFlow runs the draw; the port does not imitate it
        assert [k for k, _ in tf_saved_model_variables(directory)] == [
            "net/a", "metric/r"]
    elif kind == "unrestored":
        # TensorFlow leaves net/b uninitialized: it reads as an empty array
        got = dict(tf_saved_model_variables(directory))
        assert got["net/b"].shape == (0,) and got["net/a"].shape == (2,)
    else:
        with pytest.raises((ValueError, TypeError, tf.errors.OpError)):
            tf_saved_model_variables(directory)
    block_tensorflow(monkeypatch)
    with pytest.raises(ValueError, match=pattern):
        ttf.load_saved_model_arrays(directory)


def _crc_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


def test_crc32c_against_a_python_table_and_tensorflow():
    table = _crc_table()

    def reference(data, crc=0):
        crc ^= 0xFFFFFFFF
        for b in data:
            crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF

    rng = np.random.default_rng(0)
    lengths = list(range(17)) + [4099] + rng.integers(0, 4100, 60).tolist()
    for n in lengths:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c(data) == reference(data), n
        cut = n // 3
        assert crc32c(data[cut:], crc32c(data[:cut])) == crc32c(data), n
        assert crc32c(np.frombuffer(data, np.uint8)) == crc32c(data)
    assert crc32c(b"123456789") == 0xE3069283
    with pytest.raises(ValueError, match="contiguous"):
        crc32c(np.zeros(8, np.uint8)[::2])
    # the masked values TensorFlow stored for each tensor of a checkpoint
    bundle = tf_bundle.open_checkpoint(os.path.join(fixture.FIXTURES, "tf1"))
    with open(bundle.shard_path(0), "rb") as fh:
        data = fh.read()
    stored = [e for e in bundle.entries.values() if not e.slices]
    assert len(stored) == 14
    for e in stored:
        assert tf_bundle.mask(crc32c(data[e.offset:e.offset + e.size])) \
            == e.crc


def test_writer_against_tensorflow(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    tensors = {f"efficientnet-lite0/blocks_{i}/conv2d/kernel":
               rng.normal(size=(1, 1, 8, i + 1)).astype(np.float32)
               for i in range(300)}
    tensors.update({
        "global_step": np.int64(99), "f64": rng.normal(size=3),
        "f16": rng.normal(size=4).astype(np.float16),
        "i32": np.int32(-3), "u8": np.arange(5, dtype=np.uint8),
        "i8": np.arange(-2, 2, dtype=np.int8),
        "i16": np.arange(3, dtype=np.int16), "b": np.array([True, False]),
        "empty": np.zeros((2, 0), np.float32)})
    prefix = write_checkpoint(str(tmp_path / "w" / "model.ckpt-7"), tensors,
                              shards=2)
    assert os.path.getsize(prefix + ".index") > 2 * 4096  # several blocks
    reader = tf.train.load_checkpoint(str(tmp_path / "w"))
    assert sorted(reader.get_variable_to_shape_map()) == sorted(tensors)
    for name, value in tensors.items():
        assert same(reader.get_tensor(name), value[()] if np.ndim(value)
                    == 0 else value), name
    block_tensorflow(monkeypatch)
    bundle = tf_bundle.open_checkpoint(str(tmp_path / "w"))
    assert {e.shard for e in bundle.entries.values()} == {0, 1}
    got = bundle.read()
    assert [k for k, v in tensors.items() if not same(
        np.asarray(got[k]), np.asarray(v))] == []
