"""The port's TF1 SavedModel reader (`models/tf_graph.py`, through
`tf_bundle.saved_model_variables` and `tf_import.load_saved_model_arrays`)
against TensorFlow and the JAX package's reader, on the CPU. TensorFlow
writes each export here (graph mode); the port then runs with TensorFlow
blocked and must give what `tf.saved_model.load(d).variables` holds, in
order, names, dtypes, shapes and bytes, and the JAX package's dict:

- `simple_save`: resource variables of every dtype the reader takes
  (strings, scalars), a ref variable (left out), a variable under a name
  scope;
- `sharded`: a `Builder` over two devices (two RestoreV2s, two data
  files): variables partitioned in 2 and in 3, an EMA shadow,
  `global_step`, LOCAL variables set by a Const, by `tf.zeros` of a large
  shape (Fill) and by scalar broadcasts (float_val, half_val);
- `main_op`: an explicit main op grouping the local initializers (Cast,
  Reshape, int64 and bool Fills);
- `init_signature`: the init op as the `__saved_model_init_op` signature;
- `name_mapped`: a saver whose checkpoint keys are not the variables'
  names;
- `no_saver`: the `simple_save` export without its SaverDef (TensorFlow's
  default saver);
- `ref_only`: only ref variables, so nothing, and the importers of both
  packages raise the same KeyError;
- TensorProto decoding (the repeat-last rule, half_val, unpacked fields)
  against `tf.make_ndarray`;
- a full-width automl-named Lite0 export imported by the port's
  `cli.import_weights --efficientdet-saved-model` and by the JAX package's
  `import_tf_efficientdet`: the same tree;
- the test writer (`tests/torch_port_tfbundle.write_tf1_saved_model`)
  against `tf.saved_model.load`.

The refusals are `test_tf1_saved_model_is_refused_naming_the_format` in
test_torch_port_tf_bundle.py.
"""

import os

import numpy as np
import pytest

import tensorflow as tf
from tensorflow.core.framework import tensor_pb2
from tensorflow.core.protobuf import saved_model_pb2

from human_body_proportion_estimation_tpu.models import tf_import as jtf
from human_body_proportion_estimation_tpu.models.efficientdet import (
    EFFICIENTDET_LITE0 as J_LITE0,
)
from human_body_proportion_estimation_tpu_torch.models import (
    tf_bundle,
    tf_graph,
    tf_import as ttf,
)
from tests.test_torch_port_tf_bundle import (
    block_tensorflow,
    same,
    tf_saved_model_variables,
)
from tests.torch_port_tfbundle import _field, write_tf1_saved_model

tf1 = tf.compat.v1
LOCAL = [tf1.GraphKeys.LOCAL_VARIABLES]
STRINGS = np.array([b"ab", b"", b"xyz\x00\xff"], dtype=object)


def _simple_save(directory, rng):
    graph = tf1.Graph()
    with graph.as_default():
        values = {
            "net/f32": rng.normal(size=(2, 3)).astype(np.float32),
            "net/f64": rng.normal(size=3),
            "net/f16": rng.normal(size=4).astype(np.float16),
            "net/i32": rng.integers(-9, 9, 5).astype(np.int32),
            "net/i64": np.int64(-2 ** 40),
            "net/i16": rng.integers(-999, 999, 2).astype(np.int16),
            "net/i8": rng.integers(-100, 100, 3).astype(np.int8),
            "net/u8": rng.integers(0, 255, 3).astype(np.uint8),
            "net/flag": np.array([True, False, True]),
            "net/names": STRINGS,
            "net/title": np.array(b"lite4", object),
            "net/scalar": np.float32(2.5),
        }
        for name, val in values.items():
            tf1.get_variable(name, initializer=tf.constant(val))
        tf1.get_variable("net/ref", use_resource=False,
                         initializer=tf.constant([1.0, 2.0]))
        with tf1.name_scope("scope"):
            v = tf1.Variable(rng.normal(size=2).astype(np.float32),
                             name="named", use_resource=True)
        x = tf1.placeholder(tf.float32, [None, 2])
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            tf1.saved_model.simple_save(sess, directory, {"x": x},
                                        {"y": x * v})


def _sharded(directory, rng):
    graph = tf1.Graph()
    with graph.as_default():
        with tf.device("/device:CPU:0"):
            with tf1.variable_scope("net"):
                w = tf1.get_variable("w", initializer=tf.constant(
                    rng.normal(size=(3, 4)).astype(np.float32)))
                p2 = tf1.get_variable(
                    "p2", shape=(7, 3), partitioner=tf1.fixed_size_partitioner(
                        2))
            step = tf1.train.get_or_create_global_step()
        with tf.device("/device:CPU:1"):
            with tf1.variable_scope("head"):
                p3 = tf1.get_variable(
                    "p3", shape=(4, 8), dtype=tf.float64,
                    partitioner=tf1.fixed_size_partitioner(3, axis=1))
            ema = tf1.train.ExponentialMovingAverage(0.5)
            update = ema.apply([w])
        tf1.get_variable("metric/count", initializer=tf.constant(
            [3, -4], tf.int32), collections=LOCAL)
        tf1.get_variable("metric/zeros", initializer=tf.zeros([40, 30]),
                         collections=LOCAL)
        tf1.get_variable("metric/fill", initializer=tf.constant(
            -2.0, shape=[6, 2]), collections=LOCAL)
        tf1.get_variable("metric/half", initializer=tf.constant(
            1.5, tf.float16, shape=[3]), collections=LOCAL)
        config = tf1.ConfigProto(device_count={"CPU": 2})
        with tf1.Session(graph=graph, config=config) as sess:
            sess.run(tf1.global_variables_initializer())
            for p in list(p2) + list(p3):
                sess.run(p.assign(rng.normal(size=p.shape).astype(
                    p.dtype.base_dtype.as_numpy_dtype)))
            sess.run(update)
            sess.run(step.assign(77))
            builder = tf1.saved_model.Builder(directory)
            builder.add_meta_graph_and_variables(sess, ["serve"],
                                                 clear_devices=True)
            builder.save()


def _locals_for_init_op(rng):
    """Local variables whose initial values need Cast, Reshape and Fills;
    returns them."""
    return [
        tf1.get_variable("metric/cast", initializer=tf.reshape(tf.cast(
            tf.constant([1, 2, 3, 4, 5, 6]), tf.float32), [2, 3]),
            collections=LOCAL),
        tf1.get_variable("metric/total", initializer=tf.fill(
            [30, 40], np.int64(9)), collections=LOCAL),
        tf1.get_variable("metric/seen", initializer=tf.fill([3], True),
                         collections=LOCAL),
        tf1.get_variable("metric/ones", initializer=tf.ones_like(
            tf.constant(rng.normal(size=3).astype(np.float32))),
            collections=LOCAL),
    ]


def _main_op(directory, rng, signature=False):
    graph = tf1.Graph()
    with graph.as_default():
        tf1.get_variable("net/w", initializer=tf.constant(
            rng.normal(size=4).astype(np.float32)))
        local = _locals_for_init_op(rng)
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            init = tf1.group(*[v.initializer for v in local],
                             tf1.tables_initializer(), name="main_group")
            if signature:
                from tensorflow.python.saved_model import builder_impl

                builder = builder_impl._SavedModelBuilder(directory)
                builder.add_meta_graph_and_variables(sess, ["serve"],
                                                     init_op=init)
            else:
                builder = tf1.saved_model.Builder(directory)
                builder.add_meta_graph_and_variables(sess, ["serve"],
                                                     main_op=init)
            builder.save()


def _name_mapped(directory, rng):
    graph = tf1.Graph()
    with graph.as_default():
        a = tf1.get_variable("net/a", initializer=tf.constant(
            rng.normal(size=(2, 2)).astype(np.float32)))
        b = tf1.get_variable("net/b", initializer=tf.constant(
            rng.integers(0, 9, 3).astype(np.int64)))
        part = tf1.get_variable("net/part", shape=(5, 2),
                                partitioner=tf1.fixed_size_partitioner(2))
        saver = tf1.train.Saver({"ckpt/first": a, "ckpt/second": b,
                                 "ckpt/part": part})
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            builder = tf1.saved_model.Builder(directory)
            builder.add_meta_graph_and_variables(sess, ["serve"],
                                                 saver=saver)
            builder.save()


def drop_saver_def(directory):
    """Take the SaverDef out of the export at `directory`."""
    path = os.path.join(directory, "saved_model.pb")
    model = saved_model_pb2.SavedModel()
    with open(path, "rb") as fh:
        model.ParseFromString(fh.read())
    model.meta_graphs[0].ClearField("saver_def")
    with open(path, "wb") as fh:
        fh.write(model.SerializeToString())


def _ref_only(directory, rng):
    graph = tf1.Graph()
    with graph.as_default():
        tf1.get_variable("efficientnet-lite0/stem/conv2d/kernel",
                         use_resource=False, initializer=tf.constant(
                             rng.normal(size=(3, 3, 3, 32)).astype(
                                 np.float32)))
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            builder = tf1.saved_model.Builder(directory)
            builder.add_meta_graph_and_variables(sess, ["serve"])
            builder.save()


WRITERS = {"simple_save": _simple_save, "sharded": _sharded,
           "main_op": _main_op,
           "init_signature": lambda d, rng: _main_op(d, rng, signature=True),
           "name_mapped": _name_mapped,
           "no_saver": lambda d, rng: (_simple_save(d, rng),
                                       drop_saver_def(d)),
           "ref_only": _ref_only}


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Each case's directory and what TensorFlow and the JAX package
    read."""
    root = tmp_path_factory.mktemp("tf1_saved_models")
    out = {}
    for i, (case, write) in enumerate(WRITERS.items()):
        directory = str(root / case)
        write(directory, np.random.default_rng(i))
        out[case] = (directory, tf_saved_model_variables(directory),
                     jtf.load_saved_model_arrays(directory))
    return out


EXPECTED = {
    "simple_save": ["net/f32", "net/f64", "net/f16", "net/i32", "net/i64",
                    "net/i16", "net/i8", "net/u8", "net/flag", "net/names",
                    "net/title", "net/scalar", "scope/named"],
    "sharded": ["net/w", "net/p2/part_0", "net/p2/part_1", "global_step",
                "head/p3/part_0", "head/p3/part_1", "head/p3/part_2",
                "net/w/ExponentialMovingAverage", "metric/count",
                "metric/zeros", "metric/fill", "metric/half"],
    "main_op": ["net/w", "metric/cast", "metric/total", "metric/seen",
                "metric/ones"],
    "name_mapped": ["net/a", "net/b", "net/part/part_0", "net/part/part_1"],
    "ref_only": [],
}
EXPECTED["init_signature"] = EXPECTED["main_op"]
EXPECTED["no_saver"] = EXPECTED["simple_save"]


@pytest.mark.parametrize("case", list(WRITERS))
def test_reader_matches_tensorflow_and_jax(exports, case, monkeypatch):
    directory, tf_ref, jax_ref = exports[case]
    assert [k for k, _ in tf_ref] == EXPECTED[case]
    block_tensorflow(monkeypatch)
    got = tf_bundle.saved_model_variables(directory)
    assert [k for k, _ in got] == [k for k, _ in tf_ref]
    assert [k for (k, v), (_, w) in zip(got, tf_ref) if not same(v, w)] == []
    arrays = ttf.load_saved_model_arrays(directory)
    assert list(arrays) == list(jax_ref)
    assert [k for k in jax_ref if not same(arrays[k], jax_ref[k])] == []
    if case == "sharded":
        files = os.listdir(os.path.join(directory, "variables"))
        assert sum(".data-" in f and f.endswith("-of-00002")
                   for f in files) == 2
        pb, meta = tf_bundle.meta_graph(directory)
        graph = tf_graph.read_graph(meta[2][0], pb)
        assert sum(n.op == "RestoreV2" for n in graph.values()) == 2


def test_ref_only_export_imports_nothing_in_either_package(exports,
                                                           monkeypatch):
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (  # noqa: E501
        EFFICIENTDET_LITE0,
        EfficientDet,
    )
    from tests.test_torch_port_importers import _random_tree

    directory, _, jax_ref = exports["ref_only"]
    tree = _random_tree(EfficientDet(EFFICIENTDET_LITE0), 1)
    with pytest.raises(KeyError) as want:
        jtf.import_tf_efficientdet(jax_ref, tree, J_LITE0)
    block_tensorflow(monkeypatch)
    arrays = ttf.load_saved_model_arrays(directory)
    assert arrays == {} == jax_ref
    with pytest.raises(KeyError) as got:
        ttf.import_tf_efficientdet(arrays, tree, EFFICIENTDET_LITE0)
    assert str(got.value) == str(want.value)


def _unpacked(dtype: int, dims, field: int, values, wire: int) -> bytes:
    """A TensorProto whose repeated field `field` is written one value a
    tag (not packed), each as a varint (wire 0) or fixed32 (wire 5)."""
    import struct

    shape = b"".join(_field(2, _field(1, d)) for d in dims)
    out = _field(1, dtype) + _field(2, shape)
    for v in values:
        if wire == 5:
            out += bytes([field << 3 | 5]) + struct.pack("<f", v)
        else:
            out += _field(field, int(v) & (2 ** 64 - 1))
    return out


def test_tensor_proto_matches_make_ndarray():
    made = [
        tf.make_tensor_proto(1.5, tf.float32, [6, 2]),
        tf.make_tensor_proto(np.float16(-0.25), tf.float16, [3]),
        tf.make_tensor_proto(np.arange(5, dtype=np.float16)),
        tf.make_tensor_proto(np.array([1.0, 2.0]), tf.float64, [2]),
        tf.make_tensor_proto(7, tf.int64, [2, 2]),
        tf.make_tensor_proto(-3, tf.int8, [4]),
        tf.make_tensor_proto(True, tf.bool, [3]),
        tf.make_tensor_proto([b"a", b"bc"], tf.string),
        tf.make_tensor_proto(b"x", tf.string, [2]),
        tf.make_tensor_proto(np.arange(6, dtype=np.int32).reshape(2, 3)),
        tf.make_tensor_proto(np.zeros((0, 3), np.float32)),
    ]
    int_val = tensor_pb2.TensorProto(dtype=tf.int32.as_datatype_enum)
    int_val.tensor_shape.dim.add(size=5)
    int_val.int_val.extend([1, -2])                 # repeat the last
    empty = tensor_pb2.TensorProto(dtype=tf.float32.as_datatype_enum)
    empty.tensor_shape.dim.add(size=3)              # no values: zeros
    half = tensor_pb2.TensorProto(dtype=tf.float16.as_datatype_enum)
    half.tensor_shape.dim.add(size=4)
    half.half_val.extend([np.float16(-1.5).view(np.uint16).item(),
                          np.float16(6e-5).view(np.uint16).item()])
    protos = [p.SerializeToString() for p in made + [int_val, empty, half]]
    for raw in protos:
        want = tf.make_ndarray(tensor_pb2.TensorProto.FromString(raw))
        got = tf_graph.tensor_proto(raw, "test")
        assert same(got, np.asarray(want)), (got, want)
    # the same values written unpacked, one tag a value
    for raw, want in [
            (_unpacked(1, [4], 5, [0.5, -2.0], 5), [0.5, -2.0, -2.0, -2.0]),
            (_unpacked(3, [3], 7, [-7, 8], 0), [-7, 8, 8]),
            (_unpacked(9, [2], 10, [-2 ** 40], 0), [-2 ** 40] * 2),
            (_unpacked(19, [2], 13, [0x3C00], 0), [1.0, 1.0])]:
        got = tf_graph.tensor_proto(raw, "test")
        ref = tf.make_ndarray(tensor_pb2.TensorProto.FromString(raw))
        assert same(got, ref) and got.tolist() == want
    bf16 = tf.make_tensor_proto(1.0, tf.bfloat16, [2]).SerializeToString()
    with pytest.raises(ValueError, match="TensorFlow dtype 14"):
        tf_graph.tensor_proto(bf16, "test")


def _lite0_export(directory, arrays):
    """`arrays` (automl names) as a TF1 SavedModel of resource variables,
    every 16th with an ExponentialMovingAverage shadow, and a
    global_step."""
    graph = tf1.Graph()
    with graph.as_default():
        made = [tf1.get_variable(name, initializer=tf.constant(value))
                for name, value in arrays.items()]
        update = tf1.train.ExponentialMovingAverage(0.9).apply(made[::16])
        step = tf1.train.get_or_create_global_step()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            sess.run([update, step.assign(300000)])
            builder = tf1.saved_model.Builder(directory)
            builder.add_meta_graph_and_variables(sess, ["serve"])
            builder.save()


def test_lite0_export_imports_as_in_jax(tmp_path, monkeypatch):
    """A full-width automl-named Lite0 export: the port's CLI writes the
    tree JAX's `import_tf_efficientdet` gives."""
    from human_body_proportion_estimation_tpu.models import weights as jw
    from human_body_proportion_estimation_tpu_torch.cli import (
        import_weights as tcli,
    )
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (  # noqa: E501
        EFFICIENTDET_LITE0,
        EfficientDet,
    )
    from tests.test_torch_port_importers import (
        _random_tree,
        assert_trees_equal,
    )

    tree = _random_tree(EfficientDet(EFFICIENTDET_LITE0), 3)
    arrays = ttf.export_tf_efficientdet(tree, EFFICIENTDET_LITE0)
    directory = str(tmp_path / "lite0")
    _lite0_export(directory, arrays)
    jax_arrays = jtf.load_saved_model_arrays(directory)
    want = jtf.import_tf_efficientdet(jax_arrays, tree,
                                      J_LITE0)
    assert len(jax_arrays) == len(arrays) + (len(arrays) + 15) // 16 + 1
    block_tensorflow(monkeypatch)
    out = tmp_path / "ckpt"
    tcli.main(["--efficientdet-saved-model", directory,
               "--efficientdet-variant", "lite0", "--out", str(out)])
    det_vars, _ = jw.load_pipeline_checkpoint(str(out))
    assert_trees_equal(det_vars, want)
    assert_trees_equal(det_vars, tree)


def test_writer_against_tensorflow(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    tensors = {f"efficientnet-lite0/blocks_{i}/conv2d/kernel":
               rng.normal(size=(1, 1, 4, i + 1)).astype(np.float32)
               for i in range(40)}
    tensors.update({"global_step": np.int64(300000),
                    "f64": rng.normal(size=3),
                    "f16": rng.normal(size=4).astype(np.float16),
                    "i32": np.int32(-3), "flag": np.array([True, False]),
                    "u8": np.arange(5, dtype=np.uint8)})
    local = {"eval/count": ((50, 30), np.float32(0.5)),
             "eval/n": ((), np.int64(-4))}
    directory = write_tf1_saved_model(str(tmp_path / "w"), tensors, local,
                                      shards=2)
    ref = tf_saved_model_variables(directory)
    names = sorted(tensors, key=str.encode) + list(local)
    assert [k for k, _ in ref] == names
    for name, value in ref[:len(tensors)]:
        assert same(value, tensors[name]), name
    assert same(ref[-2][1], np.full((50, 30), 0.5, np.float32))
    assert same(ref[-1][1], np.int64(-4))
    block_tensorflow(monkeypatch)
    got = tf_bundle.saved_model_variables(directory)
    assert [k for k, _ in got] == names
    assert [k for (k, v), (_, w) in zip(got, ref) if not same(v, w)] == []
