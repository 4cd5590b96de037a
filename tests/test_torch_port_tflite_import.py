"""The port's tflite reader (`models/tflite_import.py`, struct + numpy over
the schema, no TensorFlow) against the JAX package's, which parses the
file with `tf.lite.Interpreter`:

- a tflite written with TensorFlow's own schema (`schema_py_generated` +
  `flatbuffers`) carrying the real blob's 94 weight and bias tensor names
  (`_name_map`: 47 convs) and `anchors`, uint8 weights and anchors with
  non-zero zero points, int32 biases, and a float tensor: JAX's
  `load_ssd_weights` and the port's give bit-equal arrays, leaf for leaf;
- the plain-`struct` writer of tests/torch_port_tflite.py (what
  chip_smoke.py writes on the card, where there is no TensorFlow) makes
  a file the interpreter reads as it was written: names, shapes, dtypes,
  data and (scale, zero_point);
- an absent path raises the JAX package's error, naming the path.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
flatbuffers = pytest.importorskip("flatbuffers")

from human_body_proportion_estimation_tpu.models import (  # noqa: E402
    tflite_import as jtfl,
)
from human_body_proportion_estimation_tpu_torch.models import (  # noqa: E402
    tflite_import as ttfl,
)
from tests.torch_port_tflite import (  # noqa: E402
    ssd_tensors,
    write_tflite,
)


def _tf_schema_tflite(path, tensors):
    """Write `tensors` [(name, array, (scale, zero_point) or None)] with
    TensorFlow's schema objects: one subgraph, no operators; a tensor
    without data points at buffer 0."""
    from tensorflow.lite.python import schema_py_generated as s

    types = {np.dtype(np.uint8): s.TensorType.UINT8,
             np.dtype(np.int32): s.TensorType.INT32,
             np.dtype(np.float32): s.TensorType.FLOAT32}
    model = s.ModelT()
    model.version = 3
    model.buffers = [s.BufferT()]
    sub = s.SubGraphT()
    sub.tensors, sub.inputs, sub.outputs, sub.operators = [], [], [], []
    for name, arr, quant in tensors:
        t = s.TensorT()
        t.name, t.shape, t.type = name, list(arr.shape), types[arr.dtype]
        if arr.size:
            buf = s.BufferT()
            buf.data = np.frombuffer(arr.tobytes(), np.uint8)
            model.buffers.append(buf)
            t.buffer = len(model.buffers) - 1
        else:
            t.buffer = 0
        if quant is not None:
            q = s.QuantizationParametersT()
            q.scale, q.zeroPoint = [quant[0]], [quant[1]]
            t.quantization = q
        sub.tensors.append(t)
    model.subgraphs = [sub]
    builder = flatbuffers.Builder(1 << 20)
    builder.Finish(model.Pack(builder), file_identifier=b"TFL3")
    with open(path, "wb") as fh:
        fh.write(builder.Output())
    return path


def _seeded_params():
    """A flax SSD tree of random numbers, the real blob's shapes."""
    from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (  # noqa: E501
        SSDMobileNetV1,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        state_dict_to_flax,
    )

    rng = np.random.default_rng(3)
    state = {k: v.new_tensor(rng.normal(0, 0.3, tuple(v.shape)))
             for k, v in SSDMobileNetV1().state_dict().items()}
    return state_dict_to_flax(state)["params"]


def test_reader_equals_the_interpreter_on_a_tf_schema_file(tmp_path):
    from tests.torch_port_ssd import ssd_anchors

    tensors = ssd_tensors(_seeded_params(), ssd_anchors())
    names = [t[0] for t in tensors]
    assert len(set(names)) == 95 and len(ttfl._name_map()) == 47
    assert {t[1].dtype for t in tensors} == {np.dtype(np.uint8),
                                             np.dtype(np.int32)}
    assert any(q[1] not in (0, 128) for _, a, q in tensors
               if a.dtype == np.uint8)
    path = _tf_schema_tflite(str(tmp_path / "ssd.tflite"), tensors + [
        ("unquantized", np.arange(6, dtype=np.float32).reshape(2, 3), None),
        ("no_data", np.zeros((0,), np.float32), None)])
    ref_vars, ref_anchors = jtfl.load_ssd_weights(path)
    got_vars, got_anchors = ttfl.load_ssd_weights(path)
    assert got_anchors.dtype == np.float32
    np.testing.assert_array_equal(got_anchors, ref_anchors)
    ref_leaves = dict(_leaves(ref_vars))
    got_leaves = dict(_leaves(got_vars))
    assert sorted(got_leaves) == sorted(ref_leaves)
    assert len(got_leaves) == 94
    for key, ref in ref_leaves.items():
        got = got_leaves[key]
        assert got.dtype == ref.dtype == np.float32 and \
            got.shape == ref.shape, key
        np.testing.assert_array_equal(got, ref, err_msg=key)
    raw = ttfl.read_tflite_tensors(path)
    np.testing.assert_array_equal(raw["unquantized"]["data"],
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    assert raw["unquantized"]["quantization"] == (0.0, 0)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_struct_writer_reads_back_through_the_interpreter(tmp_path):
    rng = np.random.default_rng(4)
    tensors = [
        ("w", rng.integers(0, 256, (4, 3, 3, 2)).astype(np.uint8),
         (0.0123, 117)),
        ("b", rng.integers(-1000, 1000, (4,)).astype(np.int32),
         (0.0005, 0)),
        ("f", rng.random((5,)).astype(np.float32), None),
        ("anchors", rng.integers(0, 256, (1917, 4)).astype(np.uint8),
         (0.00645, 3)),
    ]
    path = write_tflite(str(tmp_path / "t.tflite"), tensors)
    it = tf.lite.Interpreter(model_path=path)
    it.allocate_tensors()
    details = {d["name"]: d for d in it.get_tensor_details()}
    assert sorted(details) == sorted(t[0] for t in tensors)
    got = ttfl.read_tflite_tensors(path)
    for name, arr, quant in tensors:
        d = details[name]
        data = it.get_tensor(d["index"])
        assert data.dtype == arr.dtype and data.shape == arr.shape, name
        np.testing.assert_array_equal(data, arr)
        np.testing.assert_array_equal(got[name]["data"], arr)
        want = (float(np.float32(quant[0])), quant[1]) if quant else (0.0, 0)
        assert tuple(d["quantization"]) == got[name]["quantization"] == want


def test_absent_path_raises_naming_it(tmp_path):
    path = str(tmp_path / "missing" / "ssd.tflite")
    with pytest.raises(ValueError) as ref:
        jtfl.load_ssd_weights(path)
    with pytest.raises(ValueError) as got:
        ttfl.load_ssd_weights(path)
    assert str(got.value) == str(ref.value) and path in str(got.value)
    assert ttfl.DEFAULT_TFLITE_PATH == jtfl.DEFAULT_TFLITE_PATH
