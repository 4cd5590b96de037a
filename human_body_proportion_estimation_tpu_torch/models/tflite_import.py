"""Dequantize the reference's checked-in ssd.tflite into the port's SSD (port
of the JAX package's `models/tflite_import.py`).

The reference's only pretrained weights are the 4.2 MB quantized
`modules/mnetv1_sdd_tflite/ssd.tflite` (`modules/human_detector.py:10`).
The JAX package reads that flatbuffer with `tf.lite.Interpreter`, used
only as a file parser. The port reads the flatbuffer itself, with `struct`
and numpy over the tflite schema (TensorFlow is not needed, and the card's
machine has none): `Model.buffers` and the tensors of `subgraphs[0]`,
each with its name, shape, type, buffer index and per-tensor
quantization (scale, zero_point). Every conv weight and bias is
dequantized ((q - zero_point) * scale, in f32 as the JAX package does)
and laid into the flax tree of `SSDMobileNetV1`, with the 1917-anchor
table that the TFLite_Detection_PostProcess op consumes.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

DEFAULT_TFLITE_PATH = (
    "/root/reference/human_body_length_est/modules/mnetv1_sdd_tflite/"
    "ssd.tflite"
)

_PREFIX = "FeatureExtractor/MobilenetV1/"
# the SSD extra layers' ids in the blob's names
_EXTRA_IDS = (2, 3, 4, 5)

# tflite TensorType -> numpy dtype (schema.fbs), the types of weights
_TFLITE_DTYPES = {0: np.float32, 2: np.int32, 3: np.uint8, 4: np.int64,
                  9: np.int8}


def _name_map() -> Dict[str, Tuple[str, str]]:
    """The port's (= flax's) module name -> (weights tensor name, bias
    tensor name) in the blob."""
    m = {
        "conv0": (
            _PREFIX + "MobilenetV1/Conv2d_0/weights_quant/FakeQuantWithMinMaxVars",
            _PREFIX + "MobilenetV1/Conv2d_0/Conv2D_Fold_bias",
        ),
    }
    for i in range(1, 14):
        m[f"dw{i}"] = (
            _PREFIX + f"MobilenetV1/Conv2d_{i}_depthwise/weights_quant/"
                      "FakeQuantWithMinMaxVars",
            _PREFIX + f"MobilenetV1/Conv2d_{i}_depthwise/depthwise_Fold_bias",
        )
        m[f"pw{i}"] = (
            _PREFIX + f"MobilenetV1/Conv2d_{i}_pointwise/weights_quant/"
                      "FakeQuantWithMinMaxVars",
            _PREFIX + f"MobilenetV1/Conv2d_{i}_pointwise/Conv2D_Fold_bias",
        )
    # extra SSD layers: names carry their output channel count
    extra_ch = {2: (192, 384), 3: (96, 192), 4: (96, 192), 5: (48, 96)}
    for j in _EXTRA_IDS:
        c1, c3 = extra_ch[j]
        m[f"extra{j}_1x1"] = (
            _PREFIX + f"Conv2d_13_pointwise_1_Conv2d_{j}_1x1_{c1}/"
                      "weights_quant/FakeQuantWithMinMaxVars",
            _PREFIX + f"Conv2d_13_pointwise_1_Conv2d_{j}_1x1_{c1}/"
                      "Conv2D_Fold_bias",
        )
        m[f"extra{j}_3x3"] = (
            _PREFIX + f"Conv2d_13_pointwise_2_Conv2d_{j}_3x3_s2_{c3}/"
                      "weights_quant/FakeQuantWithMinMaxVars",
            _PREFIX + f"Conv2d_13_pointwise_2_Conv2d_{j}_3x3_s2_{c3}/"
                      "Conv2D_Fold_bias",
        )
    for li in range(6):
        m[f"box{li}"] = (
            f"BoxPredictor_{li}/BoxEncodingPredictor/weights_quant/"
            "FakeQuantWithMinMaxVars",
            f"BoxPredictor_{li}/BoxEncodingPredictor/Conv2D_bias",
        )
        m[f"cls{li}"] = (
            f"BoxPredictor_{li}/ClassPredictor/weights_quant/"
            "FakeQuantWithMinMaxVars",
            f"BoxPredictor_{li}/ClassPredictor/Conv2D_bias",
        )
    return m


def _dequant(tensor: np.ndarray, scale: float, zero_point: int) -> np.ndarray:
    if tensor.dtype in (np.uint8, np.int8, np.int32):
        return (tensor.astype(np.float32) - zero_point) * scale
    return tensor.astype(np.float32)


def _to_hwio(w: np.ndarray, depthwise: bool) -> np.ndarray:
    """tflite conv weights -> flax HWIO.

    tflite layout: conv [O, H, W, I]; depthwise [1, H, W, C], which flax's
    grouped conv (feature_group_count=C) holds as HWIO [H, W, 1, C].
    """
    if depthwise:
        return np.transpose(w, (1, 2, 0, 3))
    return np.transpose(w, (1, 2, 3, 0))


# --------------------------------------------------------------------- #
# the flatbuffer reader


class _Table:
    """One flatbuffer table of `buf` at byte `pos`: field i is read through
    the vtable, absent fields give None."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        vt_size = struct.unpack_from("<H", buf, vt)[0]
        self.slots = struct.unpack_from(f"<{(vt_size - 4) // 2}H", buf,
                                        vt + 4)

    def _field(self, i: int):
        off = self.slots[i] if i < len(self.slots) else 0
        return self.pos + off if off else None

    def scalar(self, i: int, fmt: str, default=0):
        at = self._field(i)
        return default if at is None else struct.unpack_from(
            "<" + fmt, self.buf, at)[0]

    def _target(self, i: int):
        at = self._field(i)
        return None if at is None else at + struct.unpack_from(
            "<I", self.buf, at)[0]

    def table(self, i: int):
        at = self._target(i)
        return None if at is None else _Table(self.buf, at)

    def vector(self, i: int, dtype) -> np.ndarray:
        """A vector of scalars (empty when absent)."""
        at = self._target(i)
        if at is None:
            return np.zeros(0, dtype)
        n = struct.unpack_from("<I", self.buf, at)[0]
        return np.frombuffer(self.buf, np.dtype(dtype).newbyteorder("<"),
                             n, at + 4)

    def tables(self, i: int) -> List["_Table"]:
        at = self._target(i)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for k in range(n):
            el = at + 4 + 4 * k
            out.append(_Table(self.buf,
                              el + struct.unpack_from("<I", self.buf, el)[0]))
        return out

    def string(self, i: int) -> str:
        at = self._target(i)
        if at is None:
            return ""
        n = struct.unpack_from("<I", self.buf, at)[0]
        return self.buf[at + 4: at + 4 + n].decode("utf-8")


def read_tflite_tensors(path: str) -> Dict[str, Dict[str, Any]]:
    """{tensor name: {"data": array of the tensor's shape and type (empty
    for a tensor without data), "quantization": (scale, zero_point)}} of
    the first subgraph of a .tflite file; (0.0, 0) where the tensor has
    no quantization, as `tf.lite.Interpreter.get_tensor_details` gives it.
    A file that is absent raises the interpreter's ValueError, naming the
    path, so that every edge answers as the JAX package's does."""
    if not os.path.isfile(path):
        raise ValueError(f"Could not open '{path}'.")
    with open(path, "rb") as fh:
        buf = fh.read()
    model = _Table(buf, struct.unpack_from("<I", buf, 0)[0])
    buffers = model.tables(4)               # Model.buffers
    subgraph = model.tables(2)[0]           # Model.subgraphs[0]
    out: Dict[str, Dict[str, Any]] = {}
    for t in subgraph.tables(0):            # SubGraph.tensors
        shape = tuple(int(d) for d in t.vector(0, np.int32))   # shape
        dtype = _TFLITE_DTYPES[t.scalar(1, "b")]               # type
        b = buffers[t.scalar(2, "I")]                          # buffer
        raw = b.vector(0, np.uint8)                            # data
        data = (np.frombuffer(raw.tobytes(), np.dtype(dtype).newbyteorder(
            "<")).astype(dtype).reshape(shape) if raw.size else
            np.zeros((0,), dtype))
        q = t.table(4)                                         # quantization
        scale = q.vector(2, np.float32) if q is not None else []
        zp = q.vector(3, np.int64) if q is not None else []
        out[t.string(3)] = {
            "data": data,
            "quantization": (float(scale[0]) if len(scale) else 0.0,
                             int(zp[0]) if len(zp) else 0),
        }
    return out


def load_ssd_weights(
    path: str = DEFAULT_TFLITE_PATH,
) -> Tuple[Dict[str, Any], np.ndarray]:
    """({'params': ...} flax tree of `SSDMobileNetV1`, anchors [1917, 4]
    normalized (cy, cx, h, w)), both dequantized to f32 numpy; convert
    with `models.ssd_mobilenet.ssd_state_dict`. Raises ValueError naming
    the path when the file is absent (`read_tflite_tensors`)."""
    tensors = read_tflite_tensors(path)

    def fetch(name: str) -> np.ndarray:
        t = tensors[name]
        scale, zp = t["quantization"]
        return _dequant(t["data"], scale, int(zp))

    params: Dict[str, Any] = {}
    for our_name, (w_name, b_name) in _name_map().items():
        params[our_name] = {
            "conv": {
                "kernel": _to_hwio(fetch(w_name), our_name.startswith("dw")),
                "bias": fetch(b_name),
            }
        }
    anchors = fetch("anchors")  # quantized like everything else
    return {"params": params}, anchors
