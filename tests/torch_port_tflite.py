"""A .tflite writer in plain `struct` (no TensorFlow, no `flatbuffers`): one
subgraph of constant tensors, no operators, each tensor with its data in a
buffer of its own and an optional per-tensor (scale, zero_point). Enough
to carry the SSD's weights the way the reference's ssd.tflite carries
them, so that `models.tflite_import.load_ssd_weights` (and
`tf.lite.Interpreter`, where TensorFlow is installed) can read a file the
tests and `chip_smoke.py` make. Port + numpy only.

Layout: the flatbuffer is written front to back. A table is preceded by
its vtable (a positive soffset back to it); everything a table refers to
(vectors, strings, sub-tables) follows it, so every uoffset points
forward, as the format requires. Vectors are aligned so that their
elements (and tflite's buffer data, at 16 bytes) are aligned.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# tflite TensorType of the numpy dtypes written here (schema.fbs)
_TYPES = {np.dtype(np.float32): 0, np.dtype(np.int32): 2,
          np.dtype(np.uint8): 3, np.dtype(np.int64): 4,
          np.dtype(np.int8): 9}


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def align(self, n: int, extra: int = 0) -> None:
        """Pad so that position + extra is a multiple of n."""
        while (len(self.buf) + extra) % n:
            self.buf.append(0)

    def patch_uoffset(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def vector(self, data: bytes, count: int, align: int) -> int:
        self.align(max(align, 4), 4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", count) + data
        return pos

    def string(self, s: str) -> int:
        raw = s.encode("utf-8")
        pos = self.vector(raw + b"\0", len(raw), 4)
        return pos

    def table(self, fields: List[Optional[Tuple[str, object]]]) -> List:
        """Write a vtable and its table. `fields[i]` is None (absent),
        ("b" | "I" | "i" | ..., value) for a scalar, or ("ref", child) for
        an offset to `child` (written later by the caller). Returns the
        table's position and [(field position, child)] of its references."""
        inline, offsets, refs, size = [], [], [], 4
        for f in fields:
            if f is None:
                offsets.append(0)
                continue
            fmt = "I" if f[0] == "ref" else f[0]
            width = struct.calcsize("<" + fmt)
            size += (-size) % width
            offsets.append(size)
            inline.append((size, fmt, f))
            size += width
        size += (-size) % 4
        vt = struct.pack(f"<HH{len(offsets)}H", 4 + 2 * len(offsets), size,
                         *offsets)
        self.align(2)
        vt_pos = len(self.buf)
        self.buf += vt
        self.align(8)
        pos = len(self.buf)
        body = bytearray(size)
        struct.pack_into("<i", body, 0, pos - vt_pos)
        for off, fmt, f in inline:
            struct.pack_into("<" + fmt, body, off,
                             0 if f[0] == "ref" else f[1])
            if f[0] == "ref":
                refs.append((pos + off, f[1]))
        self.buf += body
        return pos, refs


def _emit(w: _Writer, obj) -> int:
    """Writes `obj` and everything it refers to; returns its position.
    obj: ("table", fields) | ("tables", [obj...]) | ("string", str) |
    ("vector", numpy array, alignment)."""
    kind = obj[0]
    if kind == "string":
        return w.string(obj[1])
    if kind == "vector":
        arr = np.ascontiguousarray(obj[1])
        return w.vector(arr.astype(arr.dtype.newbyteorder("<")).tobytes(),
                        arr.size, max(obj[2], arr.dtype.itemsize))
    if kind == "tables":
        slots = w.vector(b"\0" * (4 * len(obj[1])), len(obj[1]), 4) + 4
        for i, child in enumerate(obj[1]):
            w.patch_uoffset(slots + 4 * i, _emit(w, child))
        return slots - 4
    pos, refs = w.table(obj[1])
    for at, child in refs:
        w.patch_uoffset(at, _emit(w, child))
    return pos


def tflite_bytes(tensors: Sequence[Tuple[str, np.ndarray,
                                         Optional[Tuple[float, int]]]]
                 ) -> bytes:
    """A .tflite flatbuffer holding `tensors` [(name, array, (scale,
    zero_point) or None)] as constant tensors of one subgraph."""
    buffers = [("table", [])]          # buffer 0: empty, by convention
    tensor_tables = []
    for name, arr, quant in tensors:
        arr = np.asarray(arr)
        buffers.append(("table", [("ref", ("vector", np.frombuffer(
            np.ascontiguousarray(arr).tobytes(), np.uint8), 16))]))
        q = None
        if quant is not None:
            q = ("ref", ("table", [
                None, None,
                ("ref", ("vector", np.asarray([quant[0]], np.float32), 4)),
                ("ref", ("vector", np.asarray([quant[1]], np.int64), 8)),
            ]))
        tensor_tables.append(("table", [
            ("ref", ("vector", np.asarray(arr.shape, np.int32), 4)),
            ("b", _TYPES[arr.dtype]),
            ("I", len(buffers) - 1),
            ("ref", ("string", name)),
            q,
        ]))
    subgraph = ("table", [
        ("ref", ("tables", tensor_tables)),
        ("ref", ("vector", np.zeros(0, np.int32), 4)),
        ("ref", ("vector", np.zeros(0, np.int32), 4)),
        ("ref", ("tables", [])),
        ("ref", ("string", "main")),
    ])
    model = ("table", [
        ("I", 3),                                   # version
        ("ref", ("tables", [])),                    # operator_codes
        ("ref", ("tables", [subgraph])),            # subgraphs
        ("ref", ("string", "hbpe test model")),     # description
        ("ref", ("tables", buffers)),               # buffers
    ])
    w = _Writer()
    w.buf += b"\0\0\0\0TFL3"
    root = _emit(w, model)
    w.patch_uoffset(0, root)
    return bytes(w.buf)


def write_tflite(path: str, tensors) -> str:
    with open(path, "wb") as fh:
        fh.write(tflite_bytes(tensors))
    return path


def quantize(arr: np.ndarray, dtype=np.uint8) -> Tuple[np.ndarray, float,
                                                       int]:
    """Per-tensor affine quantization of a float array, as a tflite
    converter does: uint8 weights with a zero point inside [0, 255] (or
    int32 with zero point 0 for biases, dtype=np.int32); returns
    (q, scale, zero_point) with (q - zero_point) * scale ~ arr."""
    arr = np.asarray(arr, np.float32)
    if np.dtype(dtype) == np.int32:
        scale = float(np.float32(max(float(np.abs(arr).max()), 1e-12)
                                 / 2 ** 24))
        return np.round(arr / scale).astype(np.int32), scale, 0
    lo, hi = min(float(arr.min()), 0.0), max(float(arr.max()), 0.0)
    scale = float(np.float32(max(hi - lo, 1e-12) / 255.0))
    zp = int(np.clip(round(-lo / scale), 0, 255))
    q = np.clip(np.round(arr / scale) + zp, 0, 255).astype(np.uint8)
    return q, scale, zp


def ssd_tensors(params: Dict, anchors: np.ndarray,
                bias_dtype=np.int32) -> List:
    """The tensors of an ssd.tflite for an SSD flax tree ({name: {'conv':
    {'kernel' HWIO, 'bias'}}}) and its anchor table, under the blob's
    names (`models.tflite_import._name_map`): weights uint8 in the tflite
    layouts (conv [O, H, W, I], depthwise [1, H, W, C]) with a non-zero
    zero point, biases `bias_dtype` (int32, zero point 0), anchors uint8."""
    from human_body_proportion_estimation_tpu_torch.models.tflite_import import (  # noqa: E501
        _name_map,
    )

    out = []
    for ours, (w_name, b_name) in _name_map().items():
        k = np.asarray(params[ours]["conv"]["kernel"], np.float32)
        tfl = (np.transpose(k, (2, 0, 1, 3)) if ours.startswith("dw")
               else np.transpose(k, (3, 0, 1, 2)))
        q, s, z = quantize(tfl)
        out.append((w_name, q, (s, z)))
        q, s, z = quantize(params[ours]["conv"]["bias"], bias_dtype)
        out.append((b_name, q, (s, z)))
    q, s, z = quantize(anchors)
    out.append(("anchors", q, (s, z)))
    return out
