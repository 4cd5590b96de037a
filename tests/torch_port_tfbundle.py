"""A TensorBundle writer in plain `struct` (no TensorFlow, no protobuf
package): a TF checkpoint of numeric tensors, as
`tf.compat.v1.train.Saver` writes one, that TensorFlow's
`tf.train.load_checkpoint` and the port's `models/tf_bundle` read. The card
has no TensorFlow, so `chip_smoke.py` writes the automl-format Lite4 it
imports with this. Port + numpy only.

Layout (the reader's docstring, `models/tf_bundle.py`, sets the format
out): the tensors go to `shards` data files in key order, split by bytes;
the index is a LevelDB table of uncompressed data blocks of about 4 KiB
(prefix-compressed keys, a restart every 16 entries), an index block (a
restart at every entry), an empty metaindex block and the footer. A
`checkpoint` file beside it names the prefix, relative, so that the
directory resolves to it.

`write_tf1_saved_model` writes a TF1 SavedModel (a graph-mode export, as
`tf.compat.v1.saved_model.Builder` writes one; `models/tf_graph.py` sets
the format out) that `tf.saved_model.load` and the port read alike.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from human_body_proportion_estimation_tpu_torch.models.tf_bundle import (
    DTYPES,
    TABLE_MAGIC,
    mask,
)
from human_body_proportion_estimation_tpu_torch.utils.crc32c import crc32c

# numpy type -> TensorFlow DataType of the numeric types written here
_TF_DTYPE = {dt: code for code, dt in DTYPES.items() if dt != object}
BLOCK_BYTES = 4096
RESTART_INTERVAL = 16


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _field(number: int, value) -> bytes:
    """One protobuf field: an int as a varint, bytes length-delimited."""
    if isinstance(value, bytes):
        return _varint(number << 3 | 2) + _varint(len(value)) + value
    return _varint(number << 3) + _varint(value)


def entry_proto(dtype: int, shape, shard: int, offset: int, size: int,
                crc: int) -> bytes:
    """A `BundleEntryProto`; fields at 0 are left out, as protobuf does."""
    dims = b"".join(_field(2, _field(1, d) if d else b"") for d in shape)
    out = _field(1, dtype) + _field(2, dims)
    for number, value in ((3, shard), (4, offset), (5, size)):
        if value:
            out += _field(number, value)
    return out + _varint(6 << 3 | 5) + struct.pack("<I", crc)


class _Table:
    """A LevelDB table, written into `self.out` block by block."""

    def __init__(self):
        self.out = bytearray()

    def block(self, rows: List[Tuple[bytes, bytes]], interval: int) -> bytes:
        """Write one uncompressed block of `rows`; return its handle."""
        body, restarts, prev = bytearray(), [], b""
        for i, (key, value) in enumerate(rows):
            shared = 0
            if i % interval:
                while (shared < min(len(key), len(prev))
                       and key[shared] == prev[shared]):
                    shared += 1
            else:
                restarts.append(len(body))
            body += (_varint(shared) + _varint(len(key) - shared)
                     + _varint(len(value)) + key[shared:] + value)
            prev = key
        restarts = restarts or [0]
        body += struct.pack(f"<{len(restarts)}I", *restarts)
        body += struct.pack("<I", len(restarts))
        handle = _varint(len(self.out)) + _varint(len(body))
        self.out += body + b"\0" + struct.pack(
            "<I", mask(crc32c(bytes(body) + b"\0")))
        return handle

    def finish(self, rows: List[Tuple[bytes, bytes]]) -> bytes:
        index, group, size = [], [], 0
        for key, value in rows:
            group.append((key, value))
            size += len(key) + len(value) + 8
            if size >= BLOCK_BYTES:
                index.append((key, self.block(group, RESTART_INTERVAL)))
                group, size = [], 0
        if group:
            index.append((group[-1][0], self.block(group, RESTART_INTERVAL)))
        meta = self.block([], RESTART_INTERVAL)
        index_handle = self.block(index, 1)
        footer = (meta + index_handle).ljust(40, b"\0")
        return bytes(self.out + footer + struct.pack("<Q", TABLE_MAGIC))


def table_bytes(rows: List[Tuple[bytes, bytes]]) -> bytes:
    """A whole LevelDB table file of `rows` ((key, value), sorted by key)."""
    return _Table().finish(rows)


def write_checkpoint(prefix: str, tensors: Dict[str, np.ndarray],
                     shards: int = 1) -> str:
    """Write `tensors` (name -> numeric array) as the TF checkpoint
    `prefix` in `shards` data files, and a `checkpoint` file beside it;
    returns `prefix`."""
    names = sorted(tensors, key=lambda n: n.encode("utf-8"))
    arrays = {}
    for name in names:
        arr = np.array(tensors[name], order="C")
        dtype = arr.dtype.newbyteorder("<")
        if dtype not in _TF_DTYPE:
            raise ValueError(f"{name}: dtype {arr.dtype} is not written")
        arrays[name] = arr.astype(dtype, copy=False)
    total = sum(a.nbytes for a in arrays.values())
    files: List[bytearray] = [bytearray() for _ in range(shards)]
    rows = [(b"", _field(1, shards) + _field(3, _field(1, 1)))]
    done = 0
    for name in names:
        arr = arrays[name]
        shard = min(done * shards // max(total, 1), shards - 1)
        data = arr.tobytes()
        rows.append((name.encode("utf-8"), entry_proto(
            _TF_DTYPE[arr.dtype], arr.shape, shard, len(files[shard]),
            len(data), mask(crc32c(data)))))
        files[shard] += data
        done += len(data)
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    for shard, data in enumerate(files):
        with open(f"{prefix}.data-{shard:05d}-of-{shards:05d}", "wb") as fh:
            fh.write(data)
    with open(prefix + ".index", "wb") as fh:
        fh.write(table_bytes(rows))
    base = os.path.basename(prefix)
    with open(os.path.join(os.path.dirname(os.path.abspath(prefix)),
                           "checkpoint"), "w") as fh:
        fh.write(f'model_checkpoint_path: "{base}"\n'
                 f'all_model_checkpoint_paths: "{base}"\n')
    return prefix


# --------------------------------------------------------------------- #
# a TF1 SavedModel

DT_INT32, DT_FLOAT, DT_STRING = 3, 1, 7
# the GraphDef versions TensorFlow 2.21 writes
GRAPH_PRODUCER, GRAPH_MIN_CONSUMER = 2474, 12


def _shape(dims) -> bytes:
    """A TensorShapeProto."""
    return b"".join(_field(2, _field(1, d) if d else b"") for d in dims)


def _tensor(arr: np.ndarray) -> bytes:
    """A TensorProto: numeric arrays as tensor_content, strings as
    string_val."""
    arr = np.asarray(arr)
    if arr.dtype.kind in "SO":
        return (_field(1, DT_STRING) + _field(2, _shape(arr.shape))
                + b"".join(_field(8, bytes(v)) for v in arr.reshape(-1)))
    arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    return (_field(1, _TF_DTYPE[arr.dtype]) + _field(2, _shape(arr.shape))
            + _field(4, arr.tobytes()))


def _attr(kind: str, value) -> bytes:
    """An AttrValue of `kind`: type, shape, tensor, s or types (a list of
    types)."""
    if kind == "type":
        return _field(6, value)
    if kind == "shape":
        return _field(7, _shape(value))
    if kind == "tensor":
        return _field(8, _tensor(value))
    if kind == "s":
        return _field(2, value)
    if kind == "types":
        return _field(1, _field(6, b"".join(_varint(t) for t in value)))
    raise ValueError(kind)


def _node(name: str, op: str, inputs=(), **attrs) -> bytes:
    """A NodeDef; each attr given as (kind, value)."""
    out = _field(1, name.encode()) + _field(2, op.encode())
    out += b"".join(_field(3, i.encode()) for i in inputs)
    for key, (kind, value) in sorted(attrs.items()):
        out += _field(5, _field(1, key.encode()) + _field(2, _attr(kind,
                                                                   value)))
    return out


def _const(name: str, arr) -> bytes:
    arr = np.asarray(arr)
    code = DT_STRING if arr.dtype.kind in "SO" else _TF_DTYPE[
        arr.dtype.newbyteorder("<")]
    return _node(name, "Const", dtype=("type", code), value=("tensor", arr))


def _variable(name: str, code: int, shape, init: List[bytes], value: str
              ) -> Tuple[List[bytes], bytes]:
    """The nodes of resource variable `name` (its VarHandleOp, the nodes
    `init` of its initial value `value`, its Assign and its Read) and its
    VariableDef."""
    nodes = [_node(name, "VarHandleOp", container=("s", b""),
                   dtype=("type", code), shape=("shape", shape),
                   shared_name=("s", name.encode()))]
    nodes += init
    nodes.append(_node(f"{name}/Assign", "AssignVariableOp", [name, value],
                       dtype=("type", code)))
    nodes.append(_node(f"{name}/Read/ReadVariableOp", "ReadVariableOp",
                       [name], dtype=("type", code)))
    vdef = (_field(1, f"{name}:0".encode())
            + _field(2, f"{name}/Assign".encode())
            + _field(3, f"{name}/Read/ReadVariableOp:0".encode())
            + _field(5, 1) + _field(6, f"{value}:0".encode()) + _field(7, 1))
    return nodes, vdef


def _collection(vdefs: List[bytes]) -> bytes:
    """A CollectionDef's bytes_list."""
    return _field(2, b"".join(_field(1, v) for v in vdefs))


def write_tf1_saved_model(directory: str, tensors: Dict[str, np.ndarray],
                          local: Dict[str, Tuple[tuple, object]] = None,
                          shards: int = 2) -> str:
    """Write a TF1 SavedModel at `directory`: each of `tensors` (name ->
    numeric array) a global resource variable restored from
    `variables/variables` (`shards` data files) by a sharded saver's
    restore graph (`shards` RestoreV2s, each under its own restore_shard,
    as a saver over `shards` devices builds it), its initializer an
    unevaluated TruncatedNormal (cast for a non-float variable); each of
    `local` (name -> (shape, value)) a local resource variable that a
    Fill initializes. Returns `directory`."""
    names = sorted(tensors, key=lambda n: n.encode("utf-8"))
    arrays = {n: np.asarray(tensors[n]) for n in names}
    nodes, globals_, locals_ = [], [], []
    for name in names:
        arr = arrays[name]
        code = _TF_DTYPE[arr.dtype.newbyteorder("<")]
        init = f"{name}/Initializer/truncated_normal"
        draw = DT_FLOAT if arr.dtype.kind != "f" else code
        ops = [_const(f"{init}/shape", np.array(arr.shape, np.int32)),
               _node(init, "TruncatedNormal", [f"{init}/shape"],
                     T=("type", DT_INT32), dtype=("type", draw))]
        value = init
        if draw != code:
            value = f"{name}/Initializer/Cast"
            ops.append(_node(value, "Cast", [init], SrcT=("type", draw),
                             DstT=("type", code)))
        more, vdef = _variable(name, code, arr.shape, ops, value)
        nodes += more
        globals_.append(vdef)
    for name, (shape, fill) in (local or {}).items():
        fill = np.asarray(fill)
        code = _TF_DTYPE[fill.dtype.newbyteorder("<")]
        init = f"{name}/Initializer/zeros"
        ops = [_const(f"{init}/shape_as_tensor", np.array(shape, np.int32)),
               _const(f"{init}/Const", fill),
               _node(init, "Fill", [f"{init}/shape_as_tensor",
                                    f"{init}/Const"], T=("type", code),
                     index_type=("type", DT_INT32))]
        more, vdef = _variable(name, code, shape, ops, init)
        nodes += more
        locals_.append(vdef)
    # the saver: a save op over every variable, and a restore op a shard
    codes = [_TF_DTYPE[arrays[n].dtype.newbyteorder("<")] for n in names]
    nodes.append(_const("save/filename/input", np.array(b"model", object)))
    nodes.append(_node("save/Const", "PlaceholderWithDefault",
                       ["save/filename/input"], dtype=("type", DT_STRING),
                       shape=("shape", ())))
    listed = np.array([n.encode() for n in names], object)
    nodes.append(_const("save/SaveV2/tensor_names", listed))
    nodes.append(_const("save/SaveV2/shape_and_slices",
                        np.array([b""] * len(names), object)))
    nodes.append(_node("save/SaveV2", "SaveV2", [
        "save/Const", "save/SaveV2/tensor_names",
        "save/SaveV2/shape_and_slices"] + [
        f"{n}/Read/ReadVariableOp" for n in names], dtypes=("types", codes)))
    nodes.append(_node("save/control_dependency", "Identity",
                       ["save/Const", "^save/SaveV2"], T=("type", DT_STRING)))
    restore_shards, j = [], 0
    for shard in range(shards):
        part = list(range(len(names)))[shard::shards]
        if not part:
            continue
        sfx = f"_{shard}" if shard else ""
        op = f"save/RestoreV2{sfx}"
        nodes.append(_const(f"{op}/tensor_names", listed[part]))
        nodes.append(_const(f"{op}/shape_and_slices",
                            np.array([b""] * len(part), object)))
        nodes.append(_node(op, "RestoreV2", [
            "save/Const", f"{op}/tensor_names", f"{op}/shape_and_slices"],
            dtypes=("types", [codes[i] for i in part])))
        assigns = []
        for k, i in enumerate(part):
            out = f"{op}:{k}" if k else op
            nodes.append(_node(f"save/Identity_{j}", "Identity", [out],
                               T=("type", codes[i])))
            nodes.append(_node(f"save/AssignVariableOp_{j}",
                               "AssignVariableOp",
                               [names[i], f"save/Identity_{j}"],
                               dtype=("type", codes[i])))
            assigns.append(f"^save/AssignVariableOp_{j}")
            j += 1
        nodes.append(_node(f"save/restore_shard{sfx}", "NoOp", assigns))
        restore_shards.append(f"^save/restore_shard{sfx}")
    nodes.append(_node("save/restore_all", "NoOp", restore_shards))
    graph = b"".join(_field(1, n) for n in nodes) + _field(
        4, _field(1, GRAPH_PRODUCER) + _field(2, GRAPH_MIN_CONSUMER))
    saver = (_field(1, b"save/Const:0")
             + _field(2, b"save/control_dependency:0")
             + _field(3, b"save/restore_all") + _field(4, 5) + _field(5, 1)
             + _field(7, 2))
    collections = {"variables": globals_, "trainable_variables": globals_,
                   "local_variables": locals_}
    meta = (_field(1, _field(4, b"serve")) + _field(2, graph)
            + _field(3, saver))
    for key, vdefs in sorted(collections.items()):
        if vdefs:
            meta += _field(4, _field(1, key.encode())
                           + _field(2, _collection(vdefs)))
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "saved_model.pb"), "wb") as fh:
        fh.write(_field(1, 1) + _field(2, meta))
    prefix = os.path.join(directory, "variables", "variables")
    write_checkpoint(prefix, arrays, shards=shards)
    os.remove(os.path.join(directory, "variables", "checkpoint"))
    return directory
