"""The variables of a TF1 SavedModel (a graph-mode export, as
`tf.compat.v1.saved_model.simple_save` and `SavedModelBuilder` write one:
a MetaGraph without an object graph), read with numpy: no TensorFlow, no
protobuf package. `variables` gives what `tf.saved_model.load(dir).
variables` holds for such an export (TensorFlow's `load_v1_in_v2`):

- Which, in order: the resource variables of the MetaGraph's `variables`
  collection, then of `local_variables` (`VariableDef`s), each handle
  once. A ref variable (`VariableV2`) is left out, as TensorFlow cannot
  lift it out of the imported graph. Each is named by its `VarHandleOp`.
- Global values: the saver's restore graph, from
  `SaverDef.restore_op_name` through everything it depends on (a sharded
  saver has a `RestoreV2` a device). Each `AssignVariableOp` into a listed
  variable is evaluated back to a `RestoreV2` output: the key
  `tensor_names[k]` read from the `variables/variables` bundle, cut to
  `shape_and_slices[k]` (`"<full shape> <start>,<length>:..."`, `-` for a
  whole dimension) when that is not empty. Every key of a `RestoreV2`
  reached is read, as TensorFlow's restore reads them. Without a
  SaverDef, TensorFlow's default saver: each global variable under its
  name (a partitioned one raises, as TensorFlow's loader fails on it).
- Local values: the init op (the `__saved_model_init_op` signature, else
  the `saved_model_main_op` collection, else `legacy_init_op`), else every
  local variable's initializer, run after the restore: the
  `AssignVariableOp`s it depends on evaluated over `Const`, `Identity`,
  `Fill`, `Cast`, `Reshape`, `ZerosLike` and `OnesLike`.

A variable that nothing assigns has no value in TensorFlow (it stays
uninitialized there and reads as an empty array, not one of its shape): it
raises a ValueError naming it, as does any other op on a
variable's path (a random initializer, a main op that computes values),
an op that changes a variable otherwise, or a variable assigned twice.

Wire format (field numbers): SavedModel meta_graphs 2; MetaGraphDef
meta_info_def 1 (tags 4), graph_def 2, saver_def 3 (restore_op_name 3),
collection_def 4 and signature_def 5 (maps: key 1, value 2),
object_graph_def 7; GraphDef node 1; NodeDef name 1, op 2, input 3 (`name`,
`name:k`, `^control`), attr 5 (a map); AttrValue list 1, s 2, i 3, f 4,
b 5, type 6, shape 7, tensor 8; TensorShapeProto dim 2 (size 1),
unknown_rank 3; TensorProto dtype 1, tensor_shape 2, tensor_content 4
(host byte order), float_val 5, double_val 6, int_val 7, string_val 8,
int64_val 10, bool_val 11, half_val 13 (f16 bits in int32s), packed or
not; fewer values than elements repeat the last, none is all zeros;
CollectionDef node_list 1 / bytes_list 2 (value 1); VariableDef
variable_name 1, initializer_name 2, save_slice_info_def 4, is_resource 5;
SaveSliceInfoDef full_name 1, full_shape 2, var_offset 3, var_shape 4;
SignatureDef outputs 2 (TensorInfo name 1).
"""

from __future__ import annotations

import os
import struct
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from human_body_proportion_estimation_tpu_torch.models.tf_bundle import (
    DT_STRING,
    DTYPES,
    TensorBundle,
    _message,
    _one,
    _varint,
)

INIT_OP_SIGNATURE = "__saved_model_init_op"
INIT_OP_COLLECTIONS = ("saved_model_main_op", "legacy_init_op")
# ops that take a variable's handle and leave its value as it is
READS = frozenset({"ReadVariableOp", "VarIsInitializedOp",
                   "DisableCopyOnRead", "VariableShape"})
EVALUATED = ("Const", "Identity", "Fill", "Cast", "Reshape", "ZerosLike",
             "OnesLike")

TensorRef = Tuple[str, int]


def _signed(v: int) -> int:
    """A varint as the signed 64-bit number protobuf wrote."""
    return v - (1 << 64) if v >> 63 else v


def _text(b: bytes) -> str:
    return b.decode("utf-8")


def _map(entries: List[bytes], what: str) -> Dict[str, bytes]:
    """A protobuf map<string, message> field: key -> its serialized value."""
    out = {}
    for entry in entries:
        msg = _message(entry, what)
        out[_text(_one(msg, 1, b""))] = _one(msg, 2, b"")
    return out


# --------------------------------------------------------------------- #
# repeated scalar fields, packed or not


def _ints(values: List, what: str) -> List[int]:
    out = []
    for v in values:
        if isinstance(v, bytes):
            at = 0
            while at < len(v):
                x, at = _varint(v, at, what)
                out.append(_signed(x))
        else:
            out.append(_signed(v))
    return out


def _words(values: List, code: str) -> np.ndarray:
    """A repeated fixed32 ('<u4') or fixed64 ('<u8') field's raw words."""
    parts = [np.frombuffer(v, code) if isinstance(v, bytes)
             else np.array([v], code) for v in values]
    return np.concatenate(parts) if parts else np.zeros(0, code)


# --------------------------------------------------------------------- #
# TensorShapeProto, TensorProto, AttrValue


def shape_proto(buf: bytes, what: str) -> Optional[Tuple[int, ...]]:
    """A TensorShapeProto's dims (-1 for an unknown one), None for an
    unknown rank."""
    msg = _message(buf, what)
    if _one(msg, 3):
        return None
    return tuple(_signed(_one(_message(d, what), 1)) for d in msg.get(2, []))


# dtype -> (TensorProto's typed value field, the words it holds: None for
# varints)
_VALUE_FIELD = {1: (5, "<u4"), 2: (6, "<u8"), 3: (7, None), 4: (7, None),
                5: (7, None), 6: (7, None), 7: (8, None), 9: (10, None),
                10: (11, None), 19: (13, None)}


def tensor_proto(buf: bytes, what: str) -> np.ndarray:
    """A TensorProto as an array (`bytes` elements in an object array for
    strings), as TensorFlow's `MakeNdarray` gives it."""
    msg = _message(buf, what)
    code = _one(msg, 1)
    if code not in DTYPES:
        raise ValueError(f"{what}: a tensor of TensorFlow dtype {code}, which "
                         "is not read")
    dtype = DTYPES[code]
    shape = shape_proto(_one(msg, 2, b""), what)
    if shape is None or min(shape, default=0) < 0:
        raise ValueError(f"{what}: a tensor of unknown shape {shape}")
    count = int(np.prod(shape, dtype=np.int64))
    if 4 in msg and code != DT_STRING:
        raw = _one(msg, 4)
        if len(raw) != count * dtype.itemsize:
            raise ValueError(f"{what}: {len(raw)} bytes of tensor_content for "
                             f"{shape} x {dtype}")
        return np.frombuffer(raw, dtype).reshape(shape).copy()
    field, words = _VALUE_FIELD[code]
    stored = msg.get(field, [])
    if code == DT_STRING:
        values = np.empty(len(stored), object)
        values[:] = stored
    elif words:
        values = _words(stored, words).view(dtype)
    elif code == 19:                       # half_val: f16 bits
        values = np.array(_ints(stored, what), np.int64).astype(
            np.uint16).view(dtype)
    else:
        values = np.array(_ints(stored, what), np.int64).astype(dtype)
    if len(values) > count:
        raise ValueError(f"{what}: {len(values)} values for {count} elements")
    out = np.full(count, b"" if code == DT_STRING else 0, dtype)
    if len(values):
        out[:len(values)] = values
        out[len(values):] = values[-1]
    return out.reshape(shape)


def _attr_list(buf: bytes, what: str) -> list:
    msg = _message(buf, what)
    if 2 in msg:
        return list(msg[2])
    if 3 in msg or 6 in msg:
        return _ints(msg.get(3, msg.get(6)), what)
    if 4 in msg:
        return _words(msg[4], "<u4").view("<f4").tolist()
    if 5 in msg:
        return [bool(x) for x in _ints(msg[5], what)]
    if 7 in msg:
        return [shape_proto(s, what) for s in msg[7]]
    if 8 in msg:
        return [tensor_proto(t, what) for t in msg[8]]
    return []


def attr_value(buf: bytes, what: str):
    """An AttrValue: bytes (s), int (i, type), float, bool, a shape (see
    `shape_proto`), an array (tensor) or a list of one of them."""
    msg = _message(buf, what)
    if 1 in msg:
        return _attr_list(_one(msg, 1), what)
    if 2 in msg:
        return _one(msg, 2)
    if 3 in msg or 6 in msg:
        return _signed(_one(msg, 3 if 3 in msg else 6))
    if 4 in msg:
        return struct.unpack("<f", _one(msg, 4).to_bytes(4, "little"))[0]
    if 5 in msg:
        return bool(_one(msg, 5))
    if 7 in msg:
        return shape_proto(_one(msg, 7), what)
    if 8 in msg:
        return tensor_proto(_one(msg, 8), what)
    return None


# --------------------------------------------------------------------- #
# GraphDef


def tensor_ref(name: str) -> TensorRef:
    """'node' or 'node:k' -> (node, k)."""
    node, _, k = name.partition(":")
    return node, int(k) if k else 0


class Node:
    """One NodeDef: its data inputs as (node, output), its control inputs,
    its attrs decoded when asked for."""

    __slots__ = ("name", "op", "inputs", "controls", "_attrs")

    def __init__(self, buf: bytes, what: str):
        msg = _message(buf, what)
        self.name = _text(_one(msg, 1, b""))
        self.op = _text(_one(msg, 2, b""))
        self.inputs: List[TensorRef] = []
        self.controls: List[str] = []
        for s in msg.get(3, []):
            s = _text(s)
            if s.startswith("^"):
                self.controls.append(s[1:])
            else:
                self.inputs.append(tensor_ref(s))
        self._attrs = msg.get(5, [])

    def attr(self, key: str):
        raw = _map(self._attrs, f"node {self.name!r}").get(key)
        return None if raw is None else attr_value(
            raw, f"attr {key!r} of node {self.name!r}")


def read_graph(buf: bytes, what: str) -> Dict[str, Node]:
    """A GraphDef's nodes by name."""
    nodes = [Node(b, f"{what}: NodeDef") for b in _message(buf, what).get(
        1, [])]
    return {n.name: n for n in nodes}


def _reach(graph: Dict[str, Node], starts: List[str], what: str
           ) -> List[Node]:
    """Every node that running `starts` runs: they and all they depend on,
    through data and control inputs."""
    seen, stack, out = set(), list(starts), []
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        if name not in graph:
            raise ValueError(f"{what}: no node {name!r} in the graph")
        seen.add(name)
        node = graph[name]
        out.append(node)
        stack.extend(n for n, _ in node.inputs)
        stack.extend(node.controls)
    return out


# --------------------------------------------------------------------- #
# variables


class Variable(NamedTuple):
    name: str            # its VarHandleOp
    initializer: str
    partitioned: bool    # a part of a partitioned variable
    local: bool
    dtype: np.dtype
    shape: Optional[Tuple[int, ...]]


def lifted_variables(collections: Dict[str, bytes], graph: Dict[str, Node],
                     what: str) -> List[Variable]:
    """The resource variables of the `variables` then the `local_variables`
    collection, each handle once: `.variables` of the loaded export."""
    out, seen = [], set()
    for key, local in (("variables", False), ("local_variables", True)):
        if key not in collections:
            continue
        listed = _message(_one(_message(collections[key], what), 2, b""),
                          what).get(1, [])
        for raw in listed:
            vdef = _message(raw, f"{what}: VariableDef")
            if not _one(vdef, 5):
                continue                   # a ref variable: not lifted
            ref = tensor_ref(_text(_one(vdef, 1, b"")))
            if ref in seen:
                continue
            seen.add(ref)
            node = graph.get(ref[0])
            if node is None or node.op != "VarHandleOp":
                raise ValueError(f"{what}: the variable {ref[0]!r} of the "
                                 f"collection {key!r} is not a VarHandleOp "
                                 f"({node.op if node else 'absent'})")
            code = node.attr("dtype")
            if code not in DTYPES:
                raise ValueError(f"{what}: the variable {node.name!r} has "
                                 f"TensorFlow dtype {code}, which is not read")
            out.append(Variable(node.name, _text(_one(vdef, 2, b"")),
                                4 in vdef, local, DTYPES[code],
                                node.attr("shape")))
    return out


def _handle(graph: Dict[str, Node], name: str) -> str:
    """The node a resource input comes from, through Identity."""
    while graph[name].op == "Identity" and graph[name].inputs:
        name = graph[name].inputs[0][0]
    return name


def _writes(nodes: List[Node], graph: Dict[str, Node],
            variables: Dict[str, Variable], what: str
            ) -> List[Tuple[Variable, TensorRef]]:
    """(variable, value input) of each AssignVariableOp among `nodes` into
    one of `variables`; any other op that takes one's handle and is not a
    read raises."""
    out = []
    for node in nodes:
        for i, (src, _) in enumerate(node.inputs):
            var = variables.get(_handle(graph, src))
            if var is None or node.op in READS or node.op == "Identity":
                continue
            if node.op != "AssignVariableOp" or i != 0:
                raise ValueError(f"{what}: {node.op} {node.name!r} changes "
                                 f"the variable {var.name!r}, which is not "
                                 "evaluated")
            out.append((var, node.inputs[1]))
    return out


def cut(value: np.ndarray, spec: str, what: str) -> np.ndarray:
    """`value` cut to a RestoreV2 `shape_and_slices` entry (its full shape
    checked); `value` itself for an empty one."""
    if not spec:
        return value
    *full, extents = spec.split(" ")
    full = tuple(int(d) for d in full)
    if full != value.shape:
        raise ValueError(f"{what}: the slice {spec!r} is of a {full} tensor, "
                         f"the checkpoint holds {value.shape}")
    where = []
    for ext in extents.split(":"):
        if ext == "-":
            where.append(slice(None))
        else:
            start, length = (int(x) for x in ext.split(","))
            where.append(slice(start, start + length))
    if len(where) != len(full):
        raise ValueError(f"{what}: the slice {spec!r} has rank {len(where)}")
    return np.ascontiguousarray(value[tuple(where)])


class Evaluator:
    """Values of tensors of the graph over Const, Identity, Fill, Cast,
    Reshape, ZerosLike and OnesLike; `restored(node, k)` gives a RestoreV2
    output. Any other op raises, naming it and `for_what`."""

    def __init__(self, graph: Dict[str, Node],
                 restored: Optional[Callable[[Node, int], np.ndarray]] = None):
        self.graph, self.restored = graph, restored
        self.memo: Dict[TensorRef, np.ndarray] = {}

    def __call__(self, ref: TensorRef, for_what: str) -> np.ndarray:
        if ref in self.memo:
            return self.memo[ref]
        node = self.graph.get(ref[0])
        if node is None:
            raise ValueError(f"{for_what}: no node {ref[0]!r} in the graph")

        def arg(i):
            return self(node.inputs[i], for_what)

        op = node.op
        if op == "Const":
            out = node.attr("value")
        elif op == "Identity":
            out = arg(0)
        elif op == "Fill":
            dims, value = arg(0), arg(1)
            out = np.full(tuple(dims.tolist()), value, value.dtype)
        elif op == "Cast" and node.attr("DstT") in DTYPES:
            out = arg(0).astype(DTYPES[node.attr("DstT")])
        elif op == "Reshape":
            out = arg(0).reshape(tuple(arg(1).tolist()))
        elif op in ("ZerosLike", "OnesLike") and arg(0).dtype != object:
            out = (np.zeros_like if op == "ZerosLike" else np.ones_like)(
                arg(0))
        elif op == "RestoreV2" and self.restored is not None:
            out = self.restored(node, ref[1])
        else:
            raise ValueError(
                f"{for_what} is computed by {op} {node.name!r}, which is not "
                f"evaluated (only {', '.join(EVALUATED)} are)")
        self.memo[ref] = out
        return out


def _assign(values: Dict[str, np.ndarray], writes, evaluate: Evaluator,
            what: str) -> None:
    done = set()
    for var, ref in writes:
        for_what = f"{what}: the variable {var.name!r}"
        if var.name in done:
            raise ValueError(f"{for_what} is assigned twice")
        done.add(var.name)
        value = np.asarray(evaluate(ref, for_what))
        if value.dtype != var.dtype or (var.shape is not None and (
                len(var.shape) != value.ndim or any(
                    d not in (-1, n) for d, n in zip(var.shape,
                                                     value.shape)))):
            raise ValueError(f"{for_what} ({var.dtype}, {var.shape}) is "
                             f"assigned a {value.dtype} {value.shape}")
        values[var.name] = value


def _restore_specs(graph: Dict[str, Node], nodes: List[Node], what: str
                   ) -> Dict[str, List[Tuple[str, str, int]]]:
    """(key, shape_and_slices, dtype) of each output of each RestoreV2
    among `nodes`, by node name."""
    consts = Evaluator(graph)
    out = {}
    for node in nodes:
        if node.op != "RestoreV2":
            continue
        for_what = f"{what}: RestoreV2 {node.name!r}"
        names = consts(node.inputs[1], for_what).reshape(-1)
        specs = consts(node.inputs[2], for_what).reshape(-1)
        out[node.name] = [(_text(n), _text(s), t) for n, s, t in zip(
            names, specs, node.attr("dtypes"))]
    return out


class _Checkpoint:
    """The tensors `keys` of the bundle at `prefix`, read at once (a key
    that is absent raises KeyError, as TensorFlow's restore fails)."""

    def __init__(self, prefix: str, keys, what: str):
        keys = sorted(keys)
        self.values = TensorBundle(prefix).read(keys) if keys else {}
        self.what = what

    def read(self, name: str, spec: str, code: Optional[int]) -> np.ndarray:
        """Tensor `name` cut to `spec`, its dtype checked against `code`
        (None: not checked)."""
        value = self.values[name]
        if not isinstance(value, np.ndarray):
            value = np.array(value, object if isinstance(value, bytes)
                             else None)
        if code is not None and DTYPES.get(code) != value.dtype:
            raise ValueError(f"{self.what}: the checkpoint holds {name!r} as "
                             f"{value.dtype}, the restore op reads dtype "
                             f"{code}")
        return cut(value, spec, f"{self.what}: {name!r}")


def _init_op(meta: Dict[int, List], collections: Dict[str, bytes],
             what: str) -> Optional[str]:
    """The node of the init op, as TensorFlow's `loader_impl.get_init_op`
    finds it, or None."""
    signatures = _map(meta.get(5, []), what)
    if INIT_OP_SIGNATURE in signatures:
        outputs = _map(_message(signatures[INIT_OP_SIGNATURE], what).get(
            2, []), what)
        if INIT_OP_SIGNATURE not in outputs:
            raise ValueError(f"{what}: the signature {INIT_OP_SIGNATURE!r} "
                             "has no output of that name")
        info = _message(outputs[INIT_OP_SIGNATURE], what)
        return tensor_ref(_text(_one(info, 1, b"")))[0]
    for key in INIT_OP_COLLECTIONS:
        if key in collections:
            ops = _message(_one(_message(collections[key], what), 1, b""),
                           what).get(1, [])
            if len(ops) != 1:
                raise ValueError(f"{what}: the collection {key!r} holds "
                                 f"{len(ops)} ops; an init op is one")
            return tensor_ref(_text(ops[0]))[0]
    return None


def variables(export_dir: str, meta: Dict[int, List], what: str
              ) -> List[Tuple[str, object]]:
    """(name, value) of each variable of the TF1 MetaGraph `meta` (parsed:
    field number -> values) of the SavedModel at `export_dir`, in
    `.variables` order; `what` names the file in errors."""
    graph = read_graph(_one(meta, 2, b""), what)
    collections = _map(meta.get(4, []), what)
    lifted = lifted_variables(collections, graph, what)
    by_handle = {v.name: v for v in lifted}
    prefix = os.path.join(export_dir, "variables", "variables")
    values: Dict[str, np.ndarray] = {}
    if 3 in meta:
        restore_op = _text(_one(_message(_one(meta, 3), what), 3, b""))
        where = f"{what}: the saver's restore op {restore_op!r}"
        nodes = _reach(graph, [tensor_ref(restore_op)[0]], where)
        specs = _restore_specs(graph, nodes, where)
        ckpt = _Checkpoint(prefix, {n for ss in specs.values()
                                    for n, _, _ in ss}, where)
        _assign(values, _writes(nodes, graph, by_handle, where),
                Evaluator(graph, lambda node, k: ckpt.read(
                    *specs[node.name][k])), where)
    elif any(not v.local for v in lifted):
        # TensorFlow's default saver: each global variable under its name
        where = f"{what}: no SaverDef (TensorFlow's default saver)"
        saved = [v for v in lifted if not v.local]
        for v in saved:
            if v.partitioned:
                raise ValueError(f"{where}: the partitioned variable "
                                 f"{v.name!r} is not read (TensorFlow's "
                                 "loader fails on it)")
        ckpt = _Checkpoint(prefix, {v.name for v in saved}, where)
        for v in saved:
            values[v.name] = ckpt.read(v.name, "", None)
    init = _init_op(meta, collections, what)
    if init is not None:
        where = f"{what}: the init op {init!r}"
        starts = [init]
    else:
        where = f"{what}: the local variables' initializers"
        starts = [v.initializer for v in lifted if v.local]
    nodes = _reach(graph, starts, where)
    _assign(values, _writes(nodes, graph, by_handle, where),
            Evaluator(graph), where)
    for v in lifted:
        if v.name not in values:
            raise ValueError(
                f"{what}: the {'local' if v.local else 'global'} variable "
                f"{v.name!r} has no value: "
                + ("the init op does not assign it" if v.local else
                   "the saver does not restore it")
                + " (tf.saved_model.load leaves it uninitialized: an empty "
                "array)")
    return [(v.name, values[v.name][()] if values[v.name].ndim == 0
             else values[v.name]) for v in lifted]
