"""TensorFlow checkpoints (the TensorBundle format) and the variables of a
SavedModel (TF2 here, TF1 through `models/tf_graph.py`), read with numpy
and `struct`: no TensorFlow, no protobuf package.

A checkpoint `<prefix>` is an index `<prefix>.index` and data files
`<prefix>.data-%05d-of-%05d`.

Index. A LevelDB table: it ends in a 48-byte footer (the metaindex and
index block handles as varint (offset, size) pairs, padded to 40 bytes,
then the magic 0xdb4775248b80fb57 as a little-endian u64). The index
block's values are the handles of the data blocks. Every block is
followed by its compression type (1 byte, 0 = none: the only one read
here) and the masked CRC32C of the block and that byte. A block's entries
are (shared, non_shared, value_len) varints, the key's new bytes and the
value (a key shares its first `shared` bytes with the key before it); an
array of u32 restart offsets and their count close the block.

Entries. Key "" holds the `BundleHeaderProto` (num_shards 1, endianness
2: 0 little-endian, version 3); every other key a tensor's
`BundleEntryProto` (dtype 1, shape 2, shard_id 3, offset 4, size 5,
crc32c 6: the masked CRC32C of its bytes, slices 7). Absent fields are 0.
A tensor with slices (a TF1 partitioned variable, or a tensor that
`MaxShardSizePolicy` split across data files) stores no bytes of its own:
each slice is an entry of its own under a key that encodes the name and
the slice (`slice_key`), and such keys, which begin with a 0 byte, are no
tensors of their own.

Data. A tensor's bytes lie in its shard's file at its offset, little-
endian, row-major. A string tensor is stored as the varint lengths of its
elements, the masked CRC32C of those lengths (each taken as a u32 word, a
u64 above 2**32 - 1), then the elements' bytes; its entry's CRC32C
covers those words, the 4 stored bytes and the elements.

`TensorBundle` reads one checkpoint, `checkpoint_prefix` resolves a path as
`tf.train.load_checkpoint` does, `saved_model_variables` gives what
`tf.saved_model.load(dir).variables` holds. Every CRC32C is verified; a
mismatch, a compressed block, a big-endian bundle, an unknown dtype or a
sliced tensor whose slices are absent or do not cover it once raises,
naming the file or the key.
"""

from __future__ import annotations

import codecs
import os
import re
import struct
from typing import (Dict, Iterable, Iterator, List, NamedTuple, Optional,
                    Tuple)

import numpy as np

from human_body_proportion_estimation_tpu_torch.utils.crc32c import crc32c

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
OBJECT_GRAPH_KEY = "_CHECKPOINTABLE_OBJECT_GRAPH"
# TensorFlow's DataType enum -> the numpy type a reader returns (object:
# bytes elements)
DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"),
          4: np.dtype("u1"), 5: np.dtype("<i2"), 6: np.dtype("i1"),
          7: np.dtype(object), 9: np.dtype("<i8"), 10: np.dtype("?"),
          19: np.dtype("<f2")}
DT_STRING = 7


def mask(crc: int) -> int:
    """LevelDB's and TensorFlow's masked CRC32C."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------- #
# protobuf wire format


def _varint(buf, at: int, what: str) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if at >= len(buf):
            raise ValueError(f"{what}: truncated varint")
        b = buf[at]
        at += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, at
        shift += 7
        if shift > 63:
            raise ValueError(f"{what}: varint longer than 64 bits")


def proto_fields(buf, what: str) -> Iterator[Tuple[int, object]]:
    """(field number, value) of each field of a serialized message: an int
    for varint, fixed32 and fixed64 fields, bytes for length-delimited
    ones. `what` names the message in errors."""
    at = 0
    while at < len(buf):
        tag, at = _varint(buf, at, what)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, at = _varint(buf, at, what)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            if at + n > len(buf):
                raise ValueError(f"{what}: truncated field {field}")
            value = int.from_bytes(buf[at:at + n], "little")
            at += n
        elif wire == 2:
            n, at = _varint(buf, at, what)
            if at + n > len(buf):
                raise ValueError(f"{what}: truncated field {field}")
            value = bytes(buf[at:at + n])
            at += n
        else:
            raise ValueError(f"{what}: wire type {wire} of field {field} "
                             "is not read")
        yield field, value


def _message(buf, what: str) -> Dict[int, List]:
    """Every field of a message: field number -> its values in order."""
    out: Dict[int, List] = {}
    for field, value in proto_fields(buf, what):
        out.setdefault(field, []).append(value)
    return out


def _one(msg: Dict[int, List], field: int, default=0):
    """The last value of a singular field (protobuf's rule), or default."""
    return msg[field][-1] if field in msg else default


# --------------------------------------------------------------------- #
# the LevelDB table of `.index`


def _block(data: bytes, handle: bytes, path: str) -> bytes:
    """The contents of the block at `handle` (varint offset, size), its
    trailer checked."""
    offset, at = _varint(handle, 0, path)
    size, _ = _varint(handle, at, path)
    end = offset + size
    if end + 5 > len(data):
        raise ValueError(f"{path}: block at {offset} runs past the end")
    ctype = data[end]
    (stored,) = struct.unpack_from("<I", data, end + 1)
    if mask(crc32c(memoryview(data)[offset:end + 1])) != stored:
        raise ValueError(f"{path}: CRC32C mismatch in the block at {offset}")
    if ctype != 0:
        raise ValueError(f"{path}: the block at {offset} has compression "
                         f"type {ctype}; only uncompressed (0) is read")
    return data[offset:end]


def _block_entries(block: bytes, path: str) -> Iterator[Tuple[bytes, bytes]]:
    if len(block) < 4:
        raise ValueError(f"{path}: a block of {len(block)} bytes")
    (restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 - 4 * restarts
    if limit < 0:
        raise ValueError(f"{path}: {restarts} restarts in a block of "
                         f"{len(block)} bytes")
    at, key = 0, b""
    while at < limit:
        shared, at = _varint(block, at, path)
        fresh, at = _varint(block, at, path)
        n_value, at = _varint(block, at, path)
        if shared > len(key) or at + fresh + n_value > limit:
            raise ValueError(f"{path}: malformed block entry at {at}")
        key = key[:shared] + block[at:at + fresh]
        at += fresh
        yield key, block[at:at + n_value]
        at += n_value


def read_table(path: str) -> List[Tuple[bytes, bytes]]:
    """Every (key, value) of the LevelDB table in the file `path`, in key
    order."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{path}: {len(data)} bytes, shorter than a table "
                         "footer")
    footer = data[-FOOTER_BYTES:]
    (magic,) = struct.unpack_from("<Q", footer, 40)
    if magic != TABLE_MAGIC:
        raise ValueError(f"{path}: not a TensorBundle index (table magic "
                         f"{magic:#018x})")
    _, at = _varint(footer, 0, path)           # the metaindex handle
    _, at = _varint(footer, at, path)
    index = _block(data, footer[at:40], path)
    out = []
    for _, handle in _block_entries(index, path):
        out.extend(_block_entries(_block(data, handle, path), path))
    return out


# --------------------------------------------------------------------- #
# the bundle


class Entry(NamedTuple):
    dtype: int
    shape: Tuple[int, ...]
    shard: int
    offset: int
    size: int
    crc: int
    # a sliced tensor's slices, each as (start, length or -1 for the whole
    # dimension) a dimension; () for a tensor stored whole
    slices: Tuple[Tuple[Tuple[int, int], ...], ...]


def _entry(value: bytes, key: str, path: str) -> Entry:
    what = f"{path}: entry {key!r}"
    msg = _message(value, what)
    dtype = _one(msg, 1)
    if dtype not in DTYPES:
        raise ValueError(f"{path}: {key!r} has TensorFlow dtype {dtype}, "
                         "which is not read")
    dims = _message(_one(msg, 2, b""), what)
    shape = tuple(_one(_message(d, what), 1) for d in dims.get(2, []))
    slices = []
    for sl in msg.get(7, []):
        extents = []
        for ext in _message(sl, what).get(1, []):
            ext = _message(ext, what)
            extents.append((_one(ext, 1), _one(ext, 2, -1)))
        slices.append(tuple(extents))
    return Entry(dtype, shape, _one(msg, 3), _one(msg, 4), _one(msg, 5),
                 _one(msg, 6), tuple(slices))


# the keys of a sliced tensor's slices (TensorFlow's EncodeTensorNameSlice,
# in its OrderedCode encoding)


def _ordered_num(n: int) -> bytes:
    raw = n.to_bytes(8, "big").lstrip(b"\0")
    return bytes([len(raw)]) + raw


# the header bits of a signed number encoded in n bytes, for its first two
_SIGNED_HEADER = [(0, 0), (0x80, 0), (0xC0, 0), (0xE0, 0), (0xF0, 0),
                  (0xF8, 0), (0xFC, 0), (0xFE, 0), (0xFF, 0), (0xFF, 0x80),
                  (0xFF, 0xC0)]


def _ordered_signed(v: int) -> bytes:
    x = ~v if v < 0 else v
    n = 1
    while x >= 1 << (7 * n - 1):
        n += 1
    raw = bytearray((v & ((1 << 80) - 1)).to_bytes(10, "big")[10 - n:])
    raw[0] ^= _SIGNED_HEADER[n][0]
    if n > 1:
        raw[1] ^= _SIGNED_HEADER[n][1]
    return bytes(raw)


def slice_key(name: str, extents: Tuple[Tuple[int, int], ...]) -> bytes:
    """The bundle key of the slice `extents` ((start, length) a dimension,
    length -1 for a whole one) of the tensor `name`."""
    escaped = name.encode("utf-8").replace(b"\xff", b"\xff\x00").replace(
        b"\x00", b"\x00\xff")
    return b"".join([_ordered_num(0), escaped, b"\x00\x01",
                     _ordered_num(len(extents))]
                    + [_ordered_signed(v) for ext in extents for v in ext])


class TensorBundle:
    """One TensorBundle checkpoint, `prefix` without `.index`: its header
    checked and its entries parsed when it is made (`entries`, name ->
    `Entry`, in key order, as TensorFlow's reader lists them; the slices
    of sliced tensors apart); tensors read by `read`."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.index = prefix + ".index"
        rows = read_table(self.index)
        if not rows or rows[0][0] != b"":
            raise ValueError(f"{self.index}: no bundle header")
        header = _message(rows[0][1], f"{self.index}: header")
        if _one(header, 2) != 0:
            raise ValueError(f"{self.index}: a big-endian bundle "
                             f"(endianness {_one(header, 2)}), which is not "
                             "read")
        self.num_shards = _one(header, 1)
        self.entries: Dict[str, Entry] = {}
        self._slices: Dict[bytes, Entry] = {}
        for key, value in rows[1:]:
            if key.startswith(b"\0"):
                self._slices[key] = _entry(value, repr(key), self.index)
            else:
                name = key.decode("utf-8")
                self.entries[name] = _entry(value, name, self.index)

    def shard_path(self, shard: int) -> str:
        return f"{self.prefix}.data-{shard:05d}-of-{self.num_shards:05d}"

    def _pieces(self, name: str) -> List[Tuple[object, Entry]]:
        """(key, entry) of the stored pieces of tensor `name`: itself, or
        each of its slices."""
        ent = self.entries[name]
        if not ent.slices:
            return [(name, ent)]
        if ent.dtype == DT_STRING:
            raise ValueError(f"{self.index}: {name!r} is a sliced string "
                             "tensor, which is not read")
        out = []
        for extents in ent.slices:
            key = slice_key(name, extents)
            if key not in self._slices:
                raise ValueError(f"{self.index}: {name!r} lists the slice "
                                 f"{extents}, which the bundle does not hold")
            out.append((key, self._slices[key]))
        return out

    def read(self, names: Optional[Iterable[str]] = None
             ) -> Dict[str, object]:
        """{name: tensor} of `names` (every entry by default), as
        TensorFlow's `reader.get_tensor` returns them: an array, a numpy
        scalar for a 0-d tensor, `bytes` elements (an `object` array, or
        the `bytes` of a 0-d string); a sliced tensor assembled from its
        slices, which must cover it once. Each shard file is opened once
        and read in offset order; every stored piece's CRC32C is
        checked."""
        names = list(self.entries if names is None else names)
        for name in names:
            if name not in self.entries:
                raise KeyError(f"{self.prefix}: no tensor {name!r}")
        pieces = {name: self._pieces(name) for name in names}
        by_shard: Dict[int, Dict[object, Entry]] = {}
        for key, ent in (p for ps in pieces.values() for p in ps):
            by_shard.setdefault(ent.shard, {})[key] = ent
        got = {}
        for shard, group in sorted(by_shard.items()):
            path = self.shard_path(shard)
            with open(path, "rb") as fh:
                for key, ent in sorted(group.items(),
                                       key=lambda kv: kv[1].offset):
                    fh.seek(ent.offset)
                    raw = bytearray(ent.size)
                    if fh.readinto(raw) != ent.size:
                        raise ValueError(f"{path}: {key!r} runs past the "
                                         "end of the file")
                    got[key] = _decode(key, ent, raw, path)
        out = {}
        for name in names:
            ent = self.entries[name]
            if ent.slices:
                arr = self._assemble(name, ent, pieces[name], got)
            else:
                arr = got[name]
            out[name] = arr[()] if arr.ndim == 0 else arr
        return out

    def _assemble(self, name, ent, pieces, got) -> np.ndarray:
        arr = np.empty(ent.shape, DTYPES[ent.dtype])
        covered = np.zeros(ent.shape, np.uint8)
        for extents, (key, _) in zip(ent.slices, pieces):
            if len(extents) != len(ent.shape):
                raise ValueError(f"{self.index}: a slice of {name!r} has "
                                 f"rank {len(extents)}, the tensor "
                                 f"{len(ent.shape)}")
            where = tuple(slice(s, None if n < 0 else s + n)
                          for s, n in extents)
            if arr[where].shape != got[key].shape:
                raise ValueError(f"{self.index}: the slice {extents} of "
                                 f"{name!r} holds {got[key].shape}")
            arr[where] = got[key]
            covered[where] += 1
        if not (covered == 1).all():
            raise ValueError(f"{self.index}: the slices of {name!r} do not "
                             "cover it once")
        return arr


def _decode(key, ent: Entry, raw: bytearray, path: str) -> np.ndarray:
    """A stored piece's array, its CRC32C and size checked."""
    count = int(np.prod(ent.shape, dtype=np.int64))
    if ent.dtype == DT_STRING:
        return _strings(raw, count, ent.crc, f"{path}: {key!r}").reshape(
            ent.shape)
    if mask(crc32c(raw)) != ent.crc:
        raise ValueError(f"{path}: CRC32C mismatch in {key!r}")
    dtype = DTYPES[ent.dtype]
    if count * dtype.itemsize != ent.size:
        raise ValueError(f"{path}: {key!r} holds {ent.size} bytes, "
                         f"{ent.shape} x {dtype} needs "
                         f"{count * dtype.itemsize}")
    return np.frombuffer(raw, dtype).reshape(ent.shape)


def _strings(raw: bytearray, count: int, crc: int, what: str) -> np.ndarray:
    """A string tensor's elements: varint lengths, their masked CRC32C, the
    bytes; `crc` is the entry's masked CRC32C."""
    lengths, at = [], 0
    for _ in range(count):
        n, at = _varint(raw, at, what)
        lengths.append(n)
    words = b"".join(struct.pack("<I" if n <= 0xFFFFFFFF else "<Q", n)
                     for n in lengths)
    if at + 4 + sum(lengths) != len(raw):
        raise ValueError(f"{what}: the string lengths do not match its "
                         "size")
    stored = raw[at:at + 4]
    running = crc32c(words)
    if mask(running) != struct.unpack("<I", stored)[0]:
        raise ValueError(f"{what}: CRC32C mismatch in the string lengths")
    at += 4
    if mask(crc32c(raw[at:], crc32c(stored, running))) != crc:
        raise ValueError(f"{what}: CRC32C mismatch")
    out = np.empty(count, object)
    for i, n in enumerate(lengths):
        out[i] = bytes(raw[at:at + n])
        at += n
    return out


# --------------------------------------------------------------------- #
# paths


def _model_checkpoint_path(state_file: str) -> str:
    """`model_checkpoint_path` of a `checkpoint` file (a text-format
    CheckpointState)."""
    with open(state_file, encoding="utf-8") as fh:
        text = fh.read()
    found = re.search(r'^\s*model_checkpoint_path\s*:\s*"((?:[^"\\]|\\.)*)"',
                      text, re.M)
    if not found:
        raise ValueError(f"{state_file}: no model_checkpoint_path")
    return codecs.escape_decode(found.group(1).encode("utf-8"))[0].decode(
        "utf-8")


def checkpoint_prefix(path: str) -> str:
    """The checkpoint `path` names, as `tf.train.load_checkpoint` resolves
    it: a prefix (`<path>.index` exists), or a directory whose `checkpoint`
    file names one in `model_checkpoint_path` (relative to the directory
    unless absolute). Raises FileNotFoundError naming the path otherwise."""
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if not os.path.isfile(state):
            raise FileNotFoundError(f"no 'checkpoint' file in the directory "
                                    f"{path}")
        prefix = _model_checkpoint_path(state)
        if not os.path.isabs(prefix):
            prefix = os.path.join(path, prefix)
        if not os.path.isfile(prefix + ".index"):
            raise FileNotFoundError(f"{state} names the checkpoint {prefix}, "
                                    f"which has no {prefix}.index")
        return prefix
    if os.path.isfile(path + ".index"):
        return path
    raise FileNotFoundError(f"no TF checkpoint matches {path} (neither a "
                            f"directory nor a prefix with {path}.index)")


def open_checkpoint(path: str) -> TensorBundle:
    """The bundle of `path` (see `checkpoint_prefix`)."""
    return TensorBundle(checkpoint_prefix(path))


# --------------------------------------------------------------------- #
# SavedModel


def _children(node: Dict[int, List], what: str) -> List[Tuple[str, int]]:
    """(local_name, node_id) of an object's `children`, in order."""
    out = []
    for ref in node.get(1, []):
        msg = _message(ref, what)
        out.append((_one(msg, 2, b"").decode("utf-8"), _one(msg, 1)))
    return out


def meta_graph(export_dir: str) -> Tuple[str, Dict[int, List]]:
    """(the path of `export_dir`'s saved_model.pb, its one MetaGraphDef
    parsed: field number -> values). Several MetaGraphs raise, as
    `tf.saved_model.load` without tags does."""
    pb = os.path.join(export_dir, "saved_model.pb")
    if not os.path.isfile(pb):
        raise FileNotFoundError(f"no SavedModel at {export_dir} (no "
                                "saved_model.pb)")
    with open(pb, "rb") as fh:
        model = _message(fh.read(), pb)
    metas = model.get(2, [])
    if len(metas) != 1:
        raise ValueError(f"{pb}: {len(metas)} MetaGraphs; one is read (as "
                         "tf.saved_model.load without tags)")
    return pb, _message(metas[0], f"{pb}: MetaGraphDef")


def saved_model_variables(export_dir: str) -> List[Tuple[str, object]]:
    """(name, value) of each variable in `tf.saved_model.load(export_dir).
    variables`, in order. A TF2 SavedModel (one with an object graph): the
    root object's tracked child `variables` (a list), each named by its
    `SavedVariable.name` (the part before a ':') and read from
    `variables/variables` through the checkpoint key that the bundle's
    object graph gives the same node id. A TF1 SavedModel (a graph-mode
    export, no object graph): its resource variables, restored through its
    saver's graph and its init op (`tf_graph.variables`). Several
    MetaGraphs raise, as `tf.saved_model.load` without tags does."""
    pb, meta = meta_graph(export_dir)
    if 7 not in meta:
        from human_body_proportion_estimation_tpu_torch.models import (
            tf_graph,
        )

        return tf_graph.variables(export_dir, meta, pb)
    nodes = [_message(n, f"{pb}: SavedObject")
             for n in _message(_one(meta, 7), f"{pb}: object graph").get(
                 1, [])]
    listed = dict(_children(nodes[0], pb)).get("variables")
    if listed is None:
        raise ValueError(f"{pb}: the root object has no 'variables'")
    ids = [i for _, i in _children(nodes[listed], pb)]
    if 7 in nodes[listed] or any(7 not in nodes[i] for i in ids):
        raise ValueError(f"{pb}: the root's 'variables' is not a list of "
                         "variables")
    bundle = TensorBundle(os.path.join(export_dir, "variables", "variables"))
    graph = bundle.read([OBJECT_GRAPH_KEY])[OBJECT_GRAPH_KEY]
    graph_nodes = _message(graph, f"{bundle.prefix}: object graph").get(1, [])
    keys = []
    for i in ids:
        attrs = {}
        for a in _message(graph_nodes[i], bundle.prefix).get(2, []):
            attr = _message(a, bundle.prefix)
            attrs[_one(attr, 1, b"").decode()] = _one(attr, 3, b"").decode()
        if "VARIABLE_VALUE" not in attrs:
            raise ValueError(f"{bundle.prefix}: node {i} of the object graph "
                             "holds no VARIABLE_VALUE")
        keys.append(attrs["VARIABLE_VALUE"])
    values = bundle.read(keys)
    names = [_one(_message(_one(nodes[i], 7), pb), 6, b"").decode("utf-8")
             for i in ids]
    return [(name.split(":")[0], values[key])
            for name, key in zip(names, keys)]
