"""Orbax PyTree checkpoints, read and written with numpy and `struct`.

What the JAX package's `orbax.checkpoint.PyTreeCheckpointer` writes (with
`use_ocdbt` and zarr v2, its defaults): a directory with `_METADATA` (the
tree as JSON) and an OCDBT key-value store, in which every leaf is a zarr
v2 array named by its '.'-joined keys: `<name>/.zarray` (JSON) and its
chunks `<name>/0.0`, each a zstd frame.

OCDBT (tensorstore's format). `manifest.ocdbt` and the B-tree nodes share
one file layout: magic (u32 big-endian: 0x0cdb3a2a a manifest, 0x0cdb20de
a node), the file's length (u64 little-endian), a format version (varint,
0), a compression (varint: 0 none, 1 zstd), the body, and the CRC32C of
all before it (u32 little-endian). Nodes are byte ranges of data files
(`d/<id>`, header-less), which also hold the values larger than
`max_inline_value_bytes`; smaller ones sit in the leaf nodes. Every list
in a body is stored column by column. Paths in a data-file table are
relative to the directory of the manifest, after the base path of the
file the table was read from (Orbax's root manifest reaches the files of
its per-process layer, `ocdbt.process_0/d/...`, that way). A key in a
node is stored after the prefix its parent's entry strips
(`subtree_common_prefix_length`) and after the part it shares with the
key before it. The newest version is always among the manifest's own
versions; the version-tree nodes it also lists hold older ones, which a
checkpoint reader never needs.

Read: `read_kvstore` (every key of the newest version: the B-tree walked
from the root, each data file opened once and read range by range in file
order), `load_tree` (the checkpoint's tree: numpy arrays; `bfloat16`
leaves, which numpy has no type for, as torch tensors). Every CRC32C is
verified; a mismatch, or a field this reader does not know, raises and
names it. Write: `save_tree` writes one store: a manifest, the B-tree's
leaf nodes split under `max_decoded_node_bytes` (interior nodes above
them when there are several) and one data file; zarr leaves of one chunk,
zstd frames of raw blocks (`utils/zstd.frame`). The directory is replaced
whole (Orbax's `force=True`), by a rename of a complete copy.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import struct
import tempfile
import time
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.utils import zstd
# only manifests and nodes carry a CRC32C
from human_body_proportion_estimation_tpu_torch.utils.crc32c import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
# Orbax's store settings (tensorstore's defaults: 100 inline bytes, 8 MiB
# nodes)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


# --------------------------------------------------------------------- #
# encoding helpers


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.at, self.what = data, 0, what

    def fail(self, msg: str):
        raise ValueError(f"OCDBT {self.what}: {msg}")

    def byte(self) -> int:
        if self.at >= len(self.data):
            self.fail("truncated")
        self.at += 1
        return self.data[self.at - 1]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            self.fail("truncated")
        self.at += n
        return self.data[self.at - n:self.at]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self):
        if self.at != len(self.data):
            self.fail(f"{len(self.data) - self.at} bytes after the end")


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


def _unwrap(blob: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file, its checksum verified."""
    if len(blob) < 18:
        raise ValueError(f"OCDBT {what}: {len(blob)} bytes, too short")
    got_magic, length = struct.unpack(">I", blob[:4])[0], \
        struct.unpack("<Q", blob[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"OCDBT {what}: magic {got_magic:#010x}, "
                         f"expected {magic:#010x}")
    if length != len(blob):
        raise ValueError(f"OCDBT {what}: header length {length}, the file "
                         f"holds {len(blob)} bytes")
    want = struct.unpack("<I", blob[-4:])[0]
    got = crc32c(blob[:-4])
    if got != want:
        raise ValueError(f"OCDBT {what}: CRC32C mismatch (stored "
                         f"{want:#010x}, computed {got:#010x})")
    r = _Reader(blob[:-4], what)
    r.at = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        r.fail(f"format version {version}")
    body = blob[r.at:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body).tobytes()
    r.fail(f"compression {compression}")


def _wrap(body: bytes, magic: int) -> bytes:
    """A manifest or node file around `body` (zstd, raw blocks)."""
    payload = _varint(0) + _varint(1) + zstd.frame(body)
    head = struct.pack(">I", magic) + struct.pack(
        "<Q", 4 + 8 + len(payload) + 4)
    blob = head + payload
    return blob + struct.pack("<I", crc32c(blob))


# --------------------------------------------------------------------- #
# reader


def _read_file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """[(path, base path)] of a data-file table, both relative to the
    store's directory; `base` is the base path of the file read."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base_len[i] > prefix[i] + suffix[i]:
            r.fail("malformed data-file table")
        path = prev[:prefix[i]] + r.take(suffix[i])
        prev = path
        out.append((base + path.decode(), base + path[:base_len[i]].decode()))
    return out


def _refs(r: _Reader, n: int, table: List[Tuple[str, str]]):
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    for i in ids:
        if i >= len(table):
            r.fail(f"data file {i} not in the table of {len(table)}")
    return [(table[i], o, n_) for i, o, n_ in zip(ids, offsets, lengths)]


def _read_config(r: _Reader) -> Dict[str, Any]:
    cfg = {"uuid": r.take(16).hex(), "manifest_kind": r.varint(),
           "max_inline_value_bytes": r.varint(),
           "max_decoded_node_bytes": r.varint(),
           "version_tree_arity_log2": r.byte()}
    method = r.varint()
    if method == 0:
        cfg["compression"] = None
    elif method == 1:
        cfg["compression"] = {"id": "zstd", "level": struct.unpack(
            "<i", r.take(4))[0]}
    else:
        r.fail(f"compression method {method}")
    return cfg


def read_manifest(directory: str) -> Dict[str, Any]:
    """The manifest's config and the newest version of the store:
    {'config', 'generation', 'root': ((path, base), offset, length) or
    None for an empty store, 'height', 'num_keys'}."""
    with open(os.path.join(directory, "manifest.ocdbt"), "rb") as fh:
        body = _unwrap(fh.read(), MANIFEST_MAGIC, "manifest")
    r = _Reader(body, "manifest")
    cfg = _read_config(r)
    if cfg["manifest_kind"] != 0:
        r.fail(f"manifest kind {cfg['manifest_kind']} (numbered "
               "manifests are not supported)")
    table = _read_file_table(r, "")
    n = r.varint()
    generation = r.varints(n)
    height = list(r.take(n))
    roots = _refs(r, n, table)
    num_keys = r.varints(n)
    r.varints(n)   # bytes of each version's tree
    r.varints(n)   # bytes of its indirect values
    r.u64s(n)      # commit times
    # version-tree nodes (older versions): generation, location, number of
    # generations, commit time, height
    m = r.varint()
    r.varints(m)
    _refs(r, m, table)
    r.varints(m)
    r.u64s(m)
    r.take(m)
    r.end()
    if not n:
        r.fail("no version")
    last = max(range(n), key=generation.__getitem__)
    return {"config": cfg, "generation": generation[last],
            "root": roots[last] if num_keys[last] else None,
            "height": height[last], "num_keys": num_keys[last]}


def _read_range(directory: str, path: str, offset: int, length: int) -> bytes:
    with open(os.path.join(directory, path), "rb") as fh:
        fh.seek(offset)
        data = fh.read(length)
    if len(data) != length:
        raise ValueError(f"OCDBT: {path} holds no {length} bytes at "
                         f"{offset}")
    return data


def _walk(directory: str, ref, height: int, prefix: bytes,
          inline: Dict[bytes, bytes], indirect: Dict[bytes, Tuple]):
    """Collect the entries of the subtree at `ref`: inline values, and
    indirect ones as ((path, base), offset, length)."""
    (path, base), offset, length = ref
    what = f"node {path}@{offset}"
    body = _unwrap(_read_range(directory, path, offset, length), NODE_MAGIC,
                   what)
    r = _Reader(body, what)
    if r.byte() != height:
        r.fail(f"height differs from its parent's entry ({height})")
    table = _read_file_table(r, base)
    n = r.varint()
    if n == 0:
        r.fail("no entries")
    shared = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    scpl = r.varints(n) if height else None
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            r.fail("key prefix longer than the key before it")
        key = prev[:shared[i]] + r.take(suffix[i])
        keys.append(key)
        prev = key
    if height == 0:
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            r.fail(f"value kind {max(kinds)}")
        k = sum(kinds)
        ids, offsets = r.varints(k), r.varints(k)
        it = iter(zip(ids, offsets))
        for key, n_bytes, kind in zip(keys, lengths, kinds):
            full = prefix + key
            if kind:
                i, o = next(it)
                if i >= len(table):
                    r.fail(f"data file {i} not in the table")
                indirect[full] = (table[i], o, n_bytes)
            else:
                inline[full] = r.take(n_bytes)
        r.end()
        return
    children = _refs(r, n, table)
    r.varints(n)   # keys under each child
    r.varints(n)   # bytes of its nodes
    r.varints(n)   # bytes of its indirect values
    r.end()
    for key, s, child in zip(keys, scpl, children):
        if s > len(key):
            r.fail("subtree prefix longer than its key")
        _walk(directory, child, height - 1, prefix + key[:s], inline,
              indirect)


def read_kvstore(directory: str) -> Dict[bytes, bytes]:
    """Every key of the newest version of the OCDBT store in `directory`
    and its value."""
    directory = os.path.abspath(directory)
    manifest = read_manifest(directory)
    inline: Dict[bytes, bytes] = {}
    indirect: Dict[bytes, Tuple] = {}
    if manifest["root"] is not None:
        _walk(directory, manifest["root"], manifest["height"], b"", inline,
              indirect)
    by_file: Dict[str, List[Tuple[int, int, bytes]]] = {}
    for key, ((path, _), offset, length) in indirect.items():
        by_file.setdefault(path, []).append((offset, length, key))
    values = dict(inline)
    for path, ranges in by_file.items():
        ranges.sort()
        with open(os.path.join(directory, path), "rb") as fh:
            for offset, length, key in ranges:
                fh.seek(offset)
                data = fh.read(length)
                if len(data) != length:
                    raise ValueError(f"OCDBT: {path} holds no {length} "
                                     f"bytes at {offset}")
                values[key] = data
    if len(values) != manifest["num_keys"]:
        raise ValueError(f"OCDBT: {len(values)} keys read, the manifest "
                         f"counts {manifest['num_keys']}")
    return values


# --------------------------------------------------------------------- #
# zarr v2


# zarr dtype -> (numpy storage type, whether it is bfloat16 bits)
_DTYPES = {"<f4": np.float32, "<f2": np.float16, "<f8": np.float64,
           "<i4": np.int32, "<i8": np.int64, "|b1": np.bool_,
           "|u1": np.uint8, "bfloat16": np.uint16}


def _fill(value, dtype: str):
    if value is None:
        return 0
    if isinstance(value, str):
        value = {"NaN": math.nan, "Infinity": math.inf,
                 "-Infinity": -math.inf}[value]
    if dtype == "bfloat16":
        return int(torch.tensor(value, dtype=torch.bfloat16).view(
            torch.int16).item()) & 0xFFFF
    return value


def _zarr_array(name: str, values: Mapping[bytes, bytes]):
    """The zarr v2 array `name` of a store's values: a numpy array, or a
    torch bfloat16 tensor."""
    raw = values.get(f"{name}/.zarray".encode())
    if raw is None:
        raise KeyError(f"{name}: no .zarray in the store")
    meta = json.loads(raw)

    def bad(field):
        raise ValueError(f"zarr array {name}: {field} "
                         f"{meta.get(field)!r} is not supported")

    if meta.get("zarr_format") != 2:
        bad("zarr_format")
    if meta.get("order") != "C":
        bad("order")
    if meta.get("filters"):
        bad("filters")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        bad("compressor")
    dtype = meta.get("dtype")
    if dtype not in _DTYPES:
        bad("dtype")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        bad("dimension_separator")
    np_dtype = np.dtype(_DTYPES[dtype])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape):
        bad("chunks")
    chunk_bytes = math.prod(chunks) * np_dtype.itemsize

    def decode(data, out: np.ndarray):
        if comp is None:
            if len(data) != chunk_bytes:
                raise ValueError(f"zarr array {name}: a chunk of "
                                 f"{len(data)} bytes, {chunk_bytes} expected")
            out.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
        else:
            zstd.decompress_into(data, out.reshape(-1).view(np.uint8))

    out = np.empty(shape, np_dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    if not shape:
        grid_keys = [((), "0")]
    else:
        grid_keys = [(idx, sep.join(map(str, idx)))
                     for idx in np.ndindex(*grid)]
    whole = grid == [1] * len(shape) and chunks == shape
    for idx, ckey in grid_keys:
        data = values.get(f"{name}/{ckey}".encode())
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        if data is None:
            out[region] = _fill(meta.get("fill_value"), dtype)
        elif whole:
            decode(data, out)
        else:
            chunk = np.empty(chunks, np_dtype)
            decode(data, chunk)
            out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                      for r in region)]
    if dtype == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _leaf_bytes(leaf) -> Tuple[np.ndarray, str]:
    """(contiguous numpy array of the leaf's bytes, zarr dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:   # (np.ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    if arr.dtype.name == "bfloat16":   # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    for zarr_dtype, np_dtype in _DTYPES.items():
        if arr.dtype == np_dtype and zarr_dtype != "bfloat16":
            return arr, zarr_dtype
    raise ValueError(f"dtype {arr.dtype} has no zarr v2 name here")


# --------------------------------------------------------------------- #
# writer


def _encode_leaf(entries, prefix: bytes, table_body: bytes) -> bytes:
    """A leaf node (height 0) of [(key, inline bytes or (offset, length))]
    with keys stored after `prefix`."""
    keys = [k[len(prefix):] for k, _ in entries]
    shared = [_common_prefix(a, b) for a, b in zip(keys, keys[1:])]
    out = [b"\x00", table_body, _varint(len(keys)), _varints(shared),
           _varints(len(k) - s for k, s in zip(keys, [0] + shared))]
    out += [k[s:] for k, s in zip(keys, [0] + shared)]
    lengths, kinds, offsets, inline = [], [], [], []
    for _, v in entries:
        if isinstance(v, tuple):
            lengths.append(v[1])
            kinds.append(1)
            offsets.append(v[0])
        else:
            lengths.append(len(v))
            kinds.append(0)
            inline.append(v)
    out += [_varints(lengths), _varints(kinds),
            _varints([0] * len(offsets)), _varints(offsets)]
    return b"".join(out + inline)


def _encode_interior(children, height: int, prefix: bytes,
                     table_body: bytes) -> bytes:
    """An interior node of [child dict] (first key, prefix, location and
    counts of each) with keys stored after `prefix`."""
    keys = [c["first"][len(prefix):] for c in children]
    shared = [_common_prefix(a, b) for a, b in zip(keys, keys[1:])]
    out = [bytes([height]), table_body, _varint(len(keys)), _varints(shared),
           _varints(len(k) - s for k, s in zip(keys, [0] + shared)),
           _varints(len(c["prefix"]) - len(prefix) for c in children)]
    out += [k[s:] for k, s in zip(keys, [0] + shared)]
    out += [_varints([0] * len(children)),
            _varints(c["offset"] for c in children),
            _varints(c["length"] for c in children),
            _varints(c["num_keys"] for c in children),
            _varints(c["tree_bytes"] for c in children),
            _varints(c["indirect_bytes"] for c in children)]
    return b"".join(out)


def _groups(sizes: List[int], limit: int) -> List[Tuple[int, int]]:
    """Consecutive [start, stop) runs whose sizes sum to at most `limit`
    (an item larger than `limit` alone)."""
    runs, start, total = [], 0, 0
    for i, s in enumerate(sizes):
        if i > start and total + s > limit:
            runs.append((start, i))
            start, total = i, 0
        total += s
    if sizes:
        runs.append((start, len(sizes)))
    return runs


def write_kvstore(directory: str, items: Mapping[bytes, bytes], *,
                  max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES
                  ) -> None:
    """Write `items` as a new OCDBT store (one version) into the empty
    directory `directory`: values above `MAX_INLINE_VALUE_BYTES` and then
    the B-tree's nodes in one data file, `manifest.ocdbt` last."""
    if not items:
        raise ValueError("OCDBT: an empty store is not written")
    file_id = os.urandom(16).hex()
    data_path = f"d/{file_id}"
    table_body = _varint(1) + _varint(len(data_path)) + _varint(0) + \
        data_path.encode()
    data: List[bytes] = []
    size = 0
    entries = []
    for key in sorted(items):
        value = items[key]
        if len(value) > MAX_INLINE_VALUE_BYTES:
            entries.append((key, (size, len(value))))
            data.append(value)
            size += len(value)
        else:
            entries.append((key, value))

    def put(blob: bytes) -> Tuple[int, int]:
        nonlocal size
        data.append(blob)
        size += len(blob)
        return size - len(blob), len(blob)

    # one level of nodes after another, bottom up
    level = []
    costs = [len(k) + (len(v) if isinstance(v, bytes) else 0) + 24
             for k, v in entries]
    for start, stop in _groups(costs, max_decoded_node_bytes):
        part = entries[start:stop]
        level.append({"entries": part, "first": part[0][0],
                      "last": part[-1][0], "num_keys": len(part),
                      "indirect_bytes": sum(v[1] for _, v in part
                                            if isinstance(v, tuple))})
    height = 0
    while True:
        root = len(level) == 1
        for node in level:
            node["prefix"] = b"" if root else node["first"][:_common_prefix(
                node["first"], node["last"])]
            if height == 0:
                body = _encode_leaf(node["entries"], node["prefix"],
                                    table_body)
            else:
                body = _encode_interior(node["children"], height,
                                        node["prefix"], table_body)
            node["offset"], node["length"] = put(_wrap(body, NODE_MAGIC))
            node["tree_bytes"] = node["length"] + sum(
                c["tree_bytes"] for c in node.get("children", ()))
        if root:
            break
        costs = [len(n["first"]) + 40 for n in level]
        level = [{"children": level[a:b], "first": level[a]["first"],
                  "last": level[b - 1]["last"],
                  "num_keys": sum(c["num_keys"] for c in level[a:b]),
                  "indirect_bytes": sum(c["indirect_bytes"]
                                        for c in level[a:b])}
                 for a, b in _groups(costs, max_decoded_node_bytes)]
        height += 1
    os.makedirs(os.path.join(directory, "d"))
    with open(os.path.join(directory, data_path), "wb") as fh:
        fh.writelines(data)
    (node,) = level
    config = (os.urandom(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(max_decoded_node_bytes)
              + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(1)
              + struct.pack("<i", 0))
    version = table_body + _varint(1) + _varint(1) + bytes([height]) + \
        _varints([0, node["offset"], node["length"], node["num_keys"],
                  node["tree_bytes"], node["indirect_bytes"]])
    manifest = config + version + struct.pack("<Q", time.time_ns()) + \
        _varint(0)
    with open(os.path.join(directory, "manifest.ocdbt"), "wb") as fh:
        fh.write(_wrap(manifest, MANIFEST_MAGIC))


# --------------------------------------------------------------------- #
# PyTree checkpoints


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    """(keys, leaf) of a nested dict in sorted key order (JAX's flatten
    order)."""
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            yield from _flatten(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def load_tree(directory: str) -> Dict[str, Any]:
    """The tree of one Orbax PyTree checkpoint directory, as the JAX
    package's `PyTreeCheckpointer().restore` gives it: nested dicts of
    numpy arrays (torch tensors for `bfloat16` leaves; Python numbers for
    leaves saved as scalars)."""
    with open(os.path.join(directory, "_METADATA")) as fh:
        meta = json.load(fh)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{directory}: only OCDBT stores of zarr v2 arrays "
                         "are read (use_ocdbt true, use_zarr3 false)")
    values = read_kvstore(directory)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = []
        for k in entry["key_metadata"]:
            if k.get("key_type", 2) != 2:
                raise ValueError(f"{directory}: key_type {k['key_type']} "
                                 "(only dict keys are read)")
            keys.append(str(k["key"]))
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        leaf = _zarr_array(".".join(keys), values)
        if entry["value_metadata"].get("value_type") == "scalar":
            leaf = leaf.item()   # a Python number, as Orbax restores it
        node[keys[-1]] = leaf
    return tree


def save_tree(directory: str, tree: Mapping[str, Any]) -> None:
    """Write a nested dict of arrays (numpy, or torch tensors) as the Orbax
    PyTree checkpoint the JAX package writes, replacing `directory`."""
    directory = os.path.abspath(directory)
    items: Dict[bytes, bytes] = {}
    tree_meta = {}
    for keys, leaf in _flatten(tree):
        arr, dtype = _leaf_bytes(leaf)
        name = ".".join(keys)
        zarray = {"chunks": list(arr.shape),
                  "compressor": {"id": "zstd", "level": 1},
                  "dimension_separator": ".", "dtype": dtype,
                  "fill_value": None, "filters": None, "order": "C",
                  "shape": list(arr.shape), "zarr_format": 2}
        items[f"{name}/.zarray".encode()] = json.dumps(
            zarray, separators=(",", ":")).encode()
        chunk = ".".join("0" * arr.ndim) if arr.ndim else "0"
        items[f"{name}/{chunk}".encode()] = zstd.frame(
            arr.reshape(-1).view(np.uint8))
        tree_meta[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    parent = os.path.dirname(directory)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(directory)}.",
                           dir=parent)
    try:
        write_kvstore(tmp, items)
        with open(os.path.join(tmp, "_METADATA"), "w") as fh:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, fh)
        if os.path.exists(directory):
            old = tmp + ".old"
            os.rename(directory, old)
            os.rename(tmp, directory)
            shutil.rmtree(old)
        else:
            os.rename(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
