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
