"""Tensor encodings shared by the HTTP `/v2` inference route and the KServe
gRPC service (the JAX package's `serve/kserve_grpc.py:81-160`), in a module
that imports no protobuf: the HTTP edge serves without `grpc` or
`google.protobuf` installed.

  * Triton's BYTES raw framing: <u32 little-endian length><payload>* per
    element (`serialize_bytes_tensor` / `deserialize_bytes_tensor`).
  * Triton's `classification` requested-output parameter
    (`_classification_rows`).
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np


def serialize_bytes_tensor(rows: Sequence[bytes]) -> bytes:
    """Triton BYTES raw framing: <u32 little-endian length><payload>*."""
    out = bytearray()
    for r in rows:
        out += struct.pack("<I", len(r))
        out += r
    return bytes(out)


def deserialize_bytes_tensor(raw: bytes) -> List[bytes]:
    rows, off = [], 0
    while off < len(raw):
        if off + 4 > len(raw):
            raise ValueError("truncated BYTES tensor length prefix")
        (n,) = struct.unpack_from("<I", raw, off)
        off += 4
        if off + n > len(raw):
            raise ValueError("truncated BYTES tensor payload")
        rows.append(raw[off:off + n])
        off += n
    return rows


def _classification_rows(arr: np.ndarray, k: int) -> np.ndarray:
    """Triton's `classification` requested-output parameter: replace the
    output with top-k "value:index" strings per batch row (Triton returns
    "value:index[:label]"; no label files in this repository)."""
    a = np.asarray(arr)
    if a.ndim == 0:
        a = a.reshape(1, 1)
    # float64 view for ranking: unary minus raises on bool_ and wraps on
    # unsigned dtypes, and the wire layer carries both
    rows = a.reshape(a.shape[0], -1).astype(np.float64)
    k = min(k, rows.shape[1])
    # stable: ties resolve to the lowest index, like np.argmax
    idx = np.argsort(-rows, axis=1, kind="stable")[:, :k]
    out = np.empty((rows.shape[0], k), dtype=object)
    for i in range(rows.shape[0]):
        for j in range(k):
            out[i, j] = (
                f"{rows[i, idx[i, j]]:f}:{int(idx[i, j])}".encode()
            )
    return out
