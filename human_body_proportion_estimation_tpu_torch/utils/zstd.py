"""zstd frames for the port's Orbax store (`models/orbax_store.py`).

Decoding goes through `zstd_decompress.cpp` beside this file, a decoder of
RFC 8878 frames written for this package (no dictionaries). It is compiled
with g++ at its first use into `ops/build.BUILD_DIR` (the package's
gitignored `build/`) under a name that hashes the source and the flags,
and loaded with ctypes; a failed build or a malformed frame raises, with
the reason. One call decodes a whole value into a numpy buffer sized from
the frame header's content size or, where the header declares none, by
the caller (a zarr chunk's byte count); an OCDBT node, whose frame
declares no size, decodes into a buffer that grows.

`frame` writes a frame of raw blocks (at most 128 KiB each) with the
content size in its header: valid zstd that every reader accepts, and
what the store writes.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Optional

import numpy as np

from human_body_proportion_estimation_tpu_torch.ops import build as _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "zstd_decompress.cpp")
MAGIC = 0xFD2FB528
BLOCK_MAX = 1 << 17

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The decoder, compiled at the first call (once per source)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.build_cxx_library(SOURCE,
                                                       "libhbpe_zstd"))
            p, n = ctypes.c_void_p, ctypes.c_size_t
            lib.hbpe_zstd_decompress.argtypes = [p, n, p, n, ctypes.c_char_p,
                                                 n]
            lib.hbpe_zstd_decompress.restype = ctypes.c_int64
            lib.hbpe_zstd_decompress_alloc.argtypes = [
                p, n, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, n]
            lib.hbpe_zstd_decompress_alloc.restype = ctypes.c_int64
            lib.hbpe_zstd_free.argtypes = [p]
            lib.hbpe_zstd_free.restype = None
            lib.hbpe_zstd_content_size.argtypes = [p, n, ctypes.c_char_p, n]
            lib.hbpe_zstd_content_size.restype = ctypes.c_int64
            _lib = lib
    return _lib


def _address(buf) -> tuple:
    """(address, bytes, the array to keep alive) of a contiguous
    bytes-like object or array."""
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
        else buf
    if not arr.flags.c_contiguous:
        raise ValueError("zstd: the buffer must be contiguous")
    return arr.ctypes.data, arr.nbytes, arr


def content_size(src) -> Optional[int]:
    """The sum of the declared content sizes of the frames in `src`, or
    None when a frame does not declare its size."""
    addr, n, keep = _address(src)
    err = ctypes.create_string_buffer(256)
    got = load_library().hbpe_zstd_content_size(addr, n, err, len(err))
    if got == -2:
        return None
    if got < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    return int(got)


def decompress_into(src, out: np.ndarray) -> None:
    """Decode the frames of `src` into the contiguous array `out`, which
    they must fill exactly."""
    addr, n, keep = _address(src)
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("zstd: the output must be a contiguous, writable "
                         "array")
    err = ctypes.create_string_buffer(256)
    got = load_library().hbpe_zstd_decompress(addr, n, out.ctypes.data,
                                              out.nbytes, err, len(err))
    if got < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    if got != out.nbytes:
        raise ValueError(f"zstd: the frames hold {got} bytes, "
                         f"{out.nbytes} were expected")


def decompress(src, size: Optional[int] = None) -> np.ndarray:
    """The decoded bytes of `src` (uint8). With `size`, or where the frames
    declare their content size, they are decoded into a buffer of that
    size, which they must fill; else into one that grows."""
    if size is None:
        size = content_size(src)
    if size is not None:
        out = np.empty(size, np.uint8)
        decompress_into(src, out)
        return out
    addr, n, keep = _address(src)
    err = ctypes.create_string_buffer(256)
    lib = load_library()
    dst = ctypes.c_void_p()
    got = lib.hbpe_zstd_decompress_alloc(addr, n, ctypes.byref(dst), err,
                                         len(err))
    if got < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return np.frombuffer(ctypes.string_at(dst, got), np.uint8)
    finally:
        lib.hbpe_zstd_free(dst)


def frame(data) -> bytes:
    """One zstd frame of raw blocks holding `data` (bytes-like): single
    segment, the content size in 8 bytes, no checksum."""
    view = memoryview(data).cast("B")
    parts = [struct.pack("<IBQ", MAGIC, 0xE0, len(view))]
    for at in range(0, max(len(view), 1), BLOCK_MAX):
        block = view[at:at + BLOCK_MAX]
        last = at + BLOCK_MAX >= len(view)
        parts.append(struct.pack("<I", (len(block) << 3) | last)[:3])
        parts.append(block)
    return b"".join(parts)
