"""CRC32C (Castagnoli), the one checksum of the port's checkpoint readers:
Orbax's OCDBT files (`models/orbax_store.py`) and TensorFlow's TensorBundle
blocks and tensors (`models/tf_bundle.py`).

It runs in `crc32c.cpp` beside this file, compiled with g++ at its first
use into `ops/build.BUILD_DIR` (as `zstd_decompress.cpp` is) and loaded
with ctypes; a failed build raises, with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from human_body_proportion_estimation_tpu_torch.ops import build as _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "crc32c.cpp")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The checksum library, compiled at the first call (once per source)."""
    lib = ctypes.CDLL(_build.build_cxx_library(SOURCE, "libhbpe_crc32c"))
    lib.hbpe_crc32c_extend.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                       ctypes.c_size_t]
    lib.hbpe_crc32c_extend.restype = ctypes.c_uint32
    return lib


def crc32c(data, crc: int = 0) -> int:
    """The CRC32C of `data` (a contiguous bytes-like object or array); with
    `crc`, that of the bytes whose CRC32C it is followed by `data`."""
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(data,
                                                                  np.uint8)
    if not arr.flags.c_contiguous:
        raise ValueError("crc32c: the buffer must be contiguous")
    return load_library().hbpe_crc32c_extend(crc, arr.ctypes.data,
                                             arr.nbytes)
