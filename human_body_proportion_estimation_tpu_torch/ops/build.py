"""Build and load the port's CUDA kernels (`csrc/*.cu`), and the C++
libraries the port compiles with g++ (`build_cxx_library`).

Each source is compiled by its own `nvcc` process, all started together,
into an object for `sm_90a` (headers shared between them are
`csrc/*.cuh`); the objects are linked into one shared library with a plain
C interface, loaded with `ctypes`. The build goes into `BUILD_DIR`:
`build/` beside this package (listed in `.gitignore`) unless
`utils/compile_cache` points it elsewhere, under a name that hashes the
sources and flags, so an edited source is never served from a stale
library. Nothing here runs at import time: the first kernel launch calls
`load_library()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
DEFAULT_BUILD_DIR = os.path.join(PKG_DIR, "build")
# where the kernel library and the native serving core are built and found
# (`utils/compile_cache.enable` repoints it; read at each build)
BUILD_DIR = DEFAULT_BUILD_DIR

CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]


def sources() -> List[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cu")
    )


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "csrc/ at first use"
    )


def _digest(srcs: List[str]) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh")
    )
    for s in srcs + headers:
        with open(s, "rb") as fh:
            h.update(os.path.basename(s).encode())
            h.update(fh.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile every `csrc/*.cu` (in parallel) and link one `.so`; returns
    its path. Reuses a library already built from identical sources."""
    srcs = sources()
    lib_path = os.path.join(BUILD_DIR, f"libhbpe_kernels_{_digest(srcs)}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for s in srcs:
            obj = os.path.join(tmp, os.path.basename(s) + ".o")
            objs.append(obj)
            procs.append((s, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", s, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for s, p in procs:
            out, _ = p.communicate()
            if verbose and out:
                print(f"[nvcc {os.path.basename(s)}]\n{out}", flush=True)
            if p.returncode != 0:
                failed.append(f"{s}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, "lib.so")
        subprocess.run(
            [nvcc, "-shared", "-o", tmp_lib, *objs, "-lcudart"],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp_lib, lib_path)
    return lib_path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source digest) and load the kernel library, with the
    argument types of every C entry point declared."""
    lib = ctypes.CDLL(build())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hbpe_decode_heatmaps.argtypes = [p, p, p, i, i, i, p]
    lib.hbpe_nms_sweep.argtypes = [p, p, p, i, i, f, i, p]
    # level arrays (z pointers, rows, cells, first columns) and their count,
    # packed weights and bias, best, person, then out_stride, F, A and the
    # stream
    lib.hbpe_head_score_levels.argtypes = [
        p, p, p, p, i, p, p, p, p, i, i, i, p]
    lib.hbpe_empty_launch.argtypes = [i, i, p]
    lib.hbpe_nms_launch_shape.argtypes = [p, p]
    lib.hbpe_nms_launch_shape.restype = None
    for fn in (lib.hbpe_decode_heatmaps, lib.hbpe_nms_sweep,
               lib.hbpe_head_score_levels, lib.hbpe_empty_launch):
        fn.restype = ctypes.c_int
    return lib


def cxx_library_path(source: str, stem: str,
                     build_dir: str | None = None) -> str:
    """Where the library built from `source` with `CXX_FLAGS` lives (in
    `BUILD_DIR` by default): `<stem>_<hash of flags and source>.so`."""
    build_dir = build_dir or BUILD_DIR
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(source, "rb") as fh:
        h.update(fh.read())
    return os.path.join(build_dir, f"{stem}_{h.hexdigest()[:16]}.so")


def build_cxx_library(source: str, stem: str,
                      build_dir: str | None = None) -> str:
    """Compile one C++ source into a shared library with g++ (`$CXX` if
    set) unless a library built from the same source and flags is there;
    returns its path. A failed build raises with the compiler's output."""
    build_dir = build_dir or BUILD_DIR
    path = cxx_library_path(source, stem, build_dir)
    if os.path.exists(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"g++ not found: {os.path.basename(source)} is "
                           "built at first use")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = os.path.join(tmp, "lib.so")
        done = subprocess.run([cxx, *CXX_FLAGS, "-o", out, source],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed on {source}:\n{done.stderr}")
        os.replace(out, path)
    return path


def timed_build(verbose: bool = False) -> float:
    """Build + load from scratch-or-cache; returns the seconds it took."""
    t0 = time.perf_counter()
    build(verbose=verbose)
    load_library()
    return time.perf_counter() - t0
