"""Where the port's compiled programs are kept between processes: the
counterpart of the JAX package's `utils/compile_cache.py` (its persistent
XLA compilation cache).

The port compiles three things at first use: the CUDA kernel library
(`ops/build.py`, nvcc), the native batcher's core (`serve/native.py`,
g++) and the zstd decoder of its Orbax store (`utils/zstd.py`, g++).
Each is built into `ops/build.BUILD_DIR` under a name that hashes its
sources and flags, and a later process that finds the library there
loads it without compiling. That directory is the cache: by default the
package's gitignored `build/`.

`enable(directory)` points the builds at `directory`; `disable()` points
them at a fresh temporary directory of the process, removed at exit, so
that it compiles everything anew (what `--no-compile-cache` means to the
JAX package: no persistent cache, every process compiles). Either must
come before the first build of the process to affect it: a library
already loaded stays loaded.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

from human_body_proportion_estimation_tpu_torch.ops import build

DEFAULT_DIR = build.DEFAULT_BUILD_DIR


def enable(directory: str | None = None) -> str:
    """Build into and load from `directory` (default `DEFAULT_DIR`);
    idempotent. Returns the directory."""
    directory = os.path.abspath(directory or DEFAULT_DIR)
    os.makedirs(directory, exist_ok=True)
    build.BUILD_DIR = directory
    return directory


def disable() -> str:
    """Build into a fresh temporary directory, removed when the process
    exits. Returns it."""
    directory = tempfile.mkdtemp(prefix="hbpe_build_")
    atexit.register(shutil.rmtree, directory, True)
    build.BUILD_DIR = directory
    return directory


def add_flags(parser) -> None:
    """The JAX package's `--compile-cache-dir` / `--no-compile-cache`
    flags, which `apply_flags` applies."""
    parser.add_argument(
        "--compile-cache-dir", default="",
        help="where the CUDA kernels and the native batcher core are built "
             "and found (utils/compile_cache): a restart finds them there "
             "and compiles nothing. Default the package's build/")
    parser.add_argument("--no-compile-cache", action="store_true",
                        help="build them anew into a temporary directory "
                             "of the process")


def apply_flags(args) -> str:
    """The `--compile-cache-dir` / `--no-compile-cache` flags of a parsed
    command line, as the JAX package's CLIs apply them: `disable()` with
    `--no-compile-cache`, else `enable(--compile-cache-dir or default)`.
    Returns the build directory."""
    if getattr(args, "no_compile_cache", False):
        return disable()
    return enable(getattr(args, "compile_cache_dir", None) or None)
