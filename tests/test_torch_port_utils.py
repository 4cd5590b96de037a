"""The port's `utils/compile_cache.py` and `utils/profiling.py`, the
counterparts of the JAX package's tests/test_compile_cache.py and
tests/test_profiling.py.

The port's compiled programs are the CUDA kernel library (nvcc, not on
this machine) and the native batcher's core (g++): `enable` repoints
where both are built and found, and a second build in the same directory
compiles nothing.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from human_body_proportion_estimation_tpu_torch.ops import build
from human_body_proportion_estimation_tpu_torch.serve import native
from human_body_proportion_estimation_tpu_torch.utils import (
    compile_cache,
    profiling,
)


@pytest.fixture
def build_dir(monkeypatch):
    """Puts the process's build directory back after the test."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)


def test_enable_repoints_both_builds_and_is_idempotent(tmp_path, build_dir):
    d = str(tmp_path / "cache")
    assert compile_cache.enable(d) == d
    assert compile_cache.enable(d) == d
    assert os.path.isdir(d) and build.BUILD_DIR == d
    assert os.path.dirname(native.library_path()) == d
    digest = build._digest(build.sources())
    assert not os.path.exists(os.path.join(d, f"libhbpe_kernels_{digest}.so"))
    # the native core is compiled into the directory once; a second build
    # (a restarted server) finds it there
    path = native.build_library()
    assert os.path.dirname(path) == d and os.listdir(d) == [
        os.path.basename(path)]
    mtime = os.stat(path).st_mtime_ns
    assert native.build_library() == path
    assert os.stat(path).st_mtime_ns == mtime


def test_enable_defaults_to_the_package_build_dir(build_dir):
    pkg_build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(build.__file__))), "build")
    assert compile_cache.DEFAULT_DIR == pkg_build
    assert compile_cache.enable() == pkg_build == build.BUILD_DIR


def test_kernel_build_goes_to_the_enabled_dir(tmp_path, build_dir,
                                              monkeypatch):
    """`build.build()` writes the kernel library under the enabled
    directory and, once it is there, runs no nvcc."""
    d = compile_cache.enable(str(tmp_path / "kernels"))
    runs = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            runs.append(cmd)
            open(cmd[-1], "wb").close()
            self.returncode = 0

        def communicate(self):
            return "", None

    def fake_run(cmd, **kw):
        runs.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()

    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    path = build.build()
    assert os.path.dirname(path) == d and os.path.exists(path)
    assert len(runs) == len(build.sources()) + 1   # one nvcc a source + link
    monkeypatch.setattr(build, "find_nvcc", None)  # a rebuild would fail
    assert build.build() == path
    assert len(runs) == len(build.sources()) + 1


def test_disable_builds_into_a_fresh_temporary_dir(build_dir):
    first = compile_cache.disable()
    second = compile_cache.disable()
    assert first != second and build.BUILD_DIR == second
    assert os.path.isdir(second) and os.listdir(second) == []
    assert os.path.dirname(native.library_path()) == second


@pytest.mark.parametrize("argv,want", [
    ([], None),
    (["--compile-cache-dir", "CACHE"], "CACHE"),
    (["--compile-cache-dir", "CACHE", "--no-compile-cache"], "temporary"),
])
def test_server_flag_wires_cache(argv, want, tmp_path, build_dir,
                                 monkeypatch):
    """The server applies --compile-cache-dir / --no-compile-cache before
    any model is built (here: before a missing artifact directory
    fails)."""
    from human_body_proportion_estimation_tpu_torch.serve import server

    argv = [str(tmp_path / "cache") if a == "CACHE" else a for a in argv]
    with pytest.raises(FileNotFoundError):
        server.main(["--artifact-dir", str(tmp_path / "missing"),
                     "--grpc-port", "0", *argv])
    if want is None:
        assert build.BUILD_DIR == compile_cache.DEFAULT_DIR
    elif want == "temporary":
        assert os.path.basename(build.BUILD_DIR).startswith("hbpe_build_")
    else:
        assert build.BUILD_DIR == str(tmp_path / "cache")


@pytest.mark.parametrize("module", ["args", "certify", "certify_bottomup",
                                    "evaluate", "export_artifact"])
def test_cli_flags_reach_compile_cache(module, tmp_path, build_dir,
                                       monkeypatch):
    """Every CLI that takes the JAX package's cache flags applies them
    (`compile_cache.apply_flags`) before it builds a model."""
    import importlib

    calls = []
    monkeypatch.setattr(compile_cache, "apply_flags",
                        lambda args: calls.append(
                            (args.compile_cache_dir, args.no_compile_cache))
                        or "x")
    flags = ["--compile-cache-dir", str(tmp_path), "--no-compile-cache"]
    mod = importlib.import_module(
        f"human_body_proportion_estimation_tpu_torch.cli.{module}")

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    if module == "args":
        mod.build_parser("x").parse_args(["-i", "d", *flags])
    else:
        import torch as _torch

        # the first step after the flags: no model is built
        monkeypatch.setattr(_torch, "device", stop)
        from human_body_proportion_estimation_tpu_torch.cli import common
        from human_body_proportion_estimation_tpu_torch.pipeline import host

        monkeypatch.setattr(common, "InferencePipeline", stop)
        monkeypatch.setattr(host, "InferencePipeline", stop)
        argv = {
            "certify": ["--workdir", str(tmp_path / "w")],
            "certify_bottomup": ["--workdir", str(tmp_path / "w")],
            "evaluate": ["--annotations", "a.json", "--images-dir", ".",
                         "--detector", "efficientdet_lite4"],
            "export_artifact": ["--out", str(tmp_path / "o"), "--detector",
                                "efficientdet_lite4"],
        }[module]
        with pytest.raises(Stop):
            mod.main([*argv, *flags])
    assert calls == [(str(tmp_path), True)]


def test_device_time_returns_min_and_output():
    calls = []

    def f(x):
        calls.append(time.perf_counter())
        if len(calls) == 1:
            time.sleep(0.05)          # a slow first call (a build, say)
        return x * 2

    best, out = profiling.device_time(f, torch.ones(4), trials=3)
    assert len(calls) == 3
    assert torch.equal(out, torch.full((4,), 2.0))
    assert 0 < best < 0.05
    best_np, out_np = profiling.device_time(
        lambda: {"rows": np.ones((2, 3))}, readback=lambda o: o["rows"],
        trials=2)
    assert best_np >= 0 and out_np["rows"].shape == (2, 3)


def test_torch_trace_writes_a_trace(tmp_path):
    d = tmp_path / "trace"
    with profiling.torch_trace(str(d)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(d / "trace.json") as fh:
        assert json.load(fh)["traceEvents"]
