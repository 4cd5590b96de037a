"""Package-level guarantees of the port: it imports without JAX, flax, optax,
orbax, tensorstore, zstandard, google_crc32c, TensorFlow or the JAX
package, no source file of it names those packages in an import, and its
HTTP edge and registry without grpc or protobuf; the
committed certified checkpoint converts into the
full-width port models with every tensor placed; entry points default to
CUDA and do not fall back to the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "flax", "optax", "orbax", "orbax.checkpoint",
                "tensorstore", "zstandard", "google_crc32c", "tensorflow",
                "human_body_proportion_estimation_tpu"):
    sys.modules[blocked] = None
import human_body_proportion_estimation_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 69, names
for name in ("serve.registry", "serve.grpc_server", "serve.kserve_grpc",
             "serve.hbpe_pb2", "serve.kserve_pb2", "serve.wire",
             "serve.client", "serve.perf", "models.higherhrnet",
             "pipeline.detect", "pipeline.pose", "cli.detect_edet",
             "cli.pose_est", "ops.ae_grouping", "pipeline.bottomup",
             "cli.detect_pose_bottomup", "metrics", "metrics.detection",
             "metrics.pose", "cli.evaluate", "training", "training.synthetic",
             "training.data", "training.trainer", "training.loop",
             "training.detection", "training.certify", "training.bottomup",
             "training.certify_bottomup", "cli.certify",
             "cli.certify_bottomup", "pipeline.export", "cli.export_artifact",
             "utils.compile_cache", "models.flax_init", "parallel",
             "parallel.mesh", "parallel.multihost", "training.sharded",
             "models.ssd_mobilenet", "models.tflite_import",
             "models.tf_import", "pipeline.human_detector",
             "cli.import_weights", "models.orbax_store", "utils.zstd",
             "models.tf_bundle", "utils.crc32c"):
    assert port.__name__ + "." + name in names, name
import chip_smoke
assert not [m for m in sys.modules if m.startswith(("jax", "flax", "optax",
                                                   "orbax"))
            and sys.modules[m] is not None]
print("ok", len(names))
"""


def test_port_imports_without_jax():
    """In a fresh interpreter with jax, flax, orbax, tensorstore, zstandard,
    google_crc32c, tensorflow and the JAX package blocked, every module of
    the port and chip_smoke.py import."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


_NOT_IMPORTED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
                 "zstandard", "google_crc32c", "tensorflow",
                 "human_body_proportion_estimation_tpu")


def test_no_source_file_imports_jax_or_orbax_packages():
    """No source file of the port, nor chip_smoke.py, names JAX, flax,
    optax, orbax, tensorstore, zstandard, google_crc32c, TensorFlow or the
    JAX package in an import statement, at any depth (a function's lazy
    import included): the port reads and writes Orbax checkpoints and
    reads TF checkpoints itself."""
    import ast

    pkg = os.path.join(REPO, "human_body_proportion_estimation_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
        if f.endswith(".py")]
    found = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                      for n in names if n.split(".")[0] in _NOT_IMPORTED]
    assert len(files) > 80
    assert not found, found


_NO_PROTOBUF_IMPORT = r"""
import sys
for name in ("grpc", "google.protobuf", "jax", "flax",
             "human_body_proportion_estimation_tpu"):
    sys.modules[name] = None
from human_body_proportion_estimation_tpu_torch.serve import (
    client, registry, server, wire)
reg = registry.build_registry(device="cpu")
assert len(reg.names()) == 8, reg.names()
loaded = [m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] == "grpc" or m.startswith("google.protobuf"))]
assert not loaded, loaded
print("ok")
"""


def test_http_edge_and_registry_import_without_grpc_or_protobuf():
    """With grpc and google.protobuf blocked, the registry, the HTTP server
    and its client import (and the registry builds): the HTTP /v2 routes do
    not need the gRPC packages."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_PROTOBUF_IMPORT], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_certified_checkpoint_fills_full_width_port():
    """Shape check: every tensor of certified_lite4_w32.npz finds its place
    in the full-width port models, and no port tensor is left unfilled
    (`strict=True`)."""
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
        EfficientDet,
    )
    from human_body_proportion_estimation_tpu_torch.models.hrnet import HRNet
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        default_certified_checkpoint,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        load_certified_states,
    )

    det_state, pose_state = load_certified_states()
    n_npz = len(np.load(default_certified_checkpoint()).files)
    n_bn = sum(k.endswith("num_batches_tracked")
               for k in (*det_state, *pose_state))
    assert len(det_state) + len(pose_state) - n_bn == n_npz
    with torch.device("meta"):
        det, pose = EfficientDet(), HRNet()
    det.load_state_dict(det_state, strict=True, assign=True)
    pose.load_state_dict(pose_state, strict=True, assign=True)
    w = det.class_net.predict_pw.weight
    assert w.shape == (810, 224, 1, 1) and w.dtype == torch.float32
    assert pose.head.weight.shape == (17, 32, 1, 1)


def test_entry_point_defaults_to_cuda_without_fallback():
    import inspect

    from human_body_proportion_estimation_tpu_torch.cli import (
        detect_edet,
        detect_pose_bottomup,
        pose_est,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
        BottomUpPipeline,
        build_default,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.export import (
        ArtifactPipeline,
        ServingArtifact,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )

    for fn in (InferencePipeline, detect_edet.run_demo_odet,
               pose_est.run_demo_pose_est, BottomUpPipeline,
               detect_pose_bottomup.run_bottomup,
               build_default, ArtifactPipeline, ServingArtifact):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        for make in (InferencePipeline, BottomUpPipeline):
            with pytest.raises((RuntimeError, AssertionError)):
                make(device="cuda")
