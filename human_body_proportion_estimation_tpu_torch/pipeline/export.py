"""The deployable artifact: the serving program exported with
`torch.export`, restored and served without building a model (port of the
JAX package's `pipeline/export.py`).

One directory holds:

    pipeline.pt2   the serving program at one fixed batch size
                   (`torch.export.save`): the graph of the fused forward,
                   its weights and its constants (anchors, resize
                   matrices), on the device it was exported on
    meta.json      the JAX package's keys (format version, batch size,
                   shapes, packed layout, config, weights' origin), plus
                   `program` (the file above) and `device`

The top-down program is (images u8 [b, H, W, 3], thresholds [b],
heights [b, P], orig_hw [b, 2]) -> packed [b, P, 23]; the bottom-up one
is (images, heights, orig_hw) -> packed. The three CUDA kernels are
`torch.library` ops (`ops/kernels.py`, namespace `hbpe`), so the program
calls them as nodes of its graph: importing `ops.kernels` registers them,
and `torch.export.load` needs that before it reads the program. An
artifact serves on the device type it was exported on: one exported on
the GPU holds CUDA constants, and restoring it elsewhere raises.

The JAX package writes orbax `det/` and `pose/` beside its StableHLO
program; the port's program holds its weights (its Orbax writer,
`models.weights.save_pipeline_checkpoint`, needs tensorstore, which a
serving machine may lack), and neither package reads the other's
artifact.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import numpy as np
import torch

# registers the hbpe ops before any program that calls them is loaded
from human_body_proportion_estimation_tpu_torch.ops import (  # noqa: F401
    kernels,
)
from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
    same_device,
    to_shards,
)
from human_body_proportion_estimation_tpu_torch.pipeline import (
    bottomup,
    host,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    config_from_dict,
)

# artifact directory layout version; bump on layout/meta schema breaks.
# Restore refuses artifacts from a NEWER writer.
FORMAT_VERSION = 1
PROGRAM = "pipeline.pt2"
PACKED_LAYOUT = "valid | lengths_cm[11] | seg_visible[11]"


def _export(program: torch.nn.Module, args, directory: str) -> None:
    exported = torch.export.export(program, args, strict=False)
    torch.export.save(exported, os.path.join(directory, PROGRAM))


def _write_meta(directory: str, meta: dict) -> None:
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def export_serving_artifact(pipeline, directory: str,
                            batch_size: int = 16) -> str:
    """Export the packed serving program + weights for `batch_size`.

    Accepts either serving pipeline: `InferencePipeline` (top-down
    det+pose, the default) or `BottomUpPipeline` (HigherHRNet + AE
    grouping: no detector; mode recorded in meta.json). The program is
    traced on the pipeline's device, which the artifact then serves on."""
    os.makedirs(directory, exist_ok=True)
    b = batch_size
    if not hasattr(pipeline, "program"):
        return _export_bottomup(pipeline, directory, b)
    cfg = pipeline.config
    dev = pipeline.device
    p = cfg.detector.max_persons
    h, w = cfg.detector.input_height, cfg.detector.input_width
    args = (
        torch.zeros((b, h, w, 3), dtype=torch.uint8, device=dev),
        torch.zeros((b,), dtype=torch.float32, device=dev),
        torch.zeros((b, p), dtype=torch.float32, device=dev),
        torch.ones((b, 2), dtype=torch.float32, device=dev),
    )
    _export(pipeline.program, args, directory)
    _write_meta(directory, {
        "format_version": FORMAT_VERSION,
        "batch_size": b,
        "max_persons": p,
        "detector_input_hw": [h, w],
        "pose_crop_hw": [cfg.pose.crop_height, cfg.pose.crop_width],
        "packed_layout": PACKED_LAYOUT,
        "config": dataclasses.asdict(cfg),
        # real|random per model slot, so that a server of the artifact
        # keeps the random-weight warning honest
        "weights_origin": dict(pipeline.weights_origin),
        "program": PROGRAM,
        "device": dev.type,
    })
    return directory


def _export_bottomup(pipeline, directory: str, b: int) -> str:
    """Bottom-up variant: program signature
    (images [b, H, W, 3] u8, heights [b, P], orig_hw [b, 2])."""
    dev = pipeline.device
    p = pipeline.max_people
    h, w = pipeline.INPUT_HW
    args = (
        torch.zeros((b, h, w, 3), dtype=torch.uint8, device=dev),
        torch.zeros((b, p), dtype=torch.float32, device=dev),
        torch.ones((b, 2), dtype=torch.float32, device=dev),
    )
    _export(bottomup.BottomUpProgram(pipeline), args, directory)
    _write_meta(directory, {
        "format_version": FORMAT_VERSION,
        "mode": "bottom_up",
        "batch_size": b,
        "max_persons": p,
        "input_hw": [h, w],
        "grouping": {
            "max_cands": pipeline.max_cands,
            "tag_threshold": pipeline.tag_threshold,
            "score_threshold": pipeline.score_threshold,
        },
        "packed_layout": PACKED_LAYOUT,
        "config": dataclasses.asdict(pipeline.config),
        "weights_origin": dict(pipeline.weights_origin),
        "program": PROGRAM,
        "device": dev.type,
    })
    return directory


class ServingArtifact:
    """Restored artifact: the callable packed serving program.

    Restoring reads `meta.json` and `pipeline.pt2` and builds no model:
    the program is the exported graph (`ExportedProgram.module()`), with
    the weights it was saved with. It runs under `torch.inference_mode`,
    which an export does not keep. `device`: where it serves (the GPU
    unless the caller asks for the CPU); it must be the device type the
    artifact was exported on.

    `mesh`: a `parallel.mesh.Mesh` to serve data-parallel over its 'data'
    axis, as the JAX `ServingArtifact(mesh=)` does: one call takes
    `batch_size` x dp rows (`effective_batch`), each shard of
    `batch_size` contiguous rows runs the program on its device, and the
    rows come back in order. The program is restored once per distinct
    device of the mesh (moved there with `torch.export.passes.
    move_to_device_pass` where that is not the device it was exported
    on), not once per shard; `device` is then the first shard's."""

    def __init__(self, directory: str, mesh=None,
                 device: str | torch.device = "cuda"):
        self.mesh = mesh
        if mesh is not None:
            device = mesh.data_devices[0]
        with open(os.path.join(directory, "meta.json")) as f:
            self.meta = json.load(f)
        v = self.meta.get("format_version", 1)
        if v > FORMAT_VERSION:
            raise ValueError(
                f"artifact {directory} has format_version {v}; this "
                f"build reads <= {FORMAT_VERSION} — re-export with this "
                "build or upgrade it"
            )
        self.device = torch.device(device)
        exported_on = self.meta.get("device", "cpu")
        if exported_on != self.device.type:
            raise ValueError(
                f"artifact {directory} was exported on {exported_on} and "
                f"cannot serve on {self.device.type}: its constants live "
                f"on {exported_on}; export it again on {self.device.type}")
        self.mode = self.meta.get("mode", "top_down")
        path = os.path.join(directory, self.meta.get("program", PROGRAM))
        exported = torch.export.load(path)
        home = next(iter(exported.state_dict.values())).device
        devices = [self.device] if mesh is None else mesh.data_devices
        programs = {}
        for d in dict.fromkeys(str(d) for d in devices):
            if not same_device(home, torch.device(d)):
                from torch.export.passes import move_to_device_pass

                exported = move_to_device_pass(exported, d)
            programs[d] = exported.module()
        self.program = programs[str(self.device)]
        # the program and device of each data shard
        self.shards = [(programs[str(d)], torch.device(d)) for d in devices]

    @property
    def batch_size(self) -> int:
        """The batch the program was exported for."""
        return self.meta["batch_size"]

    @property
    def effective_batch(self) -> int:
        """Rows one call consumes: `batch_size` x the mesh's dp."""
        return self.batch_size * len(self.shards)

    def __call__(
        self,
        images: np.ndarray,      # [batch_size, H, W, 3] uint8
        thresholds: np.ndarray,  # [batch_size]; ignored in bottom_up
        heights: np.ndarray,     # [batch_size, P]
        orig_hw: np.ndarray,     # [batch_size, 2]
    ) -> np.ndarray:
        """Packed rows of `effective_batch` prepared rows."""
        arrays = [np.asarray(images, np.uint8)]
        if self.mode != "bottom_up":
            arrays.append(np.asarray(thresholds, np.float32))
        arrays += [np.asarray(heights, np.float32),
                   np.asarray(orig_hw, np.float32)]
        shards = to_shards(arrays, [dev for _, dev in self.shards])
        with torch.inference_mode():
            outs = [program(*args)
                    for (program, _), args in zip(self.shards, shards)]
            return np.concatenate([o.cpu().numpy() for o in outs])


class ArtifactPipeline:
    """Serve directly from an exported artifact directory.

    Restores the program, weights and config written by
    `export_serving_artifact` and presents the `InferencePipeline` serving
    surface (`infer_serving` / `config` / `weights_origin` / `stages` /
    `prewarmed` / `device`), so `serve.server --artifact-dir <dir>` runs
    without any model being built.

    The exported program has one fixed batch size; requests are padded (and
    oversize batches cut into chunks) to it, unlike the live pipeline's
    power-of-two buckets. Its stages are `host_prepare` and
    `device_compute_readback` (the upload is part of the latter): the
    live forward's `record_function` ranges are not part of an exported
    graph. `mesh`: data-parallel serving (`ServingArtifact`): a chunk is
    then `batch_size` x dp rows.
    """

    def __init__(self, directory: str, mesh=None,
                 device: str | torch.device = "cuda"):
        self.artifact = ServingArtifact(directory, mesh=mesh, device=device)
        self.device = self.artifact.device
        if self.device.type == "cuda":
            # the live pipelines' precision: TF32 off, so that the crop's
            # f32 matmuls and the f32 heads stay f32 (a global flag, not
            # part of an exported graph)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = config_from_dict(self.artifact.meta["config"])
        self.weights_origin = dict(
            self.artifact.meta.get(
                "weights_origin",
                {"detector": "unknown", "pose": "unknown"},
            )
        )
        self.stages = None  # ServingApp attaches a StageTimer
        self.prewarmed = False

    def _stage(self, name: str):
        if self.stages is None:
            return contextlib.nullcontext()
        return self.stages.stage(name)

    def infer_serving(
        self,
        images_rgb,
        person_heights=175.0,
        det_threshold: float | list = 0.70,
    ) -> np.ndarray:
        """Packed [n, P, 23] rows, same contract as
        `InferencePipeline.infer_serving`."""
        meta = self.artifact.meta
        b = self.artifact.effective_batch
        rows = []
        for start in range(0, len(images_rgb), b):
            chunk = images_rgb[start:start + b]

            def per_chunk(v):
                if np.isscalar(v):
                    return v
                return v[start:start + b]

            with self._stage("host_prepare"):
                if self.artifact.mode == "bottom_up":
                    batch, heights, orig_hw, n = (
                        bottomup.prepare_batch_bottomup(
                            chunk, per_chunk(person_heights), b,
                            meta["max_persons"], tuple(meta["input_hw"]),
                        )
                    )
                    thresholds = None
                else:
                    batch, thresholds, heights, orig_hw, n = (
                        host.prepare_batch(
                            self.config, chunk, per_chunk(person_heights),
                            per_chunk(det_threshold), b,
                        )
                    )
            with self._stage("device_compute_readback"):
                rows.append(self.artifact(
                    batch, thresholds, heights, orig_hw
                )[:n])
        return np.concatenate(rows, axis=0)
