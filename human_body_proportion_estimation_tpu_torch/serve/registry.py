"""Named-model registry, the Triton model-repository role (port of the JAX
package's `serve/registry.py` over the port's torch modules).

The reference serves a repository of named models behind Triton's tensor
API, addressed by name from every client program. The port registers the models
whose modules it has:

  * ``ensemble_edet4_person_det_pose`` (`person_det_pose_edet4_trtserver.py:30`)
    — the det -> crop -> pose DAG, outputs
    ``ENSEMBLE_OUTPUT_FILTER_DET_BOXES`` / ``ENSEMBLE_OUTPUT_HEATMAPS``.
  * ``edetlite4`` / ``edetlite4_modified`` (`obj_det_edet4_trtserver.py:166`)
    — the raw detector (``output_0/1/2``) and the model-surgery graph
    (``detection_boxes/scores/classes``, ``filtered_boxes``,
    ``human_crops``, reference `models/conv.py:82-86`).
  * ``hrnet`` (`pose_est_hrnet_trtserver.py:22-25`) — ``output`` heatmaps.
  * ``higherhrnet`` (`pose_est_hrnet_trtserver.py:22-28`) — any-size f32
    NCHW ``input`` -> ``output_1`` (K heatmaps + K tags at 1/4) and
    ``output_2`` (K heatmaps at 1/2, the tensor the reference reads).
  * ``yolov5m`` / ``yolov5s`` (`obj_det_yolov5_trtserver.py:53`) —
    ``images`` f32 NCHW [B, 3, 640, 640] (already /255) -> ``output``
    [B, 25200, 85] decoded predictions; the NMS runs on the client.

  * ``ssd_mobilenet`` (`modules/human_detector.py:31-38`) — the SSD
    detector with the real weights of the reference's ssd.tflite, batch 1:
    a uint8 image of any size -> the TFLite_Detection_PostProcess outputs
    ``detection_boxes`` (normalized y1x1y2x2), ``detection_classes``
    (0-based, person 0), ``detection_scores`` and ``num_detections``.
    Always registered and loaded lazily: with the file absent its load
    fails naming the path, as the JAX registry's does.

Clients introspect each model's inputs, outputs and max_batch_size before
building requests (`modules/triton_utils.py:54-72` ``parse_model_grpc``):
`metadata` and `config` are the JAX package's documents, with `platform`
naming the port's runtime (``pytorch`` / ``pytorch_ensemble``).

Design notes, as in the JAX package:
  * Fixed shapes on the device, dynamic shapes on the wire: 3 padded
    person slots and 100 detection slots with validity masks; the host
    slices to the dynamic counts the reference emits.
  * Detector models take any input H x W, resize on the host to the
    detector input and scale pixel outputs back to the wire image.
  * Models are built lazily on first inference; metadata is served
    without loading. With a serving pipeline the registry shares its
    HRNet and EfficientDet modules, so registry inference adds no device
    memory; the detector models run the canonical all-class head of the
    same EfficientDet (`forward(..., all_classes=True)`, f32 class predict
    conv, greedy NMS through the NMS sweep kernel), whichever
    EfficientDet the pipeline serves (Lite4 or Lite0: the JAX registry
    takes the serving detector's config too). A YOLO model shares the
    serving pipeline's detector when that is the same YOLOv5 variant, and
    ``higherhrnet`` the pipeline's HigherHRNet pose when it has one; else
    each is built at random, flax's init with PRNGKey(0)
    (`models.layers.init_random`; no YOLO or HigherHRNet weights are in
    the repository), labelled "random".
  * The no-detection fallback of `models/conv.py:72-79` (a single all-zero
    crop, so HRNet runs on zeros) is kept: invalid person slots are zeroed
    before the pose stage and `human_crops` / heatmaps have max(n, 1) rows.

Runners run on the registry's device: the serving pipeline's, else CUDA
unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Triton/KServe-v2 datatype strings <-> numpy (triton_utils builds inputs
# from these names via tritonclient's metadata, reference :37-51)
TRITON_TO_NP = {
    "UINT8": np.uint8,
    "INT32": np.int32,
    "INT64": np.int64,
    "FP16": np.float16,
    "FP32": np.float32,
    "FP64": np.float64,
    "BOOL": np.bool_,
}
NP_TO_TRITON = {np.dtype(v): k for k, v in TRITON_TO_NP.items()}

# Every model serves exactly one version, "1" — the analog of the
# reference repo's Triton model directories `<name>/1/` (README :71-80).
# tritonclient passes model_version="" (latest) or "1" on every call
# (reference modules/triton_utils.py:21-31); anything else is NOT_FOUND.
MODEL_VERSION = "1"


def check_version(name: str, version: str) -> None:
    """Raise KeyError (-> NOT_FOUND at both edges) for a version other
    than '' (latest) or '1' — Triton's unknown-version behavior."""
    if version not in ("", MODEL_VERSION):
        raise KeyError(
            f"model '{name}' has no version '{version}' "
            f"(available: ['{MODEL_VERSION}'])"
        )


@dataclass(frozen=True)
class TensorSpec:
    """Wire tensor contract. shape uses -1 for dynamic dims; the leading
    dim is the batch dim when the model reports max_batch_size > 0."""

    name: str
    datatype: str
    shape: Tuple[int, ...]


@dataclass
class ModelEntry:
    """One named model: metadata + a lazily built numpy runner.

    Batched models (max_batch_size > 0) get per-model dynamic batching —
    Triton's `dynamic_batching` config behavior (reference README :71-80):
    concurrent requests coalesce along the batch dim into ONE device
    launch after at most `batch_timeout_ms`, then results split back per
    request. Fixed-signature models (max_batch_size == 0) dispatch
    directly.
    """

    name: str
    platform: str               # descriptive, Triton-config analog
    inputs: List[TensorSpec]
    outputs: List[TensorSpec]
    max_batch_size: int         # 0 = no batch dim (fixed batch-1 signature)
    weights: str                # "real" | "synthetic-certified" | "random"
    build: Callable[[], Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]]
    batch_timeout_ms: float = 4.0
    # hook invoked after unload() (e.g. releasing a core shared between
    # sibling entries once none of them is loaded)
    on_unload: Optional[Callable[[], None]] = None
    _runner: Optional[Callable] = field(default=None, repr=False)
    _batcher: Optional[Any] = field(default=None, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    batches_run: int = 0        # observability: device launches so far
    # devices a coalesced batch is sharded over (`instance_group.count`)
    dp: int = 1

    # -- per-model inference statistics (Triton get_inference_statistics
    # analog). Cumulative since process start, guarded by _stats_lock
    # (requests arrive on edge threads, launches run on the batcher
    # thread). --
    _stats_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False
    )
    inference_count: int = 0    # rows successfully inferred
    success_count: int = 0      # successful requests
    success_ns: int = 0         # cumulative request wall time (success)
    fail_count: int = 0
    fail_ns: int = 0
    compute_input_ns: int = 0   # host-side batch assembly (concat)
    compute_infer_ns: int = 0   # device launch wall
    compute_output_ns: int = 0  # host-side result split
    # launch wall attributed once per coalesced request: request wall
    # minus this is (about) the time spent queued in the deadline batcher
    compute_request_ns: int = 0
    last_inference_ms: int = 0  # epoch ms of the most recent request
    # rows-per-launch -> [launch count, compute_infer ns] (batch_stats)
    batch_stats: Dict[int, List[int]] = field(default_factory=dict)

    def _record_launch(self, rows: int, n_requests: int, input_ns: int,
                       infer_ns: int, output_ns: int) -> None:
        with self._stats_lock:
            self.batches_run += 1
            self.compute_input_ns += input_ns
            self.compute_infer_ns += infer_ns
            self.compute_output_ns += output_ns
            self.compute_request_ns += (
                (input_ns + infer_ns + output_ns) * n_requests
            )
            cell = self.batch_stats.setdefault(rows, [0, 0])
            cell[0] += 1
            cell[1] += infer_ns

    def record_request(self, ok: bool, wall_ns: int, rows: int) -> None:
        with self._stats_lock:
            self.last_inference_ms = int(time.time() * 1000)
            if ok:
                self.success_count += 1
                self.success_ns += wall_ns
                self.inference_count += rows
            else:
                self.fail_count += 1
                self.fail_ns += wall_ns

    @property
    def loaded(self) -> bool:
        return self._runner is not None

    def runner(self) -> Callable:
        if self._runner is None:
            with self._lock:
                if self._runner is None:
                    self._runner = self.build()
        return self._runner

    def _run_coalesced(
        self, payloads: List[Dict[str, np.ndarray]]
    ) -> List[Dict[str, np.ndarray]]:
        """Batcher runner: concatenate queued requests along the batch
        dim and split results back per request. Requests are grouped by
        their non-batch dims (dynamic-dim models may mix input sizes) and
        each group is chunked so that a combined launch never exceeds
        max_batch_size rows: the batcher counts requests, not rows."""
        run = self.runner()
        results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(payloads)

        def launch(idxs: List[int]) -> None:
            if len(idxs) == 1:
                t0 = time.monotonic_ns()
                results[idxs[0]] = run(payloads[idxs[0]])
                rows = next(iter(payloads[idxs[0]].values())).shape[0]
                self._record_launch(
                    rows, 1, 0, time.monotonic_ns() - t0, 0
                )
                return
            sizes = [next(iter(payloads[i].values())).shape[0]
                     for i in idxs]
            t0 = time.monotonic_ns()
            concat = {
                name: np.concatenate([payloads[i][name] for i in idxs])
                for name in payloads[idxs[0]]
            }
            t1 = time.monotonic_ns()
            out = run(concat)
            t2 = time.monotonic_ns()
            off = 0
            for i, n in zip(idxs, sizes):
                results[i] = {k: v[off:off + n] for k, v in out.items()}
                off += n
            self._record_launch(
                sum(sizes), len(idxs), t1 - t0, t2 - t1,
                time.monotonic_ns() - t2,
            )

        groups: Dict[Any, List[int]] = {}
        for i, p in enumerate(payloads):
            key = tuple(sorted((k, v.shape[1:]) for k, v in p.items()))
            groups.setdefault(key, []).append(i)
        for idxs in groups.values():
            chunk: List[int] = []
            rows = 0
            for i in idxs:
                n = next(iter(payloads[i].values())).shape[0]
                if chunk and rows + n > self.max_batch_size:
                    launch(chunk)
                    chunk, rows = [], 0
                chunk.append(i)
                rows += n
            if chunk:
                launch(chunk)
        return results  # every index filled: groups partition the payloads

    def dispatch(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.max_batch_size <= 0:
            t0 = time.monotonic_ns()
            wall0 = time.time_ns()
            out = self.runner()(inputs)
            self._record_launch(1, 1, 0, time.monotonic_ns() - t0, 0)
            # fixed-signature models bypass the batcher, so the Triton
            # trace extension's sampling hook lives here instead
            from human_body_proportion_estimation_tpu_torch.serve import (
                tracing,
            )

            if tracing.TRACER.sample():
                tracing.TRACER.record(
                    self.name,
                    {"COMPUTE_START": wall0, "COMPUTE_END": time.time_ns()},
                    batch_size=1,
                )
            return out
        # read the batcher reference ONCE per attempt: an unload() racing
        # this call may null the field; a request that lands in a batcher
        # being shut down gets a clean "shut down" error and retries on a
        # fresh one
        for _ in range(2):
            batcher = self._batcher
            if batcher is None:
                with self._lock:
                    if self._batcher is None:
                        from human_body_proportion_estimation_tpu_torch.serve.batching import (  # noqa: E501
                            DynamicBatcher,
                        )

                        self._batcher = DynamicBatcher(
                            self._run_coalesced,
                            max_batch=self.max_batch_size,
                            batch_timeout_ms=self.batch_timeout_ms,
                            trace_name=self.name,
                        )
                    batcher = self._batcher
            try:
                return batcher.infer(inputs)
            except RuntimeError as e:
                if "shut down" not in str(e):
                    raise
                with self._lock:
                    if self._batcher is batcher:
                        self._batcher = None
        raise RuntimeError(
            f"model '{self.name}' is being unloaded; retry the request"
        )

    def shutdown(self):
        if self._batcher is not None:
            self._batcher.shutdown()
            self._batcher = None

    def unload(self):
        """Drop the runner (and its device parameters, unless shared with
        the serving pipeline) and the batcher; the next inference
        rebuilds."""
        with self._lock:
            batcher, self._batcher = self._batcher, None
            self._runner = None
        if batcher is not None:
            # outside the lock: shutdown drains + fails queued futures and
            # may wait on an in-flight launch
            batcher.shutdown()
        if self.on_unload is not None:
            self.on_unload()


class ModelRegistry:
    """Name -> ModelEntry map with Triton-shaped introspection + dispatch."""

    def __init__(self):
        self._models: Dict[str, ModelEntry] = {}

    def register(self, entry: ModelEntry) -> None:
        self._models[entry.name] = entry

    def names(self) -> List[str]:
        return sorted(self._models)

    def index(self) -> List[Dict[str, Any]]:
        """RepositoryIndex rows (tritonclient get_model_repository_index
        analog): every registered model is servable -> READY."""
        return [
            {
                "name": m.name,
                "version": MODEL_VERSION,
                "state": "READY",
                "loaded": m.loaded,
                "weights": m.weights,
            }
            for m in (self._models[n] for n in self.names())
        ]

    def metadata(self, name: str, version: str = "") -> Dict[str, Any]:
        """The fields `parse_model_grpc` consumes (reference
        triton_utils.py:54-72): input/output names, dtypes, shapes,
        max_batch_size; `versions` mirrors Triton's single `<name>/1/`
        model directory."""
        check_version(name, version)
        m = self._get(name)
        return {
            "name": m.name,
            "versions": [MODEL_VERSION],
            "platform": m.platform,
            "max_batch_size": m.max_batch_size,
            "weights": m.weights,
            "inputs": [
                {"name": t.name, "datatype": t.datatype,
                 "shape": list(t.shape)}
                for t in m.inputs
            ],
            "outputs": [
                {"name": t.name, "datatype": t.datatype,
                 "shape": list(t.shape)}
                for t in m.outputs
            ],
        }

    def config(self, name: str, version: str = "") -> Dict[str, Any]:
        """Triton model-*config* analog, the second document tritonclient
        fetches beside metadata (`get_model_config`, reference
        triton_utils.py:27-31). Triton's conventions: `dims` EXCLUDE the
        batch dim when max_batch_size > 0; `instance_group.count` is the
        number of devices a batch is sharded over (the mesh's dp for the
        `hrnet`, `higherhrnet` and `yolov5*` runners, else 1);
        `dynamic_batching` carries the deadline batcher's queue delay."""
        check_version(name, version)
        m = self._get(name)

        def _tensors(specs: List[TensorSpec]) -> List[Dict[str, Any]]:
            return [
                {
                    "name": t.name,
                    "data_type": f"TYPE_{t.datatype}",
                    "format": "FORMAT_NONE",
                    "dims": list(
                        t.shape[1:] if m.max_batch_size > 0 else t.shape
                    ),
                }
                for t in specs
            ]

        out: Dict[str, Any] = {
            "name": m.name,
            "platform": m.platform,
            "max_batch_size": m.max_batch_size,
            "version_policy": {"latest": {"num_versions": 1}},
            "input": _tensors(m.inputs),
            "output": _tensors(m.outputs),
            "instance_group": [{"count": m.dp, "kind": "KIND_MODEL"}],
        }
        if m.max_batch_size > 0:
            out["dynamic_batching"] = {
                "preferred_batch_size": [m.max_batch_size],
                "max_queue_delay_microseconds": int(
                    m.batch_timeout_ms * 1000
                ),
            }
        return out

    def infer(
        self,
        name: str,
        inputs: Dict[str, np.ndarray],
        output_names: Optional[Sequence[str]] = None,
        version: str = "",
    ) -> Dict[str, np.ndarray]:
        """Run a named model on numpy tensors (triton_client.infer analog):
        validate tensor names / dtypes / shapes against the metadata,
        dispatch to the lazily built runner, filter the requested outputs
        (Triton's requested-outputs semantics, triton_utils.py:44-49)."""
        check_version(name, version)
        m = self._get(name)
        t_req = time.monotonic_ns()
        try:
            out = self._infer_checked(m, inputs, output_names)
        except Exception:
            m.record_request(False, time.monotonic_ns() - t_req, 0)
            raise
        rows = (next(iter(inputs.values())).shape[0]
                if m.max_batch_size > 0 and inputs else 1)
        m.record_request(True, time.monotonic_ns() - t_req, rows)
        return out

    def _infer_checked(
        self,
        m: ModelEntry,
        inputs: Dict[str, np.ndarray],
        output_names: Optional[Sequence[str]],
    ) -> Dict[str, np.ndarray]:
        name = m.name
        expected = {t.name: t for t in m.inputs}
        unknown = set(inputs) - set(expected)
        if unknown:
            raise ValueError(
                f"model '{name}' has no input(s) {sorted(unknown)}; "
                f"expects {sorted(expected)}"
            )
        missing = set(expected) - set(inputs)
        if missing:
            raise ValueError(
                f"model '{name}' missing input(s) {sorted(missing)}"
            )
        coerced = {}
        for tname, arr in inputs.items():
            spec = expected[tname]
            want = TRITON_TO_NP[spec.datatype]
            arr = np.asarray(arr)
            if arr.dtype != want:
                raise ValueError(
                    f"input '{tname}' dtype {arr.dtype} != {spec.datatype}"
                )
            if len(arr.shape) != len(spec.shape):
                raise ValueError(
                    f"input '{tname}' rank {len(arr.shape)} != "
                    f"{len(spec.shape)} (shape spec {list(spec.shape)})"
                )
            for got, want_d in zip(arr.shape, spec.shape):
                if want_d != -1 and got != want_d:
                    raise ValueError(
                        f"input '{tname}' shape {list(arr.shape)} "
                        f"incompatible with {list(spec.shape)}"
                    )
            coerced[tname] = arr
        if m.max_batch_size > 0:
            b = next(iter(coerced.values())).shape[0]
            if b > m.max_batch_size:
                raise ValueError(
                    f"batch {b} exceeds model '{name}' "
                    f"max_batch_size {m.max_batch_size}"
                )
        out = m.dispatch(coerced)
        if output_names:
            bad = set(output_names) - set(out)
            if bad:
                raise ValueError(
                    f"model '{name}' has no output(s) {sorted(bad)}"
                )
            out = {k: out[k] for k in output_names}
        return out

    def _get(self, name: str) -> ModelEntry:
        if name not in self._models:
            raise KeyError(
                f"model '{name}' not found; repository has {self.names()}"
            )
        return self._models[name]

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-model observability for /metrics: loaded state + device
        launches so far (a coalesced batch counts once)."""
        return {
            n: {
                "loaded": self._models[n].loaded,
                "batches_run": self._models[n].batches_run,
            }
            for n in self.names()
        }

    def statistics(self, name: str = "",
                   version: str = "") -> Dict[str, Any]:
        """Per-model inference statistics, the Triton
        `get_inference_statistics` / `GET /v2/models/<name>/stats`
        document; an empty name gives every model. Per model, cumulative:
        `inference_count` (rows), `execution_count` (launches; a coalesced
        batch counts once), `inference_stats` (success / fail request
        count and wall ns, queue ns, per-launch compute_input / infer /
        output ns) and `batch_stats` (per rows-per-launch)."""
        if name:
            check_version(name, version)
            self._get(name)
            names = [name]
        else:
            names = self.names()
        out = []
        for n in names:
            m = self._models[n]
            with m._stats_lock:
                queue_ns = max(0, m.success_ns - m.compute_request_ns)
                out.append({
                    "name": n,
                    "version": MODEL_VERSION,
                    "last_inference": m.last_inference_ms,
                    "inference_count": m.inference_count,
                    "execution_count": m.batches_run,
                    "inference_stats": {
                        "success": {"count": m.success_count,
                                    "ns": m.success_ns},
                        "fail": {"count": m.fail_count, "ns": m.fail_ns},
                        "queue": {"count": m.success_count,
                                  "ns": queue_ns},
                        "compute_input": {"count": m.batches_run,
                                          "ns": m.compute_input_ns},
                        "compute_infer": {"count": m.batches_run,
                                          "ns": m.compute_infer_ns},
                        "compute_output": {"count": m.batches_run,
                                           "ns": m.compute_output_ns},
                    },
                    "batch_stats": [
                        {"batch_size": b,
                         "compute_infer": {"count": c[0], "ns": c[1]}}
                        for b, c in sorted(m.batch_stats.items())
                    ],
                })
        return {"model_stats": out}

    def load(self, name: str) -> None:
        """Eagerly build a model's runner — Triton's explicit load_model
        repository-control RPC."""
        self._get(name).runner()

    # Triton's `unload_dependents` repository-extension parameter: for an
    # ensemble, also unload its composing models (the reference's ensemble
    # chains edetlite4_modified -> hrnet, conv.py + README :71-80)
    ENSEMBLE_DEPENDENTS = {
        "ensemble_edet4_person_det_pose": ("edetlite4_modified", "hrnet"),
    }

    def unload(self, name: str, unload_dependents: bool = False) -> None:
        """Triton's unload_model: free the lazily built runner (device
        parameters are released unless shared with the serving pipeline);
        the model stays registered and reloads on next use.
        `unload_dependents` also unloads the target's composing models."""
        self._get(name).unload()
        if unload_dependents:
            for dep in self.ENSEMBLE_DEPENDENTS.get(name, ()):
                if dep in self._models:
                    self._models[dep].unload()

    def shutdown(self):
        for m in self._models.values():
            m.shutdown()


# --------------------------------------------------------------------- #
# runner builders


def _certified_fallback(slot: str, arch_ok: bool = True):
    """Lazy loader of one slot of a committed synthetic-certified
    checkpoint as a port `state_dict` ("det" or "pose" of the Lite4 + W32
    one, "higherhrnet" the pose slot of the bottom-up one), or None when
    the file is absent or the entry's architecture is not the certified one.
    Registry entries that share no pipeline module load these instead of
    random weights (the reference never serves untrained weights,
    README.md:13-26). Only the existence check runs at registry build; the
    npz is read when the model is loaded.

    `HBPE_DISABLE_CERTIFIED_FALLBACK=1` turns this off (the tiny-config CPU
    tests random-init instead of reading the full-size checkpoint)."""
    import os

    if not arch_ok or os.environ.get("HBPE_DISABLE_CERTIFIED_FALLBACK"):
        return None

    from human_body_proportion_estimation_tpu_torch.models.weights import (
        default_certified_bottomup_checkpoint,
        default_certified_checkpoint,
        maybe_load_certified,
    )

    bottom_up = slot == "higherhrnet"
    if not os.path.exists(default_certified_bottomup_checkpoint() if bottom_up
                          else default_certified_checkpoint()):
        return None

    def load():
        det_state, pose_state = maybe_load_certified(bottom_up)
        return det_state if slot == "det" else pose_state

    return load


def _standalone(make, state_loader, device):
    """A module the registry builds itself (`make()`): the certified
    weights when `state_loader` is given, else flax's init with
    PRNGKey(0) (`models.layers.init_random`, labelled "random" in the
    index), as the JAX registry's `_init_on_cpu`; on `device`, in eval
    mode."""
    from human_body_proportion_estimation_tpu_torch.models.layers import (
        init_random,
    )

    module = make()
    if state_loader is not None:
        module.load_state_dict(state_loader(), strict=True)
    else:
        init_random(module)
    return module.to(device).eval()


def _to_device(arr: np.ndarray, device):
    """A wire array as a tensor on `device` (arrays decoded from the wire
    are read-only views of the request: copied first on the host)."""
    import torch

    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _pad_rows(n: int, cap: int, dp: int) -> int:
    """The serving pipeline's power-of-two bucket, then at least dp rows
    and a multiple of dp (JAX `registry._pad_rows`)."""
    from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
        pad_to_shards,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        _pad_batch,
    )

    return pad_to_shards(_pad_batch(n, cap), dp)


def _mesh_dp(mesh) -> int:
    """The data-parallel degree an entry's runner shards over."""
    return mesh.shape["data"] if mesh is not None else 1


def _batched_runner(net, devices, max_batch: int, fn):
    """A numpy runner over `net` replicated on `devices` (one per data
    shard; `parallel.mesh.replica`): the rows padded to `_pad_rows`, cut
    into len(devices) contiguous shards, `fn(net_on_device, x_on_device)`
    -> {name: tensor} on each, the outputs concatenated in order and cut
    back to the request's rows."""
    import torch

    from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
        replica,
        split_rows,
    )

    nets = [replica(net, d) for d in devices]

    @torch.inference_mode()
    def run(x: np.ndarray) -> Dict[str, np.ndarray]:
        n = x.shape[0]
        b = _pad_rows(n, max_batch, len(devices))
        if b != n:
            x = np.concatenate([x, np.zeros((b - n,) + x.shape[1:],
                                            x.dtype)])
        outs = [fn(m, _to_device(part, d)) for m, d, (part,) in zip(
            nets, devices, split_rows([x], len(devices)))]
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs])[:n]
                for k in outs[0]}

    return run


def _hrnet_entry(cfg, device, pose=None,
                 weights: str = "random", mesh=None) -> ModelEntry:
    """`hrnet`: f32 NCHW crops -> "output" heatmaps [B, 17, 96, 72]
    (reference pose_est_hrnet_trtserver.py:22-25 reads "output"; NCHW is
    the port's own layout, so nothing is transposed). With `mesh` a batch
    is sharded over its data devices (`_batched_runner`)."""
    ch, cw = cfg.pose.crop_height, cfg.pose.crop_width
    k = cfg.pose.num_keypoints
    max_batch = cfg.serve.max_batch
    fallback = None
    if pose is None:
        fallback = _certified_fallback("pose", cfg.pose.name == "hrnet_w32")
        if fallback is not None:
            weights = "synthetic-certified"

    devices = [device] if mesh is None else mesh.data_devices

    def build():
        from human_body_proportion_estimation_tpu_torch.models.hrnet import (
            create_hrnet,
        )

        model = pose
        if model is None:
            model = _standalone(lambda: create_hrnet(cfg.pose.name),
                                fallback, devices[0])
        run = _batched_runner(model, devices, max_batch,
                              lambda m, x: {"output": m(x).float()})
        return lambda inputs: run(inputs["input"])

    return ModelEntry(
        name="hrnet",
        platform="pytorch",
        inputs=[TensorSpec("input", "FP32", (-1, 3, ch, cw))],
        outputs=[TensorSpec("output", "FP32",
                            (-1, k, ch // 4, cw // 4))],
        max_batch_size=max_batch,
        weights=weights,
        build=build,
        batch_timeout_ms=cfg.serve.batch_timeout_ms,
        dp=_mesh_dp(mesh),
    )


def _higherhrnet_entry(cfg, device, model=None,
                       weights: str = "random", mesh=None) -> ModelEntry:
    """`higherhrnet`: f32 NCHW image of any size -> "output_1" (K heatmaps +
    K AE tags, 1/4 res) and "output_2" (K heatmaps, 1/2 res), the tensor
    contract the reference reads (pose_est_hrnet_trtserver.py:22-28 uses
    output_2). `model`: the serving pipeline's HigherHRNet (the bottom-up
    pipeline's model, or a HigherHRNet pose slot's); else the entry builds
    its own at its first load: the certified bottom-up checkpoint where the
    repository holds it, as in the JAX registry, else at random, flax's
    init with PRNGKey(0) (`models.layers.init_random`). Rows are padded
    to the launch bucket as the `hrnet` entry pads them."""
    k = cfg.pose.num_keypoints
    max_batch = cfg.serve.max_batch
    fallback = None
    if model is None:
        fallback = _certified_fallback("higherhrnet")
        if fallback is not None:
            weights = "synthetic-certified"

    devices = [device] if mesh is None else mesh.data_devices

    def build():
        from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (  # noqa: E501
            HigherHRNet,
        )
        from human_body_proportion_estimation_tpu_torch.models.layers import (
            init_random,
        )

        net = model
        if net is None and fallback is not None:
            net = _standalone(HigherHRNet, fallback, devices[0])
        elif net is None:
            net = init_random(HigherHRNet()).to(devices[0]).eval()
        run = _batched_runner(net, devices, max_batch, lambda m, x: {
            name: out for name, out in m(x).items()
            if name in ("output_1", "output_2")})
        return lambda inputs: run(inputs["input"])

    return ModelEntry(
        name="higherhrnet",
        platform="pytorch",
        inputs=[TensorSpec("input", "FP32", (-1, 3, -1, -1))],
        outputs=[
            TensorSpec("output_1", "FP32", (-1, 2 * k, -1, -1)),
            TensorSpec("output_2", "FP32", (-1, k, -1, -1)),
        ],
        max_batch_size=max_batch,
        weights=weights,
        build=build,
        batch_timeout_ms=cfg.serve.batch_timeout_ms,
        dp=_mesh_dp(mesh),
    )


def _yolo_entry(cfg, device, variant: str, model=None,
                weights: str = "random", mesh=None) -> ModelEntry:
    """`yolov5m` / `yolov5s`: "images" f32 NCHW [B, 3, 640, 640] (already
    /255, reference obj_det_yolov5_trtserver.py:30-37) -> "output"
    [B, 25200, 85] decoded predictions (the layout its postprocess reads,
    :40-44). `model`: the serving pipeline's YOLOv5 of this variant, if it
    has one; else the entry builds its own at its first load, from
    `models.yolov5.init_random`."""
    size = 640
    max_batch = cfg.serve.max_batch

    devices = [device] if mesh is None else mesh.data_devices

    def build():
        from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
            VARIANTS,
            YoloV5,
            decode_predictions,
            init_random,
        )

        net = model
        if net is None:
            net = init_random(YoloV5(VARIANTS[variant])).to(
                devices[0]).eval()
        run = _batched_runner(net, devices, max_batch, lambda m, x: {
            "output": decode_predictions(m(x), m.config.num_classes)})
        return lambda inputs: run(inputs["images"])

    n_pred = sum((size // s) ** 2 * 3 for s in (8, 16, 32))  # 25200
    return ModelEntry(
        name=variant,
        platform="pytorch",
        inputs=[TensorSpec("images", "FP32", (-1, 3, size, size))],
        outputs=[TensorSpec("output", "FP32", (-1, n_pred, 85))],
        max_batch_size=max_batch,
        weights=weights,
        build=build,
        batch_timeout_ms=cfg.serve.batch_timeout_ms,
        dp=_mesh_dp(mesh),
    )


def _ssd_entry(cfg, device, model=None, anchors=None) -> ModelEntry:
    """`ssd_mobilenet`: the reference's TFLite alternative detector as a
    repository model, whose weights are always real (the checked-in
    ssd.tflite, reference `modules/human_detector.py:10`). The wire
    contract is the TFLite_Detection_PostProcess outputs the reference
    reads (`human_detector.py:31-38`): normalized y1x1y2x2 boxes, 0-based
    background-stripped classes (person 0), scores, num_detections.
    `model` / `anchors`: the serving pipeline's SSD and its anchor table
    when its detector slot is SSD; else the entry reads the tflite at its
    first load (ValueError naming the path when absent). The
    wire image is resized to 300x300 with cv2 on the host, the
    postprocess is one NMS sweep launch ([1, 128])."""
    nd = 10  # TFLite_Detection_PostProcess max_detections

    def build():
        import torch

        from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (  # noqa: E501
            load_ssd,
            ssd_postprocess,
        )
        from human_body_proportion_estimation_tpu_torch.pipeline.host import (
            resize_for_detector,
        )

        net, table = model, anchors
        if net is None:
            net, table = load_ssd(device=device)

        @torch.inference_mode()
        def run(inputs):
            img = resize_for_detector(inputs["image"][0], 300, 300)[None]
            box_regs, logits = net(_to_device(img, device))
            det = ssd_postprocess(box_regs, logits, table)
            boxes, scores, classes, valid = (
                t.cpu().numpy() for t in (det.boxes, det.scores,
                                          det.classes, det.valid))
            return {
                "detection_boxes": boxes.astype(np.float32),
                "detection_classes": classes.astype(np.float32),
                "detection_scores": scores.astype(np.float32),
                "num_detections": valid.sum(-1).astype(np.float32),
            }

        return run

    return ModelEntry(
        name="ssd_mobilenet",
        platform="pytorch",
        inputs=[TensorSpec("image", "UINT8", (1, -1, -1, 3))],
        outputs=[
            TensorSpec("detection_boxes", "FP32", (1, nd, 4)),
            TensorSpec("detection_classes", "FP32", (1, nd)),
            TensorSpec("detection_scores", "FP32", (1, nd)),
            TensorSpec("num_detections", "FP32", (1,)),
        ],
        max_batch_size=0,
        weights="real",  # ssd.tflite import, never random
        build=build,
    )


def _build_edet_core(cfg, det_config, device, detector=None):
    """The shared lazily built detection core of the three EfficientDet
    models: the detector (shared, or built on `device`), its anchors on
    the device, and the `raw` / `modified` bodies producing the 100-slot
    raw tensors and the person-filtered / expanded / cropped stages of
    `models/conv.py`."""
    import torch

    from human_body_proportion_estimation_tpu_torch.models.anchors import (
        generate_anchors,
    )
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
        EFFICIENTDET_LITE4,
        EfficientDet,
        postprocess,
    )
    from human_body_proportion_estimation_tpu_torch.ops import (
        boxes as box_ops,
        crop as crop_ops,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.full import (
        select_persons,
    )

    h, w = cfg.detector.input_height, cfg.detector.input_width
    model = detector
    if model is None:
        fallback = _certified_fallback("det", det_config == EFFICIENTDET_LITE4)
        model = _standalone(lambda: EfficientDet(det_config), fallback,
                            device)
    anchors = torch.from_numpy(
        generate_anchors(model.config.anchors, h, w)).to(device)

    def raw(img_u8):
        """[1,h,w,3] u8 -> 100-slot (boxes px yxyx, scores, classes
        1-based, valid): the raw `edetlite4` SavedModel contract
        (output[i][0], reference models/conv.py:16-18)."""
        cls_logits, box_regs = model(img_u8.float(), all_classes=True)
        return postprocess(
            cls_logits[0], box_regs[0], (h, w), anchors, model.config,
            iou_threshold=cfg.detector.iou_threshold,
            top_k=cfg.detector.nms_top_k,
        )

    def modified(img_u8, det_thres, det_xy_change):
        """The `edetlite4_modified` graph (models/conv.py:14-86): person
        filter -> score threshold -> top-3 -> bbox expand by +/-xy ->
        normalize -> /255 crop -> NCHW, plus the raw tensors."""
        boxes, scores, classes, valid = raw(img_u8)
        pboxes, _, pvalid = select_persons(
            boxes[None], scores[None], classes[None], valid[None],
            torch.tensor([float(det_thres[0])], device=device),
            cfg.detector.person_class_id, cfg.detector.max_persons,
        )
        boxes_norm = box_ops.expand_clip_normalize_yxyx(
            pboxes[0], float(det_xy_change[0]), float(det_xy_change[1]),
            h, w,
        )
        crops = crop_ops.crop_and_resize(
            img_u8[0].float() / 255.0, boxes_norm,
            cfg.pose.crop_height, cfg.pose.crop_width,
        )
        # conv.py:72-79 no-detection fallback: HRNet sees ZEROS, not a
        # zero-area crop's samples, so invalid slots are zeroed exactly
        crops = torch.where(pvalid[0][:, None, None, None], crops, 0.0)
        crops_nchw = crops.permute(0, 3, 1, 2).contiguous()
        return boxes, scores, classes, boxes_norm, crops_nchw, pvalid[0]

    return model, raw, modified


def _edet_entries(cfg, det_config, device, detector=None, pose=None,
                  det_weights: str = "random",
                  pose_weights: str = "random") -> List[ModelEntry]:
    """`edetlite4`, `edetlite4_modified`, `ensemble_edet4_person_det_pose`
    — sharing one lazily built detection core (and the serving pipeline's
    modules when given)."""
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
        EFFICIENTDET_LITE4,
    )

    h, w = cfg.detector.input_height, cfg.detector.input_width
    ch, cw = cfg.pose.crop_height, cfg.pose.crop_width
    k = cfg.pose.num_keypoints
    state: Dict[str, Any] = {}
    lock = threading.Lock()

    # metadata mirrors the lazy certified-checkpoint fallbacks that the
    # build paths below take (_build_edet_core / build_ensemble)
    if detector is None and _certified_fallback(
            "det", det_config == EFFICIENTDET_LITE4) is not None:
        det_weights = "synthetic-certified"
    pose_fallback = None
    if pose is None:
        pose_fallback = _certified_fallback(
            "pose", cfg.pose.name == "hrnet_w32")
        if pose_fallback is not None:
            pose_weights = "synthetic-certified"

    def core():
        with lock:
            if "core" not in state:
                state["core"] = _build_edet_core(cfg, det_config, device,
                                                 detector)
        return state["core"]

    def prep(img_wire: np.ndarray):
        """Wire image [1,H,W,3] u8 -> det-input-sized batch on the device
        + the scale factors mapping det-input pixels back to wire pixels."""
        from human_body_proportion_estimation_tpu_torch.pipeline.host import (
            resize_for_detector,
        )

        wire_h, wire_w = img_wire.shape[1:3]
        img = resize_for_detector(img_wire[0], w, h)[None]
        scale = np.array(
            [wire_h / h, wire_w / w, wire_h / h, wire_w / w], np.float32
        )
        return _to_device(img, device), scale

    def numpy(*tensors):
        return [t.cpu().numpy() for t in tensors]

    def build_raw():
        import torch

        _, raw, _ = core()

        @torch.inference_mode()
        def run(inputs):
            img, scale = prep(inputs["image"])
            boxes, scores, classes, _valid = numpy(*raw(img))
            return {
                "output_0": (boxes * scale)[None],
                "output_1": scores[None],
                "output_2": classes[None],
            }

        return run

    def build_modified():
        import torch

        _, _, modified = core()

        @torch.inference_mode()
        def run(inputs):
            img, scale = prep(inputs["edet_input_image"])
            boxes, scores, classes, boxes_norm, crops, pvalid = numpy(
                *modified(img, inputs["det_thres"], inputs["det_xy_change"]))
            n = int(pvalid.sum())
            human_crops = (
                crops[:n] if n
                else np.zeros((1, 3, ch, cw), np.float32)  # conv.py:72-79
            )
            return {
                "detection_boxes": boxes * scale,
                "detection_scores": scores,
                "detection_classes": classes,
                "filtered_boxes": boxes_norm[:n],  # normalized: scale-free
                "human_crops": human_crops,
            }

        return run

    def build_ensemble():
        import torch

        from human_body_proportion_estimation_tpu_torch.models.hrnet import (
            create_hrnet,
        )

        _, _, modified = core()
        pmodel = pose
        if pmodel is None:
            pmodel = _standalone(lambda: create_hrnet(cfg.pose.name),
                                 pose_fallback, device)

        @torch.inference_mode()
        def run(inputs):
            img, _scale = prep(inputs["edet_input_image"])
            _, _, _, boxes_norm, crops, valid = modified(
                img, inputs["det_thres"], inputs["det_xy_change"])
            heatmaps = pmodel(crops).float()
            boxes_norm, heatmaps, valid = numpy(boxes_norm, heatmaps, valid)
            n = int(valid.sum())
            return {
                # normalized expanded person boxes, de-normalized by the
                # CLIENT against its image dims (reference client :142-145)
                "ENSEMBLE_OUTPUT_FILTER_DET_BOXES": boxes_norm[:n],
                # n == 0 -> heatmaps of the single zero crop, like the
                # reference ensemble running hrnet on conv.py's fallback
                "ENSEMBLE_OUTPUT_HEATMAPS": heatmaps[:max(n, 1)],
            }

        return run

    mod_inputs = [
        TensorSpec("edet_input_image", "UINT8", (1, -1, -1, 3)),
        TensorSpec("det_thres", "FP32", (1,)),
        TensorSpec("det_xy_change", "FP32", (2,)),
    ]
    nd = 100  # EfficientDet max_detections (conv.py:16-18 "100,4")
    entries = [
        ModelEntry(
            name="edetlite4",
            platform="pytorch",
            inputs=[TensorSpec("image", "UINT8", (1, -1, -1, 3))],
            outputs=[
                TensorSpec("output_0", "FP32", (1, nd, 4)),
                TensorSpec("output_1", "FP32", (1, nd)),
                TensorSpec("output_2", "FP32", (1, nd)),
            ],
            max_batch_size=0,
            weights=det_weights,
            build=build_raw,
        ),
        ModelEntry(
            name="edetlite4_modified",
            platform="pytorch",
            inputs=mod_inputs,
            outputs=[
                TensorSpec("detection_boxes", "FP32", (nd, 4)),
                TensorSpec("detection_scores", "FP32", (nd,)),
                TensorSpec("detection_classes", "FP32", (nd,)),
                TensorSpec("filtered_boxes", "FP32", (-1, 4)),
                TensorSpec("human_crops", "FP32", (-1, 3, ch, cw)),
            ],
            max_batch_size=0,
            weights=det_weights,
            build=build_modified,
        ),
        ModelEntry(
            name="ensemble_edet4_person_det_pose",
            platform="pytorch_ensemble",
            inputs=mod_inputs,
            outputs=[
                TensorSpec("ENSEMBLE_OUTPUT_FILTER_DET_BOXES", "FP32",
                           (-1, 4)),
                TensorSpec("ENSEMBLE_OUTPUT_HEATMAPS", "FP32",
                           (-1, k, ch // 4, cw // 4)),
            ],
            max_batch_size=0,
            weights=(
                # weakest slot wins; non-random origins ("real",
                # "synthetic-certified") propagate when they agree
                "random" if "random" in (det_weights, pose_weights)
                else det_weights if det_weights == pose_weights
                else "mixed"
            ),
            build=build_ensemble,
        ),
    ]

    def release_core():
        # the three entries share one lazily built detection core; free it
        # (parameters included, unless they came from the serving
        # pipeline) only when NONE of them still holds a runner
        with lock:
            if not any(e.loaded for e in entries):
                state.pop("core", None)

    for e in entries:
        e.on_unload = release_core
    return entries


def build_registry(pipeline=None, device=None, mesh=None) -> ModelRegistry:
    """The default repository (the reference's model-repo roster, README
    :71-80), sharing the
    serving pipeline's pose model and detector when given, so that
    registry inference adds no device memory: an HRNet pose with `hrnet`
    and the EfficientDet models' ensemble, a HigherHRNet pose with
    `higherhrnet`, the EfficientDet detector (Lite4 or Lite0) with the
    EfficientDet models, a YOLOv5 with the `yolov5*` entry of its variant,
    an SSD with `ssd_mobilenet`;
    a bottom-up pipeline's HigherHRNet with `higherhrnet` (the other models
    are then built as with no pipeline, as in the JAX registry). An
    artifact's pipeline (`pipeline.export.ArtifactPipeline`) has no module
    to share: every model is built as with no pipeline, in the artifact's
    configuration, as the JAX registry builds them beside an artifact.

    The configuration is the pipeline's, else the default one. `device`:
    where the runners run; the pipeline's device by default, else CUDA.
    `mesh` (the pipeline's by default, as in JAX): the `hrnet`,
    `higherhrnet` and `yolov5*` runners shard each coalesced batch over
    its data devices, and report its dp as `instance_group.count`; the
    EfficientDet models run on the first one, as JAX's are unsharded.
    """
    import torch

    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
        EFFICIENTDET_LITE4,
    )
    from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
        HigherHRNetHeatmaps,
    )
    from human_body_proportion_estimation_tpu_torch.models.hrnet import (
        HRNet,
    )
    from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
        VARIANTS,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.backends import (
        SSDBackend,
        YoloBackend,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
        BottomUpPipeline,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        PipelineConfig,
    )

    cfg = PipelineConfig()
    pose = det = higher = None
    det_config = EFFICIENTDET_LITE4
    det_weights = pose_weights = higher_weights = "random"
    yolo: Dict[str, Tuple[Any, str]] = {}
    ssd: Tuple[Any, ...] = ()
    if mesh is None:
        mesh = getattr(pipeline, "mesh", None)
    if mesh is not None:
        device = device or mesh.data_devices[0]
    if pipeline is not None:
        cfg = pipeline.config
        origin = pipeline.weights_origin
        device = device or pipeline.device
    if isinstance(pipeline, BottomUpPipeline):
        higher, higher_weights = pipeline.model, origin["pose"]
    elif getattr(pipeline, "backend", None) is not None:
        if isinstance(pipeline.pose, HRNet):
            pose, pose_weights = pipeline.pose, origin["pose"]
        elif isinstance(pipeline.pose, HigherHRNetHeatmaps):
            higher, higher_weights = pipeline.pose.higher, origin["pose"]
        backend = pipeline.backend
        if isinstance(backend, YoloBackend):
            # the serving detector is a YOLOv5: the yolo entry of its
            # variant shares it; the EfficientDet models build their own
            variant = {cfg_: name for name, cfg_ in VARIANTS.items()}.get(
                backend.model.config)
            if variant is not None:
                yolo[variant] = (backend.model, origin["detector"])
        elif isinstance(backend, SSDBackend):
            # the serving detector is the SSD: `ssd_mobilenet` shares it
            # and its anchors; the EfficientDet models build their own
            ssd = (backend.model, backend.anchors)
        else:
            det = backend.detector
            det_config, det_weights = det.config, origin["detector"]
    device = torch.device(device or "cuda")

    reg = ModelRegistry()
    for e in (
        _hrnet_entry(cfg, device, pose, pose_weights, mesh=mesh),
        _higherhrnet_entry(cfg, device, higher, higher_weights, mesh=mesh),
        _yolo_entry(cfg, device, "yolov5m", *yolo.get("yolov5m", ()),
                    mesh=mesh),
        _yolo_entry(cfg, device, "yolov5s", *yolo.get("yolov5s", ()),
                    mesh=mesh),
        _ssd_entry(cfg, device, *ssd),
        *_edet_entries(cfg, det_config, device, det, pose,
                       det_weights=det_weights, pose_weights=pose_weights),
    ):
        reg.register(e)
    return reg
