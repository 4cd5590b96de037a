"""HTTP serving edge of the port, self-contained on the stdlib: the JAX
package's `serve/server.py` over the port's `InferencePipeline` (or, with
`--bottom-up`, its `BottomUpPipeline`; with `--artifact-dir`, an exported
artifact's `pipeline.export.ArtifactPipeline`) on the GPU.

Route/response parity with `uvicorn_server/server.py` and the JAX server
(same status codes, JSON shapes and messages):
  POST /body_proportion_length_estimation_file
      multipart form: `file` (image), `person_height_in_cm` (int, default
      175), `threshold` (float, default 0.70), optional `back_url`
      -> {"code", "msg", "body_proportion_lengths_(cm)"}; any exception
      returns the "failed" JSON, never a 500; a full queue returns 503.
  POST /body_proportion_length_estimation_video[_stream]
      per-frame person-0 results + a median summary (the _stream variant
      as chunked NDJSON: header line, frame lines in order, summary last).
  GET  /, /health, /metrics, /docs, /openapi.json, /v2, /v2/health/live,
       /v2/health/ready; GET and POST /v2/logging, /v2/trace/setting.
  The model registry's KServe-v2 routes (`serve/registry.py`):
  GET  /v2/models, /v2/models/stats,
       /v2/models/<name>[/versions/<v>][/config|/ready|/stats]
  POST /v2/repository/index, /v2/repository/models/<name>/load|unload,
       /v2/models/<name>[/versions/<v>]/infer (JSON tensors or the
       binary_tensor_data transport).

`main` also starts the gRPC edge (`serve/grpc_server.py`: the hbpe service
and the stock KServe service on one port, 8081 by default).

Architecture: request threads decode bytes, submit decoded images to the
batcher (the C++ `NativeBatcher` with two batches in flight, or the Python
`DynamicBatcher` if the native core cannot be built), which coalesces them
into `infer_serving` calls on the card. `back_url` POSTs the response
fire-and-log with (3, 100) timeouts, as `ModelProcessTask.run` does
(server.py:69-82).
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List

import numpy as np

from human_body_proportion_estimation_tpu_torch.cli.common import (
    checkpoint_states,
    option_problems,
)
from human_body_proportion_estimation_tpu_torch.ops import (
    proportions as prop_ops,
)
from human_body_proportion_estimation_tpu_torch.pipeline.host import (
    InferencePipeline,
    decode_image_bytes,
)
from human_body_proportion_estimation_tpu_torch.serve import tracing
from human_body_proportion_estimation_tpu_torch.serve.batching import (
    DynamicBatcher,
    Metrics,
)
from human_body_proportion_estimation_tpu_torch.serve.http import (
    parse_multipart,
)
from human_body_proportion_estimation_tpu_torch.serve.openapi import (
    build_schema,
)
from human_body_proportion_estimation_tpu_torch.serve.registry import (
    NP_TO_TRITON,
    TRITON_TO_NP,
)
from human_body_proportion_estimation_tpu_torch.serve.wire import (
    _classification_rows,
    serialize_bytes_tensor,
)
from human_body_proportion_estimation_tpu_torch.utils import (
    compile_cache,
    logging as hbpe_logging,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    PipelineConfig,
)
from human_body_proportion_estimation_tpu_torch.utils.profiling import (
    StageTimer,
)

log = hbpe_logging.get_logger("serve")

FAIL_MSG = (
    "Failed to run inference on image. Please use an image with one fully "
    "visible human."
)
WELCOME = {
    "Welcome to Human Body Proportion Estimation Web Service":
        "Please visit /docs"
}
# the KServe-v2 protocol extensions this server implements (the JAX
# server's list; the gRPC services report the same)
V2_EXTENSIONS = [
    "health", "model_repository", "model_repository(unload_dependents)",
    "model_configuration", "statistics", "binary_tensor_data",
    "classification", "parameters", "logging", "trace",
]

# /docs: the interactive Swagger-UI page FastAPI auto-serves in the
# reference (uvicorn_server/server.py:122-124 points users here): a tiny
# HTML shell pulling the swagger-ui bundle from the public CDN and
# rendering /openapi.json, as FastAPI's get_swagger_ui_html does.
_SWAGGER_UI_HTML = """<!DOCTYPE html>
<html>
<head>
  <meta charset="utf-8"/>
  <title>Human Body Proportion Estimation - Swagger UI</title>
  <link rel="stylesheet"
        href="https://cdn.jsdelivr.net/npm/swagger-ui-dist@5/swagger-ui.css"/>
</head>
<body>
  <div id="swagger-ui"></div>
  <script src="https://cdn.jsdelivr.net/npm/swagger-ui-dist@5/swagger-ui-bundle.js"></script>
  <script>
    window.onload = () => {
      window.ui = SwaggerUIBundle({
        url: "/openapi.json",
        dom_id: "#swagger-ui",
        presets: [SwaggerUIBundle.presets.apis],
        layout: "BaseLayout",
      });
    };
  </script>
</body>
</html>
"""


def _form_fields(form, defaults: Dict[str, Any]) -> List[Any]:
    """The named form fields, each converted to its default's type (text
    is decoded), or the default where the field is absent. A field that
    does not convert raises ValueError (the failed JSON)."""
    out = []
    for k, d in defaults.items():
        if k not in form:
            out.append(d)
        elif isinstance(d, str):
            out.append(form[k].data.decode())
        else:
            out.append(type(d)(form[k].data))
    return out


class ServingApp:
    """Pipeline + batcher + metrics; handler classes bind to one instance."""

    # frames submitted to the batcher per wave: bounds decoded-frame memory
    # and one upload's share of the batcher queue
    VIDEO_CHUNK = 64
    # default frame cap of the AGGREGATE video route (one minute at 30 fps):
    # its response holds every frame's dict; max_frames=0 opts out, and the
    # _stream route has no cap (it never buffers)
    DEFAULT_MAX_VIDEO_FRAMES = 1800

    def __init__(self, pipeline: InferencePipeline,
                 config: PipelineConfig | None = None):
        self.pipeline = pipeline
        self.config = config or pipeline.config
        self.metrics = Metrics()
        # per-stage latency split for /metrics: request decode (handler
        # threads), the batcher's slot wait, forward and answer, and
        # inside the forward host prepare, device upload and device
        # compute + readback (InferencePipeline.infer_serving)
        self.stages = StageTimer()
        pipeline.stages = self.stages
        self._registry = None
        self._registry_lock = threading.Lock()
        serve_cfg = self.config.serve
        self.native = False
        if serve_cfg.native_batcher:
            try:
                from human_body_proportion_estimation_tpu_torch.serve.native import (  # noqa: E501
                    NativeBatcher,
                )

                self.batcher = NativeBatcher(
                    self._run_batch,
                    max_batch=serve_cfg.max_batch,
                    batch_timeout_ms=serve_cfg.batch_timeout_ms,
                    queue_depth=serve_cfg.queue_depth,
                    stages=self.stages,
                )
                self.native = True
            except Exception as e:  # noqa: BLE001 — toolchain missing
                log.warning("native_core_unavailable", error=str(e))
        if not self.native:
            self.batcher = DynamicBatcher(
                self._run_batch,
                max_batch=serve_cfg.max_batch,
                batch_timeout_ms=serve_cfg.batch_timeout_ms,
                queue_depth=serve_cfg.queue_depth,
                metrics=self.metrics,
                stages=self.stages,
            )

    @property
    def registry(self):
        """The named-model repository (`serve/registry.py`), built at first
        use so that a deployment of the domain routes alone pays nothing;
        it shares the serving pipeline's modules. Built under a lock:
        concurrent first requests must not build two registries (the
        loser's batcher threads would outlive shutdown)."""
        if self._registry is None:
            with self._registry_lock:
                if self._registry is None:
                    from human_body_proportion_estimation_tpu_torch.serve.registry import (  # noqa: E501
                        build_registry,
                    )

                    self._registry = build_registry(self.pipeline)
        return self._registry

    def metrics_snapshot(self) -> Dict[str, Any]:
        stages = {"stages": self.stages.snapshot()}
        if self._registry is not None:
            # per-model figures, once the repository has been touched
            # (reading /metrics does not build it)
            stages["models"] = self._registry.stats()
        if self.native:
            m = self.batcher.metrics_json()
            # the key set of the Python engine: runner exceptions are
            # failures, back-pressure rejections stay under "rejected"
            m["requests_total"] = m.get("completed", 0)
            m["failures_total"] = m.get("failed", 0)
            m["batches_total"] = m.get("batches", 0)
            return {"engine": "native", **m, **stages}
        return {"engine": "python", **self.metrics.snapshot(), **stages}

    def health(self) -> Dict[str, Any]:
        """/health: the JAX server's keys, with the CUDA devices' names and
        the card's memory (None for a CPU pipeline, as JAX reports for the
        CPU)."""
        import torch

        dev = self.pipeline.device
        payload: Dict[str, Any] = {"status": "ok", "devices": [str(dev)]}
        in_use = limit = None
        if dev.type == "cuda":
            payload["devices"] = [torch.cuda.get_device_name(i)
                                  for i in range(torch.cuda.device_count())]
            in_use = torch.cuda.memory_allocated(dev)
            limit = torch.cuda.mem_get_info(dev)[1]
        payload.update(
            # real|synthetic-certified per model slot
            weights=self.pipeline.weights_origin,
            # True once every batch bucket has run (--prewarm)
            prewarmed=self.pipeline.prewarmed,
            hbm_bytes_in_use=in_use,
            hbm_bytes_limit=limit,
        )
        return payload

    def _run_batch(self, payloads: List[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
        images = [p["image"] for p in payloads]
        heights = [[p["height"]] for p in payloads]
        thresholds = [p["threshold"] for p in payloads]
        # packed [n, P, 23] = valid | 11 lengths | 11 visibility
        packed = self.pipeline.infer_serving(
            images, person_heights=heights, det_threshold=thresholds
        )
        responses = []
        for row in packed:
            # first valid person slot (the reference serves person 0 only,
            # server.py:61-67)
            slot = next((s for s in range(row.shape[0]) if row[s, 0] > 0.5),
                        None)
            if slot is None:
                responses.append({
                    "code": "success",
                    "msg": "No humans detected",
                    "body_proportion_lengths_(cm)": {},
                })
            else:
                responses.append({
                    "code": "success",
                    "msg": "human body proportion estimation complete",
                    "body_proportion_lengths_(cm)": prop_ops.to_dist_dict(
                        row[slot, 1:12], row[slot, 12:23] > 0.5),
                })
        return responses

    def handle_estimation(self, form) -> Dict[str, Any]:
        if "file" not in form:
            raise ValueError("missing 'file' form field")
        height, threshold, back_url = _form_fields(form, {
            "person_height_in_cm": 175, "threshold": 0.70, "back_url": ""})
        with self.stages.stage("request_decode"):
            image = decode_image_bytes(form["file"].data)
        response = self.batcher.infer(
            {"image": image, "height": height, "threshold": threshold}
        )
        if back_url:
            self._post_webhook(back_url, response)
        return response

    def handle_video_estimation(self, form) -> Dict[str, Any]:
        """POST /body_proportion_length_estimation_video: the frames go
        through the same batcher as image requests; per-frame person-0
        results plus the median across frames."""
        if "file" not in form:
            raise ValueError("missing 'file' form field")
        height, threshold, back_url, frame_stride, max_frames = _form_fields(
            form, {"person_height_in_cm": 175, "threshold": 0.70,
                   "back_url": "", "frame_stride": 1,
                   "max_frames": self.DEFAULT_MAX_VIDEO_FRAMES})
        response = self.run_video(
            form["file"].data, height, threshold, frame_stride, max_frames
        )
        if back_url:
            self._post_webhook(back_url, response)
        return response

    def open_video_stream_form(self, form):
        """Parse the streaming route's form and open the frame stream:
        (fps, frame_stride, per-frame iterator). Raises before any byte is
        streamed on a bad form or an undecodable video, so the handler can
        still answer with the single failed JSON."""
        if "file" not in form:
            raise ValueError("missing 'file' form field")
        height, threshold, frame_stride, max_frames = _form_fields(form, {
            "person_height_in_cm": 175, "threshold": 0.70,
            "frame_stride": 1, "max_frames": 0})
        fps, it = self.open_video_stream(
            form["file"].data, height, threshold, frame_stride, max_frames
        )
        return fps, frame_stride, it

    def open_video_stream(self, video_bytes: bytes, height: float,
                          threshold: float, frame_stride: int = 1,
                          max_frames: int = 0):
        """Decode a video and pipeline its frames through the batcher,
        yielding per-frame dicts IN FRAME ORDER: (fps, iterator). A sliding
        window of VIDEO_CHUNK pending futures keeps the batcher fed while
        bounding decoded-frame memory."""
        from collections import deque

        from human_body_proportion_estimation_tpu_torch.utils.io import (
            stream_video_bytes,
        )

        frames, fps = stream_video_bytes(video_bytes, frame_stride)

        def gen():
            pending: deque = deque()  # (original frame index, Future)

            def drain_one() -> Dict[str, Any]:
                idx, fut = pending.popleft()
                r = fut.result()
                return {
                    "frame": idx,
                    "msg": r["msg"],
                    "body_proportion_lengths_(cm)":
                        r["body_proportion_lengths_(cm)"],
                }

            for n, frame in enumerate(frames):
                if max_frames and n >= max_frames:
                    frames.close()
                    break
                payload = {"image": frame, "height": height,
                           "threshold": threshold}
                try:
                    fut = self.batcher.submit(payload)
                except queue.Full:
                    # our own window may be what filled the queue: finish
                    # it and retry once before giving up
                    while pending:
                        yield drain_one()
                    fut = self.batcher.submit(payload)
                pending.append((n * frame_stride, fut))
                if len(pending) >= self.VIDEO_CHUNK:
                    yield drain_one()
            while pending:
                yield drain_one()

        return fps, gen()

    def run_video(self, video_bytes: bytes, height: float, threshold: float,
                  frame_stride: int = 1, max_frames: int = 0
                  ) -> Dict[str, Any]:
        fps, it = self.open_video_stream(
            video_bytes, height, threshold, frame_stride, max_frames
        )
        return self.summarize_video(list(it), fps, frame_stride)

    @staticmethod
    def summarize_video(per_frame: List[Dict[str, Any]], fps: float,
                        frame_stride: int) -> Dict[str, Any]:
        """Per-frame results -> the video response (median across frames
        per segment)."""
        numeric: Dict[str, List[float]] = {}
        found_any = False
        for f in per_frame:
            if f["msg"] != "No humans detected":
                found_any = True
            for k, v in f["body_proportion_lengths_(cm)"].items():
                if isinstance(v, (int, float)):
                    numeric.setdefault(k, []).append(float(v))
        summary = {
            k: float(np.median(v)) for k, v in sorted(numeric.items())
        }
        return {
            "code": "success",
            "msg": ("human body proportion estimation complete"
                    if found_any else "No humans detected"),
            "fps": fps,
            "frame_stride": frame_stride,
            "num_frames_processed": len(per_frame),
            "frames": per_frame,
            "median_body_proportion_lengths_(cm)": summary,
        }

    @staticmethod
    def _post_webhook(url: str, payload: Dict[str, Any]):
        # fire-and-log, like ModelProcessTask (server.py:69-82)
        try:
            import requests

            requests.post(
                url,
                headers={"Content-Type": "application/json"},
                data=json.dumps(payload),
                timeout=(3, 100),
            )
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            log.error("webhook_failed", error=str(e))

    def shutdown(self):
        self.batcher.shutdown()
        if self._registry is not None:
            self._registry.shutdown()


def _json_default(o):
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not serializable: {type(o)}")


def _model_path(path: str):
    """/v2/models/<name>[/versions/<v>]/<rest...> -> (name, version or "",
    [rest...])."""
    parts = path[len("/v2/models/"):].split("/")
    name, version, rest = parts[0], "", parts[1:]
    if len(rest) >= 2 and rest[0] == "versions":
        version, rest = rest[1], rest[2:]
    return name, version, rest


def make_handler(app: ServingApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send_json(self, obj, status=200):
            body = json.dumps(obj, default=_json_default).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_ndjson_stream(self, lines):
            """Chunked application/x-ndjson: one JSON object per line,
            written as each becomes available."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for obj in lines:
                data = json.dumps(obj, default=_json_default).encode() \
                    + b"\n"
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def do_GET(self):
            if self.path == "/":
                self._send_json(WELCOME)
            elif self.path == "/health":
                self._send_json(app.health())
            elif self.path == "/metrics":
                self._send_json(app.metrics_snapshot())
            elif self.path in ("/v2/health/live", "/v2/health/ready"):
                # KServe-v2 liveness/readiness: a process that answers is
                # both live and ready
                self._send_json({self.path.rsplit("/", 1)[1]: True})
            elif self.path == "/v2":
                from human_body_proportion_estimation_tpu_torch import (
                    __version__,
                )

                self._send_json({
                    "name": "human_body_proportion_estimation_tpu_torch",
                    "version": __version__,
                    "extensions": V2_EXTENSIONS,
                })
            elif self.path == "/v2/logging":
                # Triton logging extension (get_log_settings)
                self._send_json(hbpe_logging.log_settings())
            elif self.path == "/v2/trace/setting":
                # Triton trace extension (get_trace_settings)
                self._send_json(tracing.TRACER.settings())
            elif self.path == "/v2/models/stats":
                # all-models statistics (get_inference_statistics, no name)
                self._send_json(app.registry.statistics())
            elif self.path == "/v2/models":
                # repository index (read-only mirror of RepositoryIndex)
                self._send_json({"models": app.registry.index()})
            elif self.path.startswith("/v2/models/"):
                self._v2_model_get()
            elif self.path == "/docs":
                body = _SWAGGER_UI_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/openapi.json":
                self._send_json(build_schema(app.DEFAULT_MAX_VIDEO_FRAMES))
            else:
                self._send_json({"detail": "Not Found"}, 404)

        def _v2_model_get(self):
            """GET /v2/models/<name>[/versions/<v>][/config|/ready|/stats]:
            metadata, config, readiness and statistics, the KServe-v2
            layout tritonclient drives; 404 {"detail": ...} for an unknown
            name or version."""
            name, version, rest = _model_path(self.path)
            try:
                if rest == ["config"]:
                    self._send_json(app.registry.config(name, version))
                elif rest == ["ready"]:
                    # every registered model is lazily servable -> ready
                    app.registry.metadata(name, version)
                    self._send_json({"name": name, "ready": True})
                elif rest == ["stats"]:
                    self._send_json(app.registry.statistics(name, version))
                elif not rest:
                    self._send_json(app.registry.metadata(name, version))
                else:
                    self._send_json({"detail": "Not Found"}, 404)
            except KeyError as e:
                self._send_json({"detail": str(e)}, 404)

        def _stream_video(self, form):
            """Header line, per-frame lines in order, summary line last.
            Errors before the first byte fall back to the single failed
            JSON; mid-stream errors end the stream with a code='failed'
            line."""
            fps, stride, frames = app.open_video_stream_form(form)

            def lines():
                yield {"code": "success", "fps": fps,
                       "frame_stride": stride}
                collected = []
                try:
                    for f in frames:
                        collected.append(f)
                        yield f
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    log.error("video_stream_failed", error=str(e))
                    yield {"code": "failed", "msg": FAIL_MSG}
                    return
                summary = app.summarize_video(collected, fps, stride)
                summary.pop("frames")  # already streamed line by line
                yield summary

            self._send_ndjson_stream(lines())

        def _v2_settings_update(self):
            """POST /v2/logging | /v2/trace/setting: a JSON body with the
            fields to change; the answer is the whole resulting settings
            document; unknown fields or bad values are the extensions'
            400 {"error": ...}."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                updates = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(updates, dict):
                    raise ValueError("body must be a JSON object")
                if self.path == "/v2/logging":
                    self._send_json(hbpe_logging.configure_logging(updates))
                else:
                    self._send_json(tracing.TRACER.update(updates))
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json({"error": str(e)}, 400)

        def _v2_repository(self):
            """POST /v2/repository/index and
            POST /v2/repository/models/<name>/load|unload — Triton's
            model-repository HTTP extension (tritonclient.http
            get_model_repository_index / load_model / unload_model). Index
            takes an optional JSON body {"ready": bool} and returns the
            repository rows; load/unload return an empty 200 on success
            and the extension's {"error": ...} 400 otherwise."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                if self.path == "/v2/repository/index":
                    doc = json.loads(body or b"{}")
                    if not isinstance(doc, dict):
                        raise ValueError("body must be a JSON object")
                    ready_only = bool(doc.get("ready", False))
                    rows = [
                        {"name": r["name"], "version": r["version"],
                         "state": r["state"], "reason": ""}
                        for r in app.registry.index()
                        if not ready_only or r["state"] == "READY"
                    ]
                    self._send_json(rows)
                    return
                prefix = "/v2/repository/models/"
                if not self.path.startswith(prefix):
                    self._send_json({"detail": "Not Found"}, 404)
                    return
                parts = self.path[len(prefix):].split("/")
                if len(parts) != 2 or parts[1] not in ("load", "unload"):
                    self._send_json({"detail": "Not Found"}, 404)
                    return
                name, action = parts
                # Triton's extension body: {"parameters":
                # {"unload_dependents": true}} on unload
                params = {}
                if body:
                    doc = json.loads(body)
                    if not isinstance(doc, dict):
                        raise ValueError("body must be a JSON object")
                    params = doc.get("parameters", {}) or {}
                    if not isinstance(params, dict):
                        raise ValueError("parameters must be an object")
                try:
                    if action == "load":
                        app.registry.load(name)
                    else:
                        app.registry.unload(
                            name,
                            unload_dependents=bool(
                                params.get("unload_dependents", False)
                            ),
                        )
                except KeyError as e:
                    # Triton's extension reports failures as 400 +
                    # {"error": ...}, including unknown model names
                    self._send_json({"error": str(e)}, 400)
                    return
                self._send_json({})
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json({"error": str(e)}, 400)

        def _v2_infer(self):
            """POST /v2/models/<name>[/versions/<v>]/infer — the KServe-v2
            HTTP inference protocol, the HTTP mirror of the gRPC ModelInfer
            RPC. Two tensor transports, exactly Triton's:

            - JSON tensors: each input carries row-major values in `data`.
            - The binary_tensor_data extension (what tritonclient's HTTP
              path uses by default): `Inference-Header-Content-Length: J`
              marks the first J body bytes as the JSON header; the rest is
              raw little-endian tensor bytes, concatenated in `inputs`
              order for every input declaring
              `parameters.binary_data_size`. Outputs come back binary when
              the request sets per-output `parameters.binary_data` or the
              request-level `parameters.binary_data_output`; the response
              then carries the same header + trailing bytes in `outputs`
              order.

            KServe error contract: {"error": ...} with 400/404 (always
            pure JSON)."""
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            name, version, rest = _model_path(self.path)
            if rest != ["infer"]:
                self._send_json({"detail": "Not Found"}, 404)
                return
            try:
                json_len = self.headers.get(
                    "Inference-Header-Content-Length"
                )
                blob = b""
                if json_len is not None:
                    json_len = int(json_len)
                    if not 0 <= json_len <= len(body):
                        raise ValueError(
                            "Inference-Header-Content-Length "
                            f"{json_len} outside body ({len(body)} bytes)"
                        )
                    body, blob = body[:json_len], body[json_len:]
                doc = json.loads(body)
                inputs = {}
                cursor = 0
                for t in doc.get("inputs", []):
                    dt = t["datatype"]
                    if dt not in TRITON_TO_NP:
                        raise ValueError(f"unsupported datatype '{dt}'")
                    dtype = np.dtype(TRITON_TO_NP[dt]).newbyteorder("<")
                    nbin = (t.get("parameters") or {}).get(
                        "binary_data_size"
                    )
                    if nbin is not None:
                        # binary transport: consume this input's slice of
                        # the trailing bytes (strict sizing, like Triton)
                        want = int(np.prod(t["shape"], dtype=np.int64)
                                   ) * dtype.itemsize
                        if int(nbin) != want:
                            raise ValueError(
                                f"input '{t['name']}': binary_data_size "
                                f"{nbin} != shape {t['shape']} x "
                                f"{dt} = {want} bytes"
                            )
                        if cursor + want > len(blob):
                            raise ValueError(
                                f"input '{t['name']}': binary payload "
                                "truncated (need "
                                f"{cursor + want - len(blob)} more bytes; "
                                "is Inference-Header-Content-Length set?)"
                            )
                        inputs[t["name"]] = np.frombuffer(
                            blob, dtype=dtype, count=want // dtype.itemsize,
                            offset=cursor,
                        ).reshape(t["shape"])
                        cursor += want
                    else:
                        inputs[t["name"]] = np.asarray(
                            t["data"], dtype=dtype
                        ).reshape(t["shape"])
                if cursor != len(blob):
                    raise ValueError(
                        f"{len(blob) - cursor} trailing binary bytes not "
                        "claimed by any input's binary_data_size"
                    )
                out_specs = doc.get("outputs", [])
                out_names = [o["name"] for o in out_specs] or None
                # per-output binary_data, defaulted by the request-level
                # binary_data_output parameter (both are Triton's)
                bin_default = bool((doc.get("parameters") or {}).get(
                    "binary_data_output", False
                ))
                bin_out = {
                    o["name"]: bool((o.get("parameters") or {}).get(
                        "binary_data", bin_default
                    ))
                    for o in out_specs
                }
                # Triton's classification extension: per-output
                # parameters.classification = k replaces the tensor with
                # top-k "value:index" BYTES strings
                class_counts = {
                    o["name"]: int(
                        (o.get("parameters") or {}).get("classification", 0)
                    )
                    for o in out_specs
                    if (o.get("parameters") or {}).get("classification")
                }
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._send_json({"error": f"malformed request: {e}"}, 400)
                return
            try:
                out = app.registry.infer(
                    name, inputs, out_names, version=version
                )
            except KeyError as e:
                self._send_json({"error": str(e)}, 404)
                return
            except ValueError as e:
                self._send_json({"error": str(e)}, 400)
                return
            tensors, chunks = [], []
            for k, v in out.items():
                if k in class_counts and class_counts[k] > 0:
                    rows = _classification_rows(v, class_counts[k])
                    if bin_out.get(k, bin_default):
                        raw = serialize_bytes_tensor(
                            [b for b in rows.ravel()]
                        )
                        chunks.append(raw)
                        tensors.append(
                            {"name": k, "shape": list(rows.shape),
                             "datatype": "BYTES",
                             "parameters": {"binary_data_size": len(raw)}}
                        )
                    else:
                        tensors.append(
                            {"name": k, "shape": list(rows.shape),
                             "datatype": "BYTES",
                             "data": [b.decode() for b in rows.ravel()]}
                        )
                elif bin_out.get(k, bin_default):
                    raw = np.ascontiguousarray(v).astype(
                        v.dtype.newbyteorder("<"), copy=False
                    ).tobytes()
                    chunks.append(raw)
                    tensors.append(
                        {"name": k, "shape": list(v.shape),
                         "datatype": NP_TO_TRITON[v.dtype],
                         "parameters": {"binary_data_size": len(raw)}}
                    )
                else:
                    tensors.append(
                        {"name": k, "shape": list(v.shape),
                         "datatype": NP_TO_TRITON[v.dtype],
                         "data": v.ravel().tolist()}
                    )
            reply = {"model_name": name, "model_version": "1",
                     "outputs": tensors}
            if not chunks:
                self._send_json(reply)
                return
            header = json.dumps(reply).encode()
            payload = header + b"".join(chunks)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Inference-Header-Content-Length",
                             str(len(header)))
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            routes = {
                "/body_proportion_length_estimation_file":
                    app.handle_estimation,
                "/body_proportion_length_estimation_video":
                    app.handle_video_estimation,
            }
            stream = self.path == \
                "/body_proportion_length_estimation_video_stream"
            handler = routes.get(self.path)
            if handler is None and not stream:
                if (self.path.startswith("/v2/models/")
                        and self.path.endswith("/infer")):
                    self._v2_infer()
                    return
                if self.path in ("/v2/logging", "/v2/trace/setting"):
                    self._v2_settings_update()
                    return
                if self.path.startswith("/v2/repository/"):
                    self._v2_repository()
                    return
                self._send_json({"detail": "Not Found"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                form = parse_multipart(
                    body, self.headers.get("Content-Type", "")
                )
                if stream:
                    self._stream_video(form)
                else:
                    self._send_json(handler(form))
            except queue.Full:
                log.warning("backpressure_reject")
                self._send_json(
                    {"code": "failed", "msg": "server overloaded"}, 503
                )
            except Exception as e:  # noqa: BLE001 — parity: never 500
                traceback.print_exc()
                log.error("request_failed", error=str(e))
                self._send_json({"msg": FAIL_MSG, "code": "failed"})

    return Handler


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the stdlib default listen backlog (5) resets connections under
    # concurrent load
    request_queue_size = 128


def create_server(app: ServingApp, host: str, port: int) -> ThreadingHTTPServer:
    return _Server((host, port), make_handler(app))


def build_parser() -> argparse.ArgumentParser:
    """The JAX server's flags, option for option."""
    parser = argparse.ArgumentParser(
        description="GPU body proportion estimation service (PyTorch port)"
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--grpc-port", type=int, default=8081,
                        help="gRPC endpoint port (0 disables): the hbpe "
                             "service and the stock KServe service; the "
                             "reference exposes Triton gRPC on 8081")
    parser.add_argument(
        "--detector", default="ssd_mobilenet",
        choices=["efficientdet_lite4", "efficientdet_lite0",
                 "ssd_mobilenet", "yolov5s", "yolov5m"],
        help="default ssd_mobilenet, as the JAX server: the real weights "
             "of the reference's ssd.tflite (exits 2 naming the file when "
             "it is absent); efficientdet_lite4 serves the committed "
             "synthetic-certified weights, efficientdet_lite0 / yolov5s / "
             "yolov5m a random detector (no weights for them are in the "
             "repository), each before the certified HRNet-W32",
    )
    parser.add_argument("--checkpoint-dir", default=None,
                        help="orbax checkpoint dir with det/pose params "
                             "(models/orbax_store; the SSD detector takes "
                             "only its pose slot)")
    parser.add_argument(
        "--artifact-dir", default=None,
        help="serve from an exported artifact directory (torch.export "
             "program + meta.json, see pipeline/export.py and "
             "cli.export_artifact) instead of building models; overrides "
             "--detector and --bottom-up")
    parser.add_argument("--data-parallel", type=int, default=0,
                        help="shard serving batches over N CUDA devices "
                             "(parallel.mesh.make_mesh; N <= 1: one "
                             "device)")
    parser.add_argument(
        "--prewarm", action="store_true",
        help="run the serving forward at every batch bucket before "
             "accepting traffic; /health reports prewarmed: true",
    )
    compile_cache.add_flags(parser)
    parser.add_argument("--bottom-up", action="store_true",
                        help="serve the bottom-up pipeline (HigherHRNet + "
                             "associative-embedding grouping, no detector; "
                             "--detector is not read)")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    # --bottom-up and --artifact-dir never read --detector (the JAX server
    # returns before it does), so the default ssd_mobilenet serves them
    # whether ssd.tflite is there or not
    problems = option_problems(
        args.detector, bottom_up=bool(args.bottom_up or args.artifact_dir))
    if problems:
        parser.error("; ".join(problems))
    if args.grpc_port:
        # before any model is built: a server asked for gRPC never serves
        # HTTP alone without saying so
        try:
            import grpc  # noqa: F401

            from human_body_proportion_estimation_tpu_torch.serve import (  # noqa: F401,E501
                grpc_server,
            )
        except ImportError as e:
            parser.error(f"--grpc-port {args.grpc_port}: the gRPC edge "
                         f"cannot start ({e}); pass --grpc-port 0 to serve "
                         "HTTP alone")

    mesh = None
    if args.data_parallel > 1:
        # before any model is built, as the other option checks
        from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
            make_mesh,
        )

        try:
            mesh = make_mesh(args.data_parallel)
        except ValueError as e:
            parser.error(f"--data-parallel {args.data_parallel}: {e}")

    log.info("compile_cache", directory=compile_cache.apply_flags(args))

    if args.artifact_dir:
        _serve(args, build_artifact_pipeline(args.artifact_dir, mesh))
        return
    _serve(args, build_bottomup_pipeline(args.checkpoint_dir, mesh)
           if args.bottom_up else build_pipeline(args, mesh))


def build_artifact_pipeline(directory: str, mesh=None):
    """`--artifact-dir`: the exported program restored on the GPU, or on
    each device of `mesh` (`pipeline.export.ArtifactPipeline`; no model is
    built), with the JAX server's warning when no slot carries real
    weights."""
    from human_body_proportion_estimation_tpu_torch.pipeline.export import (
        ArtifactPipeline,
    )

    pipeline = ArtifactPipeline(directory, device="cuda", **(
        {} if mesh is None else {"mesh": mesh}))
    if "real" not in pipeline.weights_origin.values():
        print(
            "WARNING: artifact carries no real-weight slot "
            f"({pipeline.weights_origin}) — outputs are garbage "
            "(see /health 'weights')",
            flush=True,
        )
    return pipeline


def build_bottomup_pipeline(checkpoint_dir=None, mesh=None):
    """The `--bottom-up` pipeline on the GPU, or over `mesh`
    (`pipeline.bottomup.build_default`), with the pose slot of
    `checkpoint_dir` when given, announced as the JAX server announces
    it: the certified bottom-up checkpoint's path, or a loud warning at
    random."""
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        default_certified_bottomup_checkpoint,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
        build_default,
    )

    pose_state = None
    if checkpoint_dir:
        # the checkpoint layout of the top-down pipeline; the detector
        # slot is not read
        pose_state = checkpoint_states(checkpoint_dir)[1]
    pipeline = build_default(device="cuda", mesh=mesh,
                             pose_state=pose_state)
    if pipeline.weights_origin["pose"] == "synthetic-certified":
        print("serving committed synthetic-certified bottom-up weights "
              f"({default_certified_bottomup_checkpoint()})", flush=True)
    else:
        print("WARNING: serving RANDOM-INIT HigherHRNet — outputs are "
              "garbage; pass --checkpoint-dir (see /health 'weights')",
              flush=True)
    return pipeline


def build_pipeline(args, mesh=None) -> InferencePipeline:
    """The serving pipeline of `main`, on the GPU or over `mesh`
    (`--data-parallel`), with the slots of `--checkpoint-dir` when given
    (the pose slot alone for the SSD detector, as in JAX), announced as
    the JAX server announces it (the certified checkpoint's slots, and a
    loud warning for slots at random)."""
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        default_certified_checkpoint,
    )

    det_state = pose_state = None
    if getattr(args, "checkpoint_dir", None):
        det_state, pose_state = checkpoint_states(args.checkpoint_dir,
                                                  args.detector)
    pipeline = InferencePipeline(device="cuda", detector=args.detector,
                                 mesh=mesh, det_state=det_state,
                                 pose_state=pose_state)
    origin = pipeline.weights_origin
    certified = [k for k, v in origin.items() if v == "synthetic-certified"]
    if certified:
        print("serving committed synthetic-certified weights for "
              f"{'+'.join(certified)} ({default_certified_checkpoint()})",
              flush=True)
    if "random" in origin.values():
        print(
            "WARNING: serving RANDOM-INIT weights for "
            + ", ".join(k for k, v in origin.items() if v == "random")
            + " — outputs are garbage; pass --checkpoint-dir or use "
              "--detector ssd_mobilenet (see /health 'weights')",
            flush=True,
        )
    return pipeline


def _serve(args, pipeline):
    if args.prewarm:
        import time

        from human_body_proportion_estimation_tpu_torch.pipeline.host import (
            prewarm_serving,
        )

        t0 = time.time()
        warmed = prewarm_serving(pipeline)
        log.info("prewarmed", buckets=warmed,
                 seconds=round(time.time() - t0, 1))
        print(f"prewarmed batch buckets {warmed} "
              f"in {time.time() - t0:.1f}s", flush=True)
    app = ServingApp(pipeline)
    server = create_server(app, args.host, args.port)
    grpc_server = None
    if args.grpc_port:
        from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (  # noqa: E501
            create_grpc_server,
        )

        grpc_server, bound = create_grpc_server(app, args.host,
                                                args.grpc_port)
        grpc_server.start()
        log.info("grpc_listening", host=args.host, port=bound)
        print(f"grpc on {args.host}:{bound}", flush=True)
    log.info("http_listening", host=args.host, port=args.port,
             engine="native" if app.native else "python",
             detector=("artifact" if args.artifact_dir else
                       "bottom_up" if args.bottom_up else args.detector))
    print(f"serving on {args.host}:{args.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if grpc_server is not None:
            grpc_server.stop(0)
        app.shutdown()


if __name__ == "__main__":
    main()
