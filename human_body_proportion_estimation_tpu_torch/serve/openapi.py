"""OpenAPI 3 schema for the HTTP serving edge.

The reference's welcome JSON points users at ``/docs``
(`uvicorn_server/server.py:122-124`), where FastAPI auto-renders an
interactive OpenAPI UI from the route signatures. This framework's HTTP
edge is stdlib (no FastAPI), so the schema is built explicitly here and
served as JSON at the FastAPI-conventional ``/openapi.json`` while
``/docs`` serves a Swagger-UI HTML page rendering it (what a browser
gets from FastAPI) — machine-readable contract parity
(`serve.client.HttpClient.docs()` consumes the JSON).

The document is a plain literal: every path below corresponds one-to-one
to a branch in `serve.server.make_handler`, and the multipart form fields
mirror the reference's FastAPI `File(...)`/`Form(...)` parameters
(`uvicorn_server/server.py:85-102`).

The port's copy of the JAX package's `serve/openapi.py`: the same
document, path for path.
"""

from __future__ import annotations

from typing import Any, Dict

_SEGMENTS_SCHEMA = {
    "type": "object",
    "description": (
        "segment name -> length in cm (number) or the literal string "
        "'Part not visible' (reference modules/pose_estimator.py:191-200)"
    ),
    "additionalProperties": {
        "oneOf": [{"type": "number"}, {"type": "string"}]
    },
}

_ESTIMATION_RESPONSE = {
    "type": "object",
    "properties": {
        "code": {"type": "string", "enum": ["success", "failed"]},
        "msg": {
            "type": "string",
            "description": (
                "'human body proportion estimation complete' | "
                "'No humans detected' | failure text "
                "(uvicorn_server/server.py:60-67,114-118)"
            ),
        },
        "body_proportion_lengths_(cm)": _SEGMENTS_SCHEMA,
    },
    "required": ["code", "msg"],
}

_FRAME_RESULT = {
    "type": "object",
    "properties": {
        "frame": {"type": "integer",
                  "description": "original frame index (pre-stride)"},
        "msg": {"type": "string"},
        "body_proportion_lengths_(cm)": _SEGMENTS_SCHEMA,
    },
}

_IMAGE_FORM = {
    "type": "object",
    "properties": {
        "file": {"type": "string", "format": "binary",
                 "description": "image file"},
        "person_height_in_cm": {"type": "integer", "default": 175},
        "threshold": {"type": "number", "default": 0.70},
        "back_url": {"type": "string",
                     "description": "optional webhook URL; the result JSON "
                                    "is POSTed there fire-and-forget"},
    },
    "required": ["file"],
}


def _video_form(default_max_frames: int) -> Dict[str, Any]:
    return {
        "type": "object",
        "properties": {
            "file": {"type": "string", "format": "binary",
                     "description": "video file"},
            "person_height_in_cm": {"type": "integer", "default": 175},
            "threshold": {"type": "number", "default": 0.70},
            "frame_stride": {"type": "integer", "default": 1,
                             "description": "process every Nth frame"},
            "max_frames": {
                "type": "integer", "default": default_max_frames,
                "description": "cap on processed frames; 0 = unlimited "
                               "(aggregate endpoint defaults to "
                               f"{default_max_frames} so long uploads "
                               "cannot build unbounded JSON bodies — use "
                               "the _stream variant for unbounded videos)",
            },
            "back_url": {"type": "string"},
        },
        "required": ["file"],
    }


def _json_response(schema: Dict[str, Any], description: str) -> Dict[str, Any]:
    return {
        "200": {
            "description": description,
            "content": {"application/json": {"schema": schema}},
        }
    }


def build_schema(default_max_frames: int = 0) -> Dict[str, Any]:
    """The OpenAPI 3.0.3 document for the HTTP edge."""
    video_summary = {
        "type": "object",
        "properties": {
            "code": {"type": "string", "enum": ["success", "failed"]},
            "msg": {"type": "string"},
            "fps": {"type": "number"},
            "frame_stride": {"type": "integer"},
            "num_frames_processed": {"type": "integer"},
            "frames": {"type": "array", "items": _FRAME_RESULT},
            "median_body_proportion_lengths_(cm)": {
                "type": "object",
                "additionalProperties": {"type": "number"},
                "description": "median over frames, per segment",
            },
        },
    }
    stream_summary = {
        **video_summary,
        "properties": {k: v for k, v in video_summary["properties"].items()
                       if k != "frames"},
    }
    multipart = lambda schema: {  # noqa: E731
        "required": True,
        "content": {"multipart/form-data": {"schema": schema}},
    }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "Human Body Proportion Estimation Web Service",
            "description": (
                "TPU-native body-proportion service; HTTP JSON contract "
                "matches the reference FastAPI app "
                "(uvicorn_server/server.py), tensor-level inference is "
                "gRPC-only (see serve/hbpe.proto)"
            ),
            "version": "1.0.0",
        },
        "paths": {
            "/": {"get": {
                "summary": "Welcome message",
                "responses": _json_response(
                    {"type": "object"}, "welcome JSON pointing at /docs"
                ),
            }},
            "/body_proportion_length_estimation_file": {"post": {
                "summary": "Estimate body segment lengths from one image",
                "description": (
                    "Reference-parity endpoint "
                    "(uvicorn_server/server.py:85-119): first detected "
                    "person only; any processing error returns code="
                    "'failed' with HTTP 200, never a 500"
                ),
                "requestBody": multipart(_IMAGE_FORM),
                "responses": {
                    **_json_response(_ESTIMATION_RESPONSE,
                                     "estimation result"),
                    "503": {"description": "server overloaded "
                                           "(back-pressure reject)"},
                },
            }},
            "/body_proportion_length_estimation_video": {"post": {
                "summary": "Per-frame estimation + median summary for a "
                           "video (aggregate response)",
                "requestBody": multipart(_video_form(default_max_frames)),
                "responses": _json_response(
                    video_summary, "per-frame results + median summary"
                ),
            }},
            "/body_proportion_length_estimation_video_stream": {"post": {
                "summary": "Streaming variant: NDJSON lines as frames "
                           "complete (header, then one line per frame in "
                           "order, then the median summary)",
                "description": (
                    "HTTP twin of the gRPC EstimateVideoStream RPC: "
                    "chunked application/x-ndjson; no default frame cap "
                    "(the response never buffers)"
                ),
                "requestBody": multipart(_video_form(0)),
                "responses": {"200": {
                    "description": "NDJSON stream: first line "
                                   "{code,fps,frame_stride}, then frame "
                                   "results, last line the summary "
                                   "(code='failed' line on mid-stream "
                                   "errors)",
                    "content": {"application/x-ndjson": {"schema": {
                        "oneOf": [_FRAME_RESULT, stream_summary],
                    }}},
                }},
            }},
            "/health": {"get": {
                "summary": "Liveness, device info, per-slot weight origin "
                           "(real|random), prewarm state, HBM usage",
                "responses": _json_response({"type": "object"}, "health"),
            }},
            "/metrics": {"get": {
                "summary": "QPS/latency percentiles, batch occupancy, "
                           "per-stage split, per-model registry stats",
                "responses": _json_response({"type": "object"}, "metrics"),
            }},
            "/v2/models": {"get": {
                "summary": "Model-repository index (read-only mirror of "
                           "the gRPC RepositoryIndex RPC)",
                "responses": _json_response({"type": "object"}, "index"),
            }},
            "/v2/models/{name}": {"get": {
                "summary": "Per-model metadata (gRPC ModelMetadata "
                           "mirror); /v2/models/{name}/versions/1 "
                           "equivalent",
                "parameters": [{
                    "name": "name", "in": "path", "required": True,
                    "schema": {"type": "string"},
                }],
                "responses": {
                    **_json_response({"type": "object"}, "metadata"),
                    "404": {"description": "unknown model"},
                },
            }},
            "/v2/models/{name}/config": {"get": {
                "summary": "Triton model-config analog (max_batch_size, "
                           "instance_group/dp degree, dynamic_batching "
                           "delay); fetched separately from metadata "
                           "like tritonclient.get_model_config",
                "parameters": [{
                    "name": "name", "in": "path", "required": True,
                    "schema": {"type": "string"},
                }],
                "responses": {
                    **_json_response({"type": "object"}, "config"),
                    "404": {"description": "unknown model"},
                },
            }},
            "/v2/models/{name}/ready": {"get": {
                "summary": "Per-model readiness (tritonclient "
                           "is_model_ready analog)",
                "parameters": [{
                    "name": "name", "in": "path", "required": True,
                    "schema": {"type": "string"},
                }],
                "responses": {
                    **_json_response({"type": "object"}, "ready"),
                    "404": {"description": "unknown model"},
                },
            }},
            "/v2/models/{name}/stats": {"get": {
                "summary": "Per-model inference statistics (Triton "
                           "get_inference_statistics analog: request/"
                           "launch counts, queue + compute ns, "
                           "batch-size histogram); /v2/models/stats "
                           "returns every model",
                "parameters": [{
                    "name": "name", "in": "path", "required": True,
                    "schema": {"type": "string"},
                }],
                "responses": {
                    **_json_response({"type": "object"}, "stats"),
                    "404": {"description": "unknown model"},
                },
            }},
            "/v2/models/{name}/infer": {"post": {
                "summary": "KServe-v2 HTTP inference: JSON tensors "
                           "({inputs: [{name, shape, datatype, data}], "
                           "outputs?: [{name}]}) or Triton's "
                           "binary_tensor_data extension "
                           "(Inference-Header-Content-Length: J -> first "
                           "J body bytes are the JSON header, the rest "
                           "raw little-endian tensor bytes in inputs "
                           "order via parameters.binary_data_size; "
                           "binary outputs via parameters.binary_data / "
                           "request-level binary_data_output; per-output "
                           "parameters.classification=k returns top-k "
                           "'value:index' BYTES rows) -> "
                           "{model_name, model_version, outputs: [...]}; "
                           "the HTTP twin of the gRPC ModelInfer RPC",
                "parameters": [{
                    "name": "name", "in": "path", "required": True,
                    "schema": {"type": "string"},
                }],
                "responses": {
                    **_json_response({"type": "object"}, "outputs"),
                    "400": {"description": "malformed request / bad "
                                           "tensor (KServe {error})"},
                    "404": {"description": "unknown model"},
                },
            }},
            "/v2": {"get": {
                "summary": "KServe-v2 server metadata (name, version, "
                           "protocol extensions)",
                "responses": _json_response({"type": "object"}, "meta"),
            }},
            "/v2/health/live": {"get": {
                "summary": "KServe-v2 liveness",
                "responses": _json_response({"type": "object"}, "live"),
            }},
            "/v2/health/ready": {"get": {
                "summary": "KServe-v2 readiness",
                "responses": _json_response({"type": "object"}, "ready"),
            }},
            "/v2/logging": {
                "get": {
                    "summary": "Triton logging extension: current "
                               "runtime log settings",
                    "responses": _json_response({"type": "object"},
                                                "settings"),
                },
                "post": {
                    "summary": "Update log settings (subset of fields); "
                               "400 on unknown field or bad value",
                    "responses": _json_response({"type": "object"},
                                                "settings"),
                },
            },
            "/v2/trace/setting": {
                "get": {
                    "summary": "Triton trace extension: global trace "
                               "settings (string-valued document)",
                    "responses": _json_response({"type": "object"},
                                                "settings"),
                },
                "post": {
                    "summary": "Update trace settings (trace_level, "
                               "trace_rate, trace_count, log_frequency, "
                               "trace_file); sampled requests append "
                               "timestamp records to trace_file",
                    "responses": _json_response({"type": "object"},
                                                "settings"),
                },
            },
            "/v2/repository/index": {"post": {
                "summary": "Triton model-repository extension: "
                           "repository index rows {name, version, "
                           "state, reason}; optional JSON body "
                           "{\"ready\": true} filters to READY models",
                "responses": _json_response({"type": "array"}, "index"),
            }},
            "/v2/repository/models/{name}/load": {"post": {
                "summary": "Eagerly load a named model (Triton "
                           "repository extension; tritonclient "
                           "load_model); 400 {error} for unknown names",
                "responses": _json_response({"type": "object"}, "ok"),
            }},
            "/v2/repository/models/{name}/unload": {"post": {
                "summary": "Unload a named model's runner/params "
                           "(stays registered, reloads on next use); "
                           "body {parameters: {unload_dependents: true}} "
                           "also unloads an ensemble's composing models; "
                           "400 {error} for unknown names",
                "responses": _json_response({"type": "object"}, "ok"),
            }},
            "/docs": {"get": {
                "summary": "Interactive Swagger-UI page rendering "
                           "/openapi.json (the FastAPI auto-docs role)",
                "responses": {"200": {
                    "description": "Swagger-UI HTML",
                    "content": {"text/html": {}},
                }},
            }},
            "/openapi.json": {"get": {
                "summary": "This OpenAPI 3 document",
                "responses": _json_response({"type": "object"}, "schema"),
            }},
        },
    }
