"""The real KServe-v2 / Triton gRPC wire protocol
(`inference.GRPCInferenceService`).

The reference's only client dependency is `tritonclient[grpc]==2.45.0`
(reference requirements.txt:9), and every client program dials that
protocol (modules/triton_utils.py:11-34,167-171: InferenceServerClient
-> get_model_metadata / get_model_config / infer). `serve/hbpe.proto` is
this framework's own richer schema; THIS module serves the stock
KServe/Triton schema (vendored wire-exact in `serve/kserve.proto`) on
the SAME gRPC port, so a stock tritonclient — or any KServe client —
connects without code changes:

  * ServerLive / ServerReady / ServerMetadata
  * ModelReady / ModelMetadata / ModelConfig (full ModelConfig document)
  * ModelInfer with `raw_input_contents` (tritonclient's wire form) and
    `InferTensorContents` typed fields; BYTES length-prefixed framing;
    Triton's `classification` requested-output parameter
  * ModelStreamInfer (bidi; errors in-band as error_message)
  * ModelStatistics / RepositoryIndex / RepositoryModelLoad|Unload
  * TraceSetting / LogSettings (Triton trace + logging extensions)
  * SystemSharedMemory* / CudaSharedMemory* (status = empty; register
    -> UNIMPLEMENTED: no shared-memory transport on this server)

Everything dispatches into the same `serve/registry.py` repository the
hbpe service and the HTTP /v2 surface use — one model repository, three
wire protocols. The port's copy of the JAX package's module; the BYTES
framing and the classification rows live in `serve/wire.py`, which the
HTTP edge shares without importing protobuf.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Sequence

import numpy as np

from human_body_proportion_estimation_tpu_torch.serve import kserve_pb2 as kpb
from human_body_proportion_estimation_tpu_torch.serve.wire import (  # noqa: F401
    _classification_rows,
    deserialize_bytes_tensor,
    serialize_bytes_tensor,
)

if TYPE_CHECKING:
    from human_body_proportion_estimation_tpu_torch.serve.server import ServingApp

SERVICE = "inference.GRPCInferenceService"

# KServe-v2 dtype string <-> numpy for the wire layer. Superset of the
# registry's table (serve/registry.py TRITON_TO_NP): the registry
# validates per-model dtypes; this maps everything the protocol names.
KSERVE_TO_NP = {
    "BOOL": np.bool_,
    "UINT8": np.uint8,
    "UINT16": np.uint16,
    "UINT32": np.uint32,
    "UINT64": np.uint64,
    "INT8": np.int8,
    "INT16": np.int16,
    "INT32": np.int32,
    "INT64": np.int64,
    "FP16": np.float16,
    "FP32": np.float32,
    "FP64": np.float64,
}
NP_TO_KSERVE = {np.dtype(v): k for k, v in KSERVE_TO_NP.items()}

# InferTensorContents field per dtype (the JSON-ish typed alternative to
# raw_input_contents; tritonclient uses raw, but the protocol allows
# either and some KServe clients send typed).
_CONTENTS_FIELD = {
    "BOOL": "bool_contents",
    "UINT8": "uint_contents",
    "UINT16": "uint_contents",
    "UINT32": "uint_contents",
    "UINT64": "uint64_contents",
    "INT8": "int_contents",
    "INT16": "int_contents",
    "INT32": "int_contents",
    "INT64": "int64_contents",
    "FP16": "fp32_contents",  # no fp16 field in the protocol; fp32 carries
    "FP32": "fp32_contents",
    "FP64": "fp64_contents",
}


def _tensor_from_wire(t, raw: Optional[bytes]) -> np.ndarray:
    """InferInputTensor (+ optional raw_input_contents entry) -> numpy."""
    shape = tuple(int(d) for d in t.shape)
    n = int(np.prod(shape)) if shape else 1
    if t.datatype == "BYTES":
        if raw is None:
            rows = list(t.contents.bytes_contents)
        else:
            rows = deserialize_bytes_tensor(raw)
        if len(rows) != n:
            raise ValueError(
                f"tensor '{t.name}': {len(rows)} BYTES elements != "
                f"shape {list(shape)}"
            )
        return np.array(rows, dtype=object).reshape(shape)
    if t.datatype not in KSERVE_TO_NP:
        raise ValueError(
            f"unsupported datatype '{t.datatype}' for tensor '{t.name}'"
        )
    dtype = np.dtype(KSERVE_TO_NP[t.datatype])
    if raw is not None:
        if len(raw) != n * dtype.itemsize:
            raise ValueError(
                f"tensor '{t.name}': {len(raw)} raw bytes != "
                f"shape {list(shape)} x {t.datatype}"
            )
        return np.frombuffer(raw, dtype=dtype).reshape(shape)
    vals = getattr(t.contents, _CONTENTS_FIELD[t.datatype])
    if len(vals) != n:
        raise ValueError(
            f"tensor '{t.name}': {len(vals)} typed elements != "
            f"shape {list(shape)}"
        )
    return np.asarray(vals, dtype=dtype).reshape(shape)


def _np_to_wire(name: str, arr: np.ndarray, out_tensor, raw_list) -> None:
    """numpy -> InferOutputTensor metadata + raw_output_contents entry."""
    out_tensor.name = name
    if arr.dtype == object or arr.dtype.kind in ("S", "U"):
        rows = [
            r if isinstance(r, bytes) else str(r).encode()
            for r in np.asarray(arr).ravel()
        ]
        out_tensor.datatype = "BYTES"
        out_tensor.shape.extend(arr.shape)
        raw_list.append(serialize_bytes_tensor(rows))
        return
    arr = np.ascontiguousarray(arr)
    out_tensor.datatype = NP_TO_KSERVE[arr.dtype]
    out_tensor.shape.extend(arr.shape)
    raw_list.append(arr.tobytes())


def run_model_infer(app: "ServingApp",
                    request: kpb.ModelInferRequest) -> kpb.ModelInferResponse:
    """Shared ModelInfer body (unary + stream): wire tensors -> registry
    dispatch -> wire response. Raises KeyError (unknown model) /
    ValueError (bad tensors) for the caller to map."""
    if request.raw_input_contents and \
            len(request.raw_input_contents) != len(request.inputs):
        raise ValueError(
            f"{len(request.raw_input_contents)} raw_input_contents "
            f"entries != {len(request.inputs)} inputs"
        )
    inputs: Dict[str, np.ndarray] = {}
    for i, t in enumerate(request.inputs):
        raw = (request.raw_input_contents[i]
               if request.raw_input_contents else None)
        inputs[t.name] = _tensor_from_wire(t, raw)

    requested = [o.name for o in request.outputs]
    class_counts = {}
    for o in request.outputs:
        p = o.parameters.get("classification")
        if p is not None and p.int64_param > 0:
            class_counts[o.name] = int(p.int64_param)

    out = app.registry.infer(
        request.model_name, inputs, requested or None,
        version=request.model_version,
    )
    resp = kpb.ModelInferResponse(
        model_name=request.model_name,
        model_version=request.model_version or "1",
        id=request.id,
    )
    for name, arr in out.items():
        if name in class_counts:
            arr = _classification_rows(arr, class_counts[name])
        _np_to_wire(name, arr, resp.outputs.add(), resp.raw_output_contents)
    return resp


def _metadata_response(meta: Dict) -> kpb.ModelMetadataResponse:
    resp = kpb.ModelMetadataResponse(
        name=meta["name"],
        versions=meta["versions"],
        platform=meta["platform"],
    )
    for key, dst in (("inputs", resp.inputs), ("outputs", resp.outputs)):
        for t in meta[key]:
            dst.add(name=t["name"], datatype=t["datatype"],
                    shape=t["shape"])
    return resp


def _config_response(cfg: Dict) -> kpb.ModelConfigResponse:
    """registry.config document -> the real ModelConfig protobuf."""
    resp = kpb.ModelConfigResponse()
    c = resp.config
    c.name = cfg["name"]
    c.platform = cfg["platform"]
    c.backend = "pytorch"
    c.max_batch_size = cfg["max_batch_size"]
    c.version_policy.latest.num_versions = 1
    for t in cfg["input"]:
        c.input.add(
            name=t["name"],
            data_type=kpb.DataType.Value(t["data_type"]),
            format=kpb.ModelInput.Format.Value(t["format"]),
            dims=t["dims"],
        )
    for t in cfg["output"]:
        c.output.add(
            name=t["name"],
            data_type=kpb.DataType.Value(t["data_type"]),
            dims=t["dims"],
        )
    for g in cfg["instance_group"]:
        c.instance_group.add(
            count=g["count"],
            kind=kpb.ModelInstanceGroup.Kind.Value(g["kind"]),
        )
    if "dynamic_batching" in cfg:
        db = cfg["dynamic_batching"]
        c.dynamic_batching.preferred_batch_size.extend(
            db["preferred_batch_size"]
        )
        c.dynamic_batching.max_queue_delay_microseconds = \
            db["max_queue_delay_microseconds"]
    return resp


def _statistics_response(doc: Dict) -> kpb.ModelStatisticsResponse:
    resp = kpb.ModelStatisticsResponse()
    for row in doc["model_stats"]:
        stat = resp.model_stats.add(
            name=row["name"], version=row["version"],
            last_inference=row["last_inference"],
            inference_count=row["inference_count"],
            execution_count=row["execution_count"],
        )
        s = row["inference_stats"]
        for key in ("success", "fail", "queue", "compute_input",
                    "compute_infer", "compute_output"):
            dst = getattr(stat.inference_stats, key)
            dst.count = s[key]["count"]
            dst.ns = s[key]["ns"]
        for b in row["batch_stats"]:
            bs = stat.batch_stats.add(batch_size=b["batch_size"])
            bs.compute_infer.count = b["compute_infer"]["count"]
            bs.compute_infer.ns = b["compute_infer"]["ns"]
    return resp


def kserve_handlers(app: "ServingApp"):
    """Generic method handlers for inference.GRPCInferenceService, all
    backed by `app.registry` (one repository, every wire protocol)."""
    import grpc

    def server_live(request, context):
        return kpb.ServerLiveResponse(live=True)

    def server_ready(request, context):
        return kpb.ServerReadyResponse(ready=True)

    def server_metadata(request, context):
        from human_body_proportion_estimation_tpu_torch import __version__
        from human_body_proportion_estimation_tpu_torch.serve.server import (
            V2_EXTENSIONS,
        )

        return kpb.ServerMetadataResponse(
            name="human_body_proportion_estimation_tpu_torch",
            version=__version__,
            extensions=V2_EXTENSIONS,
        )

    def model_ready(request, context):
        try:
            app.registry.metadata(request.name, request.version)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return kpb.ModelReadyResponse(ready=True)

    def model_metadata(request, context):
        try:
            meta = app.registry.metadata(request.name, request.version)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return _metadata_response(meta)

    def model_config(request, context):
        try:
            cfg = app.registry.config(request.name, request.version)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return _config_response(cfg)

    def model_infer(request, context):
        try:
            return run_model_infer(app, request)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def model_stream_infer(request_iterator, context):
        """Triton stream contract: requests pipeline concurrently (so
        same-model requests coalesce in the per-model batcher), responses
        return in request order, per-request errors ride in-band — the
        back-pressure/cancel machinery is shared with the hbpe stream
        handler (grpc_server.pipelined_stream)."""
        from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
            pipelined_stream,
        )

        for rid, fut in pipelined_stream(
            request_iterator, lambda req: run_model_infer(app, req)
        ):
            try:
                yield kpb.ModelStreamInferResponse(
                    infer_response=fut.result()
                )
            except Exception as e:  # noqa: BLE001 — in-band error, with
                # the request id echoed so pipelined clients can
                # correlate the failure
                err = kpb.ModelStreamInferResponse(
                    error_message=str(e) or type(e).__name__
                )
                err.infer_response.id = rid
                yield err

    def model_statistics(request, context):
        try:
            doc = app.registry.statistics(request.name, request.version)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return _statistics_response(doc)

    def repository_index(request, context):
        resp = kpb.RepositoryIndexResponse()
        for row in app.registry.index():
            if request.ready and row["state"] != "READY":
                continue
            resp.models.add(name=row["name"], version=row["version"],
                            state=row["state"], reason="")
        return resp

    def repository_model_load(request, context):
        try:
            app.registry.load(request.model_name)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return kpb.RepositoryModelLoadResponse()

    def repository_model_unload(request, context):
        p = request.parameters.get("unload_dependents")
        try:
            app.registry.unload(
                request.model_name,
                unload_dependents=bool(p is not None and p.bool_param),
            )
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return kpb.RepositoryModelUnloadResponse()

    def system_shm_status(request, context):
        return kpb.SystemSharedMemoryStatusResponse()  # nothing registered

    def cuda_shm_status(request, context):
        return kpb.CudaSharedMemoryStatusResponse()

    def _shm_unsupported(request, context):
        context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "shared-memory transport is not supported by this server",
        )

    def trace_setting(request, context):
        """Triton trace extension, typed wire form: settings arrive as
        {key: SettingValue(repeated string value)} and return the same
        way (tritonclient get/update_trace_settings)."""
        from human_body_proportion_estimation_tpu_torch.serve.tracing import (
            TRACER,
        )

        updates = {}
        for key, sv in request.settings.items():
            vals = list(sv.value)
            if key == "trace_level":
                updates[key] = vals
            elif not vals:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"setting '{key}' has no value")
            else:
                updates[key] = vals[0]
        try:
            doc = TRACER.update(updates) if updates else TRACER.settings()
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        resp = kpb.TraceSettingResponse()
        for key, value in doc.items():
            sv = resp.settings[key]
            sv.value.extend(value if isinstance(value, list) else [value])
        return resp

    def log_settings(request, context):
        """Triton logging extension, typed wire form (bool / uint32 /
        string oneof per setting)."""
        from human_body_proportion_estimation_tpu_torch.utils.logging import (
            configure_logging,
            log_settings as get_log_settings,
        )

        updates = {}
        for key, sv in request.settings.items():
            which = sv.WhichOneof("parameter_choice")
            if which is None:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"setting '{key}' has no value")
            value = getattr(sv, which)
            if key == "log_verbose_level" and which == "uint32_param":
                value = int(value)
            updates[key] = value
        try:
            doc = configure_logging(updates) if updates \
                else get_log_settings()
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        resp = kpb.LogSettingsResponse()
        for key, value in doc.items():
            sv = resp.settings[key]
            if isinstance(value, bool):
                sv.bool_param = value
            elif isinstance(value, int):
                sv.uint32_param = value
            else:
                sv.string_param = str(value)
        return resp

    def _u(fn, req_cls, resp_cls):
        return grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )

    handlers = {
        "ServerLive": _u(server_live, kpb.ServerLiveRequest,
                         kpb.ServerLiveResponse),
        "ServerReady": _u(server_ready, kpb.ServerReadyRequest,
                          kpb.ServerReadyResponse),
        "ServerMetadata": _u(server_metadata, kpb.ServerMetadataRequest,
                             kpb.ServerMetadataResponse),
        "ModelReady": _u(model_ready, kpb.ModelReadyRequest,
                         kpb.ModelReadyResponse),
        "ModelMetadata": _u(model_metadata, kpb.ModelMetadataRequest,
                            kpb.ModelMetadataResponse),
        "ModelConfig": _u(model_config, kpb.ModelConfigRequest,
                          kpb.ModelConfigResponse),
        "ModelInfer": _u(model_infer, kpb.ModelInferRequest,
                         kpb.ModelInferResponse),
        "ModelStreamInfer": grpc.stream_stream_rpc_method_handler(
            model_stream_infer,
            request_deserializer=kpb.ModelInferRequest.FromString,
            response_serializer=(
                kpb.ModelStreamInferResponse.SerializeToString
            ),
        ),
        "ModelStatistics": _u(model_statistics,
                              kpb.ModelStatisticsRequest,
                              kpb.ModelStatisticsResponse),
        "RepositoryIndex": _u(repository_index,
                              kpb.RepositoryIndexRequest,
                              kpb.RepositoryIndexResponse),
        "RepositoryModelLoad": _u(repository_model_load,
                                  kpb.RepositoryModelLoadRequest,
                                  kpb.RepositoryModelLoadResponse),
        "RepositoryModelUnload": _u(repository_model_unload,
                                    kpb.RepositoryModelUnloadRequest,
                                    kpb.RepositoryModelUnloadResponse),
        "SystemSharedMemoryStatus": _u(
            system_shm_status,
            kpb.SystemSharedMemoryStatusRequest,
            kpb.SystemSharedMemoryStatusResponse),
        "SystemSharedMemoryRegister": _u(
            _shm_unsupported,
            kpb.SystemSharedMemoryRegisterRequest,
            kpb.SystemSharedMemoryRegisterResponse),
        "SystemSharedMemoryUnregister": _u(
            _shm_unsupported,
            kpb.SystemSharedMemoryUnregisterRequest,
            kpb.SystemSharedMemoryUnregisterResponse),
        "CudaSharedMemoryStatus": _u(
            cuda_shm_status,
            kpb.CudaSharedMemoryStatusRequest,
            kpb.CudaSharedMemoryStatusResponse),
        "CudaSharedMemoryRegister": _u(
            _shm_unsupported,
            kpb.CudaSharedMemoryRegisterRequest,
            kpb.CudaSharedMemoryRegisterResponse),
        "CudaSharedMemoryUnregister": _u(
            _shm_unsupported,
            kpb.CudaSharedMemoryUnregisterRequest,
            kpb.CudaSharedMemoryUnregisterResponse),
        "TraceSetting": _u(trace_setting, kpb.TraceSettingRequest,
                           kpb.TraceSettingResponse),
        "LogSettings": _u(log_settings, kpb.LogSettingsRequest,
                          kpb.LogSettingsResponse),
    }
    return grpc.method_handlers_generic_handler(SERVICE, handlers)


class KServeClient:
    """Minimal tritonclient.grpc.InferenceServerClient analog speaking
    the stock protocol — used by tests/CLI here (the image has no
    tritonclient); external users point real tritonclient at the same
    port."""

    def __init__(self, target: str = "127.0.0.1:8081"):
        import grpc

        self._channel = grpc.insecure_channel(
            target,
            options=[
                ("grpc.max_receive_message_length", 64 * 1024 * 1024),
                ("grpc.max_send_message_length", 64 * 1024 * 1024),
            ],
        )

        def u(method, req_cls, resp_cls):
            return self._channel.unary_unary(
                f"/{SERVICE}/{method}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            )

        self._server_live = u("ServerLive", kpb.ServerLiveRequest,
                              kpb.ServerLiveResponse)
        self._server_ready = u("ServerReady", kpb.ServerReadyRequest,
                               kpb.ServerReadyResponse)
        self._server_metadata = u("ServerMetadata",
                                  kpb.ServerMetadataRequest,
                                  kpb.ServerMetadataResponse)
        self._model_ready = u("ModelReady", kpb.ModelReadyRequest,
                              kpb.ModelReadyResponse)
        self._model_metadata = u("ModelMetadata",
                                 kpb.ModelMetadataRequest,
                                 kpb.ModelMetadataResponse)
        self._model_config = u("ModelConfig", kpb.ModelConfigRequest,
                               kpb.ModelConfigResponse)
        self._model_infer = u("ModelInfer", kpb.ModelInferRequest,
                              kpb.ModelInferResponse)
        self._model_stream_infer = self._channel.stream_stream(
            f"/{SERVICE}/ModelStreamInfer",
            request_serializer=kpb.ModelInferRequest.SerializeToString,
            response_deserializer=kpb.ModelStreamInferResponse.FromString,
        )
        self._model_statistics = u("ModelStatistics",
                                   kpb.ModelStatisticsRequest,
                                   kpb.ModelStatisticsResponse)
        self._repository_index = u("RepositoryIndex",
                                   kpb.RepositoryIndexRequest,
                                   kpb.RepositoryIndexResponse)
        self._repository_load = u("RepositoryModelLoad",
                                  kpb.RepositoryModelLoadRequest,
                                  kpb.RepositoryModelLoadResponse)
        self._repository_unload = u("RepositoryModelUnload",
                                    kpb.RepositoryModelUnloadRequest,
                                    kpb.RepositoryModelUnloadResponse)
        self._trace_setting = u("TraceSetting", kpb.TraceSettingRequest,
                                kpb.TraceSettingResponse)
        self._log_settings = u("LogSettings", kpb.LogSettingsRequest,
                               kpb.LogSettingsResponse)

    # -- health / metadata --

    def is_server_live(self, timeout: float = 30.0) -> bool:
        return self._server_live(kpb.ServerLiveRequest(),
                                 timeout=timeout).live

    def is_server_ready(self, timeout: float = 30.0) -> bool:
        return self._server_ready(kpb.ServerReadyRequest(),
                                  timeout=timeout).ready

    def is_model_ready(self, model_name: str, model_version: str = "",
                       timeout: float = 30.0) -> bool:
        return self._model_ready(
            kpb.ModelReadyRequest(name=model_name, version=model_version),
            timeout=timeout,
        ).ready

    def get_server_metadata(self, timeout: float = 30.0):
        return self._server_metadata(kpb.ServerMetadataRequest(),
                                     timeout=timeout)

    def get_model_metadata(self, model_name: str, model_version: str = "",
                           timeout: float = 30.0):
        """Returns the raw ModelMetadataResponse — same object shape the
        reference's parse_model_grpc consumes (triton_utils.py:54-72)."""
        return self._model_metadata(
            kpb.ModelMetadataRequest(name=model_name,
                                     version=model_version),
            timeout=timeout,
        )

    def get_model_config(self, model_name: str, model_version: str = "",
                         timeout: float = 30.0):
        """Returns ModelConfigResponse (`.config` holds the document —
        reference obj_det_edet4_trtserver.py:76)."""
        return self._model_config(
            kpb.ModelConfigRequest(name=model_name,
                                   version=model_version),
            timeout=timeout,
        )

    # -- inference --

    @staticmethod
    def _build_request(model_name: str, inputs: Dict[str, np.ndarray],
                       output_names: Optional[Sequence[str]],
                       model_version: str, request_id: str,
                       class_counts: Optional[Dict[str, int]] = None):
        req = kpb.ModelInferRequest(model_name=model_name,
                                    model_version=model_version,
                                    id=request_id)
        for name, arr in inputs.items():
            arr = np.asarray(arr)
            t = req.inputs.add(name=name)
            if arr.dtype == object or arr.dtype.kind in ("S", "U"):
                t.datatype = "BYTES"
                t.shape.extend(arr.shape)
                rows = [
                    r if isinstance(r, bytes) else str(r).encode()
                    for r in arr.ravel()
                ]
                req.raw_input_contents.append(serialize_bytes_tensor(rows))
            else:
                arr = np.ascontiguousarray(arr)
                t.datatype = NP_TO_KSERVE[arr.dtype]
                t.shape.extend(arr.shape)
                req.raw_input_contents.append(arr.tobytes())
        for name in output_names or ():
            o = req.outputs.add(name=name)
            k = (class_counts or {}).get(name, 0)
            if k:
                o.parameters["classification"].int64_param = k
        return req

    @staticmethod
    def _parse_response(resp) -> Dict[str, np.ndarray]:
        out = {}
        for i, t in enumerate(resp.outputs):
            raw = (resp.raw_output_contents[i]
                   if resp.raw_output_contents else None)
            out[t.name] = _tensor_from_wire(t, raw)
        return out

    def infer(self, model_name: str, inputs: Dict[str, np.ndarray],
              output_names: Optional[Sequence[str]] = None,
              model_version: str = "", request_id: str = "",
              class_counts: Optional[Dict[str, int]] = None,
              timeout: float = 600.0) -> Dict[str, np.ndarray]:
        resp = self._model_infer(
            self._build_request(model_name, inputs, output_names,
                                model_version, request_id, class_counts),
            timeout=timeout,
        )
        return self._parse_response(resp)

    def stream_infer(self, requests, timeout: float = 3600.0):
        """Iterable of {"model_name", "inputs", optional "id",
        "output_names", "model_version"} -> yields {"id", "outputs",
        "error"} in request order (Triton stream semantics)."""
        def gen():
            for i, r in enumerate(requests):
                yield self._build_request(
                    r["model_name"], r["inputs"],
                    r.get("output_names"), r.get("model_version", ""),
                    str(r.get("id", i)),
                )

        for item in self._model_stream_infer(gen(), timeout=timeout):
            if item.error_message:
                yield {"id": item.infer_response.id, "outputs": None,
                       "error": item.error_message}
            else:
                yield {
                    "id": item.infer_response.id,
                    "outputs": self._parse_response(item.infer_response),
                    "error": None,
                }

    # -- statistics / repository --

    def get_inference_statistics(self, model_name: str = "",
                                 model_version: str = "",
                                 timeout: float = 30.0):
        return self._model_statistics(
            kpb.ModelStatisticsRequest(name=model_name,
                                       version=model_version),
            timeout=timeout,
        )

    def get_model_repository_index(self, timeout: float = 30.0):
        return self._repository_index(kpb.RepositoryIndexRequest(),
                                      timeout=timeout).models

    def load_model(self, model_name: str, timeout: float = 600.0) -> None:
        self._repository_load(
            kpb.RepositoryModelLoadRequest(model_name=model_name),
            timeout=timeout,
        )

    def unload_model(self, model_name: str, timeout: float = 60.0,
                     unload_dependents: bool = False) -> None:
        req = kpb.RepositoryModelUnloadRequest(model_name=model_name)
        if unload_dependents:
            req.parameters["unload_dependents"].bool_param = True
        self._repository_unload(req, timeout=timeout)

    # -- trace / logging extensions --

    def get_trace_settings(self, timeout: float = 30.0) -> Dict:
        resp = self._trace_setting(kpb.TraceSettingRequest(),
                                   timeout=timeout)
        return {k: list(v.value) for k, v in resp.settings.items()}

    def update_trace_settings(self, settings: Dict,
                              timeout: float = 30.0) -> Dict:
        req = kpb.TraceSettingRequest()
        for key, value in settings.items():
            sv = req.settings[key]
            if isinstance(value, (list, tuple)):
                sv.value.extend(str(v) for v in value)
            else:
                sv.value.append(str(value))
        resp = self._trace_setting(req, timeout=timeout)
        return {k: list(v.value) for k, v in resp.settings.items()}

    def get_log_settings(self, timeout: float = 30.0) -> Dict:
        resp = self._log_settings(kpb.LogSettingsRequest(),
                                  timeout=timeout)
        return {
            k: getattr(v, v.WhichOneof("parameter_choice"))
            for k, v in resp.settings.items()
        }

    def update_log_settings(self, settings: Dict,
                            timeout: float = 30.0) -> Dict:
        req = kpb.LogSettingsRequest()
        for key, value in settings.items():
            sv = req.settings[key]
            if isinstance(value, bool):
                sv.bool_param = value
            elif isinstance(value, int):
                sv.uint32_param = value
            else:
                sv.string_param = str(value)
        resp = self._log_settings(req, timeout=timeout)
        return {
            k: getattr(v, v.WhichOneof("parameter_choice"))
            for k, v in resp.settings.items()
        }

    def close(self):
        self._channel.close()
