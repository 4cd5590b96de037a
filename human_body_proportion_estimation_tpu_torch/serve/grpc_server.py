"""gRPC serving edge (the reference's Triton-gRPC role) + client: the JAX
package's `serve/grpc_server.py` over the port's `ServingApp`.

The reference's only model-serving transport is Triton's gRPC endpoint,
driven by `tritonclient` (reference `modules/triton_utils.py`,
requirements.txt:9). This module serves the equivalent endpoint: a gRPC
service sharing the HTTP edge's `ServingApp` (its batcher and the fused
forward on the card) and model registry.

The wire contract is the checked-in protobuf schema `serve/hbpe.proto`
(service `hbpe.Inference`), a byte-identical copy of the JAX package's;
`hbpe_pb2.py` is the JAX package's generated binding, copied as is. The
service registers it through gRPC's generic method handlers, so no
grpcio-tools plugin is needed at run time. The stock KServe service
(`serve/kserve_grpc.py`) shares the port.

`GrpcClient` wraps the proto messages for Python callers (the
tritonclient analog) and returns the SAME response dict as the HTTP edge
({"code", "msg", "body_proportion_lengths_(cm)"}, reference
uvicorn_server/server.py:60-67), with visible==false segments rendered as
the "Part not visible" string (reference modules/pose_estimator.py:191-200).
"""

from __future__ import annotations

from concurrent import futures
from typing import TYPE_CHECKING, Dict, Optional, Sequence

import numpy as np

from human_body_proportion_estimation_tpu_torch.serve import hbpe_pb2 as pb
from human_body_proportion_estimation_tpu_torch.serve.registry import (
    NP_TO_TRITON,
    TRITON_TO_NP,
)

if TYPE_CHECKING:
    from human_body_proportion_estimation_tpu_torch.serve.server import ServingApp

SERVICE = "hbpe.Inference"
NOT_VISIBLE = "Part not visible"  # reference pose_estimator.py:195


def response_dict_to_proto(response: Dict) -> pb.EstimateResponse:
    """HTTP-parity response dict -> EstimateResponse message."""
    msg = pb.EstimateResponse(
        code=response.get("code", "failed"), msg=response.get("msg", "")
    )
    for name, value in response.get(
        "body_proportion_lengths_(cm)", {}
    ).items():
        if isinstance(value, str):  # "Part not visible"
            msg.segments.add(name=name, length_cm=0.0, visible=False)
        else:
            msg.segments.add(name=name, length_cm=float(value), visible=True)
    return msg


def _segments_to_proto(dist_dict: Dict, out) -> None:
    for name, value in dist_dict.items():
        if isinstance(value, str):  # "Part not visible"
            out.add(name=name, length_cm=0.0, visible=False)
        else:
            out.add(name=name, length_cm=float(value), visible=True)


def video_dict_to_proto(response: Dict) -> pb.EstimateVideoResponse:
    """run_video response dict -> EstimateVideoResponse message."""
    msg = pb.EstimateVideoResponse(
        code=response.get("code", "failed"),
        msg=response.get("msg", ""),
        fps=float(response.get("fps", 0.0)),
        frame_stride=int(response.get("frame_stride", 1)),
        num_frames_processed=int(
            response.get("num_frames_processed",
                         len(response.get("frames", ())))
        ),
    )
    for f in response.get("frames", ()):
        fr = msg.frames.add(frame=int(f["frame"]), msg=f["msg"])
        _segments_to_proto(f["body_proportion_lengths_(cm)"], fr.segments)
    _segments_to_proto(
        response.get("median_body_proportion_lengths_(cm)", {}),
        msg.median_segments,
    )
    return msg


def proto_to_video_dict(msg: pb.EstimateVideoResponse) -> Dict:
    """EstimateVideoResponse -> the HTTP edge's response dict shape."""
    def seg_dict(segments):
        return {
            s.name: (round(float(s.length_cm), 2) if s.visible
                     else NOT_VISIBLE)
            for s in segments
        }

    return {
        "code": msg.code,
        "msg": msg.msg,
        "fps": float(msg.fps),
        "frame_stride": int(msg.frame_stride),
        "num_frames_processed":
            int(msg.num_frames_processed) or len(msg.frames),
        "frames": [
            {
                "frame": int(f.frame),
                "msg": f.msg,
                "body_proportion_lengths_(cm)": seg_dict(f.segments),
            }
            for f in msg.frames
        ],
        "median_body_proportion_lengths_(cm)": seg_dict(
            msg.median_segments
        ),
    }


def proto_to_response_dict(msg: pb.EstimateResponse) -> Dict:
    """EstimateResponse message -> HTTP-parity response dict."""
    out: Dict = {"code": msg.code, "msg": msg.msg}
    if msg.code == "success":
        out["body_proportion_lengths_(cm)"] = {
            s.name: (round(float(s.length_cm), 2) if s.visible
                     else NOT_VISIBLE)
            for s in msg.segments
        }
    return out


def np_to_infer_tensor(name: str, arr: np.ndarray) -> pb.InferTensor:
    """numpy -> wire tensor (raw little-endian C-order bytes, Triton's
    raw_*_contents convention)."""
    arr = np.ascontiguousarray(arr)
    return pb.InferTensor(
        name=name,
        datatype=NP_TO_TRITON[arr.dtype],
        shape=list(arr.shape),
        raw_data=arr.tobytes(),
    )


def infer_tensor_to_np(t: pb.InferTensor) -> np.ndarray:
    if t.datatype not in TRITON_TO_NP:
        raise ValueError(f"unsupported datatype '{t.datatype}' "
                         f"for tensor '{t.name}'")
    dtype = np.dtype(TRITON_TO_NP[t.datatype])
    shape = tuple(t.shape)
    n = int(np.prod(shape)) if shape else 1
    if len(t.raw_data) != n * dtype.itemsize:
        raise ValueError(
            f"tensor '{t.name}': {len(t.raw_data)} raw bytes != "
            f"shape {list(shape)} x {t.datatype}"
        )
    return np.frombuffer(t.raw_data, dtype=dtype).reshape(shape)


def pipelined_stream(request_iterator, run, max_workers: int = 8,
                     queue_size: int = 32):
    """Shared machinery for the two ModelStreamInfer handlers (hbpe +
    KServe): dispatch streamed requests CONCURRENTLY (so same-model
    requests coalesce in the per-model dynamic batcher) and yield
    `(request_id, future)` pairs in request order.

    Back-pressure + cancel safety (advisor r4): the queue is bounded so
    a fast client can't buffer unbounded in-flight tensor requests in
    host memory, and when the consumer stops iterating (client cancel /
    stream end) the `finally` block sets `closed`, drains the queue to
    unblock the reader thread, and cancels pooled work — no parked
    daemon threads, no leaked futures."""
    import queue
    import threading

    pool = futures.ThreadPoolExecutor(max_workers=max_workers)
    fq: "queue.Queue" = queue.Queue(maxsize=queue_size)
    closed = threading.Event()

    def _put(item) -> bool:
        while not closed.is_set():
            try:
                fq.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            for req in request_iterator:
                if not _put((req.id, pool.submit(run, req))):
                    return
        except Exception:  # noqa: BLE001 — client reset mid-stream
            pass
        finally:
            _put(None)

    threading.Thread(target=reader, daemon=True).start()
    try:
        while True:
            item = fq.get()
            if item is None:
                break
            yield item
    finally:
        closed.set()
        while True:  # unblock the reader, drop buffered work
            try:
                fq.get_nowait()
            except queue.Empty:
                break
        pool.shutdown(wait=False, cancel_futures=True)


def create_grpc_server(app: "ServingApp", host: str = "0.0.0.0",
                       port: int = 0, max_workers: int = 16):
    """Returns (grpc.Server, bound_port)."""
    import grpc

    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        decode_image_bytes,
    )
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        FAIL_MSG,
        V2_EXTENSIONS,
    )

    def estimate(request: pb.EstimateRequest, context) -> pb.EstimateResponse:
        try:
            image = decode_image_bytes(request.image)
            # person_height: proto3 zero-default -> server default (0 cm is
            # meaningless); det_threshold: explicit-presence optional so a
            # deliberate 0.0 ("accept everything", expressible on the HTTP
            # edge) survives (hbpe.proto semantics; reference
            # uvicorn_server/server.py:27,88)
            height = request.person_height_cm or 175.0
            threshold = (request.det_threshold
                         if request.HasField("det_threshold") else 0.70)
            response = app.batcher.infer(
                {"image": image, "height": height, "threshold": threshold}
            )
        except Exception:  # noqa: BLE001 — parity: error response, not a trap
            response = {"msg": FAIL_MSG, "code": "failed"}
        return response_dict_to_proto(response)

    def estimate_video(request: pb.EstimateVideoRequest,
                       context) -> pb.EstimateVideoResponse:
        try:
            height = request.person_height_cm or 175.0
            threshold = (request.det_threshold
                         if request.HasField("det_threshold") else 0.70)
            response = app.run_video(
                request.video, height, threshold,
                frame_stride=max(1, request.frame_stride),
                max_frames=request.max_frames,
            )
        except Exception:  # noqa: BLE001 — parity: error response, not a trap
            response = {"msg": FAIL_MSG, "code": "failed"}
        return video_dict_to_proto(response)

    def estimate_video_stream(request: pb.EstimateVideoRequest, context):
        """Server-streaming video: header -> FrameResults in frame order
        as device batches complete -> summary (median aggregate, frames
        list omitted). Long videos never buffer a full response."""
        height = request.person_height_cm or 175.0
        threshold = (request.det_threshold
                     if request.HasField("det_threshold") else 0.70)
        stride = max(1, request.frame_stride)
        try:
            fps, it = app.open_video_stream(
                request.video, height, threshold,
                frame_stride=stride, max_frames=request.max_frames,
            )
        except Exception:  # noqa: BLE001 — parity: failed summary, no trap
            yield pb.VideoStreamItem(
                summary=pb.EstimateVideoResponse(code="failed",
                                                 msg=FAIL_MSG)
            )
            return
        yield pb.VideoStreamItem(
            header=pb.VideoStreamHeader(fps=float(fps), frame_stride=stride)
        )
        per_frame = []
        try:
            for f in it:
                fr = pb.FrameResult(frame=int(f["frame"]), msg=f["msg"])
                _segments_to_proto(
                    f["body_proportion_lengths_(cm)"], fr.segments
                )
                per_frame.append(f)
                yield pb.VideoStreamItem(frame=fr)
        except Exception:  # noqa: BLE001
            yield pb.VideoStreamItem(
                summary=pb.EstimateVideoResponse(code="failed",
                                                 msg=FAIL_MSG)
            )
            return
        summary = app.summarize_video(per_frame, fps, stride)
        summary["frames"] = []  # already streamed
        yield pb.VideoStreamItem(summary=video_dict_to_proto(summary))

    def health(request: pb.HealthRequest, context) -> pb.HealthResponse:
        # the HTTP /health document's devices (CUDA device names) and
        # weight origins
        doc = app.health()
        msg = pb.HealthResponse(status=doc["status"], devices=doc["devices"])
        for k, v in doc["weights"].items():
            msg.weights[k] = v
        return msg

    def _run_model_infer(request: pb.ModelInferRequest) -> pb.ModelInferResponse:
        """Shared body of ModelInfer and ModelStreamInfer: registry
        dispatch + tensor (de)serialization. Raises KeyError/ValueError —
        the unary path maps them to gRPC status codes, the stream path
        to in-band error_message."""
        inputs = {t.name: infer_tensor_to_np(t) for t in request.inputs}
        out = app.registry.infer(
            request.model_name, inputs,
            list(request.output_names) or None,
            version=request.model_version,
        )
        resp = pb.ModelInferResponse(model_name=request.model_name)
        for name, arr in out.items():
            resp.outputs.append(np_to_infer_tensor(name, arr))
        return resp

    def model_infer(request: pb.ModelInferRequest,
                    context) -> pb.ModelInferResponse:
        try:
            return _run_model_infer(request)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def model_stream_infer(request_iterator, context):
        """Triton ModelStreamInfer (tritonclient stream_infer): requests
        pipeline over one HTTP/2 stream and are dispatched CONCURRENTLY,
        so in-flight requests to the same batched model coalesce through
        its per-model dynamic batcher (serve/registry.py) into shared
        device launches. Responses are yielded in request order; a
        per-request failure rides in-band as error_message (Triton's
        stream contract — the stream itself never aborts)."""
        for rid, fut in pipelined_stream(request_iterator,
                                         _run_model_infer):
            try:
                yield pb.ModelStreamInferResponse(
                    infer_response=fut.result(), id=rid
                )
            except Exception as e:  # noqa: BLE001 — in-band error
                yield pb.ModelStreamInferResponse(
                    error_message=str(e) or type(e).__name__, id=rid
                )

    def model_metadata(request: pb.ModelMetadataRequest,
                       context) -> pb.ModelMetadataResponse:
        try:
            meta = app.registry.metadata(request.model_name,
                                         request.model_version)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        resp = pb.ModelMetadataResponse(
            name=meta["name"],
            platform=meta["platform"],
            max_batch_size=meta["max_batch_size"],
            weights=meta["weights"],
            versions=meta["versions"],
        )
        for key in ("inputs", "outputs"):
            dst = getattr(resp, key)
            for t in meta[key]:
                dst.add(name=t["name"], datatype=t["datatype"],
                        shape=t["shape"])
        return resp

    def model_config(request: pb.ModelConfigRequest,
                     context) -> pb.ModelConfigResponse:
        # Triton get_model_config — fetched separately from metadata by
        # the reference client (triton_utils.py:27-31)
        try:
            cfg = app.registry.config(request.model_name,
                                      request.model_version)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        resp = pb.ModelConfigResponse(
            name=cfg["name"],
            platform=cfg["platform"],
            max_batch_size=cfg["max_batch_size"],
        )
        for key in ("input", "output"):
            dst = getattr(resp, key)
            for t in cfg[key]:
                dst.add(name=t["name"], data_type=t["data_type"],
                        format=t["format"], dims=t["dims"])
        for g in cfg["instance_group"]:
            resp.instance_group.add(count=g["count"], kind=g["kind"])
        if "dynamic_batching" in cfg:
            db = cfg["dynamic_batching"]
            resp.dynamic_batching.preferred_batch_size.extend(
                db["preferred_batch_size"]
            )
            resp.dynamic_batching.max_queue_delay_microseconds = \
                db["max_queue_delay_microseconds"]
        return resp

    def _model_control(request: pb.ModelControlRequest, context,
                       action) -> pb.ModelControlResponse:
        try:
            action(request.model_name)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return pb.ModelControlResponse(
            name=request.model_name,
            loaded=app.registry._get(request.model_name).loaded,
        )

    def model_load(request, context):
        return _model_control(request, context, app.registry.load)

    def model_unload(request, context):
        return _model_control(request, context, app.registry.unload)

    def model_ready(request: pb.ModelReadyRequest,
                    context) -> pb.ModelReadyResponse:
        # tritonclient is_model_ready: metadata() raises for an unknown
        # name/version -> NOT_FOUND; every registered model is lazily
        # servable -> ready
        try:
            app.registry.metadata(request.model_name,
                                  request.model_version)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return pb.ModelReadyResponse(ready=True)

    def server_metadata(request: pb.ServerMetadataRequest,
                        context) -> pb.ServerMetadataResponse:
        from human_body_proportion_estimation_tpu_torch import __version__

        return pb.ServerMetadataResponse(
            name="human_body_proportion_estimation_tpu_torch",
            version=__version__,
            extensions=V2_EXTENSIONS,
        )

    def model_statistics(request: pb.ModelStatisticsRequest,
                         context) -> pb.ModelStatisticsResponse:
        try:
            doc = app.registry.statistics(request.model_name,
                                          request.model_version)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        resp = pb.ModelStatisticsResponse()
        for row in doc["model_stats"]:
            stat = resp.model_stats.add(
                name=row["name"], version=row["version"],
                last_inference=row["last_inference"],
                inference_count=row["inference_count"],
                execution_count=row["execution_count"],
            )
            for key, dst in (
                ("success", stat.inference_stats.success),
                ("fail", stat.inference_stats.fail),
                ("queue", stat.inference_stats.queue),
                ("compute_input", stat.inference_stats.compute_input),
                ("compute_infer", stat.inference_stats.compute_infer),
                ("compute_output", stat.inference_stats.compute_output),
            ):
                dst.count = row["inference_stats"][key]["count"]
                dst.ns = row["inference_stats"][key]["ns"]
            for b in row["batch_stats"]:
                bs = stat.batch_stats.add(batch_size=b["batch_size"])
                bs.compute_infer.count = b["compute_infer"]["count"]
                bs.compute_infer.ns = b["compute_infer"]["ns"]
        return resp

    def _settings_rpc(updates_json: str, context, get_doc, apply_updates):
        """Shared LogSettings/TraceSetting body: empty updates_json reads,
        a JSON object updates; bad JSON / bad values -> INVALID_ARGUMENT
        (the HTTP extensions' 400 contract, advisor r4)."""
        import json as _json

        try:
            if updates_json.strip():
                updates = _json.loads(updates_json)
                if not isinstance(updates, dict):
                    raise ValueError("body must be a JSON object")
                doc = apply_updates(updates)
            else:
                doc = get_doc()
        except (ValueError, TypeError) as e:  # includes JSONDecodeError
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return _json.dumps(doc)

    def log_settings(request: pb.LogSettingsRequest,
                     context) -> pb.LogSettingsResponse:
        from human_body_proportion_estimation_tpu_torch.utils.logging import (
            configure_logging,
            log_settings as get_log_settings,
        )

        return pb.LogSettingsResponse(settings_json=_settings_rpc(
            request.updates_json, context, get_log_settings,
            configure_logging,
        ))

    def trace_setting(request: pb.TraceSettingRequest,
                      context) -> pb.TraceSettingResponse:
        from human_body_proportion_estimation_tpu_torch.serve.tracing import (
            TRACER,
        )

        return pb.TraceSettingResponse(settings_json=_settings_rpc(
            request.updates_json, context, TRACER.settings, TRACER.update,
        ))

    def repository_index(request: pb.RepositoryIndexRequest,
                         context) -> pb.RepositoryIndexResponse:
        resp = pb.RepositoryIndexResponse()
        for row in app.registry.index():
            resp.models.add(name=row["name"], state=row["state"],
                            loaded=row["loaded"], weights=row["weights"],
                            version=row["version"])
        return resp

    handlers = {
        "Estimate": grpc.unary_unary_rpc_method_handler(
            estimate,
            request_deserializer=pb.EstimateRequest.FromString,
            response_serializer=pb.EstimateResponse.SerializeToString,
        ),
        "EstimateVideo": grpc.unary_unary_rpc_method_handler(
            estimate_video,
            request_deserializer=pb.EstimateVideoRequest.FromString,
            response_serializer=pb.EstimateVideoResponse.SerializeToString,
        ),
        "EstimateVideoStream": grpc.unary_stream_rpc_method_handler(
            estimate_video_stream,
            request_deserializer=pb.EstimateVideoRequest.FromString,
            response_serializer=pb.VideoStreamItem.SerializeToString,
        ),
        "Health": grpc.unary_unary_rpc_method_handler(
            health,
            request_deserializer=pb.HealthRequest.FromString,
            response_serializer=pb.HealthResponse.SerializeToString,
        ),
        "ModelInfer": grpc.unary_unary_rpc_method_handler(
            model_infer,
            request_deserializer=pb.ModelInferRequest.FromString,
            response_serializer=pb.ModelInferResponse.SerializeToString,
        ),
        "ModelStreamInfer": grpc.stream_stream_rpc_method_handler(
            model_stream_infer,
            request_deserializer=pb.ModelInferRequest.FromString,
            response_serializer=(
                pb.ModelStreamInferResponse.SerializeToString
            ),
        ),
        "ModelMetadata": grpc.unary_unary_rpc_method_handler(
            model_metadata,
            request_deserializer=pb.ModelMetadataRequest.FromString,
            response_serializer=pb.ModelMetadataResponse.SerializeToString,
        ),
        "ModelConfig": grpc.unary_unary_rpc_method_handler(
            model_config,
            request_deserializer=pb.ModelConfigRequest.FromString,
            response_serializer=pb.ModelConfigResponse.SerializeToString,
        ),
        "RepositoryIndex": grpc.unary_unary_rpc_method_handler(
            repository_index,
            request_deserializer=pb.RepositoryIndexRequest.FromString,
            response_serializer=pb.RepositoryIndexResponse.SerializeToString,
        ),
        "ModelLoad": grpc.unary_unary_rpc_method_handler(
            model_load,
            request_deserializer=pb.ModelControlRequest.FromString,
            response_serializer=pb.ModelControlResponse.SerializeToString,
        ),
        "ModelUnload": grpc.unary_unary_rpc_method_handler(
            model_unload,
            request_deserializer=pb.ModelControlRequest.FromString,
            response_serializer=pb.ModelControlResponse.SerializeToString,
        ),
        "ModelReady": grpc.unary_unary_rpc_method_handler(
            model_ready,
            request_deserializer=pb.ModelReadyRequest.FromString,
            response_serializer=pb.ModelReadyResponse.SerializeToString,
        ),
        "ServerMetadata": grpc.unary_unary_rpc_method_handler(
            server_metadata,
            request_deserializer=pb.ServerMetadataRequest.FromString,
            response_serializer=pb.ServerMetadataResponse.SerializeToString,
        ),
        "ModelStatistics": grpc.unary_unary_rpc_method_handler(
            model_statistics,
            request_deserializer=pb.ModelStatisticsRequest.FromString,
            response_serializer=pb.ModelStatisticsResponse.SerializeToString,
        ),
        "LogSettings": grpc.unary_unary_rpc_method_handler(
            log_settings,
            request_deserializer=pb.LogSettingsRequest.FromString,
            response_serializer=pb.LogSettingsResponse.SerializeToString,
        ),
        "TraceSetting": grpc.unary_unary_rpc_method_handler(
            trace_setting,
            request_deserializer=pb.TraceSettingRequest.FromString,
            response_serializer=pb.TraceSettingResponse.SerializeToString,
        ),
    }
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        # send limit matters too: ModelInfer responses carry raw tensors
        # (a yolov5 [1,25200,85] f32 output is ~8.6 MB, over the 4 MB
        # gRPC default)
        options=[
            ("grpc.max_receive_message_length", 64 * 1024 * 1024),
            ("grpc.max_send_message_length", 64 * 1024 * 1024),
        ],
    )
    from human_body_proportion_estimation_tpu_torch.serve.kserve_grpc import (
        kserve_handlers,
    )

    server.add_generic_rpc_handlers(
        (
            grpc.method_handlers_generic_handler(SERVICE, handlers),
            # the stock KServe/Triton protocol on the SAME port: a stock
            # tritonclient[grpc] (the reference's only client dependency,
            # requirements.txt:9) connects with no code changes
            kserve_handlers(app),
        )
    )
    bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound


class GrpcClient:
    """Python client for the gRPC edge (tritonclient analog,
    reference modules/triton_utils.py:11-34)."""

    def __init__(self, target: str = "127.0.0.1:8081"):
        import grpc

        self._channel = grpc.insecure_channel(
            target,
            options=[
                ("grpc.max_receive_message_length", 64 * 1024 * 1024),
                ("grpc.max_send_message_length", 64 * 1024 * 1024),
            ],
        )
        self._estimate = self._channel.unary_unary(
            f"/{SERVICE}/Estimate",
            request_serializer=pb.EstimateRequest.SerializeToString,
            response_deserializer=pb.EstimateResponse.FromString,
        )
        self._estimate_video = self._channel.unary_unary(
            f"/{SERVICE}/EstimateVideo",
            request_serializer=pb.EstimateVideoRequest.SerializeToString,
            response_deserializer=pb.EstimateVideoResponse.FromString,
        )
        self._estimate_video_stream = self._channel.unary_stream(
            f"/{SERVICE}/EstimateVideoStream",
            request_serializer=pb.EstimateVideoRequest.SerializeToString,
            response_deserializer=pb.VideoStreamItem.FromString,
        )
        self._health = self._channel.unary_unary(
            f"/{SERVICE}/Health",
            request_serializer=pb.HealthRequest.SerializeToString,
            response_deserializer=pb.HealthResponse.FromString,
        )
        self._model_infer = self._channel.unary_unary(
            f"/{SERVICE}/ModelInfer",
            request_serializer=pb.ModelInferRequest.SerializeToString,
            response_deserializer=pb.ModelInferResponse.FromString,
        )
        self._model_stream_infer = self._channel.stream_stream(
            f"/{SERVICE}/ModelStreamInfer",
            request_serializer=pb.ModelInferRequest.SerializeToString,
            response_deserializer=pb.ModelStreamInferResponse.FromString,
        )
        self._model_metadata = self._channel.unary_unary(
            f"/{SERVICE}/ModelMetadata",
            request_serializer=pb.ModelMetadataRequest.SerializeToString,
            response_deserializer=pb.ModelMetadataResponse.FromString,
        )
        self._model_config = self._channel.unary_unary(
            f"/{SERVICE}/ModelConfig",
            request_serializer=pb.ModelConfigRequest.SerializeToString,
            response_deserializer=pb.ModelConfigResponse.FromString,
        )
        self._repository_index = self._channel.unary_unary(
            f"/{SERVICE}/RepositoryIndex",
            request_serializer=pb.RepositoryIndexRequest.SerializeToString,
            response_deserializer=pb.RepositoryIndexResponse.FromString,
        )
        self._model_load = self._channel.unary_unary(
            f"/{SERVICE}/ModelLoad",
            request_serializer=pb.ModelControlRequest.SerializeToString,
            response_deserializer=pb.ModelControlResponse.FromString,
        )
        self._model_unload = self._channel.unary_unary(
            f"/{SERVICE}/ModelUnload",
            request_serializer=pb.ModelControlRequest.SerializeToString,
            response_deserializer=pb.ModelControlResponse.FromString,
        )
        self._model_ready = self._channel.unary_unary(
            f"/{SERVICE}/ModelReady",
            request_serializer=pb.ModelReadyRequest.SerializeToString,
            response_deserializer=pb.ModelReadyResponse.FromString,
        )
        self._server_metadata = self._channel.unary_unary(
            f"/{SERVICE}/ServerMetadata",
            request_serializer=pb.ServerMetadataRequest.SerializeToString,
            response_deserializer=pb.ServerMetadataResponse.FromString,
        )
        self._model_statistics = self._channel.unary_unary(
            f"/{SERVICE}/ModelStatistics",
            request_serializer=pb.ModelStatisticsRequest.SerializeToString,
            response_deserializer=pb.ModelStatisticsResponse.FromString,
        )
        self._log_settings = self._channel.unary_unary(
            f"/{SERVICE}/LogSettings",
            request_serializer=pb.LogSettingsRequest.SerializeToString,
            response_deserializer=pb.LogSettingsResponse.FromString,
        )
        self._trace_setting = self._channel.unary_unary(
            f"/{SERVICE}/TraceSetting",
            request_serializer=pb.TraceSettingRequest.SerializeToString,
            response_deserializer=pb.TraceSettingResponse.FromString,
        )

    def estimate(self, image_bytes: bytes, person_height_cm: float = 175.0,
                 det_threshold: float = 0.70, timeout: float = 600.0) -> dict:
        resp = self._estimate(
            pb.EstimateRequest(
                image=image_bytes,
                person_height_cm=float(person_height_cm),
                det_threshold=float(det_threshold),
            ),
            timeout=timeout,
        )
        return proto_to_response_dict(resp)

    def estimate_video(self, video_bytes: bytes,
                       person_height_cm: float = 175.0,
                       det_threshold: float = 0.70,
                       frame_stride: int = 1, max_frames: int = 0,
                       timeout: float = 3600.0) -> dict:
        resp = self._estimate_video(
            pb.EstimateVideoRequest(
                video=video_bytes,
                person_height_cm=float(person_height_cm),
                det_threshold=float(det_threshold),
                frame_stride=int(frame_stride),
                max_frames=int(max_frames),
            ),
            timeout=timeout,
        )
        return proto_to_video_dict(resp)

    def estimate_video_stream(self, video_bytes: bytes,
                              person_height_cm: float = 175.0,
                              det_threshold: float = 0.70,
                              frame_stride: int = 1, max_frames: int = 0,
                              timeout: float = 3600.0):
        """Generator over the streaming video RPC: yields
        ("header", {fps, frame_stride}), then ("frame", frame_dict) per
        processed frame in order, then ("summary", video_response_dict —
        frames list empty, median included). Results arrive as the device
        computes them, not after the whole video."""
        stream = self._estimate_video_stream(
            pb.EstimateVideoRequest(
                video=video_bytes,
                person_height_cm=float(person_height_cm),
                det_threshold=float(det_threshold),
                frame_stride=int(frame_stride),
                max_frames=int(max_frames),
            ),
            timeout=timeout,
        )
        for item in stream:
            kind = item.WhichOneof("item")
            if kind == "header":
                yield "header", {
                    "fps": float(item.header.fps),
                    "frame_stride": int(item.header.frame_stride),
                }
            elif kind == "frame":
                f = item.frame
                yield "frame", {
                    "frame": int(f.frame),
                    "msg": f.msg,
                    "body_proportion_lengths_(cm)": {
                        s.name: (round(float(s.length_cm), 2) if s.visible
                                 else NOT_VISIBLE)
                        for s in f.segments
                    },
                }
            else:
                yield "summary", proto_to_video_dict(item.summary)

    def infer(self, model_name: str, inputs: Dict[str, np.ndarray],
              output_names: Optional[Sequence[str]] = None,
              timeout: float = 600.0,
              model_version: str = "") -> Dict[str, np.ndarray]:
        """Tensor-level named-model inference — the triton_client.infer
        analog (reference modules/triton_utils.py:131-177): numpy dict in,
        numpy dict out, model addressed by its repository name (and
        optionally version, '' = latest = '1')."""
        req = pb.ModelInferRequest(model_name=model_name,
                                   model_version=model_version)
        for name, arr in inputs.items():
            req.inputs.append(np_to_infer_tensor(name, np.asarray(arr)))
        if output_names:
            req.output_names.extend(output_names)
        resp = self._model_infer(req, timeout=timeout)
        return {t.name: infer_tensor_to_np(t) for t in resp.outputs}

    def stream_infer(self, requests, timeout: float = 3600.0):
        """Streaming tensor-level inference — the tritonclient
        start_stream/async_stream_infer analog over Triton's
        ModelStreamInfer RPC. `requests` is an iterable of dicts:
        {"model_name", "inputs": {name: np.ndarray}, optional "id",
        "output_names", "model_version"}. All requests pipeline over ONE
        HTTP/2 stream; in-flight requests to the same batched model
        coalesce server-side into shared device launches. Yields, in
        request order, dicts {"id", "outputs": {name: np.ndarray} | None,
        "error": str | None} — per-request failures arrive in-band, the
        stream keeps going (Triton stream semantics)."""
        def gen():
            for i, r in enumerate(requests):
                req = pb.ModelInferRequest(
                    model_name=r["model_name"],
                    model_version=r.get("model_version", ""),
                    id=str(r.get("id", i)),
                )
                for name, arr in r["inputs"].items():
                    req.inputs.append(
                        np_to_infer_tensor(name, np.asarray(arr))
                    )
                if r.get("output_names"):
                    req.output_names.extend(r["output_names"])
                yield req

        for item in self._model_stream_infer(gen(), timeout=timeout):
            if item.error_message:
                yield {"id": item.id, "outputs": None,
                       "error": item.error_message}
            else:
                yield {
                    "id": item.id,
                    "outputs": {
                        t.name: infer_tensor_to_np(t)
                        for t in item.infer_response.outputs
                    },
                    "error": None,
                }

    def model_metadata(self, model_name: str, timeout: float = 30.0,
                       model_version: str = "") -> dict:
        """parse_model_grpc analog (reference triton_utils.py:54-72)."""
        resp = self._model_metadata(
            pb.ModelMetadataRequest(model_name=model_name,
                                    model_version=model_version),
            timeout=timeout,
        )
        return {
            "name": resp.name,
            "versions": list(resp.versions),
            "platform": resp.platform,
            "max_batch_size": resp.max_batch_size,
            "weights": resp.weights,
            "inputs": [
                {"name": t.name, "datatype": t.datatype,
                 "shape": list(t.shape)}
                for t in resp.inputs
            ],
            "outputs": [
                {"name": t.name, "datatype": t.datatype,
                 "shape": list(t.shape)}
                for t in resp.outputs
            ],
        }

    def model_config(self, model_name: str, timeout: float = 30.0,
                     model_version: str = "") -> dict:
        """get_model_config analog — the reference client fetches config
        separately from metadata and reads `config.input[i].format` and
        `config.max_batch_size` (triton_utils.py:27-31, :55-73)."""
        resp = self._model_config(
            pb.ModelConfigRequest(model_name=model_name,
                                  model_version=model_version),
            timeout=timeout,
        )
        out = {
            "name": resp.name,
            "platform": resp.platform,
            "max_batch_size": resp.max_batch_size,
            "input": [
                {"name": t.name, "data_type": t.data_type,
                 "format": t.format, "dims": list(t.dims)}
                for t in resp.input
            ],
            "output": [
                {"name": t.name, "data_type": t.data_type,
                 "format": t.format, "dims": list(t.dims)}
                for t in resp.output
            ],
            "instance_group": [
                {"count": g.count, "kind": g.kind}
                for g in resp.instance_group
            ],
        }
        if resp.HasField("dynamic_batching"):
            out["dynamic_batching"] = {
                "preferred_batch_size": list(
                    resp.dynamic_batching.preferred_batch_size
                ),
                "max_queue_delay_microseconds":
                    resp.dynamic_batching.max_queue_delay_microseconds,
            }
        return out

    def load_model(self, model_name: str, timeout: float = 600.0) -> dict:
        """Eager-build a named model (tritonclient load_model analog)."""
        r = self._model_load(
            pb.ModelControlRequest(model_name=model_name), timeout=timeout
        )
        return {"name": r.name, "loaded": r.loaded}

    def unload_model(self, model_name: str, timeout: float = 60.0) -> dict:
        """Free a named model's runner/params (unload_model analog)."""
        r = self._model_unload(
            pb.ModelControlRequest(model_name=model_name), timeout=timeout
        )
        return {"name": r.name, "loaded": r.loaded}

    def model_ready(self, model_name: str, timeout: float = 30.0,
                    model_version: str = "") -> bool:
        """tritonclient is_model_ready analog (unknown model raises
        NOT_FOUND, matching Triton)."""
        r = self._model_ready(
            pb.ModelReadyRequest(model_name=model_name,
                                 model_version=model_version),
            timeout=timeout,
        )
        return bool(r.ready)

    def server_metadata(self, timeout: float = 30.0) -> dict:
        """tritonclient get_server_metadata analog."""
        r = self._server_metadata(pb.ServerMetadataRequest(),
                                  timeout=timeout)
        return {"name": r.name, "version": r.version,
                "extensions": list(r.extensions)}

    def model_statistics(self, model_name: str = "",
                         timeout: float = 30.0,
                         model_version: str = "") -> dict:
        """tritonclient get_inference_statistics analog — empty name
        returns every model's statistics."""
        resp = self._model_statistics(
            pb.ModelStatisticsRequest(model_name=model_name,
                                      model_version=model_version),
            timeout=timeout,
        )

        def _d(s):
            return {"count": int(s.count), "ns": int(s.ns)}

        return {
            "model_stats": [
                {
                    "name": m.name,
                    "version": m.version,
                    "last_inference": int(m.last_inference),
                    "inference_count": int(m.inference_count),
                    "execution_count": int(m.execution_count),
                    "inference_stats": {
                        "success": _d(m.inference_stats.success),
                        "fail": _d(m.inference_stats.fail),
                        "queue": _d(m.inference_stats.queue),
                        "compute_input": _d(
                            m.inference_stats.compute_input),
                        "compute_infer": _d(
                            m.inference_stats.compute_infer),
                        "compute_output": _d(
                            m.inference_stats.compute_output),
                    },
                    "batch_stats": [
                        {"batch_size": int(b.batch_size),
                         "compute_infer": _d(b.compute_infer)}
                        for b in m.batch_stats
                    ],
                }
                for m in resp.model_stats
            ]
        }

    def get_log_settings(self, timeout: float = 30.0) -> dict:
        """tritonclient get_log_settings analog (Triton logging ext)."""
        import json

        r = self._log_settings(pb.LogSettingsRequest(), timeout=timeout)
        return json.loads(r.settings_json)

    def update_log_settings(self, updates: dict,
                            timeout: float = 30.0) -> dict:
        """tritonclient update_log_settings analog; invalid updates raise
        INVALID_ARGUMENT (the HTTP extension's 400)."""
        import json

        r = self._log_settings(
            pb.LogSettingsRequest(updates_json=json.dumps(updates)),
            timeout=timeout,
        )
        return json.loads(r.settings_json)

    def get_trace_settings(self, timeout: float = 30.0) -> dict:
        """tritonclient get_trace_settings analog (Triton trace ext)."""
        import json

        r = self._trace_setting(pb.TraceSettingRequest(), timeout=timeout)
        return json.loads(r.settings_json)

    def update_trace_settings(self, updates: dict,
                              timeout: float = 30.0) -> dict:
        """tritonclient update_trace_settings analog."""
        import json

        r = self._trace_setting(
            pb.TraceSettingRequest(updates_json=json.dumps(updates)),
            timeout=timeout,
        )
        return json.loads(r.settings_json)

    def repository_index(self, timeout: float = 30.0) -> list:
        resp = self._repository_index(
            pb.RepositoryIndexRequest(), timeout=timeout
        )
        return [
            {"name": m.name, "version": m.version, "state": m.state,
             "loaded": m.loaded, "weights": m.weights}
            for m in resp.models
        ]

    def health(self, timeout: float = 30.0) -> dict:
        resp = self._health(pb.HealthRequest(), timeout=timeout)
        return {
            "status": resp.status,
            "devices": list(resp.devices),
            "weights": dict(resp.weights),
        }

    def close(self):
        self._channel.close()
