"""HTTP client SDK for the serving edge — the user-facing analog of the
reference's client plumbing.

Reference users talk to the service with hand-rolled `requests.post`
multipart calls against the FastAPI app (`uvicorn_server/server.py:85-119`)
or `tritonclient` for raw tensors (`modules/triton_utils.py:11-34`). This
module gives the same one-call ergonomics against this framework's HTTP
edge on the stdlib only (no requests dependency):

    client = HttpClient("127.0.0.1", 8080)
    client.estimate_image("person.jpg", person_height_cm=193)
    client.estimate_video("clip.mp4", frame_stride=5)
    client.health(); client.metrics()

The gRPC twin (`serve.grpc_server.GrpcClient`) covers the tensor-level
contract over gRPC; this covers the JSON contract and the KServe-v2 HTTP
routes. The port's copy of the JAX package's client: it imports neither
grpc nor protobuf.
"""

from __future__ import annotations

import json
import mimetypes
import uuid
from typing import Any, Dict


def _multipart(fields: Dict[str, tuple]) -> tuple:
    """fields: name -> (bytes_or_str, filename_or_None). Returns
    (body, content_type)."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, (data, filename) in fields.items():
        disp = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
            guessed = mimetypes.guess_type(filename)[0]
            disp += (f"\r\nContent-Type: "
                     f"{guessed or 'application/octet-stream'}")
        payload = data if isinstance(data, bytes) else str(data).encode()
        parts.append(
            f"--{boundary}\r\n{disp}\r\n\r\n".encode() + payload + b"\r\n"
        )
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


class HttpClient:
    """Blocking client for the HTTP serving edge."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 timeout: float = 600.0):
        self.host = host
        self.port = port
        self.timeout = timeout

    # ------------------------------------------------------------------ #

    def _request(self, method: str, path: str, body: bytes | None = None,
                 content_type: str | None = None) -> Dict[str, Any]:
        import http.client

        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            headers = {}
            if content_type:
                headers["Content-Type"] = content_type
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = json.loads(resp.read())
            data["_http_status"] = resp.status
            return data
        finally:
            conn.close()

    @staticmethod
    def _read(path_or_bytes) -> tuple:
        if isinstance(path_or_bytes, (bytes, bytearray)):
            return bytes(path_or_bytes), "upload"
        with open(path_or_bytes, "rb") as f:
            return f.read(), str(path_or_bytes)

    # ------------------------------------------------------------------ #

    def estimate_image(
        self,
        image,
        person_height_cm: int = 175,
        det_threshold: float = 0.70,
        back_url: str = "",
    ) -> Dict[str, Any]:
        """POST an image (path or bytes); returns the response JSON
        (reference contract: code / msg / body_proportion_lengths_(cm))."""
        data, name = self._read(image)
        fields = {
            "file": (data, name),
            "person_height_in_cm": (person_height_cm, None),
            "threshold": (det_threshold, None),
        }
        if back_url:
            fields["back_url"] = (back_url, None)
        body, ctype = _multipart(fields)
        return self._request(
            "POST", "/body_proportion_length_estimation_file", body, ctype
        )

    def estimate_video(
        self,
        video,
        person_height_cm: int = 175,
        det_threshold: float = 0.70,
        frame_stride: int = 1,
        max_frames: int = 0,
        back_url: str = "",
    ) -> Dict[str, Any]:
        """POST a video (path or bytes); returns per-frame results plus
        the median summary (see serve.server.handle_video_estimation)."""
        data, name = self._read(video)
        fields = {
            "file": (data, name),
            "person_height_in_cm": (person_height_cm, None),
            "threshold": (det_threshold, None),
            "frame_stride": (frame_stride, None),
        }
        if max_frames:
            fields["max_frames"] = (max_frames, None)
        if back_url:
            fields["back_url"] = (back_url, None)
        body, ctype = _multipart(fields)
        return self._request(
            "POST", "/body_proportion_length_estimation_video", body, ctype
        )

    def estimate_video_stream(
        self,
        video,
        person_height_cm: int = 175,
        det_threshold: float = 0.70,
        frame_stride: int = 1,
        max_frames: int = 0,
    ):
        """POST a video to the streaming endpoint; yields parsed NDJSON
        lines as the server emits them: a header dict first, then one
        dict per frame in order, then the median summary last (the HTTP
        twin of GrpcClient.estimate_video_stream)."""
        import http.client

        data, name = self._read(video)
        fields = {
            "file": (data, name),
            "person_height_in_cm": (person_height_cm, None),
            "threshold": (det_threshold, None),
            "frame_stride": (frame_stride, None),
        }
        if max_frames:
            fields["max_frames"] = (max_frames, None)
        body, ctype = _multipart(fields)
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            conn.request(
                "POST", "/body_proportion_length_estimation_video_stream",
                body=body, headers={"Content-Type": ctype},
            )
            resp = conn.getresponse()  # http.client handles the chunking
            if resp.getheader("Content-Type") != "application/x-ndjson":
                # pre-stream failure: a single JSON error body
                yield json.loads(resp.read())
                return
            for line in resp:
                line = line.strip()
                if line:
                    yield json.loads(line)
        finally:
            conn.close()

    def health(self) -> Dict[str, Any]:
        return self._request("GET", "/health")

    def metrics(self) -> Dict[str, Any]:
        return self._request("GET", "/metrics")

    def docs(self) -> Dict[str, Any]:
        """The OpenAPI 3 document (/docs itself serves the Swagger-UI
        HTML page, like the reference's FastAPI auto-docs)."""
        return self._request("GET", "/openapi.json")

    def live(self) -> bool:
        """KServe-v2 liveness (tritonclient.is_server_live analog)."""
        return self._request("GET", "/v2/health/live").get("live", False)

    def ready(self) -> bool:
        """KServe-v2 readiness (tritonclient.is_server_ready analog)."""
        return self._request("GET", "/v2/health/ready").get("ready", False)

    def models(self) -> Dict[str, Any]:
        """Model-repository index (read-only mirror of the gRPC
        RepositoryIndex RPC)."""
        return self._request("GET", "/v2/models")

    def model_metadata(self, name: str,
                       version: str = "") -> Dict[str, Any]:
        path = f"/v2/models/{name}"
        if version:
            path += f"/versions/{version}"
        return self._request("GET", path)

    def model_config(self, name: str, version: str = "") -> Dict[str, Any]:
        """Triton get_model_config analog — fetched separately from
        metadata, exactly like the reference client
        (triton_utils.py:27-31)."""
        path = f"/v2/models/{name}"
        if version:
            path += f"/versions/{version}"
        return self._request("GET", path + "/config")

    def server_metadata(self) -> Dict[str, Any]:
        """KServe-v2 server metadata (tritonclient get_server_metadata
        analog): name, version, protocol extensions."""
        return self._request("GET", "/v2")

    def model_ready(self, name: str, version: str = "") -> bool:
        """Per-model readiness (tritonclient is_model_ready analog);
        False for an unknown model/version."""
        path = f"/v2/models/{name}"
        if version:
            path += f"/versions/{version}"
        return self._request("GET", path + "/ready").get("ready", False)

    def get_log_settings(self) -> Dict[str, Any]:
        """Triton logging extension (tritonclient get_log_settings
        analog): the server's runtime log switches."""
        return self._request("GET", "/v2/logging")

    def update_log_settings(self, settings: Dict[str, Any]) -> Dict[str, Any]:
        """tritonclient update_log_settings analog: POST the fields to
        change; returns the full resulting settings (check _http_status
        == 400 for rejected updates)."""
        return self._request("POST", "/v2/logging",
                             body=json.dumps(settings).encode(),
                             content_type="application/json")

    def get_trace_settings(self) -> Dict[str, Any]:
        """Triton trace extension (tritonclient get_trace_settings
        analog): the string-valued global trace settings document."""
        return self._request("GET", "/v2/trace/setting")

    def update_trace_settings(self,
                              settings: Dict[str, Any]) -> Dict[str, Any]:
        """tritonclient update_trace_settings analog."""
        return self._request("POST", "/v2/trace/setting",
                             body=json.dumps(settings).encode(),
                             content_type="application/json")

    def get_model_repository_index(self, ready: bool = False) -> list:
        """POST /v2/repository/index — Triton's model-repository HTTP
        extension (tritonclient.http get_model_repository_index): rows
        of {name, version, state, reason}. `ready=True` filters to
        READY models (all of ours are)."""
        status, _, raw = self._request_raw(
            "POST", "/v2/repository/index",
            body=json.dumps({"ready": ready}).encode(),
            headers={"Content-Type": "application/json"},
        )
        if status != 200:
            # status first: a non-JSON error body (proxy HTML, truncated
            # response) must surface as the RuntimeError, not a decode
            # error
            try:
                detail = json.loads(raw).get("error", raw)
            except ValueError:
                detail = raw[:200]
            raise RuntimeError(f"repository index failed: {detail}")
        return json.loads(raw)

    def load_model(self, name: str) -> None:
        """POST /v2/repository/models/<name>/load (tritonclient.http
        load_model analog); raises on the extension's 400 error."""
        out = self._request("POST", f"/v2/repository/models/{name}/load",
                            body=b"{}", content_type="application/json")
        if out["_http_status"] != 200:
            raise RuntimeError(out.get("error", str(out)))

    def unload_model(self, name: str,
                     unload_dependents: bool = False) -> None:
        """POST /v2/repository/models/<name>/unload (tritonclient.http
        unload_model analog, incl. its unload_dependents parameter);
        raises on the extension's 400 error."""
        body = json.dumps(
            {"parameters": {"unload_dependents": unload_dependents}}
        ).encode() if unload_dependents else b"{}"
        out = self._request(
            "POST", f"/v2/repository/models/{name}/unload",
            body=body, content_type="application/json",
        )
        if out["_http_status"] != 200:
            raise RuntimeError(out.get("error", str(out)))

    def _request_raw(self, method: str, path: str, body: bytes,
                     headers: Dict[str, str]):
        """Like _request but returns (status, headers, raw bytes) — for
        the binary-tensor transport where the body is not pure JSON."""
        import http.client

        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def infer(self, name: str, inputs: Dict[str, Any],
              output_names=None, version: str = "",
              binary: bool = True,
              class_counts: Dict[str, int] | None = None
              ) -> Dict[str, Any]:
        """KServe-v2 HTTP inference (POST /v2/models/<name>/infer) — the
        HTTP twin of GrpcClient.infer. numpy dict in, numpy dict out;
        raises ValueError with the server's KServe {"error": ...} message
        on 4xx.

        binary=True (default, matching tritonclient's HTTP path) ships
        tensors via Triton's binary_tensor_data extension: one JSON
        header (Inference-Header-Content-Length) + raw little-endian
        bytes, both directions — no float->JSON text inflation.
        binary=False uses pure-JSON `data` arrays. `class_counts`
        ({output: k}) requests Triton's classification extension: those
        outputs come back as top-k "value:index" BYTES strings."""
        import numpy as np

        from human_body_proportion_estimation_tpu_torch.serve.registry import (
            NP_TO_TRITON,
            TRITON_TO_NP,
        )

        path = f"/v2/models/{name}"
        if version:
            path += f"/versions/{version}"
        path += "/infer"

        arrs = {k: np.asarray(v) for k, v in inputs.items()}
        if not binary:
            doc = {"inputs": [
                {"name": k, "shape": list(v.shape),
                 "datatype": NP_TO_TRITON[v.dtype],
                 "data": v.ravel().tolist()}
                for k, v in arrs.items()
            ]}
            if output_names:
                doc["outputs"] = [
                    {"name": n, **({"parameters":
                                    {"classification": class_counts[n]}}
                                   if (class_counts or {}).get(n) else {})}
                    for n in output_names
                ]
            resp = self._request(
                "POST", path, json.dumps(doc).encode(),
                "application/json",
            )
            if resp["_http_status"] != 200:
                raise ValueError(
                    f"infer '{name}' failed "
                    f"({resp['_http_status']}): {resp.get('error')}"
                )
            return {
                t["name"]: (
                    np.asarray(
                        [x.encode() for x in t["data"]], dtype=object
                    ).reshape(t["shape"])
                    if t["datatype"] == "BYTES" else
                    np.asarray(
                        t["data"], dtype=TRITON_TO_NP[t["datatype"]]
                    ).reshape(t["shape"])
                )
                for t in resp["outputs"]
            }

        # binary_tensor_data transport
        chunks = []
        tensors = []
        for k, v in arrs.items():
            raw = np.ascontiguousarray(v).astype(
                v.dtype.newbyteorder("<"), copy=False
            ).tobytes()
            chunks.append(raw)
            tensors.append({
                "name": k, "shape": list(v.shape),
                "datatype": NP_TO_TRITON[v.dtype],
                "parameters": {"binary_data_size": len(raw)},
            })
        doc = {"inputs": tensors,
               # all outputs binary unless the caller narrows them
               "parameters": {"binary_data_output": True}}
        if output_names:
            doc["outputs"] = []
            for n in output_names:
                p = {"binary_data": True}
                if (class_counts or {}).get(n):
                    p["classification"] = class_counts[n]
                doc["outputs"].append({"name": n, "parameters": p})
        header = json.dumps(doc).encode()
        status, resp_headers, payload = self._request_raw(
            "POST", path, header + b"".join(chunks),
            {"Content-Type": "application/octet-stream",
             "Inference-Header-Content-Length": str(len(header))},
        )
        hlen = {k.lower(): v for k, v in resp_headers.items()}.get(
            "inference-header-content-length"
        )
        if status != 200:
            err = json.loads(payload)
            raise ValueError(
                f"infer '{name}' failed ({status}): {err.get('error')}"
            )
        if hlen is None:  # server answered pure JSON
            reply, blob = json.loads(payload), b""
        else:
            reply = json.loads(payload[:int(hlen)])
            blob = payload[int(hlen):]
        out, cursor = {}, 0
        for t in reply["outputs"]:
            nbin = (t.get("parameters") or {}).get("binary_data_size")
            if t["datatype"] == "BYTES":
                from human_body_proportion_estimation_tpu_torch.serve.wire import (  # noqa: E501
                    deserialize_bytes_tensor,
                )

                if nbin is not None:
                    rows = deserialize_bytes_tensor(
                        blob[cursor:cursor + int(nbin)]
                    )
                    cursor += int(nbin)
                else:
                    rows = [x.encode() for x in t["data"]]
                out[t["name"]] = np.asarray(
                    rows, dtype=object
                ).reshape(t["shape"])
                continue
            dtype = np.dtype(TRITON_TO_NP[t["datatype"]]).newbyteorder("<")
            if nbin is not None:
                out[t["name"]] = np.frombuffer(
                    blob, dtype=dtype, count=int(nbin) // dtype.itemsize,
                    offset=cursor,
                ).reshape(t["shape"])
                cursor += int(nbin)
            else:
                out[t["name"]] = np.asarray(
                    t["data"], dtype=dtype
                ).reshape(t["shape"])
        return out

    def model_stats(self, name: str = "",
                    version: str = "") -> Dict[str, Any]:
        """Per-model inference statistics (Triton
        get_inference_statistics / GET /v2/models/<name>/stats analog);
        empty name returns every model's statistics."""
        if not name:
            return self._request("GET", "/v2/models/stats")
        path = f"/v2/models/{name}"
        if version:
            path += f"/versions/{version}"
        return self._request("GET", path + "/stats")
