"""perf_analyzer-equivalent load generator for the serving edges.

The reference benchmarks with Triton's closed-source `perf_analyzer` binary
(README :82-87): gRPC, batch 1, concurrency sweep 5:20:5, p95 latency on
random inputs. This module reproduces that method against our edges — the
HTTP multipart route or, with `--grpc`, the protobuf gRPC endpoint (the
transport perf_analyzer itself uses): for each concurrency level C it
keeps C in-flight requests looping for a measurement window and reports
throughput + latency percentiles — producing the comparison table the
reference never shipped (BASELINE.md). The port's copy of the JAX
package's load generator, pointed at the port's edges.

Usage:
    python -m human_body_proportion_estimation_tpu_torch.serve.perf \
        --url http://127.0.0.1:8080 --concurrency 5:20:5 --seconds 10
    python -m human_body_proportion_estimation_tpu_torch.serve.perf \
        --grpc 127.0.0.1:8081 --concurrency 5:20:5
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Dict, List

from human_body_proportion_estimation_tpu_torch.serve.client import _multipart


def _random_jpeg(hw=(300, 300)) -> bytes:
    import cv2
    import numpy as np

    img = np.random.default_rng(0).integers(
        0, 256, (*hw, 3), dtype=np.uint8
    )
    ok, enc = cv2.imencode(".jpg", img)
    assert ok
    return enc.tobytes()


def _pct(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q / 100 * (len(s) - 1))))]


def run_level(
    host: str, port: int, path: str, concurrency: int, seconds: float,
    body: bytes, ctype: str,
) -> Dict:
    """One concurrency level: C looping workers for `seconds`."""
    import http.client

    latencies: List[float] = []
    errors = [0]
    stop = time.perf_counter() + seconds
    lock = threading.Lock()

    def worker():
        conn = http.client.HTTPConnection(host, port, timeout=120)
        while time.perf_counter() < stop:
            t0 = time.perf_counter()
            try:
                conn.request("POST", path, body=body,
                             headers={"Content-Type": ctype})
                resp = conn.getresponse()
                data = resp.read()
                ok = resp.status == 200 and b"code" in data
            except Exception:
                ok = False
                conn.close()
                conn = http.client.HTTPConnection(host, port, timeout=120)
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                if not ok:
                    errors[0] += 1
        conn.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start

    return {
        "concurrency": concurrency,
        "requests": len(latencies),
        "errors": errors[0],
        "throughput_rps": len(latencies) / wall,
        "latency_ms_p50": 1e3 * _pct(latencies, 50),
        "latency_ms_p95": 1e3 * _pct(latencies, 95),
        "latency_ms_p99": 1e3 * _pct(latencies, 99),
    }


def run_grpc_level(target: str, concurrency: int, seconds: float,
                   image: bytes) -> Dict:
    """One concurrency level over the gRPC edge (GrpcClient per worker,
    mirroring perf_analyzer's per-connection concurrency)."""
    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        GrpcClient,
    )

    latencies: List[float] = []
    errors = [0]
    stop = time.perf_counter() + seconds
    lock = threading.Lock()

    def worker():
        client = GrpcClient(target)
        while time.perf_counter() < stop:
            t0 = time.perf_counter()
            try:
                resp = client.estimate(image)
                ok = resp.get("code") in ("success", "failed")
            except Exception:
                ok = False
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                if not ok:
                    errors[0] += 1

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    return {
        "transport": "grpc",
        "concurrency": concurrency,
        "requests": len(latencies),
        "errors": errors[0],
        "throughput_rps": len(latencies) / wall,
        "latency_ms_p50": 1e3 * _pct(latencies, 50),
        "latency_ms_p95": 1e3 * _pct(latencies, 95),
        "latency_ms_p99": 1e3 * _pct(latencies, 99),
    }


def run_grpc_sweep(
    target: str, concurrency_spec: str = "5:20:5", seconds: float = 10.0,
    warmup_requests: int = 3, input_hw=(300, 300),
) -> List[Dict]:
    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        GrpcClient,
    )

    image = _random_jpeg(input_hw)
    client = GrpcClient(target)
    for _ in range(warmup_requests):
        client.estimate(image)

    lo, hi, step = (int(x) for x in concurrency_spec.split(":"))
    results = []
    for c in range(lo, hi + 1, step):
        r = run_grpc_level(target, c, seconds, image)
        results.append(r)
        print(json.dumps(r), flush=True)
    return results


def _random_model_inputs(meta: Dict, batch_size: int) -> Dict:
    """Random tensors from model metadata — perf_analyzer's method
    exactly (README :82-87: random input, batch 1, per-model): -1 batch
    dims take `batch_size`, other dynamic dims fall back to 300 (the
    1x300x300x3 default the reference quotes)."""
    import numpy as np

    from human_body_proportion_estimation_tpu_torch.serve.registry import (
        TRITON_TO_NP,
    )

    rng = np.random.default_rng(0)
    inputs = {}
    for t in meta["inputs"]:
        shape = list(t["shape"])
        for i, d in enumerate(shape):
            if d == -1:
                shape[i] = (batch_size
                            if i == 0 and meta["max_batch_size"] > 0
                            else 300)
        dtype = TRITON_TO_NP[t["datatype"]]
        if dtype == np.uint8:
            arr = rng.integers(0, 256, shape, dtype=np.uint8)
        elif np.issubdtype(dtype, np.floating):
            arr = rng.random(shape).astype(dtype)
        else:
            arr = np.zeros(shape, dtype)
        inputs[t["name"]] = arr
    return inputs


def run_model_level(target: str, model: str, concurrency: int,
                    seconds: float, inputs: Dict) -> Dict:
    """One concurrency level of tensor-level ModelInfer against a named
    model — the actual perf_analyzer recipe (`perf_analyzer -m <model>
    --concurrency-range ...`, reference README :82-87)."""
    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        GrpcClient,
    )

    latencies: List[float] = []
    errors = [0]
    stop = time.perf_counter() + seconds
    lock = threading.Lock()

    def worker():
        client = GrpcClient(target)
        while time.perf_counter() < stop:
            t0 = time.perf_counter()
            try:
                client.infer(model, inputs)
                ok = True
            except Exception:
                ok = False
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                if not ok:
                    errors[0] += 1
        client.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    return {
        "transport": "grpc_model_infer",
        "model": model,
        "concurrency": concurrency,
        "requests": len(latencies),
        "errors": errors[0],
        "throughput_rps": len(latencies) / wall,
        "latency_ms_p50": 1e3 * _pct(latencies, 50),
        "latency_ms_p95": 1e3 * _pct(latencies, 95),
        "latency_ms_p99": 1e3 * _pct(latencies, 99),
    }


def run_model_sweep(
    target: str, model: str, concurrency_spec: str = "5:20:5",
    seconds: float = 10.0, batch_size: int = 1, warmup_requests: int = 3,
) -> List[Dict]:
    """perf_analyzer -m <model>: metadata-driven random inputs, per-model
    concurrency sweep over ModelInfer."""
    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        GrpcClient,
    )

    client = GrpcClient(target)
    meta = client.model_metadata(model)
    inputs = _random_model_inputs(meta, batch_size)
    for _ in range(warmup_requests):  # lazy load + bucket compiles
        client.infer(model, inputs, timeout=1800)

    def _counts():
        try:
            (row,) = client.model_statistics(model)["model_stats"]
            return row["inference_count"], row["execution_count"]
        except Exception:  # noqa: BLE001 — older server without the RPC
            return None, None

    lo, hi, step = (int(x) for x in concurrency_spec.split(":"))
    results = []
    inf0, exe0 = _counts()
    for c in range(lo, hi + 1, step):
        r = run_model_level(target, model, c, seconds, inputs)
        # server-side counters per pass (perf_analyzer reports these from
        # get_inference_statistics): the inference/execution ratio is the
        # dynamic-batching coalescing factor actually achieved
        inf1, exe1 = _counts()
        if inf0 is not None and inf1 is not None:
            d_inf, d_exe = inf1 - inf0, exe1 - exe0
            r["server_inference_count"] = d_inf
            r["server_execution_count"] = d_exe
            if d_exe > 0:
                r["batching_ratio"] = round(d_inf / d_exe, 2)
            inf0, exe0 = inf1, exe1
        results.append(r)
        print(json.dumps(r), flush=True)
    client.close()
    return results


def run_sweep(
    url: str, concurrency_spec: str = "5:20:5", seconds: float = 10.0,
    warmup_requests: int = 3, input_hw=(300, 300),
) -> List[Dict]:
    from urllib.parse import urlparse

    u = urlparse(url)
    host, port = u.hostname, u.port or 80
    path = "/body_proportion_length_estimation_file"
    body, ctype = _multipart(
        {"file": (_random_jpeg(input_hw), "perf.jpg")})

    # warmup (first-compile)
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=600)
    for _ in range(warmup_requests):
        conn.request("POST", path, body=body,
                     headers={"Content-Type": ctype})
        conn.getresponse().read()
    conn.close()

    lo, hi, step = (int(x) for x in concurrency_spec.split(":"))
    results = []
    for c in range(lo, hi + 1, step):
        r = run_level(host, port, path, c, seconds, body, ctype)
        results.append(r)
        print(json.dumps(r), flush=True)
    return results


def main():
    parser = argparse.ArgumentParser(description="HTTP perf sweep")
    parser.add_argument("--url", default="http://127.0.0.1:8080")
    parser.add_argument("--concurrency", default="5:20:5",
                        help="lo:hi:step (reference perf_analyzer sweep)")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--grpc", default=None, metavar="HOST:PORT",
                        help="sweep the gRPC edge instead of HTTP "
                             "(perf_analyzer's own transport)")
    parser.add_argument("--model", default=None,
                        help="sweep tensor-level ModelInfer against this "
                             "named repository model (perf_analyzer -m "
                             "<model> parity; requires --grpc for the "
                             "target address)")
    parser.add_argument("--batch-size", type=int, default=1,
                        help="request batch for --model sweeps "
                             "(perf_analyzer default: 1)")
    args = parser.parse_args()
    if args.model:
        run_model_sweep(args.grpc or "127.0.0.1:8081", args.model,
                        args.concurrency, args.seconds, args.batch_size)
    elif args.grpc:
        run_grpc_sweep(args.grpc, args.concurrency, args.seconds)
    else:
        run_sweep(args.url, args.concurrency, args.seconds)


if __name__ == "__main__":
    main()
