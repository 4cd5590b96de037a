#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py                 # all phases, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --ptxas         # also print nvcc -Xptxas -v
    python3 chip_smoke.py --profile       # + torch.profiler of B=16 serving
    python3 chip_smoke.py --edge-sweep    # + the serving edge's load under
                                          # other settings (engine, batches
                                          # in flight, client threads)
    python3 chip_smoke.py --phases T      # phase 3, then only the phases
                                          # named (no result line)
    python3 chip_smoke.py --time-kernels [--repo DIR] [--kernel NAME]
                                          # kernel times only (all, or those
                                          # whose name contains NAME), of this
                                          # checkout or of another checkout of
                                          # the port (e.g. the parent commit,
                                          # to compare two versions on one
                                          # card in one call)

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. setup: the card, then build every kernel of `csrc/` from the checkout.
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the main path's shapes — heatmap decode [48,17,96,72] with
     planted ties, all-negative rows and NaN maps (exact, NaN-aware), NMS
     sweep [16,128] at t = 0.5 and 0.3 with an at-threshold pair, [16,512],
     [1,512] and a ladder of 512 boxes, the +1-pixel IoU variant at
     [1,512], [16,128] and on the ladder, then the cases of
     tests/torch_port_nms_cases.py under both IoU forms (NaN and infinite
     boxes, K from 1 to 512, B = 1, dead, identical and zero-area boxes, a
     chain across three 32-box blocks; all exact; K = 513 refused),
     head-score on the five pyramid levels with the certified predict_pw
     weights, at B=16 and B=1, through the grouped one-launch entry point
     and the one-level wrapper (|kernel - plain| <= 1e-3 + 1e-3 |plain|).
     Each is timed with CUDA events beside its plain version and a
     one-call PyTorch yardstick: `ms` launched eagerly back to back, which
     includes the host's time per call, and `graph_ms` replayed from a CUDA
     graph, which is the card alone; the NMS sweep, which no library call
     computes, beside a kernel that does nothing in its launch shape.
  3. main path: `InferencePipeline(device="cuda")` on the certified
     checkpoint answers 3 `infer_bytes` requests (scenes of
     tests/data/torch_port) and one `infer_serving` batch of 16, with the
     launch counters set to 0 just before and read just after; every
     kernel must have launched once a forward (4 each). The batch's
     packed output on the 3 scenes is held against the JAX package's
     goldens (identical person_valid;
     segments visible in both: mean |dcm| <= 1.0, max |dcm| <= 6.0), and
     infer_serving at B=16 is timed.
     With --profile, 3 more batches run under torch.profiler: per-stage
     host and device ms (the pipeline's record_function ranges), the
     device busy share, and the kernel table in
     chiprun_out/port_profile_b16.txt.
  A. serving edge, on the same pipeline: `prewarm_serving` (buckets 1-16),
     then the port's `ServingApp` (native C++ batcher, two batches in
     flight) behind `create_server` on 127.0.0.1:0 in a thread. The 3
     scenes POSTed one at a time, then 48 requests from 16 client threads
     (each scene 16 times, height 150 + i) with the launch counters set to
     0 just before and read just after: every answer against its scene's
     golden scaled by height / 175 (same segment visibility, max |dcm| <=
     6.0; the mean <= 1.0 over each group of answers); /metrics must show
     the 48 requests, no failure, a mean batch above 1, every stage, and
     each kernel launched once a batch (launches == the growth of
     batches_total). /health must name the
     card, both weight slots "synthetic-certified", prewarmed, and the
     card's memory. A 12-frame MJPG clip of the scenes goes to the video
     route (frame_stride 2) and the NDJSON stream route: frames 0, 2, ..,
     10 in order, each against its scene's golden.
  B. CLI: `python3 -m human_body_proportion_estimation_tpu_torch.cli.
     detect_pose` on a directory of the 3 scenes, in a subprocess: exit 0,
     3 frame_*.jpg files, every printed person's cm against the goldens.
  C. the model registry and the wire protocols, on the same pipeline: a
     `ServingApp` on 127.0.0.1:0 and, where `grpc` and `google.protobuf`
     import, its gRPC server (hbpe and KServe services) on 127.0.0.1:0;
     without them a line names the missing module and only HTTP is driven.
     The index and the documents of the 7 models at full width; the
     ensemble on the 3 scenes over HTTP binary_tensor_data (and gRPC
     ModelInfer): as many persons as the goldens, boxes within 0.01 of the
     main path's, heatmaps decoded by the decode kernel into cm as the
     reference client does, under phase 3's rule; edetlite4 and
     edetlite4_modified: 100 slots, scores non-increasing, 1-based
     classes, and the NMS kernel's keep masks equal to the plain version's
     on the very candidates the path gave it; hrnet under 48 requests of
     1-4 crops from 16 threads (each answer against a forward of its
     rows in a launch bucket, fewer launches than requests); hbpe
     Estimate on the scenes. Every
     request is counted from 0: an EfficientDet registry request launches
     nms_sweep once and nothing else, hrnet nothing, an Estimate batch
     each kernel once. Prints hrnet requests/s, rows per launch and
     p50/p95 at 16 clients, and the ensemble's ms a request at 1 client.
  Y. the YOLOv5 slot, `--detector yolov5m` at full width (YOLOv5m on
     640x640 letterboxed input, the certified HRNet-W32), with the seeded
     random weights of tests/data/torch_port/yolo_goldens.json made again
     on the CPU: `infer_serving` at B=16 on the 3 scenes in f32 with TF32
     off against the JAX goldens (f32; persons identical, phase 3's cm
     rule, B=1 boxes within 0.05 px) and in bf16 as the server serves it;
     the port's CPU path at B=1 against the card's; every keep mask the
     path gave the NMS kernel against the plain version; launches counted
     from 0: nms_sweep = decode_heatmaps = forwards, head_score = 0; the
     server (16 requests from 4 clients, each answer equal to its scene's
     forward at its batch size, /health "random"); the registry's yolov5m
     over HTTP and hbpe gRPC with the NMS on the client at top_k 512
     (official and +1 legacy, against the in-process detect_yolo
     program); `detect_yolo` in subprocesses (remote -g, default,
     --legacy-nms); imgs/s at B=16 beside Lite4 and the NMS kernel on the
     path's own candidates.
  S. the SSD-MobileNetV1 slot (ROADMAP item 10; the JAX default
     detector), with the seeded weights of
     tests/data/torch_port/ssd_goldens.json made again on the CPU
     (tests/torch_port_ssd.py: flax's draw with a folded calibration, the
     test-made anchor table): `InferencePipeline(detector="ssd_mobilenet")`
     in f32 (TF32 off) at B=16 and B=1 on the scenes against the JAX
     goldens (the same 10 SSD slots a scene, boxes within 0.05 det-input
     px, scores within 1e-4; the served rows under phase 3's rule);
     launches counted from 0: one NMS sweep an SSD batch, the keep masks
     on the path's own [16,128] class-offset candidates equal the plain
     version's; the registry's `ssd_mobilenet` on those weights over
     HTTP JSON, hbpe gRPC and KServe gRPC, each answer equal to the
     in-process program; `HumanDetectorSSD` on a tflite written here
     without TensorFlow (tests/torch_port_tflite.py) against `SSDBackend`
     on the dequantized weights; `serve.server` with its default
     `--detector` exits 2 naming the absent ssd.tflite; the certified
     pipeline written as an Orbax checkpoint by the port's own store
     (`models/orbax_store.py`, no tensorstore) and read back bit-equal,
     both timed, and `--checkpoint-dir` from it serving the compact
     checkpoint's rows; the committed JAX-written Orbax fixture
     (tests/data/torch_port/orbax_jax/) read bit-equal to its .npz twin;
     `cli.import_weights --efficientdet-ckpt DIR --hrnet-torch PTH` in a
     subprocess begun at the phase's start, on the certified Lite4 written
     here as an automl-format TF1 TensorBundle without TensorFlow
     (tests/torch_port_tfbundle.py: two data shards, every 8th tensor with
     an ExponentialMovingAverage shadow holding the certified value and
     its plain name the value + 1.0) and the certified W32 as an official
     .pth; its checkpoint served by `--checkpoint-dir` (weights real/real,
     the compact checkpoint's rows at B=16, one launch of each kernel); the
     reader's MB/s and the CRC32C's GB/s timed in process; the committed
     TF-written fixtures (tests/data/torch_port/tf_bundles/, a TF1
     SavedModel among them) read with tensorflow blocked, bit-equal to
     their .npz twins; `cli.import_weights --efficientdet-saved-model DIR
     --hrnet-torch PTH` in a second subprocess begun at the phase's start,
     on the certified Lite4 written here as a TF1 SavedModel without
     TensorFlow (tests/torch_port_tfbundle.py: 1 062 resource variables
     under automl names, a sharded saver's restore graph over two data
     files, a local variable that a Fill sets), its checkpoint served the
     same way (the compact checkpoint's rows, one launch of each kernel);
     the .pb's parse and the reader's MB/s timed in process;
     imgs/s at B=16 beside Lite4.
  D. the other slots and their CLIs (ROADMAP item 12), with the seeded
     weights of tests/data/torch_port/slot_goldens.json made again on the
     CPU (tests/torch_port_slots.py): the f32 (TF32 off) EfficientDet-Lite0
     `EdetDetectPipeline` at B=3 and HigherHRNet on the scenes' 384x288
     crops against the JAX goldens (the same detections, boxes within
     0.05 px, scores within 1e-4; every map's argmax identical, maxima
     within 1e-3 + 1e-3 relative); `--detector efficientdet_lite0` as the
     server builds it (/health random / synthetic-certified) with the
     seeded Lite0 at B=16 and B=1: launches 1 / 1 / 1 a forward, every
     keep mask against plain, the head-score kernel at F = 64 on the
     forward's own level features (B=16 and B=1, phase 2's rule); the
     HigherHRNet pose slot at B=16: the decode kernel on the forward's own
     [48,17,192,144] maps and with NaN maps, exact; the registry's
     higherhrnet over HTTP binary_tensor_data and hbpe gRPC, each answer
     equal to the forward of its rows zero-padded to the launch bucket;
     detect_edet (Lite4, Lite0) and pose_est (hrnet_w32, hrnet_w48,
     higherhrnet) in subprocesses, then with -g against the Lite0 server's
     gRPC edge (edetlite4, hrnet, higherhrnet), each remote answer equal to
     the registry's forward here at batch size 1; imgs/s at B=16 beside
     Lite4; head-score F = 64 (B=16, B=1) and decode [48,17,192,144] timed
     beside their bounds and the library call.
  U. bottom-up pose (ROADMAP item 13), with the seeded HigherHRNet of
     tests/data/torch_port/bottomup_goldens.json (slot_goldens.json's seed)
     made again on the CPU: the AE decode on the card against JAX's on the
     cases of tests/torch_port_bottomup.py (bit for bit, NaN maps
     included); the f32 (TF32 off) `BottomUpPipeline` at 512x512 on the
     scenes: every argmax of the aggregated heat and tag maps identical to
     the goldens', maxima within 1e-3 + 1e-3 relative, the card's decode of
     its maps equal to the port's CPU decode of them, and the grouped
     outputs and packed rows of both recorded decode configurations equal
     to the goldens' wherever the card's maxima lie within the noise the
     goldens' decode withstood; the served bf16 form (random:
     flax's init with PRNGKey(0)) at B=16 and B=1, launches 0 / 0 / 0,
     imgs/s, a torch.profiler split (chiprun_out/bottomup_profile_b16.txt)
     and the decode's CUDA launches and device time at B=16; the registry's
     higherhrnet running the pipeline's module; the serving edge over the
     seeded weights in bf16 with the wide tag threshold (16 file-route
     requests from 4 clients, each answer equal to its scene's in-process
     forward at batch size 1, 2 or 4, cm values in them);
     `serve.server --bottom-up` (default --detector, random weights, which
     find nobody) in a subprocess: /health, 16 file-route requests
     from 4 clients (each answer equal to its scene's in-process forward
     at batch size 1, 2 or 4), the video route, the registry's
     higherhrnet over HTTP and hbpe gRPC (equal to the module on rows
     padded to the bucket), hbpe Estimate; `detect_pose_bottomup` in a
     subprocess (as many persons as the in-process forward, its frame).
  E. `cli.evaluate --detector efficientdet_lite4` in a subprocess on the
     scenes and tests/data/torch_port/scenes_coco.json (their ground
     truth), equal to the same run in process (one launch of each kernel);
     box and keypoint AP50 equal to JAX's run_eval recorded there, every
     other AP within the most one match at one threshold changes it on
     these matches (a tenth of that for the mAPs), PCK within one keypoint.
  T. training (ROADMAP item 15): float64 and float32 (TF32 off) train
     steps at full width and depth, batch 2, three Adam steps each
     (HRNet-W32 384x288 on the certified weights, EfficientDet-Lite0
     480x640 and HigherHRNet-W32 512x512 from numpy-drawn flax-like inits;
     tests/torch_port_train.py) against the JAX float64 goldens of
     tests/data/torch_port/train_goldens.json, and the pose case's bf16
     steps (f32 parameters) against its JAX bfloat16 goldens (losses,
     gradient norms,
     two BatchNorms' running statistics, at the file's tolerance for the
     dtype, case and group of figures); bf16
     training imgs/s, peak memory and the loss trend of pose B=16, Lite0
     detection B=8 and bottom-up B=8, and a profile of the pose step
     (chiprun_out/train_profile_pose_b16.txt); `cli.certify.main` in
     process on a short budget (Lite0, 120 + 120 steps at batch 4) and
     `cli.certify_bottomup.main` (120 steps at batch 4): the JAX report's
     keys, finite falling losses, the reload equal to the trained state
     (checked inside the CLIs), every request of the served sweeps
     answered, launches counted from 0 (certify: each kernel at least
     once; bottom-up: none); the gates are printed, not asserted (they
     need the full budget); certify's Orbax `ckpt/` served by
     `serve.server --checkpoint-dir`, a B=16 batch at det threshold 0.05
     equal to the CLI's reloaded pipeline, with persons found.
  X. the deployable artifact (ROADMAP item 16, first half): phase 3's
     certified Lite4 -> W32 pipeline exported with torch.export at B=16
     (`pipeline/export.py`, the three kernels as `hbpe` ops of its graph),
     timed; restored in a fresh process (`--artifact-worker`), which
     builds no port module and reads no .npz, and serves the 3 scenes
     repeated to 16 and to 20 images (chunks of 16 and 4): one launch of
     each kernel an artifact batch, one packing of the head weights over
     6 batches, rows against the live forward at B=16 (identical
     expected, phase 3's rule the limit) and against the goldens;
     `serve.server --artifact-dir --prewarm` beside the live server (start
     to ready, /health, 48 file-route requests from 16 clients against
     the goldens x height/175); imgs/s at B=16 in turns with the live
     pipeline; a seeded f32 YOLOv5m and a seeded f32 bottom-up artifact at
     B=2, each identical to its live pipeline (YOLO: one NMS and one
     decode launch a batch; bottom-up none), made by a subprocess
     (`--slots-worker`) beside the export and the restore, and waited for
     before the servers start; `compile_cache.enable(dir)`: one process
     (`--cache-worker`, started with the phase) builds the kernels into
     dir with nvcc, a second finds them there with nvcc forbidden.
  M. multi-device serving and training (ROADMAP item 16, second half) on
     the one card: `InferencePipeline(mesh=make_mesh(devices=[cuda:0,
     cuda:0]))` of the certified Lite4 -> W32 at B=16; in f32 (TF32 off)
     its rows against the dp = 1 forward of each shard's own 8 rows
     (<= 1e-4), and the registry over its mesh (`instance_group.count`
     2, an `hrnet` batch against dp = 1 within 1e-4 of the peak); in bf16
     one batch counted from 0 (exactly 2 launches of each kernel: one a
     shard) and its rows against the goldens (phase 3's rule); two
     processes over gloo on cuda:0 (`--mesh-worker`, each checking that
     it serves on the card): `MultiHostServing` of the f32 pipeline
     against this process serving the same rows (<= 1e-4), the worker
     released by the zero-row sentinel, then one sharded float64 pose
     step at dp = 2 (phase T's case, three Adam steps) against JAX's
     float64 step on the global batch (the goldens of phase T) at phase
     T's float64 tolerance; imgs/s at B=16, dp = 2 beside dp = 1 in turns (a
     record: two shards on one card claim no scaling).
  4. report: a `kernels` JSON line (launches: phases 3, A, C, Y, S, D, U,
     E, T, X and M), the card's name and power limit, and the result line
     {"ok": true, "device": {...}} last.

The phases run in the order 3, A, C, B, Y, S, D, U, E, T, X, M. A
subprocess that needs nothing of the work before it begins early and runs
beside in-process work: phase B's CLI and phase E's `cli.evaluate` before
phase C; phase X's compile-cache build and its YOLOv5m / bottom-up
artifact process before phase U; phase M's two processes before phase X;
phase D's five CLIs before phase S; the CLIs and the exit-2 server of
phases Y, S and U at their phase's start (each CLI and that server with
two CPU threads); phase T's `cli.certify_bottomup` in a process of its own beside
`cli.certify`. Each is waited for where its phase
checks it, and killed at exit if it still runs. Every log line begins with
the seconds since the script began.

Imports nothing of JAX; builds into the package's gitignored `build/`.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data", "torch_port")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12       # dense tensor-core bf16
F32_FLOP_PER_S = 67e12         # CUDA-core f32
HEAD_TOL = (1e-3, 1e-3)        # (abs, rel), kernel vs plain head-score
GOLDEN_MEAN_CM, GOLDEN_MAX_CM = 1.0, 6.0
FILE_ROUTE = "/body_proportion_length_estimation_file"
ALL_PHASES = "ABCYSDUETXM"


T_START = time.perf_counter()


def log(msg: str) -> None:
    """One line of the log, after the seconds since the script began."""
    print(f"[{time.perf_counter() - T_START:6.1f}s] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


class Started:
    """A subprocess begun now and read later: a thread drains its pipes (a
    full pipe never stalls it) and notes the seconds from its start to its
    exit. `communicate()` and `returncode` as `subprocess.Popen`'s; `wall`
    those seconds; keyword arguments become attributes. Every one begun is
    killed at exit if it still runs (`stop_all`)."""

    begun: list = []

    def __init__(self, cmd, cwd, timeout=600, merge=False, env=None,
                 **attrs):
        import threading

        self.__dict__.update(attrs)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            cmd, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT if merge else subprocess.PIPE,
            text=True, env=env)
        Started.begun.append(self)
        self._done = threading.Thread(target=self._wait, args=(timeout,),
                                      daemon=True)
        self._done.start()

    def _wait(self, timeout):
        try:
            self.out, err = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.out, err = self.proc.communicate()
        self.err = err or ""
        self.wall = time.perf_counter() - self.t0

    def communicate(self, timeout=None):
        self._done.join()
        return self.out, self.err

    @property
    def returncode(self):
        return self.proc.returncode

    @classmethod
    def stop_all(cls):
        for s in cls.begun:
            if s.proc.poll() is None:
                s.proc.kill()


# the subprocesses main() begins before an earlier phase, so that they run
# beside its in-process work: the consuming phase's name -> its Started
EARLY: dict = {}


def beside_env():
    """The environment of a CLI begun beside other work: two CPU threads."""
    return dict(os.environ, OMP_NUM_THREADS="2")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() with `iters` calls captured in one
    CUDA graph and replayed: what the card needs for the launches alone,
    with no host time between them (cuda_ms includes the host's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions


def check_decode(k, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    hm = torch.randn((48, 17, 96, 72), generator=g, device=dev)
    flat = hm.view(48 * 17, -1)
    # planted ties: the max value at two positions, the later one first
    for r in range(0, 48 * 17, 7):
        top = flat[r].max() + 1.0
        flat[r, 5000] = top
        flat[r, 123 + r] = top
    flat[1::11] = -flat[1::11].abs() - 0.1           # all-negative maps
    flat[2::13] = 0.25                               # all-equal maps
    flat[3] = float("-inf")
    # NaN maps report a NaN score and keypoint (0, 0); the rest are untouched
    flat[4::17, 1000] = float("nan")                 # one NaN in a map
    flat[5] = float("nan")                           # an all-NaN map
    flat[6, 10], flat[6, 11] = float("inf"), float("nan")
    flat[8, 20] = float("inf")                       # +inf alone: ordinary
    kp, sc = k.decode_heatmaps(hm)
    kp_p, sc_p = k.decode_heatmaps_plain(hm)
    torch.cuda.synchronize()
    n_nan = int(sc_p.isnan().sum())
    assert n_nan == len(range(4, 816, 17)) + 2, n_nan
    assert bool((kp_p[sc_p.isnan()] == 0).all())
    assert torch.equal(sc.isnan(), sc_p.isnan()), "decode: NaN maps differ"
    assert torch.equal(kp, kp_p), "decode: keypoints differ from plain"
    assert torch.equal(torch.nan_to_num(sc, nan=0.0),
                       torch.nan_to_num(sc_p, nan=0.0)), \
        "decode: scores differ from plain"
    # other sizes: one small chunk a map, a map cut into 27 chunks with a
    # short last one, and a size that takes the kernel's plain-load path
    for shape in ((5, 17, 16, 12), (2, 3, 250, 196), (3, 5, 7, 9)):
        small = torch.randn(shape, generator=g, device=dev)
        small[0, 1] = float("nan")
        small[1, 2] = -small[1, 2].abs() - 0.1
        got, ref = k.decode_heatmaps(small), k.decode_heatmaps_plain(small)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]), f"decode {shape}: keypoints"
        assert torch.equal(got[1].isnan(), ref[1].isnan()), f"decode {shape}"
        assert torch.equal(torch.nan_to_num(got[1], nan=0.0),
                           torch.nan_to_num(ref[1], nan=0.0)), \
            f"decode {shape}: scores"
    err = float((kp - kp_p).abs().max())
    ms = cuda_ms(lambda: k.decode_heatmaps(hm), 200)
    plain_ms = cuda_ms(lambda: k.decode_heatmaps_plain(hm), 20)
    lib_ms = cuda_ms(lambda: torch.max(hm.flatten(2), -1), 200)
    b_ms, b_by = bound(hm.numel() * 4 + kp.numel() * 4 + sc.numel() * 4,
                       hm.numel(), F32_FLOP_PER_S)
    g_ms = graph_ms(lambda: k.decode_heatmaps(hm), 100)
    g_lib = graph_ms(lambda: torch.max(hm.flatten(2), -1), 100)
    log(f"decode_heatmaps: {n_nan} NaN maps checked; replayed from a CUDA "
        f"graph (no host time, input L2-resident): kernel {g_ms:.4f} ms, "
        f"torch.max {g_lib:.4f} ms")
    return dict(name="decode_heatmaps", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, graph_ms=g_ms, library_graph_ms=g_lib)


def nms_inputs(dev, b=16, k=128, seed=1):
    import torch

    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((b, k, 2), generator=g) * torch.tensor([560.0, 400.0])
    wh = 20.0 + torch.rand((b, k, 2), generator=g) * 200.0
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.sort(torch.rand((b, k), generator=g), -1,
                        descending=True).values
    scores[:, -9:] = 0.0                             # dead padding rows
    # an exactly-at-threshold pair: IoU(0, 1) == 0.5 -> both kept at 0.5
    boxes[0, 0] = torch.tensor([0.0, 0.0, 100.0, 100.0])
    boxes[0, 1] = torch.tensor([0.0, 0.0, 100.0, 50.0])
    # a pair at IoU ~= 0.3 where `inter / union > t` and `inter > t * union`
    # round apart in f32: the kernel must follow the division form
    ha = torch.rand(4096, generator=g) * 380.0 + 20.0
    w = torch.rand(4096, generator=g) * 380.0 + 20.0
    hb = ha * 0.3
    inter = w * hb
    union = (w * ha + inter) - inter
    split = ((inter / union) > 0.3) != (inter > 0.3 * union)
    i = int(torch.nonzero(split)[0])
    boxes[1, 0] = torch.tensor([0.0, 0.0, float(w[i]), float(ha[i])])
    boxes[1, 1] = torch.tensor([0.0, 0.0, float(w[i]), float(hb[i])])
    return boxes.to(dev).contiguous(), scores.to(dev).contiguous()


def load_nms_cases():
    """The cases of tests/torch_port_nms_cases.py, the inputs the CPU tests
    share with this script, loaded from the file beside this one."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_nms_cases",
        os.path.join(REPO, "tests", "torch_port_nms_cases.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.nms_cases()


def ladder_boxes(dev, b, k):
    """Every box overlaps only its two neighbours, so the kept boxes
    alternate and each decision hangs on the one before it: the longest
    chain a sweep can meet."""
    import torch

    step = 25.0 * torch.arange(k, device=dev)
    return torch.stack([step, 0 * step, step + 100.0, 0 * step + 100.0],
                       -1).expand(b, k, 4).contiguous()


def check_nms(k, dev):
    import torch

    boxes, scores = nms_inputs(dev)
    boxes512, scores512 = nms_inputs(dev, k=512, seed=2)
    ladder512 = ladder_boxes(dev, 16, 512)
    one = (lambda x: x[3:4].contiguous())
    checks = [("[16,128]", boxes, scores, t, False) for t in (0.5, 0.3)]
    checks += [
        ("[16,512]", boxes512, scores512, 0.5, False),
        ("[1,512]", one(boxes512), one(scores512), 0.5, False),
        ("[16,512] ladder", ladder512, scores512, 0.5, False),
        ("+1 [1,512]", one(boxes512), one(scores512), 0.5, True),
        ("+1 [16,128]", boxes, scores, 0.5, True),
        ("+1 [16,128] t=0.3", boxes, scores, 0.3, True),
        ("+1 [16,512] ladder", ladder512, scores512, 0.4, True),
    ]
    # the shared cases, with both IoU forms
    for name, c_boxes, c_scores, t, expected in load_nms_cases():
        c_boxes = torch.from_numpy(c_boxes).to(dev)
        c_scores = torch.from_numpy(c_scores).to(dev)
        if expected is not None:
            ref = k.nms_sweep_plain(c_boxes, c_scores, t)
            assert ref.cpu().numpy().tolist() == expected.tolist(), \
                f"nms case {name}: the plain version misses the stated mask"
        for plus1 in (False, True):
            checks.append((("+1 " if plus1 else "") + name, c_boxes,
                           c_scores, t, plus1))
    # every check runs before any failure is raised, and a mask that
    # differs is printed beside the plain version's
    failed, n_kept = [], 0
    for name, c_boxes, c_scores, t, plus1 in checks:
        got = k.nms_sweep(c_boxes, c_scores, t, plus1=plus1)
        ref = k.nms_sweep_plain(c_boxes, c_scores, t, plus1=plus1)
        torch.cuda.synchronize()
        n_kept += int(ref.sum())
        if not torch.equal(got, ref):
            failed.append(name)
            img = int(torch.nonzero((got != ref).any(-1))[0])
            at = torch.nonzero(got[img] != ref[img]).flatten().tolist()
            log(f"nms {name!r} at t = {t}: kernel differs from plain in "
                f"{int((got != ref).sum())} places; image {img}, boxes "
                f"{at[:16]}")
            if c_boxes.shape[1] <= 8:
                log(f"  boxes  {c_boxes[img].tolist()}")
                log(f"  kernel {got[img].tolist()}")
                log(f"  plain  {ref[img].tolist()}")
    assert not failed, f"nms: keep differs from plain in {failed}"
    for keep in (k.nms_sweep(boxes, scores, 0.5),
                 k.nms_sweep(boxes512, scores512, 0.5, plus1=True)):
        assert bool(keep.any()) and not bool(keep.all())
    try:
        k.nms_sweep(torch.zeros((1, 513, 4), device=dev),
                    torch.zeros((1, 513), device=dev), 0.5)
    except ValueError:
        pass
    else:
        raise AssertionError("nms_sweep took K = 513")
    log(f"nms_sweep: {len(checks)} keep masks ({n_kept} boxes kept) exact "
        "against plain, K = 1..512, both IoU forms; K = 513 refused")

    def sweep16():
        k.nms_sweep(boxes, scores, 0.5)

    ms = cuda_ms(sweep16, 200)
    plain_ms = cuda_ms(lambda: k.nms_sweep_plain(boxes, scores, 0.5), 3, 1)
    b, kk = scores.shape
    # a keep mask reads only the pairs j < i: K (K - 1) / 2 IoUs an image,
    # 14 operations each
    b_ms, b_by = bound(boxes.numel() * 4 + scores.numel() * 4 + b * kk,
                       14.0 * b * kk * (kk - 1) / 2, F32_FLOP_PER_S)
    b512, _ = bound(512 * 4 * 4 + 512 * 4 + 512, 14.0 * 512 * 511 / 2,
                    F32_FLOP_PER_S)
    g_ms = graph_ms(sweep16, 100)
    times = {"[16,128]": g_ms}
    for name, args in (
            ("[1,128]", (one(boxes), one(scores), 0.5)),
            ("[1,512]", (one(boxes512), one(scores512), 0.5)),
            ("[1,512] +1", (one(boxes512), one(scores512), 0.5, True)),
            ("[1,512] ladder", (ladder512[:1], one(scores512), 0.5)),
            ("[16,512]", (boxes512, scores512, 0.5))):
        times[name] = graph_ms(lambda args=args: k.nms_sweep(*args), 100)
    blocks, threads = k.nms_launch_shape()
    times["empty kernel, launch shape of 16 images"] = graph_ms(
        lambda: k.empty_launch(16 * blocks, threads), 100)
    times["empty kernel, launch shape of 1 image"] = graph_ms(
        lambda: k.empty_launch(blocks, threads), 100)
    log(f"nms_sweep [16,128]: eager {ms:.4f} ms; graph replay (ms): "
        + ", ".join(f"{n} {v:.4f}" for n, v in times.items())
        + f"; bound [16,128] {b_ms:.7f} ms, [1,512] {b512:.7f} ms")
    return dict(name="nms_sweep", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=g_ms, library_graph_ms=None)


def head_score_agrees(got, ref, what):
    """(best, person) of the kernel against the plain version: HEAD_TOL on
    both, person never above best, and as many person-argmax anchors.
    Returns (max |err|, person-argmax anchors)."""
    (best, person), (best_p, person_p) = got, ref
    err = 0.0
    for g, r in ((best, best_p), (person, person_p)):
        assert g.shape == r.shape, f"{what}: {g.shape} vs {r.shape}"
        d = (g - r).abs()
        err = max(err, float(d.max()))
        assert bool((d <= HEAD_TOL[0] + HEAD_TOL[1] * r.abs()).all()), \
            f"{what}: max |err| {float(d.max())}"
    # person is read back from a value the max ran over: never above
    # best, and equal to it wherever the person class won
    assert bool((person <= best).all()), f"{what}: person > best"
    n_plain = int((person_p >= best_p).sum())
    n_kernel = int((person == best).sum())
    assert abs(n_kernel - n_plain) <= max(1, n_plain // 1000), \
        f"{what}: person-argmax anchors {n_kernel} vs {n_plain}"
    return err, n_kernel


def check_head_score(k, dev, det_state):
    import torch

    a, c, f = 9, 90, 224
    w = det_state["class_net.predict_pw.weight"].reshape(a * c, f)
    w = w.to(dev, torch.bfloat16).contiguous()
    bias = det_state["class_net.predict_pw.bias"].to(dev).float()
    g = torch.Generator(device=dev).manual_seed(2)
    levels = [(60, 80), (30, 40), (15, 20), (8, 10), (4, 5)]
    zs = [torch.randn((16, h, ww, f), generator=g, device=dev).to(
        torch.bfloat16) for h, ww in levels]
    # B = 1 as infer_bytes runs it: level 5 is a ragged 20-row tile
    zs1 = [z[3:4].contiguous() for z in zs]
    err, n_person = 0.0, 0
    for name, batch in (("B=16", zs), ("B=1", zs1)):
        # the grouped entry point: one launch, final [B, N] buffers
        e, n = head_score_agrees(
            k.head_score_levels(batch, w, bias, a, c, 0),
            k.head_score_levels_plain(batch, w, bias, a, c, 0),
            f"head_score_levels {name}")
        err, n_person = max(err, e), n_person + n
        # the one-level wrapper over the same kernel
        for z in batch:
            e, _ = head_score_agrees(
                k.head_score(z, w, bias, a, c, 0),
                k.head_score_plain(z, w, bias, a, c, 0),
                f"head_score {name} {tuple(z.shape)}")
            err = max(err, e)
    # another person class: the pack moves it to the column the kernel reads
    e, _ = head_score_agrees(
        k.head_score_levels(zs1, w, bias, a, c, 37),
        k.head_score_levels_plain(zs1, w, bias, a, c, 37),
        "head_score_levels B=1, person class 37")
    err = max(err, e)
    torch.cuda.synchronize()

    def run_library():
        for z in zs:
            torch.matmul(z, w.t()).view(*z.shape[:3], a, c).amax(-1)

    ms = cuda_ms(lambda: k.head_score_levels(zs, w, bias, a, c, 0), 50)
    ms_b1 = cuda_ms(lambda: k.head_score_levels(zs1, w, bias, a, c, 0), 50)
    plain_ms = cuda_ms(
        lambda: k.head_score_levels_plain(zs, w, bias, a, c, 0), 10)
    lib_ms = cuda_ms(run_library, 50)
    m = sum(z.shape[0] * z.shape[1] * z.shape[2] for z in zs)
    nbytes = m * f * 2 + w.numel() * 2 + bias.numel() * 4 + 2 * m * a * 4
    flop = 2.0 * m * f * a * c
    b_ms, b_by = bound(nbytes, flop, BF16_FLOP_PER_S)
    # what the card's tensor cores sustain in a library product too large
    # to be bound by anything else: the practical ceiling beside the peak
    big = torch.randn((8192, 8192), generator=g, device=dev).to(
        torch.bfloat16)
    big_ms = graph_ms(lambda: torch.matmul(big, big), 5)
    log(f"tensor-core yardstick: torch.matmul 8192^3 bf16 {big_ms:.4f} ms "
        f"({2 * 8192**3 / big_ms / 1e9:.1f} TFLOP/s)")
    g_ms = graph_ms(lambda: k.head_score_levels(zs, w, bias, a, c, 0), 20)
    g_b1 = graph_ms(lambda: k.head_score_levels(zs1, w, bias, a, c, 0), 20)
    g_lib = graph_ms(run_library, 20)
    log(f"head_score: {n_person} person-argmax anchors checked; one launch "
        f"for the five levels: B=16 {ms:.4f} ms "
        f"({flop / ms / 1e9:.1f} TFLOP/s), B=1 {ms_b1:.4f} ms; replayed "
        f"from a CUDA graph (no host time): B=16 {g_ms:.4f} ms "
        f"({flop / g_ms / 1e9:.1f} TFLOP/s), B=1 {g_b1:.4f} ms, "
        f"matmul+amax {g_lib:.4f} ms")
    return dict(name="head_score", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, graph_ms=g_ms, library_graph_ms=g_lib)


def time_kernels(k, dev, det_state, only=""):
    """Times only, no checks, through entry points every version of the
    port has: the decode kernel at [48,17,96,72] beside torch.max, the
    head-score kernel on the five pyramid levels at B=16, level by level
    (`head_score`) and, where the version has it, grouped
    (`head_score_levels`), and the NMS sweep at [16,128] and [1,128]
    (and on a ladder of boxes, the longest chain of decisions a sweep can
    meet) beside, where the version has it, a kernel that does nothing in
    the launch shapes of the NMS kernel and of its first version. Each
    both launched eagerly back to back (host time included) and replayed
    from a CUDA graph (the card alone). `only` keeps the cases whose name
    contains it."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    hm = torch.randn((48, 17, 96, 72), generator=g, device=dev)
    # four inputs taken in turns (90 MB) never find their maps in the 50 MB
    # L2; the same input again (22.6 MB) always does, as the pipeline's
    # decode does right after the pose model wrote its heatmaps
    hm_cold = [torch.randn((48, 17, 96, 72), generator=g, device=dev)
               for _ in range(4)]
    a, c, f = 9, 90, 224
    w = det_state["class_net.predict_pw.weight"].reshape(a * c, f)
    w = w.to(dev, torch.bfloat16).contiguous()
    bias = det_state["class_net.predict_pw.bias"].to(dev).float()
    zs = [torch.randn((16, h, ww, f), generator=g, device=dev).to(
        torch.bfloat16) for h, ww in
        [(60, 80), (30, 40), (15, 20), (8, 10), (4, 5)]]

    def decode_cold():
        for x in hm_cold:
            k.decode_heatmaps(x)

    def max_cold():
        for x in hm_cold:
            torch.max(x.flatten(2), -1)

    def per_level():
        for z in zs:
            k.head_score(z, w, bias, a, c, 0)

    def library():
        for z in zs:
            torch.matmul(z, w.t()).view(*z.shape[:3], a, c).amax(-1)

    cases = [
        ("decode_heatmaps", lambda: k.decode_heatmaps(hm), 200),
        ("torch.max", lambda: torch.max(hm.flatten(2), -1), 200),
        ("decode_heatmaps x4 inputs, L2 cold", decode_cold, 50),
        ("torch.max x4 inputs, L2 cold", max_cold, 50),
        ("head_score x5 levels", per_level, 50),
        ("matmul+amax x5 levels", library, 50),
    ]
    if hasattr(k, "head_score_levels"):
        cases.append(("head_score_levels", lambda: k.head_score_levels(
            zs, w, bias, a, c, 0), 50))
    boxes, scores = nms_inputs(dev)
    boxes1, scores1 = boxes[3:4].contiguous(), scores[3:4].contiguous()
    ladder = ladder_boxes(dev, 16, 128)
    cases += [
        ("nms_sweep [16,128]", lambda: k.nms_sweep(boxes, scores, 0.5), 200),
        ("nms_sweep [1,128]", lambda: k.nms_sweep(boxes1, scores1, 0.5), 200),
        ("nms_sweep [16,128] ladder",
         lambda: k.nms_sweep(ladder, scores, 0.5), 200),
    ]
    if hasattr(k, "nms_launch_shape"):
        nms_blocks, nms_threads = k.nms_launch_shape()
        # the launch shapes of this NMS kernel (a cluster of thread blocks of
        # 1024 threads an image) and of its first version (128 threads)
        cases += [
            (f"empty kernel for nms_sweep, {blocks} x {threads} threads",
             lambda blocks=blocks, threads=threads: k.empty_launch(
                 blocks, threads), 200)
            for blocks, threads in (
                (16 * nms_blocks, nms_threads), (16, 128),
                (nms_blocks, nms_threads), (1, 128))]
    for name, fn, iters in cases:
        if only not in name:
            continue
        log(f"time {name}: eager {cuda_ms(fn, iters):.4f} ms, graph replay "
            f"{graph_ms(fn, min(iters, 50)):.4f} ms")


# --------------------------------------------------------------------- #
# phase 3: the main path


def profile_serving(pipe, images, height, thres, iters=3,
                    out_name="port_profile_b16.txt"):
    """torch.profiler over `iters` infer_serving batches: per-stage host and
    device time, device busy share, kernel table to chiprun_out/<out_name>.
    Returns (wall ms, device busy ms, {stage: {host_ms, device_ms}}), each
    a batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            pipe.infer_serving(images, height, thres)
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # device time of a host op counts the kernels of its whole subtree, so
    # the top-level ops add up to the device busy time without overlap
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    device_ms = sum(e.device_time_total for e in cpu
                    if e.cpu_parent is None) / 1e3 / iters
    stages = {}
    for e in cpu:
        if e.name.startswith("hbpe."):
            v = stages.setdefault(e.name, dict(host_ms=0.0, device_ms=0.0))
            v["host_ms"] += e.cpu_time_total / 1e3 / iters
            v["device_ms"] += e.device_time_total / 1e3 / iters
    log(f"profile B={len(images)} (under the profiler): wall "
        f"{wall_ms:.2f} ms/batch, device busy {device_ms:.2f} ms/batch "
        f"({100 * device_ms / wall_ms:.1f}% busy)")
    for name, v in sorted(stages.items()):
        log(f"  {name}: host {v['host_ms']:.2f} ms, device busy "
            f"{v['device_ms']:.2f} ms")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", out_name), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=60))
    return wall_ms, device_ms, stages


def run_main_path(k, dev, profile=False):
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
        decode_image_bytes,
    )

    with open(os.path.join(DATA, "goldens.json")) as fh:
        golden = json.load(fh)
    scene_bytes = []
    for name in golden["scenes"]:
        with open(os.path.join(DATA, name), "rb") as fh:
            scene_bytes.append(fh.read())
    height, thres = golden["person_height_cm"], golden["det_threshold"]

    # the committed certified checkpoint, loaded by the pipeline itself (so
    # that /health labels it as the JAX server does)
    pipe = InferencePipeline(device=dev, detector="efficientdet_lite4")
    images = [decode_image_bytes(bts) for bts in scene_bytes]
    batch16 = [images[i % len(images)] for i in range(16)]

    k.reset_launch_counts()
    responses = [pipe.infer_bytes(bts, height, thres) for bts in scene_bytes]
    packed = pipe.infer_serving(batch16, person_heights=height,
                                det_threshold=thres)
    launches = k.launch_counts()
    log(f"main path launches: {launches}")
    for i, r in enumerate(responses):
        log(f"infer_bytes scene {i}: {json.dumps(r)}")
        assert r["code"] == "success", r
        assert r["body_proportion_lengths_(cm)"], f"scene {i}: no person"
    # 3 infer_bytes + 1 infer_serving = 4 forwards, one launch of each
    # kernel a forward (the head-score kernel serves all five levels)
    assert launches == {"decode_heatmaps": 4, "head_score": 4,
                        "nms_sweep": 4}, launches
    assert packed.shape == (16, 3, 23) and np.isfinite(packed).all()

    # against the JAX goldens
    ref = np.asarray(golden["packed"], np.float32)
    got = packed[: len(images)]
    assert np.array_equal(got[..., 0] > 0.5, ref[..., 0] > 0.5), \
        f"person_valid differs: {got[..., 0]} vs {ref[..., 0]}"
    vis_got, vis_ref = got[..., 12:] > 0.5, ref[..., 12:] > 0.5
    both = vis_got & vis_ref
    d = np.abs(got[..., 1:12] - ref[..., 1:12])[both]
    golden_cmp = dict(
        segments_both=int(both.sum()),
        visibility_mismatch=int((vis_got != vis_ref).sum()),
        max_abs_cm=float(d.max()), mean_abs_cm=float(d.mean()),
    )
    log(f"vs JAX goldens: {json.dumps(golden_cmp)}")
    assert both.sum() > 0
    assert d.mean() <= GOLDEN_MEAN_CM and d.max() <= GOLDEN_MAX_CM, golden_cmp
    # every row of the batch repeats a scene: rows must equal their scene
    for i in range(16):
        np.testing.assert_array_equal(packed[i], packed[i % len(images)])

    # serving throughput at B=16 (host prepare + upload + forward + readback)
    for _ in range(2):
        pipe.infer_serving(batch16, height, thres)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe.infer_serving(batch16, height, thres)
    dt = time.perf_counter() - t0
    log(f"infer_serving B=16: {16 * iters / dt:.2f} imgs/s "
        f"({dt / iters * 1e3:.2f} ms per batch, {iters} batches)")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    if profile:
        profile_serving(pipe, batch16, height, thres)
    return launches, pipe, golden, scene_bytes


# --------------------------------------------------------------------- #
# phases A and B: the serving edge and the CLI


def check_answer(cm, golden, scene, height, what, nth=0):
    """One person's `body_proportion_lengths_(cm)` dict against the `nth`
    valid person of its scene's golden (the first, which the server
    answers, by default) scaled by height / 175: the same visible
    segments, and max |dcm| <= 6.0. Returns the |dcm| list, whose mean
    `check_mean` holds to 1.0 over a group of answers, as phase 3 does
    over its 3 scenes (one answer's 11 segments alone are too few: bf16
    rounding that differs between batch sizes moves a single scene's
    mean by ~1 cm)."""
    import numpy as np

    from human_body_proportion_estimation_tpu_torch.ops.proportions import (
        SEGMENT_NAMES,
    )

    ref = np.asarray(golden["packed"], np.float32)[scene]
    slots = np.flatnonzero(ref[:, 0] > 0.5)
    assert len(slots) > nth, f"{what}: the golden has no such person"
    slot = int(slots[nth])
    scale = height / golden["person_height_cm"]
    assert list(cm) == SEGMENT_NAMES, f"{what}: {cm}"
    vis_got = [not isinstance(cm[n], str) for n in SEGMENT_NAMES]
    vis_ref = (ref[slot, 12:23] > 0.5).tolist()
    assert vis_got == vis_ref, f"{what}: visibility {vis_got} vs {vis_ref}"
    d = [abs(cm[n] - float(ref[slot, 1 + i]) * scale)
         for i, n in enumerate(SEGMENT_NAMES) if vis_ref[i]]
    assert d and max(d) <= GOLDEN_MAX_CM, f"{what}: |dcm| {d}"
    return d


def check_mean(d_all, what):
    """Phase 3's mean rule over a group of answers; returns (mean, max)."""
    mean = sum(d_all) / len(d_all)
    assert mean <= GOLDEN_MEAN_CM, f"{what}: mean |dcm| {mean}"
    return mean, max(d_all)


def multipart(fields):
    import uuid

    boundary = uuid.uuid4().hex
    body = b""
    for name, value in fields.items():
        data, filename = value if isinstance(value, tuple) else (
            str(value).encode(), None)
        disp = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        body += (f"--{boundary}\r\n{disp}\r\n\r\n".encode() + data
                 + b"\r\n")
    body += f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def http_request(port, method, path, fields=None):
    """(status, body bytes); `fields` become a multipart form."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    body, ctype = multipart(fields) if fields else (None, None)
    conn.request(method, path, body=body,
                 headers={"Content-Type": ctype} if ctype else {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def http_json(port, method, path, fields=None):
    status, data = http_request(port, method, path, fields)
    assert status == 200, (path, status, data[:200])
    return json.loads(data)


def mjpg_clip(scene_bytes, n_frames=12):
    """The scenes in turn as an MJPG clip (cv2.VideoWriter), as bytes."""
    import tempfile

    import cv2
    import numpy as np

    frames = [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
              for b in scene_bytes]
    h, w = frames[0].shape[:2]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5.0,
                                 (w, h))
        assert writer.isOpened(), "cv2 cannot write MJPG"
        for i in range(n_frames):
            writer.write(frames[i % len(frames)])
        writer.release()
        with open(path, "rb") as fh:
            return fh.read()


@contextlib.contextmanager
def served(app):
    """`app` behind `create_server` on 127.0.0.1:0 in a thread: yields the
    port; shuts server, batcher and thread down on the way out."""
    import threading

    from human_body_proportion_estimation_tpu_torch.serve.server import (
        create_server,
    )

    server = create_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        app.shutdown()
        thread.join(timeout=10)


def post_load(port, scene_bytes, heights, thres, clients):
    """One file-route request per height (scene i % 3 for the i-th), sent
    from `clients` threads: (answers in request order, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        return http_json(port, "POST", FILE_ROUTE, {
            "file": (scene_bytes[i % len(scene_bytes)], "scene.png"),
            "person_height_in_cm": heights[i], "threshold": thres})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        answers = list(pool.map(one, range(len(heights))))
    return answers, time.perf_counter() - t0


def load_summary(m0, m1, wall, requests):
    """The figures of one load from /metrics before (m0) and after (m1)."""
    batches = m1["batches_total"] - m0["batches_total"]
    return dict(
        requests=requests, wall_s=wall, requests_per_s=requests / wall,
        batches=batches, mean_batch_size_of_the_load=requests / batches,
        metrics_mean_batch_size=m1["mean_batch_size"],
        latency_ms_p50=m1["latency_ms_p50"],
        latency_ms_p95=m1["latency_ms_p95"],
        queue_wait_ms_p95=m1["queue_wait_ms_p95"],
        stages_mean_ms={key: v["mean_ms"]
                        for key, v in m1["stages"].items()
                        if "mean_ms" in v},   # not the row counters
    )


def run_serving_edge(k, pipe, golden, scene_bytes):
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        prewarm_serving,
    )
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )

    height, thres = golden["person_height_cm"], golden["det_threshold"]
    n_scenes = len(scene_bytes)
    warmed = prewarm_serving(pipe)
    assert warmed == [1, 2, 4, 8, 16], warmed
    with served(ServingApp(pipe)) as port:
        m0 = http_json(port, "GET", "/metrics")
        assert m0["engine"] == "native", m0
        d_all = []
        for i, bts in enumerate(scene_bytes):
            r = http_json(port, "POST", FILE_ROUTE, {
                "file": (bts, f"scene_{i}.png"),
                "person_height_in_cm": int(height), "threshold": thres})
            assert r["code"] == "success", r
            d_all += check_answer(r["body_proportion_lengths_(cm)"], golden,
                                  i, height, f"single scene {i}")
        log("serving edge: 3 single requests agree with the goldens, mean "
            "|dcm| %.4f, max %.4f" % check_mean(d_all, "single requests"))

        # 48 requests from 16 client threads, each with its own height
        heights = [150 + i for i in range(48)]
        m1 = http_json(port, "GET", "/metrics")
        k.reset_launch_counts()
        answers, wall = post_load(port, scene_bytes, heights, thres, 16)
        launches = k.launch_counts()
        m2 = http_json(port, "GET", "/metrics")
        d_all = []
        for i, r in enumerate(answers):
            assert r["code"] == "success", r
            d_all += check_answer(r["body_proportion_lengths_(cm)"], golden,
                                  i % n_scenes, heights[i],
                                  f"concurrent request {i}")
        edge = load_summary(m1, m2, wall, 48)
        assert m2["requests_total"] - m1["requests_total"] == 48, m2
        assert m2["failures_total"] == 0, m2
        assert m2["mean_batch_size"] > 1, m2
        assert edge["mean_batch_size_of_the_load"] > 1, edge
        assert launches == {name: edge["batches"] for name in launches}, \
            (launches, edge["batches"])
        for key in ("request_decode", "host_prepare", "device_upload",
                    "device_compute_readback"):
            assert m2["stages"][key]["count"] >= 1, (key, m2["stages"])
        edge.update(client_threads=16, launches=launches)
        edge["golden_mean_abs_cm"], edge["golden_max_abs_cm"] = check_mean(
            d_all, "48 concurrent requests")
        log(f"serving edge (native engine, 2 batches in flight): "
            f"{json.dumps(edge)}")
        log(f"serving edge card: {card_line()}")

        health = http_json(port, "GET", "/health")
        log(f"/health: {json.dumps(health)}")
        assert "H100" in health["devices"][0], health
        assert health["weights"] == {"detector": "synthetic-certified",
                                     "pose": "synthetic-certified"}, health
        assert health["prewarmed"] is True, health
        assert health["hbm_bytes_in_use"] and health["hbm_bytes_limit"], \
            health

        # video: the aggregate route and the NDJSON stream, stride 2
        clip = mjpg_clip(scene_bytes)
        form = {"file": (clip, "clip.avi"), "frame_stride": 2,
                "person_height_in_cm": int(height), "threshold": thres}
        video = http_json(port, "POST",
                          "/body_proportion_length_estimation_video", form)
        assert video["code"] == "success", video
        assert [f["frame"] for f in video["frames"]] == list(range(0, 12, 2))
        status, raw = http_request(
            port, "POST", "/body_proportion_length_estimation_video_stream",
            form)
        assert status == 200, raw[:200]
        lines = [json.loads(x) for x in raw.splitlines()]
        header, frames, summary = lines[0], lines[1:-1], lines[-1]
        assert header == {"code": "success", "fps": video["fps"],
                          "frame_stride": 2}, header
        assert [f["frame"] for f in frames] == list(range(0, 12, 2))
        assert summary["code"] == "success" and "frames" not in summary
        assert summary["num_frames_processed"] == 6, summary
        d_all = []
        for f in video["frames"] + frames:
            d_all += check_answer(f["body_proportion_lengths_(cm)"], golden,
                                  f["frame"] % n_scenes, height,
                                  f"video frame {f['frame']}")
        log("video routes: frames 0..10 step 2 in order on both; against "
            "the goldens mean |dcm| %.4f, max %.4f (MJPG frames)"
            % check_mean(d_all, "video frames"))
    return edge


def edge_sweep(pipe, golden, scene_bytes):
    """--edge-sweep: phase A's load of 48 requests again under other
    settings, each on a fresh `ServingApp` (so /metrics covers that load
    alone): the native core with 2 or 1 batches in flight, the Python
    batcher (one batch at a time), and 16, 4 or 1 client threads. The
    first setting comes again last, to show the drift inside the call."""
    import dataclasses

    from human_body_proportion_estimation_tpu_torch.serve.native import (
        NativeBatcher,
    )
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )

    serve_cfg = pipe.config.serve
    heights = [150 + i for i in range(48)]
    for engine, depth, clients in (
            ("native", 2, 16), ("native", 1, 16), ("python", 1, 16),
            ("native", 2, 4), ("native", 2, 1), ("native", 1, 1),
            ("native", 2, 16)):
        app = ServingApp(pipe, dataclasses.replace(
            pipe.config, serve=dataclasses.replace(
                serve_cfg, native_batcher=engine == "native")))
        if app.native and depth != 2:
            app.batcher.shutdown()
            app.batcher = NativeBatcher(
                app._run_batch, max_batch=serve_cfg.max_batch,
                batch_timeout_ms=serve_cfg.batch_timeout_ms,
                queue_depth=serve_cfg.queue_depth, pipeline_depth=depth)
        with served(app) as port:
            m0 = http_json(port, "GET", "/metrics")
            answers, wall = post_load(port, scene_bytes, heights,
                                      golden["det_threshold"], clients)
            m1 = http_json(port, "GET", "/metrics")
        assert all(r["code"] == "success" for r in answers)
        row = dict(engine=engine, batches_in_flight=depth,
                   client_threads=clients,
                   **load_summary(m0, m1, wall, len(heights)))
        log(f"edge sweep: {json.dumps(row)}")


def start_cli(golden, repo):
    """Phase B's CLI begun in a subprocess on a directory of the scenes."""
    import shutil
    import tempfile

    height, thres = golden["person_height_cm"], golden["det_threshold"]
    tmp = tempfile.mkdtemp(prefix="phase_b_")
    media, out = os.path.join(tmp, "media"), os.path.join(tmp, "out")
    os.makedirs(media)
    for name in golden["scenes"]:
        shutil.copy(os.path.join(DATA, name), media)
    return Started(
        [sys.executable, "-m",
         "human_body_proportion_estimation_tpu_torch.cli.detect_pose",
         "-i", media, "-o", out, "-t", str(thres), "-p", str(height)],
        repo, env=beside_env(), tmp=tmp, out_dir=out)


def run_cli(golden, repo):
    """The CLI in a subprocess on a directory of the scenes (begun by
    main() before phase C, or here)."""
    import ast
    import re
    import shutil

    import numpy as np

    height = golden["person_height_cm"]
    proc = EARLY.pop("B", None) or start_cli(golden, repo)
    proc.communicate()
    wall = proc.wall
    assert proc.returncode == 0, proc.err[-4000:]
    saved = sorted(os.listdir(os.path.join(proc.out_dir, "tpu_pdet_pose")))
    shutil.rmtree(proc.tmp, ignore_errors=True)
    frames = [f for f in saved if f.startswith("frame_")]
    assert len(frames) == 3, saved
    dicts = [ast.literal_eval(m) for m in
             re.findall(r"\{'[^{}]*\}", proc.out)]
    valid = np.asarray(golden["packed"])[..., 0] > 0.5
    # the printed list holds, image after image, one dict per valid slot
    persons = [(s, nth) for s in range(valid.shape[0])
               for nth in range(int(valid[s].sum()))]
    assert len(dicts) == len(persons), (len(dicts), valid)
    d_all = []
    for cm, (scene, nth) in zip(dicts, persons):
        d_all += check_answer(cm, golden, scene, height,
                              f"cli scene {scene} person {nth}", nth)
    log(f"cli: exit 0 in {wall:.1f} s, {len(saved)} files ({frames}), "
        f"{len(dicts)} persons printed, against the goldens: mean |dcm| "
        "%.4f, max %.4f" % check_mean(d_all, "cli"))


# --------------------------------------------------------------------- #
# phase C: the model registry and the wire protocols


REGISTRY_MODELS = ["edetlite4", "edetlite4_modified",
                   "ensemble_edet4_person_det_pose", "higherhrnet", "hrnet",
                   "ssd_mobilenet", "yolov5m", "yolov5s"]
# the models no weights of which are in the repository
RANDOM_MODELS = ["higherhrnet", "yolov5m", "yolov5s"]
# the models whose weights come from a file absent from this checkout (the
# reference's ssd.tflite): registered, labelled "real", their load fails
# naming the file
ABSENT_FILE_MODELS = ["ssd_mobilenet"]
ENSEMBLE = "ensemble_edet4_person_det_pose"
KERNELS = ("decode_heatmaps", "head_score", "nms_sweep")


def grpc_modules():
    """(missing module name or None): whether this machine has what the
    gRPC edge needs."""
    import importlib

    for name in ("grpc", "google.protobuf"):
        try:
            importlib.import_module(name)
        except ImportError:
            return name
    return None


class Counted:
    """Launch counts of the kernels over the windows it is entered, each
    window set to 0 just before and read just after; `last` is the
    window's own counts, `total` the sum over all windows."""

    def __init__(self, k):
        self.k, self.total, self.last = k, dict.fromkeys(KERNELS, 0), None

    def __enter__(self):
        self.k.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.last = self.k.launch_counts()
        for name, n in self.last.items():
            self.total[name] += n
        return False


@contextlib.contextmanager
def recording_nms(k):
    """Every (boxes, scores, threshold, keep) the NMS sweep kernel gets and
    gives while inside, so that its keep masks can be held against the
    plain version on the same candidates afterwards."""
    seen, launch = [], k.nms_sweep

    def record(boxes, scores, t, plus1=False):
        keep = launch(boxes, scores, t, plus1=plus1)
        seen.append((boxes.clone(), scores.clone(), t, keep.clone(), plus1))
        return keep

    k.nms_sweep = record
    try:
        yield seen
    finally:
        k.nms_sweep = launch


def ensemble_cm(k, boxes_norm, heatmaps, image_hw, height, cfg):
    """The reference client's use of the ensemble's outputs
    (person_det_pose_edet4_trtserver.py:131-171): decode the heatmaps (the
    port's decode kernel), gate, map the keypoints into the box in image
    pixels, px -> cm by the box height, 11 segments. One cm dict a
    person."""
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.ops import (
        heatmap as hm_ops,
        proportions as prop_ops,
    )

    n = boxes_norm.shape[0]
    hm = torch.from_numpy(np.array(heatmaps[:n])).cuda()
    kp, scores = k.decode_heatmaps(hm)
    h, w = image_hw
    boxes = torch.from_numpy(np.array(boxes_norm)).cuda()[None] * torch.tensor(
        [h, w, h, w], dtype=torch.float32, device="cuda")
    visible = hm_ops.gate_keypoints(scores[None], cfg.pose.keypoint_thresholds)
    kp_img = hm_ops.remap_to_image(kp[None], boxes, tuple(hm.shape[-2:]))
    bt = torch.trunc(boxes)
    to_cm = height / (bt[..., 2] - bt[..., 0]).clamp_min(1.0)
    seg = prop_ops.segment_lengths(kp_img, visible, to_cm)
    lengths = torch.where(seg.visible, seg.lengths_cm, 0.0)[0].cpu().numpy()
    vis = seg.visible[0].cpu().numpy()
    return [prop_ops.to_dist_dict(lengths[i], vis[i]) for i in range(n)]


def hrnet_load(send, requests, clients):
    """`send(x)` for every request from `clients` threads: (outputs in
    request order, per-request seconds, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(x):
        t0 = time.perf_counter()
        out = send(x)
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        got = list(pool.map(one, requests))
    return [g[0] for g in got], [g[1] for g in got], time.perf_counter() - t0


def pct(values, q):
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q / 100 * (len(s) - 1))))]


def run_registry_and_wire(k, pipe, golden, scene_bytes):
    """Phase C: the port's model registry behind the HTTP /v2 routes and,
    where grpc and protobuf import, the hbpe and KServe gRPC services, all
    on the serving pipeline of phase 3 on the card. Returns the launches
    of the path's requests (comparisons excluded)."""
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        _pad_batch,
        decode_image_bytes,
    )
    from human_body_proportion_estimation_tpu_torch.serve.client import (
        HttpClient,
    )
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )

    cfg = pipe.config
    height, thres = golden["person_height_cm"], golden["det_threshold"]
    missing = grpc_modules()
    if missing:
        log(f"phase C: no module named '{missing}' on this machine: the gRPC "
            "edge is not driven, the HTTP /v2 routes are")
    counted = Counted(k)
    images = [decode_image_bytes(b)[None] for b in scene_bytes]
    det_hw = (cfg.detector.input_height, cfg.detector.input_width)
    xy_change = np.array([cfg.x_expand, 0.0], np.float32)
    figures = {}
    app = ServingApp(pipe)
    grpc_server = None
    with served(app) as port:
        http = HttpClient("127.0.0.1", port)
        clients = {"http": http.infer}
        if not missing:
            from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (  # noqa: E501
                GrpcClient,
                create_grpc_server,
            )
            from human_body_proportion_estimation_tpu_torch.serve.kserve_grpc import (  # noqa: E501
                KServeClient,
            )

            grpc_server, gport = create_grpc_server(app, "127.0.0.1", 0)
            grpc_server.start()
            hbpe = GrpcClient(f"127.0.0.1:{gport}")
            kserve = KServeClient(f"127.0.0.1:{gport}")
            clients["kserve"] = (lambda name, inputs, output_names=None:
                                 kserve.infer(name, inputs, output_names))
            clients["hbpe"] = hbpe.infer
        try:
            # the index and the documents, at full width
            index = http.models()["models"]
            assert [r["name"] for r in index] == REGISTRY_MODELS, index
            # no YOLO or HigherHRNet weights are in the repository: those
            # three are random; the SSD's are its tflite's
            assert all(r["weights"] == (
                "random" if r["name"] in RANDOM_MODELS else "real"
                if r["name"] in ABSENT_FILE_MODELS else "synthetic-certified")
                for r in index), index
            assert [r["name"] for r in http.get_model_repository_index()] \
                == REGISTRY_MODELS
            ch, cw = cfg.pose.crop_height, cfg.pose.crop_width
            hm_shape = [cfg.pose.num_keypoints, ch // 4, cw // 4]
            meta = {n: http.model_metadata(n) for n in REGISTRY_MODELS}
            conf = {n: http.model_config(n) for n in REGISTRY_MODELS}
            assert meta["hrnet"]["inputs"][0]["shape"] == [-1, 3, ch, cw]
            assert meta["hrnet"]["outputs"][0]["shape"] == [-1, *hm_shape]
            assert meta["hrnet"]["max_batch_size"] == cfg.serve.max_batch
            assert conf["hrnet"]["input"][0]["dims"] == [3, ch, cw]
            assert meta[ENSEMBLE]["outputs"][1]["shape"] == [-1, *hm_shape]
            assert meta[ENSEMBLE]["platform"] == "pytorch_ensemble"
            assert meta["edetlite4_modified"]["outputs"][4]["shape"] == [
                -1, 3, ch, cw]
            assert meta["edetlite4"]["outputs"][0]["shape"] == [1, 100, 4]
            assert conf["edetlite4"]["max_batch_size"] == 0
            from human_body_proportion_estimation_tpu_torch.models.tflite_import import (  # noqa: E501
                DEFAULT_TFLITE_PATH,
            )

            for n in ABSENT_FILE_MODELS:
                if os.path.exists(DEFAULT_TFLITE_PATH):
                    continue
                # its documents are served; its first inference fails as
                # the JAX registry's does, naming the file (400)
                assert meta[n]["inputs"][0]["shape"] == [1, -1, -1, 3]
                status, _, body = http._request_raw(
                    "POST", f"/v2/models/{n}/infer", json.dumps(
                        {"inputs": [{"name": "image", "shape": [1, 4, 4, 3],
                                     "datatype": "UINT8",
                                     "data": [0] * 48}]}).encode(),
                    {"Content-Type": "application/json"})
                assert status == 400 and DEFAULT_TFLITE_PATH in \
                    body.decode(), (n, status, body[:300])
            if not missing:
                assert [r["name"] for r in hbpe.repository_index()] == \
                    REGISTRY_MODELS
                for n in REGISTRY_MODELS:
                    m = kserve.get_model_metadata(n)
                    assert [list(t.shape) for t in m.outputs] == [
                        t["shape"] for t in meta[n]["outputs"]], n
                    assert hbpe.model_config(n)["max_batch_size"] == \
                        conf[n]["max_batch_size"]
            assert meta["yolov5m"]["outputs"][0]["shape"] == [-1, 25200, 85]
            log("phase C: index and documents of the 8 models at full width "
                "agree over " + ", ".join(clients) + "; ssd_mobilenet "
                "without its ssd.tflite answers 400 naming the file")

            # the ensemble on the scenes, against the main path and goldens
            main = pipe.infer_images([i[0] for i in images], height, thres)
            d_all = []
            for s, img in enumerate(images):
                inputs = {"edet_input_image": img,
                          "det_thres": np.array([thres], np.float32),
                          "det_xy_change": xy_change}
                outs = {}
                for via, infer in clients.items():
                    with counted:
                        outs[via] = infer(ENSEMBLE, inputs)
                    assert counted.last == {"decode_heatmaps": 0,
                                            "head_score": 0,
                                            "nms_sweep": 1}, counted.last
                out = outs["http"]
                for via, o in outs.items():
                    for key in o:
                        np.testing.assert_allclose(o[key], out[key],
                                                   rtol=1e-5, atol=1e-5,
                                                   err_msg=f"{via} {key}")
                boxes = out["ENSEMBLE_OUTPUT_FILTER_DET_BOXES"]
                n_ref = int((np.asarray(golden["packed"])[s, :, 0]
                             > 0.5).sum())
                assert boxes.shape[0] == n_ref, (s, boxes, n_ref)
                ref_boxes = main.boxes_norm[s][main.person_valid[s]]
                assert np.abs(boxes - ref_boxes).max() <= 0.01, (
                    boxes, ref_boxes)
                cms = ensemble_cm(k, boxes,
                                  out["ENSEMBLE_OUTPUT_HEATMAPS"],
                                  img.shape[1:3], height, cfg)
                for nth, cm in enumerate(cms):
                    d_all += check_answer(cm, golden, s, height,
                                          f"ensemble scene {s}", nth)
            ens_mean, ens_max = check_mean(d_all, "ensemble")
            log(f"phase C: ensemble over {', '.join(clients)}: persons as "
                "the goldens, boxes within 0.01 of the main path's, cm "
                f"against the goldens mean |dcm| {ens_mean:.4f}, max "
                f"{ens_max:.4f}")

            # the detector models: contracts, and the NMS kernel against
            # its plain version on the candidates the path gave it
            n_cases = 0
            for s, img in enumerate(images):
                with recording_nms(k) as seen:
                    with counted:
                        raw = http.infer("edetlite4", {"image": img})
                    assert counted.last["nms_sweep"] == 1 and \
                        counted.last["head_score"] == 0, counted.last
                    with counted:
                        mod = http.infer("edetlite4_modified", {
                            "edet_input_image": img,
                            "det_thres": np.array([thres], np.float32),
                            "det_xy_change": xy_change})
                    assert counted.last == {"decode_heatmaps": 0,
                                            "head_score": 0,
                                            "nms_sweep": 1}, counted.last
                for boxes, scores, t, keep, plus1 in seen:
                    assert boxes.is_cuda and boxes.shape == (
                        1, cfg.detector.nms_top_k, 4), boxes.shape
                    plain = k.nms_sweep_plain(boxes, scores, t, plus1)
                    assert torch.equal(keep, plain), (s, keep, plain)
                    n_cases += 1
                for scores, classes, out_boxes in (
                        (raw["output_1"][0], raw["output_2"][0],
                         raw["output_0"][0]),
                        (mod["detection_scores"], mod["detection_classes"],
                         mod["detection_boxes"])):
                    assert scores.shape == (100,) and out_boxes.shape == (
                        100, 4)
                    valid = scores > 0
                    assert valid.any() and (np.diff(scores) <= 0).all()
                    assert ((classes[valid] >= 1) & (classes[valid] <= 90)
                            ).all() and (classes[~valid] == 0).all()
                    assert (classes == np.round(classes)).all()
                np.testing.assert_allclose(
                    raw["output_1"][0], mod["detection_scores"], atol=1e-6)
                assert mod["human_crops"].shape[1:] == (3, ch, cw)
                assert mod["filtered_boxes"].shape[0] == (
                    mod["human_crops"].shape[0])
            log(f"phase C: edetlite4 / edetlite4_modified: 100 slots, scores "
                f"non-increasing, classes 1-based; the NMS kernel equals its "
                f"plain version on the {n_cases} candidate sets of the path "
                f"(K = {cfg.detector.nms_top_k}, class-offset boxes)")

            # hrnet under load: 48 requests of 1-4 crops from 16 threads
            crops = http.infer("edetlite4_modified", {
                "edet_input_image": images[0],
                "det_thres": np.array([0.05], np.float32),
                "det_xy_change": xy_change})["human_crops"]
            rng = np.random.default_rng(0)
            pool = np.concatenate([crops, rng.random((4, 3, ch, cw),
                                                     np.float32)])
            requests = [pool[rng.integers(0, len(pool), 1 + i % 4)]
                        for i in range(48)]
            entry = app.registry._models["hrnet"]
            # the references: each request's rows padded with zeros to every
            # launch bucket that holds them (the registry pads a launch so),
            # and alone. cuDNN picks its algorithm by the batch size, so the
            # bf16 forward rounds differently at another size, not by what
            # the other rows hold: the bucket the request was launched in
            # reproduces its answer
            buckets = sorted({_pad_batch(m, cfg.serve.max_batch)
                              for m in range(1, cfg.serve.max_batch + 1)})
            with torch.inference_mode():
                def forward(x, b):
                    pad = np.zeros((b - len(x),) + x.shape[1:], x.dtype)
                    xb = torch.from_numpy(np.concatenate([x, pad])).cuda()
                    return pipe.pose(xb).float()[:len(x)].cpu().numpy()

                by_bucket = [{b: forward(x, b) for b in buckets
                              if b >= len(x)} for x in requests]
                alone = [forward(x, len(x)) for x in requests]
            for via, infer in clients.items():
                infer("hrnet", {"input": requests[3]})      # load + warm
                stats0 = {b: c[0] for b, c in entry.batch_stats.items()}
                runs0 = entry.batches_run
                with counted:
                    outs, lat, wall = hrnet_load(
                        lambda x, infer=infer: infer("hrnet", {"input": x}),
                        requests, 16)
                assert counted.last == dict.fromkeys(KERNELS, 0)
                launches = entry.batches_run - runs0
                rows = {b: c[0] - stats0.get(b, 0)
                        for b, c in entry.batch_stats.items()}
                n_rows = sum(b * c for b, c in rows.items())
                assert n_rows == sum(len(x) for x in requests)
                assert launches < len(requests), launches
                assert max(b for b, c in rows.items() if c) <= \
                    cfg.serve.max_batch
                err = mean_err = err_alone = 0.0
                for i, out in enumerate(outs):
                    scale = float(np.abs(alone[i]).max())
                    d = {b: np.abs(out["output"] - ref)
                         for b, ref in by_bucket[i].items()}
                    b = min(d, key=lambda b: float(d[b].max()))
                    err = max(err, float(d[b].max()) / scale)
                    mean_err = max(mean_err, float(d[b].mean()) / scale)
                    err_alone = max(err_alone, float(
                        np.abs(out["output"] - alone[i]).max()) / scale)
                log(f"phase C: hrnet over {via}, each answer against the "
                    "forward of its rows in the nearest launch bucket: "
                    f"largest error {err:.3g} of the peak, largest mean "
                    f"{mean_err:.3g}; against its rows alone {err_alone:.3g}")
                assert err <= 0.01 and mean_err <= 0.001, (
                    via, err, mean_err, err_alone)
                figures[f"hrnet_{via}"] = dict(
                    requests=len(requests), client_threads=16,
                    requests_per_s=len(requests) / wall,
                    launches=launches, mean_rows_per_launch=n_rows / launches,
                    latency_ms_p50=1e3 * pct(lat, 50),
                    latency_ms_p95=1e3 * pct(lat, 95),
                    max_err_vs_bucket_forward_over_peak=err,
                    mean_err_vs_bucket_forward_over_peak=mean_err,
                    max_err_vs_forward_alone_over_peak=err_alone)
            log(f"phase C: hrnet under load, 48 requests of 1-4 crops from 16 "
                f"threads: {json.dumps(figures)}")
            log(f"phase C card: {card_line()}")

            # the ensemble at one client: ms a request
            inputs = {"edet_input_image": images[0],
                      "det_thres": np.array([thres], np.float32),
                      "det_xy_change": xy_change}
            for via, infer in clients.items():
                infer(ENSEMBLE, inputs)
                t0 = time.perf_counter()
                for _ in range(10):
                    with counted:
                        infer(ENSEMBLE, inputs)
                figures[f"ensemble_{via}_ms_per_request"] = (
                    (time.perf_counter() - t0) * 1e3 / 10)

            # hbpe Estimate on the scenes: each request one batch, each
            # kernel launched once
            if not missing:
                d_all = []
                for s, bts in enumerate(scene_bytes):
                    m0 = http.metrics()
                    with counted:
                        r = hbpe.estimate(bts, height, thres)
                    batches = http.metrics()["batches_total"] - \
                        m0["batches_total"]
                    assert counted.last == dict.fromkeys(KERNELS, batches) \
                        and batches == 1, (counted.last, batches)
                    assert r["code"] == "success", r
                    d_all += check_answer(r["body_proportion_lengths_(cm)"],
                                          golden, s, height,
                                          f"hbpe Estimate scene {s}")
                log("phase C: hbpe Estimate on the 3 scenes, one batch and "
                    "one launch of each kernel a request; against the "
                    "goldens mean |dcm| %.4f, max %.4f"
                    % check_mean(d_all, "hbpe Estimate"))
            metrics = http.metrics()
            assert sorted(metrics["models"]) == REGISTRY_MODELS, metrics
        finally:
            if grpc_server is not None:
                hbpe.close()
                kserve.close()
                grpc_server.stop(0)
    figures["grpc"] = "present" if not missing else f"no module {missing}"
    log(f"phase C figures: {json.dumps(figures)}")
    log(f"phase C card: {card_line()}")
    log(f"phase C launches: {counted.total}")
    return counted.total


# --------------------------------------------------------------------- #
# phase Y: the YOLOv5 detector slot


_YOLO_STATE = {}


def yolo_state(golden, images):
    """The goldens' seeded YOLOv5m weights, made again on this machine's
    CPU from the seed and biases the file records (a port `state_dict`),
    once a run (phases Y and X share it)."""
    if golden["seed"] not in _YOLO_STATE:
        _YOLO_STATE[golden["seed"]] = _make_yolo_state(golden, images)
    return _YOLO_STATE[golden["seed"]]


def _make_yolo_state(golden, images):
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.models.yolo_weights import (  # noqa: E501
        seeded_state,
    )
    from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
        YOLOV5M,
    )
    from human_body_proportion_estimation_tpu_torch.ops import image as ops

    boxed = ops.letterbox(torch.from_numpy(np.stack(images)).float(), 640,
                          640)
    x = (boxed / 255.0).permute(0, 3, 1, 2).numpy()
    state = seeded_state(YOLOV5M, golden["seed"], x, golden["obj_bias"],
                         golden["person_bias"])
    return {key: torch.from_numpy(v) for key, v in state.items()}


def check_keep_masks(k, seen, what):
    """Every keep mask the path's NMS kernel gave against the plain
    version on the same candidates; returns the (K, plus1) seen."""
    import torch

    shapes = []
    for boxes, scores, t, keep, plus1 in seen:
        assert boxes.is_cuda, what
        plain = k.nms_sweep_plain(boxes, scores, t, plus1)
        assert torch.equal(keep, plain), (what, boxes.shape, plus1)
        shapes.append((tuple(boxes.shape[:2]), plus1))
    return shapes


def check_yolo_golden(packed, golden, what):
    """The first rows of `packed` against the YOLO goldens: identical person
    validity, phase 3's cm rule on the segments visible in both. Returns
    the comparison's figures."""
    import numpy as np

    ref = np.asarray(golden["packed"], np.float32)
    got = packed[: len(ref)]
    assert np.array_equal(got[..., 0] > 0.5, ref[..., 0] > 0.5), \
        f"{what}: person_valid {got[..., 0]} vs {ref[..., 0]}"
    vis_got, vis_ref = got[..., 12:] > 0.5, ref[..., 12:] > 0.5
    both = vis_got & vis_ref
    d = np.abs(got[..., 1:12] - ref[..., 1:12])[both]
    figures = dict(persons=int((ref[..., 0] > 0.5).sum()),
                   segments_both=int(both.sum()),
                   visibility_mismatch=int((vis_got != vis_ref).sum()),
                   max_abs_cm=float(d.max()), mean_abs_cm=float(d.mean()))
    assert both.sum() > 0, what
    assert d.mean() <= GOLDEN_MEAN_CM and d.max() <= GOLDEN_MAX_CM, \
        (what, figures)
    return figures


def imgs_per_s(pipe, batch, height, thres, iters=8):
    import torch

    for _ in range(2):
        pipe.infer_serving(batch, height, thres)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe.infer_serving(batch, height, thres)
    return len(batch) * iters / (time.perf_counter() - t0)


def detect_yolo_cli(repo, image, extra):
    """`cli.detect_yolo` in a subprocess (started, not waited for)."""
    return Started(
        [sys.executable, "-m",
         "human_body_proportion_estimation_tpu_torch.cli.detect_yolo",
         "-i", image, "-o", "", "--model", "yolov5m", *extra], repo,
        env=beside_env())


def cli_detections(proc, what):
    import re

    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, (what, err[-4000:])
    counts = re.findall(r"^frame 0: (\d+) detections$", out, re.M)
    assert len(counts) == 1, (what, out[-2000:])
    return int(counts[0])


def run_yolo(k, dev, lite4_pipe, repo):
    """Phase Y: `--detector yolov5m` on the card. Returns the launches of
    the path's forwards and requests (comparisons excluded)."""
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.ops import (
        nms as nms_ops,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.detect import (
        YoloDetectPipeline,
        letterbox_host,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
        decode_image_bytes,
        prewarm_serving,
    )
    from human_body_proportion_estimation_tpu_torch.serve import (
        server as srv,
    )
    from human_body_proportion_estimation_tpu_torch.serve.client import (
        HttpClient,
    )

    t_phase = time.perf_counter()
    with open(os.path.join(DATA, "yolo_goldens.json")) as fh:
        golden = json.load(fh)
    paths = [os.path.join(DATA, name) for name in golden["scenes"]]
    scene_bytes = []
    for path in paths:
        with open(path, "rb") as fh:
            scene_bytes.append(fh.read())
    images = [decode_image_bytes(b) for b in scene_bytes]
    n = len(images)
    height, thres = golden["person_height_cm"], golden["det_threshold"]
    batch16 = [images[i % n] for i in range(16)]
    # step 6's CLIs (process mode, random weights of their own) begin now,
    # beside the steps before it
    cli_procs = {flags: detect_yolo_cli(repo, paths[0], list(flags))
                 for flags in ((), ("--legacy-nms",))}

    # 1. the weights: the goldens' seeded YOLOv5m, made here on the CPU
    t0 = time.perf_counter()
    state = yolo_state(golden, images)
    log(f"phase Y: seeded YOLOv5m (seed {golden['seed']}, objectness bias "
        f"{golden['obj_bias']}, person bias {golden['person_bias']}) made "
        f"on the CPU in {time.perf_counter() - t0:.1f} s")
    # the golden configuration: f32 with TF32 off, as the JAX goldens; and
    # the served one, as `server --detector yolov5m` builds it (bf16, the
    # certified HRNet-W32, the detector at random and labelled so), with
    # the goldens' random weights in place of its own
    pipe32 = InferencePipeline(det_state=state, device=dev,
                               dtype=torch.float32, detector="yolov5m")
    args = srv.build_parser().parse_args(["--detector", "yolov5m"])
    spipe = srv.build_pipeline(args)
    assert spipe.weights_origin == {"detector": "random",
                                    "pose": "synthetic-certified"}, \
        spipe.weights_origin
    spipe.backend.model.load_state_dict(state, strict=True)
    counted = Counted(k)

    # 2. the serving forwards, their keep masks and launch counts
    with recording_nms(k) as seen:
        with counted:
            packed32 = pipe32.infer_serving(batch16, height, thres)
            outs32 = [pipe32.infer_images([img], height, thres)
                      for img in images]
            packed16 = spipe.infer_serving(batch16, height, thres)
    forwards = 2 + n
    assert counted.last == {"decode_heatmaps": forwards, "head_score": 0,
                            "nms_sweep": forwards}, counted.last
    shapes = check_keep_masks(k, seen, "serving forwards")
    assert sorted(shapes) == sorted(
        [((16, 128), False)] * 2 + [((1, 128), False)] * n), shapes
    path_boxes, path_scores = seen[0][0], seen[0][1]
    log(f"phase Y: {forwards} forwards, launches {counted.last} (one sweep "
        f"a forward over the batch); the {len(seen)} keep masks equal the "
        "plain version's")
    assert packed32.shape == packed16.shape == (16, 3, 23)
    assert np.isfinite(packed32).all() and np.isfinite(packed16).all()
    for i in range(16):
        np.testing.assert_array_equal(packed32[i], packed32[i % n])
    f32 = check_yolo_golden(packed32, golden, "f32 serving forward")
    boxes = np.concatenate([o.boxes_orig for o in outs32])
    scores = np.concatenate([o.det_scores for o in outs32])
    valid = np.asarray(golden["person_valid"])
    box_err = float(np.abs(boxes - np.asarray(golden["boxes_orig_yxyx"]))
                    [valid].max())
    score_err = float(np.abs(scores - np.asarray(golden["det_scores"]))
                      [valid].max())
    assert box_err <= 0.05 and score_err <= 1e-4, (box_err, score_err)
    log(f"phase Y: f32 (TF32 off) serving forward at B=16 vs the JAX goldens "
        f"(f32): persons identical, {json.dumps(f32)}; B=1 person boxes "
        f"within {box_err:.3g} px, scores within {score_err:.3g}")
    bf16_valid = int(((packed16[:n, :, 0] > 0.5)
                      == (np.asarray(golden["packed"])[..., 0] > 0.5)).all())
    log(f"phase Y: the bf16 serving forward (not held to the goldens: the "
        f"seeded network amplifies bf16 rounding) finds the goldens' persons: "
        f"{bool(bf16_valid)}")

    # 3. the port's own CPU path, B=1, the same weights
    cpu = InferencePipeline(det_state=state, device="cpu",
                            dtype=torch.float32, detector="yolov5m")
    cpu_packed = np.concatenate([cpu.infer_serving([img], height, thres)
                                 for img in images])
    card_packed = np.concatenate([pipe32.infer_serving([img], height, thres)
                                  for img in images])
    cpu_cmp = check_yolo_golden(cpu_packed, dict(
        golden, packed=card_packed.tolist()), "CPU vs card at B=1")
    log(f"phase Y: the CPU path at B=1 vs the card's f32 at B=1: "
        f"{json.dumps(cpu_cmp)}")
    del cpu

    # 4. the server, `--detector yolov5m`: answers against the B=1..4
    # forwards of their scenes (equal batch sizes: bf16 rounds by batch)
    warmed = prewarm_serving(spipe)

    refs = {(s, b): first_person(spipe.infer_serving([images[s]] * b,
                                                     height, thres)[0])
            for s in range(n) for b in (1, 2, 4)}
    with_person = sum(bool(refs[(s, 1)]) for s in range(n))
    with served(srv.ServingApp(spipe)) as port:
        health = http_json(port, "GET", "/health")
        assert health["weights"] == {"detector": "random",
                                     "pose": "synthetic-certified"}, health
        m0 = http_json(port, "GET", "/metrics")
        with counted:
            answers, wall = post_load(port, scene_bytes, [int(height)] * 16,
                                      thres, 4)
        m1 = http_json(port, "GET", "/metrics")
        batches = m1["batches_total"] - m0["batches_total"]
        assert counted.last == {"decode_heatmaps": batches, "head_score": 0,
                                "nms_sweep": batches}, (counted.last, batches)
        sizes = []
        for i, r in enumerate(answers):
            assert r["code"] == "success", r
            cm = r["body_proportion_lengths_(cm)"]
            match = [b for b in (1, 2, 4) if refs[(i % n, b)] == cm]
            assert match, (i, cm, [refs[(i % n, b)] for b in (1, 2, 4)])
            sizes.append(match[0])
    log(f"phase Y: server --detector yolov5m (prewarmed {warmed}): 16 "
        f"requests from 4 clients in {wall:.2f} s, {batches} batches, "
        f"launches {counted.last}; every answer equals its scene's forward "
        f"at batch size {sorted(set(sizes))} ({with_person} of {n} scenes "
        f"with a person in bf16); /health weights "
        f"{health['weights']}")

    # 5. the registry's yolov5m over HTTP and hbpe gRPC, the NMS on the
    # client (the card), against the in-process detect_yolo program
    missing = grpc_modules()
    app = srv.ServingApp(spipe)
    grpc_server = None
    detect = YoloDetectPipeline(spipe.backend.model, 0.4, 0.5, top_k=512)
    legacy = YoloDetectPipeline(spipe.backend.model, 0.5, 0.4, top_k=512,
                                legacy_nms=True)
    n_det, remote_cli = [], None
    with served(app) as port:
        http = HttpClient("127.0.0.1", port)
        clients = {"http": http.infer}
        if not missing:
            from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (  # noqa: E501
                GrpcClient,
                create_grpc_server,
            )

            grpc_server, gport = create_grpc_server(app, "127.0.0.1", 0)
            grpc_server.start()
            hbpe = GrpcClient(f"127.0.0.1:{gport}")
            clients["hbpe"] = hbpe.infer
            remote_cli = detect_yolo_cli(
                repo, paths[0], ["-t", "0.4", "-g", f"127.0.0.1:{gport}"])
        try:
            meta = http.model_metadata("yolov5m")
            assert meta["outputs"][0]["shape"] == [-1, 25200, 85], meta
            with recording_nms(k) as seen:
                for s, img in enumerate(images):
                    x = letterbox_host(img)[None]
                    nchw = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                    preds = {}
                    for via, infer in clients.items():
                        with counted:
                            preds[via] = infer("yolov5m",
                                               {"images": nchw})["output"]
                        assert counted.last == dict.fromkeys(KERNELS, 0)
                        assert preds[via].shape == (1, 25200, 85)
                        np.testing.assert_array_equal(preds[via],
                                                      preds["http"])
                    p = torch.from_numpy(preds["http"]).to(dev)
                    with counted:
                        res = nms_ops.yolo_nms(p, 0.4, 0.5, 300, 512)
                        res_l = nms_ops.yolo_nms_legacy(p, 80, 0.5, 0.4,
                                                        300, 512)
                    assert counted.last == {"decode_heatmaps": 0,
                                            "head_score": 0,
                                            "nms_sweep": 2}, counted.last
                    want = detect(torch.from_numpy(x).to(dev))
                    want_l = legacy(torch.from_numpy(x).to(dev))
                    for got, ref in ((res, want), (res_l, want_l)):
                        assert torch.equal(got.valid, ref.valid), s
                        torch.testing.assert_close(got.boxes, ref.boxes,
                                                   rtol=0, atol=1e-4)
                        torch.testing.assert_close(got.scores, ref.scores,
                                                   rtol=0, atol=1e-6)
                        assert torch.equal(got.classes, ref.classes)
                    n_det.append((int(res.valid.sum()),
                                  int(res_l.valid.sum())))
            shapes = check_keep_masks(k, seen, "client NMS")
            assert {s for s, _ in shapes} == {(1, 512)}, shapes
            assert sum(p for _, p in shapes) == len(shapes) // 2
            client_boxes = seen[0][:2]
            if remote_cli is not None:
                remote = cli_detections(remote_cli, "detect_yolo -g")
                assert remote == n_det[0][0], (remote, n_det)
        finally:
            if grpc_server is not None:
                hbpe.close()
                grpc_server.stop(0)
    log(f"phase Y: registry yolov5m over {', '.join(clients)}: "
        f"[1, 25200, 85] a scene, identical on every protocol; the "
        f"client-side yolo_nms / yolo_nms_legacy at top_k 512 on the card "
        f"give the in-process detect_yolo detections {n_det} (official, "
        f"legacy) and their keep masks equal the plain version's "
        f"(K = 512, both IoU forms)"
        + ("" if remote_cli is None else
           f"; detect_yolo -g in a subprocess: {n_det[0][0]} detections"))

    # 6. the CLI in process mode, in subprocesses (begun at the phase's
    # start): default and --legacy-nms
    cli = {" ".join(f) or "default": cli_detections(p, f"detect_yolo {f}")
           for f, p in cli_procs.items()}
    log(f"phase Y: detect_yolo --model yolov5m (random weights of its own) "
        f"exits 0: detections {cli}")

    # 7. times: the serving forward, YOLOv5m beside Lite4 in turns; the NMS
    # kernel on the path's own candidates, beside an empty kernel
    rates = {"yolov5m": [], "efficientdet_lite4": []}
    for _ in range(2):
        rates["efficientdet_lite4"].append(imgs_per_s(lite4_pipe, batch16,
                                                      175.0, 0.7))
        rates["yolov5m"].append(imgs_per_s(spipe, batch16, height, thres))
    blocks, threads = k.nms_launch_shape()
    sweep = {
        "[16,128] serving candidates": graph_ms(
            lambda: k.nms_sweep(path_boxes, path_scores, 0.5), 100),
        "[1,512] client candidates": graph_ms(
            lambda: k.nms_sweep(*client_boxes, 0.5), 100),
        "[1,512] client candidates +1": graph_ms(
            lambda: k.nms_sweep(*client_boxes, 0.4, plus1=True), 100),
        "empty kernel, 16 images": graph_ms(
            lambda: k.empty_launch(16 * blocks, threads), 100),
        "empty kernel, 1 image": graph_ms(
            lambda: k.empty_launch(blocks, threads), 100),
    }
    log(f"phase Y: infer_serving B=16 imgs/s in turns: "
        f"{json.dumps(rates)}; nms_sweep graph replay ms: "
        f"{json.dumps(sweep)}")
    log(f"phase Y card: {card_line()}")
    log(f"phase Y: {time.perf_counter() - t_phase:.1f} s, launches "
        f"{counted.total}")
    return counted.total


# --------------------------------------------------------------------- #
# phase S: the SSD-MobileNetV1 slot


def ssd_slots_against(res, golden, det_hw, what):
    """The 10 TFLite_Detection_PostProcess slots of each scene against the
    goldens': the same detections (validity and classes), boxes within
    0.05 det-input px, scores within 1e-4. Returns (box px, score) errors."""
    import numpy as np

    ref = golden["ssd_slots"]
    valid = np.asarray(ref["valid"])
    got_valid = res.valid.cpu().numpy()
    assert np.array_equal(got_valid, valid), (what, got_valid, valid)
    assert np.array_equal(res.classes.cpu().numpy(),
                          np.asarray(ref["classes"], np.float32)), what
    h, w = det_hw
    scale = np.asarray([h, w, h, w], np.float32)
    box_err = float((np.abs(res.boxes.cpu().numpy() - np.asarray(
        ref["boxes"], np.float32)) * scale)[valid].max())
    score_err = float(np.abs(res.scores.cpu().numpy() - np.asarray(
        ref["scores"], np.float32))[valid].max())
    assert box_err <= 0.05 and score_err <= 1e-4, (what, box_err, score_err)
    return box_err, score_err


def orbax_round_trip(directory, det_state, pose_state):
    """Write the pipeline checkpoint of two port `state_dict`s with the
    port's Orbax store (`models/orbax_store.py`) and read it back, both
    timed, the zstd decoder built first; every leaf must come back
    bit-equal. Returns (write s, read s, MB on disk)."""
    import numpy as np

    from human_body_proportion_estimation_tpu_torch.models.weights import (
        load_pipeline_checkpoint,
        save_pipeline_checkpoint,
        state_dict_to_flax,
    )
    from human_body_proportion_estimation_tpu_torch.utils import zstd

    t0 = time.perf_counter()
    zstd.load_library()
    log(f"zstd decoder (utils/zstd_decompress.cpp) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    trees = (state_dict_to_flax(det_state), state_dict_to_flax(pose_state))
    t0 = time.perf_counter()
    save_pipeline_checkpoint(directory, *trees)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = load_pipeline_checkpoint(directory)
    t_read = time.perf_counter() - t0
    for want, have in zip(trees, got):
        want, have = flat_tree(want), flat_tree(have)
        assert sorted(want) == sorted(have)
        for name, arr in want.items():
            assert have[name].dtype == arr.dtype and np.array_equal(
                have[name], arr), name
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(directory) for f in fs)
    return t_write, t_read, size / 1e6


def flat_tree(tree, prefix=""):
    """'/'-joined leaf paths of a nested dict and their leaves."""
    out = {}
    for k in sorted(tree):
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(flat_tree(tree[k], name))
        else:
            out[name] = tree[k]
    return out


def check_orbax_fixture() -> int:
    """The committed Orbax checkpoint the JAX package wrote
    (tests/data/torch_port/orbax_jax/, made by
    tests/torch_port_orbax_fixture.py), read by the port, equals its twin
    orbax_jax.npz bit for bit (bfloat16 as its uint16 bits; the numpy
    scalar Orbax restores as a Python number). Returns the leaf count."""
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.models.weights import (
        load_pipeline_checkpoint,
    )

    det, pose = load_pipeline_checkpoint(os.path.join(DATA, "orbax_jax"))
    twin = np.load(os.path.join(DATA, "orbax_jax.npz"))
    got = flat_tree({"det": det, "pose": pose})
    assert sorted(got) == sorted(twin.files), (sorted(got), twin.files)
    for name, leaf in got.items():
        want = twin[name]
        if isinstance(leaf, torch.Tensor):
            assert leaf.dtype == torch.bfloat16, name
            leaf = leaf.view(torch.int16).numpy().view(np.uint16)
        if isinstance(leaf, (int, float)):
            assert want.shape == () and leaf == want.item(), name
            continue
        assert (leaf.dtype, leaf.shape) == (want.dtype, want.shape), name
        assert leaf.tobytes() == want.tobytes(), name
    return len(got)


def write_automl_inputs(directory, tfbundle):
    """Phase S step 8's inputs, written without TensorFlow: the certified
    Lite4 as an automl-format TF1 checkpoint (TF1 names, by
    tests/torch_port_tfbundle.py, in two data shards; every 8th tensor with
    an ExponentialMovingAverage shadow that holds the certified value while
    its plain name holds the value + 1.0, so that an importer that ignores
    the shadows serves other rows; an int64 global_step) and the certified
    W32 as an official pose_hrnet .pth. Returns (the checkpoint's
    directory, the .pth, the name -> array the importer must read, the
    bundle's write seconds, its MB)."""
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (  # noqa: E501
        EFFICIENTDET_LITE4,
    )
    from human_body_proportion_estimation_tpu_torch.models.hrnet import (
        HRNET_W32,
    )
    from human_body_proportion_estimation_tpu_torch.models.tf_import import (
        export_tf_efficientdet,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        default_certified_checkpoint,
        export_torch_hrnet,
        load_compact_checkpoint,
    )

    det, pose = load_compact_checkpoint(default_certified_checkpoint())
    arrays = export_tf_efficientdet(det, EFFICIENTDET_LITE4)
    stored = dict(arrays)
    for name in sorted(arrays)[::8]:
        stored[f"{name}/ExponentialMovingAverage"] = arrays[name]
        stored[name] = arrays[name] + np.float32(1.0)
    stored["global_step"] = np.int64(300000)
    edet = os.path.join(directory, "efficientdet-lite4")
    t0 = time.perf_counter()
    tfbundle.write_checkpoint(os.path.join(edet, "model.ckpt-300000"),
                              stored, shards=2)
    t_write = time.perf_counter() - t0
    mb = sum(os.path.getsize(os.path.join(edet, f))
             for f in os.listdir(edet)) / 1e6
    pth = os.path.join(directory, "pose_hrnet_w32_384x288.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                export_torch_hrnet(pose, HRNET_W32).items()}, pth)
    return edet, pth, arrays, t_write, mb


def write_tf1_export(directory, arrays, tfbundle):
    """Phase S step 9's input, written without TensorFlow: the certified
    Lite4 (`arrays`, automl names) as a TF1 SavedModel by
    tests/torch_port_tfbundle.py (a resource variable each, unevaluated
    TruncatedNormal initializers, a sharded saver's restore graph with two
    RestoreV2s over two data files) with a local variable that a Fill
    sets. Returns (its directory, name -> value of every variable in
    `.variables` order, the write seconds, its MB)."""
    import numpy as np

    local = {"eval/num_images": ((16, 4), np.float32(0.0))}
    sm_dir = os.path.join(directory, "saved_model")
    t0 = time.perf_counter()
    tfbundle.write_tf1_saved_model(sm_dir, arrays, local, shards=2)
    t_write = time.perf_counter() - t0
    mb = sum(os.path.getsize(os.path.join(d, f))
             for d, _, fs in os.walk(sm_dir) for f in fs) / 1e6
    want = {name: arrays[name] for name in sorted(arrays, key=str.encode)}
    want.update({name: np.full(shape, fill) for name, (shape, fill)
                 in local.items()})
    return sm_dir, want, t_write, mb


def run_ssd(k, dev, lite4_pipe, repo):
    """Phase S: the SSD slot on the card, on seeded weights (the reference's
    ssd.tflite is not in the checkout). Returns the launches of the path's
    forwards, artifact batch and requests (comparisons excluded)."""
    import tempfile

    import cv2
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (  # noqa: E501
        load_ssd,
        ssd_postprocess,
        ssd_state_dict,
    )
    from human_body_proportion_estimation_tpu_torch.models.tflite_import import (  # noqa: E501
        DEFAULT_TFLITE_PATH,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.backends import (
        SSDBackend,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.export import (
        ArtifactPipeline,
        export_serving_artifact,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
        decode_image_bytes,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.human_detector import (  # noqa: E501
        HumanDetectorSSD,
    )
    from human_body_proportion_estimation_tpu_torch.serve import (
        server as srv,
    )
    from human_body_proportion_estimation_tpu_torch.serve.client import (
        HttpClient,
    )
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        DetectorConfig,
        PipelineConfig,
    )

    t_phase = time.perf_counter()
    # step 6's server begins now, beside the steps before it
    default_server = None if os.path.exists(DEFAULT_TFLITE_PATH) else Started(
        [sys.executable, "-m",
         "human_body_proportion_estimation_tpu_torch.serve.server",
         "--port", "0", "--grpc-port", "0"], repo, timeout=300,
        env=beside_env())
    # step 8's automl-format inputs, written now, and its import CLI,
    # begun beside steps 1-7
    tmp = tempfile.mkdtemp(prefix="phase_s_")
    edet_dir, pth, tf_arrays, t_tf_write, tf_mb = write_automl_inputs(
        tmp, load_tests_module("torch_port_tfbundle"))
    imported = os.path.join(tmp, "imported")
    import_cli = Started(
        [sys.executable, "-m",
         "human_body_proportion_estimation_tpu_torch.cli.import_weights",
         "--efficientdet-ckpt", edet_dir, "--efficientdet-variant", "lite4",
         "--hrnet-torch", pth, "--out", imported], repo, timeout=600,
        env=beside_env())
    # step 9's TF1 SavedModel of the same Lite4, written now, and its
    # import CLI, begun beside steps 1-8
    sm_dir, sm_want, t_sm_write, sm_mb = write_tf1_export(
        tmp, tf_arrays, load_tests_module("torch_port_tfbundle"))
    imported_sm = os.path.join(tmp, "imported_sm")
    import_sm_cli = Started(
        [sys.executable, "-m",
         "human_body_proportion_estimation_tpu_torch.cli.import_weights",
         "--efficientdet-saved-model", sm_dir, "--efficientdet-variant",
         "lite4", "--hrnet-torch", pth, "--out", imported_sm], repo,
        timeout=600, env=beside_env())
    recipe = load_tests_module("torch_port_ssd")
    tflite = load_tests_module("torch_port_tflite")
    with open(os.path.join(DATA, "ssd_goldens.json")) as fh:
        golden = json.load(fh)
    scene_bytes = []
    for name in golden["scenes"]:
        with open(os.path.join(DATA, name), "rb") as fh:
            scene_bytes.append(fh.read())
    images = [decode_image_bytes(b) for b in scene_bytes]
    n = len(images)
    height, thres = golden["person_height_cm"], golden["det_threshold"]
    batch16 = [images[i % n] for i in range(16)]
    counted = Counted(k)

    # 1. the goldens' seeded weights, made again here on the CPU
    t0 = time.perf_counter()
    tree = recipe.seeded_ssd(golden["seed"], np.stack(images),
                             golden["person_bias"])
    anchors = recipe.ssd_anchors()
    state = ssd_state_dict(tree, anchors)
    log(f"phase S: seeded SSD (flax's draw at seed {golden['seed']}, folded "
        f"calibration, person bias {golden['person_bias']}) made on the CPU "
        f"in {time.perf_counter() - t0:.1f} s")
    pipe32 = InferencePipeline(det_state=state, device=dev,
                               dtype=torch.float32, detector="ssd_mobilenet")
    cfg = pipe32.config
    det_hw = (cfg.detector.input_height, cfg.detector.input_width)
    assert pipe32.weights_origin == {"detector": "real",
                                     "pose": "synthetic-certified"}

    # 2. f32 (TF32 off) forwards: launches, keep masks, the goldens
    with recording_nms(k) as seen:
        with counted:
            packed32 = pipe32.infer_serving(batch16, height, thres)
            outs32 = [pipe32.infer_images([img], height, thres)
                      for img in images]
    forwards = 1 + n
    assert counted.last == {"decode_heatmaps": forwards, "head_score": 0,
                            "nms_sweep": forwards}, counted.last
    shapes = check_keep_masks(k, seen, "SSD serving forwards")
    assert sorted(shapes) == sorted([((16, 128), False)]
                                    + [((1, 128), False)] * n), shapes
    path_boxes, path_scores = seen[0][0], seen[0][1]
    # the class offsets: coordinates up to class * MAX_WH
    offset_max = float(path_boxes.abs().max())
    log(f"phase S: {forwards} forwards, launches {counted.last} (one sweep "
        f"an SSD batch); the {len(seen)} keep masks equal the plain "
        f"version's, on [16,128] class-offset candidates up to "
        f"{offset_max:.1f}")
    assert np.isfinite(packed32).all() and packed32.shape == (16, 3, 23)
    for i in range(16):
        np.testing.assert_array_equal(packed32[i], packed32[i % n])
    f32 = check_yolo_golden(packed32, golden, "SSD f32 serving forward")
    boxes = np.concatenate([o.boxes_orig for o in outs32])
    scores = np.concatenate([o.det_scores for o in outs32])
    valid = np.asarray(golden["person_valid"])
    person_box_err = float(np.abs(boxes - np.asarray(
        golden["boxes_orig_yxyx"]))[valid].max())
    person_score_err = float(np.abs(scores - np.asarray(
        golden["det_scores"]))[valid].max())
    assert person_box_err <= 0.05 and person_score_err <= 1e-4, (
        person_box_err, person_score_err)
    # the raw outputs and the 10 SSD slots of each scene
    x = torch.from_numpy(recipe.ssd_inputs(np.stack(images))).to(dev)
    with torch.inference_mode():
        box_regs, logits = pipe32.backend.model(x)
        res = ssd_postprocess(box_regs, logits, pipe32.backend.anchors)
    ext = golden["raw_extrema"]
    raw_err = max(
        float(np.abs(box_regs.amin((1, 2)).cpu().numpy()
                     - ext["box_regs_min"]).max()),
        float(np.abs(box_regs.amax((1, 2)).cpu().numpy()
                     - ext["box_regs_max"]).max()),
        float(np.abs(logits.amin((1, 2)).cpu().numpy()
                     - ext["logits_min"]).max()),
        float(np.abs(logits.amax((1, 2)).cpu().numpy()
                     - ext["logits_max"]).max()))
    slot_box_err, slot_score_err = ssd_slots_against(res, golden, det_hw,
                                                     "SSD slots")
    log(f"phase S: f32 (TF32 off) vs the JAX goldens: the same 10 SSD "
        f"slots a scene (boxes within {slot_box_err:.3g} px, scores within "
        f"{slot_score_err:.3g}; raw extrema within {raw_err:.3g}); served "
        f"rows {json.dumps(f32)}; B=1 person boxes within "
        f"{person_box_err:.3g} px, scores within {person_score_err:.3g}")

    # 3. the SSD slot's serving artifact (pipeline/export.py) at B=16:
    # exported from the f32 pipeline, restored, its rows against the live
    # forward's; one NMS launch and one decode an artifact batch
    art = os.path.join(tmp, "ssd_w32_b16")
    t0 = time.perf_counter()
    export_serving_artifact(pipe32, art, batch_size=16)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = ArtifactPipeline(art, device=dev)
    t_restore = time.perf_counter() - t0
    assert restored.weights_origin == pipe32.weights_origin
    with counted:
        art16 = restored.infer_serving(batch16, height, thres)
    assert counted.last == {"decode_heatmaps": 1, "head_score": 0,
                            "nms_sweep": 1}, counted.last
    art_vs_live = packed_against(art16, packed32,
                                 "SSD artifact B=16 vs live B=16")
    assert art_vs_live["identical"], art_vs_live
    mib = os.path.getsize(os.path.join(art, "pipeline.pt2")) / 2**20
    log(f"phase S: the SSD artifact at B=16 (f32, exported in "
        f"{t_export:.1f} s, {mib:.1f} MiB) restores in {t_restore:.1f} s "
        f"with the pipeline's labels; launches a batch "
        f"{counted.last}; vs live B=16 {json.dumps(art_vs_live)}")
    del restored

    # 4. the registry's ssd_mobilenet over HTTP JSON, hbpe gRPC and KServe
    # gRPC, against the in-process program (ssd_postprocess at B=1)
    missing = grpc_modules()
    app = ServingApp(pipe32)
    grpc_server = None
    reg_figs = {}
    with served(app) as port:
        http = HttpClient("127.0.0.1", port)
        clients = {"http_json": lambda name, inputs: http.infer(
            name, inputs, binary=False)}
        if not missing:
            from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (  # noqa: E501
                GrpcClient,
                create_grpc_server,
            )
            from human_body_proportion_estimation_tpu_torch.serve.kserve_grpc import (  # noqa: E501
                KServeClient,
            )

            grpc_server, gport = create_grpc_server(app, "127.0.0.1", 0)
            grpc_server.start()
            hbpe = GrpcClient(f"127.0.0.1:{gport}")
            kserve = KServeClient(f"127.0.0.1:{gport}")
            clients["hbpe"] = hbpe.infer
            clients["kserve"] = (lambda name, inputs:
                                 kserve.infer(name, inputs))
        try:
            meta = http.model_metadata("ssd_mobilenet")
            assert meta["inputs"][0]["shape"] == [1, -1, -1, 3], meta
            index = {r["name"]: r["weights"] for r in http.models()["models"]}
            assert index["ssd_mobilenet"] == "real", index
            for s, img in enumerate(images):
                ssd_in = cv2.resize(img, (300, 300)).astype(np.uint8)
                with torch.inference_mode():
                    br, lg = pipe32.backend.model(
                        torch.from_numpy(ssd_in[None]).to(dev))
                    want = ssd_postprocess(br, lg, pipe32.backend.anchors)
                want = {"detection_boxes": want.boxes,
                        "detection_classes": want.classes,
                        "detection_scores": want.scores,
                        "num_detections": want.valid.sum(-1).float()}
                for via, infer in clients.items():
                    with counted:
                        got = infer("ssd_mobilenet", {"image": img[None]})
                    assert counted.last == {"decode_heatmaps": 0,
                                            "head_score": 0,
                                            "nms_sweep": 1}, counted.last
                    for key, ref in want.items():
                        ref = ref.cpu().numpy()
                        assert got[key].shape == ref.shape, (via, key)
                        np.testing.assert_array_equal(
                            got[key], ref, err_msg=f"{via} {key}")
                    reg_figs.setdefault(via, 0)
                    reg_figs[via] += int(got["num_detections"][0])
        finally:
            if grpc_server is not None:
                grpc_server.stop(0)
    log(f"phase S: registry ssd_mobilenet over {', '.join(clients)}: each "
        f"answer equal to the in-process program (detections {reg_figs}), "
        "one NMS launch ([1,128]) a request")

    # 5. HumanDetectorSSD on a tflite written here (no TensorFlow): the
    # seeded weights quantized to uint8, read by the port's own parser
    path = tflite.write_tflite(os.path.join(tmp, "ssd.tflite"),
                               tflite.ssd_tensors(tree["params"], anchors))
    detector = HumanDetectorSSD(tflite_path=path, threshold=0.3, device=dev)
    square = PipelineConfig(detector=DetectorConfig(
        name="ssd_mobilenet", input_height=300, input_width=300))
    model, table = load_ssd(path=path, dtype=torch.float32, device=dev)
    backend = SSDBackend(model, square, table)
    found = []
    for img in images:
        with counted:
            d_boxes, d_scores = detector.get_detections(img)
        assert counted.last["nms_sweep"] == 1, counted.last
        ssd_in = cv2.resize(img, (300, 300)).astype(np.float32)
        with torch.inference_mode():
            b_boxes, b_scores, b_valid = backend(
                torch.from_numpy(ssd_in[None]).to(dev),
                torch.tensor([0.3], device=dev))
        m = int(b_valid.sum())
        assert min(len(d_boxes), 3) == m, (len(d_boxes), m)
        np.testing.assert_allclose(
            d_boxes[:m], b_boxes[0, :m].cpu().numpy() / 300.0, rtol=0,
            atol=1e-5)
        np.testing.assert_array_equal(d_scores[:m],
                                      b_scores[0, :m].cpu().numpy())
        found.append(len(d_boxes))
    log(f"phase S: HumanDetectorSSD on a written {os.path.getsize(path)} B "
        f"tflite (uint8 weights) finds {found} persons at 0.3, the boxes "
        "and scores SSDBackend gives on the dequantized weights")

    # 6. the default server with the file absent (begun at the phase's
    # start): exit 2 naming it
    if default_server is not None:
        _, err = default_server.communicate()
        assert default_server.returncode == 2 and DEFAULT_TFLITE_PATH in err, (
            default_server.returncode, err[-2000:])
        log(f"phase S: serve.server with its default --detector exits 2 "
            f"naming {DEFAULT_TFLITE_PATH}")

    # 7. --checkpoint-dir: an Orbax checkpoint written here by the port's
    # store from the certified weights, read (timed), served once, rows
    # equal to the compact checkpoint's path; then the committed
    # JAX-written fixture, read bit for bit against its twin
    ckpt = os.path.join(tmp, "ckpt")
    t_write, t_read, mb = orbax_round_trip(
        ckpt, lite4_pipe.backend.detector.state_dict(),
        lite4_pipe.pose.state_dict())
    args = srv.build_parser().parse_args(
        ["--detector", "efficientdet_lite4", "--checkpoint-dir", ckpt])
    t0 = time.perf_counter()
    cpipe = srv.build_pipeline(args)
    t_build = time.perf_counter() - t0
    assert cpipe.weights_origin == {"detector": "real", "pose": "real"}
    rows = cpipe.infer_serving(batch16, height, thres)
    ref = lite4_pipe.infer_serving(batch16, height, thres)
    np.testing.assert_array_equal(rows, ref)
    log(f"phase S: --checkpoint-dir: the certified Lite4 + W32 pipeline "
        f"({mb:.1f} MB on disk) written by the port's Orbax store in "
        f"{t_write:.3f} s, read in {t_read:.3f} s ({mb / t_read:.1f} MB/s), "
        f"serve.server's pipeline built from it in {t_build:.3f} s (its "
        f"read included); rows equal to the compact checkpoint's at B=16 "
        f"on {card_line()}")
    del cpipe
    n_leaves = check_orbax_fixture()
    log(f"phase S: the committed JAX-written Orbax fixture "
        f"(tests/data/torch_port/orbax_jax/, {n_leaves} leaves: every "
        "dtype, scalars, inline and indirect values, a multi-chunk leaf "
        "with an absent chunk) equals its .npz twin bit for bit")

    # 8. cli.import_weights without TensorFlow (begun at the phase's
    # start): the certified Lite4 from the automl-format TensorBundle
    # directory (two data shards, EMA shadows that must win), the W32 from
    # its official .pth; the checkpoint it wrote served by serve.server's
    # pipeline, rows equal to the compact checkpoint's, one launch of each
    # kernel; the reader and the CRC32C timed in process; then the
    # committed TF-written fixtures, read bit for bit against their twins
    from unittest import mock

    from human_body_proportion_estimation_tpu_torch.models.tf_import import (
        load_tf_checkpoint_arrays,
    )
    from human_body_proportion_estimation_tpu_torch.utils.crc32c import (
        crc32c,
    )

    t0 = time.perf_counter()
    got = load_tf_checkpoint_arrays(edet_dir)
    t_tf_read = time.perf_counter() - t0
    assert sorted(got) == sorted(tf_arrays), len(got)
    for name, want in tf_arrays.items():
        assert got[name].dtype == want.dtype and np.array_equal(
            got[name], want), name
    shards = [np.fromfile(os.path.join(edet_dir, f), np.uint8)
              for f in sorted(os.listdir(edet_dir)) if ".data-" in f]
    assert len(shards) == 2
    t0 = time.perf_counter()
    for blob in shards:
        crc32c(blob)
    crc_gbs = sum(b.nbytes for b in shards) / (time.perf_counter() - t0) / 1e9
    out, err = import_cli.communicate()
    assert import_cli.returncode == 0, (out[-2000:], err[-4000:])
    assert (f"imported EfficientDet-lite4 ({len(tf_arrays)} TF tensors)"
            in out and "imported HRNet" in out), out
    args = srv.build_parser().parse_args(
        ["--detector", "efficientdet_lite4", "--checkpoint-dir", imported])
    ipipe = srv.build_pipeline(args)
    assert ipipe.weights_origin == {"detector": "real", "pose": "real"}
    with counted:
        rows = ipipe.infer_serving(batch16, height, thres)
    assert counted.last == dict.fromkeys(KERNELS, 1), counted.last
    np.testing.assert_array_equal(rows, ref)
    del ipipe
    with mock.patch.dict(sys.modules, {"tensorflow": None}):
        fixtures = load_tests_module("torch_port_tf_fixture").check_fixtures()
    log(f"phase S: automl-format Lite4 TensorBundle ({len(tf_arrays)} "
        f"tensors + {(len(tf_arrays) + 7) // 8} EMA shadows, 2 data shards, "
        f"{tf_mb:.1f} MB) written in {t_tf_write:.3f} s; read by "
        f"load_tf_checkpoint_arrays in {t_tf_read:.3f} s ({tf_mb / t_tf_read:.1f} MB/s, EMA values won); "
        f"CRC32C (utils/crc32c.cpp) {crc_gbs:.2f} GB/s over its data files; "
        f"cli.import_weights --efficientdet-ckpt DIR --hrnet-torch PTH "
        f"{import_cli.wall:.1f} s (begun at the phase's start); served with "
        f"--checkpoint-dir: weights real/real, rows equal to the compact "
        f"checkpoint's at B=16, launches {counted.last}; on {card_line()}")
    log(f"phase S: the committed TF-written fixtures "
        f"(tests/data/torch_port/tf_bundles/, tensorflow blocked) equal "
        f"their twins bit for bit: {json.dumps(fixtures)}")

    # 9. cli.import_weights --efficientdet-saved-model without TensorFlow
    # (begun at the phase's start): the certified Lite4 from its TF1
    # SavedModel (variables restored through the saver's graph, the local
    # one through its Fill), the W32 from its .pth; the checkpoint served
    # as in step 8; the .pb's parse and the whole read timed in process
    from human_body_proportion_estimation_tpu_torch.models import (
        tf_bundle,
        tf_graph,
    )
    from human_body_proportion_estimation_tpu_torch.models.tf_import import (
        load_saved_model_arrays,
    )

    t0 = time.perf_counter()
    pb, meta = tf_bundle.meta_graph(sm_dir)
    n_nodes = len(tf_graph.read_graph(meta[2][0], pb))
    t_parse = time.perf_counter() - t0
    pb_mb = os.path.getsize(pb) / 1e6
    t0 = time.perf_counter()
    got = load_saved_model_arrays(sm_dir)
    t_sm_read = time.perf_counter() - t0
    assert list(got) == list(sm_want), len(got)
    for name, want in sm_want.items():
        assert (got[name].dtype, got[name].shape) == (
            want.dtype, want.shape) and got[name].tobytes() == \
            want.tobytes(), name
    out, err = import_sm_cli.communicate()
    assert import_sm_cli.returncode == 0, (out[-2000:], err[-4000:])
    assert (f"imported EfficientDet-lite4 ({len(sm_want)} TF tensors)"
            in out and "imported HRNet" in out), out
    args = srv.build_parser().parse_args(
        ["--detector", "efficientdet_lite4", "--checkpoint-dir",
         imported_sm])
    spipe = srv.build_pipeline(args)
    assert spipe.weights_origin == {"detector": "real", "pose": "real"}
    with counted:
        rows = spipe.infer_serving(batch16, height, thres)
    assert counted.last == dict.fromkeys(KERNELS, 1), counted.last
    np.testing.assert_array_equal(rows, ref)
    del spipe
    log(f"phase S: TF1 SavedModel of the Lite4 ({len(sm_want)} resource "
        f"variables, {n_nodes} graph nodes, saved_model.pb {pb_mb:.2f} MB, "
        f"{sm_mb:.1f} MB in all, 2 data files) written without TensorFlow "
        f"in {t_sm_write:.3f} s; saved_model.pb parsed in {t_parse:.3f} s; "
        f"read by load_saved_model_arrays in {t_sm_read:.3f} s "
        f"({sm_mb / t_sm_read:.1f} MB/s, parse included); "
        f"cli.import_weights --efficientdet-saved-model DIR --hrnet-torch "
        f"PTH {import_sm_cli.wall:.1f} s (begun at the phase's start); "
        f"served with --checkpoint-dir: weights real/real, rows equal to "
        f"the compact checkpoint's at B=16, launches {counted.last}; on "
        f"{card_line()}")

    # 10. imgs/s at B=16: the SSD slot (bf16, as the server builds it) and
    # Lite4, in turns
    pipe16 = InferencePipeline(det_state=state, device=dev,
                               detector="ssd_mobilenet")
    rates = {"ssd_mobilenet": [], "efficientdet_lite4": []}
    for _ in range(2):
        for name, p in (("ssd_mobilenet", pipe16),
                        ("efficientdet_lite4", lite4_pipe)):
            rates[name].append(imgs_per_s(p, batch16, height, thres))
    with counted:
        pipe16.infer_serving(batch16, height, thres)
    assert counted.last == {"decode_heatmaps": 1, "head_score": 0,
                            "nms_sweep": 1}, counted.last
    log(f"phase S: infer_serving imgs/s at B=16 in turns: "
        f"{json.dumps({n_: [round(r, 2) for r in v] for n_, v in rates.items()})}"  # noqa: E501
        f" on {card_line()}")
    log(f"phase S: {time.perf_counter() - t_phase:.1f} s, launches "
        f"{counted.total}")
    return counted.total


# --------------------------------------------------------------------- #
# phase D: the other slots (EfficientDet-Lite0, HigherHRNet) and their CLIs


def load_tests_module(name="torch_port_slots"):
    """tests/<name>.py (the seeded weights, inputs and summaries the CPU
    tests and the goldens generators share: torch_port_slots,
    torch_port_bottomup), loaded from the file beside this one."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_SEEDED_HIGHER = {}


def seeded_higher(slots, seed, crops):
    """The goldens' seeded HigherHRNet state dict (torch), made on this
    machine's CPU once a run (phases D and U share it)."""
    if seed not in _SEEDED_HIGHER:
        _SEEDED_HIGHER[seed] = slots.to_torch(slots.higher_state(seed, crops))
    return _SEEDED_HIGHER[seed]


def level_features(model, images):
    """The class head's level features z of one forward of `model` (the
    head-score kernel's inputs, NHWC bf16) and the forward's (best,
    person) outputs."""
    import torch

    zs = []
    hook = model.class_net.predict_dw.register_forward_hook(
        lambda m, i, o: zs.append(
            o.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()))
    try:
        with torch.inference_mode():
            best, person, _ = model(images)
    finally:
        hook.remove()
    return zs, (best, person)


def cli_process(repo, module, image, extra, env=None):
    """`python3 -m <port>.cli.<module>` in a subprocess (started, not
    waited for)."""
    return Started(
        [sys.executable, "-m",
         f"human_body_proportion_estimation_tpu_torch.cli.{module}",
         "-i", image, "-o", "", *extra], repo, env=env)


def start_slot_clis(repo):
    """Phase D's CLIs in process mode, begun in subprocesses on the first
    scene: detect_edet with Lite4 and Lite0, pose_est with W32, W48 and
    HigherHRNet, beside other work."""
    scene = os.path.join(DATA, load_tests_module().SCENES[0])
    env = beside_env()
    local = {f"detect_edet {d}": cli_process(repo, "detect_edet", scene,
                                             ["--detector", d], env)
             for d in ("efficientdet_lite4", "efficientdet_lite0")}
    local.update({f"pose_est {m}": cli_process(repo, "pose_est", scene,
                                               ["--model", m], env)
                  for m in ("hrnet_w32", "hrnet_w48", "higherhrnet")})
    return local


def cli_output(proc, what):
    """The frame-0 lines a CLI printed: detect_edet -> [(class, score,
    [y1, x1, y2, x2]), ...]; pose_est -> (keypoints, scores)."""
    import ast
    import re

    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, (what, err[-4000:])
    m = re.search(r"^frame 0: (\d+) detections$", out, re.M)
    if m:
        rows = re.findall(r"^  (\d+) (\S+) (\[.*\])$", out, re.M)
        assert len(rows) == int(m.group(1)), (what, out[-2000:])
        return [(int(c), float(s), ast.literal_eval(b)) for c, s, b in rows]
    m = re.search(r"^frame 0: heatmaps (\[.*?\]) keypoints (\[.*\]) scores "
                  r"(\[.*\])$", out, re.M)
    assert m, (what, out[-2000:])
    return tuple(ast.literal_eval(g) for g in m.groups())


def run_other_slots(k, dev, lite4_pipe, repo, batch=16):
    """Phase D: `--detector efficientdet_lite0`, the HigherHRNet pose slot,
    the registry's `higherhrnet` and the detect_edet / pose_est CLIs on
    the card. Returns the launches of the paths' forwards and requests
    (comparisons excluded). `batch`: the serving batch (16; smaller only
    to rehearse the phase)."""
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (  # noqa: E501
        EFFICIENTDET_LITE0,
        EfficientDet,
    )
    from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (  # noqa: E501
        HigherHRNet,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.detect import (
        EdetDetectPipeline,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
        _pad_batch,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.pose import (
        preprocess_crop_host,
    )
    from human_body_proportion_estimation_tpu_torch.serve import (
        server as srv,
    )
    from human_body_proportion_estimation_tpu_torch.serve.client import (
        HttpClient,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        PipelineConfig,
        PoseConfig,
    )

    t_phase = time.perf_counter()
    slots = load_tests_module()
    scene = os.path.join(DATA, slots.SCENES[0])
    # step 6's CLIs in process mode: begun by main() before phase S, or
    # here
    local = EARLY.pop("D", None) or start_slot_clis(repo)
    with open(os.path.join(DATA, "slot_goldens.json")) as fh:
        golden = json.load(fh)
    g_lite0, g_higher = golden["lite0"], golden["higherhrnet"]
    images = slots.scenes()
    n = len(images)
    crops = slots.crops(images)
    batch16 = [images[i % n] for i in range(batch)]
    height, thres = 175.0, 0.5
    counted = Counted(k)
    figures = {}

    # 1. the goldens' seeded weights, made again on this machine's CPU
    t0 = time.perf_counter()
    lite0_state = slots.to_torch(slots.lite0_state(
        g_lite0["seed"], g_lite0["class_bias"], images))
    higher_state = seeded_higher(slots, g_higher["seed"], crops)
    log(f"phase D: seeded Lite0 (seed {g_lite0['seed']}, class bias "
        f"{g_lite0['class_bias']}) and HigherHRNet (seed {g_higher['seed']}) "
        f"made on the CPU in {time.perf_counter() - t0:.1f} s")

    # 2. f32 forwards (TF32 off) against the JAX goldens
    det32 = EfficientDet(EFFICIENTDET_LITE0, dtype=torch.float32)
    det32.load_state_dict(lite0_state, strict=True)
    detect32 = EdetDetectPipeline(det32.to(dev).eval(),
                                  tuple(g_lite0["input_hw"]))
    with recording_nms(k) as seen:
        with counted:
            dets = detect32(torch.from_numpy(images).to(dev))
    assert counted.last == {"decode_heatmaps": 0, "head_score": 0,
                            "nms_sweep": 1}, counted.last
    check_keep_masks(k, seen, "EdetDetectPipeline")
    box_err = score_err = 0.0
    for i, ref in enumerate(g_lite0["detections"]):
        m = len(ref["scores"])
        scores = dets.scores[i].cpu().numpy()
        keep = dets.valid[i].cpu().numpy() & (
            scores >= g_lite0["det_threshold"])
        assert keep[:m].all() and not keep[m:].any(), (i, keep, ref)
        assert dets.classes[i][:m].cpu().numpy().tolist() == ref["classes"]
        box_err = max(box_err, float(np.abs(dets.boxes[i][:m].cpu().numpy()
                                            - ref["boxes_yxyx"]).max()))
        score_err = max(score_err, float(np.abs(scores[:m]
                                                - ref["scores"]).max()))
    assert box_err <= 0.05 and score_err <= 1e-4, (box_err, score_err)
    higher32 = HigherHRNet(dtype=torch.float32)
    higher32.load_state_dict(higher_state, strict=True)
    higher32 = higher32.to(dev).eval()
    with torch.inference_mode():
        out32 = higher32(torch.from_numpy(crops).to(dev))
    max_err = 0.0
    for name in ("output_1", "output_2"):
        mx, am, _ = slots.heatmap_summary(out32[name].cpu().numpy())
        ref = g_higher[name]
        assert list(out32[name].shape) == ref["shape"], name
        assert am == ref["argmax"], f"{name}: argmax differs from the goldens"
        err = np.abs(np.asarray(mx) - ref["max"])
        assert (err <= 1e-3 + 1e-3 * np.abs(ref["max"])).all(), (name, err)
        max_err = max(max_err, float(err.max()))
    figures["goldens"] = dict(
        lite0_detections=[len(d["scores"]) for d in g_lite0["detections"]],
        lite0_box_err_px=box_err, lite0_score_err=score_err,
        higherhrnet_max_abs_err=max_err)
    log(f"phase D: f32 (TF32 off) vs the JAX goldens: Lite0 "
        f"EdetDetectPipeline at B=3, the same "
        f"{figures['goldens']['lite0_detections']} detections, boxes within "
        f"{box_err:.3g} px, scores within {score_err:.3g}; HigherHRNet at "
        f"384x288, every map's argmax identical, maxima within "
        f"{max_err:.3g}")

    # 3. the Lite0 serving path, as `server --detector efficientdet_lite0`
    # builds it (the certified HRNet-W32, the detector at random and
    # labelled so), with the goldens' seeded Lite0 in place of its own
    args = srv.build_parser().parse_args(["--detector", "efficientdet_lite0"])
    lpipe = srv.build_pipeline(args)
    assert lpipe.weights_origin == {"detector": "random",
                                    "pose": "synthetic-certified"}, \
        lpipe.weights_origin
    detector = lpipe.backend.detector
    assert detector.config == EFFICIENTDET_LITE0
    detector.load_state_dict(lite0_state, strict=True)
    with recording_nms(k) as seen:
        with counted:
            packed = lpipe.infer_serving(batch16, height, thres)
            for img in images:
                lpipe.infer_images([img], height, thres)
    forwards = 1 + n
    assert counted.last == dict.fromkeys(KERNELS, forwards), counted.last
    shapes = check_keep_masks(k, seen, "Lite0 serving forwards")
    assert sorted(shapes) == sorted([((batch, 128), False)]
                                    + [((1, 128), False)] * n), shapes
    assert packed.shape == (batch, 3, 23) and np.isfinite(packed).all()
    for i in range(batch):
        np.testing.assert_array_equal(packed[i], packed[i % n])
    # the head-score kernel at F = 64 on the forward's own level features
    x16 = torch.from_numpy(np.stack(batch16)).to(dev).float()
    zs16, _ = level_features(detector, x16)
    zs1, _ = level_features(detector, x16[:1])
    w_cls, b_cls = detector._class_predict_params()
    assert [z.shape[-1] for z in zs16] == [64] * 5
    hs_err, n_person = 0.0, 0
    for name, zs in ((f"B={batch}", zs16), ("B=1", zs1)):
        e, p = head_score_agrees(
            k.head_score_levels(zs, w_cls, b_cls, 9, 90, 0),
            k.head_score_levels_plain(zs, w_cls, b_cls, 9, 90, 0),
            f"head_score_levels F=64 {name}")
        hs_err, n_person = max(hs_err, e), n_person + p
    figures["lite0_persons"] = int((packed[:n, :, 0] > 0.5).sum())
    log(f"phase D: Lite0 serving (/health {lpipe.weights_origin}): "
        f"{forwards} forwards, launches {counted.last} (1 / 1 / 1 a "
        f"forward); the {len(seen)} keep masks equal the plain version's; "
        f"head_score at F = 64 (launch<2>) on the forward's own level "
        f"features, B=16 and B=1: max |err| {hs_err:.3g} against plain, "
        f"{n_person} person-argmax anchors; {figures['lite0_persons']} "
        f"persons in the 3 scenes")

    # 4. the HigherHRNet pose slot: heatmaps at 1/2 of the 384x288 crops
    cfg = PipelineConfig(pose=PoseConfig(name="higherhrnet",
                                         heatmap_height=192,
                                         heatmap_width=144))
    hpipe = InferencePipeline(cfg, device=dev, detector="efficientdet_lite4")
    assert hpipe.weights_origin == {"detector": "synthetic-certified",
                                    "pose": "random"}, hpipe.weights_origin
    hpipe.pose.load_state_dict(
        {"higher." + key: v for key, v in higher_state.items()}, strict=True)
    maps = []
    hook = hpipe.pose.register_forward_hook(lambda m, i, o: maps.append(o))
    try:
        with counted:
            hpacked = hpipe.infer_serving(batch16, height, thres)
    finally:
        hook.remove()
    assert counted.last == dict.fromkeys(KERNELS, 1), counted.last
    assert hpacked.shape == (batch, 3, 23) and np.isfinite(hpacked).all()
    hm = maps[0].contiguous()
    assert tuple(hm.shape) == (3 * batch, 17, 192, 144), hm.shape
    kp, sc = k.decode_heatmaps(hm)
    kp_p, sc_p = k.decode_heatmaps_plain(hm)
    torch.cuda.synchronize()
    assert torch.equal(kp, kp_p) and torch.equal(sc, sc_p), \
        "decode [48,17,192,144]: kernel differs from plain"
    hm_nan = hm.clone()
    hm_nan[0, 3] = float("nan")                       # an all-NaN map
    hm_nan[1, 1, 100, 70] = float("nan")              # one NaN in a map
    hm_nan[2, 2, 191, 143] = float("inf")             # +inf alone, last
    kp_n, sc_n = k.decode_heatmaps(hm_nan)
    kp_pn, sc_pn = k.decode_heatmaps_plain(hm_nan)
    torch.cuda.synchronize()
    assert int(sc_pn.isnan().sum()) == 2
    assert torch.equal(kp_n, kp_pn) and torch.equal(sc_n.isnan(),
                                                    sc_pn.isnan())
    assert torch.equal(torch.nan_to_num(sc_n, nan=0.0),
                       torch.nan_to_num(sc_pn, nan=0.0))
    log(f"phase D: HigherHRNet pose slot at B=16 (/health "
        f"{hpipe.weights_origin}, the goldens' seeded HigherHRNet loaded): "
        f"launches {counted.last}; decode [48,17,192,144] (15 bulk-copy "
        f"chunks a map) equals plain on the forward's own maps and with NaN "
        f"maps")

    # 5. the registry's higherhrnet (the pose slot's module) over HTTP
    # binary_tensor_data and hbpe gRPC: each request one launch, equal to
    # the forward of its rows zero-padded to the launch bucket
    missing = grpc_modules()
    happ = srv.ServingApp(hpipe)
    grpc_server = None
    rng = np.random.default_rng(5)
    requests = [rng.uniform(0, 1, (r, 3, 384, 288)).astype(np.float32)
                for r in (1, 2, 3)]
    with served(happ) as port:
        http = HttpClient("127.0.0.1", port)
        clients = {"http": http.infer}
        if not missing:
            from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (  # noqa: E501
                GrpcClient,
                create_grpc_server,
            )

            grpc_server, gport = create_grpc_server(happ, "127.0.0.1", 0)
            grpc_server.start()
            hbpe = GrpcClient(f"127.0.0.1:{gport}")
            clients["hbpe"] = hbpe.infer
        try:
            index = {r["name"]: r["weights"] for r in http.models()["models"]}
            assert index["higherhrnet"] == "random", index
            meta = http.model_metadata("higherhrnet")
            assert [t["shape"] for t in meta["outputs"]] == [
                [-1, 34, -1, -1], [-1, 17, -1, -1]], meta
            for via, infer in clients.items():
                for x in requests:
                    with counted:
                        got = infer("higherhrnet", {"input": x})
                    assert counted.last == dict.fromkeys(KERNELS, 0)
                    b = _pad_batch(len(x), cfg.serve.max_batch)
                    xp = np.concatenate([x, np.zeros((b - len(x),) + x.shape[1:],
                                                     np.float32)])
                    with torch.inference_mode():
                        ref = hpipe.pose.higher(torch.from_numpy(xp).to(dev))
                    for name in ("output_1", "output_2"):
                        np.testing.assert_array_equal(
                            got[name], ref[name][:len(x)].cpu().numpy(),
                            err_msg=f"{via} {name} rows {len(x)}")
        finally:
            if grpc_server is not None:
                hbpe.close()
                grpc_server.stop(0)
    log(f"phase D: registry higherhrnet over {', '.join(clients)}: requests "
        f"of 1, 2 and 3 rows at 384x288, each equal to the forward of its "
        f"rows zero-padded to the launch bucket (output_1 [n,34,96,72], "
        f"output_2 [n,17,192,144])")

    # 6. the CLIs in subprocesses: in process, then with -g against the
    # Lite0 server's gRPC edge (edetlite4 runs the serving Lite0, hrnet the
    # certified W32, higherhrnet a seeded random HigherHRNet); each remote
    # answer against the registry's forward here at the same batch size;
    # the CLIs in process mode began before
    printed = {what: cli_output(p, what) for what, p in local.items()}
    for what, out in printed.items():
        if what.startswith("pose_est"):
            shape = [17, 192, 144] if "higher" in what else [17, 96, 72]
            assert out[0] == shape, (what, out[0])
    lapp = srv.ServingApp(lpipe)
    remote = {}
    if not missing:
        grpc_server, gport = create_grpc_server(lapp, "127.0.0.1", 0)
        grpc_server.start()
        target = f"127.0.0.1:{gport}"
        try:
            procs = {
                "edetlite4": cli_process(repo, "detect_edet", scene,
                                    ["-g", target]),
                "hrnet": cli_process(repo, "pose_est", scene,
                                ["--model", "hrnet_w32", "-g", target]),
                "higherhrnet": cli_process(repo, "pose_est", scene,
                                      ["--model", "higherhrnet", "-g",
                                       target]),
            }
            remote = {name: cli_output(p, f"-g {name}")
                      for name, p in procs.items()}
            img = images[0]
            with counted:
                raw = lapp.registry.infer("edetlite4", {"image": img[None]})
            want = [(int(c), float(s), b) for b, s, c in zip(
                raw["output_0"][0], raw["output_1"][0], raw["output_2"][0])
                if s > 0 and s >= 0.6]
            got = remote["edetlite4"]
            assert len(got) == len(want), (got, want)
            for (gc, gs, gb), (wc, ws, wb) in zip(got, want):
                assert gc == wc and abs(gs - ws) <= 1e-6, (got, want)
                assert np.abs(np.asarray(gb) - wb).max() <= 1e-3, (gb, wb)
            for name, out, size in (("hrnet", "output", (288, 384)),
                                    ("higherhrnet", "output_2", (512, 512))):
                x = preprocess_crop_host(img, *size)[None].transpose(
                    0, 3, 1, 2)
                hm_reg = lapp.registry.infer(name, {"input": np.ascontiguousarray(
                    x)})[out][0]
                flat = hm_reg.reshape(17, -1)
                idx = flat.argmax(-1)
                kp_want = [[int(i % hm_reg.shape[-1]),
                            int(i // hm_reg.shape[-1])] for i in idx]
                g_shape, g_kp, g_sc = remote[name]
                assert g_shape == list(hm_reg.shape), (name, g_shape)
                assert g_kp == kp_want, (name, g_kp, kp_want)
                assert np.abs(np.asarray(g_sc) - flat.max(-1)).max() <= 1e-6
        finally:
            grpc_server.stop(0)
    lapp.shutdown()
    log(f"phase D: the CLIs exit 0 in process: "
        + "; ".join(f"{w}: " + (f"{len(o)} detections" if "detect" in w
                                else f"heatmaps {o[0]}")
                    for w, o in printed.items())
        + ("" if missing else
           f"; with -g: edetlite4 {len(remote['edetlite4'])} detections, "
           "hrnet and higherhrnet keypoints and scores, each equal to the "
           "registry's forward here at batch size 1"))

    # 7. times: the serving forward, Lite0 beside Lite4 in turns; the
    # kernels at the new shapes, replayed from a CUDA graph, beside their
    # bounds and the library call
    rates = {"efficientdet_lite0": [], "efficientdet_lite4": []}
    for _ in range(2):
        rates["efficientdet_lite4"].append(imgs_per_s(lite4_pipe, batch16,
                                                      height, thres))
        rates["efficientdet_lite0"].append(imgs_per_s(lpipe, batch16,
                                                      height, thres))
    a, c, f = 9, 90, 64
    # the library call takes the weight in the features' bf16, as the
    # kernel's packing holds it
    w_lib = w_cls.to(torch.bfloat16)

    def library(zs):
        for z in zs:
            torch.matmul(z, w_lib.t()).view(*z.shape[:3], a, c).amax(-1)

    times = {}
    for name, zs in (("B=16", zs16), ("B=1", zs1)):
        m_rows = sum(z.shape[0] * z.shape[1] * z.shape[2] for z in zs)
        b_ms, b_by = bound(m_rows * f * 2 + w_cls.numel() * 2
                           + b_cls.numel() * 4 + 2 * m_rows * a * 4,
                           2.0 * m_rows * f * a * c, BF16_FLOP_PER_S)
        times[f"head_score F=64 {name}"] = dict(
            graph_ms=graph_ms(lambda zs=zs: k.head_score_levels(
                zs, w_cls, b_cls, a, c, 0), 20),
            ms=cuda_ms(lambda zs=zs: k.head_score_levels(
                zs, w_cls, b_cls, a, c, 0), 50),
            bound_ms=b_ms, bound_by=b_by,
            library_graph_ms=graph_ms(lambda zs=zs: library(zs), 20),
            plain_ms=cuda_ms(lambda zs=zs: k.head_score_levels_plain(
                zs, w_cls, b_cls, a, c, 0), 10))
    b_ms, b_by = bound(hm.numel() * 4 + kp.numel() * 4 + sc.numel() * 4,
                       hm.numel(), F32_FLOP_PER_S)
    times["decode [48,17,192,144]"] = dict(
        graph_ms=graph_ms(lambda: k.decode_heatmaps(hm), 100),
        ms=cuda_ms(lambda: k.decode_heatmaps(hm), 200),
        bound_ms=b_ms, bound_by=b_by,
        library_graph_ms=graph_ms(lambda: torch.max(hm.flatten(2), -1), 100),
        plain_ms=cuda_ms(lambda: k.decode_heatmaps_plain(hm), 20))
    log(f"phase D: infer_serving B=16 imgs/s in turns: {json.dumps(rates)}")
    log(f"phase D kernel times (ms; graph = replayed from a CUDA graph, "
        f"library = matmul+amax / torch.max): {json.dumps(times)}")
    log(f"phase D card: {card_line()}")
    log(f"phase D: {time.perf_counter() - t_phase:.1f} s, launches "
        f"{counted.total}")
    return counted.total


# --------------------------------------------------------------------- #
# phase U: bottom-up pose (ROADMAP item 13)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def server_process(repo, args, timeout=600):
    """`python3 -m <port>.serve.server <args>` in a subprocess: yields the
    lines it printed once it prints "serving on" (and keeps collecting);
    terminated, then killed, on the way out."""
    import queue
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m",
         "human_body_proportion_estimation_tpu_torch.serve.server", *args],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines, fresh = [], queue.Queue()

    def read():
        for line in proc.stdout:
            lines.append(line)
            fresh.put(line)
        fresh.put(None)

    threading.Thread(target=read, daemon=True).start()
    try:
        deadline = time.time() + timeout
        while True:
            line = fresh.get(timeout=max(deadline - time.time(), 0.1))
            assert line is not None, "server exited:\n" + "".join(lines[-40:])
            if line.startswith("serving on"):
                break
        yield lines
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def first_person(row):
    """A packed [P, 23] row -> the file route's cm dict of its first valid
    slot ({} without one)."""
    from human_body_proportion_estimation_tpu_torch.ops import (
        proportions as prop_ops,
    )

    valid = [s for s in row if s[0] > 0.5]
    return {} if not valid else prop_ops.to_dist_dict(valid[0][1:12],
                                                      valid[0][12:] > 0.5)


def grouping_equal(got, ref):
    """Two groupings (tensors or nested lists) equal field for field, NaN
    where NaN."""
    import numpy as np

    for field in ("keypoints", "scores", "valid"):
        a = np.asarray(getattr(got, field).cpu() if hasattr(got, field)
                       else got[field])
        b = np.asarray(getattr(ref, field).cpu() if hasattr(ref, field)
                       else ref[field], dtype=a.dtype)
        if not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            return False
    return True


def count_launches(fn):
    """(CUDA kernel and memory-op events, device busy ms) of one call of
    `fn` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(cuda), sum(e.device_time_total for e in cuda) / 1e3


def run_bottom_up(k, dev, repo, batch=16):
    """Phase U: the bottom-up pipeline (HigherHRNet + AE grouping) on the
    card: the decode cases and the f32 forward against the JAX goldens,
    the served bf16 form at B=16 and B=1 (times, a profile, the decode's
    launches), `serve.server --bottom-up` in a subprocess (file route under
    load, video route, registry higherhrnet over HTTP and hbpe, hbpe
    Estimate), the registry sharing the module, and `detect_pose_bottomup`
    in a subprocess. Returns the launches of the bottom-up forwards
    (none: no kernel of the port is on this path)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.ops import (
        ae_grouping as ae,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
        BottomUpPipeline,
        prepare_batch_bottomup,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        _pad_batch,
    )
    from human_body_proportion_estimation_tpu_torch.serve import (
        server as srv,
    )
    from human_body_proportion_estimation_tpu_torch.serve.client import (
        HttpClient,
    )
    from human_body_proportion_estimation_tpu_torch.serve.registry import (
        build_registry,
    )

    t_phase = time.perf_counter()
    slots = load_tests_module()
    bu = load_tests_module("torch_port_bottomup")
    with open(os.path.join(DATA, "bottomup_goldens.json")) as fh:
        golden = json.load(fh)
    # step 7's CLI begins now, beside the steps before it
    cli_out = tempfile.mkdtemp(prefix="phase_u_")
    cli = Started(
        [sys.executable, "-m",
         "human_body_proportion_estimation_tpu_torch.cli."
         "detect_pose_bottomup", "-i",
         os.path.join(DATA, golden["scenes"][0]), "-o", cli_out], repo,
        env=beside_env())
    images = slots.scenes()
    n = len(images)
    scene_bytes = []
    for name in golden["scenes"]:
        with open(os.path.join(DATA, name), "rb") as fh:
            scene_bytes.append(fh.read())
    height, thres = golden["height_cm"], 0.7
    counted = Counted(k)
    zero = dict.fromkeys(KERNELS, 0)
    figures = {}

    # 1. the decode cases on the card: JAX's grouping bit for bit
    for name, heat, tags, kw in bu.decode_cases():
        got = ae.decode_bottom_up(torch.from_numpy(heat).to(dev),
                                  torch.from_numpy(tags).to(dev), **kw)
        assert grouping_equal(got, golden["decode_cases"][name]), name
    log(f"phase U: the AE decode on the card equals JAX's on the "
        f"{len(golden['decode_cases'])} decode cases bit for bit (ties, "
        f"plateaus, NaN and inf maps included)")

    # 2. f32 (TF32 off), the goldens' seeded HigherHRNet
    state = seeded_higher(slots, golden["seed"], slots.crops(images))
    fpipe = BottomUpPipeline(pose_state=state, device=dev,
                             dtype=torch.float32)
    batch_u8, heights, orig_hw, _ = prepare_batch_bottomup(
        list(images), height, n, fpipe.max_people, fpipe.INPUT_HW)
    with counted, torch.inference_mode():
        heat, tags = fpipe.aggregate(torch.from_numpy(batch_u8).to(dev))
    assert counted.last == zero, counted.last
    rel = 0.0
    for name, maps in (("heat", heat), ("tags", tags)):
        mx, am, _ = slots.heatmap_summary(maps.cpu().numpy())
        ref = golden["maps"][name]
        assert am == ref["argmax"], f"{name}: an argmax differs"
        err = np.abs(np.asarray(mx) - np.asarray(ref["max"]))
        assert (err <= 1e-3 + 1e-3 * np.abs(ref["max"])).all(), (
            name, float(err.max()))
        # relative to each map's largest magnitude, as the goldens' noise
        rel = max(rel, float((err / np.asarray(ref["absmax"])).max()))
    figures["f32_maxima_rel_err"] = rel
    held = {}
    for name, config in golden["configs"].items():
        for attr, value in config["decode"].items():
            setattr(fpipe, attr, value)
        kw = dict(config["decode"])
        on_card = ae.decode_bottom_up(heat, tags, **kw)
        on_cpu = ae.decode_bottom_up(heat.cpu(), tags.cpu(), **kw)
        assert grouping_equal(on_card, on_cpu), \
            f"{name}: the card's decode differs from the CPU's"
        with counted:
            out = fpipe.infer_images(list(images), person_heights=height)
            packed = fpipe.infer_serving(list(images), person_heights=height)
        assert counted.last == zero, counted.last
        ref_out, ref_packed = config["outputs"], np.asarray(config["packed"])
        same = dict(
            person_valid=bool(np.array_equal(out.person_valid,
                                              ref_out["person_valid"])),
            keypoints=bool(np.array_equal(out.keypoints,
                                           np.asarray(ref_out["keypoints"],
                                                      np.float32))),
            seg_visible=bool(np.array_equal(packed[..., 12:],
                                             ref_packed[..., 12:])))
        cm_err = float(np.abs(packed[..., 1:12] - ref_packed[..., 1:12]).max())
        # the decode's decisions are held to JAX's where the card's maxima
        # lie within the noise the goldens' decode withstood
        held[name] = rel <= config["stable_noise"]
        if held[name]:
            assert all(same.values()), (name, same)
            assert cm_err <= 1e-3 * max(1.0, float(np.abs(ref_packed).max())), \
                (name, cm_err)
        figures[f"f32_{name}"] = dict(
            **same, max_abs_cm_err=cm_err, persons=int(out.person_valid.sum()),
            segments=int(packed[..., 12:].sum()),
            stable_noise=config["stable_noise"], held=held[name])
    log(f"phase U: f32 (TF32 off) seeded HigherHRNet at 512x512 vs the JAX "
        f"goldens: every argmax of the aggregated heat and tags identical, "
        f"maxima within {rel:.3g} relative; the card's decode of its maps "
        f"equals the port's CPU decode of them; outputs "
        f"{json.dumps({k_: figures[f'f32_{k_}'] for k_ in held})}")

    # 3. the served form: bf16, random from flax's PRNGKey(0) init (what
    # `serve.server --bottom-up` builds without the certified checkpoint)
    bpipe = BottomUpPipeline(device=dev)
    assert bpipe.weights_origin == {"pose": "random"}
    batch16 = [images[i % n] for i in range(batch)]
    with counted:
        p16 = bpipe.infer_serving(batch16, height)
        p1 = [bpipe.infer_serving([img], height) for img in images]
    assert counted.last == zero, counted.last
    assert p16.shape == (batch, 3, 23) and np.isfinite(p16).all()
    for i in range(batch):
        np.testing.assert_array_equal(p16[i], p16[i % n])
    assert all(p.shape == (1, 3, 23) and np.isfinite(p).all() for p in p1)
    figures["bf16_persons_b16"] = int((p16[:n, :, 0] > 0.5).sum())
    figures["imgs_per_s"] = {
        "B=16": imgs_per_s(bpipe, batch16, height, thres),
        "B=1": imgs_per_s(bpipe, [images[0]], height, thres, iters=16)}
    wall, busy, stages = profile_serving(bpipe, batch16, height, thres,
                                         out_name="bottomup_profile_b16.txt")
    figures["profile_b16"] = dict(wall_ms=wall, device_busy_ms=busy,
                                  stages=stages)
    b16, h16, o16, _ = prepare_batch_bottomup(batch16, height, batch, 3,
                                              bpipe.INPUT_HW)
    with torch.inference_mode():
        args = [torch.from_numpy(a).to(dev) for a in (b16, h16, o16)]
        heat16, tags16 = bpipe.aggregate(args[0])
        launches, decode_busy = count_launches(
            lambda: bpipe.decode(heat16, tags16, *args[1:]))
        model_launches, model_busy = count_launches(
            lambda: bpipe.aggregate(args[0]))
        decode_ms = cuda_ms(lambda: bpipe.decode(heat16, tags16, *args[1:]),
                            10)
    figures["decode_b16"] = dict(
        cuda_events=launches, device_busy_ms=decode_busy,
        ms_launched_eagerly=decode_ms, model_cuda_events=model_launches,
        model_device_busy_ms=model_busy)
    log(f"phase U: bf16 served form: B=16 and B=1 forwards, launches "
        f"{counted.last}; imgs/s {json.dumps(figures['imgs_per_s'])}; "
        f"profile B=16 {json.dumps(figures['profile_b16'])}; decode at B=16 "
        f"{json.dumps(figures['decode_b16'])}")

    # 4. the registry's higherhrnet is the pipeline's module
    reg = build_registry(bpipe)
    calls = []
    hook = bpipe.model.register_forward_hook(lambda *a: calls.append(1))
    x1 = np.random.default_rng(8).uniform(0, 1, (1, 3, 512, 512)).astype(
        np.float32)
    try:
        with counted:
            reg.infer("higherhrnet", {"input": x1})
    finally:
        hook.remove()
        reg.shutdown()
    assert calls == [1] and counted.last == zero, (calls, counted.last)

    # 5. the serving edge over the goldens' seeded weights in bf16 with the
    # wide tag threshold (the random HigherHRNet finds nobody: its peaks
    # stay near 0.1, under the person gate): 16 file-route requests from 4
    # clients, each answer equal to its scene's in-process forward at one
    # of the batch sizes 1, 2, 4 (bf16 rounds by batch size)
    spipe = BottomUpPipeline(pose_state=state, device=dev,
                             **golden["configs"]["wide"]["decode"])
    srefs = {(s, b): first_person(spipe.infer_serving([images[s]] * b,
                                                      height)[0])
             for s in range(n) for b in (1, 2, 4)}
    with served(srv.ServingApp(spipe)) as port:
        m0 = http_json(port, "GET", "/metrics")
        with counted:
            answers, wall = post_load(port, scene_bytes, [int(height)] * 16,
                                      thres, 4)
        m1 = http_json(port, "GET", "/metrics")
    assert counted.last == zero, counted.last
    numbers, sizes = 0, []
    for i, r in enumerate(answers):
        assert r["code"] == "success", r
        cm = r["body_proportion_lengths_(cm)"]
        match = [b for b in (1, 2, 4) if srefs[(i % n, b)] == cm]
        assert match, (i, cm, [srefs[(i % n, b)] for b in (1, 2, 4)])
        sizes.append(match[0])
        numbers += sum(isinstance(v, float) for v in cm.values())
    assert numbers > 0, answers
    figures["seeded_server"] = load_summary(m0, m1, wall, 16)
    log(f"phase U: the serving edge over the seeded bf16 pipeline (tag "
        f"threshold 1000): 16 requests from 4 clients, every answer equal "
        f"to its scene's in-process forward at batch size "
        f"{sorted(set(sizes))}, {numbers} cm values: "
        f"{json.dumps(figures['seeded_server'])}")

    # 6. `serve.server --bottom-up` (the default detector) in a subprocess,
    # random from flax's PRNGKey(0) init as `bpipe`: /health, the file route
    # under 16 requests from 4 clients (each answer equal to its scene's
    # in-process forward at batch size 1, 2 or 4), the video route, the
    # registry's higherhrnet over HTTP and hbpe, hbpe Estimate
    missing = grpc_modules()
    http_port = free_port()
    grpc_port = 0 if missing else free_port()
    refs = {(s, b): first_person(bpipe.infer_serving([images[s]] * b,
                                                     height)[0])
            for s in range(n) for b in (1, 2, 4)}
    t0 = time.perf_counter()
    with server_process(repo, ["--bottom-up", "--host", "127.0.0.1",
                               "--port", str(http_port), "--grpc-port",
                               str(grpc_port), "--prewarm"]) as printed:
        started = time.perf_counter() - t0
        text = "".join(printed)
        assert "WARNING: serving RANDOM-INIT HigherHRNet" in text, text
        health = http_json(http_port, "GET", "/health")
        assert health["weights"] == {"pose": "random"}, health
        assert health["prewarmed"] is True, health
        m0 = http_json(http_port, "GET", "/metrics")
        answers, wall = post_load(http_port, scene_bytes,
                                  [int(height)] * 16, thres, 4)
        m1 = http_json(http_port, "GET", "/metrics")
        sizes = []
        for i, r in enumerate(answers):
            assert r["code"] == "success", r
            cm = r["body_proportion_lengths_(cm)"]
            match = [b for b in (1, 2, 4) if refs[(i % n, b)] == cm]
            assert match, (i, cm, [refs[(i % n, b)] for b in (1, 2, 4)])
            sizes.append(match[0])
        figures["server"] = load_summary(m0, m1, wall, 16)
        figures["server"]["startup_s"] = started
        clip = mjpg_clip(scene_bytes, n_frames=6)
        video = http_json(http_port, "POST",
                          "/body_proportion_length_estimation_video",
                          {"file": (clip, "clip.avi"),
                           "person_height_in_cm": int(height)})
        assert video["code"] == "success", video
        assert [f["frame"] for f in video["frames"]] == list(range(6))
        clients = {"http": HttpClient("127.0.0.1", http_port).infer}
        if not missing:
            from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (  # noqa: E501
                GrpcClient,
            )

            hbpe = GrpcClient(f"127.0.0.1:{grpc_port}")
            clients["hbpe"] = hbpe.infer
        try:
            http = HttpClient("127.0.0.1", http_port)
            index = {r["name"]: r["weights"] for r in http.models()["models"]}
            assert index["higherhrnet"] == "random", index
            # the SSD is registered whatever the slot, its tflite's label
            assert index["ssd_mobilenet"] == "real", index
            rng = np.random.default_rng(9)
            for via, infer in clients.items():
                for rows in (1, 2, 3):
                    x = rng.uniform(0, 1, (rows, 3, 512, 512)).astype(
                        np.float32)
                    got = infer("higherhrnet", {"input": x})
                    b = _pad_batch(rows, bpipe.config.serve.max_batch)
                    xp = np.concatenate([x, np.zeros((b - rows, 3, 512, 512),
                                                     np.float32)])
                    with torch.inference_mode():
                        ref = bpipe.model(torch.from_numpy(xp).to(dev))
                    for name in ("output_1", "output_2"):
                        np.testing.assert_array_equal(
                            got[name], ref[name][:rows].cpu().numpy(),
                            err_msg=f"{via} {name} rows {rows}")
            if not missing:
                est = hbpe.estimate(scene_bytes[0], height, thres)
                assert est["body_proportion_lengths_(cm)"] == refs[(0, 1)], \
                    est
        finally:
            if not missing:
                hbpe.close()
    log(f"phase U: serve.server --bottom-up (default --detector "
        f"ssd_mobilenet) up in {started:.1f} s with --prewarm; 16 requests "
        f"from 4 clients, every answer equal to its scene's in-process "
        f"forward at batch size {sorted(set(sizes))}: "
        f"{json.dumps(figures['server'])}; video route 6 frames; registry "
        f"higherhrnet over {', '.join(clients)} equal to the pipeline's "
        f"module on rows padded to the bucket"
        + ("" if missing else "; hbpe Estimate equals the B=1 forward"))

    # 7. the CLI in a subprocess (begun at the phase's start): as many cm
    # dicts as the in-process forward finds persons in the scene, and its
    # rendering
    cli_stdout, cli_err = cli.communicate()
    assert cli.returncode == 0, cli_err[-4000:]
    frames = os.listdir(os.path.join(cli_out, "tpu_bottomup_pose"))
    shutil.rmtree(cli_out, ignore_errors=True)
    assert frames == ["frame_000000.jpg"], frames
    with counted:
        want = int(bpipe.infer_images([images[0]]).person_valid.sum())
    assert counted.last == zero, counted.last
    assert cli_stdout.count("'shoulder':") == want, (cli_stdout[-2000:],
                                                     want)
    log(f"phase U: detect_pose_bottomup exits 0 with {want} person(s) "
        f"printed and frame_000000.jpg rendered, as the in-process forward")
    log(f"phase U card: {card_line()}")
    log(f"phase U: {time.perf_counter() - t_phase:.1f} s, launches "
        f"{counted.total}")
    return counted.total


# --------------------------------------------------------------------- #
# phase E: the evaluate CLI (ROADMAP item 14)


def one_match_figure(calls):
    """From the (name, args) of run_eval's detection_ap and oks_ap calls:
    for each, the most that turning one match into a miss, or one miss
    into a match, at one threshold changes the AP there (over every
    detection and threshold)."""
    import numpy as np

    from human_body_proportion_estimation_tpu_torch.metrics import (
        average_precision,
        match_image,
    )
    from human_body_proportion_estimation_tpu_torch.metrics import (
        pose as pose_metrics,
    )
    from human_body_proportion_estimation_tpu_torch.metrics.detection import (
        IOU_SWEEP,
    )

    out = {}
    for name, args in calls:
        preds, gts = args[0], args[1]
        n_gt = sum(len(g[0]) if name == "oks_ap" else len(g) for g in gts)
        worst = 0.0
        for thr in IOU_SWEEP:
            scores, tps = [], []
            for (a, s), g in zip(preds, gts):
                s = np.asarray(s, np.float32).reshape(-1)
                scores.append(s)
                if name == "oks_ap":
                    tps.append(pose_metrics._match_image_oks(
                        np.asarray(a, np.float32), s, *(np.asarray(v)
                                                        for v in g), thr))
                else:
                    tps.append(match_image(
                        np.asarray(a, np.float32).reshape(-1, 4), s,
                        np.asarray(g, np.float32).reshape(-1, 4), thr))
            scores, tp = np.concatenate(scores), np.concatenate(tps)
            base = average_precision(scores, tp, n_gt)
            for i in range(len(tp)):
                flipped = tp.copy()
                flipped[i] = not flipped[i]
                worst = max(worst, abs(average_precision(scores, flipped,
                                                         n_gt) - base))
        out[name] = worst
    return out


def start_evaluate(repo):
    """Phase E's `cli.evaluate` begun in a subprocess."""
    return Started(
        [sys.executable, "-m",
         "human_body_proportion_estimation_tpu_torch.cli.evaluate",
         "--annotations", os.path.join(DATA, "scenes_coco.json"),
         "--images-dir", DATA, "--detector", "efficientdet_lite4"], repo,
        env=beside_env())


def run_evaluate(k, lite4_pipe, repo):
    """Phase E: `cli.evaluate --detector efficientdet_lite4` in a
    subprocess on the committed scenes and their COCO ground truth, against
    JAX's run_eval of the certified pipeline (scenes_coco.json) and the
    same run in process. Returns the in-process run's launches."""
    import math

    import human_body_proportion_estimation_tpu_torch.metrics as metrics
    from human_body_proportion_estimation_tpu_torch.cli import evaluate

    t_phase = time.perf_counter()
    path = os.path.join(DATA, "scenes_coco.json")
    with open(path) as fh:
        jax_result = json.load(fh)["jax_run_eval"]
    # begun by main() before phase C, or here
    proc = EARLY.pop("E", None) or start_evaluate(repo)
    out, err = proc.communicate()
    wall = proc.wall
    assert proc.returncode == 0, err[-4000:]
    result = json.loads(out.strip().splitlines()[-1])

    # the same run in process, recording what reaches the metrics
    calls, plain = [], {}
    for name in ("detection_ap", "oks_ap"):
        plain[name] = getattr(metrics, name)
        setattr(metrics, name, lambda *a, _n=name, **kw: (
            calls.append((_n, a)), plain[_n](*a, **kw))[1])
    counted = Counted(k)
    try:
        with counted:
            inproc = evaluate.run_eval(lite4_pipe, path, DATA)
    finally:
        for name, fn in plain.items():
            setattr(metrics, name, fn)
    assert counted.last == dict.fromkeys(KERNELS, 1), counted.last
    assert {key: v for key, v in result.items() if key != "detector"} == \
        inproc, (result, inproc)
    assert result["weights"] == {"detector": "synthetic-certified",
                                 "pose": "synthetic-certified"}, result
    assert result["images"] == 3 and result["missing_files"] == 0, result
    flip = one_match_figure(calls)
    bounds = {"box_AP50": 0.0, "kp_AP50": 0.0,
              "box_AP75": flip["detection_ap"], "kp_AP75": flip["oks_ap"],
              "box_mAP": flip["detection_ap"] / 10,
              "kp_mAP": flip["oks_ap"] / 10,
              "PCK@0.1diag": 1.0 / 51}
    diffs = {}
    for key, bound_ in bounds.items():
        got, ref = result[key], jax_result[key]
        assert not math.isnan(got) and 0.0 <= got <= 1.0, (key, got)
        diffs[key] = abs(got - ref)
        assert diffs[key] <= bound_ + 1e-12, (key, got, ref, bound_)
    log(f"phase E: cli.evaluate --detector efficientdet_lite4 on the 3 "
        f"scenes in {wall:.1f} s (subprocess, its start included): "
        f"{json.dumps(result)}; JAX {json.dumps(jax_result)}; AP50 equal, "
        f"every other figure within one match at one threshold (the most "
        f"one match changes an AP here: box {flip['detection_ap']:.4f}, "
        f"keypoints {flip['oks_ap']:.4f}; mAP a tenth of it; PCK one "
        f"keypoint of 51): |diff| {json.dumps(diffs)}; in process equal, "
        f"launches {counted.last}")
    log(f"phase E: {time.perf_counter() - t_phase:.1f} s")
    return counted.total


# --------------------------------------------------------------------- #
# phase T: training (ROADMAP item 15)

TRAIN_KINDS = ("pose", "det", "bottomup")
# the throughput batches: pose B=16 (certify's --pose-batch), Lite0
# detection B=8 (--det-batch) and bottom-up B=8 (certify_bottomup --batch)
TRAIN_BATCH = {"pose": 16, "det": 8, "bottomup": 8}
# the certify CLIs' budget in phase T: the losses are means over chunks of
# 100 steps, so 120 steps give a first and a last to compare
CERTIFY_STEPS = 120
CERTIFY_KEYS = {"mode", "platform", "img_hw", "crop_hw", "pose_loss_first",
                "pose_loss_last", "gate_gamma", "det_loss_first",
                "det_loss_last", "pose_val", "det_val", "served",
                "coco_eval", "gates", "certified", "wall_s"}
CERTIFY_BU_KEYS = {"mode", "platform", "input_hw", "max_people",
                   "loss_first", "loss_last", "direct", "http", "gates",
                   "certified", "wall_s"}


def train_model(cases, kind, dtype):
    """The case's model at `dtype` (the certified W32 for pose, the
    flax-like seeded inits for the others)."""
    import torch

    model, _ = cases.model_and_state(kind, dtype)
    # bf16 computes on f32 parameters, as the models train
    return model if dtype == torch.bfloat16 else model.to(dtype)


def train_throughput(cases, kind, dev, warmup=3, steps=20):
    """bf16 train steps of the case's model at TRAIN_BATCH on the card:
    (imgs/s over `steps` after `warmup`, peak allocated GB, losses)."""
    import torch

    model = train_model(cases, kind, torch.bfloat16).to(dev)
    state = cases.make_state(kind, model)
    t = cases.to_device(cases.inputs(kind, TRAIN_BATCH[kind]), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [cases.train_once(kind, state, t) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [cases.train_once(kind, state, t) for _ in range(steps)]
    torch.cuda.synchronize()
    rate = steps * TRAIN_BATCH[kind] / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    return rate, peak, [float(x) for x in losses], (model, state, t)


def train_profile(cases, kind, model_state_batch, steps=1,
                  out_name="train_profile_pose_b16.txt"):
    """torch.profiler over `steps` bf16 train steps: (wall ms a step, device
    busy ms a step, CUDA launches a step); the kernel table goes to
    chiprun_out/<out_name>."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, state, t = model_state_batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            cases.train_once(kind, state, t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in cuda) / 1e3 / steps
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    averages = prof.key_averages()
    with open(os.path.join(REPO, "chiprun_out", out_name), "w") as fh:
        fh.write(averages.table(sort_by="self_cuda_time_total", row_limit=60))
        fh.write("\n")
        fh.write(averages.table(sort_by="self_cpu_time_total", row_limit=40))
    return wall, busy, len(cuda) / steps


def serve_certify_checkpoint(ckpt, dev):
    """`serve.server --detector efficientdet_lite0 --checkpoint-dir` on the
    Orbax `ckpt/` that `cli.certify` wrote: one B=16 batch of the main
    path's scenes, rows equal to those of the pipeline the CLI builds on
    its reload (`load_pipeline_checkpoint` -> `reload_state`, its config,
    bf16)."""
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.cli import (
        certify as certify_cli,
    )
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (  # noqa: E501
        EFFICIENTDET_LITE0,
    )
    from human_body_proportion_estimation_tpu_torch.models.hrnet import (
        HRNET_W32,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        load_pipeline_checkpoint,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
        decode_image_bytes,
    )
    from human_body_proportion_estimation_tpu_torch.serve import (
        server as srv,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        DetectorConfig,
        PipelineConfig,
    )

    golden, scene_bytes = _scenes()
    images = [decode_image_bytes(b) for b in scene_bytes]
    batch16 = [images[i % len(images)] for i in range(16)]
    # the short-trained detector scores these scenes below the main path's
    # threshold: a low one, so that the rows compared hold persons
    height, thres = golden["person_height_cm"], 0.05
    t0 = time.perf_counter()
    spipe = srv.build_pipeline(srv.build_parser().parse_args(
        ["--detector", "efficientdet_lite0", "--checkpoint-dir", ckpt]))
    t_build = time.perf_counter() - t0
    assert spipe.weights_origin == {"detector": "real", "pose": "real"}
    det_vars, pose_vars = load_pipeline_checkpoint(ckpt)
    cli_pipe = InferencePipeline(
        config=PipelineConfig(
            detector=DetectorConfig(name="efficientdet_lite0")),
        det_state=certify_cli.reload_state(det_vars),
        pose_state=certify_cli.reload_state(pose_vars), device=dev,
        det_config=EFFICIENTDET_LITE0, pose_config=HRNET_W32,
        dtype=torch.bfloat16)
    rows = spipe.infer_serving(batch16, height, thres)
    ref = cli_pipe.infer_serving(batch16, height, thres)
    np.testing.assert_array_equal(rows, ref)
    persons = int(rows[..., 0].sum())
    assert persons > 0, "no person found: the rows compared are empty"
    log(f"phase T: cli.certify's Orbax ckpt/ served with serve.server "
        f"--checkpoint-dir (pipeline built in {t_build:.2f} s): a B=16 "
        f"batch's rows at det threshold {thres} equal to the CLI's "
        f"reloaded pipeline ({persons} persons found)")
    del spipe, cli_pipe
    torch.cuda.empty_cache()


def check_certify_report(report, keys, what):
    assert set(report) == keys, (what, sorted(set(report) ^ keys))
    assert report["platform"] == "gpu" and report["mode"] == "chip", report
    return report


def certify_bu_worker(workdir):
    """--certify-bu-worker: `cli.certify_bottomup.main` at phase T's
    budget, launches counted from 0; prints one JSON line of its exit
    code, launches and wall seconds last."""
    from human_body_proportion_estimation_tpu_torch.cli import (
        certify_bottomup as certify_bu_cli,
    )
    from human_body_proportion_estimation_tpu_torch.ops import kernels as k

    counted = Counted(k)
    t0 = time.perf_counter()
    with counted:
        rc = certify_bu_cli.main([
            "--workdir", workdir, "--train-scenes", "16", "--val-scenes",
            "2", "--http-scenes", "2", "--steps", str(CERTIFY_STEPS),
            "--batch", "4"])
    print(json.dumps(dict(rc=rc, launches=counted.last,
                          wall_s=time.perf_counter() - t0)), flush=True)
    return 0


def run_training(k, dev, repo):
    """Phase T: the port's training on the card. (1) float64 and f32 (TF32
    off) full-width train steps against the JAX float64 goldens, bf16
    steps against the JAX bfloat16 goldens
    (tests/data/torch_port/train_goldens.json, the cases of
    tests/torch_port_train.py); (2) bf16 training throughput (pose B=16,
    Lite0 detection B=8, bottom-up B=8), peak memory, the loss trend and a
    profile of the pose step; (3) `cli.certify.main` in process on a short
    budget, counted from 0: the report has the JAX keys, the losses are
    finite and fall, the reload equals the trained state (checked inside),
    the served sweep answered, and every kernel launched; then the Orbax
    `ckpt/` that run wrote, served by `serve.server --checkpoint-dir`: one
    B=16 batch of the main path's scenes at det threshold 0.05, rows equal
    to the pipeline the CLI builds from its reload, persons among them; (4) `cli.certify_bottomup.main` the same
    way, in a process of its own beside (3) (`--certify-bu-worker`),
    launching none. Returns the launches of (3) and (4)."""
    import math
    import shutil
    import tempfile

    import torch

    from human_body_proportion_estimation_tpu_torch.cli import (
        certify as certify_cli,
    )

    t_phase = time.perf_counter()
    cases = load_tests_module("torch_port_train")
    with open(os.path.join(DATA, "train_goldens.json")) as fh:
        golden = json.load(fh)
    for kind in TRAIN_KINDS:
        for name, dtype, ref in (("float64", torch.float64, "cases"),
                                 ("float32", torch.float32, "cases"),
                                 ("bfloat16", torch.bfloat16, "cases_bf16")):
            if kind not in golden[ref]:     # bf16: the pose case only
                continue
            t0 = time.perf_counter()
            tol = golden["tolerance"][name][kind]
            model = train_model(cases, kind, dtype)
            got = cases.run_port(kind, model, cases.inputs(kind), dev)
            err = cases.compare(got, golden[ref][kind])
            grouped = cases.group(err)
            assert all(grouped[g] <= tol[g] for g in tol), \
                (kind, name, err, tol)
            log(f"phase T: {kind} {name} train steps (batch {cases.BATCH}, "
                f"3 Adam steps) against the JAX "
                f"{'bfloat16' if ref == 'cases_bf16' else 'float64'} "
                f"goldens: losses {json.dumps(got['losses'])}, grad norm "
                f"{got['grad_norm']:.6g}; relative differences "
                f"{json.dumps({g: float(f'{v:.3g}') for g, v in grouped.items()})} "  # noqa: E501
                f"(tolerances {json.dumps(tol)}; "
                f"{json.dumps({n: float(f'{v:.3g}') for n, v in err.items()})}) "  # noqa: E501
                f"in {time.perf_counter() - t0:.1f} s")
            del model
            torch.cuda.empty_cache()

    for kind in TRAIN_KINDS:
        rate, peak, losses, msb = train_throughput(cases, kind, dev)
        assert all(math.isfinite(x) for x in losses), (kind, losses)
        log(f"phase T: {kind} bf16 training at batch {TRAIN_BATCH[kind]}: "
            f"{rate:.2f} imgs/s over 20 steps after 3, peak allocated "
            f"{peak:.2f} GB, loss {losses[0]:.5g} -> {losses[-1]:.5g} "
            f"(23 steps on one batch)")
        if kind == "pose":
            wall, busy, launches = train_profile(cases, kind, msb)
            log(f"phase T: pose bf16 train step B=16 under the profiler: "
                f"{wall:.2f} ms wall, card busy {busy:.2f} ms "
                f"({100 * busy / wall:.1f}%), {launches:.0f} CUDA launches "
                f"a step (chiprun_out/train_profile_pose_b16.txt)")
        del msb
        torch.cuda.empty_cache()

    # the workdirs hold f32 checkpoints (~130 MB): outside chiprun_out/
    out = tempfile.mkdtemp(prefix="phase_t_")
    # (4) runs in a process of its own, beside (3)
    bu_workdir = os.path.join(out, "phase_t_certify_bu")
    bu_proc = Started([sys.executable, os.path.abspath(__file__), "--repo",
                       repo, "--certify-bu-worker", bu_workdir], repo,
                      merge=True)
    counted = Counted(k)
    t0 = time.perf_counter()
    with counted:
        rc = certify_cli.main([
            "--workdir", os.path.join(out, "phase_t_certify"),
            "--train-scenes", "32", "--det-scenes", "16", "--val-scenes",
            "4", "--coco-scenes", "8", "--pose-steps", str(CERTIFY_STEPS),
            "--pose-batch", "4", "--det-steps", str(CERTIFY_STEPS),
            "--det-batch", "4", "--skip-ssd"])
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "phase_t_certify", "report.json")) as fh:
        report = check_certify_report(json.load(fh), CERTIFY_KEYS, "certify")
    assert rc == (0 if report["certified"] else 1), rc
    for name in ("pose", "det"):
        first, last = report[f"{name}_loss_first"], report[f"{name}_loss_last"]
        assert math.isfinite(first) and math.isfinite(last), report
        assert last < first, (name, first, last)
    served = report["served"]
    assert served["scenes"] == 4 and served["detected"] == 4, served
    assert report["coco_eval"]["images"] == 8, report["coco_eval"]
    assert all(n > 0 for n in counted.last.values()), counted.last
    log(f"phase T: cli.certify in process (Lite0, {CERTIFY_STEPS} pose steps "
        f"at batch 4, {CERTIFY_STEPS} detector steps at batch 4) in "
        f"{wall:.1f} s: pose loss "
        f"{report['pose_loss_first']:.5g} -> {report['pose_loss_last']:.5g}, "
        f"det loss {report['det_loss_first']:.5g} -> "
        f"{report['det_loss_last']:.5g}, served {served['detected']}/4 "
        f"(mean |dcm| {served['mean_abs_cm_err']:.4g}), gates (printed, not "
        f"asserted: they need the full budget) {json.dumps(report['gates'])}"
        f", launches {counted.last}")
    serve_certify_checkpoint(os.path.join(out, "phase_t_certify", "ckpt"),
                             dev)

    bu_out, _ = bu_proc.communicate()
    *cli_lines, last = bu_out.strip().splitlines() or [""]
    assert bu_proc.returncode == 0, bu_out[-4000:]
    print("\n".join(cli_lines), flush=True)
    worker = json.loads(last)
    rc, bu_launches = worker["rc"], worker["launches"]
    with open(os.path.join(bu_workdir, "report.json")) as fh:
        report = check_certify_report(json.load(fh), CERTIFY_BU_KEYS,
                                      "certify_bottomup")
    assert rc == (0 if report["certified"] else 1), rc
    assert math.isfinite(report["loss_first"]) and \
        report["loss_last"] < report["loss_first"], report
    # every request answered (a failed POST raises in the sweep); whom
    # the short-trained model finds is printed, not asserted
    assert report["http"]["scenes"] == 2 and math.isfinite(
        report["http"]["mean_http_latency_s"]), report["http"]
    assert bu_launches == dict.fromkeys(KERNELS, 0), bu_launches
    log(f"phase T: cli.certify_bottomup in a process of its own, beside "
        f"cli.certify ({CERTIFY_STEPS} steps at batch 4) in "
        f"{worker['wall_s']:.1f} s: loss {report['loss_first']:.5g} -> "
        f"{report['loss_last']:.5g}, http {report['http']['detected']}/2, "
        f"gates (printed) {json.dumps(report['gates'])}, launches "
        f"{bu_launches}")
    shutil.rmtree(out, ignore_errors=True)
    log(f"phase T: {time.perf_counter() - t_phase:.1f} s")
    return counted.total


# --------------------------------------------------------------------- #
# phase X: the deployable artifact (ROADMAP item 16, first half)


def _port_modules_built():
    """Patches `torch.nn.Module.__init__` to record every module of the
    port constructed from now on; returns the list it fills."""
    import torch

    built, init = [], torch.nn.Module.__init__

    def counting_init(self, *a, **kw):
        if type(self).__module__.startswith(
                "human_body_proportion_estimation_tpu_torch"):
            built.append(type(self).__name__)
        init(self, *a, **kw)

    torch.nn.Module.__init__ = counting_init
    return built


def artifact_worker(directory, out_path):
    """--artifact-worker: restore the artifact in this fresh process and
    serve the 3 scenes repeated to 16 and to 20 images (chunks of 16 and
    4), recording what phase X checks: the restore and first-answer
    seconds, the launches of each batch, the packings of the head weights
    over the run, the port modules built and the .npz files read, and the
    packed rows."""
    t_start = time.perf_counter()
    import numpy as np

    built = _port_modules_built()
    npz, real_load = [], np.load

    def counting_load(path, *a, **kw):
        npz.append(str(path))
        return real_load(path, *a, **kw)

    np.load = counting_load
    from human_body_proportion_estimation_tpu_torch.ops import kernels as k
    from human_body_proportion_estimation_tpu_torch.pipeline.export import (
        ArtifactPipeline,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        decode_image_bytes,
    )

    packs, real_pack = [], k.pack_head_weights

    def counting_pack(*a, **kw):
        packs.append(1)
        return real_pack(*a, **kw)

    k.pack_head_weights = counting_pack
    import torch

    load_s, real_export_load = [], torch.export.load

    def timed_export_load(*a, **kw):
        t = time.perf_counter()
        ep = real_export_load(*a, **kw)
        load_s.append(time.perf_counter() - t)
        return ep

    torch.export.load = timed_export_load
    with open(os.path.join(DATA, "goldens.json")) as fh:
        golden = json.load(fh)
    images = []
    for name in golden["scenes"]:
        with open(os.path.join(DATA, name), "rb") as fh:
            images.append(decode_image_bytes(fh.read()))
    height, thres = golden["person_height_cm"], golden["det_threshold"]
    batch16 = [images[i % 3] for i in range(16)]
    batch20 = [images[i % 3] for i in range(20)]

    t0 = time.perf_counter()
    pipe = ArtifactPipeline(directory, device="cuda")
    restore_s = time.perf_counter() - t0
    k.reset_launch_counts()
    rows16 = pipe.infer_serving(batch16, height, thres)
    first_answer_s = time.perf_counter() - t0
    launches16 = k.launch_counts()
    k.reset_launch_counts()
    rows20 = pipe.infer_serving(batch20, height, thres)
    launches20 = k.launch_counts()
    k.reset_launch_counts()
    for _ in range(3):
        pipe.infer_serving(batch16, height, thres)
    launches_more = k.launch_counts()
    nodes = {}
    for node in pipe.artifact.program.graph.nodes:
        if node.op == "call_function":
            key = str(node.target)
            nodes[key] = nodes.get(key, 0) + 1
    with open(out_path, "w") as fh:
        json.dump(dict(
            restore_s=restore_s, export_load_s=load_s[0],
            first_answer_s=first_answer_s,
            since_start_s=time.perf_counter() - t_start,
            launches16=launches16, launches20=launches20,
            launches_more=launches_more, packs=len(packs), built=built,
            npz=npz, rows16=rows16.tolist(), rows20=rows20.tolist(),
            graph_nodes=sum(nodes.values()),
            graph_top=sorted(nodes.items(), key=lambda kv: -kv[1])[:8],
            stages=sorted(pipe.stages.snapshot()) if pipe.stages else None,
        ), fh)
    return 0


def cache_worker(directory, forbid_nvcc):
    """--cache-worker: `compile_cache.enable(directory)`, then build and
    load the kernel library; with `forbid_nvcc` a build that needs nvcc
    fails. Prints the library's path and the seconds it took."""
    from human_body_proportion_estimation_tpu_torch.ops import build
    from human_body_proportion_estimation_tpu_torch.utils import (
        compile_cache,
    )

    compile_cache.enable(directory)
    if forbid_nvcc:
        def no_nvcc():
            raise RuntimeError("the cache missed: nvcc was asked for")

        build.find_nvcc = no_nvcc
    t0 = time.perf_counter()
    path = build.build()
    build.load_library()
    print(json.dumps(dict(path=path, seconds=time.perf_counter() - t0)),
          flush=True)
    return 0


def slots_worker():
    """--slots-worker: a seeded f32 YOLOv5m and a seeded f32 bottom-up
    pipeline on the card, each exported at B=2, restored, and held to its
    live pipeline on the same images; prints one JSON line of figures and
    the launches of the artifact batches."""
    t_start = time.perf_counter()
    import tempfile

    import torch

    from human_body_proportion_estimation_tpu_torch.ops import kernels as k
    from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
        BottomUpPipeline,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.export import (
        ArtifactPipeline,
        export_serving_artifact,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
        decode_image_bytes,
    )

    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="phase_x_slots_")
    out = {}
    with open(os.path.join(DATA, "yolo_goldens.json")) as fh:
        ygold = json.load(fh)
    yimgs = []
    for name in ygold["scenes"]:
        with open(os.path.join(DATA, name), "rb") as fh:
            yimgs.append(decode_image_bytes(fh.read()))
    ypipe = InferencePipeline(det_state=yolo_state(ygold, yimgs), device=dev,
                              dtype=torch.float32, detector="yolov5m")
    yart = os.path.join(tmp, "yolov5m_b2")
    t0 = time.perf_counter()
    export_serving_artifact(ypipe, yart, batch_size=2)
    out["yolo_export_s"] = time.perf_counter() - t0
    yapipe = ArtifactPipeline(yart, device="cuda")
    height, thres = ygold["person_height_cm"], ygold["det_threshold"]
    ylive = ypipe.infer_serving(yimgs[:2], height, thres)
    k.reset_launch_counts()
    ygot = yapipe.infer_serving(yimgs[:2], height, thres)
    out["yolo_launches"] = k.launch_counts()
    out["yolo"] = packed_against(ygot, ylive, "YOLOv5m artifact vs live B=2")
    out["yolo_persons"] = int((ygot[..., 0] > 0.5).sum())
    del ypipe, yapipe

    slots = load_tests_module()
    with open(os.path.join(DATA, "bottomup_goldens.json")) as fh:
        bgold = json.load(fh)
    bimgs = list(slots.scenes())
    bpipe = BottomUpPipeline(
        pose_state=seeded_higher(slots, bgold["seed"], slots.crops(bimgs)),
        device=dev, dtype=torch.float32)
    bart = os.path.join(tmp, "bottomup_b2")
    t0 = time.perf_counter()
    export_serving_artifact(bpipe, bart, batch_size=2)
    out["bottomup_export_s"] = time.perf_counter() - t0
    bapipe = ArtifactPipeline(bart, device="cuda")
    blive = bpipe.infer_serving(bimgs[:2], bgold["height_cm"])
    k.reset_launch_counts()
    bgot = bapipe.infer_serving(bimgs[:2], bgold["height_cm"])
    out["bottomup_launches"] = k.launch_counts()
    out["bottomup"] = packed_against(bgot, blive,
                                     "bottom-up artifact vs live B=2")
    out["bottomup_persons"] = int((bgot[..., 0] > 0.5).sum())
    out["wall_s"] = time.perf_counter() - t_start
    print(json.dumps(out), flush=True)
    return 0


def packed_against(got, ref, what):
    """Two packed row sets: identical validity, and phase 3's cm rule on
    the segments visible in both. Returns the figures (the largest
    |difference| of all values among them)."""
    import numpy as np

    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.array_equal(got[..., 0] > 0.5, ref[..., 0] > 0.5), \
        f"{what}: person_valid {got[..., 0]} vs {ref[..., 0]}"
    both = (got[..., 12:] > 0.5) & (ref[..., 12:] > 0.5)
    d = np.abs(got[..., 1:12] - ref[..., 1:12])[both]
    figures = dict(max_abs_diff=float(np.abs(got - ref).max()),
                   identical=bool(np.array_equal(got, ref)),
                   segments_both=int(both.sum()),
                   visibility_mismatch=int(
                       ((got[..., 12:] > 0.5) != (ref[..., 12:] > 0.5)).sum()),
                   max_abs_cm=float(d.max()) if d.size else 0.0,
                   mean_abs_cm=float(d.mean()) if d.size else 0.0)
    assert d.size == 0 or (d.mean() <= GOLDEN_MEAN_CM
                           and d.max() <= GOLDEN_MAX_CM), (what, figures)
    return figures


def start_artifact_workers(repo):
    """Phase X's two subprocesses that need nothing of the phase: the
    compile cache's first process, building the kernels with nvcc into a
    fresh directory (it needs no card), and the YOLOv5m and bottom-up
    artifacts' exports and checks. Returns (cache1, slots)."""
    import tempfile

    me = os.path.abspath(__file__)
    kcache = os.path.join(tempfile.mkdtemp(prefix="phase_x_cache_"),
                          "kernel_cache")
    cache1 = Started(
        [sys.executable, me, "--repo", repo, "--cache-worker", kcache],
        repo, timeout=300, merge=True, kcache=kcache)
    slots = Started([sys.executable, me, "--repo", repo, "--slots-worker"],
                    repo, merge=True)
    return cache1, slots


def run_artifact(k, lite4_pipe, repo):
    """Phase X: the deployable artifact on the card. Returns the launches
    of the artifact batches run (in process and in the subprocesses)."""
    import shutil
    import tempfile

    import numpy as np

    from human_body_proportion_estimation_tpu_torch.pipeline.export import (
        ArtifactPipeline,
        export_serving_artifact,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        decode_image_bytes,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase_x_")
    me = os.path.abspath(__file__)
    # the compile cache's first process (step 6) and the YOLOv5m and
    # bottom-up artifacts' process (step 3): begun by main() before phase
    # U, or here
    cache1, slots = EARLY.pop("X", None) or start_artifact_workers(repo)
    kcache = cache1.kcache

    with open(os.path.join(DATA, "goldens.json")) as fh:
        golden = json.load(fh)
    scene_bytes = []
    for name in golden["scenes"]:
        with open(os.path.join(DATA, name), "rb") as fh:
            scene_bytes.append(fh.read())
    images = [decode_image_bytes(b) for b in scene_bytes]
    height, thres = golden["person_height_cm"], golden["det_threshold"]
    batch16 = [images[i % 3] for i in range(16)]
    counted = Counted(k)
    figures = {}

    # 1. export the certified Lite4 -> W32 program at B = 16
    art = os.path.join(tmp, "lite4_w32_b16")
    t0 = time.perf_counter()
    export_serving_artifact(lite4_pipe, art, batch_size=16)
    figures["export_s"] = time.perf_counter() - t0
    figures["program_mb"] = os.path.getsize(
        os.path.join(art, "pipeline.pt2")) / 2**20
    with open(os.path.join(art, "meta.json")) as fh:
        meta = json.load(fh)
    assert meta["device"] == "cuda" and meta["batch_size"] == 16, meta
    log(f"phase X: exported the certified Lite4 -> W32 program at B=16 in "
        f"{figures['export_s']:.1f} s ({figures['program_mb']:.1f} MiB "
        f"pipeline.pt2)")

    # 2. restore and serve in a fresh process
    out = os.path.join(tmp, "worker.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, me, "--repo", repo, "--artifact-worker", art, out],
        cwd=repo, capture_output=True, text=True, timeout=300)
    figures["worker_wall_s"] = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as fh:
        w = json.load(fh)
    one = dict.fromkeys(KERNELS, 1)
    assert w["built"] == [] and w["npz"] == [], (w["built"], w["npz"])
    assert w["launches16"] == one, w["launches16"]
    assert w["launches20"] == dict.fromkeys(KERNELS, 2), w["launches20"]
    assert w["launches_more"] == dict.fromkeys(KERNELS, 3), w["launches_more"]
    assert w["packs"] == 1, w["packs"]
    rows16, rows20 = np.asarray(w["rows16"]), np.asarray(w["rows20"])
    with counted:
        live16 = lite4_pipe.infer_serving(batch16, height, thres)
    vs_live = packed_against(rows16, live16, "artifact B=16 vs live B=16")
    vs_golden = packed_against(rows16[:3], golden["packed"],
                               "artifact vs the JAX goldens")
    assert vs_golden["segments_both"] > 0
    chunked = packed_against(rows20, [live16[i % 3] for i in range(20)],
                             "artifact 20 images (16 + 4) vs live B=16")
    np.testing.assert_array_equal(rows20[:16], rows16)
    figures.update(restore_s=w["restore_s"],
                   restore_export_load_s=w["export_load_s"],
                   graph_nodes=w["graph_nodes"],
                   graph_top_ops=w["graph_top"],
                   restore_to_first_answer_s=w["first_answer_s"],
                   process_start_to_first_answer_s=w["since_start_s"])
    log(f"phase X: restored in a fresh process (no port module built, no "
        f".npz read) in {w['restore_s']:.2f} s (torch.export.load "
        f"{w['export_load_s']:.2f} s of it), first answer "
        f"{w['first_answer_s']:.2f} s after the restore began (process "
        f"wall {figures['worker_wall_s']:.1f} s); launches a batch "
        f"{w['launches16']} (20 images: {w['launches20']}), head weights "
        f"packed {w['packs']} time over 6 batches; vs live at B=16 "
        f"{json.dumps(vs_live)}; vs the JAX goldens {json.dumps(vs_golden)};"
        f" 20 images vs live {json.dumps(chunked)}")

    # 3. the other programs, exported and checked by the subprocess begun
    # before: waited for here, so that the servers and the throughput below
    # run alone on the card
    slots_out, _ = slots.communicate()
    assert slots.returncode == 0, slots_out[-3000:]
    sw = json.loads(slots_out.strip().splitlines()[-1])
    assert sw["yolo_launches"] == {"decode_heatmaps": 1, "head_score": 0,
                                   "nms_sweep": 1}, sw["yolo_launches"]
    assert sw["bottomup_launches"] == dict.fromkeys(KERNELS, 0), \
        sw["bottomup_launches"]
    assert sw["yolo"]["identical"] and sw["bottomup"]["identical"], sw
    figures["slots_worker_wall_s"] = sw["wall_s"]
    log(f"phase X: YOLOv5m f32 artifact at B=2 (exported in "
        f"{sw['yolo_export_s']:.1f} s) equal to its live pipeline, "
        f"{sw['yolo_persons']} persons, launches a batch "
        f"{sw['yolo_launches']}; bottom-up f32 artifact at B=2 (exported "
        f"in {sw['bottomup_export_s']:.1f} s) equal to its live pipeline, "
        f"{sw['bottomup_persons']} persons, no launch (subprocess wall "
        f"{sw['wall_s']:.1f} s)")

    # 4. the server on the artifact, beside the live server
    ready = {}
    for name, args in (
            ("live", ["--detector", "efficientdet_lite4"]),
            ("artifact", ["--artifact-dir", art])):
        port = free_port()
        t0 = time.perf_counter()
        with server_process(repo, [*args, "--port", str(port), "--grpc-port",
                                   "0", "--prewarm"]) as lines:
            ready[name] = time.perf_counter() - t0
            health = http_json(port, "GET", "/health")
            assert health["prewarmed"] is True, health
            assert health["weights"] == {
                "detector": "synthetic-certified",
                "pose": "synthetic-certified"}, health
            if name == "artifact":
                assert any("WARNING: artifact carries no real-weight slot"
                           in ln for ln in lines), lines
                heights = [150 + i for i in range(48)]
                m0 = http_json(port, "GET", "/metrics")
                answers, wall = post_load(port, scene_bytes, heights, thres,
                                          16)
                m1 = http_json(port, "GET", "/metrics")
                d_all = []
                for i, a in enumerate(answers):
                    assert a["code"] == "success", (a, "".join(lines[-80:]))
                    d_all += check_answer(a["body_proportion_lengths_(cm)"],
                                          golden, i % 3, heights[i],
                                          f"artifact server request {i}")
                mean, mx = check_mean(d_all, "artifact server load")
                load = load_summary(m0, m1, wall, 48)
                assert m1["failures_total"] == m0["failures_total"], m1
                assert set(m1["stages"]) >= {"host_prepare",
                                             "device_compute_readback"}
    figures["server_ready_s"] = ready
    log(f"phase X: serve.server --prewarm start to ready: artifact "
        f"{ready['artifact']:.1f} s, live {ready['live']:.1f} s; the "
        f"artifact server's /health weights {health['weights']}; 48 "
        f"requests from 16 clients against the goldens x height/175: mean "
        f"|dcm| {mean:.3f}, max {mx:.3f}; {json.dumps(load)}")

    # 5. imgs/s at B = 16, the artifact restored here, in turns with live
    apipe = ArtifactPipeline(art, device="cuda")
    rates = {"live": [], "artifact": []}
    with counted:
        for name in ("live", "artifact", "artifact", "live"):
            rates[name].append(imgs_per_s(
                lite4_pipe if name == "live" else apipe, batch16, height,
                thres, iters=16))
    figures["imgs_per_s"] = rates
    log(f"phase X: infer_serving B=16 imgs/s in turns: {json.dumps(rates)}")
    del apipe

    # 6. the compile cache: the first process built into kcache with nvcc,
    # a second one finds the library there and runs none
    first, _ = cache1.communicate()
    assert cache1.returncode == 0, first[-3000:]
    built = json.loads(first.strip().splitlines()[-1])
    proc = subprocess.run(
        [sys.executable, me, "--repo", repo, "--cache-worker", kcache,
         "--forbid-nvcc"], cwd=repo, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    hit = json.loads(proc.stdout.strip().splitlines()[-1])
    assert hit["path"] == built["path"] and \
        os.path.dirname(hit["path"]) == kcache, (built, hit)
    figures["kernel_cache_s"] = dict(build=built["seconds"],
                                     hit=hit["seconds"])
    log(f"phase X: compile_cache.enable(dir): the first process built the "
        f"kernels into it in {built['seconds']:.1f} s, a second found the "
        f"library there without nvcc in {hit['seconds']:.3f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(os.path.dirname(kcache), ignore_errors=True)

    total = dict(counted.total)
    for counts in (w["launches16"], w["launches20"], w["launches_more"],
                   sw["yolo_launches"], sw["bottomup_launches"]):
        for name, n in counts.items():
            total[name] += n
    figures["phase_s"] = time.perf_counter() - t_phase
    log(f"phase X figures: {json.dumps(figures)}")
    log(f"phase X card: {card_line()}")
    log(f"phase X: {figures['phase_s']:.1f} s, launches {total}")
    return total



# --------------------------------------------------------------------- #
# phase M: multi-device serving and training (ROADMAP item 16, second half)


MESH_WORKERS = 2
MESH_TOL = 1e-4


def mesh_worker(rank, port, out):
    """--mesh-worker: one of two processes on cuda:0 over gloo. (1)
    `MultiHostServing` of the certified pipeline in f32 (TF32 off) on the
    card (the process fails if the pipeline is elsewhere), rank 0 the
    coordinator: the 16-image batch of the 3 scenes, 8 rows a
    process, then the shutdown sentinel (rank 1 leaves `worker_loop` on
    it); (2) one sharded float64 pose step at dp = 2 (the phase T case of
    tests/torch_port_train.py, batch 2: one row a process), three Adam
    steps. Rank 0 writes both results to `out`."""
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.parallel import (
        multihost as mh,
    )
    from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        decode_image_bytes,
        prepare_batch,
    )
    from human_body_proportion_estimation_tpu_torch.training import (
        trainer as T,
    )

    rank = int(rank)
    torch.cuda.set_device(0)
    mh.init_multihost(f"127.0.0.1:{port}", MESH_WORKERS, rank)
    result = {}
    pipe, serving = mh.make_multihost_pipeline(
        detector="efficientdet_lite4", dtype=torch.float32)
    assert pipe.device.type == "cuda", pipe.device
    result["device"] = str(pipe.device)
    if serving.is_coordinator:
        golden, scene_bytes = _scenes()
        images = [decode_image_bytes(b) for b in scene_bytes]
        *batch, _ = prepare_batch(
            pipe.config, [images[i % 3] for i in range(16)],
            golden["person_height_cm"], golden["det_threshold"], 16)
        result["rows"] = serving.coordinator_step(*batch).tolist()
        serving.shutdown()
    else:
        serving.worker_loop()
    result["left_worker_loop"] = True

    cases = load_tests_module("torch_port_train")
    model, _ = cases.model_and_state("pose", torch.float64)
    state = cases.make_state("pose", model.double())
    step, sstate = T.make_sharded_train_step(
        state, make_mesh(devices=["cuda:0"] * MESH_WORKERS))
    t = cases.to_device(cases.inputs("pose"), "cuda:0")
    imgs = t["images"].permute(0, 3, 1, 2).double() / 255.0
    tgt = T.heatmap_targets(t["kp_hm"], t["visible"], 96, 72, 2.0)
    got = {"losses": []}
    t0 = time.perf_counter()
    for i in range(cases.STEPS):
        sstate, loss = step(sstate, imgs, tgt, t["visible"].double(), 12.0)
        got["losses"].append(float(loss))
        if i == 0:
            grads = {n: p.grad.double() for n, p in
                     sstate.model.named_parameters() if p.grad is not None}
            got["grad_norm"] = float(torch.sqrt(sum(
                (g * g).sum() for g in grads.values())))
            got["grad_norms"] = {n: float(grads[n].norm())
                                 for n in cases.GRADS["pose"]}
            for prefix, name in zip(("bn", "bn_low"), cases.BN["pose"]):
                bn = sstate.model.get_submodule(name)
                got[f"{prefix}_mean"] = bn.running_mean.cpu().tolist()
                got[f"{prefix}_var"] = bn.running_var.cpu().tolist()
    result["train"] = got
    result["train_s"] = time.perf_counter() - t0
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(result, fh)
    torch.distributed.destroy_process_group()
    return 0


def _scenes():
    with open(os.path.join(DATA, "goldens.json")) as fh:
        golden = json.load(fh)
    scene_bytes = []
    for name in golden["scenes"]:
        with open(os.path.join(DATA, name), "rb") as fh:
            scene_bytes.append(fh.read())
    return golden, scene_bytes


def start_mesh_workers(repo):
    """Phase M's two lockstep processes (`--mesh-worker`), begun; rank 0
    writes both results to the `out_path` they carry."""
    import tempfile

    out = os.path.join(tempfile.mkdtemp(prefix="phase_m_"),
                       "mesh_worker.json")
    port = free_port()
    me = os.path.abspath(__file__)
    return [Started([sys.executable, me, "--repo", repo, "--mesh-worker",
                     str(r), str(port), out], repo, merge=True, out_path=out)
            for r in range(MESH_WORKERS)]


def run_mesh(k, dev, lite4_pipe, repo):
    """Phase M: the main path at dp = 2 on one card (a mesh listing cuda:0
    twice), two lockstep processes, and the sharded pose step. Returns the
    launches of one dp = 2 serving batch, counted from 0."""
    import numpy as np
    import torch

    from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
        decode_image_bytes,
    )
    from human_body_proportion_estimation_tpu_torch.serve.registry import (
        build_registry,
    )

    t_phase = time.perf_counter()
    # begun by main() before phase X, or here
    workers = EARLY.pop("M", None) or start_mesh_workers(repo)
    out = workers[0].out_path

    golden, scene_bytes = _scenes()
    images = [decode_image_bytes(b) for b in scene_bytes]
    height, thres = golden["person_height_cm"], golden["det_threshold"]
    batch16 = [images[i % 3] for i in range(16)]
    mesh = make_mesh(devices=[dev, dev])

    # 1. f32 (TF32 off): the dp = 2 rows against the dp = 1 forward of
    # each shard's own 8 rows (cuDNN picks its algorithm by batch size)
    f32 = [InferencePipeline(device=dev, detector="efficientdet_lite4",
                             dtype=torch.float32, mesh=m)
           for m in (None, mesh)]
    ref = np.concatenate([f32[0].infer_serving(batch16[:8], height, thres),
                          f32[0].infer_serving(batch16[8:], height, thres)])
    got = f32[1].infer_serving(batch16, height, thres)
    err = float(np.abs(got - ref).max())
    log(f"phase M: f32 dp = 2 rows against dp = 1 per shard: max |diff| "
        f"{err:.3g} (tolerance {MESH_TOL})")
    assert got.shape == (16, 3, 23) and err <= MESH_TOL, err
    assert got[:, :, 0].sum() > 0

    # 2. the registry over the pipeline's mesh: instance_group.count is
    # dp, and a sharded `hrnet` batch answers as the one-device one
    regs = [build_registry(p) for p in f32]
    assert regs[1].config("hrnet")["instance_group"][0]["count"] == 2
    assert regs[0].config("hrnet")["instance_group"][0]["count"] == 1
    crops = np.random.default_rng(0).random((4, 3, 384, 288), np.float32)
    outs = [r.infer("hrnet", {"input": crops})["output"] for r in regs]
    for r in regs:
        r.shutdown()
    reg_err = float(np.abs(outs[1] - outs[0]).max()
                    / np.abs(outs[0]).max())
    log(f"phase M: registry hrnet at dp = 2: instance_group.count 2, "
        f"rows against dp = 1: {reg_err:.3g} of the peak")
    assert reg_err <= MESH_TOL, reg_err
    del f32, regs

    # 3. bf16, the serving dtype: one dp = 2 batch, counted from 0: every
    # kernel launches once a shard; rows against the goldens (phase 3)
    bf16 = InferencePipeline(device=dev, detector="efficientdet_lite4",
                             mesh=mesh)
    k.reset_launch_counts()
    packed = bf16.infer_serving(batch16, height, thres)
    launches = k.launch_counts()
    log(f"phase M: dp = 2 launches of one batch: {launches}")
    assert launches == dict.fromkeys(KERNELS, 2), launches
    figures = packed_against(packed[:3], golden["packed"], "dp = 2 bf16")
    log(f"phase M: dp = 2 bf16 against the goldens: {json.dumps(figures)}")

    # 4. two lockstep processes against this one process (f32)
    logs = [w.communicate()[0] for w in workers]
    for w, text in zip(workers, logs):
        assert w.returncode == 0, text[-4000:]
    with open(out) as fh:
        worker = json.load(fh)
    one = InferencePipeline(device=dev, detector="efficientdet_lite4",
                            dtype=torch.float32)
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        prepare_batch,
    )

    *arrays, _ = prepare_batch(one.config, batch16, height, thres, 16)
    ref = np.concatenate([one.serving_rows(*(a[:8] for a in arrays)),
                          one.serving_rows(*(a[8:] for a in arrays))])
    mh_err = float(np.abs(np.asarray(worker["rows"], np.float32)
                          - ref).max())
    log(f"phase M: two processes over gloo, served on "
        f"{worker['device']}: rows against one process max |diff| "
        f"{mh_err:.3g}; both left on the sentinel: "
        f"{worker['left_worker_loop']}")
    assert mh_err <= MESH_TOL and worker["left_worker_loop"], mh_err
    assert worker["device"].startswith("cuda"), worker["device"]
    del one

    # 5. the sharded float64 pose step against JAX's float64 step on the
    # global batch (phase T's case and goldens), at phase T's tolerance
    cases = load_tests_module("torch_port_train")
    with open(os.path.join(DATA, "train_goldens.json")) as fh:
        golden = json.load(fh)
    tol = golden["tolerance"]["float64"]["pose"]
    grouped = cases.group(cases.compare(worker["train"],
                                        golden["cases"]["pose"]))
    log(f"phase M: sharded float64 pose step (dp = 2, two processes, "
        f"{worker['train_s']:.1f} s) against the JAX float64 goldens: "
        f"{json.dumps({g: float(f'{v:.3g}') for g, v in grouped.items()})}"
        f" (tolerance {json.dumps(tol)})")
    assert all(grouped[g] <= tol[g] for g in tol), (grouped, tol)

    # 6. imgs/s at B = 16, dp = 2 on one card beside dp = 1, in turns
    rates = {"dp1": [], "dp2": []}
    for _ in range(2):
        for name, p in (("dp1", lite4_pipe), ("dp2", bf16)):
            rates[name].append(imgs_per_s(p, batch16, height, thres))
    log(f"phase M: infer_serving imgs/s at B = 16 (bf16, in turns): "
        f"{json.dumps({n: [round(r, 2) for r in v] for n, v in rates.items()})}"  # noqa: E501
        f" on {card_line()} (two shards on one card: a record, no scaling "
        f"claim)")
    log(f"phase M: {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--edge-sweep", action="store_true",
                    help="after phase B, the serving-edge load under other "
                         "settings (batches in flight, engine, clients)")
    ap.add_argument("--time-kernels", action="store_true")
    ap.add_argument("--kernel", default="",
                    help="with --time-kernels: only the cases named so")
    ap.add_argument("--repo", default=REPO,
                    help="checkout whose port package is built and run")
    ap.add_argument("--phases", default=ALL_PHASES,
                    help="the phases after 3 to run (all by default); a "
                         "subset ends after the kernels line and the "
                         "card's, without the result line")
    # phase X's own subprocesses
    ap.add_argument("--artifact-worker", nargs=2, metavar=("DIR", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--cache-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--slots-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--forbid-nvcc", action="store_true",
                    help=argparse.SUPPRESS)
    # phase M's two lockstep processes
    ap.add_argument("--mesh-worker", nargs=3,
                    metavar=("RANK", "PORT", "OUT"), help=argparse.SUPPRESS)
    # phase T's certify_bottomup process
    ap.add_argument("--certify-bu-worker", metavar="WORKDIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    if args.artifact_worker:
        return artifact_worker(*args.artifact_worker)
    if args.cache_worker:
        return cache_worker(args.cache_worker, args.forbid_nvcc)
    if args.slots_worker:
        return slots_worker()
    if args.mesh_worker:
        return mesh_worker(*args.mesh_worker)
    if args.certify_bu_worker:
        return certify_bu_worker(args.certify_bu_worker)
    from human_body_proportion_estimation_tpu_torch.ops import build
    from human_body_proportion_estimation_tpu_torch.ops import kernels as k
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        load_certified_states,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    log(f"build: {build.timed_build(verbose=args.ptxas):.1f} s "
        f"({len(build.sources())} sources)")

    det_state, _ = load_certified_states(os.path.join(
        REPO, "human_body_proportion_estimation_tpu", "checkpoints",
        "certified_lite4_w32.npz"))
    if args.time_kernels:
        time_kernels(k, dev, det_state, args.kernel)
        print(card_line(), flush=True)
        return 0
    results = [check_decode(k, dev), check_head_score(k, dev, det_state),
               check_nms(k, dev)]
    for r in results:
        log(f"kernel {r['name']}: ok, max_abs_err {r['max_abs_err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms)")

    launches = {r["name"]: None for r in results}
    if not args.kernels_only:
        repo = os.path.abspath(args.repo)
        launches, pipe, golden, scene_bytes = run_main_path(
            k, dev, profile=args.profile)
        phases = {
            "A": lambda: run_serving_edge(k, pipe, golden,
                                          scene_bytes)["launches"],
            "B": lambda: run_cli(golden, repo),
            "C": lambda: run_registry_and_wire(k, pipe, golden, scene_bytes),
            "Y": lambda: run_yolo(k, dev, pipe, repo),
            "S": lambda: run_ssd(k, dev, pipe, repo),
            "D": lambda: run_other_slots(k, dev, pipe, repo),
            "U": lambda: run_bottom_up(k, dev, repo),
            "E": lambda: run_evaluate(k, pipe, repo),
            "T": lambda: run_training(k, dev, repo),
            "X": lambda: run_artifact(k, pipe, repo),
            "M": lambda: run_mesh(k, dev, pipe, repo),
        }
        # subprocesses that need nothing of the phases between begin before
        # an earlier phase, beside its in-process work: the phase before
        # which they begin -> {consuming phase: begin}. Phase C runs before
        # B, so that B's CLI has C's time
        early = {"C": {"B": lambda: start_cli(golden, repo),
                       "E": lambda: start_evaluate(repo)},
                 "S": {"D": lambda: start_slot_clis(repo)},
                 "U": {"X": lambda: start_artifact_workers(repo)},
                 "X": {"M": lambda: start_mesh_workers(repo)}}
        atexit.register(Started.stop_all)
        # the kernels line counts the launches of every path driven: the
        # main path (phase 3), the serving edge (A), the registry and wire
        # protocols (C), the YOLO slot (Y), the SSD slot (S), the other
        # slots (D), bottom-up pose (U: none), the evaluate CLI's
        # pipeline (E), the certify
        # CLIs of training (T), the artifact's batches (X) and one dp = 2
        # batch (M), each counted from 0 just before it
        for name in "ACBYSDUETXM":
            if name not in args.phases:
                continue
            for consumer, begin in early.get(name, {}).items():
                if consumer in args.phases:
                    EARLY[consumer] = begin()
            counts = phases[name]() or {}
            launches = {kn: launches[kn] + counts.get(kn, 0)
                        for kn in launches}
        if args.edge_sweep:
            edge_sweep(pipe, golden, scene_bytes)
    sources = {"decode_heatmaps": "decode_heatmaps.cu",
               "head_score": "head_score.cu", "nms_sweep": "nms_sweep.cu"}
    replaces = {
        "decode_heatmaps": "human_body_proportion_estimation_tpu/ops/"
                           "pallas_kernels.py:56",
        "head_score": "human_body_proportion_estimation_tpu/ops/"
                      "pallas_kernels.py:228",
        "nms_sweep": "human_body_proportion_estimation_tpu/ops/"
                     "pallas_kernels.py:151",
    }
    kernels_line = {"kernels": [
        dict(name=r["name"], route="cuda",
             source="human_body_proportion_estimation_tpu_torch/csrc/"
                    + sources[r["name"]],
             replaces=replaces[r["name"]], launches=launches[r["name"]],
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=r["library_ms"],
             graph_ms=r["graph_ms"], library_graph_ms=r["library_graph_ms"])
        for r in results
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(card_line(), flush=True)
    if args.kernels_only or set(ALL_PHASES) - set(args.phases):
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
