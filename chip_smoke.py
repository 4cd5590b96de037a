#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py                 # all phases, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --ptxas         # also print nvcc -Xptxas -v
    python3 chip_smoke.py --profile       # + torch.profiler of B=16 serving
    python3 chip_smoke.py --edge-sweep    # + the serving edge's load under
                                          # other settings (engine, batches
                                          # in flight, client threads)
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
     sweep [16,128] at t = 0.5 and 0.3 with an at-threshold pair, then the
     cases of tests/torch_port_nms_cases.py (NaN and infinite boxes, K from
     1 to 256, B = 1, dead, identical and zero-area boxes, a chain across
     three 32-box blocks; all exact),
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
     The index and the documents of the 4 models at full width; the
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
  4. report: a `kernels` JSON line (launches: phases 3, A and C), the
     card's name and power limit, and the result line
     {"ok": true, "device": {...}} last.

Imports nothing of JAX; builds into the package's gitignored `build/`.
"""

from __future__ import annotations

import argparse
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


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


def check_nms(k, dev):
    import torch

    cases = load_nms_cases()
    boxes, scores = nms_inputs(dev)
    for t in (0.5, 0.3):
        got = k.nms_sweep(boxes, scores, t)
        ref = k.nms_sweep_plain(boxes, scores, t)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"nms: keep differs from plain at {t}"
    assert bool(got.any()) and not bool(got.all())
    # the shared cases: every one is checked before any failure is raised,
    # and a mask that differs is printed beside the plain version's
    failed = []
    for name, c_boxes, c_scores, t, expected in cases:
        c_boxes = torch.from_numpy(c_boxes).to(dev)
        c_scores = torch.from_numpy(c_scores).to(dev)
        got = k.nms_sweep(c_boxes, c_scores, t)
        ref = k.nms_sweep_plain(c_boxes, c_scores, t)
        torch.cuda.synchronize()
        if expected is not None:
            assert ref.cpu().numpy().tolist() == expected.tolist(), \
                f"nms case {name}: the plain version misses the stated mask"
        if not torch.equal(got, ref):
            failed.append(name)
            img = int(torch.nonzero((got != ref).any(-1))[0])
            at = torch.nonzero(got[img] != ref[img]).flatten().tolist()
            log(f"nms case {name!r} at t = {t}: kernel differs from plain in "
                f"{int((got != ref).sum())} places; image {img}, boxes {at}")
            if c_boxes.shape[1] <= 8:
                log(f"  boxes  {c_boxes[img].tolist()}")
                log(f"  kernel {got[img].tolist()}")
                log(f"  plain  {ref[img].tolist()}")
    assert not failed, f"nms: keep differs from plain in cases {failed}"
    log(f"nms_sweep: {len(cases)} shared cases exact against plain")

    def sweep16():
        k.nms_sweep(boxes, scores, 0.5)

    boxes1, scores1 = boxes[3:4].contiguous(), scores[3:4].contiguous()

    def sweep1():
        k.nms_sweep(boxes1, scores1, 0.5)

    ms = cuda_ms(sweep16, 200)
    plain_ms = cuda_ms(lambda: k.nms_sweep_plain(boxes, scores, 0.5), 3, 1)
    b, kk = scores.shape
    # a keep mask reads only the pairs j < i: K (K - 1) / 2 IoUs an image,
    # 14 operations each
    b_ms, b_by = bound(boxes.numel() * 4 + scores.numel() * 4 + b * kk,
                       14.0 * b * kk * (kk - 1) / 2, F32_FLOP_PER_S)
    g_ms = graph_ms(sweep16, 100)
    line = (f"nms_sweep [16,128]: eager {ms:.4f} ms, graph replay "
            f"{g_ms:.4f} ms; [1,128]: eager {cuda_ms(sweep1, 200):.4f} ms, "
            f"graph replay {graph_ms(sweep1, 100):.4f} ms")
    if hasattr(k, "nms_launch_shape"):
        blocks, threads = k.nms_launch_shape()
        e16 = graph_ms(lambda: k.empty_launch(16 * blocks, threads), 100)
        e1 = graph_ms(lambda: k.empty_launch(blocks, threads), 100)
        line += ("; an empty kernel of the same launch shape, graph replay: "
                 f"for 16 images {e16:.4f} ms, for 1 image {e1:.4f} ms")
    log(line)
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
    # a ladder: every box overlaps only its two neighbours, so the kept boxes
    # alternate and each decision hangs on the one before it, the longest
    # chain a sweep can meet
    step = 25.0 * torch.arange(128, device=dev)
    ladder = torch.stack([step, 0 * step, step + 100.0, 0 * step + 100.0],
                         -1).expand(16, 128, 4).contiguous()
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


def profile_serving(pipe, images, height, thres, iters=3):
    """torch.profiler over `iters` infer_serving batches: per-stage host and
    device time, device busy share, kernel table to chiprun_out/."""
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
    with open(os.path.join(REPO, "chiprun_out", "port_profile_b16.txt"),
              "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=60))


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
    pipe = InferencePipeline(device=dev)
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
                        for key, v in m1["stages"].items()},
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


def run_cli(golden, repo):
    """The CLI in a subprocess on a directory of the scenes."""
    import ast
    import re
    import shutil
    import tempfile

    import numpy as np

    height, thres = golden["person_height_cm"], golden["det_threshold"]
    with tempfile.TemporaryDirectory() as tmp:
        media, out = os.path.join(tmp, "media"), os.path.join(tmp, "out")
        os.makedirs(media)
        for name in golden["scenes"]:
            shutil.copy(os.path.join(DATA, name), media)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "human_body_proportion_estimation_tpu_torch.cli.detect_pose",
             "-i", media, "-o", out, "-t", str(thres), "-p", str(height)],
            cwd=repo, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stderr[-4000:]
        saved = sorted(os.listdir(os.path.join(out, "tpu_pdet_pose")))
    frames = [f for f in saved if f.startswith("frame_")]
    assert len(frames) == 3, saved
    dicts = [ast.literal_eval(m) for m in
             re.findall(r"\{'[^{}]*\}", proc.stdout)]
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
                   "ensemble_edet4_person_det_pose", "hrnet"]
NOT_PORTED = ["higherhrnet", "ssd_mobilenet", "yolov5m", "yolov5s"]
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

    def record(boxes, scores, t):
        keep = launch(boxes, scores, t)
        seen.append((boxes.clone(), scores.clone(), t, keep.clone()))
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
            assert all(r["weights"] == "synthetic-certified" for r in index)
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
            for n in NOT_PORTED:
                status, _, _ = http._request_raw("GET", f"/v2/models/{n}",
                                                 b"", {})
                assert status == 404, (n, status)
            if not missing:
                assert [r["name"] for r in hbpe.repository_index()] == \
                    REGISTRY_MODELS
                for n in REGISTRY_MODELS:
                    m = kserve.get_model_metadata(n)
                    assert [list(t.shape) for t in m.outputs] == [
                        t["shape"] for t in meta[n]["outputs"]], n
                    assert hbpe.model_config(n)["max_batch_size"] == \
                        conf[n]["max_batch_size"]
            log("phase C: index and documents of the 4 models at full width "
                "agree over " + ", ".join(clients))

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
                for boxes, scores, t, keep in seen:
                    assert boxes.is_cuda and boxes.shape == (
                        1, cfg.detector.nms_top_k, 4), boxes.shape
                    plain = k.nms_sweep_plain(boxes, scores, t)
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
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
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
        launches, pipe, golden, scene_bytes = run_main_path(
            k, dev, profile=args.profile)
        edge = run_serving_edge(k, pipe, golden, scene_bytes)
        run_cli(golden, os.path.abspath(args.repo))
        wire_launches = run_registry_and_wire(k, pipe, golden, scene_bytes)
        # the kernels line counts the launches of every path driven: the
        # main path (phase 3), the serving edge (A) and the registry and
        # wire protocols (C), each counted from 0 just before it
        launches = {name: launches[name] + edge["launches"][name]
                    + wire_launches[name] for name in launches}
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
    if args.kernels_only:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
