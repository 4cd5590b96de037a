#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py                 # all phases, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --ptxas         # also print nvcc -Xptxas -v
    python3 chip_smoke.py --profile       # + torch.profiler of B=16 serving

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. setup: the card, then build every kernel of `csrc/` from the checkout.
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the main path's shapes — heatmap decode [48,17,96,72] with
     planted ties and all-negative rows (exact), NMS sweep [16,128] at
     t = 0.5 and 0.3 with an at-threshold pair (exact), head-score on the
     five pyramid levels at B=16 with the certified predict_pw weights
     (|kernel - plain| <= 1e-3 + 1e-3 |plain|). Each is timed with CUDA
     events beside its plain version and a one-call PyTorch yardstick.
  3. main path: `InferencePipeline(device="cuda")` on the certified
     checkpoint answers 3 `infer_bytes` requests (scenes of
     tests/data/torch_port) and one `infer_serving` batch of 16, with the
     launch counters set to 0 just before and read just after; every
     kernel must have launched. The batch's packed output on the 3 scenes
     is held against the JAX package's goldens (identical person_valid;
     segments visible in both: mean |dcm| <= 1.0, max |dcm| <= 6.0), and
     infer_serving at B=16 is timed.
     With --profile, 3 more batches run under torch.profiler: per-stage
     host and device ms (the pipeline's record_function ranges), the
     device busy share, and the kernel table in
     chiprun_out/port_profile_b16.txt.
  4. report: a `kernels` JSON line, the card's name and power limit, and
     the result line {"ok": true, "device": {...}} last.

Imports nothing of JAX; builds into the package's gitignored `build/`.
"""

from __future__ import annotations

import argparse
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
    kp, sc = k.decode_heatmaps(hm)
    kp_p, sc_p = k.decode_heatmaps_plain(hm)
    torch.cuda.synchronize()
    assert torch.equal(kp, kp_p), "decode: keypoints differ from plain"
    assert torch.equal(sc, sc_p), "decode: scores differ from plain"
    err = float((kp - kp_p).abs().max())
    ms = cuda_ms(lambda: k.decode_heatmaps(hm), 200)
    plain_ms = cuda_ms(lambda: k.decode_heatmaps_plain(hm), 20)
    lib_ms = cuda_ms(lambda: torch.max(hm.flatten(2), -1), 200)
    b_ms, b_by = bound(hm.numel() * 4 + kp.numel() * 4 + sc.numel() * 4,
                       hm.numel(), F32_FLOP_PER_S)
    return dict(name="decode_heatmaps", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


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


def check_nms(k, dev):
    import torch

    boxes, scores = nms_inputs(dev)
    for t in (0.5, 0.3):
        got = k.nms_sweep(boxes, scores, t)
        ref = k.nms_sweep_plain(boxes, scores, t)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"nms: keep differs from plain at {t}"
    assert bool(got.any()) and not bool(got.all())
    ms = cuda_ms(lambda: k.nms_sweep(boxes, scores, 0.5), 200)
    plain_ms = cuda_ms(lambda: k.nms_sweep_plain(boxes, scores, 0.5), 3, 1)
    b, kk = scores.shape
    b_ms, b_by = bound(boxes.numel() * 4 + scores.numel() * 4 + b * kk,
                       14.0 * b * kk * kk, F32_FLOP_PER_S)
    return dict(name="nms_sweep", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


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
    err, n_person = 0.0, 0
    for z in zs:
        best, person = k.head_score(z, w, bias, a, c, 0)
        best_p, person_p = k.head_score_plain(z, w, bias, a, c, 0)
        torch.cuda.synchronize()
        for got, ref in ((best, best_p), (person, person_p)):
            d = (got - ref).abs()
            err = max(err, float(d.max()))
            assert bool((d <= HEAD_TOL[0] + HEAD_TOL[1] * ref.abs()).all()), \
                f"head_score: max |err| {float(d.max())}"
        # person is read back from a value the max ran over: never above
        # best, and equal to it wherever the person class won
        assert bool((person <= best).all()), "head_score: person > best"
        n_plain = int((person_p >= best_p).sum())
        n_kernel = int((person == best).sum())
        n_person += n_kernel
        assert abs(n_kernel - n_plain) <= max(1, n_plain // 1000), \
            f"head_score: person-argmax anchors {n_kernel} vs {n_plain}"

    def run_kernel():
        for z in zs:
            k.head_score(z, w, bias, a, c, 0)

    def run_plain():
        for z in zs:
            k.head_score_plain(z, w, bias, a, c, 0)

    def run_library():
        for z in zs:
            torch.matmul(z, w.t()).view(*z.shape[:3], a, c).amax(-1)

    ms = cuda_ms(run_kernel, 50)
    plain_ms = cuda_ms(run_plain, 10)
    lib_ms = cuda_ms(run_library, 50)
    m = sum(z.shape[0] * z.shape[1] * z.shape[2] for z in zs)
    nbytes = (m * f * 2 + len(zs) * (w.numel() * 2 + bias.numel() * 4)
              + 2 * m * a * 4)
    b_ms, b_by = bound(nbytes, 2.0 * m * f * a * c, BF16_FLOP_PER_S)
    log(f"head_score: {n_person} person-argmax anchors checked")
    return dict(name="head_score", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


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


def run_main_path(k, det_state, pose_state, dev, profile=False):
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

    pipe = InferencePipeline(det_state=det_state, pose_state=pose_state,
                             device=dev)
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
    for name, n in launches.items():
        assert n > 0, f"{name} never launched on the main path"
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
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
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

    det_state, pose_state = load_certified_states()
    results = [check_decode(k, dev), check_head_score(k, dev, det_state),
               check_nms(k, dev)]
    for r in results:
        log(f"kernel {r['name']}: ok, max_abs_err {r['max_abs_err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms)")

    launches = {r["name"]: None for r in results}
    if not args.kernels_only:
        launches = run_main_path(k, det_state, pose_state, dev,
                                 profile=args.profile)
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
             bound_by=r["bound_by"], library_ms=r["library_ms"])
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
