"""Wrappers of the port's three CUDA kernels, their plain PyTorch versions,
and their launch counters.

Port of the JAX package's `ops/pallas_kernels.py`:

  JAX (Pallas, TPU)                         port (CUDA, sm_90a)
  decode_heatmaps_pallas  :56               decode_heatmaps  csrc/decode_heatmaps.cu
  head_score_epilogue     :228              head_score_levels csrc/head_score.cu
                                            (all pyramid levels in one launch;
                                            head_score is its one-level form)
  nms_sweep_pallas_batched :151 (+ :190)    nms_sweep        csrc/nms_sweep.cu

Each kernel is a `torch.library` custom op in the `hbpe` namespace
(`torch.ops.hbpe.decode_heatmaps`, `.head_score_levels`, `.nms_sweep`), so
that `torch.export` captures a call as one node of the graph and an
exported program (`pipeline/export.py`) runs the same kernels as the live
path. Dispatch is by the device of the input and nothing else: the op's
CPU implementation is the plain version (the CPU tests), its CUDA
implementation launches the kernel or raises, and its fake implementation
gives the output shapes to a trace. There is no fallback from a failed
launch to the plain version. The public wrappers below keep the shape
checks; the dtype, contiguity and alignment checks and the launch counts
live in the CUDA implementations, which see real tensors only. Every
launch adds one to `LAUNCHES[name]`, so a run can show that it went
through the kernels (`reset_launch_counts` / `launch_counts`). Importing
this module registers the ops: `torch.export.load` of a program that
calls them needs that first.

The serving edge runs two batches at once on two threads, so the first
load of the kernel library, the cache of packed head weights and the
launch counters each take a lock.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import torch
from torch.library import custom_op

from human_body_proportion_estimation_tpu_torch.ops import (
    heatmap as hm_ops,
    nms as nms_ops,
)

LAUNCHES: Dict[str, int] = {
    "decode_heatmaps": 0, "head_score": 0, "nms_sweep": 0,
}
_LAUNCHES_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with _LAUNCHES_LOCK:
        return dict(LAUNCHES)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors must all be on cpu or all on cuda: {devs}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _launch(name: str, fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    _count(name)


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The kernel library, built and loaded at the first launch (once, when
    two threads launch their first kernel together)."""
    global _LIB
    if _LIB is None:
        from human_body_proportion_estimation_tpu_torch.ops.build import (
            load_library,
        )

        with _LIB_LOCK:
            if _LIB is None:
                _LIB = load_library()
    return _LIB


# --------------------------------------------------------------------- #
# heatmap decode


def decode_heatmaps_plain(
    heatmaps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return tuple(hm_ops.decode_heatmaps(heatmaps))


@custom_op("hbpe::decode_heatmaps", mutates_args=(), device_types="cpu")
def _decode_heatmaps_op(
    heatmaps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return decode_heatmaps_plain(heatmaps)


@_decode_heatmaps_op.register_kernel("cuda")
def _decode_heatmaps_cuda(heatmaps):
    _check(heatmaps, "heatmaps", torch.float32, 4)
    n, k, h, w = heatmaps.shape
    kp = torch.empty((n, k, 2), dtype=torch.float32, device=heatmaps.device)
    scores = torch.empty((n, k), dtype=torch.float32, device=heatmaps.device)
    _launch("decode_heatmaps", _lib().hbpe_decode_heatmaps,
            heatmaps.data_ptr(), kp.data_ptr(), scores.data_ptr(),
            n * k, h * w, w)
    return kp, scores


@_decode_heatmaps_op.register_fake
def _decode_heatmaps_fake(heatmaps):
    n, k = heatmaps.shape[:2]
    return (heatmaps.new_empty((n, k, 2), dtype=torch.float32),
            heatmaps.new_empty((n, k), dtype=torch.float32))


def decode_heatmaps(
    heatmaps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, K, H, W] f32 -> (keypoints [N, K, 2] (x, y), scores [N, K])."""
    _on_cpu(heatmaps)
    if heatmaps.dim() != 4:
        raise ValueError(
            f"heatmaps: expected 4 dims, got {tuple(heatmaps.shape)}")
    return tuple(_decode_heatmaps_op(heatmaps))


# --------------------------------------------------------------------- #
# detection-head score epilogue

MAX_LEVELS = 8          # level pointers in the kernel's parameter struct
MAX_FEATURES = 256      # F: a multiple of 16, A operand held in registers
CLASS_PAD = 96          # class rows of one anchor's weight slab (wgmma N)


def head_score_plain(
    z: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    anchors_per_cell: int,
    num_classes: int,
    person_class0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as the kernel with the logits materialized:
    bf16-rounded inputs, f32 products and sums, + bias, then the per-anchor
    class max and the person logit taken from the same tensor."""
    b, h, w, f = z.shape
    zf = z.reshape(-1, f).to(torch.bfloat16).float()
    wf = weight.to(torch.bfloat16).float()
    y = zf @ wf.t() + bias.float()
    y = y.reshape(b, h, w, anchors_per_cell, num_classes)
    return y.amax(-1), y[..., person_class0].contiguous()


def head_score_levels_plain(
    zs: Sequence[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    anchors_per_cell: int,
    num_classes: int,
    person_class0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`head_score_plain` level by level, flattened and concatenated
    level-major: (best [B, N], person [B, N]), N = sum_l H_l * W_l * A."""
    outs = [head_score_plain(z, weight, bias, anchors_per_cell, num_classes,
                             person_class0) for z in zs]
    b = zs[0].shape[0]
    return (torch.cat([o[0].reshape(b, -1) for o in outs], 1),
            torch.cat([o[1].reshape(b, -1) for o in outs], 1))


def head_k_permutation(f: int) -> torch.Tensor:
    """Feature index behind each position of the kernel's K axis, padded to
    a multiple of 32 (indices >= f are padding).

    The kernel holds z in registers as the wgmma A operand. A k-step of 16
    gives thread t of a quad the columns 2t, 2t+1, 2t+8, 2t+9; so that the
    thread can fetch them with one 16-byte load per pair of k-steps, it
    owns features 32p + 8t .. 32p + 8t + 7 of every 32: +0..3 feed k-step
    2p, +4..7 feed k-step 2p + 1. The weight slabs are packed in the same
    order, which a dot product does not notice."""
    pos = torch.arange(-(-f // 32) * 32)
    chunk, e = pos // 8, pos % 8          # 16-byte chunk of K, element in it
    return (32 * (chunk // 4) + 8 * (e // 2) + 4 * ((chunk // 2) % 2)
            + 2 * (chunk % 2) + e % 2)


def pack_head_weights(
    weight: torch.Tensor, bias: torch.Tensor, anchors_per_cell: int,
    num_classes: int, person_class0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight [A*C, F], bias [A*C] -> (slabs [A, Kp/8, 96, 8] bf16,
    bias [A, 4, 24] f32), the operands as csrc/head_score.cu reads them.

    Classes: each anchor's C classes are padded to 96 columns with zero
    weights and a -inf bias, and the person class changes places with
    class 0, so that the kernel finds the person logit in a fixed register
    (the class max does not depend on the order).
    Slabs: one contiguous slab per anchor in the unswizzled core-matrix
    layout `wgmma` reads B from (8 rows x 16 bytes a core matrix; K chunks
    outermost), K padded to Kp = ceil(F/32)*32 with zeros and taken in
    `head_k_permutation` order.
    Bias: thread t of a quad holds the columns 8j + 2t, 8j + 2t + 1
    (j = 0..11) of an accumulator row; its 24 bias values lie together, in
    that order, at [anchor, t]."""
    a, c = anchors_per_cell, num_classes
    f = weight.shape[1]
    order = torch.arange(c, device=weight.device)
    order[0], order[person_class0] = person_class0, 0
    perm = head_k_permutation(f).to(weight.device)
    kp = perm.numel()
    wpad = torch.zeros((a, CLASS_PAD, kp), dtype=torch.bfloat16,
                       device=weight.device)
    wpad[:, :c, :f] = weight.reshape(a, c, f)[:, order].to(torch.bfloat16)
    slabs = wpad[:, :, perm].reshape(a, CLASS_PAD, kp // 8, 8)
    slabs = slabs.permute(0, 2, 1, 3).contiguous()
    bias_p = torch.full((a, CLASS_PAD), float("-inf"), dtype=torch.float32,
                        device=bias.device)
    bias_p[:, :c] = bias.reshape(a, c)[:, order.to(bias.device)].float()
    # [A, j, t, i] -> [A, t, j, i]: column 8j + 2t + i
    bias_p = bias_p.reshape(a, CLASS_PAD // 8, 4, 2).permute(0, 2, 1, 3)
    return slabs, bias_p.reshape(a, 4, CLASS_PAD // 4).contiguous()


# packed weights of the last few (weight, bias) pairs seen. An entry keeps
# its source tensors alive, so their addresses cannot be handed to other
# tensors while it is here; the version counter catches in-place updates
# (tensors made under `torch.inference_mode` have none).
_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()
_PACKED_MAX = 4
_PACKED_LOCK = threading.Lock()


def _version(t: torch.Tensor) -> int:
    return -1 if t.is_inference() else t._version


def _packed_head_weights(weight, bias, a, c, person0):
    key = (weight.data_ptr(), _version(weight), bias.data_ptr(),
           _version(bias), a, c, person0)
    with _PACKED_LOCK:
        hit = _PACKED.get(key)
        if hit is None:
            hit = (weight, bias,
                   *pack_head_weights(weight, bias, a, c, person0))
            _PACKED[key] = hit
            while len(_PACKED) > _PACKED_MAX:
                _PACKED.popitem(last=False)
    return hit[2], hit[3]


@custom_op("hbpe::head_score_levels", mutates_args=(), device_types="cpu")
def _head_score_levels_op(
    zs: List[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    anchors_per_cell: int,
    num_classes: int,
    person_class0: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return head_score_levels_plain(zs, weight, bias, anchors_per_cell,
                                   num_classes, person_class0)


@_head_score_levels_op.register_kernel("cuda")
def _head_score_levels_cuda(zs, weight, bias, anchors_per_cell,
                            num_classes, person_class0):
    a = anchors_per_cell
    for li, z in enumerate(zs):
        _check(z, f"z[{li}]", torch.bfloat16, 4)
    for t, name in ((weight, "weight"), (bias, "bias")):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: expected float32 or bfloat16, got "
                            f"{t.dtype}")
    slabs, bias_p = _packed_head_weights(weight, bias, a, num_classes,
                                         person_class0)
    b, f = zs[0].shape[0], zs[0].shape[3]
    cells = [z.shape[1] * z.shape[2] for z in zs]
    nl = len(zs)
    col0, n = [], 0
    for n_cells in cells:
        col0.append(n)
        n += a * n_cells
    best = torch.empty((b, n), dtype=torch.float32, device=weight.device)
    person = torch.empty((b, n), dtype=torch.float32, device=weight.device)
    ints = ctypes.c_int * nl
    _launch("head_score", _lib().hbpe_head_score_levels,
            (ctypes.c_void_p * nl)(*[z.data_ptr() for z in zs]),
            ints(*[b * n_cells for n_cells in cells]), ints(*cells),
            ints(*col0), nl, slabs.data_ptr(), bias_p.data_ptr(),
            best.data_ptr(), person.data_ptr(), n, f, a)
    return best, person


@_head_score_levels_op.register_fake
def _head_score_levels_fake(zs, weight, bias, anchors_per_cell,
                            num_classes, person_class0):
    n = sum(z.shape[1] * z.shape[2] for z in zs) * anchors_per_cell
    shape = (zs[0].shape[0], n)
    return (zs[0].new_empty(shape, dtype=torch.float32),
            zs[0].new_empty(shape, dtype=torch.float32))


def head_score_levels(
    zs: Sequence[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    anchors_per_cell: int,
    num_classes: int,
    person_class0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused class-head predict conv + score reduction for all pyramid
    levels in ONE launch.

    zs: up to 8 head-feature tensors [B, H_l, W_l, F] (NHWC, as the JAX
    function takes them), weight [A*C, F] (the 1x1 predict conv's OIHW
    weight without its unit spatial dims), bias [A*C]. F must be a multiple
    of 16 and <= 256, C <= 96. On CUDA, zs must already be bf16,
    contiguous and 16-byte aligned; weight and bias are f32 or bf16 (the
    kernel takes them packed, `pack_head_weights`, in bf16 and f32: the
    packing is cached by the tensors' addresses and versions, so a model
    that passes its own parameters packs once). Returns
    (best_logit, person_logit), each [B, N] f32 with the levels
    concatenated in order (N = sum_l H_l * W_l * A): the kernel writes
    every level straight into these buffers.
    """
    a, c = anchors_per_cell, num_classes
    if not 1 <= len(zs) <= MAX_LEVELS:
        raise ValueError(f"expected 1..{MAX_LEVELS} levels, got {len(zs)}")
    b, f = (zs[0].shape[0], zs[0].shape[3]) if zs[0].dim() == 4 else (0, 0)
    for z in zs:
        if z.dim() != 4 or z.shape[0] != b or z.shape[3] != f:
            raise ValueError(
                "every level must be [B, H, W, F] with one B and one F: "
                f"{[tuple(t.shape) for t in zs]}")
    if f % 16 or not 0 < f <= MAX_FEATURES:
        raise ValueError(
            f"F = {f}: must be a multiple of 16 and <= {MAX_FEATURES}")
    if not 0 < c <= CLASS_PAD or not 0 <= person_class0 < c or a < 1:
        raise ValueError(
            f"{a} anchors x {c} classes, person class {person_class0}: "
            f"expected 1..{CLASS_PAD} classes and a person class among them")
    if weight.shape != (a * c, f) or bias.shape != (a * c,):
        raise ValueError(
            f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} do not "
            f"match {a} anchors x {c} classes over {f} features"
        )
    _on_cpu(*zs, weight, bias)
    return tuple(_head_score_levels_op(list(zs), weight, bias, a, c,
                                       person_class0))


def head_score(
    z: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    anchors_per_cell: int,
    num_classes: int,
    person_class0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level of `head_score_levels` (the same kernel, one launch):
    z [B, H, W, F] -> (best_logit, person_logit), each [B, H, W, A] f32."""
    best, person = head_score_levels([z], weight, bias, anchors_per_cell,
                                     num_classes, person_class0)
    shape = (*z.shape[:3], anchors_per_cell)
    return best.reshape(shape), person.reshape(shape)


# --------------------------------------------------------------------- #
# NMS sweep


def nms_sweep_plain(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
    plus1: bool = False,
) -> torch.Tensor:
    return nms_ops.nms_mask(boxes, scores, iou_threshold,
                            legacy_plus1_iou=plus1)


MAX_NMS_K = 512     # candidates an image the sweep kernel takes


@custom_op("hbpe::nms_sweep", mutates_args=(), device_types="cpu")
def _nms_sweep_op(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_threshold: float, plus1: bool) -> torch.Tensor:
    return nms_sweep_plain(boxes, scores, iou_threshold, plus1)


@_nms_sweep_op.register_kernel("cuda")
def _nms_sweep_cuda(boxes, scores, iou_threshold, plus1):
    _check(boxes, "boxes", torch.float32, 3)
    _check(scores, "scores", torch.float32, 2)
    b, k, _ = boxes.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    _launch("nms_sweep", _lib().hbpe_nms_sweep,
            boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), b, k,
            float(iou_threshold), int(bool(plus1)))
    return keep


@_nms_sweep_op.register_fake
def _nms_sweep_fake(boxes, scores, iou_threshold, plus1):
    return scores.new_empty(scores.shape, dtype=torch.bool)


def nms_sweep(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
    plus1: bool = False,
) -> torch.Tensor:
    """Batched greedy-NMS keep masks: boxes [B, K, 4] xyxy sorted by
    descending score, scores [B, K] -> keep [B, K] bool. K <= 512. A box
    with a NaN coordinate overlaps nothing (every IoU with it is NaN), and
    a row whose score is 0, negative or NaN is dead, in the kernel as in
    the plain version. `plus1` takes the legacy +1-pixel IoU
    (`ops/nms.box_iou_plus1`) in place of `ops/boxes.box_iou`; both count
    as `nms_sweep` launches."""
    _on_cpu(boxes, scores)
    if (boxes.dim() != 3 or boxes.shape[2] != 4 or scores.dim() != 2
            or scores.shape != boxes.shape[:2]
            or boxes.shape[1] > MAX_NMS_K):
        raise ValueError(
            f"boxes {tuple(boxes.shape)} / scores {tuple(scores.shape)}: "
            f"expected [B, K, 4] / [B, K] with K <= {MAX_NMS_K}"
        )
    return _nms_sweep_op(boxes, scores, float(iou_threshold), bool(plus1))


def nms_launch_shape() -> Tuple[int, int]:
    """(thread blocks an image, threads a thread block) of the `nms_sweep`
    kernel, as csrc/nms_sweep.cu states them."""
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    _lib().hbpe_nms_launch_shape(ctypes.byref(blocks), ctypes.byref(threads))
    return blocks.value, threads.value


def empty_launch(blocks: int, threads: int) -> None:
    """Launch a kernel that does nothing, on the current CUDA stream. With
    `blocks` and `threads` from `nms_launch_shape` it has the launch shape
    of `nms_sweep`: timed beside it, it shows how much of the sweep's time
    is the launch itself. Not counted in `LAUNCHES`."""
    err = _lib().hbpe_empty_launch(
        int(blocks), int(threads), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty_launch: CUDA launch failed with error {err}")
