"""Bottom-up multi-person pipeline (port of the JAX package's
`pipeline/bottomup.py`): one HigherHRNet pass over the whole image and
associative-embedding grouping in place of a detector.

    uint8 [B, 512, 512, 3] -> HigherHRNet (output_1 at 1/4, output_2 at
    1/2) -> heatmaps aggregated at 1/2 -> AE decode (`ops/ae_grouping`)
    -> keypoint gates -> keypoint-extent box -> pixel->cm -> 11 segments

Multi-person pose costs ONE model pass an image whatever the person count:
no detector, no per-person crops. The input size is the reference's fixed
512x512 fallback for dynamic-shaped pose models
(`pose_est_hrnet_trtserver.py:51-52`). Heatmap aggregation is the standard
HigherHRNet evaluation: the 1/4-res "output_1" heatmaps are upsampled
bilinearly to 1/2 res and averaged with "output_2"; the tags are
upsampled alongside. The whole forward stays on the device; the stages
are profiler spans (`utils.profiling.span`: `hbpe.bottomup_model`,
`hbpe.bottomup_decode`) that `chip_smoke.py --profile` reads.

It launches none of the port's CUDA kernels: the JAX bottom-up program
reaches no Pallas kernel, and its max-pool, top-k, grouping loop and
upsample are plain PyTorch here as they are plain XLA there.

`BottomUpProgram` is the serving forward as an `nn.Module`, what
`torch.export` takes for the bottom-up artifact (`pipeline/export.py`):
(images, heights, orig_hw) -> packed, the AE decode inside.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
    HigherHRNet,
)
from human_body_proportion_estimation_tpu_torch.models.layers import (
    init_random,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    maybe_load_certified,
)
from human_body_proportion_estimation_tpu_torch.ops import (
    ae_grouping as ae,
    heatmap as hm_ops,
    proportions as prop_ops,
)
from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
    pad_to_shards,
    replica,
    to_shards,
)
from human_body_proportion_estimation_tpu_torch.pipeline.full import (
    pack_serving,
)
from human_body_proportion_estimation_tpu_torch.pipeline.host import (
    _pad_batch,
    resize_for_detector,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    PipelineConfig,
)
from human_body_proportion_estimation_tpu_torch.utils.logging import (
    get_logger,
)
from human_body_proportion_estimation_tpu_torch.utils.profiling import (
    span,
    stage_of,
)


class BottomUpOutputs(NamedTuple):
    boxes_orig: torch.Tensor     # [B, P, 4] yxyx keypoint bbox, original px
    person_valid: torch.Tensor   # [B, P] bool
    keypoints: torch.Tensor      # [B, P, 17, 2] (x, y) original-image px
    kp_scores: torch.Tensor      # [B, P, 17]
    kp_visible: torch.Tensor     # [B, P, 17] bool
    lengths_cm: torch.Tensor     # [B, P, 11]
    seg_visible: torch.Tensor    # [B, P, 11] bool


def prepare_batch_bottomup(images_rgb, person_heights, b: int, p: int,
                           input_hw) -> tuple:
    """Host-side batch assembly to a FIXED batch size `b`: (batch u8
    [b, H, W, 3], heights f32 [b, P], orig_hw f32 [b, 2], n). No detector
    inputs; the per-request height semantics of `host.prepare_batch`."""
    n = len(images_rgb)
    if n > b:
        raise ValueError(f"{n} images exceed fixed batch size {b}")
    h, w = input_hw
    batch = np.zeros((b, h, w, 3), np.uint8)
    orig_hw = np.ones((b, 2), np.float32)
    heights = np.full((b, p), 175.0, np.float32)
    for i, img in enumerate(images_rgb):
        batch[i] = resize_for_detector(img, w, h)
        orig_hw[i] = img.shape[:2]
        hi = person_heights
        if np.isscalar(hi):
            heights[i, :] = float(hi)
        else:
            per_img = hi[i] if isinstance(hi[i], (list, tuple)) else hi
            for slot in range(p):
                heights[i, slot] = float(per_img[min(slot, len(per_img) - 1)])
    return batch, heights, orig_hw, n


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, 2H, 2W] bilinear with half-pixel centres,
    the border pixels repeated: `jax.image.resize(..., "bilinear")` of a
    2x upsample (its border weights renormalize to the same values)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False, antialias=False)


class BottomUpPipeline:
    """Owns the HigherHRNet slot and the bottom-up forward on one device.

    `pose_state`: a port `state_dict` of `models.higherhrnet.HigherHRNet`
    (`models.weights.flax_to_state_dict` of flax variables, or
    `maybe_load_certified(bottom_up=True)`), labelled "real" in
    `weights_origin` (callers relabel the certified checkpoint
    "synthetic-certified"); without one the model is initialized at random
    as flax's init with PRNGKey(0) does (`models.layers.init_random`),
    labelled "random", with the JAX package's warning. `dtype`: the trunk's
    compute dtype (bf16 by default; f32 for numerics-sensitive
    comparisons). `model`: a HigherHRNet instance in place of the default
    W32 one (the tests' depth-reduced config). `mesh`: a
    `parallel.mesh.Mesh` to serve data-parallel over its 'data' axis, as
    `InferencePipeline(mesh=)` does: the model replicated once on each
    other device of the mesh, the batch padded to a multiple of dp, each
    shard's forward and decode on its device, the rows back in order.

    `stages`: an optional `utils.profiling.StageTimer` that
    `infer_serving` reports `host_prepare`, `device_upload` and
    `device_compute_readback` to, as `InferencePipeline` does.
    """

    INPUT_HW = (512, 512)   # reference pose driver fallback (:51-52)

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        pose_state: Optional[Mapping[str, torch.Tensor]] = None,
        max_people: Optional[int] = None,
        max_cands: int = 8,
        tag_threshold: float = 1.0,
        score_threshold: float = 0.1,
        person_score_threshold: float = 0.25,
        device: str | torch.device = "cuda",
        dtype: torch.dtype = torch.bfloat16,
        model: Optional[HigherHRNet] = None,
        mesh=None,
    ):
        self.mesh = mesh
        if mesh is not None:
            device = mesh.data_devices[0]
        self.config = config or PipelineConfig()
        self.max_people = max_people or self.config.detector.max_persons
        self.max_cands = max_cands
        self.tag_threshold = tag_threshold
        self.score_threshold = score_threshold
        # person-level mean-score gate (ops/ae_grouping.group_keypoints):
        # kills phantom groups opened by stray sub-peaks
        self.person_score_threshold = person_score_threshold
        self.device = torch.device(device)
        torch.empty(0, device=self.device)  # an unusable device fails here
        if self.device.type == "cuda":
            # HigherHRNet's heads are f32 convs: keep TF32 off, as the
            # JAX package computes them in full f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = model if model is not None else HigherHRNet(dtype=dtype)
        if pose_state is not None:
            model.load_state_dict(pose_state, strict=True)
        else:
            init_random(model)
        self.model = model.to(self.device).eval()
        # serving-edge integration (InferencePipeline's contract): /health
        # weight provenance, --prewarm, and the optional stage timer
        self.weights_origin = {
            "pose": "real" if pose_state is not None else "random"}
        self.stages = None
        self.prewarmed = False
        if self.weights_origin["pose"] == "random":
            get_logger("pipeline").warning(
                "random_weights",
                msg="RANDOM-INIT HigherHRNet IN USE — bottom-up outputs are "
                    "garbage; pass pose_state",
                **self.weights_origin,
            )

    @property
    def shard_models(self) -> list:
        """The model of each data shard (one without a mesh): `model`
        replicated on the shard's device."""
        if self.mesh is None:
            return [self.model]
        return [replica(self.model, d) for d in self.mesh.data_devices]

    # ------------------------------------------------------------------ #

    def aggregate(self, images: torch.Tensor, model=None):
        """uint8 [B, H, W, 3] -> (heat, tags), both f32 [B, K, H/2, W/2]:
        the maps at 1/2 resolution of `model` (the pipeline's by
        default)."""
        k = self.config.pose.num_keypoints
        x = images.permute(0, 3, 1, 2).float() / 255.0
        outs = (model or self.model)(x)
        out1, out2 = outs["output_1"], outs["output_2"]
        heat = (upsample2x(out1[:, :k]) + out2) / 2.0
        return heat, upsample2x(out1[:, k:])

    @torch.inference_mode()
    def forward(
        self,
        images: torch.Tensor,          # [B, 512, 512, 3] uint8 RGB
        person_heights: torch.Tensor,  # [B, P] cm
        orig_hw: torch.Tensor,         # [B, 2]
    ) -> BottomUpOutputs:
        return self.outputs(images, person_heights, orig_hw)

    def outputs(self, images, person_heights, orig_hw,
                model=None) -> BottomUpOutputs:
        """`forward` without `torch.inference_mode` (`BottomUpProgram`),
        on `model` (the pipeline's by default)."""
        with span("bottomup_model"):
            heat, tags = self.aggregate(images, model)
        with span("bottomup_decode"):
            return self.decode(heat, tags, person_heights, orig_hw)

    def decode(self, heat, tags, person_heights, orig_hw) -> BottomUpOutputs:
        """Aggregated (heat, tags) [B, K, Hh, Wh] -> the outputs in
        original-image pixels and cm."""
        cfg = self.config
        hh, hw = heat.shape[-2:]
        grouped = ae.decode_bottom_up(
            heat, tags, max_people=self.max_people, max_cands=self.max_cands,
            score_threshold=self.score_threshold,
            tag_threshold=self.tag_threshold,
            person_score_threshold=self.person_score_threshold,
        )

        # heatmap space -> original-image coords, (x, y)
        scale = torch.stack([orig_hw[:, 1] / hw, orig_hw[:, 0] / hh],
                            dim=-1)[:, None, None, :]
        kp_img = grouped.keypoints * scale
        kp_visible = (
            hm_ops.gate_keypoints(grouped.scores,
                                  cfg.pose.keypoint_thresholds)
            & (grouped.scores > 0)
        )

        # person box from the visible joints (the pixel->cm scale and the
        # response's box; the reference takes the scale from the detector
        # box, person_det_pose_edet4_trtserver.py:166-168: bottom-up has no
        # detector, so the keypoint extent stands in)
        big = 1e9
        xs, ys = kp_img[..., 0], kp_img[..., 1]
        x1 = torch.where(kp_visible, xs, big).amin(-1)
        y1 = torch.where(kp_visible, ys, big).amin(-1)
        x2 = torch.where(kp_visible, xs, -big).amax(-1)
        y2 = torch.where(kp_visible, ys, -big).amax(-1)
        person_valid = grouped.valid & (kp_visible.sum(-1) >= 2)
        boxes = torch.where(person_valid[..., None],
                            torch.stack([y1, x1, y2, x2], dim=-1), 0.0)

        pixel_to_cm = person_heights / (y2 - y1).clamp_min(1.0)
        seg = prop_ops.segment_lengths(kp_img, kp_visible, pixel_to_cm)
        seg_visible = seg.visible & person_valid[..., None]
        return BottomUpOutputs(
            boxes_orig=boxes,
            person_valid=person_valid,
            keypoints=kp_img,
            kp_scores=grouped.scores,
            kp_visible=kp_visible,
            lengths_cm=torch.where(seg_visible, seg.lengths_cm, 0.0),
            seg_visible=seg_visible,
        )

    def forward_serving(self, images, person_heights, orig_hw,
                        model=None) -> torch.Tensor:
        """Packed [B, P, 23] (valid | 11 lengths | 11 visibility) of
        `model` (the pipeline's by default): the single-readback serving
        layout of the top-down pipeline, so the HTTP / gRPC edge and its
        batchers serve both alike. Without `torch.inference_mode`, as
        `BottomUpProgram` exports it; `infer_serving` runs it under one."""
        out = self.outputs(images, person_heights, orig_hw, model)
        return pack_serving(out.person_valid, out.lengths_cm,
                            out.seg_visible)

    def _stage(self, name: str):
        return stage_of(self.stages, name)

    def _upload(self, arrays) -> list:
        """Host arrays -> [per shard: the arrays' rows on its device]."""
        with self._stage("device_upload"):
            return to_shards(arrays, [self.device] if self.mesh is None
                             else self.mesh.data_devices)

    @torch.inference_mode()
    def _run(self, shards, packed: bool):
        """Each shard's forward on its own model (packed rows, or the
        outputs), read back and concatenated in order."""
        run = self.forward_serving if packed else self.outputs
        outs = [run(*args, model=model)
                for model, args in zip(self.shard_models, shards)]
        if packed:
            return np.concatenate([o.cpu().numpy() for o in outs])
        return BottomUpOutputs(*(np.concatenate([x.cpu().numpy()
                                                 for x in parts])
                                 for parts in zip(*outs)))

    def _padded(self, b: int) -> int:
        if self.mesh is None:
            return b
        return pad_to_shards(b, self.mesh.shape["data"])

    def infer_serving(
        self,
        images_rgb: Sequence[np.ndarray],
        person_heights: Sequence[float] | float = 175.0,
        det_threshold=0.70,  # accepted for the edge's interface; the
        # bottom-up path has no detector: the heatmap-peak score_threshold
        # governs visibility instead
    ) -> np.ndarray:
        """One packed [n, P, 23] array, the batch padded to the
        power-of-two bucket as `InferencePipeline.infer_serving` pads it."""
        with self._stage("host_prepare"):
            b = self._padded(_pad_batch(len(images_rgb),
                                        self.config.serve.max_batch))
            *arrays, n = prepare_batch_bottomup(
                images_rgb, person_heights, b, self.max_people, self.INPUT_HW)
        shards = self._upload(arrays)
        with self._stage("device_compute_readback"):
            packed = self._run(shards, packed=True)
        return packed[:n]

    def infer_images(
        self,
        images_rgb: Sequence[np.ndarray],
        person_heights: Sequence[float] | float = 175.0,
    ) -> BottomUpOutputs:
        """Host path: resize to 512x512, run the n images (unpadded; under
        a mesh padded to a multiple of dp), fetch every output as a numpy
        array."""
        n = len(images_rgb)
        b = self._padded(n)
        h, w = self.INPUT_HW
        batch = np.zeros((b, h, w, 3), np.uint8)
        orig_hw = np.ones((b, 2), np.float32)
        heights = np.full((b, self.max_people), 175.0, np.float32)
        for i, img in enumerate(images_rgb):
            batch[i] = resize_for_detector(img, w, h)
            orig_hw[i] = img.shape[:2]
            hi = person_heights
            heights[i, :] = float(hi if np.isscalar(hi) else hi[i])
        out = self._run(self._upload((batch, heights, orig_hw)), packed=False)
        return BottomUpOutputs(*(x[:n] for x in out))


class BottomUpProgram(torch.nn.Module):
    """`BottomUpPipeline.forward_serving` as a module: (images u8
    [B, 512, 512, 3], heights [B, P], orig_hw [B, 2]) -> packed
    [B, P, 23]. Its submodule is the pipeline's HigherHRNet (shared, not
    copied); the decode settings are the pipeline's."""

    def __init__(self, pipeline: BottomUpPipeline):
        super().__init__()
        self.model = pipeline.model
        self._pipeline = (pipeline,)   # a tuple: not registered as a module

    def forward(self, images, person_heights, orig_hw):
        return self._pipeline[0].forward_serving(images, person_heights,
                                                 orig_hw)


def build_default(device: str | torch.device = "cuda",
                  dtype: torch.dtype = torch.bfloat16,
                  mesh=None, pose_state=None) -> BottomUpPipeline:
    """The bottom-up pipeline the server's `--bottom-up` and the CLI build:
    `pose_state` (a checkpoint's HigherHRNet, labelled "real") when given,
    else the committed synthetic-certified HigherHRNet where the
    repository holds it (`models.weights.maybe_load_certified(
    bottom_up=True)`), labelled so, else a random HigherHRNet labelled
    "random"; over `mesh` when given."""
    certified = pose_state is None
    if certified:
        _, pose_state = maybe_load_certified(bottom_up=True)
    pipeline = BottomUpPipeline(pose_state=pose_state, device=device,
                                dtype=dtype, mesh=mesh)
    if certified and pose_state is not None:
        pipeline.weights_origin["pose"] = "synthetic-certified"
    return pipeline
