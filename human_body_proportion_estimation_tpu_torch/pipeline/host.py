"""Host-side orchestration around the fused forward (port of the JAX
package's `pipeline/host.py`): bytes -> RGB decode, resize to the detector
input, batch padding to power-of-two buckets, and shaping outputs into the
reference's response structures (`format_image_result`, `infer_bytes`).

`InferencePipeline` is the entry point the HTTP edge calls
(`infer_serving` through its batcher, `infer_bytes`). It runs on
`device="cuda"` unless the caller asks for the CPU; nothing moves to the
CPU by itself when CUDA is missing. It is safe to call from two threads at
once (the native batcher keeps two batches in flight).
"""

from __future__ import annotations

import io
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
    EFFICIENTDET_LITE0,
    EFFICIENTDET_LITE4,
    EfficientDet,
    EfficientDetConfig,
)
from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
    HigherHRNetHeatmaps,
)
from human_body_proportion_estimation_tpu_torch.models.hrnet import (
    HRNET_W32,
    HRNET_W48,
    HRNet,
    HRNetConfig,
)
from human_body_proportion_estimation_tpu_torch.models.layers import (
    init_random,
)
from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (
    load_ssd,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    default_certified_checkpoint,
    flax_to_state_dict,
    load_compact_checkpoint,
)
from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
    VARIANTS,
    YoloV5,
)
from human_body_proportion_estimation_tpu_torch.ops import (
    proportions as prop_ops,
)
from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
    Mesh,
    pad_to_shards,
    replica,
    to_shards,
)
from human_body_proportion_estimation_tpu_torch.pipeline.backends import (
    EfficientDetBackend,
    SSDBackend,
    YoloBackend,
)
from human_body_proportion_estimation_tpu_torch.pipeline.full import (
    PipelineOutputs,
    ServingProgram,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    PipelineConfig,
)
from human_body_proportion_estimation_tpu_torch.utils.logging import (
    get_logger,
)
from human_body_proportion_estimation_tpu_torch.utils.profiling import (
    stage_of,
)


# the pose slots (`PoseConfig.name`) and the HRNet configuration of each
# (HigherHRNet's trunk is HRNet-W32, as in the JAX package)
POSE_CONFIGS = {"hrnet_w32": HRNET_W32, "hrnet_w48": HRNET_W48,
                "higherhrnet": HRNET_W32}


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Raw encoded bytes -> RGB uint8 HWC (PIL)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img)


def load_image_path(path: str) -> np.ndarray:
    """Image file -> RGB uint8 HWC (cv2 BGR decode + flip)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise ValueError(f"could not decode image: {path}")
    return img[..., ::-1].copy()


def resize_for_detector(img: np.ndarray, width: int,
                        height: int) -> np.ndarray:
    """Host resize to the det input size (cv2 bilinear). An image already
    at that size is copied as is, which is what cv2.resize does for an
    unchanged size."""
    if img.shape[:2] == (height, width):
        return np.ascontiguousarray(img, dtype=np.uint8)
    import cv2

    return cv2.resize(img, (width, height)).astype(np.uint8)


def _pad_batch(n: int, max_batch: int) -> int:
    """Round up to the next power-of-two bucket."""
    b = 1
    while b < n:
        b *= 2
    return min(max(b, 1), max(max_batch, n))


def prepare_batch(cfg: PipelineConfig, images_rgb, person_heights,
                  det_threshold, b: int):
    """Host-side batch assembly to a FIXED batch size `b`.

    Returns (batch u8 [b,H,W,3], thresholds f32 [b], heights f32 [b,P],
    orig_hw f32 [b,2], n). `person_heights`: a scalar for all images, or
    per-image scalars/lists (`FLAGS.p_height[min(i, len-1)]` semantics).
    """
    n = len(images_rgb)
    if n > b:
        raise ValueError(f"{n} images exceed fixed batch size {b}")
    p = cfg.detector.max_persons
    h, w = cfg.detector.input_height, cfg.detector.input_width

    batch = np.zeros((b, h, w, 3), np.uint8)
    orig_hw = np.ones((b, 2), np.float32)
    heights = np.full((b, p), 175.0, np.float32)
    thresholds = np.full(
        (b,), det_threshold if np.isscalar(det_threshold) else 1.0,
        np.float32,
    )
    for i, img in enumerate(images_rgb):
        if not np.isscalar(det_threshold):
            thresholds[i] = float(det_threshold[i])
        batch[i] = resize_for_detector(img, w, h)
        orig_hw[i] = img.shape[:2]
        hi = person_heights
        if np.isscalar(hi):
            heights[i, :] = float(hi)
        else:
            per_img = hi[i] if isinstance(hi[i], (list, tuple)) else hi
            for slot in range(p):
                heights[i, slot] = float(per_img[min(slot, len(per_img) - 1)])
    return batch, thresholds, heights, orig_hw, n


def prewarm_serving(pipeline) -> list:
    """Run the serving forward once at every power-of-two batch bucket up
    to `serve.max_batch` (an artifact's one fixed batch: every count pads
    to it), so that the first real request at a bucket pays no first-call
    cost (the kernel library build and load, cuDNN's choice of algorithms
    for the new shapes, the packing of the head weights). The analog of
    Triton marking a model READY only after load + initialize (reference
    README.md:56-64). Returns the image counts warmed and sets
    `pipeline.prewarmed` for /health. Works on any pipeline with `config`,
    `infer_serving` and `prewarmed`: an `InferencePipeline`, a
    `pipeline.bottomup.BottomUpPipeline` (which ignores the threshold) or a
    `pipeline.export.ArtifactPipeline`."""
    art = getattr(pipeline, "artifact", None)
    max_batch = (art.effective_batch if art is not None
                 else pipeline.config.serve.max_batch)
    img = np.zeros((64, 48, 3), np.uint8)
    warmed = []
    n = 1
    while True:
        pipeline.infer_serving([img] * n, person_heights=175.0,
                               det_threshold=0.99)
        warmed.append(n)
        if n >= max_batch:
            break
        n = min(n * 2, max_batch)
    pipeline.prewarmed = True
    return warmed


def load_certified_states(path: Optional[str] = None):
    """(det_state, pose_state) port `state_dict`s from a compact `.npz`
    (default: the committed certified Lite4 + W32 checkpoint)."""
    det, pose = load_compact_checkpoint(path or default_certified_checkpoint())
    return flax_to_state_dict(det), flax_to_state_dict(pose)


class InferencePipeline:
    """Owns the models on one device; `infer_*` block until results are on
    the host.

    `detector`: the detector slot, `cfg.detector.name` by default:
    "efficientdet_lite4", "efficientdet_lite0", or "yolov5s" / "yolov5m" /
    "yolov5l" (the JAX package's `YoloBackend`), or "ssd_mobilenet"
    (`SSDBackend`, the JAX package's default). The EfficientDet
    architecture comes from the slot name unless `det_config` is given,
    as in the JAX package, so that a Lite0 slot never gets the Lite4
    graph.

    The pose slot is `cfg.pose.name`: "hrnet_w32", "hrnet_w48" or
    "higherhrnet" (`models.higherhrnet.HigherHRNetHeatmaps`, heatmaps at
    1/2 the crop); `pose_config` overrides the HRNet configuration of the
    slot (HigherHRNet's trunk).

    `det_state` / `pose_state`: port `state_dict`s (`load_certified_states`,
    or `models.weights.flax_to_state_dict` of flax variables), labelled
    "real" in `weights_origin` (what /health reports). The SSD slot's
    state also holds its anchor table under "anchors"
    (`models.ssd_mobilenet.ssd_state_dict`); given none, the SSD slot
    reads the reference's ssd.tflite (`models.ssd_mobilenet.load_ssd`,
    ValueError naming the path when the file is absent: JAX's SSD is
    never random), labelled "real". A slot given no
    state takes the committed certified checkpoint where its architecture
    is the certified one (the EfficientDet-Lite4 detector, the HRNet-W32
    pose), labelled "synthetic-certified" as the JAX server labels it;
    any other slot (EfficientDet-Lite0, YOLOv5, HRNet-W48, HigherHRNet:
    no weights for them are in the repository) is initialized at random
    as flax's init with PRNGKey(0) does (`models.layers.init_random`),
    labelled "random", with the JAX package's loud warning.

    `mesh`: a `parallel.mesh.Mesh` (`make_mesh`) to serve data-parallel
    over its 'data' axis, as the JAX pipeline's `mesh=` does: the models
    are built on the first shard's device and replicated once on every
    other device of the mesh (`parallel.mesh.replica`; a device listed
    twice shares one copy), a batch is padded to at least dp rows and a
    multiple of dp, each shard of contiguous rows runs the whole serving
    forward on its device (each kernel launches once per shard), and the
    rows come back in order. `device` is then the first shard's device.

    `stages`: an optional `utils.profiling.StageTimer` (the serving edge
    attaches one) that `infer_serving` reports its stages to:
    `host_prepare`, `device_upload` (closed once the copies have finished
    on the stream) and `device_compute_readback` (closed when the result
    is on the host), the stage names of the JAX package; inside the last,
    `device_issue` (the shards' forwards called, up to their return) and
    `device_readback` (the packed rows copied to the host). The issue is
    not host time alone: the forward copies host values to the card
    several times, and each copy waits for the stream to drain (PERF.md
    §5), so the readback finds the card done. Every batch also adds its
    image count to the counter `rows_real` and its padded bucket to
    `rows_run`.
    """

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        det_state: Optional[Mapping[str, torch.Tensor]] = None,
        pose_state: Optional[Mapping[str, torch.Tensor]] = None,
        device: str | torch.device = "cuda",
        det_config: Optional[EfficientDetConfig] = None,
        pose_config: Optional[HRNetConfig] = None,
        dtype: torch.dtype = torch.bfloat16,
        detector: Optional[str] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.config = cfg = config or PipelineConfig()
        detector = detector or cfg.detector.name
        self.mesh = mesh
        if mesh is not None:
            device = mesh.data_devices[0]
        self.device = torch.device(device)
        torch.empty(0, device=self.device)  # an unusable device fails here
        if self.device.type == "cuda":
            # The crop is f32 matmuls and HRNet's head an f32 conv: keep
            # TF32 (~3 decimal digits) off for both, as the JAX package
            # computes them in full f32.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        certified = []   # the certified (det, pose) states, read once

        def load(model, state, certified_slot):
            """`state`, else the certified checkpoint's slot
            `certified_slot` (0 detector, 1 pose; None where the
            architecture is not the certified one), else random; returns
            the slot's label."""
            if state is not None:
                model.load_state_dict(state, strict=True)
                return "real"
            if certified_slot is None:
                init_random(model)
                return "random"
            if not certified:
                certified.extend(load_certified_states())
            model.load_state_dict(certified[certified_slot], strict=True)
            return "synthetic-certified"

        if detector in VARIANTS:
            model = YoloV5(VARIANTS[detector], dtype=dtype)
            det_label = load(model, det_state, None)
            self.backend = YoloBackend(model.to(self.device).eval(), cfg)
        elif detector in ("efficientdet_lite4", "efficientdet_lite0"):
            if det_config is None:
                det_config = (EFFICIENTDET_LITE0
                              if detector == "efficientdet_lite0"
                              else EFFICIENTDET_LITE4)
            model = EfficientDet(
                det_config, dtype=dtype,
                person_class0=cfg.detector.person_class_id - 1,
            )
            det_label = load(model, det_state,
                             0 if det_config == EFFICIENTDET_LITE4 else None)
            self.backend = EfficientDetBackend(
                model.to(self.device).eval(), cfg, self.device)
        elif detector == "ssd_mobilenet":
            model, anchors = load_ssd(det_state, dtype=dtype,
                                      device=self.device)
            det_label = "real"   # the tflite's weights, or the caller's
            self.backend = SSDBackend(model, cfg, anchors)
        else:
            raise ValueError(f"unknown detector {detector!r}")

        pose_name = cfg.pose.name
        if pose_name not in POSE_CONFIGS:
            raise ValueError(f"unknown pose model {pose_name!r}")
        pose_config = pose_config or POSE_CONFIGS[pose_name]
        if pose_name == "higherhrnet":
            pose = HigherHRNetHeatmaps(pose_config, dtype=dtype)
        else:
            pose = HRNet(pose_config, dtype=dtype)
        pose_label = load(pose, pose_state, 1 if pose_name == "hrnet_w32"
                          and pose_config == HRNET_W32 else None)
        self.pose = pose.to(self.device).eval()

        self.weights_origin = origin = {"detector": det_label,
                                        "pose": pose_label}
        if "random" in origin.values():
            # the JAX package's warning: random weights give confident-
            # looking garbage, so a slot serving them says so
            get_logger("pipeline").warning(
                "random_weights",
                msg="RANDOM-INIT WEIGHTS IN USE — outputs are garbage; "
                    "pass det_vars/pose_vars (weights.load_pipeline_"
                    "checkpoint) or detector='ssd_mobilenet'",
                **origin,
            )
        self.stages = None
        self.prewarmed = False
        self.program = ServingProgram(cfg, self.backend, pose)

    @property
    def shard_programs(self) -> list:
        """The serving program of each data shard (one without a mesh):
        `program` replicated on the shard's device."""
        if self.mesh is None:
            return [self.program]
        return [replica(self.program, d) for d in self.mesh.data_devices]

    def _stage(self, name: str):
        return stage_of(self.stages, name)

    def _prepare(self, images_rgb, person_heights, det_threshold):
        """Host batch -> [per shard: (images, thresholds, heights,
        orig_hw) on the shard's device], n."""
        with self._stage("host_prepare"):
            b = _pad_batch(len(images_rgb), self.config.serve.max_batch)
            if self.mesh is not None:
                b = pad_to_shards(b, self.mesh.shape["data"])
            *arrays, n = prepare_batch(
                self.config, images_rgb, person_heights, det_threshold, b)
        if self.stages is not None:
            self.stages.count("rows_real", n)
            self.stages.count("rows_run", b)
        return self._upload(arrays), n

    def _upload(self, arrays) -> List[list]:
        with self._stage("device_upload"):
            return to_shards(arrays, [self.device] if self.mesh is None
                             else self.mesh.data_devices)

    def serving_rows(self, batch, thresholds, heights,
                     orig_hw) -> np.ndarray:
        """Packed [b, P, 23] rows of a prepared host batch (`prepare_batch`
        arrays, b a multiple of the mesh's dp): every shard's forward,
        then one readback each (`parallel.multihost` runs a process's
        rows through this)."""
        return self._serving(self._upload((batch, thresholds, heights,
                                           orig_hw)))

    @torch.inference_mode()
    def _serving(self, shards) -> np.ndarray:
        with self._stage("device_issue"):
            outs = [program(*args)
                    for program, args in zip(self.shard_programs, shards)]
        with self._stage("device_readback"):
            return np.concatenate([o.cpu().numpy() for o in outs])

    def infer_serving(
        self,
        images_rgb: Sequence[np.ndarray],
        person_heights: Sequence[float] | float = 175.0,
        det_threshold: Sequence[float] | float = 0.70,
    ) -> np.ndarray:
        """Lean serving path: one packed [n, P, 23] array
        (valid | lengths_cm x11 | seg_visible x11)."""
        shards, n = self._prepare(images_rgb, person_heights, det_threshold)
        with self._stage("device_compute_readback"):
            packed = self._serving(shards)
        return packed[:n]

    def infer_images(
        self,
        images_rgb: Sequence[np.ndarray],
        person_heights: Sequence[float] | float = 175.0,
        det_threshold: Sequence[float] | float = 0.70,
        with_heatmaps: bool = False,
    ) -> PipelineOutputs:
        """The fused forward on original-size RGB images; every output
        leaf comes back as a numpy array cut to the n real images."""
        shards, n = self._prepare(images_rgb, person_heights, det_threshold)
        with torch.inference_mode():
            outs = [program.outputs(*args, with_heatmaps)
                    for program, args in zip(self.shard_programs, shards)]
        return PipelineOutputs(*(
            None if parts[0] is None
            else np.concatenate([x.cpu().numpy() for x in parts])[:n]
            for parts in zip(*outs)
        ))

    def infer_bytes(
        self,
        image_bytes: bytes,
        person_height_cm: float = 175.0,
        det_threshold: float = 0.70,
    ) -> Dict[str, Any]:
        """bytes -> HTTP-layer response dict (reference server.py:46-67)."""
        try:
            img = decode_image_bytes(image_bytes)
        except Exception:
            return {
                "code": "failed",
                "msg": "Failed to run inference on image. Please use an "
                       "image with one fully visible human.",
            }
        out = self.infer_images(
            [img], person_heights=float(person_height_cm),
            det_threshold=det_threshold,
        )
        dicts = format_image_result(out, 0)[2:]
        if not dicts:
            return {
                "code": "success",
                "msg": "No humans detected",
                "body_proportion_lengths_(cm)": {},
            }
        return {
            "code": "success",
            "msg": "human body proportion estimation complete",
            "body_proportion_lengths_(cm)": dicts[0],
        }


def format_image_result(out: PipelineOutputs, i: int) -> List[Any]:
    """Outputs for image i -> reference-parity nested list
    ``[boxes, heatmaps, dist_dict_0, ...]`` (reference
    `person_det_pose_edet4_trtserver.py:131-171`)."""
    valid = np.asarray(out.person_valid[i])
    nper = int(valid.sum())
    boxes = np.asarray(out.boxes_orig[i])[:nper]
    if out.heatmaps is not None:
        heatmaps = np.asarray(out.heatmaps[i])[:nper]
    else:
        heatmaps = np.zeros((nper, 0, 0, 0), np.float32)
    result: List[Any] = [boxes, heatmaps]
    lengths = np.asarray(out.lengths_cm[i])
    vis = np.asarray(out.seg_visible[i])
    for slot in range(nper):
        result.append(prop_ops.to_dist_dict(lengths[slot], vis[slot]))
    return result
