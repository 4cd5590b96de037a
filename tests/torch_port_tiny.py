"""Tiny JAX and port models on the same weights, for the registry and wire
tests of the port (tests/test_torch_port_registry.py,
tests/test_torch_port_grpc.py).

The shapes of tests/test_torch_port_pipeline.py (128x128 detector input,
64x64 crops, 16x16 heatmaps) and the depth-reduced models of
tests/tiny_models.py, both sides in float32, a max batch of 4. The flax
parameter trees come from `jax.eval_shape` of the models' `init` and are
filled from a seed with numpy, the way flax initializes them (LeCun-normal
kernels, zero biases, unit BN scales), then BN statistics and affines are
randomized and the person class's bias is raised, so that random weights
give person detections. That takes well under a second, where running
`init` takes about 30 s on the CPU.
"""

import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

from human_body_proportion_estimation_tpu.models import efficientdet as jedet
from human_body_proportion_estimation_tpu.models.hrnet import HRNet as JHRNet
from human_body_proportion_estimation_tpu.utils.config import (
    DetectorConfig as JDetectorConfig,
    PipelineConfig as JPipelineConfig,
    PoseConfig as JPoseConfig,
    ServeConfig as JServeConfig,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    DetectorConfig,
    PipelineConfig,
    PoseConfig,
    ServeConfig,
)
from tests.test_torch_port_models import (
    _port_edet_config,
    _port_hrnet_config,
    _randomize_bn,
)
from tests.tiny_models import tiny_edet_config, tiny_w32_config

DET_HW, CROP_HW, HM_HW = (128, 128), (64, 64), (16, 16)
MAX_BATCH = 4
PERSON_BIAS = 4.0
PORTED = ("edetlite4", "edetlite4_modified", "ensemble_edet4_person_det_pose",
          "higherhrnet", "hrnet", "ssd_mobilenet", "yolov5m", "yolov5s")
# the full-width YOLO models, built at random on both sides (no pipeline
# here shares them); loading one costs ~25 s of flax init on the JAX side
YOLO = ("yolov5m", "yolov5s")
# the models no pipeline here shares, built at random on both sides and
# labelled so: the YOLO models and the full-width HigherHRNet (whose flax
# init is as slow to load)
RANDOM = YOLO + ("higherhrnet",)
# the SSD detector, registered on both sides and labelled "real": its
# weights (the reference's ssd.tflite) are absent here, so loading it
# fails on both sides, naming the file
SSD = ("ssd_mobilenet",)


def configs():
    """(JAX config, port config): the same fields."""
    det = dict(input_height=DET_HW[0], input_width=DET_HW[1])
    pose = dict(crop_height=CROP_HW[0], crop_width=CROP_HW[1],
                heatmap_height=HM_HW[0], heatmap_width=HM_HW[1])
    return (
        JPipelineConfig(detector=JDetectorConfig(**det),
                        pose=JPoseConfig(**pose),
                        serve=JServeConfig(max_batch=MAX_BATCH)),
        PipelineConfig(detector=DetectorConfig(**det), pose=PoseConfig(**pose),
                       serve=ServeConfig(max_batch=MAX_BATCH)),
    )


def _filled(model, shape, seed):
    """`model.init`'s variable tree, filled as flax initializes it."""
    rng = np.random.default_rng(seed)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, *shape, 3), jnp.float32))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, leaf.shape).astype(
                np.float32)
        if name in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        return np.zeros(leaf.shape, np.float32)

    return jax.tree_util.tree_map_with_path(fill, abstract)


def tiny_models():
    """A namespace of the JAX modules and variables (canonical f32
    detector, score-kernel detector in interpret mode, f32 HRNet) and the
    port pipeline on the CPU over the same weights."""
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline as TPipeline,
    )

    jcfg, tcfg = configs()
    jdet_cfg, jpose_cfg = tiny_edet_config(), tiny_w32_config()
    jdet = jedet.EfficientDet(config=jdet_cfg, dtype=jnp.float32)
    jdet_kernel = jedet.EfficientDet(
        config=jdet_cfg, dtype=jnp.float32, score_kernel=True,
        score_kernel_interpret=True, person_class0=0)
    jpose = JHRNet(config=jpose_cfg, dtype=jnp.float32)
    det_vars = _randomize_bn(_filled(jdet, DET_HW, 0), 10)
    pose_vars = _randomize_bn(_filled(jpose, CROP_HW, 1), 11)
    nc = jdet_cfg.num_classes
    det_vars["params"]["class_net"]["predict_pw"]["bias"][::nc] += PERSON_BIAS
    tpipe = TPipeline(
        tcfg, flax_to_state_dict(det_vars), flax_to_state_dict(pose_vars),
        device="cpu", det_config=_port_edet_config(jdet_cfg),
        pose_config=_port_hrnet_config(jpose_cfg), dtype=torch.float32,
    )
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jdet=jdet, jdet_kernel=jdet_kernel,
        jpose=jpose, det_vars=det_vars, pose_vars=pose_vars, tpipe=tpipe)


def jax_registry(m, mesh=None, include=PORTED):
    """The JAX package's `build_registry` over the same weights, its
    detector models on the canonical f32 EfficientDet (what the JAX
    registry runs when the serving detector is canonical), restricted to
    the models the port serves (or to `include`), over the pipeline mesh
    `mesh` (a JAX mesh) if given."""
    from human_body_proportion_estimation_tpu.serve.registry import (
        build_registry,
    )

    stand_in = types.SimpleNamespace(
        config=m.jcfg, weights_origin={"detector": "real", "pose": "real"},
        pose=m.jpose, pose_vars=m.pose_vars, det_vars=m.det_vars, mesh=mesh,
        backend=types.SimpleNamespace(detector=m.jdet))
    return build_registry(stand_in, include=include)


def jax_pipeline(m, mesh=None):
    """The JAX serving pipeline (score-kernel detector, the port's serving
    path) over the same weights, data-parallel over `mesh` (a JAX mesh)
    if given."""
    from human_body_proportion_estimation_tpu.pipeline.backends import (
        EfficientDetBackend,
    )
    from human_body_proportion_estimation_tpu.pipeline.host import (
        InferencePipeline,
    )

    return InferencePipeline(
        config=m.jcfg, backend=EfficientDetBackend(m.jdet_kernel, m.jcfg),
        pose=m.jpose, det_vars=m.det_vars, pose_vars=m.pose_vars, mesh=mesh)


def image(seed, hw=DET_HW):
    return np.random.default_rng(seed).integers(0, 256, (1, *hw, 3),
                                                dtype=np.uint8)


def modified_inputs(img, thres, x_change=7.0):
    return {"edet_input_image": img,
            "det_thres": np.array([thres], np.float32),
            "det_xy_change": np.array([x_change, 0.0], np.float32)}
