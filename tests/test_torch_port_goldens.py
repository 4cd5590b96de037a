"""Goldens for the port's card run (`chip_smoke.py`): three synthetic scenes
and the JAX package's packed serving output on them.

The scenes are `training/synthetic.generate_scene` renders (seeds 0-2,
480x640), stored as PNG (lossless, so every reader decodes the same
pixels). The golden is the JAX `InferencePipeline.infer_serving` output,
[3, 3, 23] (valid | 11 lengths in cm | 11 visibility), on the committed
certified checkpoint, with EfficientDet's Pallas head-score kernel in
interpret mode — the serving configuration the port mirrors — computed on
the CPU one image at a time.

Regenerate with `JAX_PLATFORMS=cpu python -m tests.test_torch_port_goldens`.
The slow test recomputes the output and holds it against the file.
"""

import io
import json
import os

import numpy as np
import pytest

DATA_DIR = os.path.join(os.path.dirname(__file__), "data", "torch_port")
SEEDS = (0, 1, 2)
GOLDEN = os.path.join(DATA_DIR, "goldens.json")
PERSON_HEIGHT_CM = 175.0
DET_THRESHOLD = 0.70


def scene_path(seed: int) -> str:
    return os.path.join(DATA_DIR, f"scene_{seed}.png")


def write_scenes():
    from PIL import Image

    from human_body_proportion_estimation_tpu.training.synthetic import (
        generate_scene,
    )

    os.makedirs(DATA_DIR, exist_ok=True)
    for seed in SEEDS:
        scene = generate_scene(np.random.default_rng(seed))
        Image.fromarray(scene.image).save(scene_path(seed), optimize=True)


def jax_packed_outputs() -> np.ndarray:
    """The JAX package's packed [3, 3, 23] serving output on the PNGs."""
    from human_body_proportion_estimation_tpu.models.efficientdet import (
        EfficientDet,
    )
    from human_body_proportion_estimation_tpu.models.weights import (
        default_certified_checkpoint,
        load_compact_checkpoint,
    )
    from human_body_proportion_estimation_tpu.pipeline.backends import (
        EfficientDetBackend,
    )
    from human_body_proportion_estimation_tpu.pipeline.host import (
        InferencePipeline,
        decode_image_bytes,
    )
    from human_body_proportion_estimation_tpu.utils.config import (
        PipelineConfig,
    )

    cfg = PipelineConfig()
    det_vars, pose_vars = load_compact_checkpoint(
        default_certified_checkpoint())
    backend = EfficientDetBackend(
        EfficientDet(score_kernel=True, score_kernel_interpret=True,
                     person_class0=cfg.detector.person_class_id - 1),
        cfg,
    )
    pipe = InferencePipeline(config=cfg, backend=backend, det_vars=det_vars,
                             pose_vars=pose_vars)
    rows = []
    for seed in SEEDS:
        with open(scene_path(seed), "rb") as fh:
            img = decode_image_bytes(fh.read())
        rows.append(pipe.infer_serving(
            [img], person_heights=PERSON_HEIGHT_CM,
            det_threshold=DET_THRESHOLD)[0])
    return np.stack(rows)


def write_goldens():
    write_scenes()
    packed = jax_packed_outputs()
    with open(GOLDEN, "w") as fh:
        json.dump({
            "made_by": "tests/test_torch_port_goldens.py (JAX package, "
                       "CPU, certified_lite4_w32.npz, score_kernel "
                       "interpret, one image per call)",
            "scenes": [os.path.basename(scene_path(s)) for s in SEEDS],
            "person_height_cm": PERSON_HEIGHT_CM,
            "det_threshold": DET_THRESHOLD,
            "layout": "[scene, slot, 23] = valid | 11 lengths_cm | "
                      "11 seg_visible",
            "packed": packed.tolist(),
        }, fh, indent=1)


@pytest.mark.slow
def test_goldens_reproduce():
    """Full-size JAX forward on the CPU: the PNGs decode to 480x640 and the
    recomputed packed output equals the committed golden (1e-4 cm: same
    program, same machine class)."""
    from PIL import Image

    for seed in SEEDS:
        with open(scene_path(seed), "rb") as fh:
            assert Image.open(io.BytesIO(fh.read())).size == (640, 480)
    with open(GOLDEN) as fh:
        golden = np.asarray(json.load(fh)["packed"], np.float32)
    assert golden.shape == (3, 3, 23)
    assert golden[:, 0, 0].all(), "every scene must hold a person"
    np.testing.assert_allclose(jax_packed_outputs(), golden,
                               rtol=1e-4, atol=1e-4)


if __name__ == "__main__":
    write_goldens()
    print(open(GOLDEN).read()[:2000])
