"""Goldens for the YOLO phase of the port's card run (`chip_smoke.py` phase
Y): the JAX package's `InferencePipeline(detector="yolov5m")` on the three
committed scenes (tests/data/torch_port/scene_*.png, 480x640), its person
slots, boxes, scores and packed [3, 3, 23] serving output.

Weights: YOLOv5m from `models.yolo_weights.seeded_state` (numpy generator,
BatchNorm statistics calibrated on the three letterboxed scenes, Detect
logits of standard deviation 1, objectness and person biases from
OBJ_BIASES / PERSON_BIASES) before the committed certified HRNet-W32.
Both models run in float32 on the JAX side, and the port holds them in
float32 with TF32 off on the card: this seeded YOLOv5m
is calibrated to the edge of chaos, where two stacks' bf16 roundings grow
to percents by the heads (tests/test_torch_port_yolo.py,
test_yolov5_heads_bf16), which no decision margin can absorb, while f32
stacks agree to ~1e-5.

The generator picks the first seed from SEEDS, with the first bias pair,
whose every decision on the path lies more than MIN_MARGIN from flipping
(conf and objectness against
0.4, the person class's logit lead, the NMS IoUs against 0.5, the kept
scores against DET_THRESHOLD, the gaps between the first four kept
scores; `tests.torch_port_yolo.decision_margins`, from the port's f32
forward on the CPU), whose scenes all hold a person and whose persons'
expanded boxes stay off the far image edges (where the JAX jit-fused crop
differs, ROADMAP.md section 3), and records the margins in the file.

Regenerate with `JAX_PLATFORMS=cpu python -m tests.test_torch_port_yolo_goldens`
(~2 min on the CPU). The slow test recomputes the JAX output and holds it
against the file.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_port_goldens import (
    DATA_DIR,
    PERSON_HEIGHT_CM,
    SEEDS as SCENES,
    scene_path,
)

GOLDEN = os.path.join(DATA_DIR, "yolo_goldens.json")
SEEDS = range(40)
OBJ_BIASES = (-1.0, -1.5, -2.0, -2.5, -3.0, -3.5, -4.0, -5.0, -6.0)
PERSON_BIASES = (2.0, 3.0, 4.0)
DET_THRESHOLD = 0.5
MIN_MARGIN = 1e-3


def scenes() -> np.ndarray:
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        decode_image_bytes,
    )

    out = []
    for s in SCENES:
        with open(scene_path(s), "rb") as fh:
            out.append(decode_image_bytes(fh.read()))
    return np.stack(out)


def pick_seed(images: np.ndarray):
    """Yields (seed, obj_bias, person_bias, state, margins, persons) for
    every combination that passes, seeds first. A seed's heads are
    computed once with zero biases; a bias adds to its logit channel, so
    each bias pair is tried on shifted heads, and the margins of a pair
    that passes are taken again from the weights with the biases in."""
    from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
        YOLOV5M,
    )
    from tests.torch_port_yolo import (
        decision_margins,
        model_inputs,
        port_model,
        seeded,
    )

    x = torch.from_numpy(model_inputs(images, 640))

    def forward(state):
        with torch.inference_mode():
            return port_model(YOLOV5M, state)(x)

    def passes(heads):
        margins, persons = decision_margins(heads, DET_THRESHOLD)
        low = min(min(m.values()) for m in margins)
        return low > MIN_MARGIN and min(persons) >= 1, margins, persons

    for seed in SEEDS:
        heads0 = forward(seeded(YOLOV5M, seed, x.numpy(), 0.0, 0.0))
        for ob in OBJ_BIASES:
            for pb in PERSON_BIASES:
                heads = [h.clone() for h in heads0]
                for h in heads:
                    h[..., 4::85] += ob
                    h[..., 5::85] += pb
                if not passes(heads)[0]:
                    continue
                state = seeded(YOLOV5M, seed, x.numpy(), ob, pb)
                ok, margins, persons = passes(forward(state))
                print(f"seed {seed}, biases {ob} / {pb}: persons {persons}, "
                      f"passes {ok}", flush=True)
                if ok:
                    yield seed, ob, pb, state, margins, persons


def jax_outputs(state, images):
    """The JAX pipeline, f32, on the scenes one at a time: (packed
    [3, 3, 23], person_valid, boxes_orig, det_scores, boxes_norm)."""
    import jax.numpy as jnp

    from human_body_proportion_estimation_tpu.models.hrnet import (
        HRNET_W32,
        HRNet,
    )
    from human_body_proportion_estimation_tpu.models.weights import (
        default_certified_checkpoint,
        load_compact_checkpoint,
    )
    from human_body_proportion_estimation_tpu.models.yolov5 import (
        YOLOV5M,
        YoloV5,
    )
    from human_body_proportion_estimation_tpu.pipeline.backends import (
        YoloBackend,
    )
    from human_body_proportion_estimation_tpu.pipeline.host import (
        InferencePipeline,
    )
    from human_body_proportion_estimation_tpu.utils.config import (
        PipelineConfig,
    )
    from tests.torch_port_yolo import to_flax

    cfg = PipelineConfig()
    _, pose_vars = load_compact_checkpoint(default_certified_checkpoint())
    backend = YoloBackend(cfg, "yolov5m")
    backend.model = YoloV5(config=YOLOV5M, dtype=jnp.float32)
    pipe = InferencePipeline(config=cfg, backend=backend,
                             pose=HRNet(config=HRNET_W32, dtype=jnp.float32),
                             det_vars=to_flax(state), pose_vars=pose_vars)
    rows, outs = [], []
    for img in images:
        rows.append(pipe.infer_serving([img], PERSON_HEIGHT_CM,
                                       DET_THRESHOLD)[0])
        outs.append(pipe.infer_images([img], PERSON_HEIGHT_CM,
                                      DET_THRESHOLD))
    cat = (lambda name: np.concatenate(
        [np.asarray(getattr(o, name)) for o in outs]))
    return (np.stack(rows), cat("person_valid"), cat("boxes_orig"),
            cat("det_scores"), cat("boxes_norm"))


def write_goldens():
    images = scenes()
    for seed, ob, pb, state, margins, persons in pick_seed(images):
        packed, valid, boxes, scores, boxes_norm = jax_outputs(state, images)
        off_edge = np.all(boxes_norm[..., 2:] < 1.0, -1)
        if not off_edge[valid].all():
            print(f"seed {seed}: a person's box reaches the far edge",
                  flush=True)
            continue
        assert valid.sum(-1).tolist() == [min(p, 3) for p in persons]
        break
    else:
        raise RuntimeError("no seed passes")
    with open(GOLDEN, "w") as fh:
        json.dump({
            "made_by": "tests/test_torch_port_yolo_goldens.py (JAX package, "
                       "CPU, float32 YOLOv5m from "
                       "models.yolo_weights.seeded_state + float32 HRNet-W32 "
                       "of certified_lite4_w32.npz, one image per call)",
            "scenes": [os.path.basename(scene_path(s)) for s in SCENES],
            "seed": seed,
            "obj_bias": ob,
            "person_bias": pb,
            "dtype": "float32",
            "person_height_cm": PERSON_HEIGHT_CM,
            "det_threshold": DET_THRESHOLD,
            "margins": margins,
            "layout": "[scene, slot, 23] = valid | 11 lengths_cm | "
                      "11 seg_visible",
            "packed": packed.tolist(),
            "person_valid": valid.tolist(),
            "boxes_orig_yxyx": boxes.tolist(),
            "det_scores": scores.tolist(),
        }, fh, indent=1)


@pytest.mark.slow
def test_yolo_goldens_reproduce():
    """The recorded seed's weights through the JAX pipeline again (f32 on
    the CPU) give the file's output (1e-4), every recorded margin exceeds
    MIN_MARGIN, and every scene holds a person."""
    from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
        YOLOV5M,
    )
    from tests.torch_port_yolo import model_inputs, seeded

    with open(GOLDEN) as fh:
        golden = json.load(fh)
    images = scenes()
    state = seeded(YOLOV5M, golden["seed"], model_inputs(images, 640),
                   golden["obj_bias"], golden["person_bias"])
    packed, valid, boxes, scores, _ = jax_outputs(state, images)
    assert valid.any(-1).all()
    assert min(min(m.values()) for m in golden["margins"]) > MIN_MARGIN
    np.testing.assert_array_equal(valid, golden["person_valid"])
    np.testing.assert_allclose(packed, golden["packed"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(boxes, golden["boxes_orig_yxyx"], atol=1e-3)
    np.testing.assert_allclose(scores, golden["det_scores"], atol=1e-5)


if __name__ == "__main__":
    write_goldens()
    print(open(GOLDEN).read()[:1500])
