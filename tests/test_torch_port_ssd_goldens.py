"""Goldens for the SSD phase of the port's card run (`chip_smoke.py` phase
S): the JAX package's SSD-MobileNetV1 slot on the three committed scenes
(tests/data/torch_port/scene_*.png, 480x640): the raw outputs' extrema,
each image's 10 TFLite_Detection_PostProcess slots, and the pipeline's
person slots, boxes, scores and packed [3, 3, 23] serving output.

Weights: `tests.torch_port_ssd.seeded_ssd` (flax's init draw at the seed,
a calibrated BatchNorm folded into each trunk conv, heads scaled to unit
outputs, a person-logit bias) with the test-made anchor table
(`ssd_anchors`), before the committed certified HRNet-W32. Both models
run in float32 on the JAX side, and the port holds them in float32 with
TF32 off on the card.

The generator picks the first seed of SEEDS, with the first person bias
of PERSON_BIASES, whose every decision on the path lies more than
MIN_MARGIN from flipping (`tests.torch_port_ssd.decision_margins`, from
the port's f32 forward on the CPU: logit gaps in the sweep's order and
at the top-k cut, each candidate's class lead, same-class IoUs against
0.6, the persons' logits against the det threshold's), at the first det
threshold (`det_thresholds`: the logit midpoints between the person slot
scores, high to low) at which every scene holds a person and every
person's expanded box stays off the far image edges (where the JAX
jit-fused crop differs, ROADMAP.md section 3; the port's CPU pipeline
decides), and records the threshold and the margins in the file.

Regenerate with `JAX_PLATFORMS=cpu python -m tests.test_torch_port_ssd_goldens`
(~1 min on the CPU). The slow test recomputes the JAX output and holds it
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
from tests.test_torch_port_yolo_goldens import scenes

GOLDEN = os.path.join(DATA_DIR, "ssd_goldens.json")
SEEDS = range(60)
PERSON_BIASES = (2.0, 1.0, 3.0)
MIN_MARGIN = 1e-3


def port_raw(tree, anchors, images):
    """The port's f32 SSD forward on the CPU: (box_regs, logits) numpy."""
    from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (  # noqa: E501
        SSDMobileNetV1,
        ssd_state_dict,
    )
    from tests.torch_port_ssd import ssd_inputs

    model = SSDMobileNetV1(dtype=torch.float32).eval()
    state = ssd_state_dict(tree, anchors)
    state.pop("anchors")
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        br, lg = model(torch.from_numpy(ssd_inputs(images)))
    return br.numpy(), lg.numpy()


def port_slots(pipe, tree, anchors, images):
    """The person slots of the port's f32 pipeline (CPU) on the scenes at
    det threshold 0 (a threshold only masks the slots: the first slots
    at or above it are the same): (scores [3, P], expanded normalized
    boxes [3, P, 4])."""
    from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (  # noqa: E501
        ssd_state_dict,
    )

    state = ssd_state_dict(tree, anchors)
    pipe.backend.anchors.copy_(state.pop("anchors"))
    pipe.backend.model.load_state_dict(state, strict=True)
    out = pipe.infer_images(list(images), PERSON_HEIGHT_CM, 0.0)
    return out.det_scores, out.boxes_norm


def det_thresholds(scores: np.ndarray):
    """The det thresholds worth trying on person slot scores [3, P]: the
    logit midpoints between consecutive slot scores, from the highest at
    which every scene keeps a person down (a threshold between two scores
    is as far from both as it can be)."""
    logit = np.log(scores / (1.0 - scores))
    top = logit[:, 0].min()
    ladder = np.unique(logit[(scores > 0) & (logit <= top)])[::-1]
    for hi, lo in zip(ladder[:-1], ladder[1:]):
        yield float(1.0 / (1.0 + np.exp(-(hi + lo) / 2)))


def pick_seed(images: np.ndarray):
    """Yields (seed, person_bias, det_threshold, tree, margins) for every
    combination that passes, seeds first, on the port's CPU forward."""
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )
    from tests.torch_port_ssd import (
        decision_margins,
        seeded_ssd,
        ssd_anchors,
    )

    anchors = ssd_anchors()
    pipe = None
    for seed in SEEDS:
        for pb in PERSON_BIASES:
            tree = seeded_ssd(seed, images, pb)
            if pipe is None:
                from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (  # noqa: E501
                    ssd_state_dict,
                )

                pipe = InferencePipeline(
                    device="cpu", dtype=torch.float32,
                    detector="ssd_mobilenet",
                    det_state=ssd_state_dict(tree, anchors))
            br, lg = port_raw(tree, anchors, images)
            scores, boxes = port_slots(pipe, tree, anchors, images)
            for thres in det_thresholds(scores):
                margins = [decision_margins(br[i], lg[i], anchors, thres)
                           for i in range(len(images))]
                low = min(min(v for k, v in m.items() if k != "persons")
                          for m in margins)
                valid = scores >= thres
                off_edge = np.all(boxes[..., 2:] < 1.0, -1)
                ok = bool(low > MIN_MARGIN and valid.any(-1).all()
                          and off_edge[valid].all())
                print(f"seed {seed}, person bias {pb}, threshold {thres}: "
                      f"persons {valid.sum(-1).tolist()}, off the edge "
                      f"{off_edge[valid].all()}, lowest margin {low:.3g}, "
                      f"passes {ok}", flush=True)
                if ok:
                    yield seed, pb, thres, tree, margins


def jax_outputs(tree, anchors, images, det_threshold):
    """The JAX SSD slot, f32, on the scenes one at a time: a dict of the
    raw outputs' extrema, the 10 SSD slots and the pipeline's outputs."""
    import jax.numpy as jnp

    from human_body_proportion_estimation_tpu.models.hrnet import (
        HRNET_W32,
        HRNet,
    )
    from human_body_proportion_estimation_tpu.models.ssd_mobilenet import (
        SSDMobileNetV1,
        ssd_postprocess,
    )
    from human_body_proportion_estimation_tpu.models.weights import (
        default_certified_checkpoint,
        load_compact_checkpoint,
    )
    from human_body_proportion_estimation_tpu.pipeline.backends import (
        SSDBackend,
    )
    from human_body_proportion_estimation_tpu.pipeline.host import (
        InferencePipeline,
    )
    from human_body_proportion_estimation_tpu.utils.config import (
        DetectorConfig,
        PipelineConfig,
    )
    from tests.torch_port_ssd import ssd_inputs

    cfg = PipelineConfig(detector=DetectorConfig(name="ssd_mobilenet"))
    _, pose_vars = load_compact_checkpoint(default_certified_checkpoint())
    det_vars = {"params": tree["params"], "anchors": jnp.asarray(anchors)}
    pipe = InferencePipeline(config=cfg,
                             backend=SSDBackend(cfg, dtype=jnp.float32),
                             pose=HRNet(config=HRNET_W32, dtype=jnp.float32),
                             det_vars=det_vars, pose_vars=pose_vars)
    model = SSDMobileNetV1(dtype=jnp.float32)
    br, lg = model.apply({"params": tree["params"]},
                         jnp.asarray(ssd_inputs(images)))
    slots = [ssd_postprocess(br[i], lg[i], jnp.asarray(anchors))
             for i in range(len(images))]
    rows, outs = [], []
    for img in images:
        rows.append(pipe.infer_serving([img], PERSON_HEIGHT_CM,
                                       det_threshold)[0])
        outs.append(pipe.infer_images([img], PERSON_HEIGHT_CM,
                                      det_threshold))
    cat = (lambda name: np.concatenate(
        [np.asarray(getattr(o, name)) for o in outs]))
    br, lg = np.asarray(br), np.asarray(lg)
    return {
        "raw_extrema": {
            "box_regs_min": br.min((1, 2)).tolist(),
            "box_regs_max": br.max((1, 2)).tolist(),
            "logits_min": lg.min((1, 2)).tolist(),
            "logits_max": lg.max((1, 2)).tolist(),
        },
        "ssd_boxes": np.stack([np.asarray(d.boxes) for d in slots]),
        "ssd_classes": np.stack([np.asarray(d.classes) for d in slots]),
        "ssd_scores": np.stack([np.asarray(d.scores) for d in slots]),
        "ssd_valid": np.stack([np.asarray(d.valid) for d in slots]),
        "packed": np.stack(rows),
        "person_valid": cat("person_valid"),
        "boxes_orig": cat("boxes_orig"),
        "det_scores": cat("det_scores"),
        "boxes_norm": cat("boxes_norm"),
    }


def write_goldens():
    from tests.torch_port_ssd import ssd_anchors

    images = scenes()
    anchors = ssd_anchors()
    seed, pb, thres, tree, margins = next(pick_seed(images))
    out = jax_outputs(tree, anchors, images, thres)
    valid = out["person_valid"]
    assert valid.any(-1).all()
    assert np.all(out["boxes_norm"][..., 2:] < 1.0, -1)[valid].all()
    with open(GOLDEN, "w") as fh:
        json.dump({
            "made_by": "tests/test_torch_port_ssd_goldens.py (JAX package, "
                       "CPU, float32 SSD-MobileNetV1 from "
                       "tests.torch_port_ssd.seeded_ssd with its anchor "
                       "table + float32 HRNet-W32 of certified_lite4_w32.npz, "
                       "one image per call)",
            "scenes": [os.path.basename(scene_path(s)) for s in SCENES],
            "seed": seed,
            "person_bias": pb,
            "dtype": "float32",
            "person_height_cm": PERSON_HEIGHT_CM,
            "det_threshold": thres,
            "margins": margins,
            "raw_extrema": out["raw_extrema"],
            "ssd_slots": {k: out[f"ssd_{k}"].tolist()
                          for k in ("boxes", "classes", "scores", "valid")},
            "layout": "[scene, slot, 23] = valid | 11 lengths_cm | "
                      "11 seg_visible",
            "packed": out["packed"].tolist(),
            "person_valid": out["person_valid"].tolist(),
            "boxes_orig_yxyx": out["boxes_orig"].tolist(),
            "det_scores": out["det_scores"].tolist(),
        }, fh, indent=1)


@pytest.mark.slow
def test_ssd_goldens_reproduce():
    """The recorded seed's weights through the JAX SSD slot again (f32 on
    the CPU) give the file's output, every recorded margin exceeds
    MIN_MARGIN, and every scene holds a person."""
    from tests.torch_port_ssd import seeded_ssd, ssd_anchors

    with open(GOLDEN) as fh:
        golden = json.load(fh)
    images = scenes()
    tree = seeded_ssd(golden["seed"], images, golden["person_bias"])
    out = jax_outputs(tree, ssd_anchors(), images, golden["det_threshold"])
    assert out["person_valid"].any(-1).all()
    assert min(min(v for k, v in m.items() if k != "persons")
               for m in golden["margins"]) > MIN_MARGIN
    slots = golden["ssd_slots"]
    np.testing.assert_array_equal(out["ssd_valid"], slots["valid"])
    np.testing.assert_array_equal(out["ssd_classes"], slots["classes"])
    np.testing.assert_allclose(out["ssd_boxes"], slots["boxes"], atol=1e-5)
    np.testing.assert_allclose(out["ssd_scores"], slots["scores"], atol=1e-5)
    np.testing.assert_array_equal(out["person_valid"], golden["person_valid"])
    np.testing.assert_allclose(out["packed"], golden["packed"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out["boxes_orig"], golden["boxes_orig_yxyx"],
                               atol=1e-3)
    np.testing.assert_allclose(out["det_scores"], golden["det_scores"],
                               atol=1e-5)


if __name__ == "__main__":
    write_goldens()
    print(open(GOLDEN).read()[:1500])
