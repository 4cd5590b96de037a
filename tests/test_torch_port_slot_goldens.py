"""Goldens for the other slots of the port's card run (`chip_smoke.py`
phase D): the JAX package's float32 EfficientDet-Lite0 detection forward
(`pipeline/detect.EdetDetectPipeline`) on the three committed scenes at
480x640, and its float32 HigherHRNet on the scenes' pose crops at 384x288
(`pipeline/pose.preprocess_crop_host`), summarized per map (max value and
flattened argmax of `output_1` and `output_2`; no heatmap is stored).

Weights: `models.weights.seeded_state` through tests/torch_port_slots.py
(numpy generator, BatchNorm statistics calibrated on the scenes or
crops; for Lite0 the predict convs scaled to logits of standard deviation
1 and a class bias added). The generator takes the first Lite0 seed and
bias, seeds first, whose every decision on the detection path lies more
than MIN_MARGIN from flipping (`torch_port_slots.lite0_margins`, from the
port's f32 forward on the CPU) with MIN_CANDIDATES in every scene, and
the first HigherHRNet seed whose every map's two largest values differ by
more than MIN_MARGIN of the largest; it records the margins. MIN_MARGIN is
about a hundred times what the port's f32 forward on the CPU differs from
the JAX one by on these weights (scores ~1e-6, boxes ~3e-4 px). The card
holds the port's f32 forwards (TF32 off) to the file.

Regenerate with `JAX_PLATFORMS=cpu python -m tests.test_torch_port_slot_goldens`
(~2 min on the CPU). The slow test recomputes the JAX outputs from the
recorded seeds and holds them against the file.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests import torch_port_slots as slots

GOLDEN = os.path.join(slots.DATA_DIR, "slot_goldens.json")
SEEDS = range(20)
CLASS_BIASES = (-4.0, -4.25, -4.5, -4.75, -5.0, -5.25)
MIN_MARGIN = 1e-4
MIN_CANDIDATES = 2


def port_lite0(state):
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
        EFFICIENTDET_LITE0,
        EfficientDet,
    )

    model = EfficientDet(EFFICIENTDET_LITE0, dtype=torch.float32)
    model.load_state_dict(slots.to_torch(state), strict=True)
    return model.eval()


def pick_lite0(images):
    """(seed, class_bias, state, margins, candidates) of the first pair
    that passes. A bias adds to every class logit, so each is tried on
    the seed's shifted logits, and the margins of a pair that passes are
    taken again from the weights with the bias in."""
    x = torch.from_numpy(images)

    def margins(state, shift=0.0):
        with torch.inference_mode():
            cls, box = port_lite0(state)(x, all_classes=True)
        m, n = slots.lite0_margins(cls + shift, box)
        ok = (min(min(d.values()) for d in m) > MIN_MARGIN
              and min(n) >= MIN_CANDIDATES)
        return ok, m, n

    for seed in SEEDS:
        state0 = slots.lite0_state(seed, 0.0, images)
        for bias in CLASS_BIASES:
            if not margins(state0, bias)[0]:
                continue
            state = slots.lite0_state(seed, bias, images)
            ok, m, n = margins(state)
            print(f"lite0 seed {seed}, class bias {bias}: candidates {n}, "
                  f"passes {ok}", flush=True)
            if ok:
                return seed, bias, state, m, n
    raise RuntimeError("no Lite0 seed passes")


def pick_higher(crops):
    """(seed, state, margin) of the first HigherHRNet seed that passes."""
    from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
        HigherHRNet,
    )

    for seed in SEEDS:
        state = slots.higher_state(seed, crops)
        model = HigherHRNet(dtype=torch.float32)
        model.load_state_dict(slots.to_torch(state), strict=True)
        with torch.inference_mode():
            out = model.eval()(torch.from_numpy(crops))
        margin = min(slots.heatmap_summary(out[name].numpy())[2]
                     for name in ("output_1", "output_2"))
        print(f"higherhrnet seed {seed}: argmax margin {margin:.3g}",
              flush=True)
        if margin > MIN_MARGIN:
            return seed, state, margin
    raise RuntimeError("no HigherHRNet seed passes")


def jax_lite0(state, images):
    """The JAX EdetDetectPipeline, f32: the slots at or above the
    threshold of each scene as (boxes, scores, classes) lists."""
    import jax.numpy as jnp

    from human_body_proportion_estimation_tpu.models.efficientdet import (
        EFFICIENTDET_LITE0,
        EfficientDet,
    )
    from human_body_proportion_estimation_tpu.pipeline.detect import (
        EdetDetectPipeline,
    )
    from tests.torch_port_yolo import to_flax

    program = EdetDetectPipeline(
        EfficientDet(config=EFFICIENTDET_LITE0, dtype=jnp.float32),
        slots.DET_HW).jit()
    dets = program(to_flax(state), jnp.asarray(images))
    out = []
    for i in range(len(images)):
        scores = np.asarray(dets.scores[i])
        keep = np.asarray(dets.valid[i]) & (scores >= slots.DET_THRESHOLD)
        out.append(dict(boxes_yxyx=np.asarray(dets.boxes[i])[keep].tolist(),
                        scores=scores[keep].tolist(),
                        classes=np.asarray(dets.classes[i])[keep].tolist()))
    return out


def jax_higher(state, crops):
    """The JAX HigherHRNet, f32, on the crops: per output, the summary of
    `torch_port_slots.heatmap_summary`."""
    import jax
    import jax.numpy as jnp

    from human_body_proportion_estimation_tpu.models.higherhrnet import (
        HigherHRNet,
    )
    from tests.torch_port_yolo import to_flax

    model = HigherHRNet(dtype=jnp.float32)
    out = jax.jit(model.apply)(to_flax(state),
                               jnp.asarray(crops.transpose(0, 2, 3, 1)))
    summary = {}
    for name in ("output_1", "output_2"):
        nchw = np.asarray(out[name]).transpose(0, 3, 1, 2)
        mx, am, margin = slots.heatmap_summary(nchw)
        summary[name] = dict(shape=list(nchw.shape), max=mx, argmax=am,
                             margin=margin)
    return summary


def write_goldens():
    images = slots.scenes()
    crops = slots.crops(images)
    seed, bias, state, margins, candidates = pick_lite0(images)
    h_seed, h_state, h_margin = pick_higher(crops)
    with open(GOLDEN, "w") as fh:
        json.dump({
            "made_by": "tests/test_torch_port_slot_goldens.py (JAX package, "
                       "CPU, float32, weights from "
                       "models.weights.seeded_state via "
                       "tests/torch_port_slots.py)",
            "scenes": list(slots.SCENES),
            "min_margin": MIN_MARGIN,
            "lite0": {
                "seed": seed,
                "class_bias": bias,
                "input_hw": list(slots.DET_HW),
                "det_threshold": slots.DET_THRESHOLD,
                "candidates": candidates,
                "margins": margins,
                "detections": jax_lite0(state, images),
            },
            "higherhrnet": {
                "seed": h_seed,
                "crop_hw": list(slots.CROP_HW),
                "argmax_margin": h_margin,
                **jax_higher(h_state, crops),
            },
        }, fh, indent=1)


@pytest.mark.slow
def test_slot_goldens_reproduce():
    """The recorded seeds' weights through the JAX forwards again (f32 on
    the CPU) give the file's detections and summaries, and every recorded
    margin exceeds MIN_MARGIN."""
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    images = slots.scenes()
    crops = slots.crops(images)
    lite0, higher = golden["lite0"], golden["higherhrnet"]
    assert min(min(m.values()) for m in lite0["margins"]) > MIN_MARGIN
    assert higher["argmax_margin"] > MIN_MARGIN
    dets = jax_lite0(slots.lite0_state(lite0["seed"], lite0["class_bias"],
                                       images), images)
    for got, ref in zip(dets, lite0["detections"]):
        assert got["classes"] == ref["classes"]
        np.testing.assert_allclose(got["boxes_yxyx"], ref["boxes_yxyx"],
                                   atol=1e-3)
        np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-5)
    summary = jax_higher(slots.higher_state(higher["seed"], crops), crops)
    for name in ("output_1", "output_2"):
        assert summary[name]["argmax"] == higher[name]["argmax"]
        np.testing.assert_allclose(summary[name]["max"], higher[name]["max"],
                                   rtol=1e-5)


if __name__ == "__main__":
    write_goldens()
    print(open(GOLDEN).read()[:1500])
