"""Goldens for the bottom-up and evaluation phases of the port's card run
(`chip_smoke.py` phases U and E), made on the CPU from the JAX package.

(a) `bottomup_goldens.json`: the JAX f32 `BottomUpPipeline` (full-width
HigherHRNet, 512x512) on the three committed scenes, with the seeded
HigherHRNet of `slot_goldens.json` (its seed through
`models.weights.seeded_state`, tests/torch_port_slots.py): per-map maxima
and flattened argmax of the aggregated heat and tag maps [3, 17, 256,
256] (and each map's largest magnitude); for the served decode parameters and for a wide tag threshold (see
CONFIGS), the grouped outputs of `infer_images` and the packed rows of
`infer_serving`; and JAX's decode of every case of
tests/torch_port_bottomup.py. The generator also records how far each
decode of the scenes lies from changing: the largest relative noise (of
each map's largest magnitude) that, added to JAX's aggregated maps, left
the port's decode of them unchanged in every one of TRIALS draws.

(b) `scenes_coco.json`: the scenes' ground truth in COCO form
(`training/synthetic.generate_scene` of seeds 0-2: the tight box and the
17 keypoints, all visible), and the JAX `cli/evaluate.run_eval` of the
certified EfficientDet-Lite4 + HRNet-W32 (`InferencePipeline` with the
Pallas head-score kernel in interpret mode, the port's serving path) on
them.

Regenerate with `JAX_PLATFORMS=cpu python -m
tests.test_torch_port_bottomup_goldens` (~3 min on the CPU). The slow test
recomputes the JAX outputs and holds them against the files.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests import torch_port_bottomup as bu
from tests import torch_port_slots as slots

GOLDEN = os.path.join(slots.DATA_DIR, "bottomup_goldens.json")
COCO = os.path.join(slots.DATA_DIR, "scenes_coco.json")
SCENE_SEEDS = (0, 1, 2)
HEIGHT_CM = 175.0
NOISE = (1e-6, 1e-5, 1e-4, 1e-3)
TRIALS = 8
# the served decode parameters, and a tag threshold wide enough that every
# candidate joins the group nearest in tag: at the default 1.0 the seeded
# network's tags (spread over +-100) open groups of 1-3 joints and no
# segment is visible, so only "wide" exercises the cm path
CONFIGS = {"default": None, "wide": {"tag_threshold": 1000.0}}


def seeded_state():
    """The seeded HigherHRNet of slot_goldens.json (numpy state dict)."""
    with open(os.path.join(slots.DATA_DIR, "slot_goldens.json")) as fh:
        seed = json.load(fh)["higherhrnet"]["seed"]
    images = slots.scenes()
    return seed, slots.higher_state(seed, slots.crops(images))


def jax_pipeline(state, decode=None):
    import jax.numpy as jnp

    from human_body_proportion_estimation_tpu.models.higherhrnet import (
        HigherHRNet,
    )
    from human_body_proportion_estimation_tpu.pipeline.bottomup import (
        BottomUpPipeline,
    )
    from tests.torch_port_yolo import to_flax

    return BottomUpPipeline(pose_vars=to_flax(state),
                            model=HigherHRNet(dtype=jnp.float32),
                            **(decode or {}))


def jax_maps(pipe, images):
    """JAX's aggregated (heat, tags) [n, 17, 256, 256] of the pipeline's
    512x512 inputs, one image at a time (the JAX forward's own lines)."""
    import functools

    import jax
    import jax.numpy as jnp

    from human_body_proportion_estimation_tpu.pipeline.host import (
        resize_for_detector,
    )

    k = pipe.config.pose.num_keypoints

    @jax.jit
    def maps(v, x):
        outs = pipe.model.apply(v, x.astype(jnp.float32) / 255.0)
        out1, out2 = outs["output_1"], outs["output_2"]
        b, hh, hw = out2.shape[:3]
        up = functools.partial(jax.image.resize, shape=(b, hh, hw, k),
                               method="bilinear")
        heat = (up(out1[..., :k]) + out2) / 2.0
        return (jnp.moveaxis(heat, -1, 1),
                jnp.moveaxis(up(out1[..., k:]), -1, 1))

    heat, tags = [], []
    h, w = pipe.INPUT_HW
    for img in images:
        x = resize_for_detector(img, w, h)[None]
        hm, tg = maps(pipe.pose_vars, jnp.asarray(x))
        heat.append(np.array(hm[0]))
        tags.append(np.array(tg[0]))
    return np.stack(heat), np.stack(tags)


def decode_kwargs(decode):
    return {**bu.DEFAULTS, **(decode or {})}


def stable_noise(heat, tags, decode):
    """The largest of NOISE under which the port's decode of (heat, tags)
    gives the same keypoints, scores' support and validity in every one of
    TRIALS seeded draws (0.0 if none)."""
    from human_body_proportion_estimation_tpu_torch.ops import (
        ae_grouping as tae,
    )

    kw = decode_kwargs(decode)
    ref = tae.decode_bottom_up(torch.from_numpy(heat), torch.from_numpy(tags),
                               **kw)
    scale_h = np.abs(heat).reshape(*heat.shape[:2], -1).max(-1)[..., None,
                                                                None]
    scale_t = np.abs(tags).reshape(*tags.shape[:2], -1).max(-1)[..., None,
                                                                None]
    rng = np.random.default_rng(0)
    held = 0.0
    for eps in NOISE:
        for _ in range(TRIALS):
            h = heat + (eps * scale_h * rng.uniform(-1, 1, heat.shape)
                        ).astype(np.float32)
            t = tags + (eps * scale_t * rng.uniform(-1, 1, tags.shape)
                        ).astype(np.float32)
            got = tae.decode_bottom_up(torch.from_numpy(h),
                                       torch.from_numpy(t), **kw)
            if not (torch.equal(got.keypoints, ref.keypoints)
                    and torch.equal(got.valid, ref.valid)
                    and torch.equal(got.scores > 0, ref.scores > 0)):
                return held
        held = eps
    return held


def jax_decode_cases():
    import functools

    import jax
    import jax.numpy as jnp

    from human_body_proportion_estimation_tpu.ops import ae_grouping as jae

    out = {}
    for name, heat, tags, kw in bu.decode_cases():
        g = jax.jit(jax.vmap(functools.partial(jae.decode_bottom_up, **kw)))(
            jnp.asarray(heat), jnp.asarray(tags))
        out[name] = dict(keypoints=np.asarray(g.keypoints).tolist(),
                         scores=np.asarray(g.scores).tolist(),
                         valid=np.asarray(g.valid).tolist())
    return out


def bottomup_record(state):
    """Everything (a) records but the seed: the maps' summaries; for each
    of CONFIGS its decode parameters, grouped outputs, packed rows and
    stable noise; the decode cases."""
    images = slots.scenes()
    record = {"configs": {}, "decode_cases": jax_decode_cases()}
    for name, decode in CONFIGS.items():
        pipe = jax_pipeline(state, decode)
        if "maps" not in record:
            heat, tags = jax_maps(pipe, images)
            record["maps"] = {}
            for key, maps in (("heat", heat), ("tags", tags)):
                mx, am, margin = slots.heatmap_summary(maps)
                absmax = np.abs(maps).reshape(*maps.shape[:2], -1).max(-1)
                record["maps"][key] = dict(shape=list(maps.shape), max=mx,
                                           argmax=am, margin=margin,
                                           absmax=absmax.tolist())
        out = pipe.infer_images(list(images), person_heights=HEIGHT_CM)
        packed = pipe.infer_serving(list(images), person_heights=HEIGHT_CM)
        record["configs"][name] = {
            "decode": decode_kwargs(decode),
            "outputs": {f: np.asarray(getattr(out, f)).tolist()
                        for f in out._fields},
            "packed": np.asarray(packed).tolist(),
            "stable_noise": stable_noise(heat, tags, decode),
        }
    return record


def scenes_coco():
    """The COCO document of the scenes' ground truth."""
    from human_body_proportion_estimation_tpu.training.synthetic import (
        generate_scene,
    )
    from tests.test_torch_port_metrics import (
        coco_document,
        scenes_coco_annotation,
        scenes_coco_image,
    )

    images, annotations = [], []
    for i, seed in enumerate(SCENE_SEEDS):
        scene = generate_scene(np.random.default_rng(seed))
        images.append(scenes_coco_image(i, f"scene_{seed}.png",
                                        scene.image.shape))
        annotations.append(scenes_coco_annotation(i, scene))
    return coco_document(images, annotations)


def jax_eval(path):
    """JAX `run_eval` of the certified Lite4 + W32 serving pipeline (the
    head-score kernel in interpret mode) on the committed scenes, one
    image a batch."""
    from human_body_proportion_estimation_tpu.cli.evaluate import run_eval
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
    )
    from human_body_proportion_estimation_tpu.utils.config import (
        PipelineConfig,
    )

    cfg = PipelineConfig()
    det_vars, pose_vars = load_compact_checkpoint(
        default_certified_checkpoint())
    backend = EfficientDetBackend(
        EfficientDet(score_kernel=True, score_kernel_interpret=True,
                     person_class0=cfg.detector.person_class_id - 1), cfg)
    pipe = InferencePipeline(config=cfg, backend=backend, det_vars=det_vars,
                             pose_vars=pose_vars)
    return run_eval(pipe, path, slots.DATA_DIR, batch_size=1)


def write_goldens():
    seed, state = seeded_state()
    record = bottomup_record(state)
    with open(GOLDEN, "w") as fh:
        json.dump({
            "made_by": "tests/test_torch_port_bottomup_goldens.py (JAX "
                       "package, CPU, float32, HigherHRNet weights from "
                       "models.weights.seeded_state via "
                       "tests/torch_port_slots.py)",
            "scenes": list(slots.SCENES),
            "seed": seed,
            "input_hw": [512, 512],
            "height_cm": HEIGHT_CM,
            **record,
        }, fh)
    coco = scenes_coco()
    with open(COCO, "w") as fh:
        json.dump(coco, fh, indent=1)
    coco["jax_run_eval"] = jax_eval(COCO)
    with open(COCO, "w") as fh:
        json.dump(coco, fh, indent=1)


@pytest.mark.slow
def test_bottomup_goldens_reproduce():
    """The recorded seed's weights through the JAX bottom-up pipeline
    again (f32 on the CPU) give the file's summaries (argmax identical,
    maxima to 1e-5 relative), grouped outputs and packed rows (to 1e-5),
    and the decode cases bit for bit."""
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    seed, state = seeded_state()
    assert seed == golden["seed"]
    record = bottomup_record(state)
    for name in ("heat", "tags"):
        assert record["maps"][name]["argmax"] == \
            golden["maps"][name]["argmax"]
        for key in ("max", "absmax"):
            np.testing.assert_allclose(record["maps"][name][key],
                                       golden["maps"][name][key], rtol=1e-5)
    for name, config in golden["configs"].items():
        got = record["configs"][name]
        assert got["decode"] == config["decode"]
        assert got["stable_noise"] == config["stable_noise"]
        for field, ref in config["outputs"].items():
            np.testing.assert_allclose(
                np.asarray(got["outputs"][field], np.float64),
                np.asarray(ref, np.float64), rtol=1e-5, atol=1e-5,
                err_msg=f"{name} {field}")
        np.testing.assert_allclose(got["packed"], config["packed"],
                                   rtol=1e-5, atol=1e-5)
    for name, ref in golden["decode_cases"].items():
        for field, values in ref.items():
            np.testing.assert_array_equal(
                np.asarray(record["decode_cases"][name][field]),
                np.asarray(values), err_msg=f"{name} {field}")


@pytest.mark.slow
def test_scenes_coco_reproduces():
    """The COCO document is the scenes' ground truth again, and JAX's
    run_eval of the certified pipeline gives the recorded figures."""
    with open(COCO) as fh:
        golden = json.load(fh)
    ref = golden.pop("jax_run_eval")
    assert golden == json.loads(json.dumps(scenes_coco()))
    got = jax_eval(COCO)
    assert list(got) == list(ref)
    for key, value in ref.items():
        assert got[key] == pytest.approx(value, abs=1e-6), key


if __name__ == "__main__":
    write_goldens()
    print(open(COCO).read()[-800:])
