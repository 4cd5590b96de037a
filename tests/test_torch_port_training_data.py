"""The port's training data (`training/synthetic.py`, `training/data.py` and
the dataset functions and truths of `training/certify.py` and
`training/certify_bottomup.py`) against the JAX package's: numpy + cv2 on
both sides, so every array is held to be identical (images byte for byte).
"""

import json

import numpy as np
import pytest

from human_body_proportion_estimation_tpu.cli import certify as jcli
from human_body_proportion_estimation_tpu.training import (
    certify as jcert,
    certify_bottomup as jcbu,
    data as jdata,
    synthetic as jsyn,
)
from human_body_proportion_estimation_tpu.utils.config import (
    DetectorConfig as JDetectorConfig,
    PipelineConfig as JPipelineConfig,
    PoseConfig as JPoseConfig,
)
from human_body_proportion_estimation_tpu_torch.cli import certify as tcli
from human_body_proportion_estimation_tpu_torch.training import (
    certify as tcert,
    certify_bottomup as tcbu,
    data as tdata,
    synthetic as tsyn,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    DetectorConfig,
    PipelineConfig,
    PoseConfig,
)

SEEDS = (0, 7, 123)
IMG_HW = (240, 320)


def configs(subpixel=False):
    det = dict(input_height=IMG_HW[0], input_width=IMG_HW[1])
    pose = dict(crop_height=96, crop_width=72, heatmap_height=24,
                heatmap_width=18, subpixel_refine=subpixel)
    return (JPipelineConfig(detector=JDetectorConfig(**det),
                            pose=JPoseConfig(**pose)),
            PipelineConfig(detector=DetectorConfig(**det),
                           pose=PoseConfig(**pose)))


def assert_same(a, b):
    """Dataclasses, tuples or arrays: equal field for field, dtypes too."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__
        for name in a.__dataclass_fields__:
            assert_same(getattr(a, name), getattr(b, name))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kwargs", [{}, dict(fixed_pose=True,
                                             keypoint_markers=True)])
def test_generate_scene_identical(seed, kwargs):
    j = jsyn.generate_scene(np.random.default_rng(seed), IMG_HW, **kwargs)
    t = tsyn.generate_scene(np.random.default_rng(seed), IMG_HW, **kwargs)
    assert_same(j, t)
    assert_same(jsyn.segment_truth_cm(j), tsyn.segment_truth_cm(t))
    assert jsyn.truth_dict(j) == tsyn.truth_dict(t)


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_multi_scene_identical(seed):
    j = jsyn.generate_multi_scene(np.random.default_rng(seed), (192, 256))
    t = tsyn.generate_multi_scene(np.random.default_rng(seed), (192, 256))
    assert_same(j, t)
    js = jcbu.make_multi_scenes(2, seed, (128, 128), max_people=3)
    ts = tcbu.make_multi_scenes(2, seed, (128, 128), max_people=3)
    assert_same(js, ts)


def pose_samples(mod, seed, n=4):
    out = []
    for sc in jcert.make_scenes(n, seed, IMG_HW):
        x1, y1, x2, y2 = sc.bbox_xyxy
        out.append(mod.PoseSample(image=sc.image, keypoints=sc.keypoints,
                                  visible=sc.visible,
                                  bbox_xywh=np.array([x1, y1, x2 - x1,
                                                      y2 - y1], np.float32)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_crop_sample_and_batch_iterator_identical(seed):
    js, ts = pose_samples(jdata, seed), pose_samples(tdata, seed)
    for flip, rot in ((False, 0.0), (True, 17.0)):
        assert_same(
            jdata.crop_sample(js[0], 72, 96, 0.25, rot, flip,
                              rng=np.random.default_rng(seed)),
            tdata.crop_sample(ts[0], 72, 96, 0.25, rot, flip,
                              rng=np.random.default_rng(seed)))
    jb = jdata.batch_iterator(js, 2, (96, 72), seed=seed)
    tb = tdata.batch_iterator(ts, 2, (96, 72), seed=seed)
    for _ in range(3):   # crosses an epoch boundary (4 samples, batch 2)
        assert_same(next(jb), next(tb))


def test_load_coco_keypoints_identical(tmp_path):
    scenes = jcert.make_scenes(3, 5, IMG_HW)
    ann, imdir = jcli.write_coco_valset(scenes, str(tmp_path / "j"))
    t_ann, t_imdir = tcli.write_coco_valset(scenes, str(tmp_path / "t"))
    assert json.load(open(ann)) == json.load(open(t_ann))
    for name in ("scene_0000.png", "scene_0002.png"):
        assert (open(f"{imdir}/{name}", "rb").read()
                == open(f"{t_imdir}/{name}", "rb").read())
    j = jdata.load_coco_keypoints(ann, imdir)
    t = tdata.load_coco_keypoints(ann, imdir)
    assert len(j) == len(t) == 3
    for a, b in zip(j, t):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])


@pytest.mark.parametrize("seed", SEEDS)
def test_pose_crop_and_det_arrays_identical(seed):
    jcfg, tcfg = configs()
    scenes = jcert.make_scenes(3, seed, IMG_HW)
    assert_same(tcert.make_scenes(3, seed, IMG_HW), scenes)
    for jitter in (0.0, 0.08):
        assert_same(
            jcert.pose_crop_arrays(scenes, jcfg, seed=seed + 1,
                                   box_jitter=jitter),
            tcert.pose_crop_arrays(scenes, tcfg, seed=seed + 1,
                                   box_jitter=jitter))
    assert_same(jcert.det_arrays(scenes), tcert.det_arrays(scenes))


@pytest.mark.parametrize("subpixel", [False, True])
def test_quantized_truth_cm_identical(subpixel):
    jcfg, tcfg = configs(subpixel)
    for sc in jcert.make_scenes(4, 11, IMG_HW):
        assert_same(jcert.quantized_truth_cm(sc, jcfg, subpixel),
                    tcert.quantized_truth_cm(sc, tcfg, subpixel))


def test_crop_and_box_helpers_identical():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
    for box in ([0.1, 0.2, 0.7, 0.9], [-0.2, 0.3, 1.1, 0.5],
                [0.5, 0.5, 0.5, 0.5]):
        for out_hw in ((16, 12), (1, 1), (7, 1)):
            assert_same(
                jcert.crop_corner_aligned_np(img, np.array(box), *out_hw),
                tcert.crop_corner_aligned_np(img, np.array(box), *out_hw))
    box = np.array([10.0, -5.0, 230.0, 330.0])
    assert_same(jcert.expand_clip_normalize_np(box, 13, IMG_HW),
                tcert.expand_clip_normalize_np(box, 13, IMG_HW))


@pytest.mark.parametrize("seed", SEEDS)
def test_bottomup_arrays_and_truth_identical(seed):
    scenes = jcbu.make_multi_scenes(3, seed, (128, 160), max_people=3)
    for p in (3, 2):
        assert_same(jcbu.bottomup_arrays(scenes, p),
                    tcbu.bottomup_arrays(scenes, p))
    for sc in scenes:
        for i in range(sc.keypoints.shape[0]):
            vis = sc.visible[i].copy()
            vis[[0, 15]] = False
            for v in (sc.visible[i], vis):
                assert_same(
                    jcbu.bottomup_path_truth_cm(sc.keypoints[i], v, 170.0,
                                                (512, 512), (128, 160)),
                    tcbu.bottomup_path_truth_cm(sc.keypoints[i], v, 170.0,
                                                (512, 512), (128, 160)))


def test_match_persons_iou_identical():
    rng = np.random.default_rng(4)
    for _ in range(20):
        p, t = int(rng.integers(1, 5)), int(rng.integers(1, 4))
        xy = rng.uniform(0, 100, (t, 2))
        true = np.concatenate([xy, xy + rng.uniform(5, 60, (t, 2))], 1)
        yx = rng.uniform(0, 100, (p, 2))
        pred = np.concatenate([yx, yx + rng.uniform(5, 60, (p, 2))], 1)
        pred[0] = true[0, [1, 0, 3, 2]]   # one exact match
        valid = rng.random(p) < 0.8
        assert (jcbu.match_persons_iou(pred, valid, true)
                == tcbu.match_persons_iou(pred, valid, true))
