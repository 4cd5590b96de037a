"""The port's metrics (`metrics/`, ROADMAP item 14) and `cli/evaluate.py`
against the JAX package's, on the CPU.

- detection AP, OKS, OKS-AP and PCK on seeded cases: equal to the JAX
  package's, float for float (both are the same numpy code); and the hand
  cases of tests/test_metrics.py on the port;
- `run_eval` of both packages on the tiny top-down pipelines of
  tests/torch_port_tiny.py (the same weights; 128x128 detector input)
  over a COCO file built from `training/synthetic.generate_scene` ground
  truth: the same JSON, and the same predictions and ground truths fed to
  the metrics (boxes and keypoints 1e-4 px, scores 1e-4);
- `cli/evaluate.main`'s flags: the JAX CLI's; `--detector ssd_mobilenet`
  (the default) without its ssd.tflite and `--checkpoint-dir` without
  tensorstore exit 2 naming the reason.
"""

import json
import os

import numpy as np
import pytest

import human_body_proportion_estimation_tpu.metrics as jmetrics
import human_body_proportion_estimation_tpu_torch.metrics as tmetrics
from human_body_proportion_estimation_tpu_torch.models.tflite_import import (
    DEFAULT_TFLITE_PATH,
)
from human_body_proportion_estimation_tpu_torch.metrics import (
    average_precision,
    detection_ap,
    match_image,
    oks,
    oks_ap,
    pck,
)


def det_case(seed):
    """Per image: (predicted boxes [N,4], scores [N]) and gt boxes [M,4],
    with predictions near the gt, spurious ones, ties in score and images
    with no gt or no prediction."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for i in range(6):
        m = int(rng.integers(0, 4)) if i else 0
        xy = rng.uniform(0, 200, (m, 2))
        wh = rng.uniform(10, 80, (m, 2))
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        near = gt + rng.normal(0, 6, gt.shape).astype(np.float32)
        n_far = int(rng.integers(0, 3)) if i != 1 else 0
        far = rng.uniform(0, 300, (n_far, 4)).astype(np.float32)
        far[:, 2:] = far[:, :2] + 20
        boxes = np.concatenate([near, far]).astype(np.float32)
        scores = np.round(rng.uniform(0, 1, len(boxes)) * 4) / 4
        preds.append((boxes, scores.astype(np.float32)))
        gts.append(gt)
    return preds, gts


def kp_case(seed):
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(4):
        m = int(rng.integers(1, 4))
        kps = rng.uniform(0, 200, (m, 17, 2)).astype(np.float32)
        vis = rng.uniform(size=(m, 17)) < 0.8
        areas = rng.uniform(500, 9000, m).astype(np.float32)
        n = int(rng.integers(0, 4))
        pk = (kps[rng.integers(0, m, n)]
              + rng.normal(0, 4, (n, 17, 2))).astype(np.float32)
        preds.append((pk, rng.uniform(0, 1, n).astype(np.float32)))
        gts.append((kps, vis, areas))
    return preds, gts


def assert_same(got, ref):
    """Equal floats (NaN where NaN), dicts key for key."""
    if isinstance(ref, dict):
        assert list(got) == list(ref)
        for key in ref:
            assert_same(got[key], ref[key])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_metrics_match_jax_on_seeded_cases(seed):
    preds, gts = det_case(seed)
    assert_same(tmetrics.detection_ap(preds, gts),
                jmetrics.detection_ap(preds, gts))
    for (boxes, scores), gt in zip(preds, gts):
        assert_same(tmetrics.match_image(boxes, scores, gt, 0.5),
                    jmetrics.match_image(boxes, scores, gt, 0.5))
    rng = np.random.default_rng(seed)
    s, tp = rng.uniform(size=20), rng.uniform(size=20) < 0.5
    assert_same(tmetrics.average_precision(s, tp, 12),
                jmetrics.average_precision(s, tp, 12))
    kp_preds, kp_gts = kp_case(seed)
    assert_same(tmetrics.oks_ap(kp_preds, kp_gts),
                jmetrics.oks_ap(kp_preds, kp_gts))
    (pk, _), (gk, gv, ga) = kp_preds[0], kp_gts[0]
    if len(pk):
        assert_same(tmetrics.oks(pk[0], gk[0], gv[0], float(ga[0])),
                    jmetrics.oks(pk[0], gk[0], gv[0], float(ga[0])))
    m = min(len(pk), len(gk))
    assert_same(tmetrics.pck(pk[:m], gk[:m], gv[:m], 50.0, 0.2),
                jmetrics.pck(pk[:m], gk[:m], gv[:m], 50.0, 0.2))


# the hand cases of tests/test_metrics.py, on the port


def test_match_image_greedy_claims():
    gts = np.asarray([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32)
    dets = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                       [100, 100, 110, 110]], np.float32)
    scores = np.asarray([0.9, 0.8, 0.7, 0.95], np.float32)
    assert match_image(dets, scores, gts, 0.5).tolist() == [
        True, False, True, False]


def test_average_precision_hand_case_and_edges():
    ap = average_precision(np.asarray([0.9, 0.8, 0.7]),
                           np.asarray([True, False, True]), 2)
    assert abs(ap - (51 * 1.0 + 50 * (2 / 3)) / 101) < 1e-9
    assert np.isnan(average_precision(np.zeros(0), np.zeros(0, bool), 0))
    assert average_precision(np.zeros(0), np.zeros(0, bool), 3) == 0.0
    assert average_precision(np.asarray([0.9, 0.8]),
                             np.asarray([True, True]), 2) == pytest.approx(1.0)


def test_detection_ap_perfect_and_garbage():
    gts = [np.asarray([[0, 0, 10, 10]], np.float32),
           np.asarray([[5, 5, 25, 25], [40, 40, 60, 60]], np.float32)]
    perfect = [(g.copy(), np.full(len(g), 0.9, np.float32)) for g in gts]
    res = detection_ap(perfect, gts)
    assert res["mAP"] == pytest.approx(1.0)
    assert res["AP50"] == pytest.approx(1.0)
    garbage = [(np.asarray([[900, 900, 910, 910]], np.float32),
                np.asarray([0.9], np.float32)) for _ in gts]
    assert detection_ap(garbage, gts)["mAP"] == pytest.approx(0.0)


def test_oks_pck_and_oks_ap_hand_cases():
    kp = np.random.default_rng(0).uniform(0, 100, (17, 2)).astype(np.float32)
    vis = np.ones(17, bool)
    assert oks(kp, kp, vis, area=900.0) == pytest.approx(1.0)
    assert oks(kp + np.asarray([200.0, 0.0], np.float32), kp, vis,
               area=900.0) < 0.01
    assert oks(kp + 3.0, kp, vis, area=10000.0) > oks(kp + 3.0, kp, vis,
                                                      area=100.0)
    pred = np.zeros((1, 3, 2), np.float32)
    gt = np.asarray([[[0, 0], [0, 4], [50, 50]]], np.float32)
    assert pck(pred, gt, np.asarray([[True, True, False]]), 10.0,
               threshold=0.5) == pytest.approx(1.0)
    assert pck(pred, gt, np.asarray([[True, True, True]]), 10.0,
               threshold=0.5) == pytest.approx(2 / 3)
    rng = np.random.default_rng(1)
    gts, preds = [], []
    for _ in range(3):
        kps = rng.uniform(0, 200, (2, 17, 2)).astype(np.float32)
        gts.append((kps, np.ones((2, 17), bool),
                    np.asarray([5000.0, 8000.0], np.float32)))
        preds.append((kps.copy(), np.asarray([0.9, 0.8], np.float32)))
    assert oks_ap(preds, gts)["mAP"] == pytest.approx(1.0)


# --------------------------------------------------------------------- #
# cli/evaluate.py


def write_scenes_coco(directory, seeds, img_hw=(120, 160)):
    """`generate_scene` renders as PNG files in `directory` and a COCO
    file of their ground truth (one person each: the tight box, the 17
    keypoints, all visible); returns the COCO file's path."""
    import cv2

    from human_body_proportion_estimation_tpu.training.synthetic import (
        generate_scene,
    )

    images, annotations = [], []
    for i, seed in enumerate(seeds):
        scene = generate_scene(np.random.default_rng(seed), img_hw=img_hw)
        name = f"scene_{seed}.png"
        cv2.imwrite(os.path.join(directory, name), scene.image[..., ::-1])
        images.append(scenes_coco_image(i, name, scene.image.shape))
        annotations.append(scenes_coco_annotation(i, scene))
    path = os.path.join(directory, "scenes_coco.json")
    with open(path, "w") as fh:
        json.dump(coco_document(images, annotations), fh)
    return path


def scenes_coco_image(image_id, file_name, shape):
    return {"id": image_id, "file_name": file_name,
            "height": int(shape[0]), "width": int(shape[1])}


def scenes_coco_annotation(image_id, scene):
    """One scene's person in COCO form (visibility 2 for every joint)."""
    x1, y1, x2, y2 = (float(v) for v in scene.bbox_xyxy)
    keypoints = np.concatenate(
        [scene.keypoints, 2.0 * scene.visible[:, None]], 1)
    return {"id": image_id, "image_id": image_id, "category_id": 1,
            "iscrowd": 0, "bbox": [x1, y1, x2 - x1, y2 - y1],
            "area": (x2 - x1) * (y2 - y1),
            "keypoints": [float(v) for v in keypoints.reshape(-1)],
            "num_keypoints": int(scene.visible.sum())}


def coco_document(images, annotations):
    return {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "person"}]}


@pytest.fixture
def recorded(monkeypatch):
    """Every call each package's `run_eval` makes to detection_ap, oks_ap
    and pck, with its arguments."""
    calls = {"jax": [], "port": []}
    for key, module in (("jax", jmetrics), ("port", tmetrics)):
        for name in ("detection_ap", "oks_ap", "pck"):
            plain = getattr(module, name)

            def record(*args, plain=plain, name=name, key=key, **kw):
                calls[key].append((name, args, kw))
                return plain(*args, **kw)

            monkeypatch.setattr(module, name, record)
    return calls


def assert_args_close(got, ref):
    """Nested tuples / lists of arrays: shapes and dtypes equal, floats to
    1e-4 absolute (boxes and keypoints in px, scores)."""
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_args_close(g, r)
    elif isinstance(ref, np.ndarray):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        if ref.dtype == bool:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    else:
        assert got == pytest.approx(ref, abs=1e-4)


def test_run_eval_matches_jax(tmp_path, recorded):
    """Both `run_eval`s on the same tiny pipeline weights over 4 rendered
    scenes in batches of 3 (a missing file counted): the same JSON, and
    the same arguments to every metric call."""
    from human_body_proportion_estimation_tpu.cli import evaluate as jeval
    from human_body_proportion_estimation_tpu_torch.cli import (
        evaluate as teval,
    )
    from tests.torch_port_tiny import jax_pipeline, tiny_models

    ann = write_scenes_coco(str(tmp_path), (0, 1, 2, 3))
    with open(ann) as fh:
        doc = json.load(fh)
    doc["images"].append(scenes_coco_image(9, "missing.png", (120, 160)))
    with open(ann, "w") as fh:
        json.dump(doc, fh)
    m = tiny_models()
    ref = jeval.run_eval(jax_pipeline(m), ann, str(tmp_path), batch_size=3)
    got = teval.run_eval(m.tpipe, ann, str(tmp_path), batch_size=3)
    assert list(got) == list(ref)
    assert got["images"] == 4 and got["missing_files"] == 1
    for key in ref:
        if isinstance(ref[key], float):
            assert got[key] == pytest.approx(ref[key], abs=1e-6), key
        else:
            assert got[key] == ref[key], key
    names = [c[0] for c in recorded["jax"]]
    assert names == [c[0] for c in recorded["port"]]
    assert names.count("pck") == 4 and names[-2:] == ["detection_ap",
                                                      "oks_ap"]
    for (_, g_args, g_kw), (_, r_args, r_kw) in zip(recorded["port"],
                                                    recorded["jax"]):
        assert g_kw == r_kw
        assert_args_close(g_args, r_args)


def test_evaluate_flags_are_the_jax_clis(monkeypatch):
    import argparse

    from human_body_proportion_estimation_tpu.cli import evaluate as jeval
    from human_body_proportion_estimation_tpu_torch.cli import (
        evaluate as teval,
    )

    class Grab(Exception):
        pass

    def grab(self, *a, **k):
        raise Grab(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Grab) as caught:
            jeval.main([])
    jparser = caught.value.args[0]

    def options(parser):
        return {a.dest: (a.default, a.choices, a.required)
                for a in parser._actions if a.dest != "help"}

    assert options(teval.build_parser()) == options(jparser)


@pytest.mark.parametrize("extra,item", [
    ([], DEFAULT_TFLITE_PATH),
    (["--detector", "efficientdet_lite4", "--checkpoint-dir", "x"],
     "needs the tensorstore package"),
])
def test_evaluate_exits_on_options_not_ported(extra, item, tmp_path, capsys,
                                              monkeypatch):
    """Before any model is built, exit 2 naming the reason: the JAX
    default detector (ssd_mobilenet) without the reference's ssd.tflite
    (absent here), --checkpoint-dir on a machine without tensorstore
    (hidden here); the compile cache flags are accepted."""
    from human_body_proportion_estimation_tpu_torch.cli import common
    from human_body_proportion_estimation_tpu_torch.ops import build
    from human_body_proportion_estimation_tpu_torch.cli import (
        evaluate as teval,
    )

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    # the compile cache flags repoint the process's build directory: put
    # it back afterwards
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(common, "InferencePipeline", no_model)
    monkeypatch.setattr(common, "has_tensorstore", lambda: False)
    with pytest.raises(SystemExit) as exc:
        teval.main(["--annotations", str(tmp_path / "a.json"),
                    "--images-dir", str(tmp_path), "--no-compile-cache",
                    "--compile-cache-dir", str(tmp_path), *extra])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err
