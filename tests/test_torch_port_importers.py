"""The port's offline importers against the JAX package's (ROADMAP item 17),
on the CPU, with synthetic inputs as the JAX tests have:

- the official-name pose importers (`models/weights.py`): a torch
  pose_hrnet / PoseHigherResolutionNet `state_dict` (tests/torch_refs.py's
  official graphs) imports onto the port's flax tree as JAX's importer
  does, exactly; export inverts import exactly; the port's HRNet on the
  imported weights computes the official torch graph's heatmaps;
- `models/tf_import.py`: a TF1 checkpoint written from an EfficientDet-
  Lite0 init (with an ExponentialMovingAverage shadow, which wins) reads
  (TensorFlow blocked from the port: its own TensorBundle reader) and
  imports to the tree JAX's importer gives, exactly;
- Orbax checkpoints (the port's own store, tensorstore kept from it):
  the port reads what JAX's `save_pipeline_checkpoint` /
  `save_pose_checkpoint` write, and JAX reads what the port's write, leaf
  for leaf;
- `cli/import_weights`: the JAX CLI's flags; a Lite0 TF checkpoint and an
  HRNet .pth (TensorFlow blocked) go into a checkpoint directory that JAX's loader reads with
  the source tensors in place and `cli.common.build_pipeline` serves
  (`--checkpoint-dir`, labelled "real").
"""

import sys

import numpy as np
import pytest
import torch

import jax

from human_body_proportion_estimation_tpu.models import (
    tf_import as jtf,
    weights as jw,
)
from human_body_proportion_estimation_tpu.models.efficientdet import (
    EFFICIENTDET_LITE0 as J_LITE0,
)
from human_body_proportion_estimation_tpu.models.hrnet import (
    HRNET_W32 as J_W32,
)
from human_body_proportion_estimation_tpu_torch.models import (
    tf_import as ttf,
    weights as tw,
)
from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
    EFFICIENTDET_LITE0,
    EfficientDet,
)
from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
    HigherHRNet,
)
from human_body_proportion_estimation_tpu_torch.models.hrnet import (
    HRNET_W32,
    HRNet,
)
from tests.torch_refs import TorchHigherHRNet, TorchPoseHRNet


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def assert_trees_equal(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def _random_tree(model, seed):
    """The flax tree of `model`'s weights, every leaf random."""
    rng = np.random.default_rng(seed)
    state = {k: torch.from_numpy(rng.normal(0, 1, tuple(v.shape)).astype(
        np.float32)) for k, v in model.state_dict().items()
        if v.is_floating_point()}
    return tw.state_dict_to_flax(state)


def _official_state(tmodel, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05, generator=gen)
                m.running_var.uniform_(0.8, 1.2, generator=gen)
    return {k: v.numpy() for k, v in tmodel.eval().state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_hrnet_importer_matches_jax_and_the_official_graph():
    tmodel = TorchPoseHRNet(width=32)
    sd = _official_state(tmodel, 0)
    base = _random_tree(HRNet(HRNET_W32), 1)
    got = tw.import_torch_hrnet(sd, base, HRNET_W32)
    assert_trees_equal(got, jw.import_torch_hrnet(sd, base, J_W32))
    # export inverts import (official keys that HRNet uses), and equals JAX
    exported = tw.export_torch_hrnet(got, HRNET_W32)
    ref = jw.export_torch_hrnet(got, J_W32)
    assert sorted(exported) == sorted(ref) and set(sd) <= set(exported)
    for key in ref:
        np.testing.assert_array_equal(exported[key], ref[key], err_msg=key)
    for key in sd:
        np.testing.assert_array_equal(exported[key], sd[key], err_msg=key)
    assert_trees_equal(tw.import_torch_hrnet(exported, base, HRNET_W32),
                       got)
    # the port's HRNet on the imported weights = the official torch graph
    port = HRNet(HRNET_W32, dtype=torch.float32)
    port.load_state_dict(tw.flax_to_state_dict(got), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (1, 3, 128, 96)).astype(np.float32))
    with torch.no_grad():
        want, have = tmodel(x), port.eval()(x)
    assert want.std() > 1e-5
    torch.testing.assert_close(have, want, rtol=2e-3, atol=1e-3)


def test_higherhrnet_importer_matches_jax():
    sd = _official_state(TorchHigherHRNet(width=32), 3)
    base = _random_tree(HigherHRNet(), 4)
    got = tw.import_torch_higherhrnet(sd, base)
    assert_trees_equal(got, jw.import_torch_higherhrnet(sd, base))
    exported = tw.export_torch_higherhrnet(got)
    ref = jw.export_torch_higherhrnet(got)
    assert sorted(exported) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(exported[key], ref[key], err_msg=key)
    assert_trees_equal(tw.import_torch_higherhrnet(exported, base), got)
    # the whole tree converts into the port's HigherHRNet
    HigherHRNet().load_state_dict(tw.flax_to_state_dict(got), strict=True)


def _write_tf1_ckpt(arrays, path):
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    graph = tf1.Graph()
    with graph.as_default():
        for name, val in arrays.items():
            tf1.get_variable(name, initializer=tf.constant(val))
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            return saver.save(sess, path)


@pytest.fixture(scope="module")
def lite0_ckpt(tmp_path_factory):
    """(TF1 checkpoint prefix, its arrays) of a Lite0 with random leaves;
    one variable also carries an EMA shadow, whose value must win."""
    tree = _random_tree(EfficientDet(EFFICIENTDET_LITE0), 5)
    arrays = ttf.export_tf_efficientdet(tree, EFFICIENTDET_LITE0)
    stem = "efficientnet-lite0/stem/conv2d/kernel"
    assert stem in arrays
    with_ema = dict(arrays)
    with_ema[f"{stem}/ExponentialMovingAverage"] = arrays[stem] + 1.0
    prefix = _write_tf1_ckpt(
        with_ema, str(tmp_path_factory.mktemp("edet") / "edet.ckpt"))
    arrays[stem] = arrays[stem] + 1.0
    return prefix, arrays, tree


def block_tensorflow(monkeypatch):
    """The port may not import TensorFlow from here on."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def test_tf_import_matches_jax(lite0_ckpt, monkeypatch):
    prefix, arrays, tree = lite0_ckpt
    ref_arrays = jtf.load_tf_checkpoint_arrays(prefix)
    block_tensorflow(monkeypatch)
    got_arrays = ttf.load_tf_checkpoint_arrays(prefix)
    assert sorted(got_arrays) == sorted(ref_arrays) == sorted(arrays)
    for key in arrays:
        np.testing.assert_array_equal(got_arrays[key], arrays[key])
    assert [repr(e) for e in ttf.efficientdet_map(EFFICIENTDET_LITE0)] == [
        repr(e) for e in jtf.efficientdet_map(J_LITE0)]
    got = ttf.import_tf_efficientdet(got_arrays, tree, EFFICIENTDET_LITE0)
    assert_trees_equal(got, jtf.import_tf_efficientdet(ref_arrays, tree,
                                                       J_LITE0))
    EfficientDet(EFFICIENTDET_LITE0).load_state_dict(
        tw.flax_to_state_dict(got), strict=True)
    with pytest.raises(KeyError):
        ttf.import_tf_efficientdet({}, tree, EFFICIENTDET_LITE0)


def test_orbax_checkpoints_cross_read(tmp_path, monkeypatch):
    from tests.torch_port_orbax import block_tensorstore

    block_tensorstore(monkeypatch)
    rng = np.random.default_rng(6)
    det = {"params": {"a": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(
        np.float32)}}, "batch_stats": {"a": {"mean": np.zeros(4, np.float32)}}}
    pose = {"params": {"head": {"bias": rng.normal(size=3).astype(
        np.float32), "kernel": rng.normal(size=(1, 1, 2, 3)).astype(
        np.float32)}}}
    jw.save_pipeline_checkpoint(str(tmp_path / "jax"), det, pose)
    got_det, got_pose = tw.load_pipeline_checkpoint(str(tmp_path / "jax"))
    assert_trees_equal(got_det, det)
    assert_trees_equal(got_pose, pose)
    tw.save_pipeline_checkpoint(str(tmp_path / "port"), det, pose)
    ref_det, ref_pose = jw.load_pipeline_checkpoint(str(tmp_path / "port"))
    assert_trees_equal(jax.tree.map(np.asarray, ref_det), det)
    assert_trees_equal(jax.tree.map(np.asarray, ref_pose), pose)
    jw.save_pose_checkpoint(str(tmp_path / "pose_only"), pose)
    assert_trees_equal(tw.load_pose_checkpoint(str(tmp_path / "pose_only")),
                       pose)
    tw.save_pose_checkpoint(str(tmp_path / "port_pose"), pose)
    assert_trees_equal(jax.tree.map(np.asarray, jw.load_pose_checkpoint(
        str(tmp_path / "port_pose"))), pose)


def test_import_weights_cli_edet_and_hrnet(lite0_ckpt, tmp_path,
                                           monkeypatch):
    from human_body_proportion_estimation_tpu.cli import (
        import_weights as jcli,
    )
    from human_body_proportion_estimation_tpu_torch.cli import (
        common,
        import_weights as tcli,
    )

    # the JAX CLI's flags, option for option
    import argparse

    caught = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        caught["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        jcli.main(["--out", "x"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)

    def options(parser):
        return {a.dest: (a.option_strings, a.default, a.choices)
                for a in parser._actions if a.dest != "help"}

    assert options(tcli.build_parser()) == options(caught["parser"])

    prefix, arrays, _ = lite0_ckpt
    tmodel = TorchPoseHRNet(width=32)
    sd = _official_state(tmodel, 7)
    pth = tmp_path / "pose_hrnet_w32.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(pth))
    out = tmp_path / "ckpt"
    block_tensorflow(monkeypatch)
    tcli.main(["--efficientdet-ckpt", prefix, "--efficientdet-variant",
               "lite0", "--hrnet-torch", str(pth), "--out", str(out)])

    det_vars, pose_vars = jw.load_pipeline_checkpoint(str(out))
    stem = "efficientnet-lite0/stem/conv2d/kernel"
    np.testing.assert_array_equal(
        det_vars["params"]["backbone"]["stem"]["conv"]["kernel"],
        arrays[stem])
    np.testing.assert_array_equal(
        pose_vars["params"]["stem1"]["conv"]["kernel"],
        np.transpose(sd["conv1.weight"], (2, 3, 1, 0)))

    plain = common.InferencePipeline
    monkeypatch.setattr(common, "InferencePipeline",
                        lambda **kw: plain(**{**kw, "device": "cpu"}))
    pipe = common.build_pipeline(argparse.Namespace(
        detector="efficientdet_lite0", checkpoint_dir=str(out)))
    assert pipe.weights_origin == {"detector": "real", "pose": "real"}
    np.testing.assert_array_equal(
        pipe.pose.stem1.conv.weight.detach().numpy(), sd["conv1.weight"])

