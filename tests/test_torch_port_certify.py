"""The port's checkpoints and certification CLIs against the JAX
package's: `models/weights` (`state_dict_to_flax`, the compact
checkpoint), the training loop's Orbax checkpoint, the head-score weight
cache across a train step, and `cli/certify` / `cli/certify_bottomup`
(flags, report keys, the Orbax `ckpt/` they write, the options refused
before anything is built, no fallback to the CPU). The CLIs run end to
end with `--smoke --cpu` on a few steps."""

import argparse
import ast
import inspect
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_body_proportion_estimation_tpu.cli import (
    certify as jcli,
    certify_bottomup as jcli_bu,
)
from human_body_proportion_estimation_tpu.models import weights as jweights
from human_body_proportion_estimation_tpu.models.hrnet import (
    HRNet as JHRNet,
    HRNetConfig as JHRConfig,
)
from human_body_proportion_estimation_tpu_torch.models.tflite_import import (
    DEFAULT_TFLITE_PATH,
)
from human_body_proportion_estimation_tpu_torch.cli import (
    certify as tcli,
    certify_bottomup as tcli_bu,
)
from human_body_proportion_estimation_tpu_torch.models import (
    efficientdet as tedet,
    weights,
)
from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
    HigherHRNet,
)
from human_body_proportion_estimation_tpu_torch.models.hrnet import (
    HRNet,
    HRNetConfig,
)
from human_body_proportion_estimation_tpu_torch.models.layers import (
    init_flax_default,
)
from human_body_proportion_estimation_tpu_torch.training import (
    detection as D,
)
from tests.test_torch_port_models import _port_edet_config
from tests.torch_port_orbax import assert_bit_equal, block_tensorstore
from tests.tiny_models import tiny_edet_config

POSE = dict(width=16, stage_modules=(1, 1, 1), blocks_per_branch=1,
            stem_channels=16, bottleneck_channels=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tiny models gain nothing from torch's intra-op threads, and
    beside the suite's other workers those threads oversubscribe the CPU
    (each op's parallel region waits for all of them): one thread a test,
    the process's setting restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_state(model, seed):
    """`model` at flax's init from `seed`, with random BN statistics."""
    init_flax_default(model, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
    return model.state_dict()


@pytest.mark.parametrize("make", [
    lambda: HRNet(HRNetConfig(**POSE)),
    lambda: HigherHRNet(HRNetConfig(**POSE), num_deconv_blocks=1),
    lambda: tedet.EfficientDet(_port_edet_config(tiny_edet_config())),
], ids=["hrnet", "higherhrnet", "efficientdet"])
def test_state_dict_to_flax_round_trip_is_the_identity(make):
    """port -> flax -> port is exact, the transposed conv's flip included,
    and the flax tree has JAX's structure (`jax.eval_shape` of the flax
    HigherHRNet, checked in test_torch_port_train_step.py)."""
    sd = random_state(make(), 0)
    tree = weights.state_dict_to_flax(sd)
    back = weights.flax_to_state_dict(tree)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v.to(back[k].dtype)), k
    assert set(tree) == {"params", "batch_stats"}


def test_compact_checkpoint_loads_in_jax_with_the_same_forward(tmp_path):
    """A compact checkpoint written by the port holds the keys, order,
    dtypes and values JAX's `save_compact_checkpoint` writes for the same
    trees; JAX's `load_compact_checkpoint` reads it, and the flax HRNet on
    what it read computes the port's forward on the same f16 weights."""
    model = HRNet(HRNetConfig(**POSE), dtype=torch.float32)
    sd = random_state(model, 3)
    path = str(tmp_path / "port.npz")
    weights.save_compact_checkpoint(path, None, sd)
    ref = str(tmp_path / "jax.npz")
    jweights.save_compact_checkpoint(ref, {},
                                     weights.state_dict_to_flax(sd))
    got, want = np.load(path), np.load(ref)
    assert got.files == want.files
    for name in want.files:
        assert got[name].dtype == want[name].dtype == np.float16
        np.testing.assert_array_equal(got[name], want[name])

    det, pose = jweights.load_compact_checkpoint(path)
    assert det == {}
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 32, 3)).astype(
        np.float32)
    jm = JHRNet(config=JHRConfig(**POSE), dtype=jnp.float32)
    jout = np.asarray(jax.jit(jm.apply)(pose, x))
    _, tpose = weights.load_compact_checkpoint(path)
    model.load_state_dict(weights.flax_to_state_dict(tpose), strict=True)
    with torch.no_grad():
        tout = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tout.numpy().transpose(0, 2, 3, 1), jout,
                               rtol=1e-4, atol=1e-4)


def test_training_checkpoint_round_trip_is_exact(tmp_path, monkeypatch):
    """The training loop's checkpoint, an Orbax `step_N/` of `{params,
    batch_stats, step}` as JAX's `training/loop._save` writes: JAX's
    `PyTreeCheckpointer` restores what the port writes, the port's reader
    gives the same tree, and it converts back to the state exactly."""
    import types

    import orbax.checkpoint as ocp

    from human_body_proportion_estimation_tpu_torch.models import (
        orbax_store,
    )
    from human_body_proportion_estimation_tpu_torch.training import loop

    model = HigherHRNet(HRNetConfig(**POSE), num_deconv_blocks=1)
    sd = random_state(model, 5)
    block_tensorstore(monkeypatch)
    loop._save(str(tmp_path), types.SimpleNamespace(model=model), 123)
    ref = ocp.PyTreeCheckpointer().restore(str(tmp_path / "step_123"))
    got = orbax_store.load_tree(str(tmp_path / "step_123"))
    assert set(got) == {"params", "batch_stats", "step"}
    assert got["step"].dtype == np.int32 and got["step"].shape == ()
    assert int(got["step"]) == 123
    assert_bit_equal(got, jax.tree.map(np.asarray, ref))
    back = weights.flax_to_state_dict({k: got[k] for k in ("params",
                                                           "batch_stats")})
    for k, v in sd.items():
        assert torch.equal(back[k], v.to(back[k].dtype)), k
    assert got["params"]["head1"]["kernel"].dtype == np.float32


def test_head_score_cache_refreshes_after_a_train_step():
    """The serving forward keys its packed class-predict weight on the
    parameter's version counter; an optimizer step moves it, so the
    forward after training scores with the trained weights."""
    model = tedet.EfficientDet(_port_edet_config(tiny_edet_config()),
                               dtype=torch.float32)
    state = D.create_det_train_state(model, 0,
                                     learning_rate=1e-2)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 128, 128, 3), dtype=np.uint8))
    with torch.no_grad():
        before = model.eval()(images)
    w_before = model._class_predict_params()[0].clone()
    gt = torch.tensor([[[20.0, 30.0, 90.0, 70.0]]] * 2)
    D.train_step(state, images, gt, torch.zeros((2, 1), dtype=torch.int64),
                 torch.ones((2, 1), dtype=torch.bool))
    with torch.no_grad():
        after = model.eval()(images)
    w = model.class_net.predict_pw.weight
    cached, bias = model._class_predict_params()
    assert not torch.equal(cached, w_before)
    assert torch.equal(cached, w.detach().reshape(w.shape[0], -1))
    assert torch.equal(bias, model.class_net.predict_pw.bias.detach())
    assert not torch.equal(before[0], after[0])


# --------------------------------------------------------------------- #
# the CLIs


class Grab(Exception):
    pass


def jax_parser(monkeypatch, main):
    def grab(self, *a, **k):
        raise Grab(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Grab) as caught:
            main([])
    return caught.value.args[0]


def options(parser):
    return {a.dest: (a.default, a.choices, a.required, a.nargs,
                     a.const, a.type)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("jmain,tparser", [
    (jcli.main, tcli.build_parser), (jcli_bu.main, tcli_bu.build_parser),
], ids=["certify", "certify_bottomup"])
def test_flags_are_the_jax_clis_plus_cpu(monkeypatch, jmain, tparser):
    got, want = options(tparser()), options(jax_parser(monkeypatch, jmain))
    assert got.pop("cpu") == (False, None, False, 0, True, None)
    assert got == want


def literal_keys(module, func, target):
    """String keys written into `target` in `func` of `module`'s source:
    `target["k"] = ...` and `target[: dict] = {"k": ...}` (func's
    `return {...}` with target None)."""
    fn = next(n for n in ast.walk(ast.parse(inspect.getsource(module)))
              if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        if target is None and isinstance(node, ast.Return) and isinstance(
                node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in getattr(node, "targets", [getattr(node, "target",
                                                       None)]):
                if (isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name) and t.value.id == target
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
                if (isinstance(t, ast.Name) and t.id == target
                        and isinstance(node.value, ast.Dict)):
                    keys |= {k.value for k in node.value.keys}
    return keys


def test_certify_smoke_runs_end_to_end_with_the_jax_report(tmp_path,
                                                           capsys,
                                                           monkeypatch):
    """`cli.certify --smoke --cpu` on a few steps: train, checkpoint (Orbax,
    read by JAX), reload (checked equal inside), serve over HTTP, COCO
    eval, gates. The
    report's keys are the JAX CLI's on its smoke path (all but the SSD
    sweep's and the compact checkpoint's, which the smoke does not
    write), and so are the keys of each section."""
    out = tmp_path / "w"
    rc = tcli.main(["--smoke", "--cpu", "--workdir", str(out),
                    "--pose-steps", "4", "--det-steps", "3"])
    report = json.loads((out / "report.json").read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == report
    assert rc == (0 if report["certified"] else 1)
    want = literal_keys(jcli, "main", "report") - {"served_ssd",
                                                   "compact_checkpoint"}
    assert set(report) == want
    for section, func in (("det_val", "detector_val_report"),
                          ("served", "serve_sweep"),
                          ("pose_val", "pose_val_report")):
        assert set(report[section]) == literal_keys(jcli, func, None)
    assert set(report["gates"]) == literal_keys(jcli, "main", "gates") - {
        "mean_cm_err", "p95_cm_err"}
    assert report["mode"] == "smoke" and report["platform"] == "cpu"
    assert report["served"]["scenes"] == 4
    assert report["coco_eval"]["images"] == 8
    for name in ("pose_loss_first", "pose_loss_last", "det_loss_first",
                 "det_loss_last"):
        assert np.isfinite(report[name])
    # ckpt/ is the JAX package's pipeline checkpoint: JAX's loader reads
    # what the port's does, with tensorstore kept from the port
    block_tensorstore(monkeypatch)
    det, pose = weights.load_pipeline_checkpoint(str(out / "ckpt"))
    jdet, jpose = jweights.load_pipeline_checkpoint(str(out / "ckpt"))
    assert_bit_equal(det, jax.tree.map(np.asarray, jdet))
    assert_bit_equal(pose, jax.tree.map(np.asarray, jpose))
    assert "head" in pose["params"] and "class_net" in det["params"]

    # --reuse-checkpoint serves what was written, training nothing
    rc = tcli.main(["--smoke", "--cpu", "--workdir", str(out),
                    "--reuse-checkpoint", "--skip-coco"])
    again = json.loads((out / "report.json").read_text())
    assert "pose_loss_first" not in again
    assert again["pose_val"] == report["pose_val"]


def test_certify_bottomup_smoke_runs_end_to_end_with_the_jax_report(
        tmp_path, capsys, monkeypatch):
    out = tmp_path / "w"
    rc = tcli_bu.main(["--smoke", "--cpu", "--workdir", str(out),
                       "--steps", "3", "--emit-compact",
                       str(out / "c.npz")])
    report = json.loads((out / "report.json").read_text())
    assert rc == (0 if report["certified"] else 1)
    want = literal_keys(jcli_bu, "main", "report")
    if not report["certified"]:
        want -= {"compact_checkpoint"}
        assert not (out / "c.npz").exists()
    assert set(report) == want
    assert set(report["direct"]) == literal_keys(
        jcli_bu, "bottomup_direct_sweep", None)
    assert set(report["http"]) == literal_keys(
        jcli_bu, "bottomup_http_sweep", None)
    assert set(report["gates"]) == literal_keys(jcli_bu, "main", "gates")
    assert report["input_hw"] == [128, 128] and report["direct"][
        "scenes"] == 4 and report["http"]["scenes"] == 2
    assert np.isfinite(report["loss_first"])
    # ckpt/pose is the JAX package's pose checkpoint
    block_tensorstore(monkeypatch)
    assert_bit_equal(weights.load_pose_checkpoint(str(out / "ckpt")),
                     jax.tree.map(np.asarray, jweights.load_pose_checkpoint(
                         str(out / "ckpt"))))


@pytest.mark.parametrize("main,argv,item", [
    (tcli.main, ["--detector", "ssd"], DEFAULT_TFLITE_PATH),
    (tcli.main, ["--emit-compact"], "PATH"),
    (tcli.main, ["--emit-compact", "default"], "PATH"),
    (tcli_bu.main, ["--emit-compact"], "PATH"),
], ids=["ssd", "bare-emit", "default-emit", "bottomup-bare-emit"])
def test_options_not_ported_exit_2(main, argv, item, tmp_path, capsys):
    """Before anything is built: `--detector ssd` names the reference's
    ssd.tflite, absent here (JAX's SSD is never random);
    `--emit-compact` without a path (JAX writes the reference package's
    committed checkpoint there) asks for one."""
    with pytest.raises(SystemExit) as exc:
        main(argv + ["--cpu", "--smoke", "--workdir", str(tmp_path)])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("main", [tcli.main, tcli_bu.main],
                         ids=["certify", "certify_bottomup"])
def test_certify_clis_run_on_the_gpu_without_fallback(main, tmp_path):
    """Without --cpu the CLIs take the GPU; with no GPU they fail
    before training anything, never moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["--smoke", "--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w" / "ckpt").exists()
