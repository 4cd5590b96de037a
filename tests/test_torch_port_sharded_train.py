"""The port's sharded train steps (`training/sharded.py`:
`trainer.make_sharded_train_step`, `detection.make_sharded_det_train_step`,
`bottomup.make_sharded_bottomup_step`, `loop.train_pose(mesh=)`) against
the JAX package's sharded steps on the same mesh shape, and against the
port's one-process step on the global batch, on the CPU in float64.

Worker processes (tests/torch_port_sharded_train_worker.py) over gloo on
localhost run the pose, detector and bottom-up steps at dp = 2 (two
processes) and the pose step at dp = 2 x tp = 2 (four), two steps each
from flax's init of tiny models (tests/torch_port_sharded_train.py).

- Against JAX: `make_sharded_train_step`, `make_sharded_det_train_step`
  and `make_sharded_bottomup_step` jitted over the conftest's virtual CPU
  devices (a (2, 1) and a (2, 2) mesh), in float64 under
  `jax.enable_x64`, from the same flax init and on the same global batch,
  with JAX's sharded-step defaults (no visibility weights, no peak
  weight); an optax wrapper keeps each step's gradients in the optimizer
  state. The heads compute in f32 in both models, so sound runs read
  losses 3.6e-7 relative apart, gradients 1.1e-6 of each tensor's
  largest |g| and states 5.3e-5 after two Adam steps at rate 1e-3; the
  tolerances are about 4x those.
- Against the one-process port step: only the order of the sums
  differs; sound runs read gradients 9.3e-8 of each tensor's largest |g|
  apart (the f32 heads; the float64 trunk 1e-13), losses 7.6e-11
  relative (up to 1.4e-8 seen after an Adam step through the f32 head),
  states 2.2e-9 after two steps; the tolerances are 4x the gradients' and
  states' readings, and 1e-6 for the losses.

A planted fault, BatchNorm on each shard's own statistics (what plain
DistributedDataParallel computes), reads the loss 0.053, a gradient 3.3
and a running variance 0.65 apart: far outside either set.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from human_body_proportion_estimation_tpu.models import efficientdet as jedet
from human_body_proportion_estimation_tpu.models.higherhrnet import (
    HigherHRNet as JHigher,
)
from human_body_proportion_estimation_tpu.models.hrnet import (
    HRNet as JHRNet,
    HRNetConfig as JHRConfig,
)
from human_body_proportion_estimation_tpu.parallel import mesh as JM
from human_body_proportion_estimation_tpu.training import (
    bottomup as JBU,
    detection as JD,
    trainer as JT,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
    make_mesh,
)
from human_body_proportion_estimation_tpu_torch.training import (
    loop,
    trainer as T,
)
from tests import torch_port_sharded_train as cases
from tests.test_torch_port_models import _port_edet_config
from tests.tiny_models import tiny_edet_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL, LOSS_RTOL, STATE_ATOL = 4e-7, 1e-6, 1e-8
JAX_TOL = dict(grads=4.5e-6, losses=1.5e-6, state=2e-4)
DP2_CASES = ("pose", "det", "bottomup", "pose_per_shard_bn")
# (processes, model_parallel, kind) of each sharded run held against JAX
JAX_CASES = ((2, 1, "pose"), (2, 1, "det"), (2, 1, "bottomup"),
             (4, 2, "pose"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, tp, out, names):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_port_sharded_train_worker",
         str(rank), str(world), str(tp), str(port), str(out), *names],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]


@pytest.fixture(scope="module")
def det_config():
    return _port_edet_config(tiny_edet_config())


def _jax_model(kind, dtype):
    if kind == "det":
        return jedet.EfficientDet(config=tiny_edet_config(), dtype=dtype,
                                  param_dtype=dtype)
    if kind == "bottomup":
        return JHigher(config=JHRConfig(**cases.POSE), num_deconv_blocks=1,
                       dtype=dtype, param_dtype=dtype)
    return JHRNet(config=JHRConfig(**cases.POSE), dtype=dtype,
                  param_dtype=dtype)


def _keeping_grads(inner):
    """`inner` whose state also holds the gradients of the last update."""
    def init(params):
        return inner.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, new = inner.update(grads, state[0], params)
        return updates, (new, grads)

    return optax.GradientTransformation(init, update)


def jax_sharded_run(kind, world, tp, det_config):
    """The JAX package's sharded step of a case over a (world / tp, tp)
    mesh of the virtual CPU devices, in float64, from flax's PRNGKey(0)
    init on the case's global batch: the
    losses, the first step's gradients (after the clip) and the final
    state, as port `state_dict`s, and the init."""
    hw = {"pose": cases.CROP_HW, "det": cases.DET_HW,
          "bottomup": cases.BU_HW}[kind]
    variables = jax.tree.map(np.array, jax.jit(
        _jax_model(kind, jnp.float32).init)(
            jax.random.PRNGKey(0),
            jnp.zeros((1, *hw, 3), jnp.uint8 if kind == "det"
                      else jnp.float32)))
    _, batch = cases.build(kind, det_config)
    arrays = [t.numpy() for t in batch]
    if kind != "det":   # NCHW images (and pose targets) -> NHWC
        arrays[0] = np.moveaxis(arrays[0], 1, -1)
    if kind == "pose":
        arrays[1] = np.moveaxis(arrays[1], 1, -1)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        if kind == "det":
            tx = optax.chain(
                optax.clip_by_global_norm(10.0),
                _keeping_grads(optax.adam(optax.warmup_cosine_decay_schedule(
                    0.0, cases.LR, 1, 10, 0.03 * cases.LR))))
            make, state_cls = JD.make_sharded_det_train_step, JD.DetTrainState
        else:
            tx = _keeping_grads(optax.adam(cases.LR))
            make = (JT.make_sharded_train_step if kind == "pose"
                    else JBU.make_sharded_bottomup_step)
            state_cls = JT.PoseTrainState
        state = state_cls(jnp.zeros((), jnp.int32), v64["params"],
                          v64["batch_stats"], tx.init(v64["params"]))
        step, state = make(_jax_model(kind, jnp.float64), tx, state,
                           JM.make_mesh(world, model_parallel=tp))
        losses = []
        for i in range(cases.STEPS):
            state, loss = step(state, *(jnp.asarray(a) for a in arrays))
            losses.append(float(loss))
            if i == 0:
                kept = state.opt_state[-1] if kind == "det" \
                    else state.opt_state
                grads = jax.tree.map(np.asarray, kept[1])
        final = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return {"losses": losses,
            "grads": flax_to_state_dict({"params": grads}),
            "state": flax_to_state_dict(final),
            "init": flax_to_state_dict(variables)}


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory, det_config):
    """({(world, case): rank 0's result}, {(world, kind): JAX's run}): the
    dp = 2 cases in two processes and the dp = 2 x tp = 2 pose case in
    four, spawned together; JAX's runs made while they work."""
    jobs = {}
    for world, tp, names in ((2, 1, DP2_CASES), (4, 2, ("pose",))):
        out = tmp_path_factory.mktemp(f"sharded{world}")
        with open(out / "det_config.pkl", "wb") as f:
            pickle.dump(det_config, f)
        jobs[world] = (out, names, _spawn(world, tp, out, names))
    jax_runs = {(world, kind): jax_sharded_run(kind, world, tp, det_config)
                for world, tp, kind in JAX_CASES}
    results = {}
    for world, (out, names, procs) in jobs.items():
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log
        for name in names:
            results[world, name] = torch.load(out / f"{name}.pt",
                                              weights_only=False)
    return results, jax_runs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the workers (the tiny models gain
    nothing from more, and a sum's order depends on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_process(det_config):
    return {kind: cases.run(kind, *cases.build(kind, det_config))
            for kind in ("pose", "det", "bottomup")}


def _grad_err(got, ref):
    """The largest |difference| of each gradient over its largest |g|
    (tensors whose gradient is 0 up to rounding over the model's largest
    |g|)."""
    top = max(float(g.abs().max()) for g in ref.values())
    errs = {}
    for name, g in ref.items():
        scale = float(g.abs().max())
        scale = scale if scale > 1e-12 * top else top
        errs[name] = float((got[name] - g).abs().max()) / scale
    return errs


def assert_matches(got, ref, grad_rtol=GRAD_RTOL, loss_rtol=LOSS_RTOL,
                   state_atol=STATE_ATOL):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=loss_rtol)
    assert got["grads"].keys() <= ref["grads"].keys()
    errs = _grad_err(got["grads"], {k: ref["grads"][k].double()
                                    for k in got["grads"]})
    assert max(errs.values()) <= grad_rtol, max(errs.items(),
                                                key=lambda kv: kv[1])
    for key, value in ref["state"].items():
        if value.is_floating_point():
            np.testing.assert_allclose(got["state"][key].double().numpy(),
                                       value.double().numpy(), rtol=0,
                                       atol=state_atol, err_msg=key)


def assert_matches_jax(got, ref):
    """The port's sharded run against JAX's: its parameters with a
    gradient are JAX's with a nonzero one (JAX's hold zeros elsewhere)."""
    missing = {k for k, g in ref["grads"].items()
               if float(g.abs().max()) > 0} - got["grads"].keys()
    assert not missing, sorted(missing)[:5]
    assert_matches(got, ref, JAX_TOL["grads"], JAX_TOL["losses"],
                   JAX_TOL["state"])


@pytest.mark.parametrize("world,tp,kind", JAX_CASES,
                         ids=["pose", "det", "bottomup", "pose_dp2_tp2"])
def test_sharded_step_matches_jax_sharded_step(world, tp, kind,
                                               sharded_runs, det_config):
    """The port's sharded step against JAX's on a mesh of the same shape,
    from the same init (bit-equal: the port's flax draw) on the same
    global batch."""
    ports, jaxes = sharded_runs
    ref = jaxes[world, kind]
    init = cases.build(kind, det_config)[0].model.state_dict()
    assert all(torch.equal(v.float(), ref["init"][k].float())
               for k, v in init.items())
    assert_matches_jax(ports[world, kind], ref)


@pytest.mark.parametrize("kind", ["pose", "det", "bottomup"])
def test_sharded_step_dp2_matches_one_process(kind, sharded_runs,
                                              one_process):
    assert_matches(sharded_runs[0][2, kind], one_process[kind])


def test_sharded_pose_step_dp2_tp2_matches_one_process(sharded_runs,
                                                       one_process):
    """At dp = 2 x tp = 2 the sharded leaves (output channels >= 64) are
    stored as halves, each rank its own, and the steps are still the
    one-process steps."""
    got = sharded_runs[0][4, "pose"]
    assert_matches(got, one_process["pose"])
    shardings, shapes = got["shardings"], got["stored_shapes"]
    full = one_process["pose"]["state"]
    split = [k for k, d in shardings.items() if d is not None
             and k in shapes[0]]
    assert len(split) > 10
    for key in split:
        half = list(full[key].shape)
        half[shardings[key]] //= 2
        assert all(s[key] == tuple(half) for s in shapes), key
    replicated = [k for k in shapes[0] if shardings[k] is None]
    assert replicated and all(shapes[r][k] == tuple(full[k].shape)
                              for r in range(4) for k in replicated)


def test_per_shard_batch_norm_fault_is_caught(sharded_runs, one_process):
    """BatchNorm over each shard's 2 rows instead of the global 4 moves
    the loss, the gradients and the running statistics far outside the
    tolerances the sound step meets, against the one-process step and
    against JAX's sharded step."""
    bad, ref = sharded_runs[0][2, "pose_per_shard_bn"], one_process["pose"]
    with pytest.raises(AssertionError):
        assert_matches_jax(bad, sharded_runs[1][2, "pose"])
    loss_err = abs(bad["losses"][0] - ref["losses"][0]) / ref["losses"][0]
    assert loss_err > 1e4 * LOSS_RTOL, loss_err
    assert max(_grad_err(bad["grads"], ref["grads"]).values()) \
        > 1e4 * GRAD_RTOL
    stats = [k for k in ref["state"] if k.endswith("running_var")]
    assert max(float((bad["state"][k] - ref["state"][k]).abs().max())
               for k in stats) > 1e4 * STATE_ATOL
    with pytest.raises(AssertionError):
        assert_matches(bad, ref)


def test_one_device_mesh_is_the_one_process_step(det_config, one_process):
    """A mesh of one device needs no process group and takes the
    one-process step, bit for bit."""
    state, batch = cases.build("pose", det_config)
    step, sstate = cases.sharded_step("pose", state,
                                      make_mesh(devices=["cpu"]))
    got = cases.run("pose", sstate, batch, step)
    ref = one_process["pose"]
    assert got["losses"] == ref["losses"]
    assert all(torch.equal(got["state"][k], v)
               for k, v in ref["state"].items())
    with pytest.raises(ValueError, match="torch.distributed"):
        T.make_sharded_train_step(cases.build("pose", det_config)[0],
                                  make_mesh(devices=["cpu", "cpu"]))


def test_train_pose_with_a_mesh_matches_without():
    """`loop.train_pose(mesh=)` runs the sharded step over the loop's
    batches (the same draws): on a one-device mesh, the losses and weights
    of `mesh=None`."""
    from human_body_proportion_estimation_tpu_torch.models.hrnet import (
        HRNet,
        HRNetConfig,
    )
    from human_body_proportion_estimation_tpu_torch.training import (
        data as data_lib,
    )

    rng = np.random.default_rng(0)
    samples = [data_lib.PoseSample(
        image=rng.integers(0, 256, (80, 60, 3), dtype=np.uint8),
        keypoints=rng.uniform(5, 55, (17, 2)).astype(np.float32),
        visible=rng.random(17) < 0.8,
        bbox_xywh=np.array([5.0, 5.0, 50.0, 70.0], np.float32))
        for _ in range(4)]
    runs = []
    for mesh in (None, make_mesh(devices=["cpu"])):
        model = HRNet(HRNetConfig(**cases.POSE), dtype=torch.float32)
        state, losses = loop.train_pose(
            model, samples, steps=2, batch_size=2, crop_hw=cases.CROP_HW,
            mesh=mesh, log_every=1, augment=False)
        runs.append((losses, state.model.state_dict()))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for key, value in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][key], value)
