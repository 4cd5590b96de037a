"""Goldens for the port's full-width train steps on the card
(`chip_smoke.py` phase T): the JAX package's train steps of HRNet-W32 at
384x288 (certified weights), EfficientDet-Lite0 at 480x640 and
HigherHRNet-W32 at 512x512 (flax-like inits drawn with numpy), batch 2,
three Adam steps each, the cases of tests/torch_port_train.py.

The JAX side runs twice. In float64 (`jax.enable_x64`, the modules at
dtype float64 on the same f32-valued weights; the heads and the losses
stay f32 as in the models): flax's f32 train-mode BatchNorm takes the
variance as E[x^2] - E[x]^2 and carries ~1e-5 of rounding noise a layer
(tests/test_torch_port_train_step.py). And in bfloat16 as the models
train (bf16 compute, f32 parameters, BatchNorm statistics, heads and
losses), the reference for the port's bf16 steps. The card runs the port
in float64 (the goldens' function), in float32 with TF32 off, and in bf16
against the bf16 goldens. A train step at a random init is badly
conditioned (a deep BatchNorm network's gradients at init amplify
rounding: the port's f32 Lite0 step on the CPU is ~1% off float64 in the
stem's gradient, the certified HRNet ~1e-5), so each dtype, case and group
of figures (`torch_port_train.group`: the first step's loss and gradients,
the BatchNorm statistics, the losses after the Adam steps) has its
tolerance: FACTOR times what the port's train steps on this CPU reach
against the same goldens (`cpu_rel_err`), at least FLOOR (ADAM_FLOOR for
the losses after the Adam steps, which move every weight by +-lr whatever
the size of its gradient).

`--faults` plants faults in the port at run time (monkeypatched, nothing
is edited), runs the f32 and float64 cases on the CPU with each, and
records what they read (`fault_rel_err`) beside the tolerances: a step
that never updates the weights, torch's unbiased running variance, and
running statistics left unchanged. Each must read above its group's
tolerance (the goldens' steps run at a constant rate; the schedule's
order is held by the optimizer test of test_torch_port_train_step.py,
which `python -m tests.torch_port_train_faults` plants faults in too).

Regenerate with `JAX_PLATFORMS=cpu python -m tests.test_torch_port_train_goldens`
(about an hour and ~10 GB on the CPU: XLA's float64 convolutions are
slow); `--port-only` measures the port's side again and rewrites the
tolerances, `--faults` the fault readings; `--pose-init PATH` writes
JAX's initial HRNet-W32 state of `cli.certify` (PRNGKey(0)) as a port
training checkpoint. The slow test recomputes the JAX side and holds it
against the file.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests import torch_port_train as cases

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_port")
GOLDEN = os.path.join(DATA_DIR, "train_goldens.json")
KINDS = ("pose", "det", "bottomup")
# the card's tolerance: FACTOR times what the port reaches on the CPU, at
# least FLOOR (ADAM_FLOOR for the losses after the Adam steps)
FACTOR, FLOOR, ADAM_FLOOR = 4.0, 1e-4, 1e-3


def jax_case(kind, dtype="float64"):
    """The case's recorded quantities from the JAX package's train step,
    in float64 or as the models train ("bfloat16")."""
    import jax
    import jax.numpy as jnp
    import optax

    from human_body_proportion_estimation_tpu.models.efficientdet import (
        EFFICIENTDET_LITE0,
        EfficientDet,
    )
    from human_body_proportion_estimation_tpu.models.higherhrnet import (
        HigherHRNet,
    )
    from human_body_proportion_estimation_tpu.models.hrnet import (
        HRNET_W32,
        HRNet,
    )
    from human_body_proportion_estimation_tpu.training import (
        bottomup as JBU,
        detection as JD,
        trainer as JT,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        flax_to_state_dict,
        state_dict_to_flax,
    )

    _, state = cases.model_and_state(kind)
    batch = cases.inputs(kind)
    tree = state_dict_to_flax({k: torch.from_numpy(v)
                               for k, v in state.items()})
    adam = optax.adam(cases.LR[kind])
    # Adam, and the gradients of each step kept in the optimizer state
    tx = optax.GradientTransformation(
        init=lambda p: (adam.init(p), jax.tree.map(jnp.zeros_like, p)),
        update=lambda g, s, p=None: (
            lambda us: (us[0], (us[1], g)))(adam.update(g, s[0], p)))
    wide = dtype == "float64"
    with jax.enable_x64(wide):
        f64 = (dict(dtype=jnp.float64, param_dtype=jnp.float64) if wide
               else dict(dtype=jnp.bfloat16, param_dtype=jnp.float32))
        tree = jax.tree.map(lambda a: jnp.asarray(
            a, jnp.float64 if wide else jnp.float32), tree)
        images = jnp.asarray(batch["images"])
        if kind == "pose":
            model = HRNet(config=HRNET_W32, **f64)
            tgt = JT.heatmap_targets(jnp.asarray(batch["kp_hm"]),
                                     jnp.asarray(batch["visible"]), 96, 72,
                                     2.0)
            args = (images.astype(jnp.float32) / 255.0, tgt,
                    jnp.asarray(batch["visible"], jnp.float32))

            def step(st, *a):
                return JT.train_step(model, tx, st, *a, fg_weight=12.0)
        elif kind == "det":
            model = EfficientDet(config=EFFICIENTDET_LITE0, **f64)
            args = (images, jnp.asarray(batch["gt_boxes"]),
                    jnp.asarray(batch["gt_classes"]),
                    jnp.asarray(batch["gt_valid"]))

            def step(st, *a):
                return JD.train_step(model, tx, st, *a)
        else:
            model = HigherHRNet(**f64)
            args = (images.astype(jnp.float32) / 255.0,
                    jnp.asarray(batch["keypoints"]),
                    jnp.asarray(batch["visible"]))

            def step(st, *a):
                return JBU.bottomup_train_step(model, tx, st, *a,
                                               ae_weight=1e-3,
                                               fg_weight=12.0)

        kind_state = JD.DetTrainState if kind == "det" else JT.PoseTrainState
        st = kind_state(jnp.zeros((), jnp.int32), tree["params"],
                        tree["batch_stats"], tx.init(tree["params"]))
        step = jax.jit(step)
        out = {"losses": []}
        for i in range(cases.STEPS):
            st, loss = step(st, *args)
            out["losses"].append(float(loss))
            if i == 0:
                grads = jax.tree.map(np.asarray, st.opt_state[1])
                out["grad_norm"] = float(np.sqrt(sum(
                    np.sum(np.square(g, dtype=np.float64))
                    for g in jax.tree.leaves(grads))))
                named = flax_to_state_dict({"params": grads})
                out["grad_norms"] = {
                    n: float(named[n].double().norm())
                    for n in cases.GRADS[kind]}
                stats = flax_to_state_dict({"batch_stats": jax.tree.map(
                    np.asarray, st.batch_stats)})
                for prefix, bn in zip(("bn", "bn_low"), cases.BN[kind]):
                    out[f"{prefix}_mean"] = stats[
                        f"{bn}.running_mean"].double().tolist()
                    out[f"{prefix}_var"] = stats[
                        f"{bn}.running_var"].double().tolist()
    return out


DTYPES = {"float64": (torch.float64, "cases"),
          "float32": (torch.float32, "cases"),
          "bfloat16": (torch.bfloat16, "cases_bf16")}
# the bf16 goldens hold the pose case only: at their random inits the
# Lite0 and HigherHRNet bf16 steps of the two stacks differ by 0.46 and
# 0.074 in the first step's gradient norms on the CPU (chaotic), so a
# tolerance there would hold nothing
BF16_KINDS = ("pose",)


def port_cpu_case(kind, dtype):
    """The port's case on the CPU: float64 / float32 throughout, or bf16
    compute on f32 parameters as the models train."""
    model, _ = cases.model_and_state(kind, dtype)
    if dtype != torch.bfloat16:
        model = model.to(dtype)
    return cases.run_port(kind, model, cases.inputs(kind), "cpu")


def port_report(golden):
    """What the port's train steps on this CPU reach against the goldens of
    their dtype, and the card's tolerances derived from them."""
    golden["cpu_rel_err"] = {}
    for name, (dtype, ref) in DTYPES.items():
        golden["cpu_rel_err"][name] = errs = {}
        for kind in golden[ref]:
            errs[kind] = cases.compare(port_cpu_case(kind, dtype),
                                       golden[ref][kind])
            print(kind, name, json.dumps(errs[kind]), flush=True)
    set_tolerances(golden)


def set_tolerances(golden):
    """The card's tolerances: from the port's CPU readings, and for bf16
    also from how far JAX's own bf16 steps lie from its float64 ones
    (`jax_bf16_rel_err`). Two bf16 stacks' losses after Adam steps differ
    by that much whichever pair is taken (the card's cuDNN against JAX's
    CPU read 5.7e-2 where the port's CPU read 8.3e-3), so the CPU pair
    alone understates the noise."""
    golden["jax_bf16_rel_err"] = {
        kind: cases.compare(case, golden["cases"][kind])
        for kind, case in golden["cases_bf16"].items()}
    golden["tolerance"] = {}
    for name, errs in golden["cpu_rel_err"].items():
        golden["tolerance"][name] = {}
        for kind, err in errs.items():
            noise = cases.group(err)
            if name == "bfloat16":
                jax = cases.group(golden["jax_bf16_rel_err"][kind])
                noise = {g: max(v, jax[g]) for g, v in noise.items()}
            golden["tolerance"][name][kind] = tolerance(noise)


def tolerance(noise):
    """FACTOR times the worst relative difference in each group of figures
    (`torch_port_train.group`), at least its floor, rounded up to one
    significant digit."""
    def up(x, floor):
        x = max(FACTOR * x, floor)
        e = 10.0 ** np.floor(np.log10(x))
        return float(f"{np.ceil(x / e) * e:.1g}")

    return {k: up(v, ADAM_FLOOR if k == "after_adam" else FLOOR)
            for k, v in noise.items()}


FAULTS = ("no_optimizer_step", "unbiased_running_var",
          "running_stats_unchanged")


def fault_report(golden):
    """Each planted fault's reading in the f32 and float64 cases (the
    largest relative difference of each group), and whether it exceeds
    the group's tolerance."""
    from tests.torch_port_train_faults import planted

    golden["fault_rel_err"] = {}
    for fault in FAULTS:
        golden["fault_rel_err"][fault] = by_dtype = {}
        for name in ("float64", "float32"):
            by_dtype[name] = {}
            for kind in KINDS:
                with planted(fault):
                    got = port_cpu_case(kind, DTYPES[name][0])
                g = cases.group(cases.compare(got, golden["cases"][kind]))
                by_dtype[name][kind] = g
                tol = golden["tolerance"][name][kind]
                print(fault, name, kind, json.dumps(g), "caught:",
                      [k for k in g if g[k] > tol[k]], flush=True)


def save(golden):
    with open(GOLDEN, "w") as fh:
        json.dump(golden, fh, indent=1)
        fh.write("\n")


def generate(port_only=False, faults=False):
    if port_only or faults:
        with open(GOLDEN) as fh:
            golden = json.load(fh)
    else:
        golden = {"what": "JAX float64 (cases) and bfloat16 (cases_bf16, "
                          "the pose case) train steps, "
                          "tests/torch_port_train.py cases",
                  "cases": {}, "cases_bf16": {}}
        for kind in KINDS:
            for name, ref in (("float64", "cases"),
                              ("bfloat16", "cases_bf16")):
                if ref == "cases_bf16" and kind not in BF16_KINDS:
                    continue
                golden[ref][kind] = jax_case(kind, name)
                print(kind, name, json.dumps(golden[ref][kind]["losses"]),
                      flush=True)
        save(golden)
    if not faults:
        port_report(golden)
        save(golden)
    fault_report(golden)
    save(golden)


# which group of figures each planted fault must move past its tolerance
FAULT_GROUP = {"no_optimizer_step": "after_adam",
               "unbiased_running_var": "bn",
               "running_stats_unchanged": "bn"}
# the unbiased variance moves a running variance by 0.1 / (n - 1) of the
# batch's: 1.4e-3 at the Lite0 case's coarsest map, within 2.4x of what
# f32 rounding of that random init reads there (6.1e-4); float64 holds it
F32_BLIND = {("unbiased_running_var", "det")}


@pytest.mark.parametrize("fault", FAULTS)
def test_train_golden_tolerances_fail_the_planted_faults(fault):
    """Each tolerance of the file lies above what the port's sound steps
    read on the CPU and at least twice below what the planted fault
    reads (`--faults`), in float64 for every case and in f32 for every
    case but F32_BLIND's."""
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    group = FAULT_GROUP[fault]
    for name, by_kind in golden["fault_rel_err"][fault].items():
        for kind, reading in by_kind.items():
            tol = golden["tolerance"][name][kind]
            sound = cases.group(golden["cpu_rel_err"][name][kind])
            assert all(sound[g] <= tol[g] for g in tol), (name, kind)
            if name == "float32" and (fault, kind) in F32_BLIND:
                continue
            assert reading[group] >= 2.0 * tol[group], \
                (fault, name, kind, reading, tol)
    assert set(golden["fault_rel_err"][fault]) == {"float64", "float32"}


@pytest.mark.slow
@pytest.mark.parametrize("kind", KINDS)
def test_train_goldens_reproduce(kind):
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    err = cases.compare(jax_case(kind), golden["cases"][kind])
    assert max(err.values()) <= 1e-9, err


def save_pose_init(path, seed=0):
    """JAX's own initial pose state as `cli.certify --seed SEED` draws it
    (`create_train_state(create_hrnet("hrnet_w32"), PRNGKey(seed),
    (1, 384, 288, 3))`), written as a port training checkpoint, for
    `scripts/torch_port_pose_spread.py --init-from`."""
    import jax

    from human_body_proportion_estimation_tpu.models.hrnet import (
        create_hrnet,
    )
    from human_body_proportion_estimation_tpu.training import trainer as JT
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        flax_to_state_dict,
        save_training_checkpoint,
    )

    state, _ = JT.create_train_state(create_hrnet("hrnet_w32"),
                                     jax.random.PRNGKey(seed),
                                     (1, 384, 288, 3), 1e-3)
    tree = jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})
    save_training_checkpoint(path, flax_to_state_dict(tree))


if __name__ == "__main__":
    import sys

    if "--pose-init" in sys.argv:
        save_pose_init(sys.argv[sys.argv.index("--pose-init") + 1])
    else:
        generate(port_only="--port-only" in sys.argv,
                 faults="--faults" in sys.argv)
