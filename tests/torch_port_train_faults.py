"""Faults planted in the port's training at run time, to show that the
training checks fail a wrong step. Nothing is edited: `planted(name)`
monkeypatches the port for the duration of a `with` block.

  * no_optimizer_step: Adam's `step` does nothing (the weights never move);
  * unbiased_running_var: train-mode BatchNorm moves its running variance
    with torch's own unbiased batch variance (flax takes the biased one);
  * running_stats_unchanged: train-mode BatchNorm leaves its running
    statistics where they were;
  * schedule_before_update: the schedule steps before Adam does, so each
    update takes the next step's rate (optax reads the count before the
    update).

`python -m tests.torch_port_train_faults` runs the CPU checks of the
resident loops and of the optimizer (tests/test_torch_port_train_step.py)
under each fault and prints what each check reads and whether it fails;
`python -m tests.test_torch_port_train_goldens --faults` does the same for
the full-width train-step goldens.
"""

import contextlib
import importlib
import pkgutil

import torch
import torch.nn.functional as F

FAULTS = ("no_optimizer_step", "unbiased_running_var",
          "running_stats_unchanged", "schedule_before_update")


def _model_modules():
    import human_body_proportion_estimation_tpu_torch.models as models

    return [importlib.import_module(f"{models.__name__}.{m.name}")
            for m in pkgutil.iter_modules(models.__path__)]


@contextlib.contextmanager
def planted(fault):
    """The port with `fault` (one of FAULTS) for the `with` block."""
    from human_body_proportion_estimation_tpu_torch.models import layers
    from human_body_proportion_estimation_tpu_torch.training import trainer

    sound_bn = layers.batch_norm

    def unbiased(bn, x):
        if not bn.training:
            return sound_bn(bn, x)
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, True, bn.momentum, bn.eps)

    def unchanged(bn, x):
        if not bn.training:
            return sound_bn(bn, x)
        return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0,
                            bn.eps)

    def schedule_first(state, clip_norm=0.0):
        if clip_norm > 0:
            trainer.clip_by_global_norm(state.model.parameters(), clip_norm)
        if state.scheduler is not None:
            state.scheduler.step()
        state.optimizer.step()
        state.step += 1

    patches = []       # (owner, attribute, planted value)
    if fault == "no_optimizer_step":
        patches.append((torch.optim.Adam, "step",
                        lambda self, closure=None: None))
    elif fault in ("unbiased_running_var", "running_stats_unchanged"):
        bn = unbiased if fault == "unbiased_running_var" else unchanged
        patches += [(m, "batch_norm", bn) for m in _model_modules()
                    if getattr(m, "batch_norm", None) is sound_bn]
    elif fault == "schedule_before_update":
        patches.append((trainer, "optimizer_step", schedule_first))
    else:
        raise ValueError(fault)
    saved = [(owner, name, getattr(owner, name))
             for owner, name, _ in patches]
    try:
        for owner, name, value in patches:
            setattr(owner, name, value)
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def main():
    import warnings

    import jax

    jax.config.update("jax_platforms", "cpu")
    from tests import test_torch_port_train_step as TS

    readings = {}
    sound_update = TS.update_rel_errs

    def record(*args):
        readings["update"] = out = sound_update(*args)
        return out

    TS.update_rel_errs = record
    checks = ("test_train_pose_resident_matches_jax",
              "test_train_det_resident_matches_jax_and_sets_the_focal_prior",
              "test_adam_schedule_and_clip_match_optax")
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    for fault in (None,) + FAULTS:
        for check in checks:
            readings.clear()
            with (planted(fault) if fault else contextlib.nullcontext()):
                try:
                    getattr(TS, check)()
                    verdict = "passes"
                except AssertionError as e:
                    verdict = "FAILS: " + " ".join(str(e).split())[:120]
            print(f"{fault or 'sound'} | {check} | update "
                  f"{readings.get('update')} | {verdict}", flush=True)


if __name__ == "__main__":
    main()
