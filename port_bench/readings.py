"""The readings that the limits of `cells/<cell>.json` are set from:

    python -m port_bench.readings --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--control-precision fp8|bf16] [--look]

For each seed, the numbers of `judge` for the program's timed path on
that seed's pool: a short window (`READ_SECONDS`) of the cell's own loop
and traffic, against the float32 reference: the lower readings. For each
control seed, the same numbers for the control, the reference with its
trunk convolutions in float8 (e4m3, one scale a tensor: the step below
the configuration's bfloat16; or in bfloat16, a witness of what rounding
alone does), on the same scenes: the upper readings. One JSON line per
reading on standard output.

`--look` (closed-loop cells): for every scene whose valid slots differ
between any two sides, one more line with each side's valid slots and
deciding scores: the program, the reference, the control, and the
reference's own selection and NMS run on the program's detector outputs
(its logits and boxes before its NMS kernel), which tells a slot that
the program's boxes decide from one that its NMS decides.

Card only; the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np

from port_bench import bench, judge, load, programs, run as run_mod

READ_SECONDS = 5.0        # the window of one program reading


def program_reading(c, program, loop, seed, pool, heights, states, ref,
                    device):
    """(numbers, program's valid slots [N, P] by pool scene or None,
    pipeline)."""
    pipe = program.pipeline(c.config, states, device)
    loop.warm_up(program, pipe, pool, heights, c)
    state = run_mod.RunState(c, 0.0)
    handle = program.record_forwards(pipe, pool, state.forwards)
    driven = loop.drive(program, pipe, state, pool, heights, c, seed,
                        READ_SECONDS, False)
    handle.remove()
    out = loop.numbers(driven.answers, ref)
    out["missing"] = driven.missing
    out["repeat_gap"] = judge.repeat_gap(
        [(f[3], f[2], f[4]) for f in state.forwards])
    valid = None
    if c.mix["loop"] == "closed":
        valid = np.zeros(ref["valid"].shape, bool)
        for idx, rows in driven.answers:
            valid[idx] = rows[..., 0] > 0.5
    return out, valid, pipe


def look(c, program, pipe, reference, pool, sides, scores, seed):
    """Lines for the scenes whose valid slots differ between sides."""
    thr = c.mix["threshold"]
    got, got_scores = [], []
    for i in range(0, len(pool), c.mix["batch"]):
        best, person, regs = program.detector_outputs(
            pipe, pool[i:i + c.mix["batch"]])
        _, valid, score = reference.slots_from_logits(
            best.float(), person.float(), regs.float(), thr)
        got.append(valid.cpu().numpy())
        got_scores.append(score.cpu().numpy())
    sides = dict(sides, plain_nms_on_program_logits=np.concatenate(got))
    scores = dict(scores,
                  plain_nms_on_program_logits=np.concatenate(got_scores))
    for i in range(len(pool)):
        rows = {k: v[i] for k, v in sides.items()}
        if len({tuple(v) for v in rows.values()}) > 1:
            print(json.dumps({
                "seed": seed, "scene": i, "valid": {
                    k: v.astype(int).tolist() for k, v in rows.items()},
                "deciding_scores": {k: np.round(v[i], 4).tolist()
                                    for k, v in scores.items()}}),
                flush=True)


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-precision", default="fp8",
                   choices=("fp8", "bf16"))
    p.add_argument("--look", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=bench.ROOT)
    args = p.parse_args(argv)
    run_mod.set_cache_dirs()
    print(run_mod.card_line(), file=sys.stderr, flush=True)
    c = bench.cell(args.workload, args.root)
    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    programs.enable_build_dir(run_mod.BUILD_DIR)
    program, loop = c.module("programs"), c.module("loops")
    reference = c.module("reference")
    det = c.config["detector"]
    thr = c.mix["threshold"]
    side_ctl = "control_" + args.control_precision
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        pool, heights = load.render_pool(
            seed, c.mix["pool"], (det["input_height"], det["input_width"]))
        states = program.weights(c.config, seed, device)
        ref = reference.Reference(c.config, states, device)
        answers = ref.answers(pool, heights, thr)
        sides = {"reference": answers["valid"]}
        scores = {"reference": answers["score"]}
        pipe = None
        if seed in args.seeds:
            numbers, valid, pipe = program_reading(
                c, program, loop, seed, pool, heights, states, answers,
                device)
            print(json.dumps({"seed": seed, "side": "program", **numbers}),
                  flush=True)
            if valid is not None:
                sides["program"] = valid
        if seed in args.control_seeds:
            ctl = reference.Reference(c.config, states, device,
                                      args.control_precision)
            low = ctl.answers(pool, heights, thr)
            del ctl
            sides[side_ctl] = low["valid"]
            scores[side_ctl] = low["score"]
            print(json.dumps({"seed": seed, "side": side_ctl,
                              **loop.control_numbers(low, answers)}),
                  flush=True)
        if args.look and pipe is not None and "program" in sides:
            look(c, program, pipe, ref, pool, sides, scores, seed)
        del pipe, ref
        gc.collect()
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
