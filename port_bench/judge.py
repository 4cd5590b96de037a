"""The comparison that decides `correct`: what the timed path returned,
against the plain reference's answers for the same scenes, and against
itself.

Each answer is a person slot: valid or not, and where valid its 11
segment lengths in cm with their visibility. The numbers compared, each
against the limit of its cell (`cells/<cell>.json`, "limits"):

    valid_flip_share  slots valid on one side only, over the slots valid
                      on either side: a person missed, or one counted
                      that is not there
    vis_flip_share    segments visible on one side only, over the
                      segments visible on either side, in the slots valid
                      on both: a keypoint gated the other way
    cm_median         the median |program - reference| in cm over the
                      segments visible on both sides. A keypoint's argmax
                      can jump to a far, nearly equal second peak on
                      rounding alone, so the largest difference and the
                      mean swing from seed to seed (they are printed, not
                      compared); the median does not.
    repeat_gap        the largest difference between two answers that the
                      program gave to the same scene in forwards of the
                      same batch size (every value of the packed row): a
                      forward computes each image alone, so these are
                      equal
    missing           answers that never came (limit 0)

A run with no segment visible on both sides compares nothing and is not
correct. `cm_max` and `cm_mean` are printed for the record.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from port_bench.reference.segments import SEGMENT_NAMES

NAMES = ("valid_flip_share", "vis_flip_share", "cm_median", "repeat_gap",
         "missing")


def share(flips: np.ndarray, either: np.ndarray) -> float:
    """flips / either, 0 where neither side has any."""
    n = int(either.sum())
    return float(flips.sum()) / n if n else 0.0


def compare(prog_valid, prog_len, prog_vis, ref: Dict[str, np.ndarray]
            ) -> Dict[str, float]:
    """Program slots [M] (lengths and visibility [M, 11]) against the
    reference's slots [M] (`ref`: valid, lengths, visible)."""
    prog_valid = np.asarray(prog_valid, bool)
    prog_vis = np.asarray(prog_vis, bool)
    both = prog_valid & ref["valid"]
    vis_a = prog_vis & both[:, None]
    vis_b = ref["visible"] & both[:, None]
    seen = vis_a & vis_b
    d = np.abs(np.asarray(prog_len, np.float64) - ref["lengths"])[seen]
    nan = float("nan")
    return {
        "valid_flip_share": share(prog_valid != ref["valid"],
                                  prog_valid | ref["valid"]),
        "vis_flip_share": share(vis_a != vis_b, vis_a | vis_b),
        "cm_median": float(np.median(d)) if d.size else nan,
        "compared": int(d.size),
        "cm_max": float(d.max(initial=0.0)),
        "cm_mean": float(d.mean()) if d.size else nan,
    }


def repeat_gap(forwards: List[tuple]) -> float:
    """`forwards`: (pool indices [n], rows run, packed rows [n, P, 23]) of
    every forward; the largest difference between the rows of one scene
    in forwards of one size."""
    first, gap = {}, 0.0
    for idx, size, rows in forwards:
        for i, row in zip(idx, rows):
            key = (int(i), size)
            if key in first:
                gap = max(gap, float(np.abs(row - first[key]).max()))
            else:
                first[key] = row
    return gap


def take(ref: Dict[str, np.ndarray], idx, slots=slice(None)):
    """The reference's answers of pool scenes `idx` (and `slots`)."""
    return {k: v[idx][:, slots] for k, v in ref.items()}


def flat(answers: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """[N, P, ...] answers as [N * P, ...] slots."""
    return {k: v.reshape(v.shape[0] * v.shape[1], *v.shape[2:])
            for k, v in answers.items()}


def packed_rows(idx, rows: np.ndarray, ref) -> Dict[str, float]:
    """Packed rows [n, P, 23] (valid | 11 lengths | 11 visibility) of pool
    scenes `idx` against the reference, every slot of every row."""
    rows = rows.reshape(-1, rows.shape[-1])
    return compare(rows[:, 0] > 0.5, rows[:, 1:12], rows[:, 12:23] > 0.5,
                   flat(take(ref, idx)))


def rows_from_answer(answer: dict, segments: Sequence[str] = SEGMENT_NAMES):
    """A served answer (the file route's JSON) -> (valid, lengths [11],
    visible [11]) of its person."""
    lengths = answer.get("body_proportion_lengths_(cm)") or {}
    vis = np.array([isinstance(lengths.get(s), float) for s in segments])
    cm = np.array([lengths[s] if v else 0.0 for s, v in zip(segments, vis)],
                  np.float64)
    return bool(lengths), cm, vis


def served(answers: List[tuple], ref) -> Dict[str, float]:
    """(pool index, served answer) pairs against the reference's first
    slot, which the served answer reports."""
    parsed = [rows_from_answer(a) for _, a in answers]
    idx = np.array([i for i, _ in answers], np.int64)
    return compare([v for v, _, _ in parsed],
                   np.stack([c for _, c, _ in parsed]),
                   np.stack([s for _, _, s in parsed]), take(ref, idx, 0))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number within its limit
    and something compared."""
    checks = [(n, numbers[n], float(limits[n])) for n in NAMES]
    ok = numbers["compared"] > 0 and all(
        np.isfinite(v) and v <= lim for _, v, lim in checks)
    return bool(ok), checks
