"""Associative-embedding grouping: the bottom-up multi-person pose decode
(port of the JAX package's `ops/ae_grouping.py`).

HigherHRNet's train-time head emits K heatmaps and K associative-embedding
tag maps ("output_1", `models/higherhrnet.py`). Per joint type the decode
takes the top-M heatmap peaks (3x3 max-pool NMS), then walks the joint
types in order, greedily matching candidates to the person groups already
open by |tag - group mean tag| under `tag_threshold`, and opens new groups
from the candidates left (Newell et al., NeurIPS'17, greedy variant).

Every function takes a batch [B, ...] where the JAX package `vmap`s one
image, and keeps its fixed shapes and masks, so the whole decode stays on
the device with no Python branch on the data. The JAX rules kept here,
each of which decides a result:

- top-M order: `jax.lax.top_k` puts the lower index first among equal
  values; `torch.sort(descending=True, stable=True)` does the same
  (`torch.topk` does not promise an order for ties, which bf16 maps and
  flat plateaus are full of);
- the 3x3 max-pool pads with -inf and propagates NaN, so a NaN pixel and
  its neighbours are never peaks;
- the greedy matching is `min(P, M)` masked flat argmins, the first index
  winning ties (`torch.argmin` returns the first minimal index);
- matched and new candidates enter their groups through one-hot products
  written as multiply-and-sum: exact (one term a sum is not zero), TF32
  never rounds them, and a 0 x NaN / 0 x inf term poisons the sum as in
  the JAX matrix product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

_INF = 1e9


class Peaks(NamedTuple):
    coords: torch.Tensor   # [B, K, M, 2] (x, y) int32 in heatmap space
    scores: torch.Tensor   # [B, K, M] f32, descending per joint


class Grouping(NamedTuple):
    keypoints: torch.Tensor  # [B, P, K, 2] f32 heatmap-space (x, y)
    scores: torch.Tensor     # [B, P, K] f32 (0 where a joint is missing)
    valid: torch.Tensor      # [B, P] bool (group has >= 1 joint)


def find_peaks(heatmaps: torch.Tensor, max_cands: int) -> Peaks:
    """Top-M local maxima per joint. `heatmaps`: [B, K, H, W] f32.

    A peak is a pixel equal to its 3x3 neighbourhood max (ties broken by
    the lower flat index), the standard bottom-up heatmap NMS."""
    b, k, h, w = heatmaps.shape
    pooled = F.max_pool2d(heatmaps, 3, stride=1, padding=1)
    flat = torch.where(heatmaps >= pooled, heatmaps,
                       -_INF).reshape(b, k, h * w)
    scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    scores, idx = scores[..., :max_cands], idx[..., :max_cands]
    coords = torch.stack([idx % w, torch.div(idx, w, rounding_mode="floor")],
                         dim=-1).to(torch.int32)
    return Peaks(coords=coords, scores=scores)


def gather_tags(tags: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Tag values at candidate coords. `tags`: [B, K, H, W], `coords`:
    [B, K, M, 2] (x, y) -> [B, K, M]."""
    w = tags.shape[-1]
    flat_idx = coords[..., 1].long() * w + coords[..., 0].long()
    return tags.flatten(2).gather(-1, flat_idx)


def _greedy_assign(cost: torch.Tensor, n_picks: int):
    """Iterated masked argmin over a [B, P, M] cost matrix.

    Returns (assign_p [B, M] int64, assigned [B, M] bool): candidate m ->
    group assign_p[m] where assigned[m]. Each group and candidate used at
    most once; only finite (< _INF/2) costs assign."""
    b, p, m = cost.shape
    rows = torch.arange(p, device=cost.device)
    cols = torch.arange(m, device=cost.device)
    assign_p = torch.zeros((b, m), dtype=torch.long, device=cost.device)
    assigned = torch.zeros((b, m), dtype=torch.bool, device=cost.device)
    for _ in range(n_picks):
        flat = cost.flatten(1)
        pick = flat.argmin(1)                              # [B]
        pi = torch.div(pick, m, rounding_mode="floor")
        ok = flat.gather(1, pick[:, None])[:, 0] < _INF / 2
        col = (cols[None, :] == (pick % m)[:, None]) & ok[:, None]  # [B, M]
        row = (rows[None, :] == pi[:, None]) & ok[:, None]          # [B, P]
        assign_p = torch.where(col, pi[:, None], assign_p)
        assigned = assigned | col
        cost = torch.where(row[:, :, None] | col[:, None, :], _INF, cost)
    return assign_p, assigned


def _scatter(onehot: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """`onehot` [B, P, M] times `values` [B, M] or [B, M, 2], summed over M
    (the JAX one-hot matrix product)."""
    if values.dim() == 2:
        return (onehot * values[:, None, :]).sum(-1)
    return (onehot[..., None] * values[:, None, :, :]).sum(-2)


def group_keypoints(
    peaks: Peaks,
    tag_values: torch.Tensor,      # [B, K, M]
    max_people: int,
    score_threshold: float = 0.1,
    tag_threshold: float = 1.0,
    person_score_threshold: float = 0.0,
) -> Grouping:
    """Greedy AE grouping over joint types (fixed shapes).

    `person_score_threshold`: groups whose mean joint score (over the
    joints actually assigned) is <= this are marked invalid, the
    person-level filter of standard HigherHRNet post-processing: a stray
    peak above `score_threshold` that matches no tag cluster opens a
    phantom group whose mean sits near `score_threshold`. 0.0 keeps the
    raw grouping."""
    b, k, m = tag_values.shape
    p = max_people
    dev = tag_values.device
    kp = torch.zeros((b, p, k, 2), dtype=torch.float32, device=dev)
    kp_scores = torch.zeros((b, p, k), dtype=torch.float32, device=dev)
    tag_sum = torch.zeros((b, p), dtype=torch.float32, device=dev)
    tag_cnt = torch.zeros((b, p), dtype=torch.float32, device=dev)
    slots = torch.arange(p, device=dev)

    for joint in range(k):  # K is a model constant
        xy = peaks.coords[:, joint].float()                 # [B, M, 2]
        s = peaks.scores[:, joint]                          # [B, M]
        t = tag_values[:, joint]                            # [B, M]
        cand_ok = s > score_threshold
        group_ok = tag_cnt > 0
        mean = tag_sum / tag_cnt.clamp_min(1.0)

        cost = (mean[:, :, None] - t[:, None, :]).abs()
        cost = torch.where(group_ok[:, :, None] & cand_ok[:, None, :]
                           & (cost <= tag_threshold), cost, _INF)
        assign_p, assigned = _greedy_assign(cost, min(p, m))

        # matched candidates join their group
        onehot = ((assign_p[:, None, :] == slots[None, :, None])
                  & assigned[:, None, :]).float()           # [B, P, M]
        kp[:, :, joint] += _scatter(onehot, xy)
        kp_scores[:, :, joint] += _scatter(onehot, s)
        tag_sum = tag_sum + _scatter(onehot, t)
        tag_cnt = tag_cnt + onehot.sum(-1)

        # unmatched valid candidates open new groups in free slots,
        # strongest candidate -> first free slot (peaks are in score order)
        new_c = cand_ok & ~assigned
        free = tag_cnt == 0
        new_rank = new_c.long().cumsum(-1) - 1              # [B, M]
        free_rank = free.long().cumsum(-1) - 1              # [B, P]
        match = (free[:, :, None] & new_c[:, None, :]
                 & (free_rank[:, :, None] == new_rank[:, None, :])).float()
        kp[:, :, joint] += _scatter(match, xy)
        kp_scores[:, :, joint] += _scatter(match, s)
        tag_sum = tag_sum + _scatter(match, t)
        tag_cnt = tag_cnt + match.sum(-1)

    mean_score = kp_scores.sum(-1) / tag_cnt.clamp_min(1.0)
    return Grouping(
        keypoints=kp,
        scores=kp_scores,
        valid=(tag_cnt > 0) & (mean_score > person_score_threshold),
    )


def decode_bottom_up(
    heatmaps: torch.Tensor,       # [B, K, H, W] f32 (aggregated)
    tags: torch.Tensor,           # [B, K, H, W] f32 (AE tag maps)
    max_people: int,
    max_cands: int = 8,
    score_threshold: float = 0.1,
    tag_threshold: float = 1.0,
    person_score_threshold: float = 0.0,
) -> Grouping:
    """heatmaps + tags -> grouped multi-person keypoints, a batch of
    images at once."""
    peaks = find_peaks(heatmaps, max_cands)
    tag_values = gather_tags(tags, peaks.coords)
    return group_keypoints(
        peaks, tag_values, max_people, score_threshold, tag_threshold,
        person_score_threshold,
    )
