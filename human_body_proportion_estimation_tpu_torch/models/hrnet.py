"""HRNet top-down pose model, W32 / W48 (port of the JAX package's
`models/hrnet.py`).

  stem (2x stride-2 3x3)  -> 1/4 resolution
  layer1: 4 bottlenecks   -> 256 ch
  stage2: 2 branches [W, 2W],        1 module  x 4 basic blocks
  stage3: 3 branches [W, 2W, 4W],    4 modules x 4 basic blocks
  stage4: 4 branches [W..8W],        3 modules x 4 basic blocks
  head: 1x1 conv -> num_keypoints heatmaps on the 1/4-res branch (f32)

Module names follow the flax tree (`stem1`, `layer1_{k}`,
`transition{s}.adapt_{i}/new_{i}`, `stage{s}_module{m}.branch{b}_block{k}`,
`.fuse.up_{j}_{i}/down_{j}_{i}_{step}`, `head`). All convs use symmetric
padding, like the official pose_hrnet (flax `torch_pad=True`).

I/O: [N, 3, H, W] in [0, 1] -> [N, K, H/4, W/4] float32 heatmaps.

`model.train()` is flax's `train=True`: batch statistics in every
BatchNorm (`layers.batch_norm`), and the last module's full fusion.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from human_body_proportion_estimation_tpu_torch.models.layers import (
    BasicBlock,
    Bottleneck,
    ConvBN,
    Conv2d,
    upsample_nearest,
)


@dataclasses.dataclass(frozen=True)
class HRNetConfig:
    width: int = 32
    num_keypoints: int = 17
    stage_modules: Tuple[int, int, int] = (1, 4, 3)   # stages 2,3,4
    blocks_per_branch: int = 4
    stem_channels: int = 64
    bottleneck_channels: int = 64   # layer1, expansion 4 -> 256 out

    @property
    def branch_channels(self) -> Tuple[Tuple[int, ...], ...]:
        w = self.width
        return ((w, 2 * w), (w, 2 * w, 4 * w), (w, 2 * w, 4 * w, 8 * w))


HRNET_W32 = HRNetConfig(width=32)
HRNET_W48 = HRNetConfig(width=48)


class FuseLayer(nn.Module):
    """Full multi-resolution exchange: output branch i sums every input
    branch j, brought to its resolution (1x1 conv + nearest upsample from
    coarser, chained stride-2 3x3 convs from finer)."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.channels = tuple(channels)
        n = len(channels)
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"up_{j}_{i}", ConvBN(
                        channels[j], channels[i], 1, act=None, same=False))
                elif j < i:
                    for step in range(i - j):
                        last = step == i - j - 1
                        cout = channels[i] if last else channels[j]
                        self.add_module(f"down_{j}_{i}_{step}", ConvBN(
                            channels[j], cout, 3, 2,
                            act=None if last else F.relu, same=False))

    def forward(self, xs: List[torch.Tensor],
                n_out: int | None = None) -> List[torch.Tensor]:
        """`n_out`: compute only the first n_out output branches (the last
        module feeds only branch 0 to the head)."""
        n = len(self.channels)
        outs = []
        for i in range(n if n_out is None else n_out):
            acc = None
            for j in range(n):
                if j == i:
                    y = xs[j]
                elif j > i:
                    y = upsample_nearest(
                        getattr(self, f"up_{j}_{i}")(xs[j]), 2 ** (j - i))
                else:
                    y = xs[j]
                    for step in range(i - j):
                        y = getattr(self, f"down_{j}_{i}_{step}")(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRModule(nn.Module):
    """One HRNet module: per-branch basic blocks, then fusion."""

    def __init__(self, channels: Sequence[int], num_blocks: int):
        super().__init__()
        self.channels = tuple(channels)
        self.num_blocks = num_blocks
        for b, ch in enumerate(channels):
            for k in range(num_blocks):
                self.add_module(f"branch{b}_block{k}", BasicBlock(ch, ch))
        self.fuse = FuseLayer(channels)

    def forward(self, xs: List[torch.Tensor],
                n_out: int | None = None) -> List[torch.Tensor]:
        ys = []
        for b, x in enumerate(xs):
            for k in range(self.num_blocks):
                x = getattr(self, f"branch{b}_block{k}")(x)
            ys.append(x)
        return self.fuse(ys, n_out)


class Transition(nn.Module):
    """Grow the branch set between stages: a new branch (`new_{i}`) is a
    stride-2 conv of the coarsest input; an existing branch gets a 3x3 conv
    (`adapt_{i}`) only when its channel count changes."""

    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int]):
        super().__init__()
        self.n_in, self.n_out = len(in_channels), len(out_channels)
        for i, ch in enumerate(out_channels):
            if i >= len(in_channels):
                self.add_module(f"new_{i}", ConvBN(
                    in_channels[-1], ch, 3, 2, same=False))
            elif in_channels[i] != ch:
                self.add_module(f"adapt_{i}", ConvBN(
                    in_channels[i], ch, 3, 1, same=False))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i in range(self.n_out):
            if i >= self.n_in:
                outs.append(getattr(self, f"new_{i}")(xs[-1]))
            else:
                adapt = getattr(self, f"adapt_{i}", None)
                outs.append(xs[i] if adapt is None else adapt(xs[i]))
        return outs


class HRNetTrunk(nn.Module):
    """The stem, layer1 and stages 2-4 shared by `HRNet` and
    `models/higherhrnet.HigherHRNet` (the flax modules name these layers
    alike, so one converter covers both): [N, 3, H, W] in [0, 1] ->
    branch 0 features [N, W, H/4, W/4] in the compute dtype."""

    def __init__(self, config: HRNetConfig = HRNET_W32,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.stem1 = ConvBN(3, cfg.stem_channels, 3, 2, same=False)
        self.stem2 = ConvBN(cfg.stem_channels, cfg.stem_channels, 3, 2,
                            same=False)
        cin = cfg.stem_channels
        for k in range(4):
            self.add_module(f"layer1_{k}",
                            Bottleneck(cin, cfg.bottleneck_channels))
            cin = cfg.bottleneck_channels * 4
        prev: Sequence[int] = (cin,)
        for s, (n_modules, channels) in enumerate(
            zip(cfg.stage_modules, cfg.branch_channels)
        ):
            self.add_module(f"transition{s + 2}", Transition(prev, channels))
            for m in range(n_modules):
                self.add_module(f"stage{s + 2}_module{m}",
                                HRModule(channels, cfg.blocks_per_branch))
            prev = channels
        self.eval()     # flax's train=False default (layers.batch_norm)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.stem2(self.stem1(x.to(self.dtype)))
        for k in range(4):
            x = getattr(self, f"layer1_{k}")(x)
        xs = [x]
        n_stages = len(cfg.stage_modules)
        for s, n_modules in enumerate(cfg.stage_modules):
            xs = getattr(self, f"transition{s + 2}")(xs)
            for m in range(n_modules):
                # the last module feeds only branch 0 to the head; in
                # training the flax module still runs every fuse output,
                # whose BatchNorms move their running statistics
                last = s == n_stages - 1 and m == n_modules - 1
                xs = getattr(self, f"stage{s + 2}_module{m}")(
                    xs, 1 if last and not self.training else None)
        return xs[0]


class HRNet(HRNetTrunk):
    """Pose HRNet: [N, 3, H, W] in [0,1] -> [N, K, H/4, W/4] heatmaps."""

    def __init__(self, config: HRNetConfig = HRNET_W32,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(config, dtype)
        self.head = Conv2d(config.branch_channels[-1][0],
                           config.num_keypoints, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # f32 head for a stable argmax (flax computes it in f32 too); on
        # CUDA this needs cudnn TF32 off (pipeline/host.py sets it)
        return self.head(self.features(x).float())


def create_hrnet(name: str = "hrnet_w32", **kwargs) -> HRNet:
    cfg = {"hrnet_w32": HRNET_W32, "hrnet_w48": HRNET_W48}[name]
    return HRNet(config=cfg, **kwargs)
