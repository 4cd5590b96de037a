"""EfficientNet-Lite backbone (port of the JAX package's
`models/efficientnet_lite.py`): ReLU6 everywhere, no squeeze-excite, fixed
stem/head; Lite0 = width 1.0 / depth 1.0, Lite4 = width 1.4 / depth 1.8.
Returns C3 (stride 8), C4 (stride 16) and C5 (stride 32).

BN epsilon is 1e-3 throughout the EfficientNet/EfficientDet family (the
checkpoints' moving statistics assume it); stride-2 convs use TF "SAME"
padding (asymmetric, see `layers.pad_same`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
from torch import nn

from human_body_proportion_estimation_tpu_torch.models.layers import (
    ConvBN,
    relu6,
)

# (expand_ratio, channels, repeats, stride, kernel) — EfficientNet-B0 stages
_BASE_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    f = filters * width_mult
    new_f = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * f:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


@dataclasses.dataclass(frozen=True)
class EfficientNetLiteConfig:
    width_mult: float = 1.0
    depth_mult: float = 1.0
    stem_channels: int = 32  # fixed in lite variants

    @property
    def stages(self) -> Tuple[Tuple[int, int, int, int, int], ...]:
        out = []
        for i, (e, c, r, s, k) in enumerate(_BASE_STAGES):
            ch = round_filters(c, self.width_mult)
            # lite keeps the first and last stage depths un-scaled
            reps = r if i in (0, len(_BASE_STAGES) - 1) else round_repeats(
                r, self.depth_mult
            )
            out.append((e, ch, reps, s, k))
        return tuple(out)


LITE0 = EfficientNetLiteConfig(1.0, 1.0)
LITE4 = EfficientNetLiteConfig(1.4, 1.8)


class MBConvLite(nn.Module):
    """Mobile inverted bottleneck, lite flavor: ReLU6, no SE."""

    def __init__(self, cin: int, expand_ratio: int, features: int,
                 stride: int, kernel: int):
        super().__init__()
        hid = cin * expand_ratio
        self.expand = (
            ConvBN(cin, hid, 1, act=relu6, bn_eps=1e-3)
            if expand_ratio != 1 else None
        )
        self.depthwise = ConvBN(hid, hid, kernel, stride, groups=hid,
                                act=relu6, bn_eps=1e-3)
        self.project = ConvBN(hid, features, 1, act=None, bn_eps=1e-3)
        self.residual = stride == 1 and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.expand is None else self.expand(x)
        h = self.project(self.depthwise(h))
        return h + x if self.residual else h


class EfficientNetLite(nn.Module):
    """Backbone trunk -> [C3, C4, C5] (NCHW, compute dtype)."""

    def __init__(self, config: EfficientNetLiteConfig = LITE4):
        super().__init__()
        self.config = config
        self.stem = ConvBN(3, config.stem_channels, 3, 2, act=relu6,
                           bn_eps=1e-3)
        cin = config.stem_channels
        self.out_channels: List[int] = []
        for si, (e, c, r, s, k) in enumerate(config.stages):
            for bi in range(r):
                self.add_module(f"stage{si}_block{bi}", MBConvLite(
                    cin, e, c, s if bi == 0 else 1, k))
                cin = c
            if si in (2, 4, 6):
                self.out_channels.append(c)
        self.eval()     # flax's train=False default (layers.batch_norm)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        features = []
        for si, (_, _, r, _, _) in enumerate(self.config.stages):
            for bi in range(r):
                x = getattr(self, f"stage{si}_block{bi}")(x)
            # C3 after stage 2, C4 after stage 4, C5 after stage 6
            if si in (2, 4, 6):
                features.append(x)
        return features
