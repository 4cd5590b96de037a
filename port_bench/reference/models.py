"""The plain reference networks: EfficientDet-Lite (EfficientNet-Lite trunk,
BiFPN, shared class / box heads) and top-down HRNet, in plain PyTorch.

A frozen, inference-only transcription of the published architectures as
the measured program defines them (automl `efficientdet-lite*`: ReLU6, no
squeeze-excite, sum-fusion BiFPN, 9 anchors a cell, TF "SAME" padding,
BatchNorm eps 1e-3; HRNet, Sun et al. CVPR 2019: four stages of 1/4/3
modules, four basic blocks a branch, full fusion, symmetric padding,
BatchNorm eps 1e-5). Module names follow the flax trees of the certified
checkpoint, so `reference.weights` loads it key for key. Nothing here
imports the program; there are no kernels, no batching and no cache.

Every convolution computes in float32 (the caller keeps TF32 off) unless a
`Precision` is given: the convolutions of the trunks (all but the heads
that the configuration runs in float32) then round their input and weight
to that precision first and their output to bfloat16, which is how the
control of the correctness check computes in a precision below the one
the configuration states.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0     # largest finite float8_e4m3fn


def round_to(t: torch.Tensor, precision: str) -> torch.Tensor:
    """`t` (float32) rounded to `precision` and back: "bf16", or "fp8"
    (float8 e4m3 with one scale a tensor, its largest magnitude at 448)."""
    if precision == "bf16":
        return t.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = t.abs().amax().clamp_min(1e-12) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


def tf_same_pads(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x, k, s, value=0.0):
    top, bottom = tf_same_pads(x.shape[-2], k, s)
    left, right = tf_same_pads(x.shape[-1], k, s)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def max_pool_same(x):
    return F.max_pool2d(pad_same(x, 3, 2, float("-inf")), 3, 2)


class Conv2d(nn.Conv2d):
    """Convolution with TF "SAME" padding (`same`) or symmetric (k-1)//2.
    `head`: one of the convolutions the configuration runs in float32."""

    precision: Optional[str] = None

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=False,
                 same=True, head=False):
        super().__init__(cin, cout, k, stride=stride, padding=0,
                         groups=groups, bias=bias)
        self.same = same
        self.head = head

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        if self.same and s > 1:
            x, pad = pad_same(x, k, s), 0
        else:
            pad = (k - 1) // 2
        w = self.weight
        low = self.precision is not None and not self.head
        if low:
            x, w = round_to(x, self.precision), round_to(w, self.precision)
        y = F.conv2d(x, w, self.bias, self.stride, pad, 1, self.groups)
        return round_to(y, "bf16") if low else y


def set_precision(model: nn.Module, precision: Optional[str]) -> nn.Module:
    """Run the trunk convolutions of `model` in `precision` (None:
    float32)."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.precision = precision
    return model


def bn(module: nn.BatchNorm2d, x):
    return F.batch_norm(x, module.running_mean, module.running_var,
                        module.weight, module.bias, False, 0.0, module.eps)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, act=F.relu,
                 bn_eps=1e-5, same=True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, groups, False, same)
        self.bn = nn.BatchNorm2d(cout, eps=bn_eps)
        self.act = act

    def forward(self, x):
        x = bn(self.bn, self.conv(x))
        return x if self.act is None else self.act(x)


# --------------------------------------------------------------------- #
# EfficientNet-Lite + EfficientDet-Lite

# (expand_ratio, channels, repeats, stride, kernel): EfficientNet-B0
BASE_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
               (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
               (6, 320, 1, 1, 3))


def round_filters(filters, width_mult, divisor=8):
    f = filters * width_mult
    new_f = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * f:
        new_f += divisor
    return int(new_f)


def lite_stages(width_mult: float, depth_mult: float):
    """The seven stages of EfficientNet-Lite at these multipliers; the
    first and last keep their depth."""
    out = []
    for i, (e, c, r, s, k) in enumerate(BASE_STAGES):
        reps = r if i in (0, len(BASE_STAGES) - 1) else int(
            math.ceil(depth_mult * r))
        out.append((e, round_filters(c, width_mult), reps, s, k))
    return out


class MBConvLite(nn.Module):
    def __init__(self, cin, expand_ratio, features, stride, kernel):
        super().__init__()
        hid = cin * expand_ratio
        self.expand = (ConvBN(cin, hid, 1, act=F.relu6, bn_eps=1e-3)
                       if expand_ratio != 1 else None)
        self.depthwise = ConvBN(hid, hid, kernel, stride, groups=hid,
                                act=F.relu6, bn_eps=1e-3)
        self.project = ConvBN(hid, features, 1, act=None, bn_eps=1e-3)
        self.residual = stride == 1 and cin == features

    def forward(self, x):
        h = x if self.expand is None else self.expand(x)
        h = self.project(self.depthwise(h))
        return h + x if self.residual else h


class EfficientNetLite(nn.Module):
    def __init__(self, width_mult, depth_mult, stem_channels=32):
        super().__init__()
        self.stages = lite_stages(width_mult, depth_mult)
        self.stem = ConvBN(3, stem_channels, 3, 2, act=F.relu6, bn_eps=1e-3)
        cin = stem_channels
        self.out_channels = []
        for si, (e, c, r, s, k) in enumerate(self.stages):
            for bi in range(r):
                self.add_module(f"stage{si}_block{bi}", MBConvLite(
                    cin, e, c, s if bi == 0 else 1, k))
                cin = c
            if si in (2, 4, 6):
                self.out_channels.append(c)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for si, (_, _, r, _, _) in enumerate(self.stages):
            for bi in range(r):
                x = getattr(self, f"stage{si}_block{bi}")(x)
            if si in (2, 4, 6):
                feats.append(x)
        return feats


class SeparableConvBN(nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.depthwise = Conv2d(cin, cin, 3, groups=cin)
        self.pointwise = Conv2d(cin, features, 1, bias=True)
        self.bn = nn.BatchNorm2d(features, eps=1e-3)

    def forward(self, x):
        return bn(self.bn, self.pointwise(self.depthwise(x)))


class ResampleDown(nn.Module):
    def __init__(self, cin, features):
        super().__init__()
        self.adapt = (ConvBN(cin, features, 1, act=None, bn_eps=1e-3)
                      if cin != features else None)

    def forward(self, x):
        if self.adapt is not None:
            x = self.adapt(x)
        return max_pool_same(x)


class BiFPNLayer(nn.Module):
    def __init__(self, in_channels: Sequence[int], features: int):
        super().__init__()
        n = self.n = len(in_channels)
        for i in range(n - 2, -1, -1):
            if in_channels[i] != features:
                self.add_module(f"td_resample_{i}", ConvBN(
                    in_channels[i], features, 1, act=None, bn_eps=1e-3))
            self.add_module(f"td_{i}", SeparableConvBN(features, features))
        for i in range(1, n):
            if i < n - 1 and in_channels[i] != features:
                self.add_module(f"bu_resample_{i}", ConvBN(
                    in_channels[i], features, 1, act=None, bn_eps=1e-3))
            self.add_module(f"bu_{i}", SeparableConvBN(features, features))

    def _resample(self, x, name):
        conv = getattr(self, name, None)
        return x if conv is None else conv(x)

    def forward(self, feats):
        n = self.n
        td = [None] * n
        td[n - 1] = feats[n - 1]
        for i in range(n - 2, -1, -1):
            # jax.image.resize "nearest" samples as "nearest-exact"
            up = F.interpolate(td[i + 1], size=feats[i].shape[-2:],
                               mode="nearest-exact")
            lat = self._resample(feats[i], f"td_resample_{i}")
            td[i] = getattr(self, f"td_{i}")(F.relu6(lat + up))
        out = [None] * n
        out[0] = td[0]
        for i in range(1, n):
            s = td[i] + max_pool_same(out[i - 1])
            if i < n - 1:
                s = s + self._resample(feats[i], f"bu_resample_{i}")
            out[i] = getattr(self, f"bu_{i}")(F.relu6(s))
        return out


class HeadNet(nn.Module):
    """Separable-conv repeats shared over the levels (one BatchNorm a
    level), then a shared depthwise + 1x1 predict conv in float32."""

    def __init__(self, out_channels, repeats, features, num_levels):
        super().__init__()
        self.repeats = repeats
        for r in range(repeats):
            self.add_module(f"dw{r}", Conv2d(features, features, 3,
                                             groups=features))
            self.add_module(f"pw{r}", Conv2d(features, features, 1,
                                             bias=True))
            for li in range(num_levels):
                self.add_module(f"bn{r}_l{li}",
                                nn.BatchNorm2d(features, eps=1e-3))
        self.predict_dw = Conv2d(features, features, 3, groups=features)
        self.predict_pw = Conv2d(features, out_channels, 1, bias=True,
                                 head=True)

    def forward(self, x, li):
        for r in range(self.repeats):
            x = getattr(self, f"pw{r}")(getattr(self, f"dw{r}")(x))
            x = F.relu6(bn(getattr(self, f"bn{r}_l{li}"), x))
        return self.predict_pw(self.predict_dw(x))


class EfficientDet(nn.Module):
    """uint8 images [B, H, W, 3] -> (class logits [B, N, C], box
    regressions [B, N, 4]), level-major like the anchors."""

    def __init__(self, width_mult, depth_mult, fpn_channels, fpn_repeats,
                 head_repeats, num_classes=90, anchors_per_cell=9):
        super().__init__()
        self.num_classes = num_classes
        self.fpn_repeats = fpn_repeats
        self.backbone = EfficientNetLite(width_mult, depth_mult)
        c3, c4, c5 = self.backbone.out_channels
        fpn = fpn_channels
        self.p6_down = ResampleDown(c5, fpn)
        self.p7_down = ResampleDown(fpn, fpn)
        chans = [c3, c4, c5, fpn, fpn]
        for i in range(fpn_repeats):
            self.add_module(f"bifpn{i}", BiFPNLayer(chans, fpn))
            chans = [fpn] * 5
        na = anchors_per_cell
        self.class_net = HeadNet(na * num_classes, head_repeats, fpn, 5)
        self.box_net = HeadNet(na * 4, head_repeats, fpn, 5)

    def forward(self, images):
        b = images.shape[0]
        x = ((images.float() - 127.0) / 128.0).permute(0, 3, 1, 2)
        c3, c4, c5 = self.backbone(x)
        p6 = self.p6_down(c5)
        feats = [c3, c4, c5, p6, self.p7_down(p6)]
        for i in range(self.fpn_repeats):
            feats = getattr(self, f"bifpn{i}")(feats)
        classes, boxes = [], []
        for li, f in enumerate(feats):
            o = self.class_net(f, li)
            classes.append(o.permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes))
            o = self.box_net(f, li)
            boxes.append(o.permute(0, 2, 3, 1).reshape(b, -1, 4))
        return torch.cat(classes, 1), torch.cat(boxes, 1)


# --------------------------------------------------------------------- #
# HRNet


class BasicBlock(nn.Module):
    def __init__(self, cin, features, stride=1):
        super().__init__()
        self.conv1 = ConvBN(cin, features, 3, stride, same=False)
        self.conv2 = ConvBN(features, features, 3, 1, act=None, same=False)
        self.downsample = (ConvBN(cin, features, 1, stride, act=None,
                                  same=False)
                           if cin != features or stride != 1 else None)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + r)


class Bottleneck(nn.Module):
    def __init__(self, cin, features, stride=1, expansion=4):
        super().__init__()
        out = features * expansion
        self.conv1 = ConvBN(cin, features, 1, 1, same=False)
        self.conv2 = ConvBN(features, features, 3, stride, same=False)
        self.conv3 = ConvBN(features, out, 1, 1, act=None, same=False)
        self.downsample = (ConvBN(cin, out, 1, stride, act=None, same=False)
                           if cin != out or stride != 1 else None)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + r)


def hrnet_branches(width: int):
    """Branch widths of stages 2, 3 and 4."""
    w = width
    return ((w, 2 * w), (w, 2 * w, 4 * w), (w, 2 * w, 4 * w, 8 * w))


class FuseLayer(nn.Module):
    def __init__(self, channels):
        super().__init__()
        n = self.n = len(channels)
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"up_{j}_{i}", ConvBN(
                        channels[j], channels[i], 1, act=None, same=False))
                elif j < i:
                    for step in range(i - j):
                        last = step == i - j - 1
                        self.add_module(f"down_{j}_{i}_{step}", ConvBN(
                            channels[j], channels[i] if last else channels[j],
                            3, 2, act=None if last else F.relu, same=False))

    def forward(self, xs, n_out=None):
        outs = []
        for i in range(self.n if n_out is None else n_out):
            acc = None
            for j in range(self.n):
                if j == i:
                    y = xs[j]
                elif j > i:
                    y = F.interpolate(getattr(self, f"up_{j}_{i}")(xs[j]),
                                      scale_factor=2 ** (j - i),
                                      mode="nearest")
                else:
                    y = xs[j]
                    for step in range(i - j):
                        y = getattr(self, f"down_{j}_{i}_{step}")(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRModule(nn.Module):
    def __init__(self, channels, num_blocks):
        super().__init__()
        self.num_blocks = num_blocks
        for b, ch in enumerate(channels):
            for k in range(num_blocks):
                self.add_module(f"branch{b}_block{k}", BasicBlock(ch, ch))
        self.fuse = FuseLayer(channels)

    def forward(self, xs, n_out=None):
        ys = []
        for b, x in enumerate(xs):
            for k in range(self.num_blocks):
                x = getattr(self, f"branch{b}_block{k}")(x)
            ys.append(x)
        return self.fuse(ys, n_out)


class Transition(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.n_in, self.n_out = len(in_channels), len(out_channels)
        for i, ch in enumerate(out_channels):
            if i >= len(in_channels):
                self.add_module(f"new_{i}", ConvBN(in_channels[-1], ch, 3, 2,
                                                   same=False))
            elif in_channels[i] != ch:
                self.add_module(f"adapt_{i}", ConvBN(in_channels[i], ch, 3,
                                                     1, same=False))

    def forward(self, xs):
        outs = []
        for i in range(self.n_out):
            if i >= self.n_in:
                outs.append(getattr(self, f"new_{i}")(xs[-1]))
            else:
                adapt = getattr(self, f"adapt_{i}", None)
                outs.append(xs[i] if adapt is None else adapt(xs[i]))
        return outs


class HRNet(nn.Module):
    """Crops [N, 3, H, W] in [0, 1] -> heatmaps [N, K, H/4, W/4], the 1x1
    head in float32."""

    def __init__(self, width, num_keypoints=17, stage_modules=(1, 4, 3),
                 blocks=4, stem_channels=64, bottleneck_channels=64):
        super().__init__()
        self.stage_modules = stage_modules
        self.stem1 = ConvBN(3, stem_channels, 3, 2, same=False)
        self.stem2 = ConvBN(stem_channels, stem_channels, 3, 2, same=False)
        cin = stem_channels
        for k in range(4):
            self.add_module(f"layer1_{k}",
                            Bottleneck(cin, bottleneck_channels))
            cin = bottleneck_channels * 4
        prev: Sequence[int] = (cin,)
        for s, (n_mod, chans) in enumerate(zip(stage_modules,
                                               hrnet_branches(width))):
            self.add_module(f"transition{s + 2}", Transition(prev, chans))
            for m in range(n_mod):
                self.add_module(f"stage{s + 2}_module{m}",
                                HRModule(chans, blocks))
            prev = chans
        self.head = Conv2d(width, num_keypoints, 1, bias=True, head=True)

    def forward(self, x):
        x = self.stem2(self.stem1(x))
        for k in range(4):
            x = getattr(self, f"layer1_{k}")(x)
        xs: List[torch.Tensor] = [x]
        n_stages = len(self.stage_modules)
        for s, n_mod in enumerate(self.stage_modules):
            xs = getattr(self, f"transition{s + 2}")(xs)
            for m in range(n_mod):
                last = s == n_stages - 1 and m == n_mod - 1
                xs = getattr(self, f"stage{s + 2}_module{m}")(
                    xs, 1 if last else None)
        return self.head(xs[0].float())
