"""Shared building blocks (port of the JAX package's `models/layers.py`).

Conventions, matched to the flax modules so that converted weights compute
the same function:
  * Tensors are NCHW inside the models; parameters stay float32 and are
    cast to the activation dtype (bf16 on the main path) at each conv, as
    flax's `dtype=bfloat16, param_dtype=float32` does.
  * BatchNorm follows `nn.Module.training`: in eval mode it normalizes
    with the running statistics; in train mode (`model.train()`, flax's
    `train=True`) with the batch's, and it moves the running statistics
    the way flax does (`batch_norm`). The port's models are built in eval
    mode, as flax's `train` defaults to False. A bf16 input is normalized
    in f32 and rounded back, as flax promotes against its f32 statistics.
  * Module and attribute names equal the flax module names, so the
    converter in `models/weights.py` maps a flax tree path to a
    `state_dict` key one to one.

Padding trap: flax "SAME" is TF-style, which for stride 2 pads
asymmetrically (the extra row/column goes after). It is applied here as an
explicit `F.pad` before the op (`tf_same_pads`). The torch-family HRNet
uses symmetric (k-1)//2 padding instead (`same=False`, flax
`torch_pad=True`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Act = Optional[Callable[[torch.Tensor], torch.Tensor]]


def relu6(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x)


def tf_same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF "SAME" (before, after) padding of one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad NCHW `x` so a k x k / stride-s window op with no padding of its
    own reproduces TF "SAME" (asymmetric for stride 2)."""
    top, bottom = tf_same_pads(x.shape[-2], k, s)
    left, right = tf_same_pads(x.shape[-1], k, s)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-2 max pool with flax `padding="SAME"`: TF-style pads,
    filled with -inf (e.g. 15x20 -> 8x10 pads H 1/1 and W 0/1)."""
    return F.max_pool2d(pad_same(x, 3, 2, float("-inf")), 3, 2)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in the input's dtype, with TF "SAME" padding
    (`same=True`, flax default) or symmetric (k-1)//2 (`same=False`)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, same: bool = True):
        super().__init__(cin, cout, k, stride=stride, padding=0,
                         groups=groups, bias=bias)
        self.same = same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        if self.same and s > 1:
            x, pad = pad_same(x, k, s), 0
        else:
            pad = (k - 1) // 2   # also TF "SAME" at stride 1 (odd k)
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride, pad, 1, self.groups)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm of NCHW `x` in f32 math, output in x's dtype.

    Eval mode: the running statistics. Train mode (`bn.training`): flax's
    train-mode BatchNorm. The batch mean and the BIASED variance over N, H
    and W normalize `x` (gradients flow through both), and the running
    statistics move as ``ra = (1 - m) ra + m batch`` with the biased
    variance, m = `bn.momentum` in torch's convention: torch's default 0.1
    is flax's `momentum=0.9` of the JAX model zoo (models/layers.py:57-61,
    :289-290, efficientdet.py:209-211, higherhrnet.py:94-95), YOLOv5 sets
    0.03 (flax 0.97). `F.batch_norm(training=True)` would move
    `running_var` with the unbiased variance (n / (n - 1) larger), so it
    fills two scratch buffers at momentum 1 and the update is written
    here."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    mean = torch.zeros_like(bn.running_mean)
    var = torch.zeros_like(bn.running_var)
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, 1.0, bn.eps)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        # the scratch buffers are saved for backward: read, never write
        biased = var * ((n - 1) / n)
        keep = 1.0 - bn.momentum
        bn.running_mean.copy_(keep * bn.running_mean + bn.momentum * mean)
        bn.running_var.copy_(keep * bn.running_var + bn.momentum * biased)
    return y


class ConvBN(nn.Module):
    """Conv + BatchNorm + optional activation. `bn_eps` is 1e-5 for the
    torch-family HRNet and 1e-3 for the EfficientNet/EfficientDet family."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 groups: int = 1, act: Act = F.relu, bn_eps: float = 1e-5,
                 same: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, groups, False, same)
        self.bn = nn.BatchNorm2d(cout, eps=bn_eps)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = batch_norm(self.bn, self.conv(x))
        return x if self.act is None else self.act(x)


class BasicBlock(nn.Module):
    """ResNet basic block (two 3x3 convs), HRNet branches."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(cin, features, 3, stride, same=False)
        self.conv2 = ConvBN(features, features, 3, 1, act=None, same=False)
        self.downsample = (
            ConvBN(cin, features, 1, stride, act=None, same=False)
            if cin != features or stride != 1 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class Bottleneck(nn.Module):
    """ResNet bottleneck (1x1 -> 3x3 -> 1x1, expansion 4), HRNet layer1."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 expansion: int = 4):
        super().__init__()
        out = features * expansion
        self.conv1 = ConvBN(cin, features, 1, 1, same=False)
        self.conv2 = ConvBN(features, features, 3, stride, same=False)
        self.conv3 = ConvBN(features, out, 1, 1, act=None, same=False)
        self.downsample = (
            ConvBN(cin, out, 1, stride, act=None, same=False)
            if cin != out or stride != 1 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbor upsample of NCHW `x` by an integer factor."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class SeparableConvBN(nn.Module):
    """Depthwise 3x3 + pointwise 1x1 with BN (eps 1e-3) + optional act —
    the EfficientDet-Lite BiFPN node."""

    def __init__(self, cin: int, features: int, act: Act = None):
        super().__init__()
        self.depthwise = Conv2d(cin, cin, 3, groups=cin)
        self.pointwise = Conv2d(cin, features, 1, bias=True)
        self.bn = nn.BatchNorm2d(features, eps=1e-3)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = batch_norm(self.bn, self.pointwise(self.depthwise(x)))
        return x if self.act is None else self.act(x)


def _fan_in(module: nn.Module) -> int:
    """The inputs one output of `module`'s kernel sums over, as flax counts
    them on its HWIO kernel (kh * kw * in / groups; for a transposed conv
    kh * kw * in)."""
    w = module.weight
    if isinstance(module, nn.ConvTranspose2d):
        return w.shape[0] * w.shape[2] * w.shape[3]
    return w[0].numel()


def init_flax_default(model: nn.Module,
                      generator: torch.Generator) -> nn.Module:
    """Re-initialize `model` the way flax's `init` does, drawing from
    `generator` (a CPU generator; the model may live on any device):
    conv and transposed-conv kernels `lecun_normal` (a normal truncated at
    two standard deviations, rescaled to variance 1 / fan_in), biases 0,
    BatchNorm at unit scale, zero shift, mean 0 and variance 1. The JAX
    package trains from this init (`training/trainer.create_train_state`);
    `init_random`, torch's own, has a third of its variance."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                # truncated_normal's stddev correction, flax
                # initializers.variance_scaling
                std = (1.0 / _fan_in(module)) ** 0.5 / .87962566103423978
                w = torch.empty(module.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                module.weight.copy_(w)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
    return model


def init_random(model: nn.Module) -> nn.Module:
    """Re-initialize every parameter and statistic of `model` from an
    explicit `torch.Generator` seeded with 0, the way torch
    initializes fresh layers (conv and transposed-conv weights
    Kaiming-uniform with a = sqrt(5), biases uniform in +-fan_in^-1/2,
    BatchNorm at unit scale, zero shift, mean 0, variance 1): the random
    model a slot serves when it is given no weights, the same on every
    call and machine."""
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                w = torch.empty(module.weight.shape)
                nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=g)
                module.weight.copy_(w)
                if module.bias is not None:
                    bound = (w[0].numel()) ** -0.5
                    b = torch.empty(module.bias.shape).uniform_(
                        -bound, bound, generator=g)
                    module.bias.copy_(b)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
    return model
