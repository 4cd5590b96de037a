"""HigherHRNet pose model (port of the JAX package's
`models/higherhrnet.py`).

HRNet plus a higher-resolution deconv head (Cheng et al., CVPR'20): the
1/4-res branch emits K heatmaps + K associative-embedding tags
(`head1`), then a 4x4 stride-2 transposed conv over [features, head1]
followed by BatchNorm, ReLU and residual blocks emits the 1/2-res heatmaps
(`head2`), the tensor the reference reads as "output_2"
(`pose_est_hrnet_trtserver.py:22-28`).

The trunk is the port's HRNet trunk (`models/hrnet.HRNetTrunk`, the flax
names `stem1`, `layer1_{k}`, `transition{s}`, `stage{s}_module{m}`), and the
dtype borders are the flax module's: the trunk, the deconv, its
BatchNorm (eps 1e-5) and the blocks compute in `dtype` (bf16 on the
serving path), `head1` and `head2` are f32 convs of f32-cast features.

I/O: [N, 3, H, W] in [0, 1] -> {"output_1": [N, 2K, H/4, W/4],
"output_2": [N, K, H/2, W/2]}, both float32, NCHW.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from human_body_proportion_estimation_tpu_torch.models.hrnet import (
    HRNET_W32,
    HRNetConfig,
    HRNetTrunk,
)
from human_body_proportion_estimation_tpu_torch.models.layers import (
    BasicBlock,
    Conv2d,
    batch_norm,
)


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` computing in the input's dtype. k = 4, s = 2,
    p = 1 is flax `ConvTranspose((4, 4), strides=(2, 2), padding="SAME")`
    with the kernel flipped (`models/weights.flax_to_state_dict` flips
    it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None,
                                  self.stride, self.padding)


class HigherHRNet(HRNetTrunk):
    """[N, 3, H, W] in [0, 1] -> {"output_1", "output_2"}."""

    def __init__(self, config: HRNetConfig = HRNET_W32,
                 num_deconv_blocks: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(config, dtype)
        w, k = config.width, config.num_keypoints
        self.num_deconv_blocks = num_deconv_blocks
        self.head1 = Conv2d(w, 2 * k, 1, bias=True)
        self.deconv = ConvTranspose2d(w + 2 * k, w, 4, stride=2, padding=1,
                                      bias=False)
        self.deconv_bn = nn.BatchNorm2d(w, eps=1e-5)
        for i in range(num_deconv_blocks):
            self.add_module(f"deconv_block{i}", BasicBlock(w, w))
        self.head2 = Conv2d(w, k, 1, bias=True)
        self.eval()     # flax's train=False default (layers.batch_norm)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feat = self.features(x)                       # [N, W, H/4, W/4]
        out1 = self.head1(feat.float())
        d = torch.cat([feat, out1.to(self.dtype)], dim=1)
        d = F.relu(batch_norm(self.deconv_bn, self.deconv(d)))
        for i in range(self.num_deconv_blocks):
            d = getattr(self, f"deconv_block{i}")(d)
        return {"output_1": out1, "output_2": self.head2(d.float())}


class HigherHRNetHeatmaps(nn.Module):
    """HigherHRNet through the plain-heatmap contract of the top-down
    pipeline and the pose CLI: only the 1/2-res "output_2" heatmaps
    [N, K, H/2, W/2]. The submodule keeps the flax name `higher`."""

    def __init__(self, config: HRNetConfig = HRNET_W32,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.higher = HigherHRNet(config, dtype=dtype)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.higher(x)["output_2"]
