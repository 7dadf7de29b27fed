"""ValueNet: a small conv net predicting the per-image RL reward.

Port of the reference's models/value.py, the learned state-value baseline
of the REINFORCE phase (cfg.rl.baseline = "value"): 4 stride-2 3x3 convs
(16-32-64-64, flax "SAME" padding, GroupNorm(8) in f32 + ReLU) -> global
mean pool -> dense -> scalar. Convolutions compute in `dtype` (bf16 by
default) with f32 parameters; submodule names mirror the flax tree
(models/convert.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from image_compression_torch.models.unet import EPS, GROUPS


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax/XLA "SAME" padding of NCHW x for kernel k, stride s: the total
    pad max((ceil(n / s) - 1) * s + k - n, 0), the odd pixel at the end."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ValueNet(nn.Module):
    """[B, H, W, 3] float in [0, 1] -> [B] predicted reward."""

    def __init__(self, features: tuple = (16, 32, 64, 64),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, feat in enumerate(features):
            setattr(self, f"conv{i}", nn.Conv2d(cin, feat, 3, stride=2))
            setattr(self, f"norm{i}", nn.GroupNorm(GROUPS, feat, eps=EPS))
            cin = feat
        self.n_layers = len(features)
        self.head = nn.Linear(cin, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(self.n_layers):
            conv = getattr(self, f"conv{i}")
            norm = getattr(self, f"norm{i}")
            x = F.conv2d(_same_pad(x, 3, 2), conv.weight.to(self.dtype),
                         conv.bias.to(self.dtype), stride=2)
            x = F.group_norm(x.float(), GROUPS, norm.weight, norm.bias, EPS)
            x = F.relu(x).to(self.dtype)
        # global average pool: f32 sum, result in the compute dtype
        x = x.float().mean(dim=(2, 3)).to(self.dtype).float()
        return F.linear(x, self.head.weight, self.head.bias)[..., 0]
