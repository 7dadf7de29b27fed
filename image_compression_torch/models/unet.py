"""EdgeUNet: 3-level U-Net predicting per-pixel edge (mu, sigma) logits.

Port of the reference's models/unet.py: inc DoubleConv(3, c); down1..3
MaxPool(2) + DoubleConv (c -> 2c -> 4c -> 8c); up1..3 ConvTranspose(k=2,
s=2) + pad correction + skip concat + DoubleConv; outc 1x1 conv -> 4
channels. DoubleConv = 2 x [3x3 conv (pad 1) -> GroupNorm(8 groups,
eps 1e-6) in f32 -> ReLU]. Convolutions compute in `dtype` (bf16 by
default) with f32 parameters, like the reference's flax module.

Input [B, H, W, 3] float, output [B, H, W, 4] f32 raw edge parameters
(channels 0/1 = mu/sigma of horizontal edges, 2/3 of vertical ones); the
NHWC layout of the reference is kept at the interface. Submodule and
parameter names mirror the flax parameter tree (models/convert.py).

Under inference mode a bf16 U-Net on a card runs each norm, ReLU and cast
as one hand-written kernel (ops/group_norm_relu.py), which reads the
convolution's bf16 output and writes the next layer's bf16 input; with
autograd able to record (training, `no_grad`), in f32 and on the CPU the
chain runs as written, since the kernel has no backward. While traced,
"unet.norms" counts every norm and "unet.norms_fused" those the kernel ran.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from image_compression_torch.ops.group_norm_relu import (
    group_norm_relu, group_norm_relu_plain)
from image_compression_torch.utils.profiling import count, tracing

GROUPS = 8
EPS = 1e-6  # flax GroupNorm's epsilon (PyTorch's default is 1e-5)


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm0 = nn.GroupNorm(GROUPS, cout, eps=EPS)
        self.conv1 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1 = nn.GroupNorm(GROUPS, cout, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        for conv, norm in ((self.conv0, self.norm0), (self.conv1, self.norm1)):
            x = F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                         padding=1)
            # normalize in f32, then back to the compute dtype
            fused = _fused(x)
            if tracing():
                count("unet.norms")
                count("unet.norms_fused", int(fused and x.is_cuda))
            norm_relu = group_norm_relu if fused else group_norm_relu_plain
            x = norm_relu(x, norm.weight, norm.bias, GROUPS, EPS)
        return x


def _fused(x: torch.Tensor) -> bool:
    """Whether the norms go through group_norm_relu (the kernel on a card,
    the chain on the CPU): a bf16 activation under inference mode, where no
    autograd graph can be recorded."""
    return x.dtype == torch.bfloat16 and torch.is_inference_mode_enabled()


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.max_pool2d(x, 2, 2))


class Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 2, stride=2)
        self.conv = DoubleConv(cout + cout, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = F.conv_transpose2d(x, self.up.weight.to(dtype),
                               self.up.bias.to(dtype), stride=2)
        dy = skip.shape[-2] - x.shape[-2]
        dx = skip.shape[-1] - x.shape[-1]
        if dy or dx:  # odd skip sizes
            x = F.pad(x, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return self.conv(torch.cat([skip, x], dim=1))


class EdgeUNet(nn.Module):
    """[B, H, W, 3] float -> [B, H, W, 4] f32 raw edge parameters."""

    def __init__(self, base: int = 64, edge_channels: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = base
        self.dtype = dtype
        self.inc = DoubleConv(3, c)
        self.down1 = Down(c, 2 * c)
        self.down2 = Down(2 * c, 4 * c)
        self.down3 = Down(4 * c, 8 * c)
        self.up1 = Up(8 * c, 4 * c)
        self.up2 = Up(4 * c, 2 * c)
        self.up3 = Up(2 * c, c)
        self.outc = nn.Conv2d(c, edge_channels, 1)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        if x.is_cuda and _fused(x):
            # the kernel takes contiguous NCHW; the permuted input would make
            # the first convolution's output channels_last
            x = x.contiguous()
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        u = self.up1(x4, x3)
        u = self.up2(u, x2)
        u = self.up3(u, x1)
        out = F.conv2d(u, self.outc.weight.to(self.dtype),
                       self.outc.bias.to(self.dtype))
        return out.float().permute(0, 2, 3, 1)


def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights, the same on every device: conv and dense
    kernels ~ N(0, 1/fan_in) (flax's default lecun-normal scale), zero
    biases, unit GroupNorm scales. Drawn on the CPU from a torch.Generator,
    then copied."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            module = model.get_submodule(name.rsplit(".", 1)[0])
            if name.endswith("bias"):
                p.zero_()
            elif isinstance(module, nn.GroupNorm):
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()  # in x kh x kw, or in of a dense
                if isinstance(module, nn.ConvTranspose2d):
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=gen)
                        / fan_in ** 0.5)
    return model
