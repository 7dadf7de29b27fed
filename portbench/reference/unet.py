"""The EdgeUNet's forward pass in plain PyTorch, from a state_dict.

The benchmark's reference model: the 3-level U-Net of the repo's
flagship (inc DoubleConv(3, c); down1..3 MaxPool(2) + DoubleConv;
up1..3 ConvTranspose(k=2, s=2) + skip concat + DoubleConv; outc 1x1 conv
to 4 channels; DoubleConv = 2 x [3x3 conv, GroupNorm(8 groups, eps 1e-6),
ReLU]). It reads the weights file's tensors by name and computes in
float32 with TF32 off (the caller sets the backend flags, see
`no_tf32`). `cast` is applied to every convolution's input and weight:
the identity for the reference, a rounding to a narrower format for the
control (`fp8`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

GROUPS = 8
EPS = 1e-6


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products and convolutions in float32 on the card."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Fp8(torch.autograd.Function):
    """Forward: round to float8 e4m3 under a per-tensor scale; backward:
    the gradient rounded to float8 e5m2 under its own scale."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = fmax / amax
    return ((x.float() * scale).clamp(-fmax, fmax).to(dtype).float()
            / scale).to(x.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: float8 e4m3 values (e5m2 gradients)."""
    return _Fp8.apply(x)


def _double_conv(p: dict, pre: str, x: torch.Tensor, cast) -> torch.Tensor:
    for i in (0, 1):
        x = F.conv2d(cast(x), cast(p[f"{pre}.conv{i}.weight"]),
                     p[f"{pre}.conv{i}.bias"], padding=1)
        x = F.relu(F.group_norm(x, GROUPS, p[f"{pre}.norm{i}.weight"],
                                p[f"{pre}.norm{i}.bias"], EPS))
    return x


def _up(p: dict, pre: str, x: torch.Tensor, skip: torch.Tensor,
        cast) -> torch.Tensor:
    x = F.conv_transpose2d(cast(x), cast(p[f"{pre}.up.weight"]),
                           p[f"{pre}.up.bias"], stride=2)
    dy = skip.shape[-2] - x.shape[-2]
    dx = skip.shape[-1] - x.shape[-1]
    if dy or dx:
        x = F.pad(x, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return _double_conv(p, f"{pre}.conv", torch.cat([skip, x], dim=1), cast)


def forward(p: dict, x_nhwc: torch.Tensor, cast=identity) -> torch.Tensor:
    """[B, H, W, 3] float in [0, 1] -> [B, H, W, 4] float32 raw edge
    parameters (channels 0/1: mu/sigma of horizontal edges, 2/3: of
    vertical ones)."""
    x = x_nhwc.permute(0, 3, 1, 2).float()
    x1 = _double_conv(p, "inc", x, cast)
    x2 = _double_conv(p, "down1.conv", F.max_pool2d(x1, 2, 2), cast)
    x3 = _double_conv(p, "down2.conv", F.max_pool2d(x2, 2, 2), cast)
    x4 = _double_conv(p, "down3.conv", F.max_pool2d(x3, 2, 2), cast)
    u = _up(p, "up1", x4, x3, cast)
    u = _up(p, "up2", u, x2, cast)
    u = _up(p, "up3", u, x1, cast)
    out = F.conv2d(cast(u), cast(p["outc.weight"]), p["outc.bias"])
    return out.permute(0, 2, 3, 1)
