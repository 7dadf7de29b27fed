"""Colour conversions and the Gaussian blur of the classical extractors.

Port of the reference's ops/color.py. Every function is batched over
leading dimensions and runs on the tensor's device. The blur's kernel is
computed on the host in float64 and rounded to float32 (the correctly
rounded values, which are the reference's on its CPU), so that the card
and the CPU blur with the same weights; the blur itself multiplies and adds
in the reference's order, so its float32 results are bitwise on every
device.
"""

from __future__ import annotations

import numpy as np
import torch


def rgb_to_gray_u8(image: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] uint8 or float in [0, 1] -> [..., H, W] uint8 luma
    with the BT.601 weights (OpenCV's COLOR_BGR2GRAY)."""
    x = image
    if x.dtype != torch.uint8:
        x = torch.clamp(torch.round(x * 255.0), 0, 255)
    x = x.to(torch.float32)
    if x.ndim >= 3 and x.shape[-1] >= 3:
        gray = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    else:
        gray = x[..., 0] if x.ndim >= 3 else x
    return torch.clamp(torch.round(gray), 0, 255).to(torch.uint8)


def to_u8(image_float01: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> uint8, rounded."""
    return torch.clamp(torch.round(image_float01 * 255.0), 0,
                       255).to(torch.uint8)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """Normalised float32 Gaussian taps, summed left to right in float32."""
    half = ksize // 2
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8  # OpenCV's default rule
    xs = np.arange(-half, half + 1, dtype=np.float32) / np.float32(sigma)
    taps = np.exp(-0.5 * xs.astype(np.float64) ** 2).astype(np.float32)
    total = np.float32(0.0)
    for t in taps:
        total = np.float32(total + t)
    return (taps / total).astype(np.float32)


def _reflect101(n: int, half: int, device) -> torch.Tensor:
    """Source index of each of the n + 2*half padded positions under
    reflect-101 padding (numpy's "reflect", repeated for pads wider than
    the side)."""
    i = torch.arange(-half, n + half, device=device)
    if n == 1:
        return torch.zeros_like(i)
    j = torch.remainder(i, 2 * (n - 1))
    return torch.where(j >= n, 2 * (n - 1) - j, j)


def gaussian_blur(image: torch.Tensor, ksize: int = 3,
                  sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W] float32 with reflect-101
    borders (OpenCV's default): horizontal then vertical pass, each a sum of
    shifted planes in tap order."""
    if ksize < 3 or ksize % 2 == 0:
        return image
    half = ksize // 2
    taps = gaussian_kernel(ksize, sigma).tolist()
    height, width = image.shape[-2:]
    x = image[..., _reflect101(height, half, image.device), :][
        ..., _reflect101(width, half, image.device)]
    h = 0.0
    for i, t in enumerate(taps):
        h = h + t * x[..., :, i:i + width]
    v = 0.0
    for i, t in enumerate(taps):
        v = v + t * h[..., i:i + height, :]
    return v
