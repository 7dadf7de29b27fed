"""Batched Canny edge extraction.

Port of the reference's ops/canny.py: gray -> Gaussian blur rounded back
to integers -> 3x3 Sobel (replicate borders) -> L2 gradient magnitude ->
non-maximum suppression along the quantised gradient direction ->
hysteresis (strong edges grown through weak pixels, 8-connected, to the
fixpoint). Every value before the hysteresis is an integer or the sqrt of
one, so the edge maps are bitwise to the reference's on every device.

Edge-cost contract: an inter-pixel edge is cut (0) if either endpoint is a
Canny edge pixel, else connect (1); padding slots are 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from image_compression_torch.ops.color import gaussian_blur, rgb_to_gray_u8

TAN22 = 0.4142135623730951
# fixpoint tests of the hysteresis run once per this many dilations (extra
# dilations at the fixpoint change nothing)
CHECK_EVERY = 8


def _planes(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """[..., H, W] -> ([N, 1, H, W], H, W) for the 2-D padding ops."""
    height, width = x.shape[-2:]
    return x.reshape(-1, 1, height, width), height, width


def _sobel(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gradients with replicate borders. gray [..., H, W] f32."""
    x, height, width = _planes(gray)
    x = F.pad(x, (1, 1, 1, 1), mode="replicate").reshape(
        *gray.shape[:-2], height + 2, width + 2)

    def s(dy, dx):
        return x[..., 1 + dy:1 + dy + height, 1 + dx:1 + dx + width]

    gx = (s(-1, 1) + 2 * s(0, 1) + s(1, 1)
          - s(-1, -1) - 2 * s(0, -1) - s(1, -1))
    gy = (s(1, -1) + 2 * s(1, 0) + s(1, 1)
          - s(-1, -1) - 2 * s(-1, 0) - s(-1, 1))
    return gx, gy


def _nms(mag: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor
         ) -> torch.Tensor:
    """Keep pixels that are maxima along their quantised gradient
    direction (>= the forward neighbour, > the backward one)."""
    height, width = mag.shape[-2:]
    m = F.pad(mag, (1, 1, 1, 1))

    def s(dy, dx):
        return m[..., 1 + dy:1 + dy + height, 1 + dx:1 + dx + width]

    ax, ay = gx.abs(), gy.abs()
    diag_sign = (gx * gy) >= 0
    horiz = ax * TAN22 >= ay
    vert = ay * TAN22 >= ax
    n1 = torch.where(horiz, s(0, 1), torch.where(
        vert, s(1, 0), torch.where(diag_sign, s(1, 1), s(1, -1))))
    n2 = torch.where(horiz, s(0, -1), torch.where(
        vert, s(-1, 0), torch.where(diag_sign, s(-1, -1), s(-1, 1))))
    return (mag >= n1) & (mag > n2)


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Grow strong edges through weak pixels (8-connected) to the fixpoint:
    the weak components that hold a strong pixel. Each image's fixpoint is
    its own, so the batch runs until every image has reached it."""
    w, height, width = _planes(weak.to(torch.float32))
    edges = strong.to(torch.float32).reshape(w.shape)
    while True:
        prev = edges
        for _ in range(CHECK_EVERY):
            edges = F.max_pool2d(edges, 3, stride=1, padding=1) * w
        if torch.equal(edges, prev):
            return edges.reshape(strong.shape) > 0


def canny_edges(images: torch.Tensor, low: float = 50.0, high: float = 150.0,
                aperture_size: int = 3, l2_gradient: bool = True,
                blur_ksize: int = 3, blur_sigma: float = 1.0
                ) -> torch.Tensor:
    """Batched Canny edge map: images [..., H, W, C] -> bool [..., H, W]."""
    del aperture_size  # 3x3 Sobel only (the reference default)
    gray = rgb_to_gray_u8(images).to(torch.float32)
    if blur_ksize >= 3 and blur_ksize % 2 == 1:
        gray = torch.round(gaussian_blur(gray, blur_ksize, blur_sigma))
    gx, gy = _sobel(gray)
    if l2_gradient:
        mag = torch.sqrt(gx * gx + gy * gy)
    else:
        mag = gx.abs() + gy.abs()
    keep = _nms(mag, gx, gy)
    return _hysteresis(keep & (mag > high), keep & (mag > low))


def canny_edge_costs(images: torch.Tensor, low: float = 50.0,
                     high: float = 150.0, aperture_size: int = 3,
                     l2_gradient: bool = True, blur_ksize: int = 3,
                     blur_sigma: float = 1.0) -> torch.Tensor:
    """Edge-cost planes [..., H, W, 2]: cut (0) if either endpoint is a
    Canny edge pixel, connect (1) otherwise; padding slots 0."""
    not_edge = ~canny_edges(images, low, high, aperture_size, l2_gradient,
                            blur_ksize, blur_sigma)
    h = (not_edge[..., :, :-1] & not_edge[..., :, 1:]).to(torch.float32)
    v = (not_edge[..., :-1, :] & not_edge[..., 1:, :]).to(torch.float32)
    return torch.stack([F.pad(h, (0, 1)), F.pad(v, (0, 0, 0, 1))], dim=-1)
