"""Batched grid-seeded watershed segmentation.

Port of the reference's ops/watershed.py: markers on a regular grid
(stride 16, at stride/2 offsets), then minimum-barrier flooding — every
pixel adopts the label of the 4-neighbour path from a seed that minimises
the path's largest colour difference — by relaxation sweeps (each a few
plane shifts and elementwise minima) to a fixpoint or `max_iters` sweeps.
Every barrier is an integer (differences of the blurred image rounded back
to integers), so labels are bitwise to the reference's on every device.

A batch runs its sweeps together. A sweep at an image's fixpoint changes
nothing, so each image gets the labels it gets alone: min(its own sweep
count, max_iters) sweeps.
"""

from __future__ import annotations

import torch

from image_compression_torch.ops.color import gaussian_blur, to_u8
from image_compression_torch.ops.edges import edges_from_labels, shift_plane

BIG = 1e9
# fixpoint tests run once per this many sweeps (max_iters is a multiple)
CHECK_EVERY = 8


def _grid_markers(height: int, width: int, stride: int,
                  device) -> torch.Tensor:
    """Seed labels 1..K on a regular grid at stride/2 offsets; 0 elsewhere
    (one seed in the centre if the grid holds none)."""
    ys = torch.arange(stride // 2, max(height, stride // 2), stride,
                      device=device)
    xs = torch.arange(stride // 2, max(width, stride // 2), stride,
                      device=device)
    markers = torch.zeros((height, width), dtype=torch.int32, device=device)
    k = ys.numel() * xs.numel()
    markers[ys[:, None], xs[None, :]] = torch.arange(
        1, k + 1, dtype=torch.int32, device=device).reshape(ys.numel(),
                                                            xs.numel())
    if k == 0:
        markers[height // 2, width // 2] = 1
    return markers


def _neighbor_diffs(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, 4]: largest channel |difference| to the
    right, left, down and up neighbour; BIG where there is none."""
    height, width = img.shape[1:3]
    chw = img.permute(0, 3, 1, 2)
    out = []
    for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):  # right, left, down, up
        nb = shift_plane(chw, dy, dx, 0.0)
        d = (chw - nb).abs().amax(dim=1)
        valid = torch.zeros((height, width), dtype=torch.bool,
                            device=img.device)
        valid[max(0, dy):height + min(0, dy),
              max(0, dx):width + min(0, dx)] = True
        out.append(torch.where(valid, d, BIG))
    return torch.stack(out, dim=-1)


def watershed_labels(images: torch.Tensor, seed_stride: int = 16,
                     blur_ksize: int = 3, blur_sigma: float = 1.0,
                     max_iters: int = 256) -> torch.Tensor:
    """Images [B, H, W, C] float [0, 1] or uint8 -> labels [B, H, W] int32
    >= 1."""
    img = images if images.dtype == torch.uint8 else to_u8(images)
    img = img.to(torch.float32)
    if blur_ksize >= 3 and blur_ksize % 2 == 1:
        img = torch.round(gaussian_blur(img.permute(0, 3, 1, 2), blur_ksize,
                                        blur_sigma)).permute(0, 2, 3, 1)
    b, height, width = img.shape[:3]
    markers = _grid_markers(height, width, seed_stride, img.device)
    diffs = _neighbor_diffs(img)
    labeled = markers > 0
    label = markers.expand(b, height, width).clone()
    barrier = torch.where(labeled, 0.0, BIG).expand(b, height, width).clone()
    # (label shift, barrier shift, crossing difference), in the order
    # right, left, down, up
    moves = [((0, -1), 0), ((0, 1), 1), ((-1, 0), 2), ((1, 0), 3)]
    for it in range(max_iters):
        best_l, best_b = label, barrier
        for (dy, dx), p in moves:
            nl = shift_plane(label, dy, dx, 0)
            cand = torch.maximum(shift_plane(barrier, dy, dx, BIG),
                                 diffs[..., p])
            take = (cand < best_b) & (nl > 0)
            best_b = torch.where(take, cand, best_b)
            best_l = torch.where(take, nl, best_l)
        best_l = torch.where(labeled, markers, best_l)
        best_b = torch.where(labeled, 0.0, best_b)
        if (it + 1) % CHECK_EVERY == 0 and torch.equal(best_l, label) \
                and torch.equal(best_b, barrier):
            break
        label, barrier = best_l, best_b
    return torch.clamp(label, min=1)


def watershed_edge_costs(images: torch.Tensor, seed_stride: int = 16,
                         blur_ksize: int = 3,
                         blur_sigma: float = 1.0) -> torch.Tensor:
    """Edge-cost planes [B, H, W, 2]: connect (1) iff both endpoints share
    a basin."""
    return edges_from_labels(watershed_labels(images, seed_stride,
                                              blur_ksize, blur_sigma))
