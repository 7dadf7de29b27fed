"""Frozen copy of the port's `ops/edges.py` (plain PyTorch), part of the
benchmark's reference; it imports nothing of the program.

Grid-edge representation: the tensor contract of the port.

Edge quantities of a 4-connected H x W grid are image planes `[..., H, W, 2]`:

  plane 0 ("horizontal"): edge between (y, x) and (y, x+1); the last column
      is padding (mask 0);
  plane 1 ("vertical"):   edge between (y, x) and (y+1, x); the last row is
      padding (mask 0).

Costs: positive / 1.0 = attraction ("connect"), negative / 0.0 = repulsion
("cut"). The flattened edge-list order is all horizontal edges row-major over
(y, x < W-1), then all vertical edges row-major over (y < H-1, x). Port of the
reference's ops/edges.py; results are bit-identical to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def edge_validity_masks(height: int, width: int, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Masks [H, W, 2]: 1 where a plane entry is a real edge (horizontal
    iff x+1 < W, vertical iff y+1 < H)."""
    mask_h = torch.ones((height, width), dtype=dtype, device=device)
    mask_h[:, width - 1] = 0
    mask_v = torch.ones((height, width), dtype=dtype, device=device)
    mask_v[height - 1, :] = 0
    return torch.stack([mask_h, mask_v], dim=-1)


def shift_plane(arr: torch.Tensor, dy: int, dx: int, fill=0) -> torch.Tensor:
    """The plane moved by (dy, dx): out[..., y, x] = arr[..., y - dy,
    x - dx], `fill` where that lies outside. shift_plane(a, -dy, -dx) reads
    each pixel's (y + dy, x + dx) neighbour."""
    height, width = arr.shape[-2:]
    out = torch.full_like(arr, fill)
    out[..., max(0, dy):height - max(0, -dy),
        max(0, dx):width - max(0, -dx)] = arr[
            ..., max(0, -dy):height - max(0, dy),
            max(0, -dx):width - max(0, dx)]
    return out


def flatten_edge_planes(planes: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 2] -> [..., E] in the reference's edge-list order."""
    h = planes[..., :, : planes.shape[-2] - 1, 0]
    v = planes[..., : planes.shape[-3] - 1, :, 1]
    batch = planes.shape[:-3]
    return torch.cat([h.reshape(*batch, -1), v.reshape(*batch, -1)], dim=-1)


def unflatten_edge_planes(flat: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """Inverse of flatten_edge_planes; padding entries are zero."""
    n_h = height * (width - 1)
    batch = flat.shape[:-1]
    h = flat[..., :n_h].reshape(*batch, height, width - 1)
    v = flat[..., n_h:].reshape(*batch, height - 1, width)
    return torch.stack([F.pad(h, (0, 1)), F.pad(v, (0, 0, 0, 1))], dim=-1)


def squash_mu(raw_mu: torch.Tensor, mu_scale: float = 2.0) -> torch.Tensor:
    """mu = mu_scale * tanh(0.5 * raw)."""
    return mu_scale * torch.tanh(0.5 * raw_mu)


def squash_sigma(raw_sigma: torch.Tensor, sigma_min: float = 0.1,
                 sigma_max: float = 0.9) -> torch.Tensor:
    """sigma = min + (max - min) * sigmoid(raw), sigmoid as 1 / (1 + e^-x)."""
    return sigma_min + (sigma_max - sigma_min) * (1.0 / (1.0 + torch.exp(
        -raw_sigma)))
