"""Grid multicut: the compress path's entry into the hierarchical solver.

Port of the parts of the reference's ops/multicut.py that compress runs
with its shipped settings (chain mode, no ICM sweeps) and the slot-space
aggregation: the hierarchical branch of `multicut_grid` for images whose
top supertile is the whole image (square sides 8 * 2^k), the pad-to-32
branch for sides that are not divisible by 16, and `relabel_connected`.
The batch is a dimension of every tensor ([B, H, W, 2] -> [B, H, W]), so
`multicut_grid` is also the counterpart of the reference's
`multicut_grid_batched`. The sorted-round machinery (tiny grids,
non-square remainders) and the ICM sweeps belong to a later slice and
raise NotImplementedError here.

Edge-cost convention: positive = attraction ("connect"), negative =
repulsion ("cut"). Labels follow the minlabel contract: every region is
labelled by its smallest flat pixel index.
"""

from __future__ import annotations

import numpy as np
import torch

from image_compression_torch.ops.edges import edge_validity_masks
from image_compression_torch.ops.multicut_hier import (
    hier_gaec, lean_caps, plan_levels, smallest_pixel_labels)


def multicut_grid(costs_bhw2: torch.Tensor,
                  hier_rounds: tuple[int, ...] | None = None,
                  hier_caps: tuple[int, ...] | str | None = None,
                  hier_leaf: str = "auto") -> torch.Tensor:
    """Solve multicut on the 4-connected grid of each image of a batch.

    costs_bhw2: [B, H, W, 2] float edge costs (padding slots ignored).
    hier_rounds / hier_caps: rounds per level and slot caps of the
      hierarchy (hier_caps may be a `lean_caps` preset name); None uses
      the defaults of ops/multicut_hier.py.
    hier_leaf: "auto" | "fused" | "unfused" (ops/multicut_hier.hier_gaec).

    Returns labels [B, H, W] int32, each the smallest pixel index of its
    cluster."""
    b, height, width = costs_bhw2.shape[:3]
    costs = costs_bhw2.to(torch.float32)
    if min(height, width) < 16:
        raise NotImplementedError(
            "grids under 16 pixels a side use the sorted-round ensemble, "
            "which is not ported yet")
    if len(plan_levels(height, width, 8)) < 2:
        # pad to multiples of 32 with zero-cost edges: the original's
        # padding slots (last column/row) become real edges to padded
        # pixels, so zero them first; padding-to-padding edges get weight 1
        # so the padding collapses into one region per supertile
        ph, pw = -(-height // 32) * 32, -(-width // 32) * 32
        masked = costs * edge_validity_masks(height, width,
                                             device=costs.device)
        ys = torch.arange(ph, device=costs.device)[:, None]
        xs = torch.arange(pw, device=costs.device)[None, :]
        pad_pad = ((ys >= height) | (xs >= width)).to(torch.float32)
        padded = pad_pad[None, :, :, None] + torch.nn.functional.pad(
            masked, (0, 0, 0, pw - width, 0, ph - height))
        labels_p = multicut_grid(padded, hier_rounds=hier_rounds,
                                 hier_caps=hier_caps, hier_leaf=hier_leaf)
        # labels reference padded pixel indices: restore the minlabel
        # contract in original coordinates
        return relabel_connected(labels_p[:, :height, :width])

    sides = plan_levels(height, width, 8)
    caps = (lean_caps(sides, hier_caps) if isinstance(hier_caps, str)
            else hier_caps)
    res = hier_gaec(costs, rounds_per_level=hier_rounds, caps=caps,
                    leaf=hier_leaf)
    if res.top_tile != height or res.top_tile != width:
        raise NotImplementedError(
            f"{height}x{width}: the top supertile ({res.top_tile}) does not "
            "cover the image; the sorted finishing rounds are not ported yet")
    return smallest_pixel_labels(res)


def _seg_min_scan(root: torch.Tensor, reset: torch.Tensor, dim: int,
                  reverse: bool) -> torch.Tensor:
    """Segmented running minimum along `dim` (a segment starts where
    `reset` is set), by log-step doubling — the associative scan of the
    reference, exact because min is."""
    if reverse:
        root, reset = root.flip(dim), reset.flip(dim)
    n = root.shape[dim]
    val, flag = root, reset
    d = 1
    while d < n:
        prev_v = val.narrow(dim, 0, n - d)
        prev_f = flag.narrow(dim, 0, n - d)
        cur_v = val.narrow(dim, d, n - d)
        cur_f = flag.narrow(dim, d, n - d)
        new_v = torch.where(cur_f, cur_v, torch.minimum(prev_v, cur_v))
        val = torch.cat([val.narrow(dim, 0, d), new_v], dim)
        flag = torch.cat([flag.narrow(dim, 0, d), prev_f | cur_f], dim)
        d *= 2
    return val.flip(dim) if reverse else val


def relabel_connected(labels: torch.Tensor,
                      max_rounds: int = 64) -> torch.Tensor:
    """Split disconnected clusters into connected components and relabel
    every cluster by its smallest pixel index. labels [B, H, W] -> int32.

    Segmented min-scans sweep the root ids along rows and columns (label
    boundaries reset the scan), iterated to a fixpoint or `max_rounds`
    sweeps, as the reference does."""
    b, height, width = labels.shape
    same_row = torch.nn.functional.pad(labels[:, :, 1:] == labels[:, :, :-1],
                                       (1, 0))
    same_col = torch.nn.functional.pad(labels[:, 1:, :] == labels[:, :-1, :],
                                       (0, 0, 1, 0))
    end_row = torch.roll(same_row, -1, dims=2)
    end_row[:, :, -1] = False
    end_col = torch.roll(same_col, -1, dims=1)
    end_col[:, -1, :] = False
    root = (torch.arange(height * width, dtype=torch.int32,
                         device=labels.device)
            .reshape(1, height, width).expand(b, height, width))
    for _ in range(max_rounds):
        r = _seg_min_scan(root, ~same_row, 2, reverse=False)
        r = _seg_min_scan(r, ~end_row, 2, reverse=True)
        r = _seg_min_scan(r, ~same_col, 1, reverse=False)
        r = _seg_min_scan(r, ~end_col, 1, reverse=True)
        changed = bool((r != root).any())
        root = r
        if not changed:
            break
    return root.to(torch.int32)


def multicut_objective(costs_hw2: np.ndarray, labels_hw: np.ndarray) -> float:
    """Sum of the costs of joined edges (GAEC maximizes this); host helper
    for checks."""
    costs = np.asarray(costs_hw2)
    labels = np.asarray(labels_hw)
    same_h = labels[:, :-1] == labels[:, 1:]
    same_v = labels[:-1, :] == labels[1:, :]
    return float((costs[:, :-1, 0] * same_h).sum()
                 + (costs[:-1, :, 1] * same_v).sum())
