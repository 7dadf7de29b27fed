"""Grid multicut: the compress path's entry into the hierarchical solver.

Port of the parts of the reference's ops/multicut.py that compress runs
with its shipped settings (chain mode, no ICM sweeps) and the slot-space
aggregation: the hierarchical branch of `multicut_grid`, the pad-to-32
branch for sides that are not divisible by 16, the chain-mode sorted
rounds (`_contract_rounds`) that finish every image whose top supertile
does not cover it (non-square images, square sides that are not 8 * 2^k),
and `relabel_connected`. The batch is a dimension of every tensor
([B, H, W, 2] -> [B, H, W]), so `multicut_grid` is also the counterpart of
the reference's `multicut_grid_batched`. The tiny-grid ensemble (sides
under 16), the random-mate and mutual modes and the ICM sweeps belong to a
later slice and raise NotImplementedError here.

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


def multicut_grid(costs_bhw2: torch.Tensor, max_rounds: int = 3,
                  hier_rounds: tuple[int, ...] | None = None,
                  hier_caps: tuple[int, ...] | str | None = None,
                  hier_leaf: str = "auto") -> torch.Tensor:
    """Solve multicut on the 4-connected grid of each image of a batch.

    costs_bhw2: [B, H, W, 2] float edge costs (padding slots ignored).
    max_rounds: bound on the sorted rounds that finish an image whose top
      supertile does not cover it (at least one round runs).
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
        labels_p = multicut_grid(padded, max_rounds=max_rounds,
                                 hier_rounds=hier_rounds,
                                 hier_caps=hier_caps, hier_leaf=hier_leaf)
        # labels reference padded pixel indices: restore the minlabel
        # contract in original coordinates
        return relabel_connected(labels_p[:, :height, :width])

    sides = plan_levels(height, width, 8)
    caps = (lean_caps(sides, hier_caps) if isinstance(hier_caps, str)
            else hier_caps)
    res = hier_gaec(costs, rounds_per_level=hier_rounds, caps=caps,
                    leaf=hier_leaf)
    labels = smallest_pixel_labels(res)
    if res.top_tile == height and res.top_tile == width:
        return labels
    # the top supertile does not cover the image: finish with sorted rounds
    # over the remaining inter-supertile merges on plain pixel-index roots
    # (frozen regions rejoin contraction here; the rounds have no slot caps),
    # then restore the minlabel contract
    root = _contract_rounds(relabel_connected(labels), costs,
                            max_rounds=max(max_rounds, 1))
    return relabel_connected(root)


def _grid_endpoints_h(root: torch.Tensor):
    """Region ids of each edge's endpoints, [B, H * W * 2] each, slot order
    (y, x, plane) by shifts of the root image; the padding slots (last
    column of plane 0, last row of plane 1) get u == v and stay inactive."""
    right = torch.cat([root[:, :, 1:], root[:, :, -1:]], dim=2)
    down = torch.cat([root[:, 1:, :], root[:, -1:, :]], dim=1)
    b = root.shape[0]
    return (torch.stack([root, root], -1).reshape(b, -1),
            torch.stack([right, down], -1).reshape(b, -1))


def _contract_rounds(root: torch.Tensor, costs: torch.Tensor,
                     max_rounds: int) -> torch.Tensor:
    """Chain-mode sorted GAEC rounds over the grid's edges (the reference's
    `_contract_rounds` with mode="chain": one matching pass per round, with
    first_pass and last_pass). root [B, H, W] region ids (pixel indices of
    the image), costs [B, H, W, 2] -> root [B, H, W] int64.

    Per round: canonical pairs (min, max) of the active edges and their
    costs summed in a fixed order (sort, then one segmented sum per pair);
    each region's best is the maximum over its pairs in both directions,
    its partner the smallest id among the ties; it hooks there iff
    best > 0 (then a partner exists); 2-cycles break toward the smaller id;
    exactly two pointer doublings; root = m[root]. Rounds run while a root
    changed and fewer than max_rounds have run.

    The batch runs as one graph, image b's ids offset by b * H * W, and
    stops when no image changed (the reference's vmap stops per image). A
    round that changes nothing leaves an image at a fixed point, so the
    extra rounds it sees here leave it as it is: batched labels equal the
    per-image labels."""
    b, height, width = root.shape
    n = height * width
    total = b * n
    dev = root.device
    offset = (torch.arange(b, device=dev) * n).view(b, 1, 1)
    root = root.to(torch.int64) + offset
    w = costs.to(torch.float32).reshape(-1)
    ids = torch.arange(total, device=dev)
    for _ in range(max_rounds):
        # --- aggregate costs per adjacent region pair ---------------------
        ru, rv = (e.reshape(-1) for e in _grid_endpoints_h(root))
        active = ru != rv
        lo = torch.minimum(ru, rv)[active]
        hi = torch.maximum(ru, rv)[active]
        if lo.numel() == 0:  # every image is one region: nothing can merge
            break
        # a stable sort keeps each pair's edges in slot order and the
        # segmented sum adds them in that order without atomics, so the
        # totals repeat bit for bit on real-valued costs too
        key = lo * total + hi
        order = torch.argsort(key, stable=True)
        keys, counts = torch.unique_consecutive(key[order],
                                                return_counts=True)
        tot = torch.segment_reduce(w[active][order], "sum", lengths=counts)
        pa, pb = keys // total, keys % total

        # --- hook each region to its best attractive partner --------------
        src = torch.cat([pa, pb])
        dst = torch.cat([pb, pa])
        val = torch.cat([tot, tot])
        best = torch.full((total,), float("-inf"), device=dev).scatter_reduce(
            0, src, val, "amax")
        is_best = val == best[src]
        partner = torch.full((total,), total, dtype=torch.int64,
                             device=dev).scatter_reduce(
            0, src, torch.where(is_best, dst, total), "amin")
        nxt = torch.where(best > 0.0, partner, ids)
        two_cycle = (nxt[nxt] == ids) & (ids < nxt)
        nxt = torch.where(two_cycle, ids, nxt)
        for _ in range(2):  # the reference's two doublings (depth 4)
            nxt = nxt[nxt]
        new_root = nxt[root]
        changed = bool((new_root != root).any())
        root = new_root
        if not changed:
            break
    return root - offset


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
