"""Batched SLIC superpixels.

Port of the reference's ops/slic.py (region size 20, ruler 0, 10
iterations, as the reference's cv::ximgproc SLIC settings): each pixel
picks, among the centres of the 3x3 grid cells around its own cell, the
nearest in colour (plus (ruler/S)^2 times the squared spatial distance),
the first on a tie; centres are the means of their pixels; then
connectivity is enforced by speckle absorption, connected components and
whole-component absorption of fragments below 25% of the nominal area
(`_absorb_small_components_dense`, at most 768 slots, 4 rounds).

Centre sums are taken over cells in float64 and rounded to float32 once,
so they do not depend on the device or the batch (exact for 8-bit
images); the reference sums in float32 in XLA's order, so a centre can
differ from its in the last bit and a pixel without margin between two
centres can pick the other one. Every later step is integer-exact.
Everything runs batched over the leading image dimension.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from image_compression_torch.ops.edges import edges_from_labels, shift_plane
from image_compression_torch.ops.multicut import relabel_connected

OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _cells_shift(grid: torch.Tensor, dy: int, dx: int,
                 edge: bool) -> torch.Tensor:
    """[B, gh, gw, ...]: the value of cell (cy + dy, cx + dx), clamped to
    the grid (edge) or 0 outside."""
    gh, gw = grid.shape[1:3]
    if edge:
        cy = (torch.arange(gh, device=grid.device) + dy).clamp(0, gh - 1)
        cx = (torch.arange(gw, device=grid.device) + dx).clamp(0, gw - 1)
        return grid[:, cy][:, :, cx]
    moved = grid.movedim((1, 2), (-2, -1))
    return shift_plane(moved, -dy, -dx, 0.0).movedim((-2, -1), (1, 2))


def slic_labels(images_f01: torch.Tensor, region_size: int = 20,
                ruler: float = 0.0, iters: int = 10) -> torch.Tensor:
    """[B, H, W, C] float [0, 1] -> superpixel labels [B, H, W] int32."""
    b, height, width, chans = images_f01.shape
    dev = images_f01.device
    s = region_size
    gh, gw = -(-height // s), -(-width // s)
    hp, wp = gh * s, gw * s
    img = F.pad(images_f01.to(torch.float32).permute(0, 3, 1, 2),
                (0, wp - width, 0, hp - height), mode="replicate"
                ).permute(0, 2, 3, 1)
    ysf = torch.arange(hp, device=dev, dtype=torch.float32)[:, None].expand(
        hp, wp)
    xsf = torch.arange(wp, device=dev, dtype=torch.float32)[None, :].expand(
        hp, wp)
    spatial_w = (ruler / s) ** 2
    cyg = torch.arange(gh, device=dev)[:, None]
    cxg = torch.arange(gw, device=dev)[None, :]

    def up(grid):  # [B, gh, gw, ...] -> pixel resolution
        return grid.repeat_interleave(s, 1).repeat_interleave(s, 2)

    def cell_sum(vals):  # [B, hp, wp, ...] -> [B, gh, gw, ...]
        # summed in float64 and rounded once: for 8-bit images every term
        # is a multiple of 2^-31 below 1 (the sum needs 40 bits), so the
        # sum is exact and its float32 value does not depend on the order
        # of the terms, which the device and the batch size choose
        return vals.reshape(b, gh, s, gw, s, *vals.shape[3:]).to(
            torch.float64).sum(dim=(2, 4)).to(torch.float32)

    def assign(cc_grid, cy_grid, cx_grid):
        best_d = torch.full((b, hp, wp), float("inf"), device=dev)
        best_o = torch.zeros((b, hp, wp), dtype=torch.int64, device=dev)
        for o, (dy, dx) in enumerate(OFFSETS):
            cc = up(_cells_shift(cc_grid, dy, dx, True))
            cy = up(_cells_shift(cy_grid, dy, dx, True))
            cx = up(_cells_shift(cx_grid, dy, dx, True))
            ok = up(((cyg + dy >= 0) & (cyg + dy < gh) & (cxg + dx >= 0)
                     & (cxg + dx < gw))[None])
            diff = img - cc
            d = 0.0
            for c in range(chans):  # left to right, as the reference
                d = d + diff[..., c] * diff[..., c]
            d = d + spatial_w * ((ysf - cy) ** 2 + (xsf - cx) ** 2)
            d = torch.where(ok, d, float("inf"))
            take = d < best_d
            best_d = torch.where(take, d, best_d)
            best_o = torch.where(take, o, best_o)
        return best_o

    def centers(best_o, old):
        color_sum = torch.zeros((b, gh, gw, chans), device=dev)
        y_sum = torch.zeros((b, gh, gw), device=dev)
        x_sum = torch.zeros((b, gh, gw), device=dev)
        count = torch.zeros((b, gh, gw), device=dev)
        for o, (dy, dx) in enumerate(OFFSETS):
            m = (best_o == o).to(torch.float32)
            color_sum = color_sum + _cells_shift(
                cell_sum(img * m[..., None]), -dy, -dx, False)
            y_sum = y_sum + _cells_shift(cell_sum(ysf * m), -dy, -dx, False)
            x_sum = x_sum + _cells_shift(cell_sum(xsf * m), -dy, -dx, False)
            count = count + _cells_shift(cell_sum(m), -dy, -dx, False)
        denom = torch.clamp(count, min=1.0)
        occ = count > 0
        old_c, old_y, old_x = old
        return (torch.where(occ[..., None], color_sum / denom[..., None],
                            old_c),
                torch.where(occ, y_sum / denom, old_y),
                torch.where(occ, x_sum / denom, old_x))

    ones = torch.ones((b, hp, wp), device=dev)
    state = (cell_sum(img) / cell_sum(ones)[..., None],
             cell_sum(ysf.expand(b, hp, wp)) / cell_sum(ones),
             cell_sum(xsf.expand(b, hp, wp)) / cell_sum(ones))
    for _ in range(iters):
        state = centers(assign(*state), state)
    best_o = assign(*state)

    # offset choice -> label = the chosen cell's index
    cell_y = torch.arange(hp, device=dev)[:, None] // s
    cell_x = torch.arange(wp, device=dev)[None, :] // s
    labels = torch.zeros((b, hp, wp), dtype=torch.int32, device=dev)
    for o, (dy, dx) in enumerate(OFFSETS):
        lab_o = ((cell_y + dy) * gw + (cell_x + dx)).to(torch.int32)
        labels = torch.where(best_o == o, lab_o, labels)
    labels = labels[:, :height, :width]
    min_size = max(1, (s * s) * 25 // 100)  # cv enforceLabelConnectivity
    return _absorb_small_components_dense(labels, min_size)


def _despeckle(labels: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """A pixel with at most one same-label 8-neighbour adopts an adjacent
    label (right, down, left, up, rotating by sweep); iterating erodes the
    thin stray fragments of noisy images."""
    dirs8 = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
             if (dy, dx) != (0, 0)]
    adopt_from = [(0, 1), (1, 0), (0, -1), (-1, 0)]
    lab = labels
    for i in range(sweeps):
        same = torch.zeros_like(lab)
        for dy, dx in dirs8:
            same = same + (shift_plane(lab, -dy, -dx, -1) == lab).to(lab.dtype)
        speckle = same <= 1
        out = lab
        for k in range(4):
            dy, dx = adopt_from[(k + i) % 4]
            nb = shift_plane(lab, -dy, -dx, -1)
            out = torch.where(speckle & (out == lab) & (nb >= 0), nb, out)
        lab = out
    return lab


def _dense_ranks(labels: torch.Tensor, slots: int) -> torch.Tensor:
    """Per-pixel rank of its region in ascending label order for minlabel
    labels [B, H, W] (label = the smallest flat index of its region), or -1
    where the rank reaches `slots`: a cumulative count of the
    representatives (pixels whose label is their own index). The same
    ranks as segment_stats.dense_ranks gives minlabel labels, in O(H*W)
    memory where that one compares every pixel with every slot."""
    b, height, width = labels.shape
    flat = labels.reshape(b, -1).long()
    pix = torch.arange(height * width, device=labels.device)
    rep_count = torch.cumsum((flat == pix).to(torch.int64), dim=1)
    rank = torch.gather(rep_count, 1, flat) - 1
    return torch.where(rank < slots, rank, -1).reshape(
        b, height, width).to(torch.int32)


def _absorb_small_components_dense(labels: torch.Tensor, min_size: int,
                                   slots: int = 768,
                                   rounds: int = 4) -> torch.Tensor:
    """Connected components (after speckle absorption), ranked densely;
    then `rounds` rounds in which every component smaller than min_size
    joins its largest 4-adjacent component (the smallest rank on a tie)
    when that one is larger, or equal and of smaller rank; two pointer
    doublings compose chains. Components ranked past `slots` keep their
    labels. Labels: each slot's smallest pixel index."""
    b, height, width = labels.shape
    n = height * width
    dev = labels.device
    root = relabel_connected(_despeckle(labels))
    rank = _dense_ranks(root, slots)
    base = (torch.arange(b, device=dev) * slots)[:, None, None]
    sid = torch.arange(slots, device=dev)[None, :].expand(b, slots)
    nbrs = ((0, 1), (0, -1), (1, 0), (-1, 0))

    def per_slot(vals, live, init, how):
        """Reduce per-pixel vals over each (image, slot) -> [B, S]."""
        idx = (base + rank.clamp(min=0))[live]
        out = torch.full((b * slots,), init, dtype=vals.dtype, device=dev)
        return out.scatter_reduce(0, idx, vals[live], how).reshape(b, slots)

    def take(vec, idx):  # vec [B, S] at per-pixel idx; 0 where idx < 0
        got = torch.gather(vec, 1, idx.clamp(min=0).reshape(b, -1).long())
        return torch.where(idx >= 0, got.reshape(idx.shape), 0)

    for _ in range(rounds):
        live = rank >= 0
        size = per_slot(torch.ones_like(rank), live, 0, "sum")
        small = (size > 0) & (size < min_size)
        nb_best = torch.full((b, slots), -1, dtype=size.dtype, device=dev)
        for dy, dx in nbrs:
            p = shift_plane(rank, -dy, -dx, -1)
            psize = torch.where((p >= 0) & (p != rank), take(size, p), -1)
            nb_best = torch.maximum(nb_best,
                                    per_slot(psize, live, -1, "amax"))
        tgt = torch.full((b, slots), slots, dtype=rank.dtype, device=dev)
        nb_best_px = take(nb_best, rank)
        for dy, dx in nbrs:
            p = shift_plane(rank, -dy, -dx, -1)
            cand = torch.where((p >= 0) & (p != rank)
                               & (take(size, p) == nb_best_px), p, slots)
            tgt = torch.minimum(tgt, per_slot(cand.to(rank.dtype), live,
                                              slots, "amin"))
        has = small & (tgt < slots) & (nb_best >= 0)
        tgt_safe = torch.where(has, tgt.long(), sid)
        t_size = torch.gather(size, 1, tgt_safe)
        ok = has & ((t_size > size) | ((t_size == size) & (tgt_safe < sid)))
        nxt = torch.where(ok, tgt_safe, sid)
        for _ in range(2):  # compose short absorption chains
            nxt = torch.gather(nxt, 1, nxt)
        rank = torch.where(rank < 0, -1, take(nxt, rank)).to(torch.int32)

    live = rank >= 0
    pix = torch.arange(n, dtype=torch.int32, device=dev).reshape(
        1, height, width).expand(b, height, width)
    mins = per_slot(pix, live, n, "amin")
    return torch.where(rank < 0, root, take(mins, rank)).to(torch.int32)


def slic_edge_costs(images: torch.Tensor, region_size: int = 20,
                    ruler: float = 0.0, iters: int = 10) -> torch.Tensor:
    """Edge-cost planes [B, H, W, 2]: connect (1) iff same superpixel."""
    return edges_from_labels(slic_labels(images, region_size, ruler, iters))
