"""Frozen copy of the port's `ops/graph_based_hier.py` (plain PyTorch, float32),
part of the benchmark's reference; it imports nothing of the program.

Hierarchical Felzenszwalb segmentation (the extractor analogue of
multicut_hier.py), at the configuration's settings only (graph_based.py). Regions are ranked
densely inside supertiles whose side doubles per level (8 -> 16 -> ...);
each round evaluates every slot's minimum outgoing edge and the
Felzenszwalb criterion
    join over edge w iff w <= min(Int(A) + k/|A|, Int(B) + k/|B|),
contracts the hooks (2-cycles broken toward the smaller slot, three pointer
doublings) and carries component size and Int as pixel maps, so level
transitions stay elementwise. Regions that overflow a level's slot cap
freeze. A final global stage (the whole image one tile, 512 slots) runs the
criterion across supertile boundaries with mutual matching, then the
min_size absorption rounds; labels are each slot's smallest pixel index.

The reference evaluates each round with dense [T, E, S] compares and
one-hot products; here the same minima, maxima and counts are scatter
reductions over the edge and pixel lists, which are independent of order,
so the decisions are the reference's wherever the edge weights are. Pixel
ids are int32 (the reference's f32 ids are exact up to 2^24 pixels).

A batch folds its images into the tile dimension. The adaptive levels stop
when no pixel's rank changes; a round at an image's fixpoint changes
neither its ranks nor its Int map, so running the batch until every image
has converged (or the level's round budget is spent) gives each image the
labels it gets alone.
"""

from __future__ import annotations

import torch

from portbench.reference.edges import shift_plane
from portbench.reference.graph_based import (BIG, PLANES, check_settings,
                                             edge_weight_planes, identity,
                                             smooth_image)
from portbench.reference.multicut_hier import (_from_tiles, _to_tiles,
                                               plan_levels)


def _tiles(img: torch.Tensor, s: int, tiles: bool) -> torch.Tensor:
    """[B, H, W] -> [B * T, s * s] tiles, or [B, H * W] for the global
    stage."""
    return _to_tiles(img, s) if tiles else img.reshape(img.shape[0], -1)


def _untiles(t: torch.Tensor, shape, s: int, tiles: bool) -> torch.Tensor:
    b, height, width = shape
    return (_from_tiles(t, b, height, width, s) if tiles
            else t.reshape(b, height, width))


def _level_edges(rank_img: torch.Tensor, w_planes: torch.Tensor, s: int,
                 tiles: bool):
    """Endpoint ranks a, b and weights w [T, E] of the 8-connected edges
    usable at tile side s; edges crossing an s-boundary get weight BIG."""
    height, width = rank_img.shape[-2:]
    ys = torch.arange(height, device=rank_img.device)[:, None]
    xs = torch.arange(width, device=rank_img.device)[None, :]
    a, b, w = [], [], []
    for p, (dy, dx) in enumerate(PLANES):
        wp = w_planes[..., p]
        if tiles:
            cross = torch.zeros((height, width), dtype=torch.bool,
                                device=rank_img.device)
            if dx > 0:
                cross = cross | (xs % s == s - 1)
            if dx < 0:
                cross = cross | (xs % s == 0)
            if dy > 0:
                cross = cross | (ys % s == s - 1)
            wp = torch.where(cross, BIG, wp)
        a.append(_tiles(rank_img, s, tiles))
        b.append(_tiles(shift_plane(rank_img, -dy, -dx, -1), s, tiles))
        w.append(_tiles(wp, s, tiles))
    return torch.cat(a, 1), torch.cat(b, 1), torch.cat(w, 1)


def _gather(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec[t, idx[t, i]] for idx in [0, S)."""
    return torch.gather(vec, 1, idx.long())


def _felz_round(rank_img, int_img, w_planes, s: int, slots: int, k: float,
                tiles: bool, absorb_min_size: int = 0, mutual: bool = False):
    """One criterion round (or, with absorb_min_size > 0, one min_size
    absorption round). Returns the updated (rank_img, int_img)."""
    shape = rank_img.shape
    dev = rank_img.device
    ranks_t = _tiles(rank_img, s, tiles)
    int_t = _tiles(int_img, s, tiles)
    n_t = ranks_t.shape[0]
    base = (torch.arange(n_t, device=dev) * slots)[:, None]
    live = ranks_t >= 0
    pix_slot = (base + ranks_t.clamp(min=0))[live]
    size = torch.bincount(pix_slot, minlength=n_t * slots).reshape(
        n_t, slots).to(torch.float32)
    int_slot = torch.full((n_t * slots,), -BIG, device=dev).scatter_reduce(
        0, pix_slot, int_t[live], "amax").reshape(n_t, slots).clamp(min=0.0)

    a, b, w_e = _level_edges(rank_img, w_planes, s, tiles)
    active = (a != b) & (a >= 0) & (b >= 0) & (w_e < BIG)
    t_idx = torch.arange(n_t, device=dev)[:, None].expand_as(a)[active]
    ea, eb, ew = a[active].long(), b[active].long(), w_e[active]
    ga, gb = t_idx * slots + ea, t_idx * slots + eb
    # per-slot minimum outgoing edge, over both endpoint roles
    best = torch.full((n_t * slots,), BIG, device=dev).scatter_reduce(
        0, torch.cat([ga, gb]), torch.cat([ew, ew]), "amin")
    # partner: the other endpoint of a best-achieving edge (smallest slot)
    on_a, on_b = ew == best[ga], ew == best[gb]
    part = torch.full((n_t * slots,), slots, dtype=torch.int64,
                      device=dev).scatter_reduce(
        0, torch.cat([ga[on_a], gb[on_b]]),
        torch.cat([eb[on_a], ea[on_b]]), "amin")
    best, part = best.reshape(n_t, slots), part.reshape(n_t, slots)
    has_best = (best < BIG) & (part < slots)
    part_safe = torch.where(has_best, part, 0)
    sid = torch.arange(slots, device=dev)[None, :].expand(n_t, slots)

    if absorb_min_size:
        # absorb small components along their cheapest boundary into
        # strictly larger partners, or mutually between equal partners
        p_size = _gather(size, part_safe)
        small = (size < float(absorb_min_size)) & has_best & (size > 0)
        pp = _gather(part_safe, part_safe)
        ok = small & ((p_size > size)
                      | ((p_size == size) & (part_safe < sid)))
        mutual_pair = small & (pp == sid) & _gather(small, part_safe)
        merge = ok | mutual_pair
        cand_int = int_slot  # Int no longer matters in the absorb phase
    else:
        tau = int_slot + k / torch.clamp(size, min=1.0)
        merge = has_best & (best <= tau) & (best <= _gather(tau, part_safe)) \
            & (size > 0)
        if mutual:
            pp = _gather(part_safe, part_safe)
            merge = merge & (pp == sid) & (sid > part_safe)
        cand_int = torch.maximum(int_slot, torch.where(merge, best, 0.0))

    nxt = torch.where(merge, part_safe, sid)
    two_cycle = (_gather(nxt, nxt) == sid) & (sid < nxt)
    nxt = torch.where(two_cycle, sid, nxt)
    for _ in range(3):
        nxt = _gather(nxt, nxt)

    # Int(root) = max over the slots merged into it of cand_int
    new_int = torch.full((n_t * slots,), -BIG, device=dev).scatter_reduce(
        0, (base + nxt).reshape(-1), cand_int.reshape(-1), "amax").reshape(
        n_t, slots).clamp(min=0.0)
    new_rank_t = torch.where(live, _gather(nxt, ranks_t.clamp(min=0)), -1)
    new_int_t = _gather(new_int, new_rank_t.clamp(min=0))
    new_rank = _untiles(new_rank_t, shape, s, tiles).to(torch.int32)
    new_int_img = _untiles(new_int_t, shape, s, tiles)
    return new_rank, torch.where(new_rank < 0, int_img, new_int_img)


def _compact(rank_img: torch.Tensor, s: int, slots: int, tiles: bool):
    """Re-rank live slots densely; returns (rank_img, live count [T])."""
    ranks_t = _tiles(rank_img, s, tiles)
    n_t = ranks_t.shape[0]
    live = ranks_t >= 0
    base = (torch.arange(n_t, device=ranks_t.device) * slots)[:, None]
    alive = torch.bincount((base + ranks_t.clamp(min=0))[live],
                           minlength=n_t * slots).reshape(n_t, slots) > 0
    new_rank = torch.cumsum(alive.to(torch.int32), dim=1) - 1
    g = torch.where(live, _gather(new_rank, ranks_t.clamp(min=0)), -1)
    return (_untiles(g, rank_img.shape, s, tiles).to(torch.int32),
            new_rank[:, -1] + 1)


def _run_rounds_adaptive(rank_img, int_img, max_rounds: int, round_fn):
    """Iterate round_fn until no pixel's rank changes, at most max_rounds
    times (each image of the batch stops at its own fixpoint, where a round
    changes nothing)."""
    for _ in range(max_rounds):
        nr, ni = round_fn(rank_img, int_img)
        changed = not torch.equal(nr, rank_img)
        rank_img, int_img = nr, ni
        if not changed:
            break
    return rank_img, int_img


def _child_offsets(ncand: torch.Tensor, b: int, height: int, width: int,
                   prev_s: int) -> torch.Tensor:
    """Per pixel: the live counts of the preceding children of its parent
    supertile (quad order 00, 01, 10, 11)."""
    th_p, tw_p = height // prev_s, width // prev_s
    counts = ncand.reshape(b, th_p, tw_p)
    c00 = counts[:, 0::2, 0::2]
    c01 = counts[:, 0::2, 1::2]
    c10 = counts[:, 1::2, 0::2]
    off = torch.stack([
        torch.stack([torch.zeros_like(c00), c00], -1),
        torch.stack([c00 + c01, c00 + c01 + c10], -1),
    ], -2)                                       # [B, th/2, tw/2, 2, 2]
    off_prev = off.permute(0, 1, 3, 2, 4).reshape(b, th_p, tw_p)
    return off_prev.repeat_interleave(prev_s, 1).repeat_interleave(prev_s, 2)


def felzenszwalb_labels_hier(images_f01: torch.Tensor, sigma: float = 1.0,
                             k: float = 100.0, min_size: int = 250,
                             global_slots: int = 512,
                             cast=identity) -> torch.Tensor:
    """[B, H, W, C] float [0, 1] -> labels [B, H, W] int32 (smallest pixel
    index per segment; frozen regions carry a level-tagged id >= H*W).
    Requires H, W divisible by 8 with >= 2 hierarchy levels
    (graph_based.py dispatches). `cast` is applied to the smoothed image
    (the control's bf16)."""
    check_settings(sigma, k, min_size)
    b, height, width = images_f01.shape[:3]
    n = height * width
    dev = images_f01.device
    w_planes = edge_weight_planes(cast(smooth_image(images_f01, sigma)))

    sides = plan_levels(height, width, 8)
    caps = []
    for i, s in enumerate(sides):
        caps.append(s * s if i == 0 else int(min(caps[-1] * 4, s * s,
                                                 128 + 64 * i)))
    # hooking at sub-plateau scales; mutual matching and more rounds at
    # plateau-scale levels (> 32 px)
    rounds = [(3, False), (2, False)] + [
        (2, False) if s <= 32 else (4, True) for s in sides[2:]]

    ys = torch.arange(height, device=dev)[:, None]
    xs = torch.arange(width, device=dev)[None, :]
    frozen = torch.zeros((b, height, width), dtype=torch.bool, device=dev)
    final_gid = torch.zeros((b, height, width), dtype=torch.int32,
                            device=dev)
    int_img = torch.zeros((b, height, width), dtype=torch.float32,
                          device=dev)
    rank_img = ncand = None
    for i, s in enumerate(sides):
        slots = int(caps[i])
        if i == 0:
            rank_img = ((ys % s) * s + (xs % s)).to(torch.int32).expand(
                b, height, width)
        else:
            # level transition: offset each child's ranks by the live
            # counts of the preceding children; freeze what overflows
            prev_s = sides[i - 1]
            cand_img = rank_img + _child_offsets(ncand, b, height, width,
                                                 prev_s)
            newly = ~frozen & (rank_img >= 0) & (cand_img >= slots)
            prev_tile = (ys // prev_s) * (width // prev_s) + xs // prev_s
            gid_prev = prev_tile * int(caps[i - 1]) + rank_img
            final_gid = torch.where(newly, i * n + gid_prev, final_gid)
            frozen = frozen | newly
            rank_img = torch.where(frozen, -1, cand_img).to(torch.int32)

        n_rounds, mut = rounds[i]

        def round_fn(r, ii, s=s, slots=slots, mut=mut):
            return _felz_round(r, ii, w_planes, s, slots, k, tiles=True,
                               mutual=mut)

        if s <= 16:  # fixed round counts at the small levels
            for _ in range(n_rounds):
                rank_img, int_img = round_fn(rank_img, int_img)
        else:
            rank_img, int_img = _run_rounds_adaptive(rank_img, int_img,
                                                     n_rounds, round_fn)
        rank_img, ncand = _compact(rank_img, s, slots, tiles=True)

    # ---- global stage: the whole image as one tile ----------------------
    s_top = sides[-1]
    th, tw = height // s_top, width // s_top
    counts = ncand.reshape(b, th * tw)
    off = torch.cumsum(counts, dim=1) - counts
    tile_idx = ((ys // s_top) * tw + xs // s_top).expand(b, height, width)
    off_img = torch.gather(off, 1, tile_idx.reshape(b, -1)).reshape(
        b, height, width)
    cand = rank_img + off_img
    newly = ~frozen & (rank_img >= 0) & (cand >= global_slots)
    gid_prev = tile_idx * int(caps[-1]) + rank_img
    final_gid = torch.where(newly, len(sides) * n + gid_prev, final_gid)
    frozen = frozen | newly
    rank_img = torch.where(frozen, -1, cand).to(torch.int32)

    if th * tw > 1:  # criterion rounds across supertile boundaries
        rank_img, int_img = _run_rounds_adaptive(
            rank_img, int_img, 6,
            lambda r, ii: _felz_round(r, ii, w_planes, s_top, global_slots,
                                      k, tiles=False, mutual=True))
    rank_img, int_img = _run_rounds_adaptive(  # min_size absorption
        rank_img, int_img, 8,
        lambda r, ii: _felz_round(r, ii, w_planes, s_top, global_slots, k,
                                  tiles=False, absorb_min_size=min_size))

    # ---- labels: smallest pixel index per global slot --------------------
    ranks = rank_img.reshape(b, -1)
    live = ranks >= 0
    base = (torch.arange(b, device=dev) * global_slots)[:, None]
    pix = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    mins = torch.full((b * global_slots,), n, dtype=torch.int32,
                      device=dev).scatter_reduce(
        0, (base + ranks.clamp(min=0))[live], pix[live], "amin")
    lab = _gather(mins.reshape(b, global_slots), ranks.clamp(min=0))
    return torch.where(frozen, final_gid, lab.reshape(b, height, width))
