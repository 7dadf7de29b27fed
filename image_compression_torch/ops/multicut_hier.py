"""Hierarchical dense GAEC with slot-space ("matrix") pair aggregation.

Port of the matrix path of the reference's ops/multicut_hier.py. The image
is covered by supertiles whose side doubles per level (8 -> 16 -> ... ->
min(H, W)); inside a supertile, regions are rank-compacted to a static slot
count S and the aggregated pair-cost matrix [S, S] is the state:

  * a merge round hooks every slot to its most attractive partner (first
    index of the row maximum, chain mode), breaks 2-cycles, contracts
    chains by three pointer doublings and aggregates P <- M^T P M;
  * a level transition offsets the four child ranks, freezes regions that
    overflow the next level's slot cap (labelled by their smallest pixel
    index, carried per slot as the min-pixel vector m), embeds the four
    child matrices and adds the newly active mid-line edges;
  * pixels carry their region's rank; one slot-map apply per level.

Levels 0-1 run in the multicut leaf (ops/multicut_leaf.py: a CUDA kernel on
the GPU, its plain version on the CPU) when the configuration allows it.

Every tensor carries the batch: images are [B, H, W], tile tensors fold the
batch into their leading dimension ([B * tiles, ...], image-major then tiles
row-major). Arithmetic mirrors the reference: edge weights are rounded to
bf16 (round to nearest even) before they are summed in f32, the argmax takes
the first index, and min-pixel ids are f32 (exact below 2^24, so H * W must
stay below 2^24). On integer-valued costs every state field is bit-identical
to the reference; on real-valued costs f32 sums may be grouped differently.
The f32 matrix products assume PyTorch's default full-precision float32
matmul (`torch.backends.cuda.matmul.allow_tf32` False).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

# levels 0-1 fit the leaf when its level-1 slot matrix fits the kernel's
# shared memory (the reference's envelope is caps[1] <= 256; every cap preset
# gives caps[1] <= 128)
LEAF_MAX_S1 = 128


class HierResult(NamedTuple):
    rank_img: torch.Tensor   # [B, H, W] int32 rank in its top tile; -1 frozen
    n_regions: torch.Tensor  # [B, T_top] int32 live regions per top tile
    frozen: torch.Tensor     # [B, H, W] bool: pixel belongs to a frozen region
    final_gid: torch.Tensor  # [B, H, W] int32 where frozen: the region's
    #                          smallest pixel index (minlabel contract)
    overflow: torch.Tensor   # [B] int32 regions frozen per image
    top_tile: int            # side of the top-level supertile
    top_slots: int           # slot cap at the top level
    minpix: torch.Tensor     # [B, T_top, S] f32 min pixel id per slot
    pair: torch.Tensor       # [B, T_top, S, S] f32 aggregated pair costs


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 value (ties to even), kept as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _to_tiles(img: torch.Tensor, s: int) -> torch.Tensor:
    """[B, H, W] -> [B * T, s * s], tiles row-major within each image."""
    b, height, width = img.shape
    return (img.reshape(b, height // s, s, width // s, s)
            .permute(0, 1, 3, 2, 4).reshape(-1, s * s))


def _from_tiles(tiles: torch.Tensor, b: int, height: int, width: int,
                s: int) -> torch.Tensor:
    """[B * T, s * s] -> [B, H, W]."""
    return (tiles.reshape(b, height // s, width // s, s, s)
            .permute(0, 1, 3, 2, 4).reshape(b, height, width))


def _take(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec[t, idx[t, i]]; an index outside [0, S) reads 0, as the
    reference's one-hot lookups do."""
    slots = vec.shape[-1]
    ok = (idx >= 0) & (idx < slots)
    got = torch.gather(vec, -1, idx.clamp(0, slots - 1).long())
    return torch.where(ok, got, torch.zeros_like(got))


def _one_hot(idx: torch.Tensor, slots: int) -> torch.Tensor:
    """f32 one-hot over the last dim; indices outside [0, slots) give a zero
    row."""
    cols = torch.arange(slots, device=idx.device)
    return (idx.unsqueeze(-1) == cols).to(torch.float32)


def _remap(sym: torch.Tensor, m: torch.Tensor, tgt: torch.Tensor,
           sentinel: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Aggregate the pair matrix and min-pixel vector through the slot map
    tgt [T, S] (-1 drops a slot): sym'[A, B] = sum over a -> A, b -> B of
    sym[a, b]; m'[A] = min over a -> A of m[a], the sentinel if none."""
    slots = m.shape[-1]
    mm = _one_hot(tgt, slots)                       # [T, S, S]
    sym = torch.bmm(mm.transpose(1, 2), torch.bmm(sym, mm))
    keep = tgt >= 0
    m_new = torch.full_like(m, sentinel).scatter_reduce(
        1, tgt.clamp(min=0), torch.where(keep, m, sentinel), "amin")
    return sym, m_new


def _matrix_rounds(sym: torch.Tensor, m: torch.Tensor, rounds: int,
                   sentinel: float):
    """Chain-mode GAEC rounds in slot space, then dense re-ranking.

    sym [T, S, S] f32, m [T, S] f32. Returns (sym, m, cmap, n_alive): cmap
    [T, S] int64 maps entry ranks to final dense ranks (entries of slots
    that were dead on entry are unused), n_alive [T] int64."""
    t_count, slots = m.shape
    ids = torch.arange(slots, device=m.device).expand(t_count, slots)
    off_diag = 1.0 - torch.eye(slots, device=m.device)
    cmap = ids
    for _ in range(rounds):
        best = sym.amax(dim=-1)
        partner = torch.where(sym == best.unsqueeze(-1), ids.unsqueeze(1),
                              slots).amin(dim=-1)   # first index of the max
        nxt = torch.where(best > 0.0, partner, ids)
        nn = _take(nxt, nxt)
        nxt = torch.where((nn == ids) & (ids < nxt), ids, nxt)
        for _ in range(3):  # chain-mode pointer doublings
            nxt = _take(nxt, nxt)
        sym, m = _remap(sym, m, nxt, sentinel)
        sym = sym * off_diag
        cmap = _take(nxt, cmap)

    alive = m < sentinel
    new_rank = torch.cumsum(alive.long(), dim=1) - 1
    n_alive = alive.sum(dim=1)
    sym, m = _remap(sym, m, torch.where(alive, new_rank, -1), sentinel)
    cmap = _take(new_rank, cmap)
    return sym, m, cmap, n_alive


def _embed_children(p4: torch.Tensor, m4: torch.Tensor, off4: torch.Tensor,
                    slots: int, sentinel: float):
    """Embed four child pair matrices p4 [T, 4, Sp, Sp] and min-pixel
    vectors m4 [T, 4, Sp] at rank offsets off4 [T, 4] into [T, S, S] / [T, S];
    candidates >= S (frozen) drop out."""
    t_count, _, prev, _ = p4.shape
    cand = torch.arange(prev, device=p4.device) + off4.unsqueeze(-1)
    emb = _one_hot(cand, slots)                            # [T, 4, Sp, S]
    x = torch.matmul(p4, emb)                              # [T, 4, Sp, S]
    emb_f = emb.reshape(t_count, 4 * prev, slots)
    sym = torch.bmm(emb_f.transpose(1, 2), x.reshape(t_count, 4 * prev,
                                                     slots))
    keep = (cand < slots).reshape(t_count, -1)
    m = torch.full((t_count, slots), sentinel, device=p4.device)
    m = m.scatter_reduce(1, cand.reshape(t_count, -1).clamp(max=slots - 1),
                         torch.where(keep, m4.reshape(t_count, -1), sentinel),
                         "amin")
    return sym, m


def _edge_pairs(a_e: torch.Tensor, b_e: torch.Tensor, w_e: torch.Tensor,
                slots: int) -> torch.Tensor:
    """Pair matrix [T, S, S] of an edge list: sum of the bf16-rounded weights
    w_e [T, E] of the edges whose endpoint ranks are (a_e, b_e); endpoints
    outside [0, S) (frozen, -1) contribute nothing."""
    oh_aw = _one_hot(a_e, slots) * bf16_round(w_e).unsqueeze(-1)
    return torch.bmm(oh_aw.transpose(1, 2), _one_hot(b_e, slots))


def _level_weights(costs: torch.Tensor, s: int) -> torch.Tensor:
    """Edge weights [B * T, 2 * s * s] of one level: all grid edges, zeroed
    where the edge crosses a supertile boundary or is a padding slot;
    horizontal plane then vertical."""
    _, height, width, _ = costs.shape
    xs = torch.arange(width, device=costs.device)
    ys = torch.arange(height, device=costs.device)
    wh = torch.where(((xs % s != s - 1) & (xs + 1 < width))[None, None, :],
                     costs[..., 0], 0.0)
    wv = torch.where(((ys % s != s - 1) & (ys + 1 < height))[None, :, None],
                     costs[..., 1], 0.0)
    return torch.cat([_to_tiles(wh, s), _to_tiles(wv, s)], dim=1)


def _edge_endpoint_ranks(rank_img: torch.Tensor, s: int):
    """Current rank of each edge's endpoints, [B * T, 2 * s * s] each
    (tile-crossing edges read a neighbour tile's rank; their weight is 0)."""
    right = torch.cat([rank_img[:, :, 1:], rank_img[:, :, -1:]], dim=2)
    down = torch.cat([rank_img[:, 1:, :], rank_img[:, -1:, :]], dim=1)
    tiles = _to_tiles(rank_img, s)
    return (torch.cat([tiles, tiles], dim=1),
            torch.cat([_to_tiles(right, s), _to_tiles(down, s)], dim=1))


def _pair_from_pixels(rank_img: torch.Tensor, costs: torch.Tensor, s: int,
                      slots: int) -> torch.Tensor:
    """Symmetric zero-diagonal pair-cost matrix [B * T, S, S] aggregated from
    pixel state at supertile side s (the unfused leaf aggregation)."""
    w_e = _level_weights(costs, s)
    a, b = _edge_endpoint_ranks(rank_img, s)
    we = torch.where((a != b) & (w_e != 0.0), w_e, 0.0)
    pair = _edge_pairs(a, b, we, slots)
    sym = pair + pair.transpose(1, 2)
    return sym * (1.0 - torch.eye(slots, device=sym.device))


def _matrix_transition(rank_img, ncand, sym, m, frozen, final_gid, overflow,
                       costs, prev_s: int, prev_slots: int, s: int,
                       slots: int):
    """Level transition in slot space: offset child ranks, freeze overflow
    (labels straight from m), embed the four child pair matrices, add the
    newly active mid-line edges."""
    b, height, width = rank_img.shape
    th_p, tw_p = height // prev_s, width // prev_s
    th_n, tw_n = height // s, width // s
    counts = ncand.reshape(b, th_p, tw_p)
    c00 = counts[:, 0::2, 0::2]
    c01 = counts[:, 0::2, 1::2]
    c10 = counts[:, 1::2, 0::2]
    c11 = counts[:, 1::2, 1::2]
    off4 = torch.stack([torch.zeros_like(c00), c00, c00 + c01,
                        c00 + c01 + c10], dim=-1)        # [B, th, tw, 4]
    off_prev = (off4.reshape(b, th_n, tw_n, 2, 2).permute(0, 1, 3, 2, 4)
                .reshape(b, th_p, tw_p))
    off_img = (off_prev.repeat_interleave(prev_s, dim=1)
               .repeat_interleave(prev_s, dim=2))
    cand_img = rank_img + off_img
    newly = ~frozen & (rank_img >= 0) & (cand_img >= slots)
    ranks_pt = _to_tiles(rank_img, prev_s)
    minpix = _from_tiles(_take(m, ranks_pt.clamp(min=0)), b, height, width,
                         prev_s).to(torch.int32)
    final_gid = torch.where(newly, minpix, final_gid)
    frozen = frozen | newly
    rank_img = torch.where(frozen, -1, cand_img)
    overflow = overflow + (c00 + c01 + c10 + c11 - slots).clamp(
        min=0).sum(dim=(1, 2)).to(torch.int32)

    p4 = (sym.reshape(b, th_n, 2, tw_n, 2, prev_slots, prev_slots)
          .permute(0, 1, 3, 2, 4, 5, 6).reshape(-1, 4, prev_slots, prev_slots))
    m4 = (m.reshape(b, th_n, 2, tw_n, 2, prev_slots)
          .permute(0, 1, 3, 2, 4, 5).reshape(-1, 4, prev_slots))
    sym_new, m_new = _embed_children(p4, m4, off4.reshape(-1, 4), slots,
                                     float(height * width))

    # newly active edges: the two mid-lines of each new tile
    half = s // 2

    def tiles_h(img):  # [B, H, tw] -> [B * T', s]
        return img.reshape(b, th_n, s, tw_n).permute(0, 1, 3, 2).reshape(-1, s)

    def tiles_v(img):  # [B, th, W] -> [B * T', s]
        return img.reshape(-1, s)

    a_e = torch.cat([tiles_h(rank_img[:, :, half - 1::s]),
                     tiles_v(rank_img[:, half - 1::s, :])], dim=1)
    b_e = torch.cat([tiles_h(rank_img[:, :, half::s]),
                     tiles_v(rank_img[:, half::s, :])], dim=1)
    w_e = torch.cat([tiles_h(costs[:, :, half - 1::s, 0]),
                     tiles_v(costs[:, half - 1::s, :, 1])], dim=1)
    pair = _edge_pairs(a_e, b_e, w_e, slots)
    sym_new = sym_new + pair + pair.transpose(1, 2)
    return rank_img, sym_new, m_new, frozen, final_gid, overflow


def _apply_slot_map(rank_img: torch.Tensor, cmap: torch.Tensor,
                    s: int) -> torch.Tensor:
    """Remap pixel ranks through the level's composed slot map (frozen stay
    frozen): the one per-level pixel-space op of the matrix path."""
    b, height, width = rank_img.shape
    ranks_t = _to_tiles(rank_img, s)
    new_t = torch.where(ranks_t < 0, -1, _take(cmap, ranks_t))
    return _from_tiles(new_t, b, height, width, s)


def leaf_applies(sides: Sequence[int], caps: Sequence[int]) -> bool:
    """Whether levels 0-1 fit the multicut leaf: base 8, 64 level-0 slots,
    at least two levels and a level-1 cap the kernel holds."""
    return (len(sides) >= 2 and sides[0] == 8 and int(caps[0]) == 64
            and int(caps[1]) <= LEAF_MAX_S1)


def _hier_gaec_matrix(costs, sides, caps, rounds_per_level,
                      leaf: str) -> HierResult:
    b, height, width, _ = costs.shape
    sentinel = float(height * width)
    dev = costs.device
    if leaf == "fused" and not leaf_applies(sides, caps):
        raise ValueError("leaf='fused' needs base 8, caps[0]=64, "
                         f"caps[1]<={LEAF_MAX_S1} and >=2 levels; got "
                         f"sides={sides} caps={list(caps)[:2]}")
    if leaf in ("auto", "fused") and leaf_applies(sides, caps):
        from image_compression_torch.ops.multicut_leaf import (
            leaf_levels_fused)
        (rank_img, ncand, frozen, final_gid, overflow, sym,
         m) = leaf_levels_fused(costs, int(caps[1]), int(rounds_per_level[0]),
                                int(rounds_per_level[1]))
        first = 2
    else:
        overflow = torch.zeros(b, dtype=torch.int32, device=dev)
        frozen = torch.zeros((b, height, width), dtype=torch.bool, device=dev)
        final_gid = torch.zeros((b, height, width), dtype=torch.int32,
                                device=dev)
        s0, slots0 = sides[0], int(caps[0])
        ys = torch.arange(height, device=dev)[:, None]
        xs = torch.arange(width, device=dev)[None, :]
        rank_img = ((ys % s0) * s0 + (xs % s0)).expand(b, height, width)
        sym = _pair_from_pixels(rank_img, costs, s0, slots0)
        # level-0 ranks are the local pixel index: m is the pixel id itself
        m = _to_tiles((ys * width + xs).expand(b, height, width),
                      s0).to(torch.float32)
        sym, m, cmap, ncand = _matrix_rounds(sym, m, int(rounds_per_level[0]),
                                             sentinel)
        rank_img = _apply_slot_map(rank_img, cmap, s0)
        first = 1

    for i in range(first, len(sides)):
        s, slots = sides[i], int(caps[i])
        rank_img, sym, m, frozen, final_gid, overflow = _matrix_transition(
            rank_img, ncand, sym, m, frozen, final_gid, overflow, costs,
            sides[i - 1], int(caps[i - 1]), s, slots)
        sym, m, cmap, ncand = _matrix_rounds(sym, m, int(rounds_per_level[i]),
                                             sentinel)
        rank_img = _apply_slot_map(rank_img, cmap, s)

    slots = int(caps[-1])
    return HierResult(rank_img.to(torch.int32),
                      ncand.reshape(b, -1).to(torch.int32), frozen,
                      final_gid.to(torch.int32), overflow.to(torch.int32),
                      sides[-1], slots, minpix=m.reshape(b, -1, slots),
                      pair=sym.reshape(b, -1, slots, slots))


def plan_levels(height: int, width: int, base: int = 8) -> list[int]:
    """Supertile sides: base, 2*base, ... while they divide both dims. Empty
    if base does not divide the image."""
    if height % base or width % base or height < base or width < base:
        return []
    sides = []
    s = base
    while height % s == 0 and width % s == 0 and s <= min(height, width):
        sides.append(s)
        s *= 2
    return sides


def default_caps(sides: Sequence[int]) -> list[int]:
    """Slot caps per level: the first level exact (s^2 singleton slots), then
    min(4 * previous, s^2, 64 + 64 * level)."""
    caps = []
    for i, s in enumerate(sides):
        if i == 0:
            caps.append(s * s)
        else:
            caps.append(int(min(4 * caps[-1], s * s, 64 + 64 * i)))
    return caps


def lean_caps(sides: Sequence[int], kind: str = "half") -> list[int]:
    """Tighter slot-cap schedules than `default_caps`: "half" halves every
    level above the first (floor 32), "flat64" caps them at 64."""
    base = default_caps(sides)
    if kind == "half":
        return [c if i == 0 else max(32, c // 2) for i, c in enumerate(base)]
    if kind == "flat64":
        return [c if i == 0 else min(c, 64) for i, c in enumerate(base)]
    raise ValueError(f"unknown caps kind: {kind}")


def hier_gaec(costs_bhw2: torch.Tensor, base: int = 8,
              rounds_per_level: Sequence[int] | None = None,
              caps: Sequence[int] | None = None,
              leaf: str = "auto") -> HierResult:
    """Run the chain-mode hierarchy with matrix aggregation over all
    divisible levels of a batch of cost planes [B, H, W, 2].

    leaf selects how levels 0-1 run: "auto" uses the multicut leaf
    (ops/multicut_leaf.py) whenever it applies, "fused" requires it,
    "unfused" runs the level-by-level loop. Same merges either way
    (bit-identical on integer-valued costs)."""
    height, width = costs_bhw2.shape[1:3]
    sides = plan_levels(height, width, base)
    if not sides:
        raise ValueError(f"image {height}x{width} not divisible by {base}")
    if height * width >= 2 ** 24:
        raise ValueError("min-pixel ids are f32: H*W must stay below 2^24")
    if leaf not in ("auto", "fused", "unfused"):
        raise ValueError(f"unknown leaf: {leaf}")
    if caps is None:
        caps = default_caps(sides)
    if int(caps[0]) < sides[0] * sides[0]:
        raise ValueError("caps[0] must cover the base tile "
                         f"({sides[0]}^2), got {caps[0]}")
    if rounds_per_level is None:
        rounds_per_level = [3, 2] + [1] * (len(sides) - 2)
    elif len(rounds_per_level) < len(sides):  # deeper levels repeat the last
        rounds_per_level = (list(rounds_per_level)
                            + [rounds_per_level[-1]]
                            * (len(sides) - len(rounds_per_level)))
    return _hier_gaec_matrix(costs_bhw2.to(torch.float32), sides, caps,
                             rounds_per_level, leaf)


def globalize(res: HierResult, height: int, width: int) -> torch.Tensor:
    """Per-pixel region ids [B, H, W] across each image from top-tile ranks:
    top_tile_index * top_slots + rank; frozen pixels get the sentinel H*W."""
    s, slots = res.top_tile, res.top_slots
    dev = res.rank_img.device
    ys = torch.arange(height, device=dev)[:, None]
    xs = torch.arange(width, device=dev)[None, :]
    tile_idx = (ys // s) * (width // s) + (xs // s)
    return torch.where(res.frozen, height * width,
                       tile_idx * slots + res.rank_img).to(torch.int32)


def smallest_pixel_labels(res: HierResult) -> torch.Tensor:
    """Relabel top-tile ranks to each region's smallest pixel index (the
    public label contract) by one slot lookup into minpix; frozen regions
    carry theirs in final_gid. Returns [B, H, W] int32."""
    b, height, width = res.rank_img.shape
    s, slots = res.top_tile, res.top_slots
    ranks_t = _to_tiles(res.rank_img, s)
    lab_t = _take(res.minpix.reshape(-1, slots),
                  ranks_t.clamp(min=0)).to(torch.int32)
    labels = _from_tiles(lab_t, b, height, width, s)
    return torch.where(res.frozen, res.final_gid, labels)
