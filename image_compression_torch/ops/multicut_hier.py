"""Hierarchical dense GAEC: the multicut solver's sort-free path.

Port of the reference's ops/multicut_hier.py. The image is covered by
supertiles whose side doubles per level (8 -> 16 -> ... -> min(H, W));
inside a supertile, regions are rank-compacted to a static slot count S and
the aggregated pair-cost matrix [S, S] is dense and small:

  * a merge round hooks slots to their most attractive partner (first index
    of the row maximum) — every slot in chain mode; mutual pairs plus the
    tail -> head hooks of coins `fold_in(PRNGKey(3), 1000 * level + round)`
    in random-mate mode; mutual pairs only in mutual mode — breaks
    2-cycles toward the smaller id and contracts chains by three (chain)
    or two (otherwise) pointer doublings;
  * a level transition offsets the four child ranks and freezes the
    regions that overflow the next level's slot cap, labelled by their
    smallest pixel index;
  * pixels carry their region's rank within the current supertile.

Two aggregations, the same merges on integer-valued costs:
  * "matrix": the pair matrix is the state, P <- M^T P M per round; the
    transition embeds the four child matrices and adds the newly active
    mid-line edges; a min-pixel vector m per slot labels frozen regions.
    Levels 0-1 run in the multicut leaf (ops/multicut_leaf.py: a CUDA
    kernel on the GPU, its plain version on the CPU) in chain mode.
  * "pixel": every round re-aggregates the pair matrix from the pixel-space
    edges; freezing takes a masked minimum over the pixels.

Every tensor carries the batch: images are [B, H, W], tile tensors fold the
batch into their leading dimension ([B * tiles, ...], image-major then tiles
row-major). Coins are drawn once at one image's shape [tiles, S] and
repeated over the batch, as the reference's vmap shares its constant keys.
Arithmetic mirrors the reference: edge weights are rounded to bf16 (round
to nearest even) before they are summed in f32, and the argmax takes the
first index. Min-pixel ids are int32, exact at every image size; the
reference carries them in f32, exact only up to 2^24 pixels. On
integer-valued costs every state field is bit-identical to the reference
there; on real-valued costs f32 sums may be grouped differently. The f32
matrix products assume PyTorch's default full-precision float32 matmul
(`torch.backends.cuda.matmul.allow_tf32` False).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from image_compression_torch.ops import prng

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
    minpix: torch.Tensor | None = None  # [B, T_top, S] int32 min pixel id
    #                          per slot (agg="matrix" only)
    pair: torch.Tensor | None = None    # [B, T_top, S, S] f32 aggregated
    #                          pair costs (agg="matrix" only)


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


def _pixel_ids(b: int, height: int, width: int, device) -> torch.Tensor:
    """Flat pixel index of every pixel, [B, H, W] int32."""
    return (torch.arange(height * width, dtype=torch.int32, device=device)
            .reshape(1, height, width).expand(b, height, width))


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


def first_argmax(sym: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """First index of each row's maximum `best` of sym [T, S, S]."""
    slots = sym.shape[-1]
    cols = torch.arange(slots, device=sym.device)
    return torch.where(sym == best.unsqueeze(-1), cols, slots).amin(dim=-1)


def _hook(sym: torch.Tensor, mode: str, coin: torch.Tensor | None
          ) -> torch.Tensor:
    """One round's slot map [T, S] from the pair matrices [T, S, S]: hook
    (chain: every slot with an attractive best partner; mutual: mutual best
    pairs; random_mate: those plus tail -> head hooks of `coin`), break
    2-cycles toward the smaller id, then 3 (chain) or 2 pointer
    doublings."""
    t_count, slots = sym.shape[:2]
    ids = torch.arange(slots, device=sym.device).expand(t_count, slots)
    best = sym.amax(dim=-1)
    partner = first_argmax(sym, best)
    merge = best > 0.0
    if mode != "chain":
        partner_safe = torch.where(merge, partner, 0)
        mutual = merge & (_take(partner, partner_safe) == ids)
        if mode == "mutual":
            merge = mutual
        else:
            merge = mutual | (merge & ~coin & _take(coin, partner_safe))
    nxt = torch.where(merge, partner, ids)
    nn = _take(nxt, nxt)
    nxt = torch.where((nn == ids) & (ids < nxt), ids, nxt)
    for _ in range(3 if mode == "chain" else 2):
        nxt = _take(nxt, nxt)
    return nxt


def _round_coins(mode: str, salt: int, t_count: int, slots: int,
                 batch: int, device) -> torch.Tensor | None:
    """Random-mate coins of one round in the [B * tiles, S] layout:
    bernoulli(fold_in(PRNGKey(3), salt), 0.5, [tiles of one image, S]),
    repeated over the images; None in the other modes."""
    if mode != "random_mate":
        return None
    return prng.bernoulli(prng.fold_in(prng.prng_key(3), salt), 0.5,
                          (t_count // batch, slots), device).repeat(batch, 1)


def _remap(sym: torch.Tensor, m: torch.Tensor, tgt: torch.Tensor,
           sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
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
                   sentinel: int, mode: str = "chain", level_salt: int = 0,
                   batch: int = 1):
    """GAEC rounds in slot space, then dense re-ranking.

    sym [T, S, S] f32, m [T, S] int32 (T = batch * tiles per image).
    Returns (sym, m, cmap, n_alive): cmap [T, S] int64 maps entry ranks to
    final dense ranks (entries of slots that were dead on entry are unused),
    n_alive [T] int64."""
    t_count, slots = m.shape
    ids = torch.arange(slots, device=m.device).expand(t_count, slots)
    off_diag = 1.0 - torch.eye(slots, device=m.device)
    cmap = ids
    for r in range(rounds):
        coin = _round_coins(mode, level_salt + r, t_count, slots, batch,
                            m.device)
        nxt = _hook(sym, mode, coin)
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
                    slots: int, sentinel: int):
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
    m = torch.full((t_count, slots), sentinel, dtype=m4.dtype,
                   device=p4.device)
    m = m.scatter_reduce(1, cand.reshape(t_count, -1).clamp(max=slots - 1),
                         torch.where(keep, m4.reshape(t_count, -1), sentinel),
                         "amin")
    return sym, m


def _pair_matrix(a_e: torch.Tensor, b_e: torch.Tensor, w_e: torch.Tensor,
                 slots: int) -> torch.Tensor:
    """Pair matrix [T, S, S] of an edge list: the f32 sum of the weights
    w_e [T, E] of the edges whose endpoint ranks are (a_e, b_e); endpoints
    outside [0, S) (frozen, -1) contribute nothing."""
    oh_aw = _one_hot(a_e, slots) * w_e.unsqueeze(-1)
    return torch.bmm(oh_aw.transpose(1, 2), _one_hot(b_e, slots))


def _edge_pairs(a_e: torch.Tensor, b_e: torch.Tensor, w_e: torch.Tensor,
                slots: int) -> torch.Tensor:
    """`_pair_matrix` of the bf16-rounded weights (the hierarchy's bf16
    operands with f32 accumulation; the products are exact in f32)."""
    return _pair_matrix(a_e, b_e, bf16_round(w_e), slots)


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


def _slot_min(ranks_t: torch.Tensor, pix_t: torch.Tensor, slots: int,
              sentinel: int) -> torch.Tensor:
    """Smallest pixel id per slot [T, S] over the pixels of each tile
    carrying that rank (frozen pixels, rank -1, excluded); the sentinel
    where no pixel does."""
    keep = ranks_t >= 0
    return torch.full((ranks_t.shape[0], slots), sentinel,
                      dtype=pix_t.dtype, device=pix_t.device).scatter_reduce(
        1, ranks_t.clamp(min=0).long(), torch.where(keep, pix_t, sentinel),
        "amin")


def _child_offsets(ncand: torch.Tensor, b: int, height: int, width: int,
                   prev_s: int, s: int):
    """Level transition offsets: each child tile's ranks shift by the live
    regions of the children before it (quad order 00, 01, 10, 11). Returns
    (off4 [B * T', 4], off_img [B, H, W], live regions per new tile
    [B, th, tw])."""
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
    return off4.reshape(-1, 4), off_img, c00 + c01 + c10 + c11


def _matrix_transition(rank_img, ncand, sym, m, frozen, final_gid, overflow,
                       costs, prev_s: int, prev_slots: int, s: int,
                       slots: int):
    """Level transition in slot space: offset child ranks, freeze overflow
    (labels straight from m), embed the four child pair matrices, add the
    newly active mid-line edges."""
    b, height, width = rank_img.shape
    th_n, tw_n = height // s, width // s
    off4, off_img, live = _child_offsets(ncand, b, height, width, prev_s, s)
    cand_img = rank_img + off_img
    newly = ~frozen & (rank_img >= 0) & (cand_img >= slots)
    ranks_pt = _to_tiles(rank_img, prev_s)
    minpix = _from_tiles(_take(m, ranks_pt.clamp(min=0)), b, height, width,
                         prev_s).to(torch.int32)
    final_gid = torch.where(newly, minpix, final_gid)
    frozen = frozen | newly
    rank_img = torch.where(frozen, -1, cand_img)
    overflow = overflow + (live - slots).clamp(min=0).sum(
        dim=(1, 2)).to(torch.int32)

    p4 = (sym.reshape(b, th_n, 2, tw_n, 2, prev_slots, prev_slots)
          .permute(0, 1, 3, 2, 4, 5, 6).reshape(-1, 4, prev_slots, prev_slots))
    m4 = (m.reshape(b, th_n, 2, tw_n, 2, prev_slots)
          .permute(0, 1, 3, 2, 4, 5).reshape(-1, 4, prev_slots))
    sym_new, m_new = _embed_children(p4, m4, off4, slots, height * width)

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
    """Remap pixel ranks through a slot map (frozen stay frozen)."""
    b, height, width = rank_img.shape
    ranks_t = _to_tiles(rank_img, s)
    new_t = torch.where(ranks_t < 0, -1, _take(cmap, ranks_t))
    return _from_tiles(new_t, b, height, width, s)


def leaf_applies(sides: Sequence[int], caps: Sequence[int],
                 mode: str) -> bool:
    """Whether levels 0-1 fit the multicut leaf: chain mode, base 8, 64
    level-0 slots, at least two levels and a level-1 cap the kernel
    holds."""
    return (mode == "chain" and len(sides) >= 2 and sides[0] == 8
            and int(caps[0]) == 64 and int(caps[1]) <= LEAF_MAX_S1)


def _minpix_from_pixels(rank_img: torch.Tensor, s: int,
                        slots: int) -> torch.Tensor:
    """Smallest pixel id per slot [B * T, S] from pixel state at supertile
    side s (the resume's rebuild; dead slots carry the sentinel H*W)."""
    b, height, width = rank_img.shape
    return _slot_min(_to_tiles(rank_img, s),
                     _to_tiles(_pixel_ids(b, height, width, rank_img.device),
                               s), slots, height * width)


def _resume_state(init_state, b: int):
    """The five pixel-state fields of a resume, in the loop's layout: ranks,
    frozen and final_gid [B, H, W], ncand [B * T], overflow [B]."""
    rank_img, ncand, frozen, final_gid, overflow = init_state[:5]
    overflow = torch.as_tensor(overflow, dtype=torch.int32,
                               device=rank_img.device).expand(b)
    return (rank_img.to(torch.int64), ncand.reshape(-1).to(torch.int64),
            frozen.to(torch.bool), final_gid.to(torch.int32), overflow)


def _hier_gaec_matrix(costs, sides, caps, rounds_per_level, mode: str,
                      leaf: str, start_level: int = 0,
                      init_state: tuple | None = None) -> HierResult:
    b, height, width, _ = costs.shape
    sentinel = height * width
    dev = costs.device
    fused_ok = init_state is None and leaf_applies(sides, caps, mode)
    if leaf == "fused" and not fused_ok:
        raise ValueError("leaf='fused' needs a fresh start, mode='chain', "
                         f"base 8, caps[0]=64, caps[1]<={LEAF_MAX_S1} and "
                         f">=2 levels; got sides={sides} "
                         f"caps={list(caps)[:2]} mode={mode}")
    if init_state is not None:
        rank_img, ncand, frozen, final_gid, overflow = _resume_state(
            init_state, b)
        if len(init_state) == 7:
            # the slot-space handoff: the carried pair matrices and min-pixel
            # ids continue as they are, with no pixel-space rebuild
            slots = int(caps[start_level - 1])
            sym = init_state[5].reshape(-1, slots, slots).to(torch.float32)
            m = init_state[6].reshape(-1, slots).to(torch.int32)
        else:
            prev = start_level - 1
            sym = _pair_from_pixels(rank_img, costs, sides[prev],
                                    int(caps[prev]))
            m = _minpix_from_pixels(rank_img, sides[prev], int(caps[prev]))
        first = start_level
    elif leaf in ("auto", "fused") and fused_ok:
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
        m = _to_tiles(_pixel_ids(b, height, width, dev), s0)
        sym, m, cmap, ncand = _matrix_rounds(
            sym, m, int(rounds_per_level[0]), sentinel, mode, 0, b)
        rank_img = _apply_slot_map(rank_img, cmap, s0)
        first = 1

    for i in range(first, len(sides)):
        s, slots = sides[i], int(caps[i])
        rank_img, sym, m, frozen, final_gid, overflow = _matrix_transition(
            rank_img, ncand, sym, m, frozen, final_gid, overflow, costs,
            sides[i - 1], int(caps[i - 1]), s, slots)
        sym, m, cmap, ncand = _matrix_rounds(
            sym, m, int(rounds_per_level[i]), sentinel, mode, 1000 * i, b)
        rank_img = _apply_slot_map(rank_img, cmap, s)

    slots = int(caps[-1])
    return HierResult(rank_img.to(torch.int32),
                      ncand.reshape(b, -1).to(torch.int32), frozen,
                      final_gid.to(torch.int32), overflow.to(torch.int32),
                      sides[-1], slots,
                      minpix=m.reshape(b, -1, slots).to(torch.int32),
                      pair=sym.reshape(b, -1, slots, slots))


def _dense_rounds(rank_img: torch.Tensor, w_e: torch.Tensor, s: int,
                  slots: int, rounds: int, mode: str, level_salt: int,
                  identity_first: bool = False):
    """Pixel-aggregation GAEC rounds at one level. rank_img [B, H, W] with
    ranks in [0, slots) (-1 frozen), w_e [B * T, 2 * s * s] the level's edge
    weights. Returns (rank_img, n_alive [B * T]) with ranks re-compacted.

    identity_first: entry ranks are the identity (level 0), so round 0's
    pair matrix is the horizontal weights on the +1 band and the vertical
    weights on the +s band (one edge per pair: equal to the aggregation)."""
    b, height, width = rank_img.shape
    w_bf = bf16_round(w_e)
    t_count = w_e.shape[0]
    dev = rank_img.device
    for r in range(rounds):
        if identity_first and r == 0 and slots == s * s:
            whb, wvb = w_bf[:, :s * s], w_bf[:, s * s:]
            rr = torch.arange(slots, device=dev)[:, None]
            cc = torch.arange(slots, device=dev)[None, :]
            band_r = ((cc == rr + 1) & (rr % s != s - 1)).to(torch.float32)
            band_d = (cc == rr + s).to(torch.float32)
            sym = (whb[:, :, None] * band_r + wvb[:, :, None] * band_d
                   + whb[:, None, :] * band_r.T + wvb[:, None, :] * band_d.T)
        else:
            a, bb = _edge_endpoint_ranks(rank_img, s)
            we = torch.where((a != bb) & (w_e != 0.0), w_bf, 0.0)
            pair = _pair_matrix(a, bb, we, slots)
            sym = pair + pair.transpose(1, 2)
        coin = _round_coins(mode, level_salt + r, t_count, slots, b, dev)
        rank_img = _apply_slot_map(rank_img, _hook(sym, mode, coin), s)

    # compact: re-rank the live slots (those some unfrozen pixel carries)
    ranks_t = _to_tiles(rank_img, s)
    alive = torch.zeros((t_count, slots), dtype=torch.int64,
                        device=dev).scatter_reduce(
        1, ranks_t.clamp(min=0).long(), (ranks_t >= 0).long(), "amax")
    new_rank = torch.cumsum(alive, dim=1) - 1
    return _apply_slot_map(rank_img, new_rank, s), new_rank[:, -1] + 1


def _hier_gaec_pixel(costs, sides, caps, rounds_per_level, mode: str,
                     start_level: int = 0,
                     init_state: tuple | None = None) -> HierResult:
    b, height, width, _ = costs.shape
    n = height * width
    dev = costs.device
    pix = _pixel_ids(b, height, width, dev)
    if init_state is not None:
        rank_img, ncand, frozen, final_gid, overflow = _resume_state(
            init_state, b)
    else:
        overflow = torch.zeros(b, dtype=torch.int32, device=dev)
        frozen = torch.zeros((b, height, width), dtype=torch.bool,
                             device=dev)
        final_gid = torch.zeros((b, height, width), dtype=torch.int32,
                                device=dev)
        ncand = None
    for i, s in list(enumerate(sides))[start_level:]:
        slots = int(caps[i])
        if i == 0:
            ys = torch.arange(height, device=dev)[:, None]
            xs = torch.arange(width, device=dev)[None, :]
            rank_img = ((ys % s) * s + (xs % s)).expand(b, height, width)
        else:
            # offset each child's dense ranks; freeze whole regions that do
            # not fit the cap under their smallest pixel index
            prev_s, prev_slots = sides[i - 1], int(caps[i - 1])
            _, off_img, live = _child_offsets(ncand, b, height, width,
                                              prev_s, s)
            cand_img = rank_img + off_img
            newly = ~frozen & (rank_img >= 0) & (cand_img >= slots)
            ranks_pt = _to_tiles(rank_img, prev_s)
            mins_p = _slot_min(ranks_pt, _to_tiles(pix, prev_s), prev_slots,
                               n)
            minpix = _from_tiles(_take(mins_p, ranks_pt.clamp(min=0)), b,
                                 height, width, prev_s)
            final_gid = torch.where(newly, minpix, final_gid)
            frozen = frozen | newly
            rank_img = torch.where(frozen, -1, cand_img)
            overflow = overflow + (live - slots).clamp(min=0).sum(
                dim=(1, 2)).to(torch.int32)
        rank_img, ncand = _dense_rounds(
            rank_img, _level_weights(costs, s), s, slots,
            int(rounds_per_level[i]), mode, 1000 * i, identity_first=(i == 0))
    return HierResult(rank_img.to(torch.int32),
                      ncand.reshape(b, -1).to(torch.int32), frozen,
                      final_gid, overflow, sides[-1], int(caps[-1]))


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


def hier_gaec(costs_bhw2: torch.Tensor, mode: str = "chain", base: int = 8,
              rounds_per_level: Sequence[int] | None = None,
              caps: Sequence[int] | None = None, agg: str = "matrix",
              leaf: str = "auto", start_level: int = 0,
              init_state: tuple | None = None) -> HierResult:
    """Run the hierarchy over all divisible levels of a batch of cost planes
    [B, H, W, 2].

    start_level / init_state resume the hierarchy part way (the spatially
    sharded solve, parallel/spatial.py: strips run the levels that fit their
    height, then the gathered state continues here). init_state holds the
    state after level start_level - 1, as a HierResult lays it out:
    (rank_img [B, H, W], ncand [B, T], frozen, final_gid [B, H, W],
    overflow [B]); sides, caps and rounds are the whole image's plan. With
    agg="matrix" a 7-tuple (..., pair [B, T, S, S], minpix [B, T, S]) hands
    over the slot-space state as it is, and the resumed run is bit-identical
    to an unsharded one; the 5-tuple rebuilds pair and minpix from the pixel
    state. A resumed run never takes the leaf kernel.

    mode: "chain", "random_mate" or "mutual". agg: "matrix" (the port's
    default; the reference function's is "pixel") or "pixel". leaf (matrix
    agg only) selects how levels 0-1 run: "auto" uses the multicut leaf
    (ops/multicut_leaf.py) whenever it applies (chain mode, base 8,
    caps[0] = 64, caps[1] <= 128), "fused" requires it, "xla" or "unfused"
    runs the level-by-level loop. The same merges every way (bit-identical
    on integer-valued costs)."""
    height, width = costs_bhw2.shape[1:3]
    sides = plan_levels(height, width, base)
    if not sides:
        raise ValueError(f"image {height}x{width} not divisible by {base}")
    if mode not in ("chain", "random_mate", "mutual"):
        raise ValueError(f"unknown mode: {mode}")
    if agg not in ("pixel", "matrix"):
        raise ValueError(f"unknown agg: {agg}")
    if leaf not in ("auto", "fused", "xla", "unfused"):
        raise ValueError(f"unknown leaf: {leaf}")
    if (start_level > 0) != (init_state is not None):
        raise ValueError("start_level and init_state go together")
    if init_state is not None:
        if not 0 < start_level <= len(sides):
            raise ValueError(f"start_level {start_level} outside the "
                             f"{len(sides)} levels of {height}x{width}")
        if len(init_state) not in (5, 7) or (len(init_state) == 7
                                             and agg != "matrix"):
            raise ValueError("init_state is a 5-tuple, or a 7-tuple with "
                             f"agg='matrix'; got {len(init_state)} fields "
                             f"with agg={agg!r}")
    if caps is None:
        caps = default_caps(sides)
    if int(caps[0]) < sides[0] * sides[0]:
        raise ValueError("caps[0] must cover the base tile "
                         f"({sides[0]}^2), got {caps[0]}")
    if rounds_per_level is None:
        # random_mate's coin-gated merges convert fewer candidates per round
        rounds_per_level = ([3, 2] + [1] * (len(sides) - 2) if mode == "chain"
                            else [4, 3] + [2] * (len(sides) - 2))
    elif len(rounds_per_level) < len(sides):  # deeper levels repeat the last
        rounds_per_level = (list(rounds_per_level)
                            + [rounds_per_level[-1]]
                            * (len(sides) - len(rounds_per_level)))
    costs = costs_bhw2.to(torch.float32)
    if agg == "pixel":
        return _hier_gaec_pixel(costs, sides, caps, rounds_per_level, mode,
                                start_level, init_state)
    return _hier_gaec_matrix(costs, sides, caps, rounds_per_level, mode, leaf,
                             start_level, init_state)


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
    public label contract): one slot lookup into minpix (matrix agg) or a
    per-slot minimum over the pixels (pixel agg); frozen regions carry
    theirs in final_gid. Returns [B, H, W] int32."""
    b, height, width = res.rank_img.shape
    s, slots = res.top_tile, res.top_slots
    ranks_t = _to_tiles(res.rank_img, s)
    if res.minpix is not None:
        mins = res.minpix.reshape(-1, slots)
    else:
        mins = _slot_min(ranks_t, _to_tiles(_pixel_ids(
            b, height, width, ranks_t.device), s), slots, height * width)
    lab_t = _take(mins, ranks_t.clamp(min=0)).to(torch.int32)
    labels = _from_tiles(lab_t, b, height, width, s)
    return torch.where(res.frozen, res.final_gid, labels)
