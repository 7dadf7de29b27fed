"""PNG/DEFLATE size estimator for masked segments.

Port of the reference's ops/png_estimator.py (the size-bucketed paths): an
analytic, encode-free model of the PNG byte size of one segment rendered
into its bounding box with everything outside the segment zeroed. Per
segment:

  1. per-row costs of the 5 PNG filters (None/Sub/Up/Avg/Paeth) with
     segment-masked neighbours and bbox-relative boundaries;
  2. min-cost filter per row (first index on ties), residual image;
  3. per-channel 256-bin histograms -> mean entropy (optionally only over
     bytes not covered by a long run, plus the Miller-Madow correction);
  4. run-length match proxy on the residual stream in bbox row-major order,
     and the LZ-window distance term (rows repeating at a period whose
     stream distance fits the window);
  5. S = overhead_base + h + N * b_data / 8,
     b_data = (1 - f)(H + beta) + f (b_match_token / L + gamma).

Every segment slot is evaluated inside a square crop of the smallest size
class that holds its bbox, all slots of a class at once (a written-out slot
dimension). Sizes agree with the reference within a relative 1e-5 (f32 sums
may be grouped differently). The formulas mirror the reference's estimator
and its scalar oracle tests; do not "fix" them here alone.
"""

from __future__ import annotations

import torch

from image_compression_torch.ops.edges import shift_plane

MASK32 = 0xFFFFFFFF


def _as_int8_abs(r: torch.Tensor) -> torch.Tensor:
    """|int8 reinterpretation| of a uint8 residual (the filter heuristic)."""
    return torch.where(r >= 128, r - 256, r).abs()


def _paeth(a, b, c):
    """PNG Paeth predictor."""
    p = a + b - c
    pa = (p - a).abs()
    pb = (p - b).abs()
    pc = (p - c).abs()
    return torch.where((pa <= pb) & (pa <= pc), a, torch.where(pb <= pc, b, c))


def segment_sizes(img: torch.Tensor, inverse: torch.Tensor, k: torch.Tensor,
                  bbox: torch.Tensor, count: torch.Tensor,
                  seg_valid: torch.Tensor, *, min_pixels: int, l_min: int,
                  beta: float, b_match_token: float, gamma: float,
                  overhead_base: float, adaptive_filter: bool,
                  entropy_correction: str = "none",
                  literal_hist: str = "all", distance_window: int = 0,
                  max_period: int = 96) -> torch.Tensor:
    """Estimated PNG size of segment k[i] of crop i, for N crops at once
    (the reference's `_segment_size_one` with the slot dimension written
    out). img [N, h, w, C] int (0..255), inverse [N, h, w], k/count/
    seg_valid [N], bbox [N, 4] crop-local (x0, y0, x1, y1). Returns [N] f32.

    All per-element work runs on channel-interleaved rows [N, h, w*C]: the
    minor axis is the PNG byte stream itself."""
    n, height, width, channels = img.shape
    dev = img.device
    img = img.to(torch.int64)
    x0, y0, x1, y1 = (v[:, None, None] for v in bbox.to(torch.int64).unbind(1))
    w = bbox[:, 2].to(torch.int64) - bbox[:, 0] + 1
    h = bbox[:, 3].to(torch.int64) - bbox[:, 1] + 1
    n_cols = width * channels

    img2 = img.reshape(n, height, n_cols)
    ys = torch.arange(height, device=dev)[None, :, None]
    cs = torch.arange(n_cols, device=dev)[None, None, :]
    xs2 = cs // channels
    in_bbox2 = (xs2 >= x0) & (xs2 <= x1) & (ys >= y0) & (ys <= y1)
    in_seg2 = (inverse == k[:, None, None]).repeat_interleave(channels, dim=2)
    cur = torch.where(in_seg2, img2, 0)

    # masked neighbours with bbox-relative existence; the left pixel of
    # column j is column j - C
    has_left = xs2 > x0
    has_up = ys > y0
    left = torch.where(has_left & shift_plane(in_seg2, 0, channels),
                       shift_plane(img2, 0, channels), 0)
    up = torch.where(has_up & shift_plane(in_seg2, 1, 0),
                     shift_plane(img2, 1, 0), 0)
    upleft = torch.where(has_left & has_up & shift_plane(in_seg2, 1, channels),
                         shift_plane(img2, 1, channels), 0)

    def residual(pred):
        return torch.remainder(cur - pred, 256)

    preds = [torch.zeros_like(cur), left, up, (left + up) // 2,
             _paeth(left, up, upleft)]
    if adaptive_filter:
        costs = torch.stack([(_as_int8_abs(residual(p)) * in_bbox2).sum(dim=2)
                             for p in preds])       # [5, N, h]
        filter_id = torch.argmin(costs, dim=0)      # first index on ties
    else:
        filter_id = torch.full((n, height), 4, device=dev)
    fid = filter_id[:, :, None]
    res = residual(preds[0])
    for f in (1, 2, 3, 4):
        res = torch.where(fid == f, residual(preds[f]), res)

    # --- run-length match proxy in bbox row-major, channel-innermost order;
    # the row-start column continues from the previous bbox row's last
    # stream element
    col_start = x0 * channels
    col_end = x1 * channels + channels - 1
    row_last = torch.where(cs == col_end, res, 0).sum(dim=2)       # [N, h]
    prev_row_last = torch.cat(
        [torch.full((n, 1), -1, dtype=res.dtype, device=dev),
         row_last[:, :-1]], dim=1)
    prev = torch.where(cs > col_start, shift_plane(res, 0, 1, fill=-1),
                       torch.where(ys > y0, prev_row_last[:, :, None], -1))
    in_stream = in_bbox2
    same = in_stream & (res == prev) & (prev >= 0)
    is_start = in_stream & ~same

    # window formulation: a stream position lies in a run of length >=
    # l_min iff some window of l_min consecutive equal elements covers it
    def stream_next(b):
        head = (b & (cs == col_start)).any(dim=2)
        next_head = torch.cat([head[:, 1:], torch.zeros_like(head[:, :1])], 1)
        return torch.where(cs < col_end, shift_plane(b, 0, -1, fill=False),
                           (cs == col_end) & next_head[:, :, None])

    def stream_prev(b):
        tail = (b & (cs == col_end)).any(dim=2)
        prev_tail = torch.cat([torch.zeros_like(tail[:, :1]), tail[:, :-1]], 1)
        return torch.where(cs > col_start, shift_plane(b, 0, 1, fill=False),
                           (cs == col_start) & prev_tail[:, :, None])

    s_t = stream_next(same)
    w_ok = s_t
    for _ in range(l_min - 2):
        s_t = stream_next(s_t)
        w_ok = w_ok & s_t
    longrun = w_ok
    back = w_ok
    for _ in range(l_min - 1):
        back = stream_prev(back)
        longrun = longrun | back

    match_symbols = (in_stream & longrun).sum(dim=(1, 2))
    match_count = (is_start & longrun).sum(dim=(1, 2))
    match_len_sum = match_symbols

    # --- LZ-window distance term: rows whose residual signatures repeat at
    # period p <= max_period, gated by p * (w*C + 1) <= distance_window. The
    # signatures are the reference's int32 sums with wraparound, computed
    # here in int64 and compared modulo 2^32.
    matched_rows = torch.zeros((n, height), dtype=torch.bool, device=dev)
    if distance_window:
        cols = torch.arange(n_cols, device=dev)
        wgt1 = (cols * 1103515245 + 12345) & MASK32
        wgt2 = (cols * 214013 + 2531011) & MASK32
        masked_res = torch.where(in_stream, res, 0)
        sig1 = (masked_res * wgt1).sum(dim=2) & MASK32
        sig2 = (masked_res * wgt2).sum(dim=2) & MASK32
        periods = min(max_period, height - 1)
        if periods >= 1:
            ps = torch.arange(1, periods + 1, device=dev)[:, None]  # [P, 1]
            rows = torch.arange(height, device=dev)[None, :]        # [1, h]
            src = (rows - ps).clamp(min=0)                          # [P, h]
            eq = ((sig1[:, None, :] == sig1[:, src])
                  & (sig2[:, None, :] == sig2[:, src])
                  & (rows >= ps))                                   # [N, P, h]
            ok_rows = (rows >= y0 + ps) & (rows <= y1)              # [N, P, h]
            reach = ps[None] * (w * channels + 1)[:, None, None] \
                <= distance_window                                  # [N, P, 1]
            matched_rows = (eq & ok_rows & reach).any(dim=1)
        row_new = (in_stream & ~longrun).sum(dim=2)
        psyms = torch.where(matched_rows, row_new, 0).sum(dim=1)
        ptokens = torch.where(matched_rows, (row_new + 257) // 258, 0).sum(1)
        match_symbols = match_symbols + psyms
        match_count = match_count + ptokens
        match_len_sum = match_len_sum + psyms

    # --- entropy from per-channel histograms over the bbox ----------------
    if literal_hist == "nonmatch":
        hist_mask2 = in_bbox2 & ~longrun & ~matched_rows[:, :, None]
    elif literal_hist == "all":
        hist_mask2 = in_bbox2
    else:
        raise ValueError(f"unknown literal_hist: {literal_hist}")
    chan = (cs % channels).expand(n, height, n_cols)
    crop_id = torch.arange(n, device=dev)[:, None, None]
    bins = ((crop_id * channels + chan) * 256 + res)[hist_mask2]
    hist = torch.bincount(bins, minlength=n * channels * 256).to(
        torch.float32).reshape(n, channels, 256)
    if literal_hist == "nonmatch":
        n_per_channel = hist.sum(dim=-1)
    else:
        n_per_channel = (w * h).to(torch.float32)[:, None].expand(n, channels)
    denom = n_per_channel.clamp(min=1.0)
    p = hist / denom[..., None]
    h_c = -torch.where(hist > 0, p * torch.log2(p.clamp(min=1e-30)),
                       0.0).sum(dim=-1)
    if entropy_correction == "miller_madow":
        # first-order small-sample bias of the plug-in entropy, capped at
        # 8 bits/byte
        k_occ = (hist > 0).to(torch.float32).sum(dim=-1)
        h_c = h_c + (k_occ - 1.0) / (2.0 * denom * 0.6931471805599453)
        h_c = h_c.clamp(max=8.0)
    elif entropy_correction != "none":
        raise ValueError(f"unknown entropy_correction: {entropy_correction}")
    h_bar = h_c.mean(dim=-1)

    # --- finalize ---------------------------------------------------------
    n_total = (w * h * channels).to(torch.float32)
    f_match = torch.where((n_total > 0) & (match_symbols > 0),
                          match_symbols / n_total, 0.0)
    l_bar = torch.where(match_count > 0,
                        match_len_sum / match_count.clamp(min=1),
                        float(l_min))
    b_lit = h_bar + beta
    b_match = b_match_token / l_bar.clamp(min=1e-9) + gamma
    b_data = (1.0 - f_match) * b_lit + f_match * b_match
    s_est = overhead_base + h.to(torch.float32) + n_total * b_data / 8.0
    ok = seg_valid & (count >= min_pixels) & (w > 0) & (h > 0)
    return torch.where(ok, s_est, 0.0).to(torch.float32)


def class_sizes_for(height: int, width: int) -> list[int]:
    """Square crop classes: powers of two from 32 below the smaller side,
    then the full image."""
    return [s for s in (32, 64, 128, 256, 512)
            if 32 <= s < min(height, width)] + [max(height, width)]


def _classify_and_pack(bboxes, valid, class_sizes, caps):
    """Assign each slot the smallest crop class that fits its bbox, spilling
    to larger classes when a class cap is exceeded (slots in order along
    the last dim). Returns (class, 1-based rank within class, top-class
    overflow mask)."""
    side = torch.maximum(bboxes[..., 2] - bboxes[..., 0] + 1,
                         bboxes[..., 3] - bboxes[..., 1] + 1)
    n_classes = len(class_sizes)
    cls = torch.full_like(side, n_classes - 1)
    for c in range(n_classes - 1, -1, -1):
        cls = torch.where(valid & (side <= class_sizes[c]), c, cls)
    cls = torch.where(valid, cls, n_classes)  # invalid slots: no class
    rank = torch.zeros_like(side)
    for c in range(n_classes):
        in_c = cls == c
        r = torch.cumsum(in_c.to(rank.dtype), dim=-1) * in_c
        if c < n_classes - 1:
            spill = in_c & (r > caps[c])
            cls = torch.where(spill, c + 1, cls)
            r = torch.where(spill, 0, r)
        rank = torch.where(in_c & (r > 0), r, rank)
    overflow = (cls == n_classes - 1) & (rank > caps[n_classes - 1])
    return cls, rank, overflow


def _estimate_bucketed(imgs, inverse, counts, bboxes, valid, caps, pooled,
                       est_kwargs):
    """Crop-class evaluation shared by the per-image and batch-pooled
    estimators. Slots are grouped [G, K']: one group per image with
    per-image caps, or (pooled) one group of all B*K slots with batch caps."""
    batch, height, width, chans = imgs.shape
    k_max = counts.shape[1]
    dev = imgs.device
    class_sizes = class_sizes_for(height, width)
    if pooled:
        counts_g = counts.reshape(1, -1)
        bboxes_g = bboxes.reshape(1, -1, 4)
        valid_g = valid.reshape(1, -1)
    else:
        counts_g, bboxes_g, valid_g = counts, bboxes, valid
    groups, slots = counts_g.shape
    cls, rank, overflow = _classify_and_pack(bboxes_g.to(torch.int64),
                                             valid_g, class_sizes, caps)
    sizes = torch.zeros((groups, slots), dtype=torch.float32, device=dev)
    for c, side in enumerate(class_sizes):
        crop_h, crop_w = min(side, height), min(side, width)
        member = (cls == c) & (rank >= 1) & (rank <= caps[c])
        g_idx, s_idx = member.nonzero(as_tuple=True)
        if g_idx.numel() == 0:
            continue
        if pooled:
            img_idx, lab_idx = s_idx // k_max, s_idx % k_max
        else:
            img_idx, lab_idx = g_idx, s_idx
        bb = bboxes_g[g_idx, s_idx].to(torch.int64)
        y0 = bb[:, 1].clamp(0, height - crop_h)
        x0 = bb[:, 0].clamp(0, width - crop_w)
        rows = y0[:, None] + torch.arange(crop_h, device=dev)
        cols = x0[:, None] + torch.arange(crop_w, device=dev)
        img_crop = imgs[img_idx[:, None, None], rows[:, :, None],
                        cols[:, None, :]]
        inv_crop = inverse[img_idx[:, None, None], rows[:, :, None],
                           cols[:, None, :]]
        bb_local = bb - torch.stack([x0, y0, x0, y0], dim=1)
        vals = segment_sizes(img_crop, inv_crop, lab_idx, bb_local,
                             counts_g[g_idx, s_idx], valid_g[g_idx, s_idx],
                             **est_kwargs)
        sizes[g_idx, s_idx] = vals

    # top-class overflow: literal-only upper bound (max-entropy bytes)
    w = (bboxes_g[..., 2] - bboxes_g[..., 0] + 1).to(torch.float32)
    h = (bboxes_g[..., 3] - bboxes_g[..., 1] + 1).to(torch.float32)
    n_total = w * h * chans
    fallback = (est_kwargs["overhead_base"] + h
                + n_total * (8.0 + est_kwargs["beta"]) / 8.0)
    ok_fb = overflow & (counts_g >= est_kwargs["min_pixels"])
    sizes = torch.where(ok_fb, fallback, sizes)
    return torch.where(valid_g, sizes, 0.0).reshape(batch, k_max)


def _est_kwargs(min_pixels=1, l_min=4, beta=0.012167, b_match_token=18.0,
                gamma=0.1, overhead_base=9.308622, adaptive_filter=True,
                entropy_correction="none", literal_hist="all",
                distance_window=0, max_period=96):
    return dict(min_pixels=min_pixels, l_min=l_min, beta=beta,
                b_match_token=b_match_token, gamma=gamma,
                overhead_base=overhead_base, adaptive_filter=adaptive_filter,
                entropy_correction=entropy_correction,
                literal_hist=literal_hist, distance_window=distance_window,
                max_period=max_period)


def estimate_segment_png_sizes_fast(imgs_u8: torch.Tensor,
                                    inverse: torch.Tensor,
                                    counts: torch.Tensor,
                                    bboxes: torch.Tensor,
                                    valid: torch.Tensor, *,
                                    class_caps: tuple | None = None,
                                    **kwargs) -> torch.Tensor:
    """Size-bucketed estimator with per-image class caps.

    imgs_u8 [B, H, W, C], inverse [B, H, W] compact labels, counts/valid
    [B, k_max], bboxes [B, k_max, 4]. Returns sizes [B, k_max] f32 (0 for
    empty slots). Class caps default to max(4, k_max / 2^i), the full-image
    class max(2, k_max / 16); slots past a class cap spill to the next
    class, past the last to the literal-only bound. Keyword arguments are
    the estimator parameters (reference-parity defaults)."""
    height, width = imgs_u8.shape[1:3]
    k_max = counts.shape[1]
    class_sizes = class_sizes_for(height, width)
    if class_caps is not None:
        if len(class_caps) != len(class_sizes):
            raise ValueError(f"class_caps needs {len(class_sizes)} entries "
                             f"for {class_sizes}, got {class_caps}")
        caps = [int(c) for c in class_caps]
    else:
        caps = [max(2, k_max // 16) if i == len(class_sizes) - 1
                else max(4, k_max // (2 ** i))
                for i in range(len(class_sizes))]
    return _estimate_bucketed(imgs_u8, inverse, counts, bboxes, valid, caps,
                              False, _est_kwargs(**kwargs))


def estimate_segment_png_sizes_packed(imgs_u8: torch.Tensor,
                                      inverse: torch.Tensor,
                                      counts: torch.Tensor,
                                      bboxes: torch.Tensor,
                                      valid: torch.Tensor, *,
                                      class_caps: tuple,
                                      **kwargs) -> torch.Tensor:
    """`estimate_segment_png_sizes_fast` with the class caps shared by the
    whole batch (batch totals per class; earlier images claim capacity
    first). Every evaluated slot's value is the same as the per-image
    estimator's."""
    height, width = imgs_u8.shape[1:3]
    class_sizes = class_sizes_for(height, width)
    if len(class_caps) != len(class_sizes):
        raise ValueError(f"class_caps needs {len(class_sizes)} entries "
                         f"for {class_sizes}, got {class_caps}")
    return _estimate_bucketed(imgs_u8, inverse, counts, bboxes, valid,
                              [int(c) for c in class_caps], True,
                              _est_kwargs(**kwargs))
