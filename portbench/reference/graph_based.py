"""Frozen copy of the port's `ops/graph_based.py` (plain PyTorch, float32),
part of the benchmark's reference; it imports nothing of the program. The
Gaussian blur of `ops/color.py` and `edges_from_labels` of `ops/edges.py`
are copied in beside it.

Batched Felzenszwalb-Huttenlocher graph segmentation at the configuration's
settings only (sigma 1, k 100, min_size 250; any other raises): the
8-connected grid, edge weights the Euclidean colour distance of the
Gaussian-smoothed image in [0, 255]. Images whose shape admits at least two
supertile levels run the hierarchical version (graph_based_hier.py); the
others run this module's pixel-space parallel Boruvka:

  phase 1: each region takes its minimum outgoing edge (partner: the
  smallest region id among the edges of that weight) and joins over it iff
      w <= min(Int(A) + k/|A|, Int(B) + k/|B|),
  hooks are contracted with 2-cycles broken toward the smaller id and three
  pointer doublings (depth cap 8), and Int(A u B) = max(Int(A), Int(B), w);
  phase 2: components below min_size are absorbed along their cheapest
  boundary into larger (or equal-size smaller-id) partners, two doublings.

Each phase iterates to its fixpoint or `max_rounds` rounds. Segment minima,
maxima and counts are scatter reductions, which are independent of order.
The blur multiplies and adds in tap order, so its float32 results are the
same on every device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# the configuration's settings, the only ones this copy runs
SETTINGS = {"sigma": 1.0, "k": 100.0, "min_size": 250}
BIG = 1e9
INT_MAX = 2 ** 31 - 1
# (dy, dx) of the 8-connected edge planes: right, down, down-right, down-left
PLANES = ((0, 1), (1, 0), (1, 1), (1, -1))


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """Normalised float32 Gaussian taps, summed left to right in float32."""
    half = ksize // 2
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8  # OpenCV's default rule
    xs = np.arange(-half, half + 1, dtype=np.float32) / np.float32(sigma)
    taps = np.exp(-0.5 * xs.astype(np.float64) ** 2).astype(np.float32)
    total = np.float32(0.0)
    for t in taps:
        total = np.float32(total + t)
    return (taps / total).astype(np.float32)


def _reflect101(n: int, half: int, device) -> torch.Tensor:
    """Source index of each of the n + 2*half padded positions under
    reflect-101 padding (numpy's "reflect", repeated for pads wider than
    the side)."""
    i = torch.arange(-half, n + half, device=device)
    if n == 1:
        return torch.zeros_like(i)
    j = torch.remainder(i, 2 * (n - 1))
    return torch.where(j >= n, 2 * (n - 1) - j, j)


def gaussian_blur(image: torch.Tensor, ksize: int = 3,
                  sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W] float32 with reflect-101
    borders (OpenCV's default): horizontal then vertical pass, each a sum of
    shifted planes in tap order."""
    if ksize < 3 or ksize % 2 == 0:
        return image
    half = ksize // 2
    taps = gaussian_kernel(ksize, sigma).tolist()
    height, width = image.shape[-2:]
    x = image[..., _reflect101(height, half, image.device), :][
        ..., _reflect101(width, half, image.device)]
    h = 0.0
    for i, t in enumerate(taps):
        h = h + t * x[..., :, i:i + width]
    v = 0.0
    for i, t in enumerate(taps):
        v = v + t * h[..., i:i + height, :]
    return v


def edges_from_labels(labels: torch.Tensor) -> torch.Tensor:
    """Connect/cut planes [..., H, W, 2] float32 from a label map
    [..., H, W]: 1.0 where both endpoints share a label; padding is 0."""
    same_h = (labels[..., :, :-1] == labels[..., :, 1:]).to(torch.float32)
    same_v = (labels[..., :-1, :] == labels[..., 1:, :]).to(torch.float32)
    return torch.stack([F.pad(same_h, (0, 1)), F.pad(same_v, (0, 0, 0, 1))],
                       dim=-1)


def check_settings(sigma: float, k: float, min_size: int) -> None:
    """Raise ValueError unless (sigma, k, min_size) are SETTINGS."""
    if (sigma, k, min_size) != tuple(SETTINGS.values()):
        raise ValueError(f"the reference runs only {SETTINGS}, got sigma "
                         f"{sigma}, k {k}, min_size {min_size}")


def smooth_image(images_f01: torch.Tensor, sigma: float) -> torch.Tensor:
    """[B, H, W, C] float [0, 1] -> the Gaussian-smoothed [0, 255] image
    (OpenCV's automatic kernel size for float images)."""
    img = images_f01.to(torch.float32) * 255.0
    ksize = 2 * int(math.ceil(4.0 * sigma)) + 1
    return gaussian_blur(img.permute(0, 3, 1, 2), ksize,
                         sigma).permute(0, 2, 3, 1)


def edge_weight_planes(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, 4] colour distances to the target of each
    plane (edge-replicated outside the image), BIG where the target lies
    outside. The channel sum runs left to right, as the reference's."""
    b, height, width, chans = img.shape
    ys = torch.arange(height, device=img.device)[:, None]
    xs = torch.arange(width, device=img.device)[None, :]
    out = []
    for dy, dx in PLANES:
        ty = (ys + dy).clamp(0, height - 1)
        tx = (xs + dx).clamp(0, width - 1)
        diff = img - img[:, ty, tx]
        sq = 0.0
        for c in range(chans):
            sq = sq + diff[..., c] * diff[..., c]
        ok = ((ys + dy >= 0) & (ys + dy < height)
              & (xs + dx >= 0) & (xs + dx < width))
        out.append(torch.where(ok, torch.sqrt(sq), BIG))
    return torch.stack(out, dim=-1)


def _endpoints(root: torch.Tensor, height: int, width: int):
    """Endpoint region ids (ru, rv) of every 8-connected edge slot
    [B * H * W * 4], in (image, y, x, plane) order; out-of-image slots get
    ru == rv (inactive)."""
    im = root.reshape(-1, height, width)
    ys = torch.arange(height, device=root.device)[:, None]
    xs = torch.arange(width, device=root.device)[None, :]
    rv = []
    for dy, dx in PLANES:
        ok = (ys + dy < height) & (xs + dx >= 0) & (xs + dx < width)
        ty = (ys + dy).clamp(max=height - 1)
        tx = (xs + dx).clamp(0, width - 1)
        rv.append(torch.where(ok, im[:, ty, tx], im))
    rv = torch.stack(rv, dim=-1).reshape(-1)
    ru = im.unsqueeze(-1).expand(*im.shape, 4).reshape(-1)
    return ru, rv


def _best_neighbor(root, w, height: int, width: int, n_all: int):
    """Per region: minimum outgoing edge weight (inf where none) and the
    smallest partner id among the edges of that weight (INT_MAX where
    none)."""
    ru, rv = _endpoints(root, height, width)
    active = ru != rv
    src = torch.cat([ru[active], rv[active]]).long()
    dst = torch.cat([rv[active], ru[active]])
    val = torch.cat([w[active], w[active]])
    best = torch.full((n_all,), float("inf"), device=w.device).scatter_reduce(
        0, src, val, "amin")
    is_best = val == best[src]
    partner = torch.full((n_all,), INT_MAX, dtype=torch.int32,
                         device=w.device).scatter_reduce(
        0, src[is_best], dst[is_best], "amin")
    return best, partner


def _break_two_cycles(nxt: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    two_cycle = (nxt[nxt.long()] == ids) & (ids < nxt)
    return torch.where(two_cycle, ids, nxt)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """The control's cast: float32 rounded to bfloat16 and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def felzenszwalb_labels_flat(images_f01: torch.Tensor, sigma: float = 1.0,
                             k: float = 100.0, min_size: int = 250,
                             max_rounds: int = 48,
                             cast=identity) -> torch.Tensor:
    """The pixel-space version: [B, H, W, C] -> labels [B, H, W] int32
    (each region's id is one of its pixels' flat indices). `cast` is
    applied to the smoothed image (the control's bf16)."""
    b, height, width = images_f01.shape[:3]
    n = height * width
    n_all = b * n
    dev = images_f01.device
    w = edge_weight_planes(cast(smooth_image(images_f01, sigma))).reshape(-1)
    ids = torch.arange(n_all, dtype=torch.int32, device=dev)
    offset = (torch.arange(b, dtype=torch.int32, device=dev) * n)[:, None]
    ones = torch.ones(n_all, dtype=torch.float32, device=dev)

    def segment_size(root, dtype):
        return torch.zeros(n_all, dtype=dtype, device=dev).index_add_(
            0, root.long(), ones.to(dtype))

    # phase 1: criterion rounds
    root = ids
    internal = torch.zeros(n_all, dtype=torch.float32, device=dev)
    for _ in range(max_rounds):
        size = segment_size(root, torch.float32)
        tau = internal + k / torch.clamp(size, min=1.0)
        best, partner = _best_neighbor(root, w, height, width, n_all)
        partner_safe = torch.where(partner < n_all, partner, 0)
        merge = (best < BIG) & (best <= tau) & \
            (best <= tau[partner_safe.long()])
        nxt = _break_two_cycles(torch.where(merge, partner_safe, ids), ids)
        for _ in range(3):  # depth cap 8: deeper chains finish next round
            nxt = nxt[nxt.long()]
        cand = torch.maximum(internal, torch.where(merge, best, 0.0))
        internal = torch.full((n_all,), -float("inf"), device=dev
                              ).scatter_reduce(0, nxt.long(), cand, "amax")
        new_root = nxt[root.long()]
        changed = not torch.equal(new_root, root)
        root = new_root
        if not changed:
            break

    # phase 2: absorb components below min_size along their cheapest edge
    for _ in range(max_rounds):
        size = segment_size(root, torch.int32)
        best, partner = _best_neighbor(root, w, height, width, n_all)
        partner_safe = torch.where(partner < n_all, partner, 0).long()
        small = (size < min_size) & (best < BIG)
        p_size = size[partner_safe]
        ok = small & ((p_size > size)
                      | ((p_size == size) & (partner_safe < ids)))
        mutual_small = small & small[partner_safe] & \
            (partner[partner_safe] == ids)
        nxt = _break_two_cycles(
            torch.where(ok | mutual_small, partner_safe.to(torch.int32), ids),
            ids)
        for _ in range(2):  # depth cap 4
            nxt = nxt[nxt.long()]
        new_root = nxt[root.long()]
        changed = not torch.equal(new_root, root)
        root = new_root
        if not changed:
            break
    return (root.reshape(b, n) - offset).reshape(b, height, width)


def felzenszwalb_labels(images_f01: torch.Tensor, sigma: float = 1.0,
                        k: float = 100.0, min_size: int = 250,
                        max_rounds: int = 48, hier: bool = True,
                        cast=identity) -> torch.Tensor:
    """[B, H, W, C] float [0, 1] -> labels [B, H, W] int32: the
    hierarchical version where the shape admits >= 2 supertile levels (and
    `hier`), else the pixel-space one."""
    from portbench.reference.graph_based_hier import felzenszwalb_labels_hier
    from portbench.reference.multicut_hier import plan_levels

    check_settings(sigma, k, min_size)
    height, width = images_f01.shape[1:3]
    if hier and len(plan_levels(height, width, 8)) >= 2:
        return felzenszwalb_labels_hier(images_f01, sigma=sigma, k=k,
                                        min_size=min_size, cast=cast)
    return felzenszwalb_labels_flat(images_f01, sigma, k, min_size,
                                    max_rounds, cast)


def graph_based_edge_costs(images: torch.Tensor, sigma: float = 1.0,
                           k: float = 100.0, min_size: int = 250,
                           cast=identity) -> torch.Tensor:
    """Edge-cost planes [B, H, W, 2]: connect (1) iff same segment."""
    return edges_from_labels(felzenszwalb_labels(images, sigma, k, min_size,
                                                 cast=cast))
