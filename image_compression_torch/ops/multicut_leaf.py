"""Multicut leaf: hierarchy levels 0-1 of the matrix-aggregation GAEC.

Replaces the one Pallas kernel of the JAX reference package,
ops/multicut_leaf.py::_leaf_kernel (defined at multicut_leaf.py:91, launched
by its `leaf_levels_fused` at :299). TPU kernels of the reference and where
they went:

  | reference (pl.pallas_call)            | port                         |
  | ops/multicut_leaf.py::_leaf_kernel    | csrc/multicut_leaf.cu (CUDA, |
  |   (multicut_leaf.py:91, call :299)    |   sm_90a), `leaf_cuda` here  |

Per 16x16 supertile (four 8x8 children): level 0 builds each child's 64x64
pair matrix from the bf16-rounded horizontal/vertical weights on the +1/+8
bands and runs r0 chain-mode rounds plus the dense re-rank; the level-1
transition offsets the child ranks, freezes ranks >= s1 under their
smallest pixel id, embeds the four children into [s1, s1] and adds the 32
mid-line edges; then r1 rounds.

`leaf_levels_fused` (the glue: child-major tiling, mid-line weights,
untiling) calls `leaf_core`, which launches the CUDA kernel on a CUDA tensor
and runs `leaf_plain`, the plain PyTorch version, on a CPU tensor. There is
no fallback between the two: on a CUDA tensor the kernel launches or the
call raises. Each kernel launch counts "leaf.launches"
(utils/profiling.count).

What bounds the kernel on an H100: it reads ~3 KB and writes ~2 KB plus the
[s1, s1] f32 matrix per supertile — for T1 = 2048 supertiles (8 images of
256x256) at s1 = 64 about 44 MB, ~13 us at 3.35 TB/s. The kernel keeps each
supertile's adjacent region pairs as a sparse list (at most 480 pixel edges)
in ~15 KB of shared memory, one CTA of 128 threads per supertile and one warp
per level-0 child, so that many supertiles are resident on each SM; the
dense [s1, s1] matrix is written only at the end (see the .cu file, which
tests/test_torch_leaf_source.py compiles for the CPU).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from image_compression_torch.ops.multicut_hier import (
    LEAF_MAX_S1, _edge_pairs, _embed_children, _matrix_rounds, _take,
    bf16_round)
from image_compression_torch.utils.profiling import count

S0 = 64  # level-0 slots: the 8x8 pixels of a child tile


def _mid_edge_endpoints() -> tuple[np.ndarray, np.ndarray]:
    """Flat (quad * 64 + slot) index of each mid-line edge's two endpoint
    pixels: 16 horizontal edges (y, 7)-(y, 8), then 16 vertical edges
    (7, x)-(8, x), supertile-local coordinates."""
    def flat(y, x):
        return ((y // 8) * 2 + x // 8) * S0 + (y % 8) * 8 + x % 8

    a = [flat(y, 7) for y in range(16)] + [flat(7, x) for x in range(16)]
    b = [flat(y, 8) for y in range(16)] + [flat(8, x) for x in range(16)]
    return np.asarray(a), np.asarray(b)


def leaf_plain(w0h: torch.Tensor, w0v: torch.Tensor, wmid: torch.Tensor,
               pix: torch.Tensor, s1: int, r0: int, r1: int, n_pix: int):
    """Plain PyTorch version of the leaf kernel, batched over supertiles.

    w0h, w0v [T1, 4, 64] f32 (child-major; weights already zeroed at
    tile-crossing positions), wmid [T1, 32] f32, pix [T1, 4, 64] int32 pixel
    ids, n_pix = H*W (the min-pixel sentinel). Returns rank, gid [T1, 4, 64]
    int32, sym [T1, s1, s1] f32, m [T1, s1] int32, ncand [T1] int32,
    over [T1] int32."""
    t1 = w0h.shape[0]
    dev = w0h.device
    sentinel = n_pix

    # level 0: band-structured pair init, then the rounds, per child
    rows = torch.arange(S0, device=dev)[:, None]
    cols = torch.arange(S0, device=dev)[None, :]
    band_r = ((cols == rows + 1) & (rows % 8 != 7)).to(torch.float32)
    band_d = (cols == rows + 8).to(torch.float32)
    whb = bf16_round(w0h.reshape(t1 * 4, S0))
    wvb = bf16_round(w0v.reshape(t1 * 4, S0))
    sym0 = (whb[:, :, None] * band_r + wvb[:, :, None] * band_d
            + whb[:, None, :] * band_r.T + wvb[:, None, :] * band_d.T)
    sym0, m0, cmap0, nal0 = _matrix_rounds(sym0, pix.reshape(t1 * 4, S0),
                                           r0, sentinel)
    r4 = cmap0.reshape(t1, 4, S0)  # entry ranks = identity => pixel ranks
    nal4 = nal0.reshape(t1, 4)

    # level-1 transition: offsets, freeze, embed, mid-line edges
    offs = torch.cumsum(nal4, dim=1) - nal4
    over = (nal4.sum(dim=1) - s1).clamp(min=0)
    cand = r4 + offs.unsqueeze(-1)
    newly = cand >= s1
    minpix = _take(m0, cmap0).reshape(t1, 4, S0)  # each region's min pixel
    gid = torch.where(newly, minpix, 0).to(torch.int32)
    rank1 = torch.where(newly, -1, cand).reshape(t1, 4 * S0)
    sym1, m1 = _embed_children(sym0.reshape(t1, 4, S0, S0),
                               m0.reshape(t1, 4, S0), offs, s1, sentinel)
    ea, eb = (torch.as_tensor(e, device=dev) for e in _mid_edge_endpoints())
    pair = _edge_pairs(rank1[:, ea], rank1[:, eb], wmid, s1)
    sym1 = sym1 + pair + pair.transpose(1, 2)

    # level-1 rounds, compaction and the pixel remap
    sym1, m1, cmap1, nal1 = _matrix_rounds(sym1, m1, r1, sentinel)
    rank = torch.where(rank1 < 0, -1, _take(cmap1, rank1))
    return (rank.reshape(t1, 4, S0).to(torch.int32), gid, sym1, m1,
            nal1.to(torch.int32), over.to(torch.int32))


def _lib() -> ctypes.CDLL:
    from image_compression_torch import kernels
    lib = kernels.load("multicut_leaf")
    fn = lib.multicut_leaf_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.multicut_leaf_resident.argtypes = []
        lib.multicut_leaf_resident.restype = ctypes.c_int
    return lib


def resident_per_sm() -> int:
    """Supertiles (CTAs) of the kernel resident on one SM, from the CUDA
    occupancy calculator on the current card (the same for every s1)."""
    return int(_lib().multicut_leaf_resident())


def leaf_cuda(w0h: torch.Tensor, w0v: torch.Tensor, wmid: torch.Tensor,
              pix: torch.Tensor, s1: int, r0: int, r1: int, n_pix: int):
    """The CUDA kernel: same contract as `leaf_plain`, one launch over all
    T1 supertiles on the current stream."""
    t1 = w0h.shape[0]
    dev = w0h.device
    for name, t, shape, dtype in (
            ("w0h", w0h, (t1, 4, S0), "f32"), ("w0v", w0v, (t1, 4, S0), "f32"),
            ("wmid", wmid, (t1, 32), "f32"), ("pix", pix, (t1, 4, S0), "i32")):
        want = torch.float32 if dtype == "f32" else torch.int32
        if (t.device != dev or t.dtype != want
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"leaf_cuda: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"leaf_cuda needs CUDA tensors, got {dev}")
    if not 1 <= s1 <= LEAF_MAX_S1:
        raise ValueError(f"leaf_cuda supports 1 <= s1 <= {LEAF_MAX_S1}, "
                         f"got {s1}")
    i32 = dict(dtype=torch.int32, device=dev)
    rank = torch.empty((t1, 4, S0), **i32)
    gid = torch.empty((t1, 4, S0), **i32)
    sym = torch.empty((t1, s1, s1), dtype=torch.float32, device=dev)
    m = torch.empty((t1, s1), **i32)
    ncand = torch.empty((t1,), **i32)
    over = torch.empty((t1,), **i32)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.multicut_leaf_launch(
            w0h.data_ptr(), w0v.data_ptr(), wmid.data_ptr(), pix.data_ptr(),
            rank.data_ptr(), gid.data_ptr(), sym.data_ptr(), m.data_ptr(),
            ncand.data_ptr(), over.data_ptr(), t1, s1, r0, r1, n_pix, stream)
    if err != 0:
        raise RuntimeError(f"multicut_leaf kernel launch failed: "
                           f"cudaError {err}")
    count("leaf.launches")
    return rank, gid, sym, m, ncand, over


def leaf_core(w0h, w0v, wmid, pix, s1: int, r0: int, r1: int, n_pix: int):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if w0h.is_cuda:
        return leaf_cuda(w0h, w0v, wmid, pix, s1, r0, r1, n_pix)
    if w0h.device.type != "cpu":
        raise ValueError(f"multicut leaf: unsupported device {w0h.device}")
    return leaf_plain(w0h, w0v, wmid, pix, s1, r0, r1, n_pix)


def leaf_inputs(costs: torch.Tensor):
    """Kernel inputs from cost planes [B, H, W, 2] (H, W divisible by 16):
    child-major level-0 weights [B*T1, 4, 64] f32, mid-line weights
    [B*T1, 32] f32 and pixel ids [B*T1, 4, 64] int32."""
    b, height, width, _ = costs.shape
    if height % 16 or width % 16:
        raise ValueError(f"multicut leaf needs 16-divisible dims, "
                         f"got {height}x{width}")
    th, tw = height // 16, width // 16
    costs = costs.to(torch.float32)
    dev = costs.device
    xs = torch.arange(width, device=dev)
    ys = torch.arange(height, device=dev)
    wh0 = torch.where((xs % 8 != 7)[None, None, :], costs[..., 0], 0.0)
    wv0 = torch.where((ys % 8 != 7)[None, :, None], costs[..., 1], 0.0)

    def tiles8(img):  # [B, H, W] -> [B*T1, 4, 64] child-major
        return (img.reshape(-1, th, 2, 8, tw, 2, 8)
                .permute(0, 1, 4, 2, 5, 3, 6).reshape(-1, 4, S0).contiguous())

    pix = (ys[:, None] * width + xs[None, :]).to(torch.int32)
    wmid_h = (costs[:, :, 7::16, 0].reshape(b, th, 16, tw)
              .permute(0, 1, 3, 2).reshape(-1, 16))
    wmid_v = costs[:, 7::16, :, 1].reshape(-1, 16)
    return (tiles8(wh0), tiles8(wv0),
            torch.cat([wmid_h, wmid_v], dim=1).contiguous(),
            tiles8(pix.expand(b, height, width)))


def leaf_levels_fused(costs: torch.Tensor, s1: int, r0: int, r1: int):
    """Hierarchy levels 0 (side 8, 64 slots) and 1 (side 16, s1 slots) for a
    batch of cost planes [B, H, W, 2] in one leaf call.

    Returns the loop state the level-by-level path carries entering level 2:
    (rank_img [B, H, W], ncand [B*T1], frozen [B, H, W], final_gid
    [B, H, W], overflow [B], sym [B*T1, s1, s1], m [B*T1, s1])."""
    b, height, width, _ = costs.shape
    th, tw = height // 16, width // 16
    w0h, w0v, wmid, pix = leaf_inputs(costs)
    rank_cm, gid_cm, sym, m, ncand, over = leaf_core(
        w0h, w0v, wmid, pix, s1, r0, r1, height * width)

    def untile(cm):  # [B*T1, 4, 64] child-major -> [B, H, W]
        return (cm.reshape(b, th, tw, 2, 2, 8, 8)
                .permute(0, 1, 3, 5, 2, 4, 6).reshape(b, height, width))

    rank_img = untile(rank_cm)
    overflow = over.reshape(b, -1).sum(dim=1).to(torch.int32)
    return (rank_img, ncand, rank_img < 0, untile(gid_cm), overflow, sym, m)
