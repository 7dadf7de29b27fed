"""Compact device->host label wire: bit-packed connectivity planes.

A multicut labeling of a grid is determined by its inter-pixel
connectivity: two 1-bit planes (horizontal (y,x)-(y,x+1), vertical
(y,x)-(y+1,x)), packed 8 per byte LSB-first (bit k of byte j in row y covers
column 8*j + k). Both planes are [H, ceil(W/8)]; the horizontal plane's last
column and the vertical plane's last row are zero padding. The host rebuilds
the minlabel ids by connected components. Port of the reference's
ops/labels_wire.py; the bytes are identical.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pack_connectivity(labels_bhw: torch.Tensor):
    """labels [..., H, W] int -> (hbits, vbits) uint8 [..., H, ceil(W/8)]."""
    width = labels_bhw.shape[-1]
    stride = -(-width // 8)
    pad_w = stride * 8 - width
    h_conn = (labels_bhw[..., :, :-1] == labels_bhw[..., :, 1:]).to(
        torch.uint8)
    v_conn = (labels_bhw[..., :-1, :] == labels_bhw[..., 1:, :]).to(
        torch.uint8)
    h_conn = F.pad(h_conn, (0, 1 + pad_w))
    v_conn = F.pad(v_conn, (0, pad_w, 0, 1))
    weights = (2 ** torch.arange(8, device=labels_bhw.device)).to(torch.int32)

    def pack(bits):
        b8 = bits.reshape(bits.shape[:-1] + (stride, 8)).to(torch.int32)
        return (b8 * weights).sum(dim=-1).to(torch.uint8)

    return pack(h_conn), pack(v_conn)


def unpack_connectivity(hbits: np.ndarray, vbits: np.ndarray,
                        width: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side unpack: (hconn, vconn) bool [H, W]."""
    hconn = np.unpackbits(hbits, axis=-1, bitorder="little")[:, :width] > 0
    vconn = np.unpackbits(vbits, axis=-1, bitorder="little")[:, :width] > 0
    return hconn, vconn


def labels_from_connectivity(hbits: np.ndarray, vbits: np.ndarray,
                             height: int, width: int) -> np.ndarray:
    """Minlabel ids int32 [H, W] from the connectivity planes: doubled-grid
    connected components (pixels at even coordinates, connectivity bits as
    the nodes between them), each relabelled by its smallest flat pixel
    index."""
    from scipy import ndimage

    hconn, vconn = unpack_connectivity(hbits, vbits, width)
    grid = np.zeros((2 * height - 1, 2 * width - 1), bool)
    grid[::2, ::2] = True
    grid[::2, 1::2] = hconn[:, :width - 1]
    grid[1::2, ::2] = vconn[:height - 1, :]
    cc, ncc = ndimage.label(grid)
    cc_pix = cc[::2, ::2]
    flat = np.arange(height * width, dtype=np.int64).reshape(height, width)
    minlab = ndimage.minimum(flat, labels=cc_pix,
                             index=np.arange(1, ncc + 1))
    return np.asarray(minlab, np.int32)[cc_pix - 1]
