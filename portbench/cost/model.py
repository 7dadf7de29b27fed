"""Work that the algorithm needs, from problem shapes alone: the EdgeUNet's
floating-point operations and the multicut leaf's least time on the card.
Neither calls the program. The peaks are the published ones (peaks.json).
"""

from __future__ import annotations

import json
import pathlib

PEAKS = json.loads(
    (pathlib.Path(__file__).resolve().parent / "peaks.json").read_text())


def unet_layers(base: int, edge_channels: int = 4):
    """(kind, c_in, c_out, k, scale) for each convolution of the EdgeUNet,
    `scale` the side of its output relative to the input's (1, 1/2, 1/4,
    1/8). A DoubleConv is two 3x3 convolutions; Up is a 2x2 stride-2
    transposed convolution and a DoubleConv over the concatenated skip."""
    c = base
    layers = []

    def double(cin, cout, s):
        layers.extend([("conv", cin, cout, 3, s), ("conv", cout, cout, 3, s)])

    double(3, c, 1)
    double(c, 2 * c, 1 / 2)
    double(2 * c, 4 * c, 1 / 4)
    double(4 * c, 8 * c, 1 / 8)
    for cin, cout, s in ((8 * c, 4 * c, 1 / 4), (4 * c, 2 * c, 1 / 2),
                         (2 * c, c, 1)):
        layers.append(("up", cin, cout, 2, s))
        double(2 * cout, cout, s)
    layers.append(("conv", c, edge_channels, 1, 1))
    return layers


def unet_forward_flops(height: int, width: int, base: int,
                       edge_channels: int = 4) -> float:
    """Multiply-adds x 2 of one image's forward pass (the convolutions;
    GroupNorm, ReLU and pooling are under 1% and left out). A transposed
    2x2 stride-2 convolution does c_in * c_out * 4 multiply-adds per input
    pixel, i.e. c_in * c_out per output pixel."""
    total = 0.0
    for kind, cin, cout, k, s in unet_layers(base, edge_channels):
        pixels = height * width * s * s
        macs = cin * cout * (k * k if kind == "conv" else 1) * pixels
        total += 2.0 * macs
    return total


def leaf_bound_s(t1: int, s1: int, r0: int, r1: int) -> tuple[float, str]:
    """Least seconds an H100 needs for the multicut leaf over t1 supertiles
    (16 x 16 pixels each) at level-1 slots s1 and r0, r1 rounds: the larger
    of the bytes moved (inputs read once, outputs written once) over the HBM
    rate and the f32 operations over the f32 rate. Operations: per round a
    row-maximum scan (S^2 compares) and two aggregation passes (2 S^2
    adds), plus the two passes of each dense re-rank. (The formula of the
    port's chip_smoke.leaf_bound, kept here as the benchmark's.)"""
    bytes_in = 4 * (3 * t1 * 4 * 64 + t1 * 32)
    bytes_out = 4 * (2 * t1 * 4 * 64 + t1 * s1 * s1 + t1 * s1 + 2 * t1)
    ops = t1 * (4 * (r0 * 3 * 64 ** 2 + 2 * 64 ** 2)
                + r1 * 3 * s1 ** 2 + 2 * s1 ** 2)
    t_bytes = (bytes_in + bytes_out) / PEAKS["hbm_bytes_per_s"]
    t_ops = ops / PEAKS["f32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def supertiles(images: int, height: int, width: int) -> int:
    """Level-1 supertiles (16 x 16) that `images` images of H x W need."""
    return images * (height // 16) * (width // 16)
