"""The benchmark's traffic generator: a seeded copy of the port's
mixed-corpus recipe (utils/pattern_generator.py: `mixed_corpus` and the
four mosaic classes it cycles), and the one general reader of the traffic
files beside it.

A traffic file `traffic/<name>.json` names its generator and parameters:
  {"generator": "mixed_corpus", "images": n, "size": side,
   "cells": [c0, c1], "png_level": level}
The corpus is the 4-class cycle sigma, anticorr, mixedmos, flatnoise
(3/4 mosaics that slicing wins on, 1/4 controls where the fallback must
decline), cells c0 for the first cycle of four, c1 for the next, and so
on, all drawn in sequence from one numpy default_rng(seed). Seed 0 gives
the port's `mixed_corpus`, image for image. Every seed gives the same
classes, cell sizes and image sizes in the same order; only the noise, the
cell levels' draws and the flat-noise rectangles differ. The originals are
written by pngcodec.encode at `png_level`.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from portbench import pngcodec

HERE = pathlib.Path(__file__).resolve().parent
MIXED_CYCLE = ("sigma", "anticorr", "mixedmos", "flatnoise")


def _noise_cell(h: int, w: int, sigma: float, mean: float,
                rng: np.random.Generator) -> np.ndarray:
    if sigma <= 0:
        return np.full((h, w, 3), int(mean), np.uint8)
    return np.clip(rng.normal(mean, sigma, (h, w, 3)), 0, 255).astype(np.uint8)


def _anticorr_cell(h: int, w: int, amp: float, base: float,
                   rng: np.random.Generator) -> np.ndarray:
    """High-amplitude per-channel noise that is EXACTLY luma-flat: R and G
    move in a ratio that cancels under the BT.601 weights
    (0.299*0.587a - 0.587*0.299a = 0), so a grayscale edge detector sees
    only the cell borders while the per-channel byte entropy is near-full.
    Models compound images whose parts differ in chroma statistics but not
    luminance (print textures, chroma-noisy camera regions)."""
    u = rng.uniform(-1.0, 1.0, (h, w))
    out = np.empty((h, w, 3))
    out[..., 0] = base + 0.587 * amp * u
    out[..., 1] = base - 0.299 * amp * u
    out[..., 2] = base
    return np.clip(out, 0, 255).astype(np.uint8)


def generate_sigma_mosaic(width: int, height: int, rng: np.random.Generator,
                          cell: int = 64,
                          sigmas=(0.0, 2.0, 5.0, 12.0),
                          means=(50, 110, 170, 230)
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Grid mosaic of i.i.d. noise cells with per-cell sigma cycled so every
    grid row mixes all classes (latin-square-ish). Sigmas stay below Canny's
    hysteresis trigger (blurred sigma*|Sobel| << 150) so cell interiors are
    edge-free while the mean steps mark the borders. Returns (image [H,W,3]
    u8, labels [H,W] int64 — one label per cell)."""
    img = np.zeros((height, width, 3), np.uint8)
    lab = np.zeros((height, width), np.int64)
    k = 0
    for y in range(0, height, cell):
        for x in range(0, width, cell):
            s = sigmas[k % len(sigmas)]
            m = means[(k + k // (width // cell)) % len(means)]
            img[y:y + cell, x:x + cell] = _noise_cell(
                min(cell, height - y), min(cell, width - x), s, m, rng)
            lab[y:y + cell, x:x + cell] = k
            k += 1
    return img, lab


def generate_anticorr_mosaic(width: int, height: int,
                             rng: np.random.Generator, cell: int = 64,
                             amps=(0.0, 40.0, 120.0, 240.0),
                             bases=(60, 110, 160, 210)
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Grid mosaic of luma-flat chroma-noise cells (see _anticorr_cell) with
    amplitude diversity — the per-channel entropy spread (0..~7.5 bits)
    maximizes the whole-image mixture gap that slicing recovers."""
    img = np.zeros((height, width, 3), np.uint8)
    lab = np.zeros((height, width), np.int64)
    k = 0
    for y in range(0, height, cell):
        for x in range(0, width, cell):
            a = amps[k % len(amps)]
            b = bases[(k + k // (width // cell)) % len(bases)]
            img[y:y + cell, x:x + cell] = _anticorr_cell(
                min(cell, height - y), min(cell, width - x), a, b, rng)
            lab[y:y + cell, x:x + cell] = k
            k += 1
    return img, lab


def generate_mixed_mosaic(width: int, height: int, rng: np.random.Generator,
                          cell: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Alternating sigma-noise and chroma-noise cells: the widest statistics
    spread per block, hence the largest estimator-visible headroom."""
    sigmas = (0.0, 3.0, 8.0)
    amps = (60.0, 160.0, 255.0)
    bases = (50, 110, 170, 230)
    img = np.zeros((height, width, 3), np.uint8)
    lab = np.zeros((height, width), np.int64)
    k = 0
    for y in range(0, height, cell):
        for x in range(0, width, cell):
            b = bases[(k + k // (width // cell)) % len(bases)]
            ch, cw = min(cell, height - y), min(cell, width - x)
            if k % 2 == 0:
                patch = _noise_cell(ch, cw, sigmas[(k // 2) % 3], b, rng)
            else:
                patch = _anticorr_cell(ch, cw, amps[(k // 2) % 3], b, rng)
            img[y:y + cell, x:x + cell] = patch
            lab[y:y + cell, x:x + cell] = k
            k += 1
    return img, lab


def generate_flat_noise_composite(width: int, height: int,
                                  rng: np.random.Generator
                                  ) -> tuple[np.ndarray, np.ndarray]:
    """Control class: one uniform-noise rectangle on a flat background.
    Slicing does NOT win here for real (zlib codes the flat part as matches
    either way, and the extra slice container costs bytes) — the corpus
    includes it to check the fallback correctly DECLINES to slice."""
    img = np.full((height, width, 3), int(rng.integers(120, 220)), np.uint8)
    lab = np.zeros((height, width), np.int64)
    h2, w2 = height // 2, width // 2
    y0 = int(rng.integers(0, height - h2))
    x0 = int(rng.integers(0, width - w2))
    img[y0:y0 + h2, x0:x0 + w2] = rng.integers(0, 256, (h2, w2, 3), np.uint8)
    lab[y0:y0 + h2, x0:x0 + w2] = 1
    return img, lab


def mixed_corpus(n: int, size: int, cells=(64, 128), seed: int = 0):
    """Yields (stem, uint8 RGB image [size, size, 3]) for the first n
    images of the mixed corpus drawn from default_rng(seed); stems are
    "<class>_<index:04d>"."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        tag = MIXED_CYCLE[i % len(MIXED_CYCLE)]
        cell = cells[(i // len(MIXED_CYCLE)) % len(cells)]
        if tag == "sigma":
            img, _ = generate_sigma_mosaic(size, size, rng, cell=cell)
        elif tag == "anticorr":
            img, _ = generate_anticorr_mosaic(size, size, rng, cell=cell)
        elif tag == "mixedmos":
            img, _ = generate_mixed_mosaic(size, size, rng, cell=cell)
        else:
            img, _ = generate_flat_noise_composite(size, size, rng)
        yield f"{tag}_{i:04d}", img


GENERATORS = {"mixed_corpus": mixed_corpus}


def load(name: str) -> dict:
    """The parameters of traffic file `traffic/<name>.json`."""
    return json.loads((HERE / f"{name}.json").read_text())


def make(params: dict, seed: int, directory: pathlib.Path) -> dict:
    """Writes the corpus of `params` under `directory` as <stem>.png and
    returns {stem: {"image": uint8 array, "png_bytes": int}} in the order
    of the sorted stems (the order the program lists the files in)."""
    gen = GENERATORS[params["generator"]]
    directory.mkdir(parents=True, exist_ok=True)
    out = {}
    for stem, img in gen(params["images"], params["size"],
                         tuple(params["cells"]), seed):
        data = pngcodec.encode(img, params["png_level"])
        (directory / f"{stem}.png").write_bytes(data)
        out[stem] = {"image": img, "png_bytes": len(data)}
    return dict(sorted(out.items()))
