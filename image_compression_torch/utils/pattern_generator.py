"""Synthetic images with known compressibility classes.

Port of the reference's utils/pattern_generator.py, numpy only: every
generator draws from the caller's np.random.Generator in the reference's
order, so the same generator state gives the same pixels bit for bit.
The single-statistics classes (GENERATORS: tile repetition, monochrome,
low-variance noise, low-frequency noise, row copies, uniform noise), the
mixed-compressibility composites with their ground-truth partitions
(MOSAIC_GENERATORS), the photo composites (crops of photographs the
caller passes as arrays) and the random connected partition.
"""

from __future__ import annotations

import numpy as np


def generate_repetition_pattern(width: int, height: int, alpha: bool,
                                rng: np.random.Generator,
                                tile: int = 8) -> np.ndarray:
    c = 4 if alpha else 3
    small = rng.integers(0, 256, (tile, tile, c), np.uint8)
    reps = (-(-height // tile), -(-width // tile), 1)
    return np.tile(small, reps)[:height, :width]


def generate_monochrome_region(width: int, height: int, alpha: bool,
                               rng: np.random.Generator) -> np.ndarray:
    c = 4 if alpha else 3
    color = rng.integers(0, 256, (c,), np.uint8)
    return np.broadcast_to(color, (height, width, c)).copy()


def generate_low_variance_noise(width: int, height: int, alpha: bool,
                                rng: np.random.Generator) -> np.ndarray:
    c = 4 if alpha else 3
    mean = rng.integers(50, 201, (c,))
    sigma = rng.integers(2, 9, (c,))
    img = rng.normal(mean, sigma, (height, width, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def generate_low_frequency_noise(width: int, height: int, alpha: bool,
                                 rng: np.random.Generator,
                                 seed_size: int = 32) -> np.ndarray:
    c = 4 if alpha else 3
    mean = rng.integers(50, 201, (c,))
    sigma = rng.integers(2, 21, (c,))
    seed = np.clip(rng.normal(mean, sigma, (seed_size, seed_size, c)), 0, 255)
    # bilinear upscale (reference uses cubic; low-frequency character is what
    # matters for the estimator tests)
    ys = np.linspace(0, seed_size - 1, height)
    xs = np.linspace(0, seed_size - 1, width)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, seed_size - 1)
    x1 = np.minimum(x0 + 1, seed_size - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = ((1 - wy) * (1 - wx) * seed[y0][:, x0]
           + (1 - wy) * wx * seed[y0][:, x1]
           + wy * (1 - wx) * seed[y1][:, x0]
           + wy * wx * seed[y1][:, x1])
    return np.clip(img, 0, 255).astype(np.uint8)


def generate_random_row_copies(width: int, height: int, alpha: bool,
                               rng: np.random.Generator) -> np.ndarray:
    c = 4 if alpha else 3
    row = rng.integers(0, 256, (1, width, c), np.uint8)
    return np.repeat(row, height, axis=0)


def generate_random_noise(width: int, height: int, alpha: bool,
                          rng: np.random.Generator) -> np.ndarray:
    c = 4 if alpha else 3
    return rng.integers(0, 256, (height, width, c), np.uint8)


GENERATORS = {
    "repetition": generate_repetition_pattern,
    "monochrome": generate_monochrome_region,
    "low_variance": generate_low_variance_noise,
    "low_frequency": generate_low_frequency_noise,
    "row_copies": generate_random_row_copies,
    "noise": generate_random_noise,
}


def create_random_patterns(cache_dir, width: int = 1024, height: int = 1024,
                           per_class: int = 100, seed: int = 0) -> int:
    """Populate cache_dir/random_patterns with the five compressibility
    classes x {alpha, no-alpha} (per_class images each, skipping ones that
    already exist). Returns the number of images written."""
    import pathlib

    from image_compression_torch.io.image_io import write_image

    out_dir = pathlib.Path(cache_dir) / "random_patterns"
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    classes = ["repetition", "monochrome", "low_variance", "low_frequency",
               "row_copies"]
    idx = 0
    written = 0
    for name in classes:
        for alpha in (True, False):
            for _ in range(per_class):
                path = out_dir / f"{idx}.png"
                if not path.exists():
                    write_image(path, GENERATORS[name](width, height, alpha,
                                                       rng))
                    written += 1
                idx += 1
    return written


# Mixed-compressibility composites, with the ground-truth partition next to
# the pixels. DEFLATE codes literals with one Huffman table per ~16k-symbol
# block, which spans ~20 rows of a 256-pixel image: where region statistics
# interleave horizontally (mosaic cells, vertical strips) every block pays
# the mixture entropy, and slicing restores per-region tables. The flat +
# noise composite is the control where slicing does not win.


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


def generate_lz_period(width: int, height: int, rng: np.random.Generator,
                       n_strips: int = 3, periods=(48, 64, 80),
                       sigma: float = 10.0, means=(60, 130, 200)
                       ) -> tuple[np.ndarray, np.ndarray]:
    """LZ-window fragmentation class: vertical strips of noise whose rows repeat
    exactly with per-strip vertical period p. In the FULL image the match
    source is p full rows away — p*(3*width+1) stream bytes, outside zlib's
    32768-byte window for p >= 48 at width >= 228 — so DEFLATE codes
    literals at the noise entropy. Each SLICED strip has rows of
    3*(width/n_strips)+1 bytes, putting the same match within the window:
    near-free length-258 matches. Distinct per-strip periods keep the whole
    image aperiodic as a unit; per-strip mean steps give extractors a
    luminance boundary to find while sigma stays below Canny's hysteresis
    trigger (interiors edge-free, like generate_sigma_mosaic). Returns
    (image [H,W,3] u8, labels [H,W] int64 — one label per strip)."""
    img = np.zeros((height, width, 3), np.uint8)
    lab = np.zeros((height, width), np.int64)
    edges = np.linspace(0, width, n_strips + 1).astype(int)
    for s in range(n_strips):
        x0, x1 = edges[s], edges[s + 1]
        p = periods[s % len(periods)]
        m = means[s % len(means)]
        block = np.clip(rng.normal(m, sigma, (p, x1 - x0, 3)),
                        0, 255).astype(np.uint8)
        img[:, x0:x1] = np.tile(block, (height // p + 1, 1, 1))[:height]
        lab[:, x0:x1] = s
    return img, lab


def generate_photo_mosaic(width: int, height: int, photos: list,
                          rng: np.random.Generator, cell: int = 128
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Mosaic whose cells are crops of photographs (arrays [h, w, >=3]
    u8): each cell takes a random crop of a different randomly drawn
    photo, so distinct real regions interleave. Returns (image [H,W,3] u8,
    labels [H,W] int64, one label per cell). As in the reference, a photo
    smaller than a cell raises (its crop does not fill the cell)."""
    img = np.zeros((height, width, 3), np.uint8)
    lab = np.zeros((height, width), np.int64)
    k = 0
    order = rng.permutation(len(photos))
    for y in range(0, height, cell):
        for x in range(0, width, cell):
            src = photos[order[k % len(photos)]]
            ch = min(cell, height - y)
            cw = min(cell, width - x)
            sy = int(rng.integers(0, max(src.shape[0] - ch, 0) + 1))
            sx = int(rng.integers(0, max(src.shape[1] - cw, 0) + 1))
            img[y:y + ch, x:x + cw] = src[sy:sy + ch, sx:sx + cw, :3]
            lab[y:y + ch, x:x + cw] = k
            k += 1
    return img, lab


def generate_photo_collage(width: int, height: int, photos: list,
                           rng: np.random.Generator, n_panels: int = 3
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Photo rectangles pasted on a flat background (a document-style
    compound image); panel sides are clamped to their photo's. Returns
    (image [H,W,3] u8, labels [H,W] int64: 0 background, i + 1 panel
    i)."""
    img = np.full((height, width, 3), int(rng.integers(200, 245)), np.uint8)
    lab = np.zeros((height, width), np.int64)
    order = rng.permutation(len(photos))
    for i in range(n_panels):
        src = photos[order[i % len(photos)]]
        ph = int(rng.integers(height // 4, height // 2))
        pw = int(rng.integers(width // 4, width // 2))
        ph, pw = min(ph, src.shape[0]), min(pw, src.shape[1])
        y0 = int(rng.integers(0, height - ph + 1))
        x0 = int(rng.integers(0, width - pw + 1))
        sy = int(rng.integers(0, src.shape[0] - ph + 1))
        sx = int(rng.integers(0, src.shape[1] - pw + 1))
        img[y0:y0 + ph, x0:x0 + pw] = src[sy:sy + ph, sx:sx + pw, :3]
        lab[y0:y0 + ph, x0:x0 + pw] = i + 1
    return img, lab


MOSAIC_GENERATORS = {
    "sigma_mosaic": generate_sigma_mosaic,
    "anticorr_mosaic": generate_anticorr_mosaic,
    "mixed_mosaic": generate_mixed_mosaic,
    "flat_noise": generate_flat_noise_composite,
    "lz_period": generate_lz_period,
}


MIXED_CYCLE = ("sigma", "anticorr", "mixedmos", "flatnoise")


def mixed_corpus(n: int, size: int, cells: tuple[int, int] = (64, 128)):
    """The first n images of the mixed benchmark corpus at size x size:
    the 4-class cycle sigma, anticorr, mixedmos, flatnoise (3/4 winnable
    mosaics, 1/4 fallback controls), cells[0] for the first cycle of four,
    cells[1] for the next, and so on, all drawn in sequence from one
    default_rng(0) (the recipe of the reference's
    benchmarks/make_mixed_corpus.py). Yields (stem, uint8 RGB image),
    stems "<class>_<index:04d>"."""
    rng = np.random.default_rng(0)
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


def generate_random_partition(height: int, width: int, num_segments: int,
                              seed: int = 0) -> np.ndarray:
    """Multi-seed BFS region growth -> connected random segmentation,
    vectorized as iterative masked dilation with a random per-round
    priority so that regions interleave."""
    rng = np.random.default_rng(seed)
    labels = np.full((height, width), -1, np.int64)
    ys = rng.integers(0, height, num_segments)
    xs = rng.integers(0, width, num_segments)
    labels[ys, xs] = np.arange(num_segments)

    while (labels < 0).any():
        # each unfilled cell adopts a random filled 4-neighbor
        padded = np.pad(labels, 1, constant_values=-1)
        neigh = np.stack([padded[:-2, 1:-1], padded[2:, 1:-1],
                          padded[1:-1, :-2], padded[1:-1, 2:]])
        prio = rng.random(neigh.shape)
        prio[neigh < 0] = -1.0
        pick = np.take_along_axis(
            neigh, prio.argmax(axis=0)[None], axis=0)[0]
        grow = (labels < 0) & (pick >= 0)
        if not grow.any():
            # unreachable cells (can't happen on a 4-connected grid with >=1 seed)
            break
        labels[grow] = pick[grow]
    return labels
