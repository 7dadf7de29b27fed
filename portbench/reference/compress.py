"""The compress cells' plain reference and the comparison that decides
`correct`.

The reference works the cost planes out again from the benchmark's own
images and the raw weights file: the U-Net in float32 (reference/unet.py),
squash and validity masks. It then solves the program's cost planes (as
the program's solver received them in the checked job): the multicut at
the configuration's settings, the single-slice fallback priced against
the originals' bytes, and merge refinement, all in the frozen plain
copies beside this file. It follows the program's costs there because a
solve flips with the last bits of a cost near zero: bfloat16 against
float32 costs changed the partition of 0-6 of 64 images, a float8
control's 13-16, so a partition from its own costs could not tell the two
apart. The U-Net stage is held by mu_gap. The program's answers are the
solver's labels before the fallback, kept in the checked job, and what
the timed job wrote: each image's metadata.bin and slice PNGs, read back
with the benchmark's own decoder.

Numbers compared, each against its limit in limits/<cell>.json:
  lossless_fail   images whose slices do not reassemble to the original
                  pixels (or overlap, or leave a pixel uncovered): 0
  input_mismatch  images the program's U-Net saw other than the original
                  pixels / 255: 0
  mu_gap          the widest gap between the program's and the reference's
                  squashed mu cost planes (padding masked) over the job
  solver_diff     images whose partition (which 4-neighbours share a
                  region) from the program's solver, before the fallback,
                  differs from the reference's multicut of the same costs
  partition_diff  images whose written partition differs from the
                  reference's solve, fallback and merge of the program's
                  costs
  over_bound      images written above their original's bytes plus a
                  one-slice metadata.bin: the product never expands an
                  image by more than the passthrough's record
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np
import torch

from portbench import harness, pngcodec
from portbench.reference import unet
from portbench.reference.edges import edge_validity_masks, squash_mu
from portbench.reference.merge_refine import merge_refine_batch
from portbench.reference.multicut import multicut_grid
from portbench.reference.rewards import estimated_total_sizes_batched

# metadata.bin for one slice: the 16-byte header, one 22-byte entry and
# the 11-byte name "slice_0.png"
ONE_SLICE_RECORD = 16 + 22 + 11


def to_float01(images_u8: np.ndarray, device: str) -> torch.Tensor:
    """uint8 -> float32 in [0, 1], divided on the host (IEEE division;
    a card may multiply by the reciprocal instead)."""
    return torch.as_tensor(images_u8.astype(np.float32) / 255.0).to(device)


def load_weights(config: dict, device: str) -> dict:
    path = harness.ROOT / config["weights"]
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device, torch.float32) for k, v in sd.items()}


def fallback(images, labels, orig_sizes, s: dict):
    """Keep a segmentation only where the size model prices its slices
    below margin x min(the whole image as one slice, the original's
    bytes); otherwise one slice."""
    rw = s["reward"]
    kw = dict(k_max=rw["max_segments"],
              overhead_base=rw["overhead_base"],
              distance_window=rw["distance_window"],
              entropy_correction=rw["entropy_correction"],
              literal_hist=rw["literal_hist"])
    est_sliced = estimated_total_sizes_batched(images, labels, **kw)
    est_whole = estimated_total_sizes_batched(
        images, torch.zeros_like(labels), **kw)
    est_whole = torch.minimum(est_whole, orig_sizes.to(torch.float32))
    keep = est_sliced < s["fallback_margin"] * est_whole
    return torch.where(keep[:, None, None], labels, 0)


@torch.no_grad()
def reference_costs(sd: dict, images_u8: np.ndarray, device: str,
                    cast=unet.identity) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> the U-Net's mu cost planes [B, H, W, 2]
    (squashed, padding masked) in float32, or with cast=unet.fp8 the
    control's."""
    x = to_float01(images_u8, device)
    with unet.no_tf32():
        raw = unet.forward(sd, x, cast)
    return mu_planes(raw)


def mu_planes(raw: torch.Tensor) -> torch.Tensor:
    """Raw U-Net output [B, H, W, 4] -> squashed mu planes, masked."""
    h, w = raw.shape[1:3]
    return squash_mu(torch.stack([raw[..., 0], raw[..., 2]], -1).float()) \
        * edge_validity_masks(h, w, device=raw.device)


@torch.no_grad()
def reference_solve(costs: torch.Tensor, settings: dict) -> torch.Tensor:
    """The multicut of `costs` at the configuration's settings -> labels
    [B, H, W]."""
    mc = settings["multicut"]
    return multicut_grid(
        costs, max_rounds=mc["max_rounds"], mode=mc["mode"],
        icm_sweeps=mc["icm_sweeps"],
        matchings_per_round=mc["matchings_per_round"],
        hier_rounds=tuple(mc["hier_rounds"]), hier_caps=mc["hier_caps"],
        hier_agg=mc["hier_agg"], hier_leaf=mc["hier_leaf"])


@torch.no_grad()
def reference_finish(images_u8: np.ndarray, labels: torch.Tensor, orig_sizes,
                     settings: dict) -> torch.Tensor:
    """The fallback and merge refinement of solved `labels`."""
    device = labels.device
    x = to_float01(images_u8, device)
    if settings["compress_fallback"]:
        labels = fallback(x, labels, torch.as_tensor(
            orig_sizes, dtype=torch.float32, device=device), settings)
    rw = settings["reward"]
    if settings["merge_refine_rounds"]:
        labels = merge_refine_batch(
            x, labels, k_max=rw["max_segments"],
            rounds=settings["merge_refine_rounds"],
            overhead_base=rw["overhead_base"],
            entropy_correction=rw["entropy_correction"],
            literal_hist=rw["literal_hist"],
            distance_window=rw["distance_window"])
    return labels


def reference_labels(images_u8: np.ndarray, costs: torch.Tensor, orig_sizes,
                     settings: dict) -> torch.Tensor:
    """The multicut of `costs`, the fallback and merge refinement ->
    labels [B, H, W]."""
    return reference_finish(images_u8, reference_solve(costs, settings),
                            orig_sizes, settings)


def same_region(labels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Which horizontal and vertical neighbours share a region."""
    return labels[:, :-1] == labels[:, 1:], labels[:-1, :] == labels[1:, :]


def read_output(directory: pathlib.Path, original: np.ndarray):
    """An image's slice directory -> (region map [H, W] or None, lossless):
    each slice is a bbox crop, RGB where its region fills the bbox, else
    RGBA with the region opaque and the rest transparent. A directory that
    is missing or does not read back is (None, False)."""
    try:
        return _read_output(directory, original)
    except (OSError, ValueError, struct.error, zlib.error):
        return None, False


def _read_output(directory: pathlib.Path, original: np.ndarray):
    data = (directory / "metadata.bin").read_bytes()
    magic, count, width, height = struct.unpack_from("<IIII", data, 0)
    h, w = original.shape[:2]
    if magic != 0x534C4943 or (height, width) != (h, w):
        return None, False
    region = np.full((h, w), -1, np.int64)
    canvas = np.zeros((h, w, 3), np.uint8)
    pos = 16
    for i in range(count):
        _label, x, y, sw, sh, nlen = struct.unpack_from("<iiiiiH", data, pos)
        pos += 22
        name = data[pos:pos + nlen].decode()
        pos += nlen
        px = pngcodec.decode((directory / name).read_bytes())
        if px.shape[:2] != (sh, sw) or x < 0 or y < 0 or x + sw > w \
                or y + sh > h:
            return None, False
        mask = (np.ones((sh, sw), bool) if px.shape[2] == 3
                else px[..., 3] > 0)
        if px.shape[2] == 4 and not (px[..., 3][mask] == 255).all():
            return None, False
        sub = region[y:y + sh, x:x + sw]
        if (sub[mask] >= 0).any():
            return None, False  # two slices claim a pixel
        sub[mask] = i
        canvas[y:y + sh, x:x + sw][mask] = px[..., :3][mask]
    if (region < 0).any():
        return None, False
    return region, bool((canvas == original).all())


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    ah, av = same_region(a)
    bh, bv = same_region(b)
    return bool((ah == bh).all() and (av == bv).all())


def check(spec: dict, corpus: dict, job_dir: pathlib.Path, captured: list,
          solved: list, device: str) -> dict:
    """The numbers of the checked job: `captured` holds the U-Net's
    (input, output) of each batch, `solved` the solver's (costs, labels)."""
    config, limits = spec["config"], spec["limits"]
    settings = config["settings"]
    stems = list(corpus)
    bs = config["batch_size"]
    sd = load_weights(config, device)
    n = dict.fromkeys(("lossless_fail", "input_mismatch", "solver_diff",
                       "partition_diff", "over_bound"), 0)
    mu_gap = 0.0
    for b0 in range(0, len(stems), bs):
        batch = stems[b0:b0 + bs]
        imgs = np.stack([corpus[s]["image"] for s in batch])
        sizes = [corpus[s]["png_bytes"] for s in batch]
        got_in, got_out = captured[b0 // bs]
        n["input_mismatch"] += int(
            (got_in[:len(batch)] != to_float01(imgs, device))
            .flatten(1).any(1).sum())
        mu_gap = max(mu_gap, float((mu_planes(got_out[:len(batch)])
                                    - reference_costs(sd, imgs, device))
                                   .abs().max()))
        costs, got_solve = solved[b0 // bs]
        solve = reference_solve(costs[:len(batch)].to(device), settings)
        labels = reference_finish(imgs, solve, sizes, settings).cpu().numpy()
        solve, got_solve = solve.cpu().numpy(), got_solve.cpu().numpy()
        for i, stem in enumerate(batch):
            n["solver_diff"] += not same_partition(got_solve[i], solve[i])
            out = job_dir / stem
            n["over_bound"] += (out.is_dir() and sum(
                f.stat().st_size for f in out.iterdir())
                > corpus[stem]["png_bytes"] + ONE_SLICE_RECORD)
            region, lossless = read_output(out, corpus[stem]["image"])
            n["lossless_fail"] += not lossless
            n["partition_diff"] += (region is None
                                    or not same_partition(region, labels[i]))
    c = harness.check
    out = {k: c(v, limits[k]) for k, v in n.items()}
    out["mu_gap"] = c(mu_gap, limits["mu_gap"])
    return out


def control(spec: dict, corpus: dict, device: str) -> dict:
    """The control: the reference's U-Net at float8 put in the program's
    place, its cost planes compared with the float32 reference's (its
    partition is the reference's own solve of them, so partition_diff
    reads 0 by construction and is not reported)."""
    config = spec["config"]
    stems = list(corpus)
    bs = config["batch_size"]
    sd = load_weights(config, device)
    mu_gap = 0.0
    for b0 in range(0, len(stems), bs):
        imgs = np.stack([corpus[s]["image"] for s in stems[b0:b0 + bs]])
        mu_gap = max(mu_gap, float(
            (reference_costs(sd, imgs, device, unet.fp8)
             - reference_costs(sd, imgs, device)).abs().max()))
    return {"mu_gap": mu_gap}
