"""Compress pipeline: images -> edge costs -> multicut -> fallback decision
-> merge refinement -> slice PNGs + metadata.bin (or one pack per image).

Port of the reference's pipeline.py. Edge costs come from the U-Net
(learned) or from a classical extractor (CANNY, GRAPH, SLIC, WATERSHED:
{0, 1} planes made signed). The device half (costs, solver, size model,
connectivity wire) runs batched on `device`; slicing and PNG encoding run
on the host. The order solver -> fallback -> merge is the reference's, and
it is measured: merging before the keep decision flips borderline images
across the original-size floor, so the decision runs on the un-merged
partition and merge refinement only on the kept slicings (a declined image
is all-zero labels, a no-op there). `compress_directory` overlaps the two
halves as the reference does: batch i is sliced and written in a worker
thread while batch i + 1's device half runs.
"""

from __future__ import annotations

import pathlib
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from image_compression_torch.config import Config, EdgeTarget
from image_compression_torch.device import resolve_device
from image_compression_torch.io.image_io import (find_image_files_recursively,
                                                 load_image, to_float01_rgb)
from image_compression_torch.io.metadata import (SliceMetadata,
                                                 write_metadata_binary)
from image_compression_torch.io.pack import write_pack
from image_compression_torch.io.slicer import write_slices_from_conn
from image_compression_torch.models.unet import EdgeUNet
from image_compression_torch.ops.edges import (edge_validity_masks,
                                               split_model_output, squash_mu)
from image_compression_torch.ops.labels_wire import pack_connectivity
from image_compression_torch.ops.merge_refine import merge_refine_batch
from image_compression_torch.ops.multicut import multicut_grid
from image_compression_torch.ops.rewards import estimated_total_sizes_batched
from image_compression_torch.ops.targets import compute_edge_costs


def classical_costs_signed(images: torch.Tensor,
                           target: EdgeTarget) -> torch.Tensor:
    """Classical {0, 1} connect/cut planes -> signed multicut costs
    {-1, +1} with padding masked to 0 (the checkpoint-free compress path)."""
    costs01 = compute_edge_costs(images, target)
    height, width = costs01.shape[-3], costs01.shape[-2]
    return (2.0 * costs01 - 1.0) * edge_validity_masks(
        height, width, device=costs01.device)


def learned_costs(model: EdgeUNet, images: torch.Tensor,
                  mu_scale: float = 2.0) -> torch.Tensor:
    """U-Net forward -> deterministic mu cost planes [B, H, W, 2], padding
    masked to 0."""
    out = model(images)
    mu_raw, _ = split_model_output(out)
    height, width = out.shape[1:3]
    return squash_mu(mu_raw, mu_scale) * edge_validity_masks(
        height, width, device=out.device)


def segment_batch(costs_bhw2: torch.Tensor, mode: str = "chain",
                  max_rounds: int = 3, icm_sweeps: int = 0,
                  hier_rounds: tuple | None = None,
                  hier_caps: str | None = None, hier_agg: str = "matrix",
                  hier_leaf: str = "auto",
                  matchings_per_round: int = 4) -> torch.Tensor:
    """Batched multicut over cost planes -> labels [B, H, W] int32. Takes
    every solver setting the reference's segment_batch takes; unknown values
    raise ValueError (ops/multicut.multicut_grid)."""
    return multicut_grid(costs_bhw2, max_rounds=max_rounds, mode=mode,
                         icm_sweeps=icm_sweeps,
                         matchings_per_round=matchings_per_round,
                         hier_rounds=hier_rounds, hier_caps=hier_caps,
                         hier_agg=hier_agg, hier_leaf=hier_leaf)


def fallback_single_slice(images_f01: torch.Tensor, labels: torch.Tensor,
                          margin: float, k_max: int = 64,
                          entropy_correction: str = "none",
                          literal_hist: str = "all",
                          overhead_base: float = 9.308622,
                          distance_window: int = 0,
                          orig_sizes: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Per-image single-slice fallback: keep a segmentation only when the
    size model prices its slices below margin x the whole image as one
    slice (and, with orig_sizes, below the source file's bytes, which a
    passthrough copies verbatim); otherwise zero the labels (one
    full-canvas slice). Both sides price RGBA and use minlabel stats."""
    kw = dict(k_max=k_max, minlabel=True, overhead_base=overhead_base,
              distance_window=distance_window,
              entropy_correction=entropy_correction,
              literal_hist=literal_hist)
    est_sliced = estimated_total_sizes_batched(images_f01, labels, **kw)
    est_whole = estimated_total_sizes_batched(
        images_f01, torch.zeros_like(labels), **kw)
    if orig_sizes is not None:
        est_whole = torch.minimum(est_whole, orig_sizes.to(torch.float32))
    keep = est_sliced < margin * est_whole
    return torch.where(keep[:, None, None], labels, 0)


class _StageClock:
    """Per-stage seconds into `timings` (when given), synchronizing the
    device at each mark so a stage owns its device work."""

    def __init__(self, timings: dict | None, device: torch.device):
        self.timings = timings
        self.device = device
        self.t = time.perf_counter()

    def mark(self, stage: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + now - self.t
        self.t = now


def _device_labels(images_u8: list[np.ndarray], cost_fn: Callable,
                   cfg: Config, device: torch.device, orig_sizes=None,
                   clock: _StageClock | None = None) -> torch.Tensor:
    """The device half of compress for one batch -> labels [B, H, W]."""
    clock = clock or _StageClock(None, device)
    batch = torch.as_tensor(
        np.stack([to_float01_rgb(im) for im in images_u8])).to(device)
    costs = cost_fn(batch)
    clock.mark("costs")
    mc = cfg.multicut
    labels = segment_batch(
        costs, mode=mc.mode, max_rounds=mc.max_rounds,
        icm_sweeps=mc.icm_sweeps,
        hier_rounds=tuple(mc.hier_rounds) if mc.hier_rounds else None,
        hier_caps=mc.hier_caps, hier_agg=mc.hier_agg, hier_leaf=mc.hier_leaf,
        matchings_per_round=mc.matchings_per_round)
    clock.mark("solver")
    rw = cfg.reward
    if cfg.compress_fallback:
        labels = fallback_single_slice(
            batch, labels, cfg.fallback_margin, k_max=rw.max_segments,
            entropy_correction=rw.entropy_correction,
            literal_hist=rw.literal_hist, overhead_base=rw.overhead_base,
            distance_window=rw.distance_window,
            orig_sizes=(torch.as_tensor(orig_sizes, dtype=torch.float32,
                                        device=device)
                        if orig_sizes is not None else None))
    clock.mark("fallback")
    # ORDER MATTERS (module docstring): merge only after the decision
    if cfg.merge_refine_rounds:
        labels = merge_refine_batch(
            batch, labels, k_max=rw.max_segments,
            rounds=cfg.merge_refine_rounds, overhead_base=rw.overhead_base,
            entropy_correction=rw.entropy_correction,
            literal_hist=rw.literal_hist,
            distance_window=rw.distance_window)
    clock.mark("merge")
    return labels


def _pack_wire(labels: torch.Tensor):
    """Device -> host wire: 2-bit/pixel connectivity planes and a per-image
    single-slice flag, as numpy arrays."""
    hbits, vbits = pack_connectivity(labels)
    single = (labels == 0).all(dim=2).all(dim=1)
    return hbits.cpu().numpy(), vbits.cpu().numpy(), single.cpu().numpy()


def write_passthrough(src_path: str | pathlib.Path,
                      shape_hw: tuple[int, int],
                      results_dir: str | pathlib.Path, name: str,
                      container: str = "files") -> pathlib.Path:
    """Emit the source PNG verbatim as the single full-canvas slice (a
    fallen-back image whose source is a PNG of the same pixels), as a
    slice directory or as a one-slice pack."""
    height, width = shape_hw
    meta = [SliceMetadata(label=0, filename="slice_0.png", x=0, y=0,
                          width=width, height=height)]
    if container == "pack":
        out = pathlib.Path(results_dir) / f"{name}.pack"
        out.parent.mkdir(parents=True, exist_ok=True)
        write_pack(out, meta, [pathlib.Path(src_path).read_bytes()], width,
                   height)
        return out
    out = pathlib.Path(results_dir) / name
    out.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src_path, out / "slice_0.png")
    write_metadata_binary(meta, out / "metadata.bin", width, height)
    return out


def _write_batch(images_u8: list[np.ndarray], wire, cfg: Config,
                 results_dir: str | pathlib.Path, names: list[str | None],
                 src_paths: list | None = None) -> list[pathlib.Path]:
    """Host half of compress for one batch: slice + write from the wire
    into cfg.slice_container ("files" or "pack"). With src_paths, a
    fallen-back image copies its source PNG instead of re-encoding it.
    Returns each image's slice directory or pack file; a failed write
    raises OSError."""
    hbits, vbits, single = wire
    pack = cfg.slice_container == "pack"
    out_dirs = []
    for i, (img, name) in enumerate(zip(images_u8, names)):
        if name is None:  # batch padding entry
            continue
        src = src_paths[i] if src_paths else None
        if src is not None and cfg.compress_fallback and single[i]:
            out_dirs.append(write_passthrough(
                src, img.shape[:2], results_dir, name,
                container=cfg.slice_container))
            continue
        write_slices_from_conn(img, hbits[i], vbits[i], results_dir, name,
                               cfg.image_format, cfg.compression_level,
                               container=cfg.slice_container)
        out_dirs.append(pathlib.Path(results_dir)
                        / (f"{name}.pack" if pack else name))
    return out_dirs


def compress_arrays(images_u8: list[np.ndarray], cost_fn: Callable,
                    cfg: Config, results_dir: str | pathlib.Path,
                    names: list[str], device: str | torch.device = "cuda",
                    timings: dict | None = None) -> list[pathlib.Path]:
    """Compress a list of equally sized uint8 HWC images as one batch on
    `device`; returns the per-image output directories (or pack files).
    cost_fn maps the float [B, H, W, 3] batch on the device to cost planes
    [B, H, W, 2] (learned_costs, or classical_costs_signed for a classical
    extractor). With `timings`, per-stage seconds (costs, solver, fallback,
    merge, wire, write) are added into it."""
    dev = resolve_device(device)
    clock = _StageClock(timings, dev)
    with torch.inference_mode():
        labels = _device_labels(images_u8, cost_fn, cfg, dev, clock=clock)
        wire = _pack_wire(labels)
    clock.mark("wire")
    out = _write_batch(images_u8, wire, cfg, results_dir, names)
    clock.mark("write")
    return out


def image_dims(path: pathlib.Path) -> tuple[int, int]:
    """(H, W) from the PNG IHDR without decoding pixel data."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
        return (int.from_bytes(head[20:24], "big"),
                int.from_bytes(head[16:20], "big"))
    return load_image(path).shape[:2]


def _timed_write(*args, **kwargs) -> tuple[list[pathlib.Path], float]:
    t0 = time.perf_counter()
    out = _write_batch(*args, **kwargs)
    return out, time.perf_counter() - t0


def compress_directory(cfg: Config, model: EdgeUNet | None = None,
                       limit: int | None = None,
                       classical: EdgeTarget | None = None,
                       batch_size: int = 8,
                       device: str | torch.device = "cuda",
                       timings: dict | None = None) -> list[pathlib.Path]:
    """The `compress` entry point: scan cfg.dataset_dir, segment every image
    and write slices + metadata into cfg.results_dir/<stem>/ (or
    <stem>.pack). With `model`, the U-Net's learned costs (the model is
    moved to `device`); otherwise the `classical` extractor's, CANNY when
    none is named. Images are bucketed by shape and batched (trailing
    batches padded by repetition); a fallen-back image copies its source
    PNG. Batch i is sliced and written in a worker thread while batch
    i + 1's device half runs; the outputs are those of a serial run, and a
    write failure raises here. With `timings`, per-stage seconds are added
    into it: the device stages as in compress_arrays, "write" summed over
    the worker's batches (it overlaps the device stages)."""
    dev = resolve_device(device)
    paths = find_image_files_recursively(cfg.dataset_dir, cfg.image_format)
    if limit:
        paths = paths[:limit]
    print(f"Found {len(paths)} images")
    if model is not None:
        model = model.to(dev).eval()

        def cost_fn(b):
            return learned_costs(model, b)
    else:
        target = classical or EdgeTarget.CANNY

        def cost_fn(b):
            return classical_costs_signed(b, target)

    by_shape: dict[tuple[int, int], list[pathlib.Path]] = {}
    for path in paths:
        by_shape.setdefault(image_dims(path), []).append(path)
    clock = _StageClock(timings, dev)
    out: list[pathlib.Path] = []
    pending = None  # the future of the previous batch's write

    def collect(fut):
        dirs, seconds = fut.result()  # re-raises the worker's failure
        out.extend(dirs)
        if timings is not None:
            timings["write"] = timings.get("write", 0.0) + seconds

    with ThreadPoolExecutor(1) as pool:
        for _shape, group in sorted(by_shape.items()):
            for i in range(0, len(group), batch_size):
                chunk = group[i:i + batch_size]
                imgs = [load_image(p) for p in chunk]
                pad = batch_size - len(chunk) if len(group) > batch_size \
                    else 0
                sizes = [p.stat().st_size for p in chunk]
                sizes += sizes[-1:] * pad
                clock.t = time.perf_counter()
                with torch.inference_mode():
                    labels = _device_labels(imgs + imgs[-1:] * pad, cost_fn,
                                            cfg, dev, orig_sizes=sizes,
                                            clock=clock)
                    wire = _pack_wire(labels)
                clock.mark("wire")
                if pending is not None:
                    collect(pending)
                pending = pool.submit(
                    _timed_write, imgs + imgs[-1:] * pad, wire, cfg,
                    cfg.results_dir, [p.stem for p in chunk] + [None] * pad,
                    src_paths=list(chunk) + [None] * pad)
        if pending is not None:
            collect(pending)
    return out
