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

Never-expand guard (a product departure: the reference only predicts that
a kept slicing is smaller). With the fallback on and a source file to copy,
the writer gives the slice writer the passthrough's size (the source's
bytes plus a one-slice metadata.bin, 49 bytes; in a pack also the pack's
framing) as a byte budget: a kept slicing over it is not left written, and
the passthrough is written instead. It reads only host data: no kernel, no
device sync. Declined images never reach it, and where it does not fire the
bytes are those of the reference.
"""

from __future__ import annotations

import contextlib
import functools
import os
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
from image_compression_torch.io.pack import pack_bytes, write_pack
from image_compression_torch.io.slicer import write_slices_from_conn
from image_compression_torch.models.unet import EdgeUNet
from image_compression_torch.ops.edges import (edge_validity_masks,
                                               split_model_output, squash_mu)
from image_compression_torch.ops.labels_wire import pack_connectivity
from image_compression_torch.ops.merge_refine import merge_refine_batch
from image_compression_torch.ops.multicut import multicut_grid
from image_compression_torch.ops.rewards import estimated_total_sizes_batched
from image_compression_torch.ops.targets import compute_edge_costs
from image_compression_torch.utils.profiling import (StageClock, count, span,
                                                     tracing)


def classical_costs_signed(images: torch.Tensor,
                           target: EdgeTarget) -> torch.Tensor:
    """Classical {0, 1} connect/cut planes -> signed multicut costs
    {-1, +1} with padding masked to 0 (the checkpoint-free compress path).
    Traced, the GRAPH extractor is the span "graph"."""
    with (span("graph", images.device) if target is EdgeTarget.GRAPH
          else contextlib.nullcontext()):
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


# the host dtype each image depth is stacked in: 8-bit as it is, 16-bit
# widened to int32 (an index the gather takes), float32 as it is
_HOST_DTYPES = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.uint16): torch.int32,
                np.dtype(np.float32): torch.float32}


def _rgb(image_hwc: np.ndarray) -> np.ndarray:
    """The pixels to_float01_rgb converts, unconverted: an HWC view with
    alpha dropped, gray left as one channel (broadcast to three where it is
    assigned). Raises what to_float01_rgb raises on other channel counts
    and dtypes."""
    arr = image_hwc if image_hwc.ndim == 3 else image_hwc[:, :, None]
    c = arr.shape[2]
    if c not in (1, 3, 4):
        raise ValueError(f"unsupported channel count: {c}")
    if arr.dtype not in _HOST_DTYPES:
        raise ValueError(f"unsupported dtype: {arr.dtype}")
    return arr[:, :, :3]


@functools.cache
def _float01_table(depth: np.dtype, device: torch.device) -> torch.Tensor:
    """to_float01_rgb of every value of the integer dtype `depth` (256 or
    65,536 entries), float32 on `device`: each entry is the host's
    conversion of its value, bit for bit. One per depth and device, kept
    for the life of the process."""
    values = np.arange(np.iinfo(depth).max + 1, dtype=depth)
    return torch.from_numpy(np.ascontiguousarray(
        to_float01_rgb(values[None, :, None])[0, :, 0])).to(device)


def _float01_stack(rgb: list[np.ndarray],
                   device: torch.device) -> torch.Tensor:
    """Equally sized images of one depth, as _rgb gives them -> float32
    [B, H, W, 3] on `device`: stacked as they are on the host, in
    page-locked memory for a CUDA device (the upload does not wait for
    it), then, for an integer depth, gathered from its _float01_table on
    the device."""
    depth = rgb[0].dtype
    host = torch.empty((len(rgb), *rgb[0].shape[:2], 3),
                       dtype=_HOST_DTYPES[depth],
                       pin_memory=device.type == "cuda")
    stacked = host.numpy()
    for i, im in enumerate(rgb):
        stacked[i] = im
    part = host.to(device, non_blocking=True)
    if depth == np.float32:
        return part
    return _float01_table(depth, device).index_select(
        0, part.int().view(-1)).view(part.shape)


def _float01_batch(images: list[np.ndarray],
                   device: torch.device) -> torch.Tensor:
    """Equally sized images -> their float32 RGB batch [B, H, W, 3] on
    `device`, bit for bit torch.as_tensor(np.stack([to_float01_rgb(im) for
    im in images])): integer pixels become float32 on the device by a
    gather from their depth's table, never by a division, so the values do
    not depend on how the device divides (_float01_stack). A batch that
    mixes depths converts each depth's images apart and puts them back in
    their places."""
    rgb = [_rgb(im) for im in images]
    depths = {im.dtype for im in rgb}
    if len(depths) == 1:
        return _float01_stack(rgb, device)
    batch = torch.empty((len(rgb), *rgb[0].shape[:2], 3),
                        dtype=torch.float32, device=device)
    for depth in depths:
        members = [i for i, im in enumerate(rgb) if im.dtype == depth]
        part = _float01_stack([rgb[i] for i in members], device)
        for j, i in enumerate(members):
            batch[i] = part[j]
    return batch


def _device_labels(images_u8: list[np.ndarray], cost_fn: Callable,
                   cfg: Config, device: torch.device, orig_sizes=None,
                   clock: StageClock | None = None) -> torch.Tensor:
    """The device half of compress for one batch -> labels [B, H, W].
    Traced, the batch's preparation (_float01_batch) is the host span
    "costs.input" inside "costs"."""
    clock = clock or StageClock(None, device)
    with clock.stage("costs"):
        with span("costs.input"):
            batch = _float01_batch(images_u8, device)
        costs = cost_fn(batch)
    mc = cfg.multicut
    with clock.stage("solver"):
        labels = segment_batch(
            costs, mode=mc.mode, max_rounds=mc.max_rounds,
            icm_sweeps=mc.icm_sweeps,
            hier_rounds=tuple(mc.hier_rounds) if mc.hier_rounds else None,
            hier_caps=mc.hier_caps, hier_agg=mc.hier_agg,
            hier_leaf=mc.hier_leaf,
            matchings_per_round=mc.matchings_per_round)
    rw = cfg.reward
    with clock.stage("fallback"):
        if cfg.compress_fallback:
            labels = fallback_single_slice(
                batch, labels, cfg.fallback_margin, k_max=rw.max_segments,
                entropy_correction=rw.entropy_correction,
                literal_hist=rw.literal_hist, overhead_base=rw.overhead_base,
                distance_window=rw.distance_window,
                orig_sizes=(torch.as_tensor(orig_sizes, dtype=torch.float32,
                                            device=device)
                            if orig_sizes is not None else None))
    # ORDER MATTERS (module docstring): merge only after the decision
    with clock.stage("merge"):
        if cfg.merge_refine_rounds:
            labels = merge_refine_batch(
                batch, labels, k_max=rw.max_segments,
                rounds=cfg.merge_refine_rounds,
                overhead_base=rw.overhead_base,
                entropy_correction=rw.entropy_correction,
                literal_hist=rw.literal_hist,
                distance_window=rw.distance_window)
    return labels


def _pack_wire(labels: torch.Tensor):
    """Device -> host wire: 2-bit/pixel connectivity planes and a per-image
    single-slice flag, as numpy arrays."""
    hbits, vbits = pack_connectivity(labels)
    single = (labels == 0).all(dim=2).all(dim=1)
    return hbits.cpu().numpy(), vbits.cpu().numpy(), single.cpu().numpy()


# metadata.bin of one slice: the 16-byte header, one 22-byte entry and the
# 11-byte name "slice_0.png"
ONE_SLICE_RECORD = 16 + 22 + 11


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


def _passthrough_bytes(src: str | pathlib.Path, container: str) -> int:
    """Bytes write_passthrough writes for the source file `src`."""
    src_bytes = os.stat(src).st_size
    if container == "pack":
        return pack_bytes(ONE_SLICE_RECORD, [src_bytes])
    return src_bytes + ONE_SLICE_RECORD


def _write_batch(images_u8: list[np.ndarray], wire, cfg: Config,
                 results_dir: str | pathlib.Path, names: list[str | None],
                 src_paths: list | None = None) -> list[pathlib.Path]:
    """Host half of compress for one batch: slice + write from the wire
    into cfg.slice_container ("files" or "pack"). With src_paths and the
    fallback on, a fallen-back image copies its source PNG instead of
    re-encoding it, and so does a kept slicing that would write more bytes
    than that copy (the never-expand guard, module docstring). Returns
    each image's slice directory or pack file; a failed write raises
    OSError. Counts "compress.kept_images" (the batch's slicings the
    fallback kept) and "compress.guard_rewrites"."""
    hbits, vbits, single = wire
    pack = cfg.slice_container == "pack"
    out_dirs = []
    kept = rewrites = 0
    for i, (img, name) in enumerate(zip(images_u8, names)):
        if name is None:  # batch padding entry
            continue
        kept += not single[i]
        src = src_paths[i] if src_paths and cfg.compress_fallback else None
        if src is None or not single[i]:
            budget = (_passthrough_bytes(src, cfg.slice_container)
                      if src is not None else None)
            if write_slices_from_conn(
                    img, hbits[i], vbits[i], results_dir, name,
                    cfg.image_format, cfg.compression_level,
                    container=cfg.slice_container,
                    max_bytes=budget) is not None:
                out_dirs.append(pathlib.Path(results_dir)
                                / (f"{name}.pack" if pack else name))
                continue
            rewrites += 1  # over the passthrough: nothing was written
        out_dirs.append(write_passthrough(src, img.shape[:2], results_dir,
                                          name,
                                          container=cfg.slice_container))
    count("compress.kept_images", kept)
    count("compress.guard_rewrites", rewrites)
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
    clock = StageClock(timings, dev)
    with torch.inference_mode():
        labels = _device_labels(images_u8, cost_fn, cfg, dev, clock=clock)
        with clock.stage("wire"):
            wire = _pack_wire(labels)
    with clock.stage("write"):
        return _write_batch(images_u8, wire, cfg, results_dir, names)


def image_dims(path: pathlib.Path) -> tuple[int, int]:
    """(H, W) from the PNG IHDR without decoding pixel data."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
        return (int.from_bytes(head[20:24], "big"),
                int.from_bytes(head[16:20], "big"))
    return load_image(path).shape[:2]


def _timed_write(*args, batch: int | None = None,
                 **kwargs) -> tuple[list[pathlib.Path], float]:
    """The writer thread's _write_batch of batch number `batch`, and its
    seconds."""
    t0 = time.perf_counter()
    with span("write", id=batch):
        out = _write_batch(*args, **kwargs)
    return out, time.perf_counter() - t0


def _decoders(batch_size: int) -> int:
    """Width of compress_directory's decode pool: the batch size, at most the
    CPUs this process may run on."""
    cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
            else os.cpu_count() or 1)
    return min(batch_size, cpus)


def _decode(path: pathlib.Path, batch: int) -> np.ndarray:
    """A decode thread's load_image of one image of batch number `batch`."""
    with span("load.decode", id=batch):
        return load_image(path)


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
    PNG. A pool of decode threads (`_decoders` wide) decodes a batch's
    PNGs in parallel, and batch i + 1's decodes are queued before batch i's
    device half starts, so they run while it does: at most two batches are
    decoded or in flight. Batch i is sliced and written in a worker thread
    while batch i + 1's device half runs. The outputs are those of a serial
    run, and a decode or write failure raises here, where the serial run
    would have raised it. With `timings`, per-stage seconds are added into
    it: the device stages as in compress_arrays, "write" summed over the
    worker's batches (it overlaps the device stages). Traced, each batch is
    a span "compress.batch" (from its load through its wire, id = the
    batch's number) holding "load", the wait for its decoded images, and
    the stages; "load.ready_images" counts the batch's images decoded
    before that wait; "load.decode" is each decode in its thread;
    "write_wait" is the wait for the previous batch's write, "write" the
    write itself in the worker's thread."""
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
    batches = []  # (paths, padding entries) in the order they run
    for _shape, group in sorted(by_shape.items()):
        for i in range(0, len(group), batch_size):
            chunk = group[i:i + batch_size]
            batches.append((chunk, batch_size - len(chunk)
                            if len(group) > batch_size else 0))
    clock = StageClock(timings, dev)
    out: list[pathlib.Path] = []
    pending = None  # the future of the previous batch's write

    def device_half(number, chunk, decoded, pad):
        """Batch `number`: its decoded PNGs taken and padded, and its
        wire."""
        with span("compress.batch", dev, id=number):
            with span("load"):
                if tracing():
                    count("load.ready_images",
                          sum(f.done() for f in decoded))
                imgs = [f.result() for f in decoded]  # re-raises a failure
            imgs += imgs[-1:] * pad
            sizes = [p.stat().st_size for p in chunk]
            sizes += sizes[-1:] * pad
            with torch.inference_mode():
                labels = _device_labels(imgs, cost_fn, cfg, dev,
                                        orig_sizes=sizes, clock=clock)
                with clock.stage("wire"):
                    return imgs, _pack_wire(labels)

    def collect(fut, number):
        with span("write_wait", id=number):
            dirs, seconds = fut.result()  # re-raises the worker's failure
        out.extend(dirs)
        if timings is not None:
            timings["write"] = timings.get("write", 0.0) + seconds

    with ThreadPoolExecutor(_decoders(batch_size),
                            thread_name_prefix="decode") as decoder, \
            ThreadPoolExecutor(1) as pool:

        def decode(number):
            """Queue batch `number`'s decodes (none past the last batch)."""
            chunk = batches[number][0] if number < len(batches) else []
            return [decoder.submit(_decode, p, number) for p in chunk]

        ahead = decode(0)
        for number, (chunk, pad) in enumerate(batches):
            decoded, ahead = ahead, decode(number + 1)
            imgs, wire = device_half(number, chunk, decoded, pad)
            if pending is not None:
                collect(pending, number - 1)
            pending = pool.submit(
                _timed_write, imgs, wire, cfg, cfg.results_dir,
                [p.stem for p in chunk] + [None] * pad,
                src_paths=list(chunk) + [None] * pad, batch=number)
        if pending is not None:
            collect(pending, len(batches) - 1)
    return out
