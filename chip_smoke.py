#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (image_compression_torch) on one GPU.

    python3 chip_smoke.py                      # on a machine with a CUDA GPU
    python3 chip_smoke.py --device cpu --small # CPU rehearsal, plain versions

Phases, each printing one line with its own seconds:
  0. environment: Python, torch, CUDA, nvcc, the card's name and power
     limit, and the host compiler g++ and zlib.h (the native PNG writer's
     toolchain);
  1. build: nvcc compiles every kernel source of the port and g++ the
     native PNG writer csrc/pngio.cpp, all at once; where g++ and zlib.h
     exist a failed writer build fails the run (without them the port
     writes through its Python encoder, which gives the same bytes);
  2. kernel vs plain: each kernel's wrapper against its plain PyTorch
     version on the card, at the main path's shapes (8 images of 256x256)
     and on a ragged batch (3 images of 48x48, 27 supertiles); bitwise on
     integer-valued costs, by objective on real-valued costs, repeatable
     bit for bit; times at level-1 caps 64 and 128. Then the GroupNorm +
     ReLU + bf16 kernel against its plain chain at each distinct norm site
     of the base-64 U-Net for a batch of 8 images of 1024x1024 and of
     256x256 (random bf16 activations, random gamma and beta): unequal on
     at most 0.1% of the elements, there by at most 1 bf16 ulp of the
     affine step's terms (ops/group_norm_relu.distance); per shape and summed
     over the 14 sites, the kernel's and the chain's times beside the
     kernel's bound (6 bytes an element at the HBM rate);
  3. main path: the solver on the card against the CPU on square and
     non-square integer costs, then compress_arrays on 8 seeded 256x256
     images and on 4 seeded 256x384 images (sorted finishing rounds) with a
     full-width EdgeUNet (base 64, bf16, seeded random weights) and the
     shipped settings with hier_agg="matrix". On each batch's own learned
     costs the solver must repeat bit for bit and, rounded to 1/16, give
     the CPU's labels; its regions per image before the fallback are
     printed. Slices are reassembled and must be pixel-lossless, and every
     kernel of the path must have launched in each run. Then the 8 x
     256x256 batch again at the reference's shipped hier_agg="pixel", and
     8 tiny 12x12 images (the tiny-grid ensemble): lossless, with images/s,
     stage seconds and slices per image; neither reaches the leaf kernel,
     so their launch counts are printed but not checked;
  4. solver configurations: threefry coin bits drawn on the card equal the
     CPU's; the tiny-grid ensemble (4 x 12x12, 2 x 8x40), random_mate with
     8 ICM sweeps and pixel aggregation (2 x 64x64), and the sorted path's
     mutual and hybrid modes with the tile presolve (2 x 64x64) give the
     CPU's labels bit for bit on integer costs;
  5. a 3648x5472 cost field (19.96 Mpx, past 2^24 pixels) through
     multicut_grid at the shipped settings: every label is the smallest
     flat index of its region and the leaf kernel launched; its seconds
     and peak memory are printed;
  6. classical extractors on the card against the CPU (2 x 64x64): canny
     and watershed costs equal, graph and SLIC costs agreeing on >= 99% of
     entries (the share is printed); each image alone gives the costs it
     gets in the batch;
  7. classical compress: 16 seeded 256x256 and 4 seeded 256x384 images are
     written as PNG files and compressed by compress_directory on the card
     with canny (the default without a model) and graph costs, 3 batches,
     so that the host writes one batch while the device runs the next:
     every output reassembles losslessly and is byte-equal to a serial run
     (no overlap); each image's costs alone equal its costs in the first
     batch, and on that batch's costs the solver repeats and gives the
     CPU's labels. Printed: regions per image before the fallback,
     images/s, stage seconds, slices per image, out/orig bytes, the PNG
     writer that ran and the leaf launches (which must be >= 1). Then SLIC
     and watershed compress the first 8 square images once, losslessly;
  8. photo scale: graph costs and the solve of one 1536x2048 image, with
     seconds and peak memory;
  9. training at the flagship settings on the mixed corpus (16 train + 8
     val 256x256 PNGs from the port's generators), full-width EdgeUNet
     (base 64, bf16, batch 8): 5 pretrain steps on one batch lower its
     loss; run_pretraining runs an epoch with validation and checkpoints;
     REINFORCE steps (antithetic pairs, fallback-aware reward) give finite
     rewards and each launch the leaf kernel; the RL solve and reward of
     sampled costs rounded to 1/16 equal the CPU's; run_reinforce (an
     epoch, interrupted by a SIGINT) sets the baseline, changes the params
     and leaves an interrupt checkpoint that resumes at its step; the
     run's best_params compress and reassemble losslessly through the CLI.
     Printed: steps/s and images/s of both phases, RL stage seconds
     (forward, solve + reward, update), leaf launches per step, peak
     memory;
 10. spatial solve: multicut_grid_spatial on real-valued piecewise-smooth
     costs (4096x4096 over Mesh([cuda:0] * 4) and 2048x2048 over 8 strips
     with matrix aggregation; 1024x1024 over 4 and 8 with pixel
     aggregation, whose dense top-level operands do not fit one card at
     4096^2; over distinct cards too where there are several) equals the
     unsharded solve bit for bit; the matrix runs' strips launch the leaf
     kernel, the pixel runs nothing; the leaf kernel at the 4096^2
     strips' shape (T1 = 65,536, s1 = 128, rounds (3, 2)) equals its
     plain version bitwise on integer costs. Printed: sharded and
     unsharded seconds and peak memory, the leaf's and the plain
     version's time at that shape. Sharded canny (1024x1024, 4 strips) on
     the card equals the CPU's;
 11. data parallel: run_pretraining and run_reinforce (2 steps each, 8 x
     256x256, base 64) with use_mesh=True, without a process group and
     then in a world of one over NCCL (file:// rendezvous): losses,
     rewards, metrics and parameters equal bit for bit, the RL steps
     launch the leaf kernel; then steps/s with and without the group's
     reductions, in turns;
 12. convert: the CLI's convert on 6 PNGs (480x640, 300x200) on the card;
     the outputs decode and are within 1 level of the CPU converter's;
 13. trace: one 8 x 256x256 learned-cost compress batch inside
     utils/profiling.device_trace; the exported trace names leaf_kernel;
     printed: the device's busy share of the batch and the snapshot of
     the program's spans and counters (utils/profiling.snapshot);
 14. flagship: the repo's trained U-Net (image_compression_torch/weights/
     fcn_pretrained_r4_mixed.pt, its sha256 the record's) compresses the
     first 32 images of the mixed corpus (256x256, made by the port's
     generators, zlib level 6) through compress_directory in bf16 and f32:
     lossless, never above an original plus a one-slice record, and the
     f32 run keeps every fallback decision of the JAX package's record
     (weights/flagship_mixed_reference.json), writes the record's bytes
     for all but 1 in F32_UNEQUAL_PER images, and its out/orig is within
     F32_OUT_ORIG_TOL; on one batch's flagship costs the card's labels
     equal the CPU's and the leaf kernel its plain version; REINFORCE
     from the weights through the CLI's train (2 steps and an
     evaluation); one batch traced. Printed: out/orig beside the record's,
     decisions, slices per image, images/s, stage seconds, leaf launches,
     steps/s, the eval reward beside phase 9's, the busy share beside
     phase 13's.
Then one JSON line describing each kernel (its leaf launches of the main
compress path under "launches", and per path under "launches_by_path":
compress, run_reinforce, the sharded solves, the data-parallel run and
the flagship's bf16 compress),
the card's name and power limit, and as the last line {"ok": true,
"device": {...}}. Any failure exits non-zero before that line. Without a
GPU (and without --device cpu) the script exits non-zero at once.

--device cpu --small runs phases 0, 3, 4, 6, 7 and 9-14 on the CPU at
64x64 (and one 48x80 image; phase 7 on 8 + 4 images of 64x64 and 64x96 in
batches of 4; phases 9 and 11 with a base-8 U-Net on 32x32 images in
batches of 2, phase 11 in a world of one over gloo; phase 10 at 128x128
over 8 CPU strips with both aggregations and sharded canny at 64x64; the
tiny cases as they are) with a base-8 U-Net, through the plain versions of
the kernels, on 2 torch threads (the CPU's float sums depend on the thread
count); phase 6 then compares the CPU with itself, and there is no
3648x5472 field and no photo. Phase 14 on the CPU runs f32 only (4 images
of 128x128 with --small, with the real base-64 weights) and trains at
32x32.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import pathlib
import platform
import subprocess
import sys
import tempfile
import time

import numpy as np

CPU_THREADS = 2  # torch threads of the --device cpu rehearsal
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, same sheet
REPO = pathlib.Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


def leaf_launches() -> int:
    """The leaf kernel's launches since the last profiling.reset()."""
    from image_compression_torch.utils.profiling import counters
    return counters().get("leaf.launches", 0)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"[{name}] start")
    yield
    log(f"[{name}] ok in {time.perf_counter() - t0:.3f} s")


def gpu_name_and_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms (CUDA events around `iters` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_toolchain() -> tuple[str | None, str | None]:
    """(g++ path, zlib.h path), None for what is missing."""
    from image_compression_torch import kernels
    gxx = kernels.gxx_path()
    return gxx, kernels.zlib_header(gxx) if gxx else None


def phase_env(torch, device: str) -> None:
    with phase("env"):
        log(f"python {platform.python_version()} torch {torch.__version__} "
            f"cuda {torch.version.cuda} device {device}")
        gxx, zlib_h = host_toolchain()
        version = ""
        if gxx:
            version = subprocess.run([gxx, "--version"], capture_output=True,
                                     text=True).stdout.splitlines()[0]
        log(f"g++: {gxx or 'not found'} {version}; zlib.h: "
            f"{zlib_h or 'not found'}")
        if device == "cuda":
            from image_compression_torch import kernels
            try:
                nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                                      capture_output=True, text=True,
                                      timeout=60).stdout.strip()
                log("nvcc: " + nvcc.splitlines()[-1])
            except (OSError, subprocess.TimeoutExpired, IndexError) as e:
                log(f"nvcc: not runnable ({e})")
            log(f"gpu: {torch.cuda.get_device_name(0)} x "
                f"{torch.cuda.device_count()}")
            log("nvidia-smi: " + gpu_name_and_limit())


def phase_build() -> None:
    """nvcc every kernel source and g++ the PNG writer, all at once; print
    ptxas' resource lines. A failed build fails the run (the writer's only
    where g++ and zlib.h exist)."""
    from concurrent.futures import ThreadPoolExecutor

    from image_compression_torch import kernels
    names = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    gxx, zlib_h = host_toolchain()
    if gxx and zlib_h:
        names.append("pngio")
    else:
        log("pngio: not built (no g++ or no zlib.h): the Python encoder "
            "writes the slices")
    with phase("build"):
        with ThreadPoolExecutor(len(names)) as pool:
            futures = {n: pool.submit(kernels.build, n) for n in names}
        for name, fut in futures.items():
            try:
                path, stderr = fut.result()
            except kernels.BuildError as e:
                log(f"build failed for {name}:\n{e.stderr}")
                raise
            log(f"built {name} -> {path.relative_to(REPO)}")
            for line in stderr.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log("  ptxas: " + line.strip())


def leaf_bound(t1: int, s1: int, r0: int, r1: int) -> tuple[float, str]:
    """Least time (ms) an H100 needs for the leaf at these shapes: the larger
    of bytes moved (inputs read once, outputs written once) over HBM rate and
    f32 operations over the f32 rate. Operations: per round a row-maximum
    scan (S^2 compares) and the two aggregation passes (2 S^2 adds), plus
    the two passes of each dense re-rank."""
    bytes_in = 4 * (3 * t1 * 4 * 64 + t1 * 32)
    bytes_out = 4 * (2 * t1 * 4 * 64 + t1 * s1 * s1 + t1 * s1 + 2 * t1)
    ops = t1 * (4 * (r0 * 3 * 64 ** 2 + 2 * 64 ** 2)
                + r1 * 3 * s1 ** 2 + 2 * s1 ** 2)
    t_bytes = (bytes_in + bytes_out) / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _leaf_equal(torch, ml, name: str, costs: np.ndarray, s1: int,
                r0: int = 2, r1: int = 1) -> tuple[float, int]:
    """Kernel vs plain version on one input (rounds r0 at level 0, r1 at
    level 1), every field bitwise; returns the largest absolute difference
    (0) and the regions frozen."""
    fields = ("rank", "gid", "sym", "m", "ncand", "over")
    costs = torch.as_tensor(costs.astype(np.float32), device="cuda")
    args = (*ml.leaf_inputs(costs), s1, r0, r1,
            costs.shape[1] * costs.shape[2])
    got = ml.leaf_cuda(*args)
    want = ml.leaf_plain(*args)
    torch.cuda.synchronize()
    max_err = 0.0
    for f, a, b in zip(fields, got, want):
        if a.shape != b.shape:
            raise AssertionError(f"leaf {name}: field {f} has shape "
                                 f"{tuple(a.shape)}, plain {tuple(b.shape)}")
        diff = (a.double() - b.double()).abs().max().item()
        max_err = max(max_err, diff)
        if not torch.equal(a, b):
            raise AssertionError(f"leaf {name}: field {f} differs from the "
                                 f"plain version by {diff}")
    log(f"  {name} (T1={args[0].shape[0]}, s1={s1}, rounds ({r0}, {r1})): "
        f"all fields bitwise equal, {int(got[5].sum())} regions frozen")
    return max_err, int(got[5].sum())


def phase_leaf(torch, batch: int, side: int) -> dict:
    """The multicut leaf kernel against its plain version on the card."""
    from image_compression_torch.ops import multicut_leaf as ml
    from image_compression_torch.ops.multicut import (multicut_grid,
                                                      multicut_objective)
    rng = np.random.default_rng(0)
    shape = (batch, side, side, 2)
    cases = [
        ("integer flat64", rng.integers(-8, 9, size=shape), 64),
        ("integer default caps", rng.integers(-8, 9, size=shape), 128),
        ("heavy freezing", -np.abs(rng.normal(size=shape)) - 0.1, 64),
        ("ragged 3 x 48x48", rng.integers(-8, 9, size=(3, 48, 48, 2)), 64),
    ]
    max_err = 0.0
    with phase("leaf kernel vs plain"):
        for name, costs, s1 in cases:
            err, over = _leaf_equal(torch, ml, name, costs, s1)
            max_err = max(max_err, err)
            if name == "heavy freezing" and over <= 1000 * batch:
                raise AssertionError("heavy-freezing case did not freeze")

        # real-valued costs: the kernel repeats itself bit for bit
        costs = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                device="cuda")
        args = (*ml.leaf_inputs(costs), 64, 2, 1, side * side)
        first, second = ml.leaf_cuda(*args), ml.leaf_cuda(*args)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError("leaf kernel is not repeatable on real "
                                 "costs")
        log("  real costs: two launches bitwise equal")

        # real-valued costs: held by objective through the solver, fused
        # leaf (the kernel) vs the unfused level loop
        costs = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                device="cuda")
        kw = dict(hier_rounds=(2, 1), hier_caps="flat64")
        lab_k = multicut_grid(costs, hier_leaf="fused", **kw).cpu().numpy()
        lab_u = multicut_grid(costs, hier_leaf="unfused", **kw).cpu().numpy()
        c_np = costs.cpu().numpy()
        for i in range(batch):
            ok_ = multicut_objective(c_np[i], lab_k[i])
            ou = multicut_objective(c_np[i], lab_u[i])
            if abs(ok_ - ou) > 0.01 * abs(ou) + 1e-3:
                raise AssertionError(f"real costs image {i}: objective "
                                     f"{ok_} vs unfused {ou}")
        same = int((lab_k == lab_u).all(axis=(1, 2)).sum())
        log(f"  real costs: objectives within 1% on {batch} images "
            f"(labels equal on {same})")

        # timing at the main path's shape (flat64: s1 = 64), then at the
        # default caps' s1 = 128
        inputs = ml.leaf_inputs(torch.as_tensor(
            cases[0][1].astype(np.float32), device="cuda"))
        t1 = inputs[0].shape[0]
        for s1 in (64, 128):
            args = (*inputs, s1, 2, 1, side * side)
            k_ms = cuda_ms(torch, lambda: ml.leaf_cuda(*args))
            p_ms = cuda_ms(torch, lambda: ml.leaf_plain(*args), iters=5)
            b_ms, b_by = leaf_bound(t1, s1, 2, 1)
            log(f"  T1={t1} s1={s1}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{ml.resident_per_sm()} supertiles resident per SM")
            if s1 == 64:
                ms, plain_ms, bound_ms, bound_by = k_ms, p_ms, b_ms, b_by
        # what the rounds cost: the same launch with none (lists, the two
        # sorts, the re-ranks and the output writes remain)
        args = (*inputs, 64, 0, 0, side * side)
        log(f"  T1={t1} s1=64 rounds (0, 0): kernel "
            f"{cuda_ms(torch, lambda: ml.leaf_cuda(*args)):.4f} ms")
    return {"name": "multicut_leaf", "route": "cuda",
            "source": "image_compression_torch/csrc/multicut_leaf.cu",
            "replaces": "image_compression_tpu/ops/multicut_leaf.py:91",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def norm_sites(side: int, base: int = 64) -> list[tuple[int, int, int]]:
    """(channels, side of the plane, sites) of each distinct norm site of an
    EdgeUNet on side x side images: inc and up3, down1 and up2, down2 and
    up1 share their shapes, two norms a DoubleConv."""
    return [(base, side, 4), (2 * base, side // 2, 4),
            (4 * base, side // 4, 4), (8 * base, side // 8, 2)]


def phase_norm(torch, batch: int) -> dict:
    """The GroupNorm + ReLU + bf16 kernel against its plain chain on the
    card, at the norm sites of the flagship U-Net, with times."""
    from image_compression_torch.ops import group_norm_relu as gnr
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    with phase("group norm + relu kernel vs plain"):
        for side in (1024, 256):
            k_sum = p_sum = b_sum = 0.0
            for c, s, sites in norm_sites(side):
                x = torch.randn((batch, c, s, s), generator=gen,
                                device="cuda").mul_(2).add_(0.5).to(
                                    torch.bfloat16)
                w = torch.randn(c, generator=gen, device="cuda")
                b = torch.randn(c, generator=gen, device="cuda")
                y, mean, rstd = gnr.group_norm_relu_cuda(x, w, b, 8, 1e-6)
                ulps, scaled = gnr.distance(
                    y, gnr.group_norm_relu_plain(x, w, b, 8, 1e-6), x, w, b,
                    mean, rstd)
                worst, share = int(ulps.max()), float((ulps > 0).double()
                                                      .mean())
                if float(scaled.max()) > 1 or share > 1e-3:
                    raise AssertionError(
                        f"group_norm_relu at {tuple(x.shape)}: "
                        f"{float(scaled.max())} ulp of the terms, on "
                        f"{share:.2e} of the elements")
                k_ms = cuda_ms(torch, lambda: gnr.group_norm_relu_cuda(
                    x, w, b, 8, 1e-6))
                p_ms = cuda_ms(torch, lambda: gnr.group_norm_relu_plain(
                    x, w, b, 8, 1e-6), iters=5)
                b_ms = 6 * x.numel() / H100_BYTES_PER_S * 1e3
                log(f"  {tuple(x.shape)} x {sites} sites: kernel {k_ms:.4f} "
                    f"ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms (bytes); "
                    f"unequal on {share:.2e} of the elements, by at most "
                    f"{worst} ulp of the output and "
                    f"{float(scaled.max()):.3f} of the terms")
                k_sum += sites * k_ms
                p_sum += sites * p_ms
                b_sum += sites * b_ms
                del x, y, ulps, scaled
            log(f"  {batch} x {side}x{side}, 14 sites: kernel {k_sum:.3f} ms, "
                f"plain {p_sum:.3f} ms, bound {b_sum:.3f} ms")
            totals[side] = (k_sum, p_sum, b_sum)
    ms, plain_ms, bound_ms = totals[1024]
    return {"name": "group_norm_relu", "route": "cuda",
            "source": "image_compression_torch/csrc/group_norm_relu.cu",
            "replaces": None, "launches": None, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}


def make_images(n: int, height: int, width: int,
                seed: int) -> list[np.ndarray]:
    """Seeded uint8 RGB test images: each quadrant one of five patterns
    (flat colour, gradient, uniform noise, repeating tile, low-amplitude
    noise), rotated across images. Sides are even."""
    rng = np.random.default_rng(seed)
    h, w = height // 2, width // 2
    ys, xs = np.mgrid[:h, :w]
    images = []
    for i in range(n):
        img = np.empty((height, width, 3), np.uint8)
        for q, (y0, x0) in enumerate(((0, 0), (0, w), (h, 0), (h, w))):
            kind = (i + q) % 5
            if kind == 0:
                patch = np.broadcast_to(rng.integers(0, 256, 3, np.uint8),
                                        (h, w, 3))
            elif kind == 1:
                patch = np.stack([(ys + xs) * 255 // (h + w - 2),
                                  ys * 255 // (h - 1),
                                  xs * 255 // (w - 1)], -1).astype(np.uint8)
            elif kind == 2:
                patch = rng.integers(0, 256, (h, w, 3), np.uint8)
            elif kind == 3:
                patch = np.tile(rng.integers(0, 256, (8, 8, 3), np.uint8),
                                (-(-h // 8), -(-w // 8), 1))[:h, :w]
            else:
                patch = (rng.integers(0, 12, (h, w, 3))
                         + rng.integers(0, 240, 3)).astype(np.uint8)
            img[y0:y0 + h, x0:x0 + w] = patch
        images.append(img)
    return images


def make_solve(pipeline, mc):
    """The solver at the settings of MulticutConfig `mc`."""
    def solve(costs):
        return pipeline.segment_batch(
            costs, mode=mc.mode, max_rounds=mc.max_rounds,
            icm_sweeps=mc.icm_sweeps,
            hier_rounds=tuple(mc.hier_rounds) if mc.hier_rounds else None,
            hier_caps=mc.hier_caps, hier_agg=mc.hier_agg,
            hier_leaf=mc.hier_leaf,
            matchings_per_round=mc.matchings_per_round)
    return solve


def check_solver_on_batch(torch, solve, costs, device: str) -> None:
    """The solver on a batch's own costs (learned or classical): two solves
    give the same labels (fixed-order sums), and on the card the labels
    equal the CPU's on the costs rounded to multiples of 1/16 (exact in
    bf16 and in every f32 sum, so the order of the sums cannot matter).
    Prints the regions per image before the fallback."""
    labels = solve(costs)
    if not torch.equal(solve(costs), labels):
        raise AssertionError("two solves of the same costs differ")
    regions = [int(torch.unique(lab).numel()) for lab in labels]
    msg = (f"  solver: share of edges with cost > 0 "
           f"{float((costs > 0).float().mean()):.4f}; regions per image "
           f"before fallback {regions}; repeats")
    if device == "cuda":
        q = torch.round(costs * 16) / 16
        if not torch.equal(solve(q).cpu(), solve(q.cpu())):
            raise AssertionError("solver labels differ from the CPU's on "
                                 "this batch's costs rounded to 1/16")
        msg += "; labels equal the CPU's on the costs rounded to 1/16"
    log(msg)


def phase_main(torch, device: str, runs: list[dict], base: int) -> list[int]:
    """The solver on the device against the CPU, then compress_arrays ->
    reassemble on seeded images with a seeded full-width U-Net, one run per
    entry of `runs` (batch, height, width, mu bias, hier_agg, and whether
    the run must keep a slicing and launch the leaf kernel); returns the
    leaf kernel's launches of each run."""
    from image_compression_torch import pipeline
    from image_compression_torch.config import Config
    from image_compression_torch.io.image_io import ensure_rgba
    from image_compression_torch.io.reassemble import reassemble_array
    from image_compression_torch.models.unet import EdgeUNet, init_random_
    from image_compression_torch.utils import profiling
    from image_compression_torch.ops.multicut import multicut_grid

    with phase("main path"):
        # the mu logits' bias (set per run) leans the random net toward
        # "connect", so that some images of every batch keep a slicing and
        # the solver's labels reach merging, the slicer and the writer
        model = init_random_(EdgeUNet(base=base), seed=0).to(device).eval()

        def cost_fn(b):
            return pipeline.learned_costs(model, b)

        # the solver on the device agrees with the CPU, on a square input
        # and on a non-square one (sorted finishing rounds)
        kw = dict(hier_rounds=(2, 1), hier_caps="flat64")
        for shape in ((2, 64, 64, 2), (2, 96, 160, 2)):
            small = torch.as_tensor(np.random.default_rng(2).integers(
                -8, 9, shape).astype(np.float32))
            if not torch.equal(multicut_grid(small.to(device), **kw).cpu(),
                               multicut_grid(small, **kw)):
                raise AssertionError(f"solver labels differ from the CPU's "
                                     f"on {shape[1]}x{shape[2]}")
        log("  solver labels equal the CPU's on 2 x 64x64 and 2 x 96x160")

        all_launches = []
        for run in runs:
            batch, height, width = run["batch"], run["height"], run["width"]
            cfg = Config()  # shipped settings, with the run's aggregation
            cfg.multicut.hier_agg = run["agg"]
            solve = make_solve(pipeline, cfg.multicut)

            with torch.no_grad():
                model.outc.bias[0::2] = run["bias"]
            images = make_images(batch, height, width, seed=run["seed"])
            names = [f"img{j}" for j in range(batch)]
            # outputs are right: finite costs of the right shape
            with torch.inference_mode():
                x = torch.as_tensor(np.stack(images) / 255.0,
                                    dtype=torch.float32, device=device)
                costs = cost_fn(x)
            if costs.shape != (len(x), height, width, 2) or not bool(
                    torch.isfinite(costs).all()):
                raise AssertionError(f"bad costs {tuple(costs.shape)}")
            check_solver_on_batch(torch, solve, costs, device)
            with tempfile.TemporaryDirectory() as tmp:
                tmp = pathlib.Path(tmp)
                pipeline.compress_arrays(images, cost_fn, cfg, tmp / "warm",
                                         names, device=device)
                timings: dict = {}
                profiling.reset()
                t0 = time.perf_counter()
                dirs = pipeline.compress_arrays(images, cost_fn, cfg,
                                                tmp / "out", names,
                                                device=device,
                                                timings=timings)
                elapsed = time.perf_counter() - t0
                launches = leaf_launches()
                n_slices = []
                for d, img in zip(dirs, images):
                    rec = reassemble_array(d)
                    if not np.array_equal(rec, ensure_rgba(img)):
                        raise AssertionError(f"{d.name}: reassembly not "
                                             "lossless")
                    n_slices.append(len(list(d.glob("slice_*.png"))))
            if run["need_slices"] and max(n_slices) < 2:
                raise AssertionError("every image fell back to one slice: "
                                     "the solver's labels reached no "
                                     "slicer or writer")
            log(f"  {batch} images {height}x{width}, hier_agg "
                f"{run['agg']!r}, mu bias {run['bias']}: "
                f"{batch / elapsed:.3f} images/s ({elapsed:.3f} s); slices "
                f"per image {n_slices}; lossless")
            log("  stage seconds: " + ", ".join(
                f"{k} {v:.4f}" for k, v in timings.items()))
            if run["check_leaf"]:
                log(f"  multicut_leaf launches: {launches}")
                if device == "cuda" and launches < 1:
                    raise AssertionError("the main path did not launch the "
                                         "leaf kernel")
            else:
                log(f"  multicut_leaf launches: {launches} (not checked: "
                    f"{run['why_no_leaf']})")
            all_launches.append(launches)
    return all_launches


def phase_solver_configs(torch, device: str) -> None:
    """Solver configurations beyond the compress defaults, on the device
    against the CPU, labels bitwise on integer costs: the tiny-grid
    ensemble, random_mate with ICM and pixel aggregation, the sorted path's
    mutual and hybrid modes (tile presolve, boundary and full rounds); and
    threefry coin bits drawn on the device against the CPU's."""
    from image_compression_torch.ops import prng
    from image_compression_torch.ops.multicut import multicut_grid

    with phase("solver configurations"):
        for salt, shape in ((0, (4096,)), (50_003, (27, 64)),
                            (90_001, (3, 256)), (2 ** 31 - 1, (1_000_003,))):
            key = prng.fold_in(prng.prng_key(3), salt)
            on_dev = prng.random_bits(key, shape, device).cpu()
            if not torch.equal(on_dev, prng.random_bits(key, shape)):
                raise AssertionError(f"coin bits differ on {device}, salt "
                                     f"{salt}")
        log(f"  threefry bits on {device} equal the CPU's (4 keys, up to "
            "1,000,003 words)")
        cases = [
            ("tiny ensemble", (4, 12, 12), {}),
            ("tiny ensemble", (2, 8, 40), {}),
            ("random_mate, 8 ICM sweeps, pixel agg", (2, 64, 64),
             dict(mode="random_mate", icm_sweeps=8, hier_agg="pixel")),
            ("mutual (sorted path, presolve)", (2, 64, 64),
             dict(mode="mutual")),
            ("hybrid (sorted path, presolve)", (2, 64, 64),
             dict(mode="hybrid")),
        ]
        rng = np.random.default_rng(6)
        for name, shape, kw in cases:
            costs = torch.as_tensor(rng.integers(
                -8, 9, shape + (2,)).astype(np.float32))
            t0 = time.perf_counter()
            got = multicut_grid(costs.to(device), **kw).cpu()
            if device == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            msg = (f"  {name} {shape[0]} x {shape[1]}x{shape[2]}: "
                   f"{dt:.4f} s on {device}, regions "
                   f"{[int(torch.unique(g).numel()) for g in got]}")
            if device == "cuda":
                if not torch.equal(got, multicut_grid(costs, **kw)):
                    raise AssertionError(f"{name} {shape}: labels differ "
                                         "from the CPU's")
                msg += "; labels equal the CPU's"
            log(msg)


def phase_big_field(torch) -> None:
    """One 3648x5472 integer cost field (19.96 Mpx, past 2^24 pixels)
    through multicut_grid at the shipped settings: every label must be the
    smallest flat index of its region, and the leaf kernel must launch.
    Solve only: no slices are written."""
    from image_compression_torch.config import Config
    from image_compression_torch.utils import profiling
    from image_compression_torch.ops.multicut import multicut_grid

    height, width = 3648, 5472
    n = height * width
    mc = Config().multicut
    with phase("3648x5472 solve"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        costs = torch.randint(-3, 9, (1, height, width, 2), generator=gen,
                              device="cuda").to(torch.float32)
        kw = dict(mode=mc.mode, max_rounds=mc.max_rounds,
                  icm_sweeps=mc.icm_sweeps, hier_rounds=tuple(mc.hier_rounds),
                  hier_caps=mc.hier_caps, hier_agg=mc.hier_agg,
                  hier_leaf=mc.hier_leaf)
        multicut_grid(costs[:, :512, :512], **kw)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset()
        t0 = time.perf_counter()
        labels = multicut_grid(costs, **kw)[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = leaf_launches()
        peak = torch.cuda.max_memory_allocated()
        flat = labels.reshape(-1).long()
        idx = torch.arange(n, device="cuda")
        mins = torch.full((n,), n, device="cuda", dtype=torch.int64
                          ).scatter_reduce(0, flat, idx, "amin")
        if not bool((mins[flat] == flat).all()):
            raise AssertionError("3648x5472: a label is not the smallest "
                                 "flat index of its region")
        if launches < 1:
            raise AssertionError("3648x5472: the leaf kernel did not launch")
        regions = int(torch.unique(flat).numel())
        past = int(torch.unique(flat[flat >= 2 ** 24]).numel())
        log(f"  {height}x{width} ({n} px): {seconds:.3f} s, peak "
            f"{peak / 2 ** 30:.2f} GiB allocated, {regions} regions "
            f"({past} labelled past 2^24), leaf launches {launches}; every "
            "label is its region's smallest flat index")


def phase_extractors(torch, device: str, side: int) -> None:
    """Each classical extractor on 2 seeded images on the device against
    the CPU: canny and watershed cost planes equal, graph and SLIC costs
    agreeing on >= 99% of entries (their float sums may round apart where
    a decision has no margin)."""
    from image_compression_torch.config import EdgeTarget
    from image_compression_torch.ops.targets import compute_edge_costs

    images = np.stack(make_images(2, side, side, seed=11)) / 255.0
    x = torch.as_tensor(images, dtype=torch.float32)
    with phase("classical extractors"):
        for target in EdgeTarget:
            t0 = time.perf_counter()
            got = compute_edge_costs(x.to(device), target)
            if device == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            want = compute_edge_costs(x, target)
            if got.shape != want.shape:
                raise AssertionError(f"{target.value}: shape "
                                     f"{tuple(got.shape)}")
            agree = float((got.cpu() == want).float().mean())
            for i in range(len(x)):
                if not torch.equal(compute_edge_costs(x[i:i + 1].to(device),
                                                      target), got[i:i + 1]):
                    raise AssertionError(f"{target.value}: image {i} alone "
                                         "differs from the batch")
            exact = target in (EdgeTarget.CANNY, EdgeTarget.WATERSHED)
            if (exact and agree != 1.0) or agree < 0.99:
                raise AssertionError(f"{target.value} on {device}: "
                                     f"{agree:.6f} of entries equal the "
                                     f"CPU's")
            log(f"  {target.value} 2 x {side}x{side}: {dt:.4f} s on "
                f"{device}; {agree:.6f} of cost entries equal the CPU's"
                + (" (bitwise)" if exact else "")
                + "; each image alone equals the batch")


def serial_compress(torch, cfg, paths, cost_fn, device, batch_size: int):
    """compress_directory's steps without the device/host overlap: each
    batch's device half, then its write, in turn."""
    from image_compression_torch import pipeline
    from image_compression_torch.io.image_io import load_image

    by_shape: dict = {}
    for path in paths:
        by_shape.setdefault(pipeline.image_dims(path), []).append(path)
    for _shape, group in sorted(by_shape.items()):
        for i in range(0, len(group), batch_size):
            chunk = group[i:i + batch_size]
            imgs = [load_image(p) for p in chunk]
            pad = batch_size - len(chunk) if len(group) > batch_size else 0
            sizes = [p.stat().st_size for p in chunk]
            with torch.inference_mode():
                labels = pipeline._device_labels(
                    imgs + imgs[-1:] * pad, cost_fn, cfg,
                    torch.device(device), orig_sizes=sizes + sizes[-1:] * pad)
                wire = pipeline._pack_wire(labels)
            pipeline._write_batch(imgs + imgs[-1:] * pad, wire, cfg,
                                  cfg.results_dir,
                                  [p.stem for p in chunk] + [None] * pad,
                                  src_paths=list(chunk) + [None] * pad)


def _tree_bytes(path: pathlib.Path) -> dict:
    if path.is_file():
        return {path.name: path.read_bytes()}
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


def phase_classical(torch, device: str, side: int, batch: int) -> None:
    """Checkpoint-free compress on the device with classical costs: canny
    (the default) and graph over 3 batches (2 * batch square images and 4
    wide ones) with the host/device overlap, byte-equal to a serial run and
    lossless; then SLIC and watershed once on the first batch."""
    from image_compression_torch import pipeline
    from image_compression_torch.config import Config, EdgeTarget
    from image_compression_torch.io import native, pypng
    from image_compression_torch.io.image_io import ensure_rgba, load_image
    from image_compression_torch.io.reassemble import reassemble_array
    from image_compression_torch.utils import profiling

    wide = side * 3 // 2
    with phase("classical compress"), tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        data = tmp / "data"
        data.mkdir()
        square = make_images(2 * batch, side, side, seed=21)
        for i, img in enumerate(square):
            (data / f"sq{i:02d}.png").write_bytes(pypng.encode(img))
        for i, img in enumerate(make_images(4, side, wide, seed=22)):
            (data / f"wide{i}.png").write_bytes(pypng.encode(img))
        paths = sorted(data.glob("*.png"))
        orig_bytes = sum(p.stat().st_size for p in paths)
        log(f"  png writer: {native.writer()}")
        for target in (None, EdgeTarget.GRAPH):
            name = target.value if target else "canny (default)"
            cost_target = target or EdgeTarget.CANNY

            def cost_fn(b, t=cost_target):
                return pipeline.classical_costs_signed(b, t)

            # the solver on this extractor's costs of the first batch
            with torch.inference_mode():
                costs = cost_fn(torch.as_tensor(
                    np.stack(square[:batch]) / 255.0, dtype=torch.float32,
                    device=device))
            check_solver_on_batch(torch, make_solve(pipeline,
                                                    Config().multicut),
                                  costs, device)
            with torch.inference_mode():
                for i in range(batch):
                    if not torch.equal(cost_fn(torch.as_tensor(
                            square[i][None] / 255.0, dtype=torch.float32,
                            device=device)), costs[i:i + 1]):
                        raise AssertionError(f"{name}: image {i}'s costs "
                                             "alone differ from its costs "
                                             "in the batch")
            log(f"  {name}: each image's costs alone equal its costs in the "
                f"batch of {batch}")
            serial = Config(dataset_dir=str(data),
                            results_dir=str(tmp / f"serial_{name[:5]}"))
            serial_compress(torch, serial, paths, cost_fn, device, batch)
            cfg = Config(dataset_dir=str(data),
                         results_dir=str(tmp / f"out_{name[:5]}"))
            timings: dict = {}
            profiling.reset()
            t0 = time.perf_counter()
            outs = pipeline.compress_directory(cfg, classical=target,
                                               batch_size=batch,
                                               device=device,
                                               timings=timings)
            elapsed = time.perf_counter() - t0
            launches = leaf_launches()
            out_bytes, n_slices = 0, []
            for out, src in zip(outs, paths):
                files = _tree_bytes(out)
                if files != _tree_bytes(pathlib.Path(serial.results_dir)
                                        / out.name):
                    raise AssertionError(f"{name} {out.name}: bytes differ "
                                         "from the serial run")
                out_bytes += sum(len(v) for v in files.values())
                n_slices.append(len(files) - 1)
                if not np.array_equal(reassemble_array(out),
                                      ensure_rgba(load_image(src))):
                    raise AssertionError(f"{name} {out.name}: reassembly "
                                         "not lossless")
            if len(outs) != len(paths):
                raise AssertionError(f"{name}: {len(outs)} outputs")
            if device == "cuda" and launches < 1:
                raise AssertionError(f"{name}: the leaf kernel did not "
                                     "launch")
            log(f"  {name}: {len(paths)} images ({len(square)} x "
                f"{side}x{side}, 4 x {side}x{wide}) in 3 batches, "
                f"{len(paths) / elapsed:.3f} images/s ({elapsed:.3f} s); "
                f"lossless; bytes equal the serial run")
            log(f"  {name}: stage seconds " + ", ".join(
                f"{k} {v:.4f}" for k, v in timings.items())
                + " (write runs in a worker thread, overlapping the rest)")
            log(f"  {name}: slices per image {n_slices}; out/orig bytes "
                f"{out_bytes / orig_bytes:.4f} ({out_bytes} / "
                f"{orig_bytes}); multicut_leaf launches {launches}")

        first = tmp / "first"
        first.mkdir()
        for p in paths[:batch]:
            (first / p.name).write_bytes(p.read_bytes())
        for target in (EdgeTarget.SLIC, EdgeTarget.WATERSHED):
            cfg = Config(dataset_dir=str(first),
                         results_dir=str(tmp / target.value))
            t0 = time.perf_counter()
            outs = pipeline.compress_directory(cfg, classical=target,
                                               device=device)
            elapsed = time.perf_counter() - t0
            for out, src in zip(outs, sorted(first.glob("*.png"))):
                if not np.array_equal(reassemble_array(out),
                                      ensure_rgba(load_image(src))):
                    raise AssertionError(f"{target.value} {out.name}: "
                                         "reassembly not lossless")
            log(f"  {target.value}: {batch} x {side}x{side} in "
                f"{elapsed:.3f} s "
                f"(first call, one batch); slices per image "
                f"{[len(_tree_bytes(o)) - 1 for o in outs]}; lossless")


def phase_photo(torch) -> None:
    """Graph costs and the solve of one 1536x2048 image on the card."""
    from image_compression_torch.config import Config, EdgeTarget
    from image_compression_torch.utils import profiling
    from image_compression_torch.ops.multicut import multicut_grid
    from image_compression_torch.pipeline import classical_costs_signed

    height, width = 1536, 2048
    mc = Config().multicut
    with phase("photo scale"):
        x = torch.as_tensor(np.stack(make_images(1, height, width, seed=31))
                            / 255.0, dtype=torch.float32, device="cuda")
        classical_costs_signed(x[:, :256, :256], EdgeTarget.GRAPH)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset()
        t0 = time.perf_counter()
        costs = classical_costs_signed(x, EdgeTarget.GRAPH)
        torch.cuda.synchronize()
        t_costs = time.perf_counter() - t0
        labels = multicut_grid(
            costs, mode=mc.mode, max_rounds=mc.max_rounds,
            icm_sweeps=mc.icm_sweeps, hier_rounds=tuple(mc.hier_rounds),
            hier_caps=mc.hier_caps, hier_agg=mc.hier_agg,
            hier_leaf=mc.hier_leaf)
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if labels.shape != (1, height, width) or not bool(
                torch.isin(costs, torch.tensor([-1.0, 0.0, 1.0],
                                               device="cuda")).all()):
            raise AssertionError("photo: bad costs or labels")
        log(f"  {height}x{width}: graph costs {t_costs:.3f} s, costs + "
            f"solve {t_all:.3f} s, peak {peak / 2 ** 30:.2f} GiB allocated, "
            f"{int((costs > 0).float().mean() * 1e4) / 1e4} of edges "
            f"connect, {int(torch.unique(labels).numel())} regions, leaf "
            f"launches {leaf_launches()}")


def write_training_corpus(root: pathlib.Path, n_train: int, n_val: int,
                          size: int) -> tuple[pathlib.Path, pathlib.Path]:
    """The mixed corpus of the flagship configuration, made by the port's
    generators: the 4-class cycle sigma, anticorr, mixedmos, flatnoise with
    cells (64, 128) (at 256x256) from one generator seeded 0; the first
    n_train images train, the next n_val validate. PNGs by the port's
    encoder."""
    from image_compression_torch.io import pypng
    from image_compression_torch.utils.pattern_generator import mixed_corpus

    dirs = root / "train", root / "val"
    for d in dirs:
        d.mkdir(parents=True)
    # cells 64 and 128 at 256x256, scaled with smaller sides
    for i, (stem, img) in enumerate(mixed_corpus(
            n_train + n_val, size, cells=(size // 4, size // 2))):
        d = dirs[0] if i < n_train else dirs[1]
        (d / f"{stem}.png").write_bytes(pypng.encode(img))
    return dirs


def check_rl_solve(torch, cfg, rl_step, rl_state, key, imgs_d,
                   sizes_d) -> None:
    """The RL solve and reward of one step's sampled costs, rounded to 1/16
    (exact in every sum, so the order of the sums cannot matter): on the
    card, labels equal the CPU's and rewards are within 1e-5; the rewards
    are printed."""
    from image_compression_torch.train import steps

    with torch.no_grad():
        mu, sigma = rl_step.forward(rl_state, imgs_d)
        w, _ = rl_step.solve_reward(key, rl_state.step, mu, sigma, imgs_d,
                                    sizes_d)
        q = torch.round(w * 16) / 16
        imgs2 = torch.cat([imgs_d, imgs_d])
        sizes2 = torch.cat([sizes_d, sizes_d])
        lab, rew = steps.solve_and_reward(q, imgs2, sizes2, cfg)
        if imgs_d.is_cuda:
            lab_c, rew_c = steps.solve_and_reward(q.cpu(), imgs2.cpu(),
                                                  sizes2.cpu(), cfg)
            err = float((rew.cpu() - rew_c).abs().max())
            if not torch.equal(lab.cpu(), lab_c) or not torch.allclose(
                    rew.cpu(), rew_c, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"RL solve/reward differ from the "
                                     f"CPU's (max reward diff {err})")
            log(f"  RL solve and reward of {len(q)} samples rounded to "
                f"1/16: labels equal the CPU's, rewards within {err:.2e}")
        log(f"  rewards (fallback-aware) of those samples: "
            f"{[round(float(r), 5) for r in rew]}")


def phase_training(torch, device: str, small: bool) -> dict:
    """Training on the device at the flagship settings: supervised
    pretraining (r4_pre_mixed: the defaults, AdamW 1e-3, wd 1e-4; graph
    targets) and REINFORCE (r4_rl_mixed: antithetic pairs, EMA baseline,
    no whitening, lr 2e-5, entropy 1e-5, the fallback-aware reward) on the
    mixed corpus, a full-width EdgeUNet (base 64, bf16, batch 8, 256x256).
    Checks: 5 pretrain steps on one batch lower its loss; run_pretraining
    runs an epoch with validation and checkpoints; RL steps give finite
    rewards and launch the leaf kernel at least once each (3 epochs of the
    train set, the first step untimed); run_reinforce
    (an epoch of 2 steps, an evaluation after each) initializes the
    baseline and changes the params; on the card the RL solve and reward
    of sampled costs rounded to 1/16 equal the CPU's (labels bitwise,
    rewards within 1e-5); a SIGINT during the run leaves an interrupt
    checkpoint that resumes at its step; the run's best_params compress
    and reassemble losslessly through the CLI. Returns the leaf launches of
    the run_reinforce run and its evaluation's log line."""
    import signal

    from image_compression_torch.cli.main import main as cli
    from image_compression_torch.config import Config
    from image_compression_torch.io.image_io import ensure_rgba, load_image
    from image_compression_torch.models.unet import EdgeUNet
    from image_compression_torch.ops import prng
    from image_compression_torch.utils import profiling
    from image_compression_torch.ops.targets import create_target_with_mask
    from image_compression_torch.train import steps
    from image_compression_torch.train.data import ImageBatches
    from image_compression_torch.train.pretrain import run_pretraining
    from image_compression_torch.train.reinforce import run_reinforce

    size, base, batch = (32, 8, 2) if small else (256, 64, 8)
    n_train, n_val = (4, 2) if small else (16, 8)
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with phase("training"), tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        train_dir, val_dir = write_training_corpus(tmp / "data", n_train,
                                                   n_val, size)
        cfg = Config(dataset_dir=str(train_dir), val_dataset_dir=str(val_dir),
                     results_dir=str(tmp / "pre"), cache_dir=str(tmp / "c"),
                     image_size=size)
        cfg.pretrain.batch_size = cfg.rl.batch_size = batch
        cfg.pretrain.epochs = cfg.rl.epochs = 1
        cfg.rl.sampler, cfg.rl.baseline, cfg.rl.whiten = ("antithetic",
                                                          "ema", False)
        cfg.rl.lr, cfg.rl.entropy_coef, cfg.rl.eval_every = 2e-5, 1e-5, 1
        cfg.reward.fallback_aware = True
        log(f"  corpus: {n_train} train + {n_val} val {size}x{size} "
            f"(sigma, anticorr, mixedmos, flatnoise; cells {size // 4}/"
            f"{size // 2}; seed 0); "
            f"EdgeUNet base {base} bf16, batch {batch}; multicut hier_agg "
            f"{cfg.multicut.hier_agg!r}")
        if cuda:
            torch.cuda.reset_peak_memory_stats()

        # 5 pretrain steps on one fixed batch lower its loss
        images = next(ImageBatches(sorted(train_dir.glob("*.png")), batch,
                                   size).epoch(0, shuffle=False))
        x = torch.as_tensor(images).to(device)
        with torch.no_grad():
            targets = create_target_with_mask(x, cfg.edge_target)
        state = steps.init_train_state(EdgeUNet(base=base), cfg, 0, device)
        step_fn = steps.make_pretrain_step(cfg)
        losses = [float(step_fn(state, x, targets)[1]["loss"])]  # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(4):
            losses.append(float(step_fn(state, x, targets)[1]["loss"]))
        sync()
        dt = time.perf_counter() - t0
        after = float(steps.make_pretrain_eval(cfg)(state.model, x,
                                                    targets)[0]["loss"])
        if not all(np.isfinite(losses)) or not after < losses[0]:
            raise AssertionError(f"pretrain loss did not fall: {losses} -> "
                                 f"{after}")
        log(f"  pretrain, 5 steps on one batch: loss {losses[0]:.5f} -> "
            f"{after:.5f}; {4 / dt:.3f} steps/s, {4 * batch / dt:.3f} "
            f"images/s (steps 2-5)")

        # one epoch of run_pretraining: validation, checkpoints
        t0 = time.perf_counter()
        pre, run_id = run_pretraining(cfg, log=lambda *_: None,
                                      device=device, model=EdgeUNet(base=base))
        sync()
        dt = time.perf_counter() - t0
        prefix = f"fcn_pretrained_{run_id}_"
        tags = sorted(p.name[len(prefix):]
                      for p in (tmp / "pre").glob(prefix + "*"))
        if pre.step != n_train // batch or tags != ["best", "epoch_1",
                                                    "final"]:
            raise AssertionError(f"run_pretraining: step {pre.step}, "
                                 f"checkpoints {tags}")
        log(f"  run_pretraining, 1 epoch: {pre.step} steps in {dt:.3f} s "
            f"({pre.step / dt:.3f} steps/s with targets, validation and 3 "
            f"full-state checkpoints); checkpoints {tags}")
        params = {k: v.detach().clone() for k, v in
                  pre.model.state_dict().items()}
        del state, pre

        # RL steps, each launching the leaf kernel
        cfg.results_dir = str(tmp / "rl")
        rl_state = steps.init_rl_state(
            EdgeUNet(base=base).to(device), cfg)
        rl_state.model.load_state_dict(params)
        rl_step = steps.make_rl_step(cfg)
        key = prng.prng_key(0)
        data = ImageBatches(sorted(train_dir.glob("*.png")), batch, size,
                            with_file_sizes=True)
        timings: dict = {}
        per_step = []
        t_all = 0.0
        batches = [b for epoch in range(3) for b in data.epoch(epoch)]
        for i, (imgs, sizes) in enumerate(batches):
            imgs_d = torch.as_tensor(imgs).to(device)
            sizes_d = torch.as_tensor(sizes).to(device)
            profiling.reset()
            sync()
            t0 = time.perf_counter()
            _, aux = rl_step(rl_state, key, imgs_d, sizes_d,
                             timings=timings if i else None)
            sync()
            if i:
                t_all += time.perf_counter() - t0
            per_step.append(leaf_launches())
            if not np.isfinite(float(aux["reward_mean"])):
                raise AssertionError(f"RL step {i}: reward {aux}")
        if cuda and min(per_step) < 1:
            raise AssertionError(f"an RL step launched no leaf kernel: "
                                 f"{per_step}")
        n_timed = len(per_step) - 1
        log(f"  RL step (antithetic: {2 * batch} solves): "
            f"{n_timed / t_all:.3f} steps/s, {n_timed * batch / t_all:.3f} "
            f"images/s (steps after the first); stage seconds per step "
            + ", ".join(f"{k} {v / n_timed:.4f}" for k, v in timings.items())
            + f"; leaf launches per step {per_step}")

        check_rl_solve(torch, cfg, rl_step, rl_state, key, imgs_d, sizes_d)
        del rl_state

        # run_reinforce; a SIGINT after the first evaluation leaves
        # the interrupt checkpoint after the next step
        evals = []

        def rl_log(msg):
            if msg.startswith("Eval reward"):
                evals.append(msg)
                if len(evals) == 1:
                    signal.raise_signal(signal.SIGINT)

        profiling.reset()
        t0 = time.perf_counter()
        rl, rl_id = run_reinforce(cfg, params, log=rl_log, device=device)
        sync()
        dt = time.perf_counter() - t0
        launches = leaf_launches()
        interrupt = tmp / "rl" / f"fcn_training_{rl_id}_interrupt"
        best = tmp / "rl" / f"fcn_training_{rl_id}_best_params"
        changed = any(not torch.equal(v, params[k])
                      for k, v in rl.model.state_dict().items())
        baseline = float(rl.baseline)
        if not (rl.step == n_train // batch and bool(rl.baseline_init)
                and np.isfinite(baseline) and changed and interrupt.exists()
                and best.exists() and len(evals) == 1):
            raise AssertionError(f"run_reinforce: step {rl.step}, baseline "
                                 f"{baseline} (set {bool(rl.baseline_init)})"
                                 f", params changed {changed}, evals "
                                 f"{evals}, interrupt {interrupt.exists()}")
        if cuda and launches < rl.step:
            raise AssertionError(f"run_reinforce launched the leaf kernel "
                                 f"{launches} times in {rl.step} steps")
        log(f"  run_reinforce, 1 epoch interrupted after step {rl.step}: "
            f"{dt:.3f} s; baseline {baseline:.5f}; params changed; "
            f"{evals[0]}; leaf launches {launches}")
        eval_msg = evals[0]
        del rl

        cfg.rl.epochs = 2
        msgs = []
        resumed, _ = run_reinforce(cfg, params, log=msgs.append,
                                   device=device, resume=str(interrupt))
        if not any(f"at step {n_train // batch}" in m for m in msgs) or \
                resumed.step != 2 * (n_train // batch):
            raise AssertionError(f"resume: step {resumed.step}, {msgs[:1]}")
        log(f"  resumed from the interrupt checkpoint at step "
            f"{n_train // batch}, ran on to step {resumed.step}")
        del resumed

        # the best RL params through the CLI: compress, reassemble
        out = tmp / "compressed"
        cli(["compress", "--dataset-dir", str(val_dir), "--results-dir",
             str(out), "--checkpoint", str(best), "--device", device])
        n_slices = []
        for src in sorted(val_dir.glob("*.png")):
            rec = tmp / f"{src.stem}_rec.png"
            cli(["reassemble", str(out / src.stem), "-o", str(rec)])
            if not np.array_equal(load_image(rec),
                                  ensure_rgba(load_image(src))):
                raise AssertionError(f"{src.name}: not lossless")
            n_slices.append(len(list((out / src.stem).glob("slice_*.png"))))
        log(f"  compress --checkpoint best_params + reassemble: "
            f"{len(n_slices)} images lossless, slices per image {n_slices}")
        if cuda:
            log(f"  peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
                "GiB allocated")
    return launches, eval_msg


def smooth_costs(size: int, seed: int) -> np.ndarray:
    """Piecewise-smooth real-valued f32 costs [size, size, 2] from a numpy
    seed (16-pixel blocks of random colour plus noise; the shape of
    tests/test_torch_spatial.py's field)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(size // 16 + 1, size // 16 + 1, 3))
    img = np.repeat(np.repeat(base, 16, 0), 16, 1)[:size, :size]
    img = img + 0.1 * rng.standard_normal(img.shape, dtype=np.float32)
    img = (img - img.min()) / (img.max() - img.min())
    dh = np.abs(np.diff(img, axis=1, append=img[:, -1:])).sum(-1)
    dv = np.abs(np.diff(img, axis=0, append=img[-1:, :])).sum(-1)
    costs = np.stack([1.0 - 8.0 * dh, 1.0 - 8.0 * dv], axis=-1)
    return np.clip(costs, -2, 2).astype(np.float32)


def phase_spatial(torch, device: str, small: bool) -> int:
    """The spatially sharded solve (parallel/spatial.py) against the
    unsharded one on real-valued piecewise-smooth costs: labels bit for
    bit, the leaf kernel launched by the matrix runs' strips and by no
    pixel run; seconds and peak memory of both. Sharded canny on the card
    equals the CPU's. The leaf kernel at the 4096^2 strips' shape is held
    bitwise to its plain version. Returns the leaf launches of the sharded
    runs and the kernel's largest absolute difference from the plain
    version."""
    from image_compression_torch.ops import multicut_leaf as ml
    from image_compression_torch.ops.multicut import multicut_grid
    from image_compression_torch.ops.multicut_hier import (default_caps,
                                                           plan_levels)
    from image_compression_torch.parallel.mesh import make_mesh
    from image_compression_torch.parallel.spatial import (
        multicut_grid_spatial, sharded_edge_costs)

    cuda = device == "cuda"
    # pixel aggregation builds dense one-hot [1, 2 H W, S] operands at the
    # top level (~2 x 43 GB at 4096^2, ~2 x 19 GB at 2048^2), so its runs
    # are smaller than the matrix runs
    runs = ([("matrix", 128, 8), ("pixel", 128, 8)] if small else
            [("matrix", 4096, 4), ("matrix", 2048, 8), ("pixel", 1024, 4),
             ("pixel", 1024, 8)])
    if cuda and torch.cuda.device_count() > 1:
        runs.append(("matrix", 2048, torch.cuda.device_count()))
    launches, max_err = 0, 0.0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with phase("spatial solve"):
        warm = torch.as_tensor(smooth_costs(256, 0), device=device)
        for agg in ("matrix", "pixel"):
            multicut_grid(warm[None], icm_sweeps=0, hier_agg=agg)
            multicut_grid_spatial(warm, make_mesh([device] * 4), agg=agg)
        for i, (agg, size, n) in enumerate(runs):
            costs = torch.as_tensor(smooth_costs(size, 40 + i),
                                    device=device)
            devices = ([f"cuda:{k}" for k in range(n)]
                       if cuda and i == 4 else [device] * n)
            mesh = make_mesh(devices)
            times, peaks = [], []
            for sharded in (False, True):
                sync()
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                n0 = leaf_launches()
                t0 = time.perf_counter()
                if sharded:
                    labels = multicut_grid_spatial(costs, mesh, agg=agg)
                else:
                    whole = multicut_grid(costs[None], icm_sweeps=0,
                                          hier_agg=agg)[0]
                sync()
                times.append(time.perf_counter() - t0)
                peaks.append(f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
                             if cuda else "not measured")
                delta = leaf_launches() - n0
            if not torch.equal(labels.to(whole.device), whole):
                raise AssertionError(f"spatial {agg} {size}^2 over {n}: "
                                     "labels differ from the unsharded "
                                     "solve")
            if cuda and (delta > 0) != (agg == "matrix"):
                raise AssertionError(f"spatial {agg} {size}^2: leaf "
                                     f"launches {delta}")
            if agg == "matrix":
                launches += delta
            log(f"  {agg} {size}x{size} over {n} strips "
                f"({'cards ' + str(devices) if i == 4 else devices[0]}): "
                f"sharded {times[1]:.4f} s, unsharded {times[0]:.4f} s; "
                f"peak GiB allocated {peaks[1]} / {peaks[0]}; "
                f"{int(torch.unique(whole).numel())} regions; labels "
                f"equal bit for bit; leaf launches in the strips {delta}")
        if cuda:
            # the leaf kernel at the 4096^2 strips' shapes (4 x 1024x4096:
            # 65,536 supertiles, the default caps' s1 = 128, the default
            # schedule's rounds (3, 2)): bitwise to the plain version on
            # integer costs, then timed on the real-valued strips
            s1 = int(default_caps(plan_levels(4096, 4096))[1])
            strips = (4, 1024, 4096, 2)
            ints = np.random.default_rng(41).integers(-8, 9, size=strips)
            err, _ = _leaf_equal(torch, ml, "4096^2 strips, integer costs",
                                 ints, s1, 3, 2)
            max_err = max(max_err, err)
            # the third level-0 and second level-1 rounds did work there
            inputs = ml.leaf_inputs(torch.as_tensor(
                ints.astype(np.float32), device="cuda"))
            if all(torch.equal(a, b) for a, b in zip(
                    ml.leaf_cuda(*inputs, s1, 3, 2, 1024 * 4096),
                    ml.leaf_cuda(*inputs, s1, 2, 1, 1024 * 4096))):
                raise AssertionError("rounds (3, 2) changed nothing over "
                                     "(2, 1) on the strips' integer costs")
            del inputs
            costs = torch.as_tensor(smooth_costs(4096, 40), device="cuda")
            args = (*ml.leaf_inputs(costs.reshape(strips)), s1, 3, 2,
                    1024 * 4096)
            k_ms = cuda_ms(torch, lambda: ml.leaf_cuda(*args), iters=10)
            p_ms = cuda_ms(torch, lambda: ml.leaf_plain(*args), iters=2,
                           warmup=1)
            b_ms, b_by = leaf_bound(args[0].shape[0], s1, 3, 2)
            log(f"  leaf in the 4096^2 strips (T1={args[0].shape[0]}, "
                f"s1={s1}, rounds (3, 2)): {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        side, n = (64, 4) if small else (1024, 4)
        img = torch.as_tensor(np.stack(make_images(1, side, side, seed=51))[0]
                              / 255.0, dtype=torch.float32)
        want = sharded_edge_costs(img, make_mesh(["cpu"] * n))
        t0 = time.perf_counter()
        got = sharded_edge_costs(img.to(device), make_mesh([device] * n))
        sync()
        dt = time.perf_counter() - t0
        if not torch.equal(got.cpu(), want):
            raise AssertionError("sharded canny differs from the CPU's")
        log(f"  sharded canny {side}x{side} over {n} strips on {device}: "
            f"{dt:.4f} s; equals the CPU's sharded canny on every entry")
    return launches, max_err


def _jsonl(d: pathlib.Path) -> list[dict]:
    (path,) = d.glob("metrics_*.jsonl")
    return [{k: v for k, v in json.loads(line).items()
             if k not in ("time", "seconds")}  # the host's clock
            for line in path.read_text().splitlines()]


def step_rates(torch, device: str, cfg, base: int, train_dir, batch: int
               ) -> None:
    """Steps/s of the pretrain and RL steps with the group's reductions
    (data_parallel=True) and without them, in turns on one batch."""
    from image_compression_torch.models.unet import EdgeUNet
    from image_compression_torch.ops import prng
    from image_compression_torch.ops.targets import create_target_with_mask
    from image_compression_torch.train import steps
    from image_compression_torch.train.data import ImageBatches

    imgs, sizes = next(ImageBatches(sorted(train_dir.glob("*.png")), batch,
                                    cfg.image_size, with_file_sizes=True
                                    ).epoch(0, shuffle=False))
    x = torch.as_tensor(imgs).to(device)
    s = torch.as_tensor(sizes).to(device)
    with torch.no_grad():
        targets = create_target_with_mask(x, cfg.edge_target)
    state = steps.init_train_state(EdgeUNet(base=base), cfg, 0, device)
    rl_state = steps.init_rl_state(
        steps.init_train_state(EdgeUNet(base=base), cfg, 0, device).model,
        cfg)
    key = prng.prng_key(0)
    runs = {}
    for dp in (True, False):
        pre = steps.make_pretrain_step(cfg, data_parallel=dp)
        rl = steps.make_rl_step(cfg, data_parallel=dp)
        runs[dp] = (lambda pre=pre: pre(state, x, targets),
                    lambda rl=rl: rl(rl_state, key, x, s))
        for fn in runs[dp]:
            fn()  # warm-up
    rates: dict = {}
    for dp in (True, False, False, True):
        for kind, fn, n in (("pretrain", runs[dp][0], 5),
                            ("RL", runs[dp][1], 3)):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            if device == "cuda":
                torch.cuda.synchronize()
            rates.setdefault((kind, dp), []).append(
                n / (time.perf_counter() - t0))
    log(f"  steps/s at {batch} images a step (group reductions on; off), "
        "two turns each: " + "; ".join(
            f"{kind} {', '.join(f'{r:.3f}' for r in rates[(kind, True)])}"
            f"; {', '.join(f'{r:.3f}' for r in rates[(kind, False)])}"
            for kind in ("pretrain", "RL")))


def phase_data_parallel(torch, device: str, small: bool) -> int:
    """The training loops with use_mesh=True inside a process group of
    one rank (NCCL on the card, gloo on the CPU; file:// rendezvous): 2
    pretrain steps then 2 RL steps at the flagship width, whose losses,
    rewards, metrics and parameters equal bit for bit the same loops' run
    without a process group. Returns the group run's leaf launches."""
    import torch.distributed as dist

    from image_compression_torch.config import Config
    from image_compression_torch.models.unet import EdgeUNet
    from image_compression_torch.utils import profiling
    from image_compression_torch.parallel import mesh
    from image_compression_torch.train.pretrain import run_pretraining
    from image_compression_torch.train.reinforce import run_reinforce

    size, base, batch = (32, 8, 2) if small else (256, 64, 8)
    cuda = device == "cuda"
    deterministic = torch.backends.cudnn.deterministic
    with phase("data parallel"), tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        train_dir, val_dir = write_training_corpus(tmp / "data", 2 * batch,
                                                   batch, size)
        # cuDNN's default backward algorithms may sum in any order
        torch.backends.cudnn.deterministic = True
        results = {}
        try:
            for name in ("no group", "group"):
                if name == "group":
                    mesh.initialize_distributed(
                        "file://" + str(tmp / "rendezvous"), 1, 0, device)
                    log(f"  process group: backend "
                        f"{dist.get_backend()}, world {mesh.world()}")
                cfg = Config(dataset_dir=str(train_dir),
                             val_dataset_dir=str(val_dir),
                             results_dir=str(tmp / name / "pre"),
                             cache_dir=str(tmp / name / "cache"),
                             image_size=size)
                cfg.pretrain.batch_size = cfg.rl.batch_size = batch
                cfg.pretrain.epochs = cfg.rl.epochs = 1
                cfg.rl.sampler, cfg.rl.eval_every = "antithetic", 1
                cfg.reward.fallback_aware = True
                t0 = time.perf_counter()
                pre, _ = run_pretraining(cfg, log=lambda *_: None,
                                         device=device,
                                         model=EdgeUNet(base=base),
                                         use_mesh=True)
                if cuda:
                    torch.cuda.synchronize()
                t_pre = time.perf_counter() - t0
                params = {k: v.detach().clone()
                          for k, v in pre.model.state_dict().items()}
                cfg.results_dir = str(tmp / name / "rl")
                profiling.reset()
                t0 = time.perf_counter()
                rl, _ = run_reinforce(cfg, params, log=lambda *_: None,
                                      device=device, use_mesh=True)
                if cuda:
                    torch.cuda.synchronize()
                t_rl = time.perf_counter() - t0
                results[name] = dict(
                    pre=params, rl=rl.model.state_dict(),
                    baseline=rl.baseline.clone(), launches=leaf_launches(),
                    records=_jsonl(tmp / name / "pre")
                    + _jsonl(tmp / name / "rl"), step=(pre.step, rl.step))
                log(f"  {name}: run_pretraining {pre.step} steps "
                    f"{t_pre:.3f} s, run_reinforce {rl.step} steps "
                    f"{t_rl:.3f} s (with validation, evaluation and "
                    f"checkpoints); leaf launches {leaf_launches()}")
                del pre, rl
            step_rates(torch, device, cfg, base, train_dir, batch)
        finally:
            if mesh.distributed():
                dist.destroy_process_group()
            torch.backends.cudnn.deterministic = deterministic
        a, b = results["no group"], results["group"]
        same = (a["step"] == b["step"] == (2, 2)
                and a["records"] == b["records"]
                and torch.equal(a["baseline"], b["baseline"])
                and all(torch.equal(a[k][p], b[k][p])
                        for k in ("pre", "rl") for p in a[k]))
        if not same:
            raise AssertionError(f"data parallel: the group's run differs: "
                                 f"{a['records']} vs {b['records']}")
        if cuda and b["launches"] < 2:
            raise AssertionError(f"data parallel: {b['launches']} leaf "
                                 "launches in 2 RL steps")
        rl_rec = [r for r in b["records"] if r.get("phase") == "rl"]
        log(f"  group equals no group bit for bit: {len(b['records'])} "
            f"JSONL records (losses, rewards, metrics), baseline "
            f"{float(b['baseline']):.6f}, every parameter of both phases; "
            f"RL reward means {[r['reward_mean'] for r in rl_rec]}")
    return b["launches"]


def phase_convert(torch, device: str) -> None:
    """The CLI's convert on 6 PNGs (480x640 and 300x200, the port's
    writer) on the device: every output decodes as 256x256 RGB and is
    within 1 level of the port's CPU converter on the same files."""
    import shutil

    from image_compression_torch.io import pypng
    from image_compression_torch.io.converter import convert_dataset
    from image_compression_torch.io.image_io import load_image

    with phase("convert"), tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        src = tmp / "card"
        src.mkdir()
        shapes = [(480, 640)] * 3 + [(300, 200)] * 3
        for i, (h, w) in enumerate(shapes):
            img = make_images(1, h, w, seed=60 + i)[0]
            (src / f"img{i}.png").write_bytes(pypng.encode(img))
        shutil.copytree(src, tmp / "cpu")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "image_compression_torch.cli.main",
             "convert", "--dataset-dir", str(src), "--source-format", "png",
             "--device", device], cwd=REPO, capture_output=True, text=True,
            timeout=600, env={**__import__("os").environ,
                              "PYTHONPATH": str(REPO)})
        dt = time.perf_counter() - t0
        if out.returncode != 0 or "converted 6 images" not in out.stdout:
            raise AssertionError(f"convert: {out.stdout}{out.stderr}")
        convert_dataset(tmp / "cpu", "png", device="cpu")
        worst, share = 0, 0.0
        for i in range(len(shapes)):
            got = load_image(src / f"img{i}.png").astype(int)
            want = load_image(tmp / "cpu" / f"img{i}.png").astype(int)
            if got.shape != (256, 256, 3) or want.shape != got.shape:
                raise AssertionError(f"convert: shape {got.shape}")
            diff = np.abs(got - want)
            worst = max(worst, int(diff.max()))
            share = max(share, float((diff > 0).mean()))
        if worst > 1:
            raise AssertionError(f"convert on {device}: {worst} levels off "
                                 "the CPU converter")
        log(f"  6 PNGs (3 x 480x640, 3 x 300x200) -> 256x256 by the CLI on "
            f"{device} in {dt:.3f} s (with the interpreter's start); "
            f"outputs decode; within {worst} level of the CPU converter, "
            f"at most {share:.4f} of entries differ")


def trace_busy(events: list[dict], device: str) -> dict:
    """Kernel events of a device_trace around one "compress_batch" range:
    the trace must name leaf_kernel (on the card); returns the kernel
    count, the device's busy ms (union of the kernels' intervals), the
    range's wall ms and a printable summary."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    leaf = [e for e in kernels if "leaf_kernel" in e.get("name", "")]
    if device == "cuda" and not leaf:
        raise AssertionError("the trace names no leaf_kernel")
    ranged = [e for e in events if e.get("name") == "compress_batch"]
    if not ranged:
        raise AssertionError("the trace lacks the annotated range")
    out = {"kernels": len(kernels), "busy_ms": None, "wall_ms": None,
           "text": f", leaf_kernel events {len(leaf)}"}
    if kernels:
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
        total, end = 0.0, -1.0
        for t0, t1 in spans:  # union of the kernels' intervals
            total += max(0.0, t1 - max(t0, end))
            end = max(end, t1)
        wall = max(e["dur"] for e in ranged)
        out.update(busy_ms=total / 1e3, wall_ms=wall / 1e3)
        out["text"] += (f"; {len(kernels)} kernels, device busy "
                        f"{total / 1e3:.3f} ms of the {wall / 1e3:.3f} ms "
                        f"batch ({total / wall:.4f})")
    return out


def phase_trace(torch, device: str, base: int, side: int) -> dict:
    """One 8-image learned-cost compress batch inside device_trace: the
    trace names the leaf kernel (on the card), and the batch's snapshot of
    the program's spans and counters is printed with the device's busy
    share of the traced batch (returned as trace_busy gives it)."""
    from image_compression_torch import pipeline
    from image_compression_torch.config import Config
    from image_compression_torch.models.unet import EdgeUNet, init_random_
    from image_compression_torch.utils.profiling import device_trace, span

    with phase("trace"), tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        model = init_random_(EdgeUNet(base=base), seed=0).to(device).eval()
        with torch.no_grad():
            model.outc.bias[0::2] = 1.0
        images = make_images(8, side, side, seed=1)
        names = [f"img{j}" for j in range(8)]
        cfg = Config()

        def cost_fn(b):
            return pipeline.learned_costs(model, b)

        pipeline.compress_arrays(images, cost_fn, cfg, tmp / "warm", names,
                                 device=device)
        with device_trace(tmp / "trace") as handle:
            with span("compress_batch", device):
                pipeline.compress_arrays(images, cost_fn, cfg, tmp / "out",
                                         names, device=device)
        events = json.loads(handle.path.read_text())["traceEvents"]
        busy = trace_busy(events, device)
        log(f"  trace {handle.path.name}: {len(events)} events{busy['text']}")
        spans = json.loads(handle.spans_path.read_text())
        log("  " + json.dumps({k: spans[k] for k in ("spans", "counters")}))
    return busy

WEIGHTS = REPO / "image_compression_torch" / "weights"
FLAGSHIP = WEIGHTS / "fcn_pretrained_r4_mixed.pt"
FLAGSHIP_RECORD = WEIGHTS / "flagship_mixed_reference.json"
# the f32 run against the JAX package's record: every image keeps the
# record's fallback decision, all but n // F32_UNEQUAL_PER images (1 in
# 16: 2 of 32, 0 of 4) write files byte-equal to the record's, and the
# total out/orig stays within F32_OUT_ORIG_TOL of the record's. The port's
# f32 run met every image's bytes, on the CPU and on an H100; the slack is
# for a near-tie merge between regions, which the U-Net's last bits decide
# and which cuDNN, oneDNN and XLA sum in their own orders (1.92e-5 x max
# apart on the CPU, tests/test_torch_weights.py). 0.0005 lets those images'
# slicings move by ~1.4 KB in total
F32_UNEQUAL_PER = 16
F32_OUT_ORIG_TOL = 0.0005


def flagship_outputs(data: pathlib.Path, out: pathlib.Path) -> list[dict]:
    """io/reassemble.output_record of every source PNG (sorted): the
    record's entries. Every output must reassemble to its source and be at
    most the source plus a one-slice metadata record (the never-expand
    guarantee)."""
    from image_compression_torch.io.image_io import ensure_rgba, load_image
    from image_compression_torch.io.metadata import (SliceMetadata,
                                                     encode_metadata)
    from image_compression_torch.io.reassemble import (output_record,
                                                       reassemble_array)

    entries = []
    for src in sorted(data.glob("*.png")):
        img = load_image(src)
        h, w = img.shape[:2]
        record = len(encode_metadata(
            [SliceMetadata(0, "slice_0.png", 0, 0, w, h)], w, h))
        entry = output_record(src, out / src.stem)
        if not np.array_equal(reassemble_array(out / src.stem),
                              ensure_rgba(img)):
            raise AssertionError(f"flagship {src.stem}: not lossless")
        if entry["out_bytes"] > src.stat().st_size + record:
            raise AssertionError(f"flagship {src.stem}: {entry['out_bytes']}"
                                 f" bytes out of {src.stat().st_size} + "
                                 f"{record}")
        entries.append(entry)
    return entries


def phase_flagship(torch, device: str, small: bool,
                   random_eval: str | None,
                   random_busy: dict | None) -> tuple[int, float]:
    """The repo's trained flagship (fcn_pretrained_r4_mixed, the weights
    file) through the main path's entry points, held against the JAX
    package's own output (the record): compress_directory at the shipped
    settings on the first 32 images of the mixed corpus at 256x256 (4 of
    128x128 with --small), made here by the port's generators and written
    at zlib level 6, in bf16 (the shipped dtype, on the card only) and in
    f32. Every output is lossless and never expands; the f32 run keeps the
    record's fallback decision on every image, writes the record's bytes
    for all but 1 in F32_UNEQUAL_PER images, and its total out/orig is
    within F32_OUT_ORIG_TOL of the record's. On one batch's
    flagship costs the card's labels equal the CPU's (costs rounded to
    1/16) and the leaf kernel equals its plain version bitwise (unrounded
    costs). Then `train --checkpoint <weights>` through the CLI at the r4
    RL settings (16 + 8 images of 256x256, batch 8; on the CPU 4 + 2 of
    32x32, batch 2: 2 steps and an evaluation) gives finite rewards,
    launches the leaf kernel at every solve and changes the params, and
    its sampled costs' solve and reward equal the CPU's; and one batch is
    traced. Returns the bf16 compress run's leaf launches (the f32 run's
    on the CPU) and the leaf's largest absolute difference from its plain
    version."""
    from image_compression_torch import pipeline
    from image_compression_torch.cli.main import main as cli
    from image_compression_torch.config import Config
    from image_compression_torch.io.image_io import load_image, write_image
    from image_compression_torch.models.unet import EdgeUNet
    from image_compression_torch.ops import multicut_leaf as ml
    from image_compression_torch.ops import prng
    from image_compression_torch.train import steps
    from image_compression_torch.train.checkpoint import load_params
    from image_compression_torch.train.data import ImageBatches
    from image_compression_torch.utils import profiling
    from image_compression_torch.utils.pattern_generator import mixed_corpus

    cuda = device == "cuda"
    key = "small" if small else "full"
    record = json.loads(FLAGSHIP_RECORD.read_text())
    ref = record["runs"][key]
    n, size, batch = ref["n"], ref["size"], 8

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with phase("flagship"), tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        digest = hashlib.sha256(FLAGSHIP.read_bytes()).hexdigest()
        if digest != record["weights_sha256"]:
            raise AssertionError(f"{FLAGSHIP.name}: sha256 {digest}, the "
                                 f"record's {record['weights_sha256']}")
        params = load_params(FLAGSHIP)
        log(f"  weights {FLAGSHIP.relative_to(REPO)}: sha256 {digest} (the "
            f"record's); {sum(v.numel() for v in params.values())} f32 "
            f"parameters, base {params['inc.conv0.weight'].shape[0]}")
        data = tmp / "data"
        data.mkdir()
        for stem, img in mixed_corpus(n, size):
            write_image(data / f"{stem}.png", img, 6)
        paths = sorted(data.glob("*.png"))
        orig = {p.stem: p.stat().st_size for p in paths}
        log(f"  corpus: the mixed corpus' first {n} images at {size}x{size} "
            f"(seed 0, cells 64/128), zlib level 6: {sum(orig.values())} "
            f"bytes; each original's bytes equal the record's: "
            f"{orig == ref['orig_bytes']}")

        models = {}
        for name, dtype in ((("bf16", torch.bfloat16),
                             ("f32", torch.float32)) if cuda else
                            (("f32", torch.float32),)):
            model = EdgeUNet(base=64, dtype=dtype)
            model.load_state_dict(params)
            models[name] = model = model.to(device).eval()
            cfg = Config(dataset_dir=str(data),
                         results_dir=str(tmp / name))
            if cuda:  # warm-up batch
                warm = tmp / "warm"
                warm.mkdir(exist_ok=True)
                for p in paths[:batch]:
                    (warm / p.name).write_bytes(p.read_bytes())
                pipeline.compress_directory(
                    Config(dataset_dir=str(warm),
                           results_dir=str(tmp / f"warm_{name}")),
                    model, device=device)
            timings: dict = {}
            profiling.reset()
            t0 = time.perf_counter()
            pipeline.compress_directory(cfg, model, batch_size=batch,
                                        device=device, timings=timings)
            elapsed = time.perf_counter() - t0
            launches = leaf_launches()
            if name == "bf16" or not cuda:
                flagship_launches = launches
            if cuda and launches < -(-n // batch):
                raise AssertionError(f"flagship {name}: {launches} leaf "
                                     f"launches for {n} images")
            got = flagship_outputs(data, tmp / name)
            want = ref[name]
            ratio = sum(e["out_bytes"] for e in got) / sum(orig.values())
            slices = [e["slices"] for e in got]
            same = sum(a["fallback"] == b["fallback"]
                       for a, b in zip(got, want["images"]))
            equal = sum(a["sha256"] == b["sha256"]
                        for a, b in zip(got, want["images"]))
            log(f"  {name}: {n} images lossless, none above its original "
                f"plus a one-slice record; {n / elapsed:.3f} images/s "
                f"({elapsed:.3f} s); out/orig {ratio:.6f}, the JAX "
                f"package's {want['out_orig']:.6f} (difference "
                f"{ratio - want['out_orig']:+.6f}); fallback decisions as "
                f"the record's on {same} of {n}; output bytes equal the "
                f"JAX package's on {equal} of {n}; slices per image {slices}; "
                f"single-slice share {slices.count(1) / n:.4f}; leaf "
                f"launches {launches}")
            log(f"  {name} stage seconds: " + ", ".join(
                f"{k} {v:.4f}" for k, v in timings.items())
                + " (write runs in a worker thread)")
            if name == "f32" and (
                    same < n or equal < n - n // F32_UNEQUAL_PER
                    or abs(ratio - want["out_orig"]) > F32_OUT_ORIG_TOL):
                raise AssertionError(
                    f"flagship f32: {same} of {n} decisions and {equal} of "
                    f"{n} images' bytes as the record's (at least "
                    f"{n - n // F32_UNEQUAL_PER}), out/orig {ratio} vs "
                    f"{want['out_orig']} (within {F32_OUT_ORIG_TOL})")
        if "pixel_bf16" in ref:
            log(f"  the JAX package's shipped hier_agg 'pixel' (bf16), for "
                f"context: out/orig {ref['pixel_bf16']['out_orig']:.6f}")

        # one batch's flagship costs: the solver against the CPU, the leaf
        # kernel against its plain version
        model = models["bf16" if cuda else "f32"]
        images = [load_image(p) for p in paths[:batch]]
        with torch.inference_mode():
            x = torch.as_tensor(np.stack(images) / 255.0,
                                dtype=torch.float32, device=device)
            costs = pipeline.learned_costs(model, x)
        check_solver_on_batch(torch, make_solve(pipeline, Config().multicut),
                              costs, device)
        max_err = 0.0
        if cuda:
            max_err, _ = _leaf_equal(torch, ml, "flagship costs",
                                     costs.cpu().numpy(), 64)
            args = (*ml.leaf_inputs(costs), 64, 2, 1, size * size)
            k_ms = cuda_ms(torch, lambda: ml.leaf_cuda(*args))
            p_ms = cuda_ms(torch, lambda: ml.leaf_plain(*args), iters=5)
            b_ms, b_by = leaf_bound(args[0].shape[0], 64, 2, 1)
            log(f"  leaf on the flagship's costs (T1={args[0].shape[0]}, "
                f"s1=64): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")

        # REINFORCE from the flagship through the CLI, r4 RL settings
        rl_size, rl_batch = (256, 8) if cuda else (32, 2)
        train_dir, val_dir = write_training_corpus(tmp / "rl_data",
                                                   2 * rl_batch, rl_batch,
                                                   rl_size)
        cfg = Config(dataset_dir=str(train_dir), val_dataset_dir=str(val_dir),
                     results_dir=str(tmp / "rl"), cache_dir=str(tmp / "c"),
                     image_size=rl_size)
        cfg.rl.sampler, cfg.rl.baseline, cfg.rl.ppo_epochs = ("antithetic",
                                                              "ema", 0)
        cfg.rl.whiten, cfg.rl.lr, cfg.rl.entropy_coef = False, 2e-5, 1e-5
        cfg.rl.epochs, cfg.rl.batch_size = 1, rl_batch
        cfg.reward.fallback_aware = True
        cfg_path = tmp / "r4_rl.json"
        cfg_path.write_text(json.dumps(cfg.to_dict()))
        profiling.reset()
        t0 = time.perf_counter()
        cli(["train", "--config", str(cfg_path), "--checkpoint",
             str(FLAGSHIP), "--device", device])
        sync()
        dt = time.perf_counter() - t0
        rl_launches = leaf_launches()
        records = _jsonl(tmp / "rl")
        (final,) = (tmp / "rl").glob("fcn_training_*_final")
        trained = load_params(final)
        changed = any(not torch.equal(trained[k], v)
                      for k, v in params.items())
        rewards = [r[k] for r in records
                   for k in ("reward_mean", "eval_reward_mean")]
        if (len(records) != 1 or records[0]["step"] != 2 or not changed
                or not all(np.isfinite(rewards))):
            raise AssertionError(f"train from the flagship: records "
                                 f"{records}, params changed {changed}")
        if cuda and rl_launches < 3:  # 2 steps + 1 evaluation batch
            raise AssertionError(f"train from the flagship: {rl_launches} "
                                 f"leaf launches in 2 steps + 1 evaluation")
        log(f"  train --checkpoint {FLAGSHIP.name} (r4 RL settings, "
            f"{2 * rl_batch} + {rl_batch} images {rl_size}x{rl_size}, batch "
            f"{rl_batch}): 2 steps and an evaluation in {dt:.3f} s "
            f"({2 / dt:.3f} steps/s with the evaluation and checkpoints); "
            f"reward mean {records[0]['reward_mean']:.6f}, eval reward "
            f"{records[0]['eval_reward_mean']:.6f} (phase 9 from pretrained "
            f"random weights: {random_eval or 'not run'}); params changed; "
            f"leaf launches {rl_launches}")
        rl_state = steps.init_rl_state(EdgeUNet(base=64).to(device), cfg)
        rl_state.model.load_state_dict(params)
        imgs, sizes = next(ImageBatches(sorted(train_dir.glob("*.png")),
                                        rl_batch, rl_size,
                                        with_file_sizes=True).epoch(0))
        check_rl_solve(torch, cfg, steps.make_rl_step(cfg), rl_state,
                       prng.prng_key(0), torch.as_tensor(imgs).to(device),
                       torch.as_tensor(sizes).to(device))
        del rl_state

        # one batch traced (bf16 on the card)
        with profiling.device_trace(tmp / "trace") as handle:
            with profiling.span("compress_batch"):
                pipeline.compress_arrays(
                    images, lambda b: pipeline.learned_costs(model, b),
                    Config(), tmp / "traced", [p.stem for p in
                                               paths[:batch]],
                    device=device)
        busy = trace_busy(json.loads(handle.path.read_text())["traceEvents"],
                          device)
        log(f"  trace of one flagship batch{busy['text']}; phase 13 "
            f"(random weights): " + (random_busy["text"].lstrip(", ")
                                     if random_busy else "not run"))
    return flagship_launches, max_err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="64x64 images, base-8 U-Net (CPU rehearsal)")
    args = ap.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA GPU (or --device cpu)", file=sys.stderr)
        return 2
    import image_compression_torch  # noqa: F401  (fails outside the repo)
    if args.device == "cpu":
        # the CPU's float sums depend on the thread count; pin it so that
        # the rehearsal does not depend on the machine's cores
        torch.set_num_threads(CPU_THREADS)

    side, base = (64, 8) if args.small else (256, 64)
    batch = 8

    def run(batch, height, width, bias, seed, agg="matrix", need_slices=True,
            why_no_leaf=None):
        return dict(batch=batch, height=height, width=width, bias=bias,
                    seed=seed, agg=agg, need_slices=need_slices,
                    check_leaf=why_no_leaf is None, why_no_leaf=why_no_leaf)

    # the square batch first (its launches go into the kernels line), then
    # a non-square batch that finishes with the sorted rounds. The sorted
    # finish has no slot caps and joins every pair of regions whose summed
    # cost is > 0: at a lean of 1.0 the non-square batch kept no slicing
    # (PERF.md, section 4). Which of its images keep one hangs on the signs
    # of a few of its 786,432 edges, which the first convolution's input
    # layout alone moves (2 to 20 flips): at 0.8 the chain kept slicings and
    # the GroupNorm kernel none, at 0.6 both keep some. Then the square
    # batch again with the reference's shipped pixel aggregation, and 8
    # tiny images (the tiny-grid ensemble), neither of which runs the leaf
    # kernel
    runs = [run(batch, side, side, 1.0, seed=1),
            run(1, 48, 80, 1.0, seed=2) if args.small
            else run(4, 256, 384, 0.6, seed=2),
            run(batch, side, side, 1.0, seed=1, agg="pixel",
                why_no_leaf="pixel aggregation has no leaf kernel"),
            run(batch, 12, 12, 1.0, seed=4, need_slices=False,
                why_no_leaf="sides under 16 take the sorted ensemble")]
    phase_env(torch, args.device)
    if args.device == "cpu":
        log(f"torch threads: {torch.get_num_threads()} (pinned)")
    kernels = []
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_build()
    if args.device == "cuda":
        kernels.append(phase_leaf(torch, batch, side))
        kernels.append(phase_norm(torch, batch))
    launches = phase_main(torch, args.device, runs, base)
    phase_solver_configs(torch, args.device)
    if args.device == "cuda":
        phase_big_field(torch)
    phase_extractors(torch, args.device, 64)
    phase_classical(torch, args.device, side, 4 if args.small else batch)
    if args.device == "cuda":
        phase_photo(torch)
    train_launches, train_eval = phase_training(torch, args.device,
                                                args.small)
    spatial_launches, spatial_err = phase_spatial(torch, args.device,
                                                  args.small)
    dp_launches = phase_data_parallel(torch, args.device, args.small)
    phase_convert(torch, args.device)
    busy = phase_trace(torch, args.device, base, side)
    flagship_launches, flagship_err = phase_flagship(
        torch, args.device, args.small, train_eval, busy)

    if args.device == "cuda":
        kernels[0]["launches"] = launches[0]
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                        spatial_err, flagship_err)
        kernels[0]["launches_by_path"] = {"compress": launches[0],
                                          "training": train_launches,
                                          "spatial": spatial_launches,
                                          "data_parallel": dp_launches,
                                          "flagship": flagship_launches}
        log(json.dumps({"kernels": kernels}))
        log(gpu_name_and_limit())
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()}
    else:
        device = {"platform": "cpu", "kind": platform.processor() or "cpu",
                  "count": 1}
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
