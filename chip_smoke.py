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
     bit for bit; times at level-1 caps 64 and 128;
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
     seconds and peak memory.
Then one JSON line describing each kernel, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Any failure exits
non-zero before that line. Without a GPU (and without --device cpu) the
script exits non-zero at once.

--device cpu --small runs phases 0, 3, 4, 6 and 7 on the CPU at 64x64 (and
one 48x80 image; phase 7 on 8 + 4 images of 64x64 and 64x96 in batches of
4; the tiny cases as they are) with a base-8 U-Net, through the plain
versions of the kernels; phase 6 then compares the CPU with itself, and
there is no 3648x5472 field and no photo.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import platform
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, same sheet
REPO = pathlib.Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


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


def _leaf_equal(torch, ml, name: str, costs: np.ndarray,
                s1: int) -> tuple[float, int]:
    """Kernel vs plain version on one input, every field bitwise; returns
    the largest absolute difference (0) and the regions frozen."""
    fields = ("rank", "gid", "sym", "m", "ncand", "over")
    costs = torch.as_tensor(costs.astype(np.float32), device="cuda")
    args = (*ml.leaf_inputs(costs), s1, 2, 1,
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
    log(f"  {name} (T1={args[0].shape[0]}, s1={s1}): all fields bitwise "
        f"equal, {int(got[5].sum())} regions frozen")
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
    from image_compression_torch.ops import multicut_leaf
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
                multicut_leaf.launches = 0
                t0 = time.perf_counter()
                dirs = pipeline.compress_arrays(images, cost_fn, cfg,
                                                tmp / "out", names,
                                                device=device,
                                                timings=timings)
                elapsed = time.perf_counter() - t0
                launches = multicut_leaf.launches
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
    from image_compression_torch.ops import multicut_leaf
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
        multicut_leaf.launches = 0
        t0 = time.perf_counter()
        labels = multicut_grid(costs, **kw)[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = multicut_leaf.launches
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
    from image_compression_torch.ops import multicut_leaf

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
            multicut_leaf.launches = 0
            t0 = time.perf_counter()
            outs = pipeline.compress_directory(cfg, classical=target,
                                               batch_size=batch,
                                               device=device,
                                               timings=timings)
            elapsed = time.perf_counter() - t0
            launches = multicut_leaf.launches
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
    from image_compression_torch.ops import multicut_leaf
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
        multicut_leaf.launches = 0
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
            f"launches {multicut_leaf.launches}")


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
    # (PERF.md, section 4), at 0.8 it does. Then the square batch again
    # with the reference's shipped pixel aggregation, and 8 tiny images
    # (the tiny-grid ensemble), neither of which runs the leaf kernel
    runs = [run(batch, side, side, 1.0, seed=1),
            run(1, 48, 80, 1.0, seed=2) if args.small
            else run(4, 256, 384, 0.8, seed=2),
            run(batch, side, side, 1.0, seed=1, agg="pixel",
                why_no_leaf="pixel aggregation has no leaf kernel"),
            run(batch, 12, 12, 1.0, seed=4, need_slices=False,
                why_no_leaf="sides under 16 take the sorted ensemble")]
    phase_env(torch, args.device)
    kernels = []
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_build()
        kernels.append(phase_leaf(torch, batch, side))
    launches = phase_main(torch, args.device, runs, base)
    phase_solver_configs(torch, args.device)
    if args.device == "cuda":
        phase_big_field(torch)
    phase_extractors(torch, args.device, 64)
    phase_classical(torch, args.device, side, 4 if args.small else batch)
    if args.device == "cuda":
        phase_photo(torch)

    if args.device == "cuda":
        kernels[0]["launches"] = launches[0]
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
