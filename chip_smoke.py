#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (image_compression_torch) on one GPU.

    python3 chip_smoke.py                      # on a machine with a CUDA GPU
    python3 chip_smoke.py --device cpu --small # CPU rehearsal, plain versions

Phases, each printing one line with its own seconds:
  0. environment: Python, torch, CUDA, nvcc, the card's name and power limit;
  1. build: nvcc compiles every kernel source of the port (in parallel);
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
     kernel of the path must have launched in each run.
Then one JSON line describing each kernel, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Any failure exits
non-zero before that line. Without a GPU (and without --device cpu) the
script exits non-zero at once.

--device cpu --small runs phases 0 and 3 on the CPU at 64x64 (and one
48x80 image) with a base-8 U-Net, through the plain versions of the
kernels.
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


def phase_env(torch, device: str) -> None:
    with phase("env"):
        log(f"python {platform.python_version()} torch {torch.__version__} "
            f"cuda {torch.version.cuda} device {device}")
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
    """nvcc every kernel source at once; print ptxas' resource lines."""
    from concurrent.futures import ThreadPoolExecutor

    from image_compression_torch import kernels
    names = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    with phase("build"):
        with ThreadPoolExecutor(len(names)) as pool:
            futures = {n: pool.submit(kernels.build, n) for n in names}
        for name, fut in futures.items():
            try:
                path, stderr = fut.result()
            except kernels.BuildError as e:
                log(f"nvcc failed for {name}:\n{e.stderr}")
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
    noise), rotated across images. Sides are multiples of 16."""
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
                                (h // 8, w // 8, 1))
            else:
                patch = (rng.integers(0, 12, (h, w, 3))
                         + rng.integers(0, 240, 3)).astype(np.uint8)
            img[y0:y0 + h, x0:x0 + w] = patch
        images.append(img)
    return images


def check_solver_on_batch(torch, solve, costs, device: str) -> None:
    """The solver on a batch's own learned costs: two solves of the
    real-valued costs give the same labels (fixed-order sums), and on the
    card the labels equal the CPU's on the costs rounded to multiples of
    1/16 (exact in bf16 and in every f32 sum, so the order of the sums
    cannot matter). Prints the regions per image before the fallback."""
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


def phase_main(torch, device: str,
               runs: list[tuple[int, int, int, float]],
               base: int) -> list[int]:
    """The solver on the device against the CPU, then compress_arrays ->
    reassemble on seeded images with a seeded full-width U-Net, one run per
    (batch, height, width, mu bias); returns the leaf kernel's launches of
    each run."""
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
        cfg = Config()  # shipped settings; the port's solver is "matrix"
        assert cfg.multicut.hier_agg == "matrix"

        def cost_fn(b):
            return pipeline.learned_costs(model, b)

        def solve(costs):
            mc = cfg.multicut
            return pipeline.segment_batch(
                costs, mode=mc.mode, max_rounds=mc.max_rounds,
                icm_sweeps=mc.icm_sweeps,
                hier_rounds=tuple(mc.hier_rounds) if mc.hier_rounds else None,
                hier_caps=mc.hier_caps, hier_agg=mc.hier_agg,
                hier_leaf=mc.hier_leaf)

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
        for i, (batch, height, width, bias) in enumerate(runs):
            with torch.no_grad():
                model.outc.bias[0::2] = bias
            images = make_images(batch, height, width, seed=1 + i)
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
            if max(n_slices) < 2:
                raise AssertionError("every image fell back to one slice: "
                                     "the solver's labels reached no "
                                     "slicer or writer")
            log(f"  {batch} images {height}x{width}, mu bias {bias}: "
                f"{batch / elapsed:.3f} images/s ({elapsed:.3f} s); slices "
                f"per image {n_slices}; lossless")
            log("  stage seconds: " + ", ".join(
                f"{k} {v:.4f}" for k, v in timings.items()))
            log(f"  multicut_leaf launches: {launches}")
            if device == "cuda" and launches < 1:
                raise AssertionError("the main path did not launch the leaf "
                                     "kernel")
            all_launches.append(launches)
    return all_launches


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
    # the square batch first (its launches go into the kernels line), then
    # a non-square batch that finishes with the sorted rounds; (batch,
    # height, width, mu bias). The sorted finish has no slot caps and joins
    # every pair of regions whose summed cost is > 0: at a lean of 1.0 the
    # non-square batch kept no slicing (PERF.md, section 4), at 0.8 it does
    runs = [(batch, side, side, 1.0)] + ([(1, 48, 80, 1.0)] if args.small
                                         else [(4, 256, 384, 0.8)])
    phase_env(torch, args.device)
    kernels = []
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_build()
        kernels.append(phase_leaf(torch, batch, side))
    launches = phase_main(torch, args.device, runs, base)

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
