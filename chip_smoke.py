#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (image_compression_torch) on one GPU.

    python3 chip_smoke.py                      # on a machine with a CUDA GPU
    python3 chip_smoke.py --device cpu --small # CPU rehearsal, plain versions

Phases, each printing one line with its own seconds:
  0. environment: Python, torch, CUDA, nvcc, the card's name and power limit;
  1. build: nvcc compiles every kernel source of the port (in parallel);
  2. kernel vs plain: each kernel's wrapper against its plain PyTorch
     version on the card, at the main path's shapes (8 images of 256x256);
     bitwise on integer-valued costs, by objective on real-valued costs;
  3. main path: compress_arrays on 8 seeded 256x256 images with a full-width
     EdgeUNet (base 64, bf16, seeded random weights) and the shipped
     settings with hier_agg="matrix"; slices are reassembled and must be
     pixel-lossless, and every kernel of the path must have launched.
Then one JSON line describing each kernel, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Any failure exits
non-zero before that line. Without a GPU (and without --device cpu) the
script exits non-zero at once.

--device cpu --small runs phases 0 and 3 on the CPU at 64x64 with a base-8
U-Net, through the plain versions of the kernels.
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


def phase_leaf(torch, batch: int, side: int) -> dict:
    """The multicut leaf kernel against its plain version on the card."""
    from image_compression_torch.ops import multicut_leaf as ml
    from image_compression_torch.ops.multicut import (multicut_grid,
                                                      multicut_objective)
    fields = ("rank", "gid", "sym", "m", "ncand", "over")
    rng = np.random.default_rng(0)
    shape = (batch, side, side, 2)
    cases = [
        ("integer flat64", rng.integers(-8, 9, size=shape), 64),
        ("integer default caps", rng.integers(-8, 9, size=shape), 128),
        ("heavy freezing", -np.abs(rng.normal(size=shape)) - 0.1, 64),
    ]
    max_err = 0.0
    with phase("leaf kernel vs plain"):
        for name, costs, s1 in cases:
            costs = torch.as_tensor(costs.astype(np.float32), device="cuda")
            args = (*ml.leaf_inputs(costs), s1, 2, 1, side * side)
            got = ml.leaf_cuda(*args)
            want = ml.leaf_plain(*args)
            torch.cuda.synchronize()
            for f, a, b in zip(fields, got, want):
                if a.shape != b.shape:
                    raise AssertionError(f"leaf {name}: field {f} has shape "
                                         f"{tuple(a.shape)}, plain "
                                         f"{tuple(b.shape)}")
                diff = (a.double() - b.double()).abs().max().item()
                max_err = max(max_err, diff)
                if not torch.equal(a, b):
                    raise AssertionError(f"leaf {name}: field {f} differs "
                                         f"from the plain version by {diff}")
            over = int(got[5].sum())
            log(f"  {name} (s1={s1}): all fields bitwise equal, "
                f"{over} regions frozen")
            if name == "heavy freezing" and over <= 1000 * batch:
                raise AssertionError("heavy-freezing case did not freeze")

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

        # timing at the main path's shape (flat64: s1 = 64)
        args = (*ml.leaf_inputs(torch.as_tensor(
            cases[0][1].astype(np.float32), device="cuda")), 64, 2, 1,
            side * side)
        ms = cuda_ms(torch, lambda: ml.leaf_cuda(*args))
        plain_ms = cuda_ms(torch, lambda: ml.leaf_plain(*args), iters=5)
        t1 = args[0].shape[0]
        bound_ms, bound_by = leaf_bound(t1, 64, 2, 1)
        log(f"  T1={t1} s1=64: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "multicut_leaf", "route": "cuda",
            "source": "image_compression_torch/csrc/multicut_leaf.cu",
            "replaces": "image_compression_tpu/ops/multicut_leaf.py:91",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def make_images(n: int, side: int, seed: int) -> list[np.ndarray]:
    """Seeded uint8 RGB test images: each quadrant one of five patterns
    (flat colour, gradient, uniform noise, repeating tile, low-amplitude
    noise), rotated across images."""
    rng = np.random.default_rng(seed)
    h = side // 2
    ys, xs = np.mgrid[:h, :h]
    images = []
    for i in range(n):
        img = np.empty((side, side, 3), np.uint8)
        for q, (y0, x0) in enumerate(((0, 0), (0, h), (h, 0), (h, h))):
            kind = (i + q) % 5
            if kind == 0:
                patch = np.broadcast_to(rng.integers(0, 256, 3, np.uint8),
                                        (h, h, 3))
            elif kind == 1:
                patch = np.stack([(ys + xs) * 255 // (2 * h - 2),
                                  ys * 255 // (h - 1),
                                  xs * 255 // (h - 1)], -1).astype(np.uint8)
            elif kind == 2:
                patch = rng.integers(0, 256, (h, h, 3), np.uint8)
            elif kind == 3:
                patch = np.tile(rng.integers(0, 256, (8, 8, 3), np.uint8),
                                (h // 8, h // 8, 1))
            else:
                patch = (rng.integers(0, 12, (h, h, 3))
                         + rng.integers(0, 240, 3)).astype(np.uint8)
            img[y0:y0 + h, x0:x0 + h] = patch
        images.append(img)
    return images


def phase_main(torch, device: str, batch: int, side: int, base: int) -> int:
    """compress_arrays -> reassemble on seeded images with a seeded
    full-width U-Net; returns the leaf kernel's launches in that run."""
    from image_compression_torch import pipeline
    from image_compression_torch.config import Config
    from image_compression_torch.io.image_io import ensure_rgba
    from image_compression_torch.io.reassemble import reassemble_array
    from image_compression_torch.models.unet import EdgeUNet, init_random_
    from image_compression_torch.ops import multicut_leaf
    from image_compression_torch.ops.multicut import multicut_grid

    with phase("main path"):
        images = make_images(batch, side, seed=1)
        names = [f"img{i}" for i in range(batch)]
        model = init_random_(EdgeUNet(base=base), seed=0)
        # a zero-bias random net cuts almost every edge and every image
        # falls back to one slice; leaning the mu logits toward "connect"
        # gives segmentations the fallback keeps, so slicing, merging and
        # writing all run
        with torch.no_grad():
            model.outc.bias[0::2] = 1.0
        model = model.to(device).eval()
        cfg = Config()  # shipped settings; the port's solver is "matrix"
        assert cfg.multicut.hier_agg == "matrix"

        def cost_fn(b):
            return pipeline.learned_costs(model, b)

        # outputs are right: finite costs of the right shape, and the solver
        # on the device agrees with the CPU on a small input
        with torch.inference_mode():
            x = torch.as_tensor(np.stack(images[:2]) / 255.0,
                                dtype=torch.float32, device=device)
            costs = cost_fn(x)
        if costs.shape != (2, side, side, 2) or not bool(
                torch.isfinite(costs).all()):
            raise AssertionError(f"bad costs {tuple(costs.shape)}")
        small = torch.as_tensor(np.random.default_rng(2).integers(
            -8, 9, (2, 64, 64, 2)).astype(np.float32))
        kw = dict(hier_rounds=(2, 1), hier_caps="flat64")
        if not torch.equal(multicut_grid(small.to(device), **kw).cpu(),
                           multicut_grid(small, **kw)):
            raise AssertionError("solver labels differ from the CPU's")

        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            pipeline.compress_arrays(images, cost_fn, cfg, tmp / "warm",
                                     names, device=device)
            timings: dict = {}
            multicut_leaf.launches = 0
            t0 = time.perf_counter()
            dirs = pipeline.compress_arrays(images, cost_fn, cfg,
                                            tmp / "out", names,
                                            device=device, timings=timings)
            elapsed = time.perf_counter() - t0
            launches = multicut_leaf.launches
            n_slices = []
            for d, img in zip(dirs, images):
                rec = reassemble_array(d)
                if not np.array_equal(rec, ensure_rgba(img)):
                    raise AssertionError(f"{d.name}: reassembly not lossless")
                n_slices.append(len(list(d.glob("slice_*.png"))))
        log(f"  {batch} images {side}x{side}: {batch / elapsed:.3f} images/s "
            f"({elapsed:.3f} s); slices per image {n_slices}; lossless")
        log("  stage seconds: " + ", ".join(
            f"{k} {v:.4f}" for k, v in timings.items()))
        log(f"  multicut_leaf launches: {launches}")
        if device == "cuda" and launches < 1:
            raise AssertionError("the main path did not launch the leaf "
                                 "kernel")
    return launches


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
    phase_env(torch, args.device)
    kernels = []
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_build()
        kernels.append(phase_leaf(torch, batch, side))
    launches = phase_main(torch, args.device, batch, side, base)

    if args.device == "cuda":
        kernels[0]["launches"] = launches
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
