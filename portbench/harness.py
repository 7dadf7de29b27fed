"""The benchmark's run: one cell of BENCHMARK.json, from its seed to the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: `configs/<config>.json` (and the driver it
names, `drivers/<driver>.py`), `traffic/<traffic>.json`,
`metrics/<metric>.py` (a `read(ctx)` that returns a number or None) and
`limits/<cell>.json` (the limit of each number the correctness check
compares). This file knows none of them.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "image_compression_tpu")


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_spec(name: str) -> dict:
    """The cell's entry, its configuration (with `file` read), traffic
    parameters, limits and the metrics that apply to it."""
    bench = manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf_entry["file"]).read_text())
    from portbench.traffic import generator
    reported = [m for m in bench["end_to_end"]
                if name in m.get("workloads", [name])]
    names = {m["name"] for m in reported}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"cell": cell, "config": config,
            "traffic": generator.load(cell["traffic"]),
            "limits": json.loads((HERE / "limits" / f"{name}.json")
                                 .read_text()),
            "end_to_end": reported, "per_layer": per_layer}


def reader(metric: str):
    """metrics/<metric>.py's read function (metric names hold dots, so the
    file is loaded by path)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc/g++ builds go to image_compression_torch/csrc/build/
    there)."""
    base = ROOT / ".cache" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(torch, device: str) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             spec: dict | None = None) -> dict:
    """One run of cell `name`; returns the result object (correct,
    attempted, failed, metrics, device, [breakdown], checks). `spec`
    replaces the cell's files (tests run small sizes on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or cell_spec(name)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < spec["cell"]["chips"]:
            raise NoDevice(f"{torch.cuda.device_count()} card(s), the cell "
                           f"asks for {spec['cell']['chips']}")
    driver = importlib.import_module(
        f"portbench.drivers.{spec['config']['driver']}")
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        run = driver.Run(spec, seed, device, workdir)
        with contextlib.redirect_stdout(sys.stderr):
            run.setup()
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        with contextlib.redirect_stdout(sys.stderr):
            e2e = run.window(seconds, timings=trace)
            summary = run.profile() if trace else None
        dev = device_info(torch, device)
        with contextlib.redirect_stdout(sys.stderr):
            checks = run.check()
        found = forbidden_modules()
        if found:
            raise RuntimeError("modules of JAX or the JAX package were "
                               f"loaded: {found}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    e2e["setup_s"] = setup_s
    if trace:
        ctx = run.context(summary)
        metrics = {}
        for m in spec["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["span_s"]
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    ok = all(c["ok"] for c in checks.values())
    result = {"correct": ok, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def check(value: float, limit: float) -> dict:
    """One compared number: correct while it does not exceed its limit (a
    number that is not finite fails)."""
    return {"value": value, "limit": limit,
            "ok": bool(math.isfinite(value) and value <= limit)}
