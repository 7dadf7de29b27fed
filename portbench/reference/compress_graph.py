"""The checkpoint-free compress cells' plain reference (Felzenszwalb-
Huttenlocher graph costs) and the comparison that decides `correct`.

The reference works the cost planes out again from the benchmark's own
images: the FH extractor in float32 (graph_based.py and
graph_based_hier.py, frozen copies of the port's, at the configuration's
sigma 1, k 100, min_size 250), its labels made signed connect/cut planes.
It then solves the program's cost planes as the program's solver received
them in the checked job, falls back and merges (reference/compress.py's
solve, fallback and merge), and decides the writer's never-expand guard on
its own: it encodes each kept slicing with its copy of the Python slice
writer (slicer.py) and expects the source's passthrough wherever those
bytes exceed the original's plus a one-slice metadata.bin. It never reads
the program's decision. The program's answers are the images its extractor
saw and its cost planes, the solver's labels before the fallback (both kept
in the checked job), and what the job wrote, read back with the
benchmark's own decoder.

Numbers compared, each against its limit in limits/<cell>.json:
  costs_diff      edges whose signed cost differs between the program's
                  cost planes and the reference's FH of the same images
                  (elementwise float32 in tap order on both sides)
  input_mismatch  images the program's extractor saw other than the
                  original pixels / 255
  solver_diff     images whose partition from the program's solver, before
                  the fallback, differs from the reference's multicut of
                  the same costs
  partition_diff  images whose written partition differs from the
                  reference's solve, fallback, merge and guard
  lossless_fail, over_bound   as in reference/compress.py
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from portbench import harness
from portbench.reference import compress as ref
from portbench.reference import slicer
from portbench.reference.edges import edge_validity_masks
from portbench.reference.graph_based import (bf16, graph_based_edge_costs,
                                             identity)


@torch.no_grad()
def reference_costs(images_u8: np.ndarray, fh: dict, device: str,
                    cast=identity) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> FH's signed costs [B, H, W, 2] ({-1, +1},
    padding 0), or with cast=bf16 the control's."""
    x = ref.to_float01(images_u8, device)
    costs01 = graph_based_edge_costs(x, fh["sigma"], fh["k"],
                                     fh["min_size"], cast=cast)
    h, w = x.shape[1:3]
    return (2.0 * costs01 - 1.0) * edge_validity_masks(h, w, device=device)


def guarded(image_u8: np.ndarray, labels: np.ndarray, orig_bytes: int,
            level: int) -> np.ndarray:
    """The partition the writer writes for finished `labels`: one region
    where the slicing was declined (all-zero labels) or where its slices
    and metadata.bin exceed the original's bytes plus a one-slice
    metadata.bin (the never-expand guard), else `labels`."""
    if (labels == 0).all() or slicer.slicing_bytes(
            image_u8, labels, level) > orig_bytes + ref.ONE_SLICE_RECORD:
        return np.zeros_like(labels)
    return labels


def check(spec: dict, corpus: dict, job_dir: pathlib.Path, inputs: list,
          solved: list, device: str) -> dict:
    """The numbers of the checked job: `inputs` holds the batch each call of
    the extractor saw, `solved` the solver's (costs, labels)."""
    config, limits = spec["config"], spec["limits"]
    settings, fh = config["settings"], config["graph"]
    level = settings["compression_level"]
    stems = list(corpus)
    bs = config["batch_size"]
    n = dict.fromkeys(("costs_diff", "input_mismatch", "solver_diff",
                       "partition_diff", "lossless_fail", "over_bound"), 0)
    for b0 in range(0, len(stems), bs):
        batch = stems[b0:b0 + bs]
        imgs = np.stack([corpus[s]["image"] for s in batch])
        sizes = [corpus[s]["png_bytes"] for s in batch]
        n["input_mismatch"] += int(
            (inputs[b0 // bs][:len(batch)] != ref.to_float01(imgs, device))
            .flatten(1).any(1).sum())
        costs, got_solve = solved[b0 // bs]
        costs = costs[:len(batch)].to(device)
        n["costs_diff"] += int((costs != reference_costs(imgs, fh, device))
                               .sum())
        solve = ref.reference_solve(costs, settings)
        labels = ref.reference_finish(imgs, solve, sizes,
                                      settings).cpu().numpy()
        solve, got_solve = solve.cpu().numpy(), got_solve.cpu().numpy()
        for i, stem in enumerate(batch):
            n["solver_diff"] += not ref.same_partition(got_solve[i], solve[i])
            want = guarded(corpus[stem]["image"], labels[i], sizes[i], level)
            out = job_dir / stem
            n["over_bound"] += (out.is_dir() and sum(
                f.stat().st_size for f in out.iterdir())
                > sizes[i] + ref.ONE_SLICE_RECORD)
            region, lossless = ref.read_output(out, corpus[stem]["image"])
            n["lossless_fail"] += not lossless
            n["partition_diff"] += (region is None
                                    or not ref.same_partition(region, want))
    return {k: harness.check(v, limits[k]) for k, v in n.items()}


def control(spec: dict, corpus: dict, device: str) -> dict:
    """The control: FH on the smoothed images rounded to bfloat16 put in
    the program's place, its cost planes compared with the float32
    reference's by costs_diff (the rest would be the reference's own solve
    of them, equal by construction, and is not reported)."""
    fh = spec["config"]["graph"]
    stems = list(corpus)
    bs = spec["config"]["batch_size"]
    diff = 0
    for b0 in range(0, len(stems), bs):
        imgs = np.stack([corpus[s]["image"] for s in stems[b0:b0 + bs]])
        diff += int((reference_costs(imgs, fh, device, bf16)
                     != reference_costs(imgs, fh, device)).sum())
    return {"costs_diff": diff}
