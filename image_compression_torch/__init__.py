"""PyTorch/CUDA port of the learned image-compression system.

Runs the compress path of the JAX reference package (kept beside this one)
on an NVIDIA GPU: U-Net or classical edge costs -> hierarchical multicut ->
single-slice fallback -> merge refinement -> slice PNGs + `metadata.bin` (or
one pack per image), and the lossless reassembly; and trains the U-Net
(supervised pretraining, then REINFORCE on the size model's reward). The one Pallas kernel of
the reference (the multicut leaf) is a hand-written CUDA kernel here
(csrc/multicut_leaf.cu); the host PNG writer is the port's copy of the
reference's native writer (csrc/pngio.cpp); everything else is plain
PyTorch.

This package imports torch, numpy and scipy only — never JAX, never the
reference package — and keeps its own copies of the host-side modules it
needs (config, io, pngio.cpp). Public tensors keep the reference's layouts:
edge planes [B, H, W, 2], images NHWC.

Layer map:
  config     -- the reference's whole configuration schema
  device     -- device resolution (CUDA by default, CPU only on request)
  kernels    -- nvcc/g++ builds of csrc/ into ctypes libraries
  io/        -- metadata.bin codec, PNG codecs (native and Python, the same
                bytes), slicer, pack container, reassembly
  ops/       -- edges, classical extractors (colour, canny, watershed,
                graph-based, SLIC, targets), multicut solver (+ CUDA leaf),
                segment stats, PNG size estimator, fallback/merge support,
                label wire
  models/    -- EdgeUNet, ValueNet, the flax-params and train-state
                converters
  train/     -- losses, metrics, policy, optimizers and steps, checkpoints,
                data, the pretraining and REINFORCE loops (data parallel
                inside a process group; what each rank does: ranks)
  parallel/  -- meshes of devices and the data-parallel process group
                (mesh), height-sharded solve and extractors (spatial)
  utils/     -- synthetic pattern generators, random partitions (numpy),
                tracing (spans, counters, stage clock, torch.profiler
                traces)
  pipeline   -- compress driver
  cli/       -- `python -m image_compression_torch.cli.main`
"""

__version__ = "0.1.0"
