"""Data parallelism and spatial sharding.

The reference package scales out through one single-controller JAX mesh:
a "data" axis over every device the program sees, batches sharded along
it, parameters replicated, and XLA inserting the gradient reduction; the
same mesh carries the height-sharded solve and extractors (shard_map with
halo exchange). PyTorch runs one process per card, so the port splits this
in two:

  * data parallelism (mesh.py, process-group side): a torch.distributed
    process group, NCCL on CUDA and gloo on the CPU, one device per rank.
    Each rank takes its slice of every global batch; the train steps
    (train/steps.py) reduce gradients over the group before the optimizer's
    clip and compute every batch statistic of the RL step (baseline,
    advantages, the reward mean) over the global batch, so a step of N ranks
    is the step of one process on the global batch. Launch it with
    `torchrun --nproc_per_node=N -m image_compression_torch.cli.main
    pretrain|train ...`.
  * spatial sharding (mesh.Mesh, spatial.py): one process, an ordered list
    of torch devices with repeats allowed. A height-sharded image runs one
    strip per entry; several strips on one device run as one batch, so
    `Mesh([cuda:0] * 4)` exercises the strip handoff on a single card (NCCL
    refuses two ranks on one GPU), and `Mesh([cpu] * 8)` stands in for the
    reference tests' eight forced CPU devices.
"""
