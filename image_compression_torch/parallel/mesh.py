"""Device meshes for spatial sharding and the process group for data
parallelism (see parallel/__init__.py for how the two map onto the
reference's single mesh).

Mesh side: `Mesh` is an ordered tuple of torch devices (repeats allowed);
`shard_batch` splits a leading axis into equal chunks, chunk i on
devices[i], and `replicate` copies onto every device.

Process-group side: `initialize_distributed` joins a torch.distributed
group when a cluster environment is set (torchrun's WORLD_SIZE, RANK,
MASTER_ADDR, MASTER_PORT) or when told where to rendezvous, and is a no-op
otherwise; `world` gives (rank, size), (0, 1) without a group; the
reductions and `broadcast_module_` do nothing without a group.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from image_compression_torch.device import resolve_device

_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple
    axis_name: str = "data"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """A mesh over `devices` (each checked by resolve_device); by default
    every visible CUDA device. The CPU only when named."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(tuple(resolve_device(d) for d in devices), axis_name)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor tree: {type(tree)}")


def shard_batch(mesh: Mesh, tree):
    """Each tensor of `tree` as a list of mesh.size equal chunks of its
    leading axis, chunk i on devices[i]. Raises if the axis does not split
    evenly (as a NamedSharding over the batch does)."""
    def split(x):
        if x.shape[0] % mesh.size:
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"evenly over {mesh.size} devices")
        return [c.to(d, non_blocking=True) for c, d in
                zip(x.chunk(mesh.size), mesh.devices)]
    return _tree_map(split, tree)


def replicate(mesh: Mesh, tree):
    """Each tensor of `tree` as a list of copies, one per mesh device."""
    return _tree_map(lambda x: [x.to(d, non_blocking=True)
                                for d in mesh.devices], tree)


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           device: str | torch.device = "cuda") -> bool:
    """Join the data-parallel process group; returns whether one is
    active.

    With no arguments: a no-op (False) when none of WORLD_SIZE, RANK and
    MASTER_ADDR is set; with all of them and MASTER_PORT set (torchrun
    sets them), an "env://" rendezvous; a partial environment raises. With
    `init_method` (e.g. "file:///path" or "tcp://host:port"), `world_size`
    and `rank` are required. The backend is NCCL on CUDA, each rank taking
    card LOCAL_RANK (else rank modulo the card count), and gloo on the CPU.
    A misconfigured group fails loudly, never degrading to one process.
    """
    if dist.is_initialized():
        return True
    dev = resolve_device(device)
    if init_method is None:
        if world_size is not None or rank is not None:
            raise ValueError("world_size and rank need an init_method")
        present = [k for k in _ENV if k in os.environ]
        if not any(k in present for k in _ENV[:3]):
            return False
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise ValueError(f"cluster environment partly set: {present} "
                             f"present, {missing} missing")
        init_method = "env://"
        world_size, rank = (int(os.environ["WORLD_SIZE"]),
                            int(os.environ["RANK"]))
    elif world_size is None or rank is None:
        raise ValueError("init_method needs world_size and rank")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


def distributed() -> bool:
    """Whether a process group is active."""
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """The device of this rank: the current card on CUDA, else the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _flat_all_reduce_(tensors, divide: bool) -> None:
    if not distributed():
        return
    by_dtype: dict = {}
    for t in tensors:
        if t is not None:
            by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        if divide:
            flat /= dist.get_world_size()
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_sum_(tensors) -> None:
    """Sum each tensor over the group, in place (one flat all-reduce per
    dtype)."""
    _flat_all_reduce_(tensors, divide=False)


def all_reduce_mean_(tensors) -> None:
    """Average each tensor over the group, in place."""
    _flat_all_reduce_(tensors, divide=True)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[n, ...] of every rank -> [world * n, ...] in rank order (x itself
    without a group)."""
    if not distributed():
        return x
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x.contiguous())
    return torch.cat(out)


def rank_slice(global_batch: int) -> slice:
    """This rank's rows of a global batch; raises if it does not divide by
    the world size."""
    rank, size = world()
    if global_batch % size:
        raise ValueError(f"global batch {global_batch} does not divide "
                         f"over {size} ranks")
    n = global_batch // size
    return slice(rank * n, (rank + 1) * n)


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Copy rank src's parameters and buffers to every rank, in place."""
    if not distributed():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)


def broadcast_object(obj, src: int = 0):
    """rank src's picklable `obj` on every rank (obj itself without a
    group)."""
    if not distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]
