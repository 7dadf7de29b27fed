"""GroupNorm + ReLU + bf16 cast of the U-Net's convolution outputs.

Replaces no TPU kernel: the JAX package leaves its U-Net's GroupNorm to XLA
(models/unet.py there). On an H100 the chain the port ran after each of the
U-Net's 14 convolutions, `x.float()`, `F.group_norm` (a statistics kernel,
then an affine pass), `F.relu`, `.to(bfloat16)`, was the U-Net's largest
cost: full f32 passes over the activation, ~32 bytes an element. The
hand-written kernel `csrc/group_norm_relu.cu` reads the convolution's bf16
output twice (statistics, then apply) and writes the next layer's bf16
input once: 6 bytes an element, which is what bounds it. Its design is
described at the head of the .cu file.

`group_norm_relu_plain` is that chain line for line; `group_norm_relu_cuda`
launches the kernel; `group_norm_relu` takes the plain version on a CPU
tensor and the kernel on a CUDA tensor, with no fallback between the two:
on a CUDA tensor the kernel launches or the call raises. Each launch counts
"group_norm_relu.launches" (utils/profiling.count). The kernel has no
backward: models/unet.py calls it only under inference mode.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from image_compression_torch.utils.profiling import count

MAX_SPLITS = 256  # statistics partials a (sample, group) row may have


def group_norm_relu_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, groups: int,
                          eps: float) -> torch.Tensor:
    """relu(group_norm(x in f32)) back in x's dtype."""
    y = F.group_norm(x.float(), groups, weight, bias, eps)
    return F.relu(y).to(x.dtype)


def _lib() -> ctypes.CDLL:
    from image_compression_torch import kernels
    lib = kernels.load("group_norm_relu")
    fn = lib.group_norm_relu_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def group_norm_relu_cuda(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float):
    """The kernel on a contiguous bf16 [N, C, H, W] CUDA tensor (C divisible
    by `groups`) with f32 [C] weight and bias: (y, mean, rstd), y the
    plain version's bf16 output and mean, rstd [N, groups] f32, the
    statistics F.group_norm computes. One call, two launches on the current
    stream."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"group_norm_relu_cuda needs a CUDA tensor, got "
                         f"{dev}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"group_norm_relu_cuda: x must be a bf16 [N, C, H, "
                         f"W] tensor, got {x.dtype} {tuple(x.shape)}")
    n, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"group_norm_relu_cuda: {c} channels do not divide "
                         f"into {groups} groups")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm_relu_cuda: x must be contiguous (NCHW) "
                         "and 16-byte aligned")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (c,) or not t.is_contiguous()):
            raise ValueError(f"group_norm_relu_cuda: {name} must be a "
                             f"contiguous f32 ({c},) tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    y = torch.empty((n, c, h, w), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((2, n, groups), dtype=torch.float32, device=dev)
    scratch = torch.empty((n * groups, MAX_SPLITS, 4), dtype=torch.float32,
                          device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.group_norm_relu_launch(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), scratch.data_ptr(),
            MAX_SPLITS, n, c, h * w, groups, eps, stream)
    if err != 0:
        raise RuntimeError(f"group_norm_relu kernel launch failed: "
                           f"cudaError {err}")
    count("group_norm_relu.launches")
    return y, stats[0], stats[1]


def distance(y: torch.Tensor, want: torch.Tensor, x: torch.Tensor,
             weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
             rstd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """How far the bf16 output `y` of this function on x [N, C, H, W] lies
    from `want`, per element, given the statistics mean, rstd [N, G] that
    made y: (the distance in bf16 units in the last place of the output,
    +0 and -0 equal; |y - want| in bf16 units in the last place of the
    affine step's term scale |a x| + |b|, a = rstd * weight,
    b = bias - a * mean). Statistics summed in another order move
    fma(a, x, b) by f32 rounding at the terms' scale, so an output that
    cancels to near 0 may move by many of its own units and by less than
    one of its terms'."""
    n, c = x.shape[:2]
    groups = mean.shape[1]
    a = (rstd.repeat_interleave(c // groups, dim=1) * weight).reshape(
        n, c, 1, 1)
    b = bias.reshape(1, c, 1, 1) - a * mean.repeat_interleave(
        c // groups, dim=1).reshape(n, c, 1, 1)
    scale = (a * x.float()).abs() + b.abs()
    unit = torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)
    y0 = torch.where(y == 0, torch.zeros_like(y), y)
    w0 = torch.where(want == 0, torch.zeros_like(want), want)
    ulps = (y0.view(torch.int16).int() - w0.view(torch.int16).int()).abs()
    return ulps, (y.float() - want.float()).abs() / unit


def group_norm_relu(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, groups: int,
                    eps: float) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.is_cuda:
        return group_norm_relu_cuda(x, weight, bias, groups, eps)[0]
    if x.device.type != "cpu":
        raise ValueError(f"group_norm_relu: unsupported device {x.device}")
    return group_norm_relu_plain(x, weight, bias, groups, eps)
