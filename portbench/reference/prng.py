"""Frozen copy of the port's `ops/prng.py` (plain PyTorch), part of the
benchmark's reference; it imports nothing of the program.

Threefry-2x32 counter-based random bits, bit for bit those of
`jax.random` with `jax_threefry_partitionable` on (the default of jax 0.5 and
later).

The solver's coins are all drawn from fixed keys: `fold_in(PRNGKey(0),
salt)` per matching pass of the sorted rounds, `fold_in(PRNGKey(3), salt)`
per hierarchy round and `fold_in(PRNGKey(2), round)` per presolve round. So
the labels of the random-mate modes depend on these exact bits, and this
module reproduces them rather than drawing its own.

torch's uint32 supports few operations, so words are int64 tensors holding
values in [0, 2^32); every add and shift is masked back to 32 bits, which
wraps the same way on the CPU and on CUDA. A key is a pair of Python ints.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(key: tuple[int, int], x0, x1):
    """Threefry-2x32 with 20 rounds of the block (x0, x1) under `key`.
    x0, x1: int64 tensors (or Python ints) of 32-bit words; returns the two
    output words in the same form."""
    k0, k1 = key[0] & MASK, key[1] & MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed."""
    return (0, seed & MASK)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in(key, data)`: the block (0, data) under key."""
    return threefry2x32(key, 0, data & MASK)


def random_bits(key: tuple[int, int], shape, device=None) -> torch.Tensor:
    """32-bit random words of `shape` as int64 in [0, 2^32): the words of
    the row-major counters 0, 1, ... (hi, lo halves of a 64-bit count) under
    key, the two output words xor-ed."""
    numel = 1
    for d in shape:
        numel *= int(d)
    count = torch.arange(numel, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, count >> 32, count & MASK)
    return (b0 ^ b1).reshape(tuple(shape))


def _unit_floats(key: tuple[int, int], shape, device=None) -> torch.Tensor:
    """f32 in [0, 1): the top 23 bits as the mantissa of a float in [1, 2),
    minus 1."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


# Giles' single-precision erfinv ("Approximating the erfinv function", GPU
# Computing Gems, 2011): the polynomial XLA evaluates for f32 erf_inv.
# torch.erfinv is more accurate in the tails and so differs from
# jax.random.normal by up to 7.5e-5 there; this form stays within 5e-7.
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """erfinv of f32 x in (-1, 1) by Giles' polynomial (+-inf at +-1)."""
    w = -torch.log1p(-x * x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(central, _ERFINV_CENTRAL[0], _ERFINV_TAIL[0])
    for c_central, c_tail in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = torch.where(central, c_central, c_tail) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = -0.99999994  # nextafter(-1, 0) in f32


def normal(key: tuple[int, int], shape, device=None) -> torch.Tensor:
    """`jax.random.normal(key, shape)` in f32: uniform on
    [nextafter(-1, 0), 1) from the same bits (bitwise jax's), then
    sqrt(2) * erfinv. Within 1e-6 of jax's values (only erfinv's rounding
    differs)."""
    lo = torch.tensor(_NORMAL_LO, dtype=torch.float32)
    u = _unit_floats(key, shape, device) * 2.0 + lo.to(device)
    u = torch.maximum(u, lo.to(u.device))
    return torch.tensor(2.0 ** 0.5, dtype=torch.float32) * erfinv_f32(u)
