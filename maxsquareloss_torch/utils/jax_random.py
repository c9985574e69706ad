"""The JAX package's random draws in PyTorch (no JAX): ``jax.random.key``,
``split`` and float32 ``normal`` under the default threefry2x32 generator
with ``jax_threefry_partitionable`` on (JAX's default).

``models.deeplabv2.init_deeplabv2(cfg, seed)`` draws through these, so a run
of the port from ``--seed s`` starts from the weights the JAX package's run
from ``--seed s`` starts from. Keys and the uniform bits are bitwise JAX's;
``normal`` follows XLA's float32 ``erf_inv`` (Giles' polynomial) and lands
within a few ulp of ``jax.random.normal``. The hash runs on any device as
int64 arithmetic masked to 32 bits, so a draw for the card runs on the card.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's float32 erf_inv: coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _threefry2x32(k: tuple[int, int], x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2):
    int64 tensors holding uint32 values."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = ((x[1] << r) & _MASK) | (x[1] >> (32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x


def _hash_iota(k: tuple[int, int], n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The hash of a 64-bit iota of n, split as (high, low) 32-bit words."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return tuple(_threefry2x32(k, torch.zeros_like(lo), lo))


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)``'s data for a seed in [0, 2**31): (0, seed)."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    return (0, int(seed))


def split(k: tuple[int, int], n: int) -> list[tuple[int, int]]:
    """``jax.random.split(k, n)``: n keys."""
    b1, b2 = _hash_iota(k, n, "cpu")
    return list(zip(b1.tolist(), b2.tolist()))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv; each Horner step rounds once, as a fused
    multiply-add does."""
    w = -torch.log1p(-(x * x))
    small = w < 5
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for lt5, ge5 in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(small, lt5, ge5)  # float32 constants
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def normal(k: tuple[int, int], shape: tuple[int, ...], device="cpu") -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` on ``device``: sqrt(2)
    erf_inv(u) for u uniform in (-1, 1) from the mantissa of 32 random bits."""
    b1, b2 = _hash_iota(k, math.prod(shape), device)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    f32 = dict(dtype=torch.float32, device=device)
    lo = torch.nextafter(torch.tensor(-1.0, **f32), torch.tensor(0.0, **f32))
    u = torch.maximum(u * (torch.tensor(1.0, **f32) - lo) + lo, lo)
    return (torch.tensor(math.sqrt(2), **f32) * _erf_inv(u)).reshape(shape)
