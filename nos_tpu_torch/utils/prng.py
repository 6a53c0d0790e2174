"""The parts of ``jax.random`` the reference calls, on torch tensors.

The draws are JAX's own, bit for bit: the threefry2x32 hash (20 rounds
and its key schedule), the default ``jax_threefry_partitionable=True``
counter layout (a 64-bit iota split into high and low 32-bit words) and
``jax_enable_x64`` off (a seed is taken modulo 2^32). So a seed gives
the reference's tokens on the CPU and on the card alike.

PyTorch has no complete ``uint32`` arithmetic, so every 32-bit word is
an ``int64`` tensor holding a value in [0, 2^32), masked after each add
and shift. These are integer ops: their bits do not depend on the
device. A key is an ``int64`` tensor ``[..., 2]``; leading dims batch
keys, as ``jax.vmap`` over keys would.

Floats: ``uniform`` builds its mantissa exactly as JAX does. ``gumbel``
takes two logs. Neither XLA's nor torch's f32 ``log`` is correctly
rounded, and torch's may differ between the CPU and the card, so the port
takes its own: an f64 series of exact IEEE operations, rounded to f32
once at the end, which gives the same bits on every device and lies
within a few f32 ulp of JAX's. ``categorical`` therefore agrees with
JAX except where the top two perturbed logits lie that close together.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

__all__ = ["PRNGKey", "threefry2x32", "fold_in", "split", "random_bits",
           "uniform", "randint", "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = float(torch.finfo(torch.float32).tiny)

IntLike = Union[int, torch.Tensor]


def _u32(x: IntLike, device=None) -> torch.Tensor:
    """``x`` as int64 words in [0, 2^32) (a uint32 conversion). A Python
    int is filled in on the device, with no host-to-device copy (which
    would wait for the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=torch.int64) & _MASK
    return torch.full((), int(x) & _MASK, dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``threefry2x32_p``: the 20-round Threefry-2x32 hash of the
    counter pairs (x1, x2) under the key (k1, k2), all uint32 words
    held in int64 tensors that broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def PRNGKey(seed: IntLike, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]``,
    which with x64 off is ``[0, seed mod 2^32]``. A tensor of seeds
    gives a batch of keys ``[*seed.shape, 2]``."""
    lo = _u32(seed, device)
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def _halves(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair (0, data);
    ``data`` is taken as uint32. Batched keys take a matching batch of
    data (``jax.vmap(fold_in)``)."""
    k1, k2 = _halves(key)
    d = _u32(data, key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``iota_2x32_shape``: the flat index of each element of ``shape``
    as (high, low) 32-bit words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def _hash_shape(key: torch.Tensor, shape: Sequence[int]):
    """threefry over ``shape``'s counters under ``key`` (batched keys'
    leading dims lead the result)."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape, key.device)
    k1, k2 = _halves(key)
    k1 = k1.reshape(k1.shape + (1,) * len(shape))
    k2 = k2.reshape(k2.shape + (1,) * len(shape))
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``[num, 2]`` keys (the
    partitionable, fold-like split)."""
    b1, b2 = _hash_shape(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` for 32 bits: the xor of the two
    hash words of each element's counter; int64 values in [0, 2^32)."""
    b1, b2 = _hash_shape(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval) in f32."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, (floats - 1.0) * (hi - lo) + lo)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` with JAX's default int32 dtype (values
    returned in an int64 tensor): two draws from ``split(key)``, folded
    into the span with JAX's uint32 ``multiplier`` arithmetic (which
    wraps, as JAX's does, for spans above 2^16)."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError(
            f"randint bounds must lie in int32, got [{minval}, {maxval})")
    k1, k2 = split(key, 2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = 1 if maxval <= minval else (maxval - minval) & _MASK
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    return minval + offset


_LN2 = math.log(2.0)
# 2 atanh(s) = log((1 + s) / (1 - s)): the odd series' coefficients,
# enough terms for |s| <= (sqrt 2 - 1) / (sqrt 2 + 1) at f64 precision
_ATANH = tuple(1.0 / (2 * k + 1) for k in range(12))


def _log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive, normal f64 values from exact IEEE ops
    (bit fields, +, -, *, /), so every device gives the same bits:
    x = m 2^e with m in [sqrt(1/2), sqrt 2], log m = 2 atanh((m-1)/(m+1))."""
    bits = x.view(torch.int64)
    e = ((bits >> 52) & 0x7FF) - 1023
    m = ((bits & ((1 << 52) - 1)) | (1023 << 52)).view(torch.float64)
    big = m > math.sqrt(2.0)
    m = torch.where(big, m * 0.5, m)
    e = e + big.long()
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    p = torch.full_like(s, _ATANH[-1])
    for c in _ATANH[-2::-1]:
        p = p * s2 + c
    return e.double() * _LN2 + 2.0 * s * p


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in f32, mode "low" (JAX's default):
    ``-log(-log(uniform(key, shape, tiny, 1)))``, the logs in f64 and
    the result rounded to f32 once."""
    u = uniform(key, shape, _F32_TINY, 1.0).double()
    return (-_log(-_log(u))).float()


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the argmax of
    ``logits + gumbel``. A single key ``[2]`` draws the noise over all
    of ``logits`` (JAX's call on a batch of rows); keys ``[B, 2]`` draw
    row b's noise from key b over one row (``jax.vmap`` over rows)."""
    logits = logits.float()
    if key.dim() == 1:
        noise = gumbel(key, logits.shape)
    else:
        noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)
