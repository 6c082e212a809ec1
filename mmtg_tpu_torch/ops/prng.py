"""A counter-based PRNG in torch integer ops: JAX's threefry2x32, bit for bit.

What ``jax.random`` does for the JAX engine, for the port: ``PRNGKey``,
``fold_in``, ``split``, the random bits, and the uniform / Gumbel / categorical draws
behind ``jax.random.categorical`` — so that a decode keyed per row
(``row_seeds``) samples the JAX engine's tokens, and a row's stream depends
on nothing batch-shaped (a ``torch.Generator`` is one stream for the whole
batch). Everything is elementwise tensor math on whatever device the key
lives on: no host synchronisation.

The variant is the one JAX 0.9 uses by default,
``jax_threefry_partitionable=True``: the random bits of element ``i`` of a
draw are ``threefry2x32(key, (0, i))`` with the two output words xor-ed
(the older variant hashed the two halves of an iota against each other).

Keys are int64 tensors ``[..., 2]`` holding two uint32 words (torch has no
uint32 arithmetic); a leading shape is a batch of keys.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words ``(0, seed)``
    (a negative seed enters as its two's-complement bit pattern)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds) over broadcastable int64
    tensors of uint32 words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``key`` ``[..., 2]``, ``data`` an int or an
    integer tensor broadcastable against the key's leading shape (taken as
    uint32, two's complement). Returns keys of the broadcast shape."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for one key ``[2]``: keys ``[num, 2]``.
    In the partitionable variant key ``i`` is ``threefry2x32(key, (0, i))``,
    which is ``fold_in(key, i)``."""
    return fold_in(key, torch.arange(num, dtype=torch.int64, device=key.device))


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 ``[..., *shape]``:
    each key of a batch draws its own array of ``shape``."""
    shape = tuple(shape)
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    o1, o2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return (o1 ^ o2).reshape(lead + shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23
    random mantissa bits under exponent 0, minus 1, scaled, floored at
    ``minval``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default ("low")
    mode: ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` by Gumbel-max. One
    key ``[2]`` draws the whole of ``logits``' shape; a batch of keys
    ``[B, 2]`` with ``logits`` ``[B, k]`` is the per-row draw, row ``b`` from
    key ``b`` alone (``jax.vmap`` of the above). The noise is float32
    whatever the logits' dtype (JAX draws it in the logits' dtype: bit-equal
    for float32 logits only)."""
    if key.dim() == 1:
        noise = gumbel(key, logits.shape)
    else:
        if key.shape[:-1] != logits.shape[:-1]:
            raise ValueError(f"categorical: keys {tuple(key.shape)} do not "
                             f"batch over logits {tuple(logits.shape)}")
        noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(noise + logits.float(), dim=-1)
