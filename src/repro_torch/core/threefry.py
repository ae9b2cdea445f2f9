"""Threefry-2x32 random bits, bit for bit as ``jax.random`` draws them.

The port's own copy of the part of ``jax.random`` that Keyformer's noise
(:mod:`repro_torch.core.keyformer`) and temperature sampling
(:mod:`repro_torch.serving.scheduler`) need: :func:`prng_key`
(``PRNGKey``), :func:`fold_in`, :func:`split`, :func:`random_bits`
(``bits(key, shape, uint32)``), :func:`uniform`, :func:`gumbel` and
:func:`categorical`, as JAX 0.9 computes them with
``jax_threefry_partitionable=True`` (its default): the key of a seed is
``(seed >> 32, seed & 0xFFFFFFFF)``; ``fold_in(key, d)`` hashes the pair
``(0, d)``, and so does subkey ``d`` of ``split``; ``bits(key, shape)``
hashes the 64-bit iota of ``shape`` as ``(hi, lo)`` word pairs and XORs
the two output words.  The hash is Threefry-2x32 with 20 rounds (Salmon et
al., SC 2011).  The floats are fp32, and exact but for the two logs of the
Gumbel transform, which may differ from XLA's by an ulp.

A key is a pair of tensors ``(k1, k2)`` of any broadcastable shape, so one
call draws for a batch of keys.  Values are uint32 held in ``int64`` tensors
and masked to 32 bits after each addition: ``torch.uint32`` has few CUDA
kernels, and an int64 shift of a 32-bit value never overflows.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[torch.Tensor, torch.Tensor]


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counter words ``(x0, x1)`` under key ``(k1,
    k2)``; every operand holds uint32 values and they broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31)."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    # filled on the device: no host-to-device copy, so a decode step that
    # draws stays free of host syncs
    return (torch.zeros((), dtype=torch.int64, device=device),
            torch.full((), seed, dtype=torch.int64, device=device))


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in(key, data)`` for each element of ``data``
    (uint32 values, or int32 ones taken modulo 2**32 as JAX converts
    them), broadcast against the key's shape."""
    data = _u32(data).to(key[0].device)
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, jnp.uint32)``: int64 tensor of uint32
    values, of shape ``key_shape + shape`` (the key's own shape leads)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    if n >= 2 ** 32:
        raise NotImplementedError("random bits beyond 2**32 values per key")
    k1, k2 = key
    lo = torch.arange(n, dtype=torch.int64, device=k1.device).reshape(shape)
    lead = (...,) + (None,) * len(shape)
    b1, b2 = threefry2x32(k1[lead], k2[lead], torch.zeros_like(lo), lo)
    return b1 ^ b2


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> fp32 in [0, 1) by exact steps only: the top 23 bits
    fill the mantissa of a float in [1, 2), minus the exact 1.0 (as
    ``repro.core.keyformer`` does; the value fits a positive int32)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """The IEEE bits of fp32 values as uint32 values in an int64 tensor —
    ``bitcast_convert_type(x.astype(float32), uint32)``."""
    return (x.float().contiguous().view(torch.int32).to(torch.int64)
            & MASK32)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` as ``num`` keys: subkey ``i`` is the
    hash of ``(0, i)``, which is ``fold_in(key, i)``."""
    idx = torch.arange(num, dtype=torch.int64, device=key[0].device)
    k1, k2 = threefry2x32(key[0][..., None], key[1][..., None],
                          torch.zeros_like(idx), idx)
    return tuple((k1[..., i], k2[..., i]) for i in range(num))


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    mantissa fill of :func:`bits_to_unit`, then ``* (maxval - minval) +
    minval`` and ``max(minval, .)``.  XLA fuses the product and the sum
    into one fused multiply-add; here the fp32 product is exact in fp64,
    so the sum is taken there and rounded to fp32 once."""
    unit = bits_to_unit(random_bits(key, shape))
    lo = torch.full((), minval, dtype=torch.float32, device=unit.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=unit.device)
    fma = unit.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fma.float())


def gumbel(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default "low"
    mode: ``-log(-log(u))`` of ``u`` uniform on ``[tiny, 1)``."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, minval=tiny)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the first index of
    the largest ``logits + gumbel`` on the last axis.  The noise is drawn
    over ``logits``' whole shape (its shape is part of the bits), so a
    caller samples over the padded vocabulary, as the reference does."""
    return torch.argmax(logits + gumbel(key, logits.shape), dim=-1)
