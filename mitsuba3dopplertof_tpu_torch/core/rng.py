"""Counter-exact PCG32 / TEA / Kensler RNG primitives on torch tensors.

Port of the JAX package's ``core/rng.py`` (reference
include/mitsuba/core/random.h:77 TEA, drjit PCG32, random.h:235 Kensler),
bitwise equal to it for every lane.

torch has no full uint32 arithmetic, so every 32-bit word is an ``int64``
tensor holding a value in [0, 2^32), masked with ``& 0xFFFFFFFF`` after each
operation that can leave the range. No product ever exceeds 2^63: 32x32-bit
products are built from 16-bit partial products, exactly as the JAX package
builds its 64-bit PCG32 state from 32-bit limbs (``_mul32_wide``,
``_add64``, ``_mul64``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF

# PCG32 multiplier 0x5851F42D4C957F2D as (hi, lo) 32-bit limbs
_PCG32_MULT_HI = 0x5851F42D
_PCG32_MULT_LO = 0x4C957F2D
PCG32_DEFAULT_STREAM = (0xDA3E39CB, 0x94B95BDB)


def u32(x, device=None) -> torch.Tensor:
    """A uint32 word as an int64 tensor in [0, 2^32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


# ---------------------------------------------------------------------------
# 64-bit helpers on (hi, lo) limb pairs
# ---------------------------------------------------------------------------

def _mul32_wide(a, b):
    """Full 32x32 -> 64 bit product as (hi, lo) words."""
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + p10                      # < 2^33: bit 32 is the carry
    lo = p00 + ((mid << 16) & MASK32)
    hi = p11 + (mid >> 16) + (lo >> 32)
    return hi & MASK32, lo & MASK32


def _mul32_lo(a, b):
    """(a * b) mod 2^32 without leaving int64."""
    return (a * (b & _MASK16) + (((a * (b >> 16)) & _MASK16) << 16)) & MASK32


def _add64(ahi, alo, bhi, blo):
    lo = alo + blo
    hi = (ahi + bhi + (lo >> 32)) & MASK32
    return hi, lo & MASK32


def _mul64(ahi, alo, bhi, blo):
    """(a * b) mod 2^64 on limb pairs."""
    hi, lo = _mul32_wide(alo, blo)
    hi = (hi + _mul32_lo(alo, bhi) + _mul32_lo(ahi, blo)) & MASK32
    return hi, lo


# ---------------------------------------------------------------------------
# TEA hash — reference random.h:77
# ---------------------------------------------------------------------------

def sample_tea_32(v0, v1, rounds: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two uniformly distributed 32-bit words from two inputs."""
    v0 = u32(v0)
    v1 = u32(v1)
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & MASK32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s)
                     ^ ((v1 >> 5) + 0xC8013EA4)) & MASK32)) & MASK32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s)
                     ^ ((v0 >> 5) + 0x7E95761E)) & MASK32)) & MASK32
    return v0, v1


def bits_to_unit_float(bits) -> torch.Tensor:
    """Top 23 random bits onto [0, 1) like drjit: reinterpret
    (0x3F800000 | bits >> 9) as float32 and subtract 1."""
    f = (0x3F800000 | (bits >> 9)).to(torch.int32).view(torch.float32)
    return f - 1.0


def sample_tea_f32(v0, v1, rounds: int = 4) -> torch.Tensor:
    x, _ = sample_tea_32(v0, v1, rounds)
    return bits_to_unit_float(x)


# ---------------------------------------------------------------------------
# PCG32
# ---------------------------------------------------------------------------

class PCG32State(NamedTuple):
    """Per-lane PCG32 stream state: four int64 tensors of 32-bit words."""
    state_hi: torch.Tensor
    state_lo: torch.Tensor
    inc_hi: torch.Tensor
    inc_lo: torch.Tensor


def _pcg32_step(s: PCG32State) -> PCG32State:
    hi, lo = _mul64(s.state_hi, s.state_lo, _PCG32_MULT_HI, _PCG32_MULT_LO)
    hi, lo = _add64(hi, lo, s.inc_hi, s.inc_lo)
    return PCG32State(hi, lo, s.inc_hi, s.inc_lo)


def pcg32_seed(initstate_hi, initstate_lo, initseq_hi,
               initseq_lo) -> PCG32State:
    """pcg32 seed(): state=0; inc=(initseq<<1)|1; step(); state+=initstate;
    step()."""
    initstate_hi, initstate_lo = u32(initstate_hi), u32(initstate_lo)
    initseq_hi, initseq_lo = u32(initseq_hi), u32(initseq_lo)
    inc_hi = ((initseq_hi << 1) | (initseq_lo >> 31)) & MASK32
    inc_lo = ((initseq_lo << 1) | 1) & MASK32
    z = torch.zeros_like(inc_lo)
    s = _pcg32_step(PCG32State(z, z, inc_hi, inc_lo))
    hi, lo = _add64(s.state_hi, s.state_lo, initstate_hi, initstate_lo)
    return _pcg32_step(PCG32State(hi, lo, s.inc_hi, s.inc_lo))


def pcg32_seed_wavefront(seed_value, stream_index,
                         seed_offset: int = 0) -> PCG32State:
    """``PCG32Sampler::seed`` (reference sampler.cpp:115-135):
    TEA(seed_value + seed_offset, stream_index) seeds pcg32 with the two
    words zero-extended to 64 bits."""
    stream_index = u32(stream_index)
    v0, v1 = sample_tea_32(
        torch.full_like(stream_index, (int(seed_value) + seed_offset)
                        & MASK32), stream_index)
    zero = torch.zeros_like(v0)
    return pcg32_seed(zero, v0, zero, v1)


def pcg32_next_u32(s: PCG32State, active=None):
    """Draw a 32-bit word; the state advances only where ``active``
    (drjit's masked next_uint32, the lockstep contract of the correlated
    sampler)."""
    old_hi, old_lo = s.state_hi, s.state_lo
    ns = _pcg32_step(s)
    if active is not None:
        ns = PCG32State(torch.where(active, ns.state_hi, old_hi),
                        torch.where(active, ns.state_lo, old_lo),
                        s.inc_hi, s.inc_lo)
    # xorshifted = uint32(((oldstate >> 18) ^ oldstate) >> 27)
    x_hi = (old_hi >> 18) ^ old_hi
    x_lo = (((old_lo >> 18) | (old_hi << 14)) & MASK32) ^ old_lo
    xorshifted = ((x_lo >> 27) | (x_hi << 5)) & MASK32
    rot = old_hi >> 27                   # oldstate >> 59
    out = ((xorshifted >> rot)
           | (xorshifted << ((-rot) & 31))) & MASK32
    return out, ns


def pcg32_next_f32(s: PCG32State, active=None):
    bits, ns = pcg32_next_u32(s, active)
    return bits_to_unit_float(bits), ns


# ---------------------------------------------------------------------------
# Kensler permutation — reference random.h:235
# ---------------------------------------------------------------------------

def permute_kensler(index, sample_count: int, seed, active=None):
    """Pseudorandom permutation of [0, sample_count); ``sample_count`` is a
    Python int, ``index``/``seed`` 32-bit words (tensors or ints)."""
    index = u32(index)
    if sample_count == 1:
        return torch.zeros_like(index)
    seed = u32(seed, device=index.device).expand_as(index)
    if active is None:
        active = torch.ones_like(index, dtype=torch.bool)
    else:
        active = torch.as_tensor(active, device=index.device).expand_as(index)

    w = sample_count - 1
    w |= w >> 1
    w |= w >> 2
    w |= w >> 4
    w |= w >> 8
    w |= w >> 16

    def body(tmp):
        tmp = tmp ^ seed
        tmp = _mul32_lo(tmp, 0xE170893D)
        tmp = tmp ^ (seed >> 16)
        tmp = tmp ^ ((tmp & w) >> 4)
        tmp = tmp ^ (seed >> 8)
        tmp = _mul32_lo(tmp, 0x0929EB3F)
        tmp = tmp ^ (seed >> 23)
        tmp = tmp ^ ((tmp & w) >> 1)
        tmp = _mul32_lo(tmp, 1 | (seed >> 27))
        tmp = _mul32_lo(tmp, 0x6935FA69)
        tmp = tmp ^ ((tmp & w) >> 11)
        tmp = _mul32_lo(tmp, 0x74DCB303)
        tmp = tmp ^ ((tmp & w) >> 2)
        tmp = _mul32_lo(tmp, 0x9E501CC3)
        tmp = tmp ^ ((tmp & w) >> 2)
        tmp = _mul32_lo(tmp, 0xC860A3DF)
        tmp = tmp & w
        return tmp ^ (tmp >> 5)

    act = active.clone()
    while bool(act.any()):
        index = torch.where(act, body(index), index)
        act = act & (index >= sample_count)
    return ((index + seed) & MASK32) % sample_count


__all__ = [
    "PCG32State", "PCG32_DEFAULT_STREAM", "MASK32", "u32",
    "pcg32_seed", "pcg32_seed_wavefront", "pcg32_next_u32", "pcg32_next_f32",
    "sample_tea_32", "sample_tea_f32", "bits_to_unit_float",
    "permute_kensler",
]
