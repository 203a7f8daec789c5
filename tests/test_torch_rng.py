"""The PyTorch port's RNG (mitsuba3dopplertof_tpu_torch/core/rng.py) is
bitwise equal to the JAX package's (mitsuba3dopplertof_tpu/core/rng.py):
TEA, PCG32 seeding and masked draws, and Kensler permutations, over
>= 65,536 lanes of inputs made from a numpy seed."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3dopplertof_tpu.core import rng as jrng
from mitsuba3dopplertof_tpu_torch.core import rng as trng

from torch_threads import shared_cores  # noqa: F401 (autouse)

N = 1 << 16


def _words(seed, n=N):
    r = np.random.default_rng(seed)
    return r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _j(a):
    return jnp.asarray(a, jnp.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy())


def test_tea_bitwise():
    a, b = _words(0), _words(1)
    for rounds in (1, 4, 6):
        j0, j1 = jrng.sample_tea_32(_j(a), _j(b), rounds)
        t0, t1 = trng.sample_tea_32(_t(a), _t(b), rounds)
        assert _eq(j0, t0) and _eq(j1, t1)
    jf = jrng.sample_tea_f32(_j(a), _j(b))
    tf = trng.sample_tea_f32(_t(a), _t(b))
    assert np.array_equal(np.asarray(jf), tf.numpy())


def test_pcg32_reference_vector():
    """O'Neill's pcg32 demo: seed(42, 54) gives this exact sequence."""
    s = trng.pcg32_seed(0, 42, 0, 54)
    for e in [0xA15C02B7, 0x7B47F409, 0xBA1D3330, 0x83D2F293,
              0xBFA4784B, 0xCBED606E]:
        o, s = trng.pcg32_next_u32(s)
        assert int(o) == e


def test_pcg32_seed_and_next_bitwise():
    # full 64-bit seeds exercise every limb of the multiply and the adds
    hs, ls, hq, lq = (_words(k) for k in range(2, 6))
    sj = jrng.pcg32_seed(_j(hs), _j(ls), _j(hq), _j(lq))
    st = trng.pcg32_seed(_t(hs), _t(ls), _t(hq), _t(lq))
    for fj, ft in zip(sj, st):
        assert _eq(fj, ft)
    for _ in range(3):
        oj, sj = jrng.pcg32_next_u32(sj)
        ot, st = trng.pcg32_next_u32(st)
        assert _eq(oj, ot)


@pytest.mark.parametrize("seed_value,offset", [(0, 0), (12345, 1),
                                               (0xFFFFFFFF, 2)])
def test_pcg32_wavefront_masked_draws_bitwise(seed_value, offset):
    lanes = np.arange(N, dtype=np.uint32) * 7 + 3
    active = np.random.default_rng(6).random(N) < 0.6
    sj = jrng.pcg32_seed_wavefront(np.uint32(seed_value), _j(lanes), offset)
    st = trng.pcg32_seed_wavefront(seed_value, _t(lanes), offset)
    for k in range(6):
        act = active if k % 2 else None
        fj, sj = jrng.pcg32_next_f32(
            sj, None if act is None else jnp.asarray(act))
        ft, st = trng.pcg32_next_f32(
            st, None if act is None else torch.from_numpy(act))
        assert np.array_equal(np.asarray(fj), ft.numpy())
    for fj, ft in zip(sj, st):
        assert _eq(fj, ft)


@pytest.mark.parametrize("count", [1, 7, 1000, 1024])
def test_kensler_bitwise(count):
    idx = _words(7) % count
    seed = _words(8)
    active = np.random.default_rng(9).random(N) < 0.8
    pj = jrng.permute_kensler(_j(idx), count, _j(seed), jnp.asarray(active))
    pt = trng.permute_kensler(_t(idx), count, _t(seed),
                              torch.from_numpy(active))
    assert _eq(pj, pt)
    # a scalar seed, as the samplers pass one per sequence
    pj = jrng.permute_kensler(_j(idx), count, np.uint32(0xDEADBEEF))
    pt = trng.permute_kensler(_t(idx), count, 0xDEADBEEF)
    assert _eq(pj, pt)
