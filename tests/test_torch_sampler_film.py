"""The PyTorch port's samplers and film against the JAX package: correlated
and independent sampler draws are bitwise equal (antithetic time sampling,
the correlate gate, masked draws, ``advance`` and ``advance_window``); the
film splat and develop agree to 1e-6 relative for box, tent and gaussian
filters, in one pass and in strips."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu import films as jfilms
from mitsuba3dopplertof_tpu import samplers as js
from mitsuba3dopplertof_tpu.core import rng as jrng
from mitsuba3dopplertof_tpu_torch import films as tfilms

N = 4096


def _samplers(kind, spp=16, **kw):
    d = {"type": kind, "sample_count": spp, "seed": 5, **kw}
    return mj.load_dict(dict(d)), mt.load_dict(dict(d))


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), b.numpy())


def _same_state(sj, st):
    for f in ("rng", "rng_time", "rng_path"):
        for x, y in zip(getattr(sj, f), getattr(st, f)):
            assert np.array_equal(np.asarray(x).astype(np.int64), y.numpy())
    assert np.array_equal(np.asarray(sj.permutation_seed).astype(np.int64),
                          st.permutation_seed.numpy())
    assert int(sj.sample_index) == st.sample_index
    assert int(sj.dimension_index) == st.dimension_index
    assert np.array_equal(np.asarray(sj.lane).astype(np.int64),
                          st.lane.numpy())
    assert int(sj.seed_value) == st.seed_value


@pytest.fixture(scope="module")
def jit_kensler():
    """The JAX samplers' Kensler permutation under jax.jit (sample count
    static): integer arithmetic, exact under jit, where eagerly each call
    compiles its own while loop. The draws' float arithmetic stays eager."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "permute_kensler",
                   jax.jit(jrng.permute_kensler, static_argnums=1))
        yield


@pytest.mark.parametrize("spw", [16, 4])
def test_correlated_draws_bitwise(jit_kensler, spw):
    sj_, st_ = _samplers("correlated", time_correlate_number=2,
                         path_correlate_number=2)
    for s in (sj_, st_):
        s.set_samples_per_wavefront(spw)
    sj, st = sj_.seed(3, N), st_.seed(3, N)
    _same_state(sj, st)
    rng = np.random.default_rng(11)
    act_np = rng.random(N) < 0.7
    cor_np = rng.random(N) < 0.5
    aj, at = jnp.asarray(act_np), torch.from_numpy(act_np)
    cj, ct = jnp.asarray(cor_np), torch.from_numpy(cor_np)

    draws = [
        lambda s, S, a, c: S.next_2d_correlate(s, a, True),
        lambda s, S, a, c: S.next_1d_time(s, a, js.TIME_ANTITHETIC, 0.5,
                                          True),
        lambda s, S, a, c: S.next_1d_time(s, a, js.TIME_ANTITHETIC, 0.5,
                                          False),
        lambda s, S, a, c: S.next_1d_time(s, a, js.TIME_STRATIFIED, 0.0,
                                          True),
        lambda s, S, a, c: S.next_1d_time(s, a, js.TIME_ANTITHETIC_MIRROR,
                                          0.25, True),
        lambda s, S, a, c: S.next_1d_time(s, a, js.TIME_PERIODIC, 0.0,
                                          False),
        lambda s, S, a, c: S.next_1d_time(s, a, js.TIME_UNIFORM, 0.0, False),
        lambda s, S, a, c: S.next_1d_correlate(s, a, c),
        lambda s, S, a, c: S.next_2d_correlate(s, a, c),
        lambda s, S, a, c: S.next_2d(s, a),
    ]
    for step in range(3):
        for k, draw in enumerate(draws):
            masked = (k + step) % 2 == 0
            vj, sj = draw(sj, sj_, aj if masked else None, cj)
            vt, st = draw(st, st_, at if masked else None, ct)
            assert _same(vj, vt), (step, k)
        _same_state(sj, st)
        sj, st = ((sj_.advance(sj), st_.advance(st)) if step == 0 else
                  (sj_.advance_window(sj), st_.advance_window(st)))
        _same_state(sj, st)


def test_independent_draws_bitwise():
    sj_, st_ = _samplers("independent", spp=8)
    sj, st = sj_.seed(0, N, lane0=N * 3), st_.seed(0, N, lane0=N * 3)
    _same_state(sj, st)
    for _ in range(4):
        vj, sj = sj_.next_2d(sj)
        vt, st = st_.next_2d(st)
        assert _same(vj, vt)
        vj, sj = sj_.next_1d_time(sj)
        vt, st = st_.next_1d_time(st)
        assert _same(vj, vt)
    _same_state(sj_.advance(sj), st_.advance(st))


W, H, SPP = 12, 10, 8


def _wavefront(rows, row0, seed):
    n = rows * W * SPP
    rng = np.random.default_rng(seed)
    lane = np.arange(n) // SPP
    px = (lane % W).astype(np.float32)
    py = (lane // W + row0).astype(np.float32)
    pos_x = px + rng.random(n, dtype=np.float32)
    pos_y = py + rng.random(n, dtype=np.float32)
    values = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    values.append(np.ones(n, np.float32))
    active = rng.random(n) < 0.9
    return pos_x, pos_y, values, active


def _splat_both(rf, rows, row0, pad, strip_rows, blocks, seed):
    pos_x, pos_y, values, active = _wavefront(rows, row0, seed)
    jb, tb = blocks
    jb = jfilms.block_splat_wavefront(
        jb, rf[0], jnp.asarray(pos_x), jnp.asarray(pos_y),
        [jnp.asarray(v) for v in values], jnp.asarray(active), W, H, SPP,
        pad_rows=pad, row0=row0, strip_rows=strip_rows)
    tb = tfilms.block_splat_wavefront(
        tb, rf[1], torch.from_numpy(pos_x), torch.from_numpy(pos_y),
        [torch.from_numpy(v) for v in values], torch.from_numpy(active),
        W, H, SPP, pad_rows=pad, row0=row0, strip_rows=strip_rows)
    return jb, tb


def _close(a, b, rtol=1e-6):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else b
    scale = max(float(np.abs(a).max()), 1e-30)
    return np.allclose(b, a, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("kind", ["box", "tent", "gaussian"])
def test_splat_and_develop_match(kind):
    rf = (mj.load_dict({"type": kind}), mt.load_dict({"type": kind}))
    assert tfilms.filter_reach(rf[1]) == jfilms.filter_reach(rf[0])
    # one pass over the frame
    jb, tb = _splat_both(rf, H, 0, 0, None,
                         (jfilms.block_create(W, H, 4),
                          tfilms.block_create(W, H, 4)), seed=1)
    assert _close(jb, tb)
    assert _close(jfilms.develop(jb, False), tfilms.develop(tb, False))
    # strips of 3 rows (the last one ragged) on a padded canvas
    k = tfilms.filter_reach(rf[1])
    rows, n_strips = 3, 4
    blocks = (jfilms.block_create(W, 2 * k + rows * n_strips, 4),
              tfilms.block_create(W, 2 * k + rows * n_strips, 4))
    for s in range(n_strips):
        blocks = _splat_both(rf, rows, s * rows, k, rows, blocks,
                             seed=10 + s)
    assert _close(*blocks)
    jd = jfilms.develop(blocks[0][:, k:k + H], False)
    td = tfilms.develop(blocks[1][:, k:k + H], False)
    assert _close(jd, td)


def test_develop_guards_zero_weight():
    block = torch.zeros((4, 3, 5))
    block[:, 1, 2] = torch.tensor([2.0, 4.0, 6.0, 2.0])
    img = tfilms.develop(block, False)
    assert img.shape == (3, 5, 3)
    assert torch.isfinite(img).all()
    assert img[1, 2].tolist() == [1.0, 2.0, 3.0]
    assert (img.sum() == 6.0).item()


def test_tree_sum_is_split_invariant():
    """Per-pixel sums do not depend on how many pixels share the call:
    the property that makes strip passes equal one pass bit for bit."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(64, 24)).astype(np.float32))
    whole = tfilms._tree_sum(x)
    parts = torch.cat([tfilms._tree_sum(x[i:i + 8]) for i in range(0, 64, 8)])
    assert torch.equal(whole, parts)
    assert torch.allclose(whole, x.double().sum(1).float(), rtol=1e-5,
                          atol=1e-5)
