"""The rayleigh, blendphase, tabphase and sggx phases in the PyTorch port
against the JAX package on the CPU: each phase's sampling and evaluation
on 10^4 lanes, volpath's SGGX S lookup in a grid that varies in space
(``_sggx_S6``), the refusals of bad input, the media scene's compiled
tables (bit for bit) and its volpath image. The media scene is
``utils/textured_scenes.media_scene``: four boxes of homogeneous media,
one per phase, the SGGX one with a 6-channel S grid. Functions agree
within rtol 1e-4, atol 1e-5; the image at PERF.md section 2's tolerance
(rtol 1e-4, atol 1e-4 * max|ref|). Inputs are made from a seed with
numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu import integrators as ji
from mitsuba3dopplertof_tpu import media as jmedia
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.core.vec import Vec3 as JVec3
from mitsuba3dopplertof_tpu.integrators import volpath as jvol

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch import media as tmedia
from mitsuba3dopplertof_tpu_torch.core import transform as ttf
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3dopplertof_tpu_torch.integrators import volpath as tvol
from mitsuba3dopplertof_tpu_torch.media import (M_PHASE, M_SGGX,
                                                M_SGGX_NX)
from mitsuba3dopplertof_tpu_torch.render.scene import (SceneArrays,
                                                       from_jax_scene_arrays)
from mitsuba3dopplertof_tpu_torch.utils import textured_scenes as ts

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_ties import TieRecorder

TOL = dict(rtol=1e-4, atol=1e-5)
N = 10000
RES, SPP = 16, 16


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i], jnp.float32) for i in range(3)))


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i],
                                                         np.float32))
                   for i in range(3)))


def _close(ours, theirs, label):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), err_msg=label,
                               **TOL)


def _close3(ours, theirs, label):
    for c in "xyz":
        _close(getattr(ours, c), getattr(theirs, c), f"{label}.{c}")


def _unit(rng, n):
    v = rng.standard_normal((n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def sggx_vol(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("phases") / "sggx.vol")
    ts.write_sggx_vol(path)
    return path


@pytest.fixture(scope="module")
def compiled(sggx_vol):
    """(port tables, JAX tables) of the media scene at 16x16 x 16 spp."""
    return (mt.load_dict(ts.media_scene(sggx_vol, SPP, RES, ttf),
                         device="cpu").compile(),
            mj.load_dict(ts.media_scene(sggx_vol, SPP, RES, jtf)).compile())


TAB_VALUES = (0.2, 0.3, 0.5, 1.0, 2.5, 6.0)
# an S with off-diagonal terms: flakes tilted out of the axes
S_TILTED = (1.0, 0.3, 0.6, 0.2, -0.1, 0.15)


@pytest.mark.parametrize("phase", ["rayleigh", "tabphase", "sggx", "hg"])
def test_phase_sample_and_eval_match_jax(phase):
    """Each phase's sample (direction and pdf) from random incident
    directions, and its value between random direction pairs: Rayleigh's
    Cardano inverse, the tabulated trapezoid-CDF inverse, SGGX's visible
    normal sample and its eval, and HG at a blendphase's interpolated g
    (0.7 * 0.6 + 0.3 * -0.3 = 0.33)."""
    rng = np.random.default_rng({"rayleigh": 3, "tabphase": 5, "sggx": 7,
                                 "hg": 11}[phase])
    wi, wo = _unit(rng, N), _unit(rng, N)
    s = rng.random((N, 2)).astype(np.float32)
    sj = (jnp.asarray(s[:, 0]), jnp.asarray(s[:, 1]))
    st = (torch.from_numpy(s[:, 0].copy()), torch.from_numpy(s[:, 1].copy()))
    cos = np.sum(wi * wo, 1).astype(np.float32)
    if phase == "rayleigh":
        (wo_j, pdf_j), (wo_t, pdf_t) = (jmedia.rayleigh_sample(_jv(wi), *sj),
                                        tmedia.rayleigh_sample(_tv(wi), *st))
        ev_j = jmedia.rayleigh_eval(jnp.asarray(cos))
        ev_t = tmedia.rayleigh_eval(torch.from_numpy(cos))
    elif phase == "tabphase":
        tj = jmedia.tab_phase_tables(np.asarray(TAB_VALUES))
        grid, vals, cdf, inv = tmedia.tab_phase_tables(TAB_VALUES)
        for a, b in zip((grid, vals, cdf, inv), tj):
            assert np.array_equal(a, b)
        tt = tuple(torch.from_numpy(a) for a in (grid, vals, cdf))
        wo_j, pdf_j = jmedia.tab_sample(_jv(wi), *sj, *tj)
        wo_t, pdf_t = tmedia.tab_sample(_tv(wi), *st, *tt, float(inv))
        ev_j = jmedia.tab_eval(jnp.asarray(cos), tj[0], tj[1], tj[3])
        ev_t = tmedia.tab_eval(torch.from_numpy(cos), tt[0], tt[1],
                               float(inv))
    elif phase == "sggx":
        S_j = tuple(jnp.full((N,), v, jnp.float32) for v in S_TILTED)
        S_t = tuple(torch.full((N,), v) for v in S_TILTED)
        wo_j, pdf_j = jmedia.sggx_sample(_jv(wi), *sj, S_j)
        wo_t, pdf_t = tmedia.sggx_sample(_tv(wi), *st, S_t)
        ev_j = jmedia.sggx_eval(_jv(wi), _jv(wo), S_j)
        ev_t = tmedia.sggx_eval(_tv(wi), _tv(wo), S_t)
    else:
        g = mt.load_dict({"type": "blendphase", "weight": 0.3,
                          "a": {"type": "hg", "g": 0.6},
                          "b": {"type": "hg", "g": -0.3}}).g
        assert g == mj.load_dict({"type": "blendphase", "weight": 0.3,
                                  "a": {"type": "hg", "g": 0.6},
                                  "b": {"type": "hg", "g": -0.3}}).g
        gj, gt = jnp.full((N,), g, jnp.float32), torch.full((N,), g)
        wo_j, pdf_j = jmedia.hg_sample(_jv(wi), gj, *sj)
        wo_t, pdf_t = tmedia.hg_sample(_tv(wi), gt, *st)
        ev_j = jmedia.hg_eval(jnp.asarray(cos), gj)
        ev_t = tmedia.hg_eval(torch.from_numpy(cos), gt)
    _close3(wo_t, wo_j, "wo")
    _close(pdf_t, pdf_j, "pdf")
    _close(ev_t, ev_j, "eval")
    assert float(ev_t.std()) > 1e-3
    # a normalized phase: the mean of eval over uniform directions is
    # 1 / (4 pi)
    assert abs(float(ev_t.mean()) * 4 * np.pi - 1.0) < 0.08


def test_sggx_grid_lookup_matches_jax(compiled):
    """_sggx_S6 at points in and around the SGGX box, for lanes in each
    of the four media and in none: the trilinear lookup of the S grid for
    the SGGX medium (its S changes across the box), the row's constant S
    for the others."""
    sa_t, sa_j = compiled
    rng = np.random.default_rng(13)
    p = rng.uniform([0.9, -0.5, -0.5], [2.1, 0.5, 0.5], (N, 3)).astype(
        np.float32)
    med = rng.integers(-1, 4, N).astype(np.int32)
    const_j = tuple(jnp.asarray(np.asarray(sa_j.med_params)[
        M_SGGX + i][np.maximum(med, 0)]) for i in range(6))
    const_t = tuple(sa_t.med_params[M_SGGX + i][
        torch.from_numpy(np.maximum(med, 0)).long()] for i in range(6))
    s_j = jvol._sggx_S6(sa_j, jnp.asarray(med), _jv(p), const_j)
    s_t = tvol._sggx_S6(sa_t, torch.from_numpy(med), _tv(p), const_t)
    for i in range(6):
        _close(s_t[i], s_j[i], f"S{i}")
    on = med == 3
    assert np.asarray(s_t[1])[on].std() > 0.1     # Syy turns across x
    assert np.all(np.asarray(s_t[1])[med == 0] == 0.0)


def test_media_tables_match_jax(compiled):
    """The media scene compiles to the JAX package's tables bit for bit:
    the medium rows (phase kernels, SGGX columns, the S grid's offset and
    resolution), the (V, 6) S atlas and its world-to-grid columns, and
    the metadata (any_sggx, any_sggx_grid, any_rayleigh, the tabulated
    phase's values)."""
    sa_t, sa_j = compiled
    via = from_jax_scene_arrays(
        {k: np.asarray(getattr(sa_j, k))
         for k in SceneArrays.ARRAY_FIELDS + ["chunk_aabb"]}, sa_j)
    for k in SceneArrays.ARRAY_FIELDS + ["chunk_aabb"]:
        a, b = getattr(sa_t, k), getattr(via, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for k in SceneArrays.META_FIELDS:
        assert getattr(sa_t, k) == getattr(via, k), k
    assert sa_t.med_params[M_PHASE].tolist() == [2.0, 0.0, 3.0, 1.0]
    assert sa_t.med_params[M_SGGX_NX].tolist() == [0.0, 0.0, 0.0, 8.0]
    assert tuple(sa_t.sggx_grid.shape) == (4 * 4 * 8, 6)
    assert (sa_t.any_sggx, sa_t.any_sggx_grid, sa_t.any_rayleigh) == (
        True, True, True)
    assert sa_t.tab_phase_tables == (None, None, TAB_VALUES, None)


def _sggx_with_grid(path, channels):
    data = np.ones((2, 2, 2, channels), np.float32)
    ts.write_vol(path, data)
    return {"type": "sggx", "S": {"type": "gridvolume", "filename": path}}


@pytest.mark.parametrize("case", ["tab_negative", "tab_all_zero",
                                  "sggx_five_channels", "sggx_no_S"])
def test_phase_refusals_match_jax(case, tmp_path):
    """Both packages refuse the same bad input: a table with a negative
    value or no positive one, an S grid of fewer than 6 channels, an SGGX
    phase without S."""
    phase = {"tab_negative": {"type": "tabphase", "values": "1, -0.5, 2"},
             "tab_all_zero": {"type": "tabphase", "values": "0, 0, 0"},
             "sggx_five_channels": _sggx_with_grid(
                 str(tmp_path / "s5.vol"), 5),
             "sggx_no_S": {"type": "sggx"}}[case]
    for pkg in (mt, mj):
        with pytest.raises(RuntimeError, match="tabphase|sggx"):
            pkg.load_dict(dict(phase))


def test_media_render_matches_jax(sggx_vol, monkeypatch):
    """volpath on the media scene at 16x16 x 16 spp, seed 0, the lanes
    whose queries meet a tie or graze an edge (the port's TieRecorder: at
    most 1% of them) left out of both films: every value of the port's
    image is within rtol 1e-4, atol 1e-4 * max|ref| of the JAX package's;
    the port's volpathmis is the same image bit for bit."""
    rec = TieRecorder(RES * RES * SPP, "cpu")
    scene = mt.load_dict(ts.media_scene(sggx_vol, SPP, RES, ttf),
                         device="cpu")
    with rec.hooked(), rec.dropped():
        img = mt.render(scene, spp=SPP, seed=0).numpy()
    with rec.dropped():
        mis = mt.render(scene, spp=SPP, seed=0, integrator=mt.load_dict(
            {"type": "volpathmis", "max_depth": 6})).numpy()
    assert np.array_equal(mis, img)
    assert int(rec.marked.sum()) <= 0.01 * RES * RES * SPP
    keep = jnp.asarray(~rec.marked.numpy())
    splat = ji.block_splat_wavefront

    def splat_kept(block, rfilter, x, y, values, active, *args, **kw):
        assert active.shape == keep.shape
        return splat(block, rfilter, x, y, values, active & keep, *args,
                     **kw)

    monkeypatch.setattr(ji, "block_splat_wavefront", splat_kept)
    ref = np.asarray(mj.render(mj.load_dict(ts.media_scene(
        sggx_vol, SPP, RES, jtf)), spp=SPP, seed=0))
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all()
    scale = np.abs(ref).max()
    assert scale > 0.0
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-4 * scale)
    bad = [(tuple(int(i) for i in ix), float(img[tuple(ix)]),
            float(ref[tuple(ix)])) for ix in np.argwhere(~close)]
    assert not bad, (int(rec.marked.sum()), bad[:10])


@pytest.mark.parametrize("phase", ts.PHASES)
def test_each_phase_changes_the_image(sggx_vol, phase):
    """The port's volpath with one box's phase replaced by the isotropic
    one renders another image: each phase's kernel is on the path."""
    base = ts.media_scene(sggx_vol, 4, 8, ttf)
    iso = ts.media_scene(sggx_vol, 4, 8, ttf)
    iso[f"box_{phase}"]["interior"]["phase"] = {"type": "isotropic"}
    a, b = (mt.render(mt.load_dict(d, device="cpu"), spp=4,
                      seed=1).numpy() for d in (base, iso))
    assert np.isfinite(a).all() and not np.array_equal(a, b)

