"""The polarized variants in the PyTorch port against the JAX package on
the CPU.

Modules, on 4,096 seeded lanes: ``core/mueller.py`` function by function
(2e-6 absolute, 4e-6 relative; the Stokes-basis rotations on angles
within pi / 2 of 0); the polarized integrator's Mueller factors
(Rayleigh, the rotated elements, the specular Fresnel matrices; 1e-4
absolute) on the lanes away from normal and grazing incidence whose
basis rotations all turn by less than 0.9 pi (the JAX package's
``_unit_angle`` is ill-conditioned near pi); the polarizing elements'
BSDF rows and their scalar dispatch bit for bit; the measured pBRDF's
tables bit for bit and its Mueller eval and sampling record (rtol 1e-4,
atol 1e-6); the compiled tables of a polarized scene; and the
depolarizing fast path's decision on the JAX package's two fast-path
scenes.

Renders at 16x16 x 16 spp, seed 0, each against the JAX package's render
run op by op (``torch_port_helpers.jax_op_by_op``, each made once for the
module: in the one-worker run this size is cheaper than 8x8 x 4, its
4,096-lane programs being the unit tests' and other files') at PERF.md
section 2's tolerance over every channel, the 12 Stokes AOVs included
(rtol 1e-4, atol 1e-4 * max|ref|): the three elements' plates
(``utils/polarized_scenes.ELEMENTS``, max_depth 3); the polarizing
canonical under stokes(dopplertofpath) (max_depth 3) and under ptracer
(max_depth 2); stokes(volpath) on the Rayleigh cube over rough copper
(max_depth 2) in cuda_spectral_polarized (copper's eta / k spectra, the
medium's and the light's spectra); measured_polarized on a sphere
(max_depth 2).
Port-only: the fast path's image equals cuda_rgb's bit for bit and the
Mueller chain's S0 to 1e-6; flipping MI_NO_DEPOL_FASTPATH between two
renders of one scene changes the path; Malus's law and the quarter-wave
plate; the plugins from a dict and from XML. Every test that sets a
variant restores rgb in its teardown."""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu import integrators as jint
from mitsuba3dopplertof_tpu.bsdfs import measured_polarized_impl as jmp
from mitsuba3dopplertof_tpu.core import mueller as jmu
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.core.vec import Vec3 as JVec3
from mitsuba3dopplertof_tpu.integrators import polarized as jpol
from mitsuba3dopplertof_tpu.io import tensor_file as jtfile

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch import bsdfs as tb
from mitsuba3dopplertof_tpu_torch import integrators as tint
from mitsuba3dopplertof_tpu_torch.bsdfs import measured_polarized_impl as tmp
from mitsuba3dopplertof_tpu_torch.core import mueller as tmu
from mitsuba3dopplertof_tpu_torch.core import transform as ttf
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3dopplertof_tpu_torch.integrators import polarized as tpol
from mitsuba3dopplertof_tpu_torch.io import tensor_file as ttfile
from mitsuba3dopplertof_tpu_torch.utils import measured_data as md
from mitsuba3dopplertof_tpu_torch.utils import polarized_scenes as ps

from torch_port_helpers import jax_op_by_op
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 4096
# 2e-6 absolute plus a few float32 ulps: XLA's sqrt, rsqrt and asin differ
# from PyTorch's in the last bit on part of the inputs (rsqrt on about a
# third of them), and the complex Fresnel divisions carry such a bit to
# ~30 ulps of 1 on a few lanes
FN_TOL = dict(rtol=4e-6, atol=2e-6)
# the Stokes-basis rotations compared: the JAX package's unit angle,
# 2 asin(|b - a| / 2), magnifies a last-bit difference of its argument by
# 1 / cos(angle / 2), to ~5e-4 near pi (ROADMAP Queue C)
MAX_ANGLE = 0.9 * np.pi
SPP = 16
RES = 16


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


def _set_both(name):
    mj.set_variant("tpu_" + name)
    return mt.set_variant("cuda_" + name)


@pytest.fixture
def variant():
    """Sets both packages' variant for one test; rgb again afterwards."""
    yield _set_both
    _set_both("rgb")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, theirs, label, **tol):
    np.testing.assert_allclose(_np(ours), _np(theirs), err_msg=label,
                               **(tol or FN_TOL))


def _close_tree(ours, theirs, label, **tol):
    """Tuples / Vec3s / pairs of tensors, leaf by leaf."""
    if isinstance(ours, (tuple, list)):
        assert len(ours) == len(theirs), label
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _close_tree(a, b, f"{label}[{i}]", **tol)
    else:
        _close(ours, theirs, label, **tol)


def _vecs(rng, n=N, upper=False):
    v = rng.normal(size=(3, n)).astype(np.float32)
    if upper:
        v[2] = np.abs(v[2]) + 0.1
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    return v


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _jv(a):
    return JVec3(*(jnp.asarray(c) for c in a))


@contextlib.contextmanager
def _rotations():
    """Records, lane by lane, the largest angle of the port's Stokes-basis
    rotations made while open; yields the list its mask is appended to
    (True where every rotation turned by less than MAX_ANGLE)."""
    from mitsuba3dopplertof_tpu_torch.core.vec import normalize
    orig = tmu.rotate_stokes_basis
    ok = []

    def recorded(forward, basis_current, basis_target):
        theta = tmu._unit_angle(normalize(basis_current),
                                normalize(basis_target))
        ok.append((theta < MAX_ANGLE).numpy())
        return orig(forward, basis_current, basis_target)
    tmu.rotate_stokes_basis = recorded
    try:
        yield ok
    finally:
        tmu.rotate_stokes_basis = orig


def _lanes(tree, keep):
    """``tree`` with every leaf cut to the lanes of ``keep``."""
    if isinstance(tree, (tuple, list)):
        return tuple(_lanes(t, keep) for t in tree)
    return _np(tree)[keep]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _fresnel_case(rng):
    ci = rng.uniform(-1, 1, N).astype(np.float32)
    er = rng.uniform(0.5, 2.5, N).astype(np.float32)
    ei = np.where(rng.random(N) < 0.5, 0.0,
                  rng.uniform(0.0, 4.0, N)).astype(np.float32)
    er[:64], ei[:64] = 1.0, 0.0          # index-matched lanes: no Fresnel
    return ci, er, ei


def _mueller_fresnel(m, T, rng):
    ci, er, ei = (T(x) for x in _fresnel_case(rng))
    return (m.fresnel_polarized(ci, er, ei),
            m.specular_reflection_mueller(ci, (er, er * 0.9, er * 1.1),
                                          (ei, ei * 0.5, ei)),
            m.specular_transmission_mueller(ci, er))


def _mueller_elements(m, T, rng):
    th = T(rng.uniform(-np.pi, np.pi, N).astype(np.float32))
    return (m.linear_polarizer(1.0, like=th), m.linear_polarizer(0.7, th),
            m.linear_retarder(th), m.right_circular_polarizer(th),
            m.left_circular_polarizer(th), m.rotator(th),
            m.rotated_element(th, m.linear_polarizer(1.0, like=th)),
            m.mm_zero(th), m.mm_identity(th))


def _mueller_algebra(m, T, V, rng):
    A = tuple(V(e) for e in rng.uniform(-1, 1, (16, 3, N)).astype(np.float32))
    B = tuple(V(e) for e in rng.uniform(-1, 1, (16, 3, N)).astype(np.float32))
    S = tuple(V(e) for e in rng.uniform(-1, 1, (4, 3, N)).astype(np.float32))
    s = T(rng.uniform(0, 2, N).astype(np.float32))
    mask = T(rng.random(N) < 0.5)
    return (m.mm_mul(A, B), m.mm_transpose(A), m.mm_scale(A, s),
            m.mm_scale(A, S[0]), m.mm_where(mask, A, B),
            m.mm_apply_stokes(A, S), m.stokes_where(mask, S, S[::-1]),
            m.depolarizer(S[1]),
            m.mm_from_rows([s if i % 2 else S[0] for i in range(16)]))


def _mueller_bases(m, T, V, rng):
    f = _vecs(rng)
    # the target basis: the current one turned about forward by an angle
    # within pi / 2: the JAX package's unit angle, 2 asin(|b - a| / 2),
    # magnifies a last-bit difference of its argument by 1 / cos(angle / 2)
    cur = np.stack([np.asarray(c) for c in jmu.stokes_basis(_jv(f))])
    ang = rng.uniform(-0.5 * np.pi, 0.5 * np.pi, N).astype(np.float32)
    tgt = (cur * np.cos(ang) + np.cross(f.T, cur.T).T * np.sin(ang)).astype(
        np.float32)
    g = _vecs(rng)
    cur2 = np.stack([np.asarray(c) for c in jmu.stokes_basis(_jv(g))])
    M = tuple(V(e) for e in rng.uniform(-1, 1, (16, 3, N)).astype(np.float32))
    return (m.stokes_basis(V(f)), m.rotate_stokes_basis(V(f), V(cur), V(tgt)),
            m.rotate_mueller_basis(M, V(f), V(cur), V(tgt), V(g), V(cur2),
                                   V(cur2)),
            m.rotate_mueller_basis_collinear(M, V(f), V(cur), V(tgt)))


MUELLER_CASES = {"fresnel": _mueller_fresnel,
                 "elements": _mueller_elements,
                 "algebra": _mueller_algebra,
                 "bases": _mueller_bases}


@pytest.mark.parametrize("case", sorted(MUELLER_CASES))
def test_mueller_matches_jax(case):
    """core/mueller.py against the JAX package's on the same seeded
    inputs, 1e-6 absolute."""
    fn = MUELLER_CASES[case]
    extra = case in ("algebra", "bases")
    rng_t, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    tv = (lambda a: _tv(a)) if extra else None
    ours = (fn(tmu, torch.from_numpy, tv, rng_t) if extra
            else fn(tmu, torch.from_numpy, rng_t))
    theirs = (fn(jmu, jnp.asarray, _jv, rng_j) if extra
              else fn(jmu, jnp.asarray, rng_j))
    _close_tree(ours, theirs, case)


def test_polarized_factors_match_jax():
    """The polarized integrator's local Mueller factors: Rayleigh
    scattering, the three rotated elements (tilted axes), the specular
    and rough Fresnel matrices with their plane-of-incidence rotations."""
    from mitsuba3dopplertof_tpu.render.types import SurfaceInteraction as JSI
    from mitsuba3dopplertof_tpu_torch.render.types import \
        SurfaceInteraction as TSI
    rng = np.random.default_rng(11)
    d_in, d_out = _vecs(rng), _vecs(rng)
    wi, wo = _vecs(rng, upper=True), _vecs(rng, upper=False)
    # rough reflection: the micro-normal is the half vector of wi and an
    # upper-hemisphere wo (wo near -wi has none)
    wo_up = _vecs(rng, upper=True)
    th = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    de = rng.uniform(0.0, np.pi, N).astype(np.float32)
    er = rng.uniform(0.2, 2.0, (3, N)).astype(np.float32)
    ei = rng.uniform(0.0, 4.0, (3, N)).astype(np.float32)

    def run(pol, V, T, SI):
        si = SI(*([None] * len(SI._fields)))._replace(wi=V(wi))

        class BS:
            def __init__(self, w):
                self.wo = w

            def _replace(self, wo):
                return BS(wo)
        out = [pol.rayleigh_scatter_mueller(V(d_in), V(d_out))]
        for kind in (12, 13, 14):
            out.append(pol._element_bounce_mueller(si, T(th), T(de), kind))
        for rough, w in ((False, wo), (True, wo_up)):
            out.append(pol._specular_bounce_mueller(
                si, BS(V(w)), V(er), V(ei), rough=rough))
        return out
    with _rotations() as ok:
        ours = run(tpol, _tv, torch.from_numpy, TSI)
    theirs = run(jpol, _jv, jnp.asarray, JSI)
    # their basis rotations turn by any angle in (-pi, pi]: the lanes
    # whose rotations all stay below MAX_ANGLE
    keep = np.logical_and.reduce(ok)
    assert keep.mean() > 0.4        # 54% of the seeded lanes
    # and whose planes of incidence are defined and Fresnel not at its
    # steepest: not within ~8 degrees of normal incidence on the surface
    # or on the rough micro-facet, nor grazing the micro-facet
    h = wo_up + wi
    h /= np.linalg.norm(h, axis=0)
    cos_m = np.sum(h * wo_up, axis=0)
    keep &= ((np.abs(wi[2]) < 0.99) & (np.abs(wo[2]) < 0.99)
             & (cos_m < 0.99) & (cos_m > 0.1))
    # 1e-4: the JAX package's complex square root takes its imaginary
    # part from sqrt((|z| - re z) / 2), a cancellation for the nearly real
    # cos^2 theta_t of a conductor near normal incidence (~140 ulps seen);
    # the planes' axes and the unit angle multiply a last-bit difference
    # by up to ~7 near the cuts above
    _close_tree(_lanes(ours, keep), _lanes(theirs, keep),
                "polarized factors", rtol=4e-6, atol=1e-4)


def _plates_dict(tf, spp=SPP, res=RES):
    return ps.plate_scene(ps.ELEMENTS, spp=spp, res=res, tf=tf, max_depth=3)


def test_element_rows_and_dispatch_match_jax(variant):
    """polarizer / retarder / circular: the compiled BSDF rows and the
    scalar dispatch (0.5, 1 and 0.5 times the transmittance) on seeded
    lanes, bit for bit, in cuda_rgb (the null row's tint) and
    cuda_rgb_polarized."""
    from mitsuba3dopplertof_tpu.bsdfs import eval_pdf_sample as jeps
    for name in ("rgb", "rgb_polarized"):
        variant(name)
        sa_t = mt.load_dict(_plates_dict(ttf)).compile()
        sa_j = mj.load_dict(_plates_dict(jtf)).compile()
        assert sa_t.polarized == sa_j.polarized == (name != "rgb")
        np.testing.assert_array_equal(sa_t.bsdf_params.numpy(),
                                      np.asarray(sa_j.bsdf_params))
        np.testing.assert_array_equal(sa_t.bsdf_type.numpy(),
                                      np.asarray(sa_j.bsdf_type))
        assert sa_t.bsdf_types_present == sa_j.bsdf_types_present == (
            12, 13, 14)
        assert sa_t.bsdf_flags_host == sa_j.bsdf_flags_host
        rng = np.random.default_rng(5)
        lane = rng.integers(0, 3, N).astype(np.int32)
        wi = _vecs(rng, upper=True)
        s = rng.random((3, N)).astype(np.float32)
        ours = tb.eval_pdf_sample(sa_t, torch.from_numpy(lane), _tv(wi),
                                  _tv(wi), *map(torch.from_numpy, s))
        theirs = jeps(sa_j, jnp.asarray(lane), _jv(wi), _jv(wi),
                      *map(jnp.asarray, s))
        _close_tree(tuple(ours), tuple(theirs), name, rtol=0.0, atol=0.0)
        w = ours.weight.x.numpy()
        np.testing.assert_array_equal(w, np.select(
            [lane == 0, lane == 1, lane == 2], [0.5, 1.0, 0.5]))


@pytest.fixture(scope="module")
def pbsdf(tmp_path_factory):
    return md.write_pbsdf(str(tmp_path_factory.mktemp("pbsdf")
                              / "pol.pbsdf"))


def test_pbsdf_tables_match_jax(pbsdf):
    """The file read by both packages and build_pbsdf_tables, bit for
    bit."""
    f_t = ttfile.read_tensor_file(pbsdf)
    f_j = jtfile.read_tensor_file(pbsdf)
    ours, theirs = tmp.build_pbsdf_tables(f_t), jmp.build_pbsdf_tables(f_j)
    for k in tmp.PbsdfTables._fields:
        a, b = getattr(ours, k).numpy(), np.asarray(getattr(theirs, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert ours.M.shape == (4 * 5 * 6 * 5, 16)


def test_pbsdf_eval_and_sample_match_jax(pbsdf):
    """pbsdf_eval_mueller and the scalar sampling record on 4,096 seeded
    lanes (rtol 1e-4, atol 1e-6), at the rgb band centres: the sampling
    record on every lane, the Mueller matrix on
    the lanes whose basis rotations stay below MAX_ANGLE."""
    tbl_t = tmp.build_pbsdf_tables(ttfile.read_tensor_file(pbsdf))
    tbl_j = jmp.build_pbsdf_tables(jtfile.read_tensor_file(pbsdf))
    rng = np.random.default_rng(21)
    wi, wo = _vecs(rng, upper=True), _vecs(rng, upper=True)
    wo_nee = _vecs(rng)
    s = rng.random((3, N)).astype(np.float32)
    alpha = rng.uniform(0.05, 0.5, N).astype(np.float32)
    for wls in (tmp.RGB_WAVELENGTHS,):
        with _rotations() as ok:
            M_t = tmp.pbsdf_eval_mueller(tbl_t, _tv(wi), _tv(wo), wls)
        keep = np.logical_and.reduce(ok)
        assert keep.mean() > 0.8        # 86% of the seeded lanes
        ours = (M_t,
                tuple(tmp.pbsdf_eval_pdf_sample(
                    tbl_t, torch.from_numpy(alpha), _tv(wi), _tv(wo_nee),
                    *map(torch.from_numpy, s), wavelengths=wls)))
        theirs = (jmp.pbsdf_eval_mueller(tbl_j, _jv(wi), _jv(wo), wls),
                  tuple(jmp.pbsdf_eval_pdf_sample(
                      tbl_j, jnp.asarray(alpha), _jv(wi), _jv(wo_nee),
                      *map(jnp.asarray, s), wavelengths=wls)))
        _close_tree(ours[1], theirs[1], f"pbsdf sample {wls}", rtol=1e-4,
                    atol=1e-6)
        _close_tree(_lanes(ours[0], keep), _lanes(theirs[0], keep),
                    f"pbsdf Mueller {wls}", rtol=1e-4, atol=1e-6)
    assert float(ours[0][0].x.max()) > 0.05


def test_compiled_tables_match_jax(variant, pbsdf):
    """A polarized scene (the three elements, a measured_polarized sphere,
    a rough gold floor) compiled by the port equals the JAX package's
    compile carried over by from_jax_scene_arrays, bit for bit: every
    array and metadata field (``polarized``, ``measured_pol_wls`` among
    them) and the pBRDF tables, in both polarized variants (in the
    spectral one the emitters' fitted coefficients aside)."""
    from mitsuba3dopplertof_tpu_torch.render.scene import (
        SceneArrays, from_jax_scene_arrays)

    def scene(tf):
        d = md.measured_polarized_sphere_dict(
            pbsdf, None, SPP, 4, tf, {"type": "stokes",
                                      "nested": {"type": "path"}})
        d["floor"]["bsdf"] = {"type": "roughconductor", "material": "Au"}
        for i, (bsdf, z, x) in enumerate(ps.ELEMENTS):
            d[f"plate{i}"] = {"type": "rectangle", "bsdf": bsdf,
                              "to_world": tf.translate([x, 2.0, z])}
        return d
    for name in ("rgb_polarized", "spectral_polarized"):
        variant(name)
        sa_t = mt.load_dict(scene(ttf)).compile()
        sa_j = mj.load_dict(scene(jtf)).compile()
        via = from_jax_scene_arrays(
            {k: np.asarray(getattr(sa_j, k))
             for k in SceneArrays.ARRAY_FIELDS}, sa_j)
        for k in SceneArrays.ARRAY_FIELDS:
            if k == "emitter_params" and name == "spectral_polarized":
                # the emitters' sigmoid fits can differ along flat
                # directions (tests/test_torch_spectral.py compares them
                # as spectra)
                continue
            a, b = getattr(sa_t, k), getattr(via, k)
            assert a.dtype == b.dtype and torch.equal(a, b), (name, k)
        for k in SceneArrays.META_FIELDS:
            assert getattr(sa_t, k) == getattr(via, k), (name, k)
        assert sa_t.polarized and sa_t.spectral == (name != "rgb_polarized")
        assert len(sa_t.measured_pol) == len(via.measured_pol) == 1
        for a, b in zip(sa_t.measured_pol[0], via.measured_pol[0]):
            assert torch.equal(a, b)


def _fastpath_scene(bsdf, tf):
    """The JAX package's tests/test_polarized_fastpath.py scene."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1.0, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([4, 4, 1]),
                  "bsdf": bsdf},
        "light": {"type": "point", "position": [0, 3, -3],
                  "intensity": {"type": "rgb", "value": 30.0}},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0.5, -3], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 24, "height": 16},
                   "sampler": {"type": "independent", "sample_count": 8}},
    }


DIFF = {"type": "twosided", "nested": {"type": "diffuse"}}


@pytest.mark.parametrize("bsdf", [DIFF, {"type": "conductor"}],
                         ids=["diffuse", "conductor"])
def test_scene_depolarizing_matches_jax(variant, bsdf, monkeypatch):
    """The fast path's decision on the JAX package's two fast-path scenes,
    and MI_NO_DEPOL_FASTPATH turning it off in both packages."""
    variant("rgb_polarized")
    sa_t = mt.load_dict(_fastpath_scene(bsdf, ttf)).compile()
    sa_j = mj.load_dict(_fastpath_scene(bsdf, jtf)).compile()
    assert (tint.scene_depolarizing(sa_t) == jint._scene_depolarizing(sa_j)
            == (bsdf is DIFF))
    monkeypatch.setenv("MI_NO_DEPOL_FASTPATH", "1")
    assert not tint.scene_depolarizing(sa_t)
    assert not jint._scene_depolarizing(sa_j)


def test_fast_path_equals_rgb(variant, monkeypatch):
    """On a depolarizing scene the polarized variant's image is cuda_rgb's
    bit for bit, and the full Mueller chain's (MI_NO_DEPOL_FASTPATH=1)
    within 1e-6 of it."""
    variant("rgb")
    rgb = mt.render(mt.load_dict(_fastpath_scene(DIFF, ttf)), seed=2,
                    spp=8).numpy()
    variant("rgb_polarized")
    fast = mt.render(mt.load_dict(_fastpath_scene(DIFF, ttf)), seed=2,
                     spp=8).numpy()
    monkeypatch.setenv("MI_NO_DEPOL_FASTPATH", "1")
    full = mt.render(mt.load_dict(_fastpath_scene(DIFF, ttf)), seed=2,
                     spp=8).numpy()
    assert np.array_equal(fast, rgb)
    assert np.abs(fast - full).max() < 1e-6
    assert float(np.abs(rgb).max()) > 0.01


def test_fast_path_switch_changes_the_pass(variant, monkeypatch):
    """Flipping MI_NO_DEPOL_FASTPATH between two renders of one scene
    object changes the path its pass function takes (the decision is
    taken per render, not cached with the pass)."""
    variant("rgb_polarized")
    calls = []
    orig = tpol.path_loop_polarized

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(tpol, "path_loop_polarized", spy)
    scene = mt.load_dict(_fastpath_scene(DIFF, ttf))
    scene.integrator.render(scene, seed=0, spp=2)
    assert calls == []
    monkeypatch.setenv("MI_NO_DEPOL_FASTPATH", "1")
    scene.integrator.render(scene, seed=0, spp=2)
    assert len(calls) == 1
    monkeypatch.delenv("MI_NO_DEPOL_FASTPATH")
    scene.integrator.render(scene, seed=0, spp=2)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# renders against the JAX package's eager renders
# ---------------------------------------------------------------------------

def _canonical_xml(integrator=None, stokes=True):
    # max_depth 3: at 2 the Doppler signal of the static walls cancels
    # between the antithetic time pairs, down to float noise
    return ps.polarizing_canonical_xml(stokes=stokes, integrator=integrator,
                                       max_depth=3)


PTRACER = ('<integrator type="ptracer"><integer name="max_depth" value="2"/>'
           '</integrator>')


def _render_cases(pbsdf_path):
    """name -> (variant, loader(package)), each loader building the
    scene its package renders."""
    def plates(pkg):
        return pkg.load_dict(_plates_dict(jtf if pkg is mj else ttf))

    def canonical(integrator=None, stokes=True):
        xml = _canonical_xml(integrator, stokes)
        return lambda pkg: pkg.load_string(xml, spp=SPP, resx=RES, resy=RES)

    def rayleigh(pkg):
        return pkg.load_dict(ps.rayleigh_cube_scene(
            SPP, RES, jtf if pkg is mj else ttf, max_depth=2))

    def measured(pkg):
        return pkg.load_dict(md.measured_polarized_sphere_dict(
            pbsdf_path, None, SPP, RES, jtf if pkg is mj else ttf,
            {"type": "stokes", "nested": {"type": "path",
                                          "max_depth": 2}}))
    return {"plates": ("rgb_polarized", plates),
            "canonical": ("rgb_polarized", canonical()),
            "ptracer": ("rgb_polarized", canonical(PTRACER, False)),
            "rayleigh_volpath_spectral": ("spectral_polarized", rayleigh),
            "measured_polarized": ("rgb_polarized", measured)}


@pytest.fixture(scope="module")
def renders(pbsdf):
    """name -> (port image, JAX image), each JAX render made once, eagerly,
    on first use."""
    cases = _render_cases(pbsdf)
    done = {}

    def get(name):
        if name not in done:
            var, load = cases[name]
            try:
                _set_both(var)
                with jax_op_by_op():
                    ref = np.asarray(mj.render(load(mj), spp=SPP, seed=0))
                img = mt.render(load(mt), spp=SPP, seed=0).numpy()
            finally:
                _set_both("rgb")
            done[name] = (img, ref)
        return done[name]
    return get


def _match(img, ref, label):
    """PERF.md section 2's tolerance on every value."""
    assert img.shape == ref.shape, (label, img.shape, ref.shape)
    assert np.isfinite(img).all(), label
    scale = float(np.abs(ref).max())
    assert scale > 0.0, label
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=label)


@pytest.mark.parametrize("name", ["plates", "canonical", "ptracer",
                                  "rayleigh_volpath_spectral",
                                  "measured_polarized"])
def test_render_matches_jax(renders, name):
    img, ref = renders(name)
    _match(img, ref, name)
    if not name.startswith("ptracer"):
        assert img.shape[-1] == 15           # rgb + S0..S3 x RGB
        # polarized light reaches the film
        assert float(np.abs(img[..., 6:12]).max()) > 1e-3 * float(
            np.abs(img[..., 3:6]).max())


# ---------------------------------------------------------------------------
# the port alone: physics and the plugins' surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t2,expect", [(0.0, 0.5), (45.0, 0.25),
                                       (90.0, 0.0)])
def test_render_malus_law(variant, t2, expect):
    """Two ideal polarizers: S0 = 0.5 cos^2 of their angle."""
    variant("rgb_polarized")
    sc = mt.load_dict(ps.plate_scene(
        [({"type": "polarizer", "theta": 0.0}, 2.0),
         ({"type": "polarizer", "theta": t2}, 1.0)], spp=16))
    img = mt.render(sc, spp=16, seed=0).numpy()
    assert abs(img[..., :3].mean() - expect) < 1e-3


def test_render_circular_from_quarter_wave_plate(variant):
    """A horizontal polarizer, then a quarter-wave retarder at 45 degrees:
    circular light (|S3| = S0), no circular part behind the polarizer
    alone (its degree of polarization 1)."""
    variant("rgb_polarized")
    S = ps.stokes_channels(mt.render(mt.load_dict(ps.plate_scene(
        ps.QUARTER_WAVE, spp=16)), spp=16, seed=0).numpy())
    assert np.all(np.abs(S[3]) / np.maximum(S[0], 1e-9) > 0.99)
    S = ps.stokes_channels(mt.render(mt.load_dict(ps.plate_scene(
        ps.QUARTER_WAVE[:1], spp=16)), spp=16, seed=0).numpy())
    dop = np.sqrt(S[1] ** 2 + S[2] ** 2 + S[3] ** 2) / np.maximum(S[0], 1e-9)
    assert np.all(np.abs(dop - 1.0) < 1e-4) and np.all(np.abs(S[3]) < 1e-4)


def test_stokes_requires_polarized_variant(variant):
    variant("rgb")
    sc = mt.load_dict(ps.plate_scene(ps.QUARTER_WAVE[:1], spp=4))
    with pytest.raises(RuntimeError, match="polarized"):
        sc.integrator.render(sc, seed=0, spp=4)
    with pytest.raises(RuntimeError, match="does not support Stokes"):
        mt.load_dict({"type": "stokes", "nested": {"type": "direct"}})


def test_plugins_load_from_dict_and_xml(variant, pbsdf):
    """The five plugins from a dict and from XML; their classes and
    parameters."""
    variant("spectral_polarized")
    assert mt.variant() == "cuda_spectral_polarized"
    xml = f"""<scene version="3.0.0">
      <integrator type="stokes"><integrator type="volpath"/></integrator>
      <sensor type="perspective"/>
      <shape type="rectangle"><bsdf type="polarizer">
        <float name="theta" value="30"/></bsdf></shape>
      <shape type="rectangle"><bsdf type="retarder">
        <float name="delta" value="45"/></bsdf></shape>
      <shape type="rectangle"><bsdf type="circular"/></shape>
      <shape type="sphere"><bsdf type="measured_polarized">
        <string name="filename" value="{pbsdf}"/>
        <float name="alpha_sample" value="0.3"/></bsdf></shape>
    </scene>"""
    sc = mt.load_string(xml)
    assert type(sc.integrator).__name__ == "StokesIntegrator"
    assert type(sc.integrator.nested).__name__ == "VolPathIntegrator"
    kinds = [type(s.bsdf).__name__ for s in sc.shapes]
    assert kinds == ["Polarizer", "Retarder", "CircularPolarizer",
                     "MeasuredPolarized"]
    assert abs(sc.shapes[0].bsdf.theta - np.pi / 6) < 1e-7
    assert abs(sc.shapes[1].bsdf.delta - np.pi / 4) < 1e-7
    sa = sc.compile()
    assert sa.polarized and sa.spectral
    assert sa.bsdf_types_present == (12, 13, 14, 16)
    assert sa.measured_pol_wls == (tmp.RGB_WAVELENGTHS,)
    for kind in ("stokes", "polarizer", "retarder", "circular",
                 "measured_polarized"):
        d = {"type": kind}
        if kind == "stokes":
            d["nested"] = {"type": "path"}
        if kind == "measured_polarized":
            d["filename"] = pbsdf
        assert mt.load_dict(d) is not None
    assert os.path.exists(pbsdf)
