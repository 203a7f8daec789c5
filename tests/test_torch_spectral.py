"""The spectral and mono variants in the PyTorch port against the JAX
package on the CPU.

Modules: the CIE colour matching functions, D65, the RGB <-> XYZ
matrices, the reflectance and emission spectra and ``hero_to_srgb`` on
4,096 seeded wavelengths; the per-colour and the batched reflectance fits
(compared as sigmoid spectra on a 64-point grid: the coefficients can
differ along flat directions of the fit); the 4^3 coefficient lattice; the
lattice lookup of ``upsample_rgb_array``; the six spectrum plugins in the
rgb and spectral variants; the variant switch and the refusals.

Renders at 16x16 x 16 spp, seed 0, each against the JAX package's eager
render (``jax.disable_jit()``: its jit contracts multiply-adds the port's
eager ops do not), at PERF.md section 2's tolerance (every value within
rtol 1e-4, atol 1e-4 * max|ref|): the canonical scene's dopplertofpath in
spectral (through ``moment``), and its path (max_depth 2) in mono; the
spectral surface scene
(``utils/spectral_scenes.py``: a bitmap-textured floor, a gold conductor
with its eta / k spectra, roughplastic and plastic spheres, a 16x8 envmap
sky, a medium cube) with ``volpath`` (max_depth 2) into a ``specfilm`` of
three ``regular`` SRFs, and its floor's bitmap at seeded uvs (volpath
reads no texture, as the JAX package's does not); the canonical
scene's ``aov`` over ``direct`` and ``ptracer`` (max_depth 2) in
spectral. Depths are cut where the JAX package's eager render is the
cost; every path still scatters at least once. Both packages upsample bitmap texels with the
same 4^3 lattice, fitted once by the JAX package and given to the port
(``set_coeff_lattice``), so no test fits the 32^3 lattice. Every test that
sets a variant restores rgb in its fixture's teardown."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu.core import cie as jcie
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.core.vec import Vec3 as JVec3

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch import media as tmedia
from mitsuba3dopplertof_tpu_torch.core import cie as tcie
from mitsuba3dopplertof_tpu_torch.core import logger as tlog
from mitsuba3dopplertof_tpu_torch.core import transform as ttf
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3dopplertof_tpu_torch.utils import spectral_scenes as ss
from mitsuba3dopplertof_tpu_torch.utils import textured_scenes as ts

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(ROOT, "scenes", "canonical", "scene.xml")
RES, SPP = 16, 16
N = 4096
# float32 functions of the CMFs: XLA's and PyTorch's exp differ in the
# last bit, and hero_to_srgb sums three products of them
FN_TOL = dict(rtol=2e-6, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


@pytest.fixture(scope="module")
def lattice():
    """The JAX package's 4^3 coefficient lattice, used by both packages'
    texel upsampling for this module (the JAX package's through its own
    ``coeff_lattice``, the port's through ``set_coeff_lattice``)."""
    lat = np.asarray(jcie.coeff_lattice(n=4))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcie, "coeff_lattice", lambda n=32: lat)
        tcie.set_coeff_lattice(lat)
        try:
            yield lat
        finally:
            tcie.set_coeff_lattice(None)


@pytest.fixture
def variant():
    """Sets both packages' variant ("rgb", "spectral", "mono") for one
    test; rgb again afterwards, whatever happened."""
    def set_both(name):
        mj.set_variant("tpu_" + name)
        return mt.set_variant("cuda_" + name)
    yield set_both
    mj.set_variant("tpu_rgb")
    mt.set_variant("cuda_rgb")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return ss.write_spectral_assets(str(tmp_path_factory.mktemp("spectral")))


def _close(ours, theirs, label, **tol):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), err_msg=label,
                               **(tol or FN_TOL))


def _match(img, ref, label):
    """PERF.md section 2's tolerance on every value."""
    assert img.shape == ref.shape, (label, img.shape, ref.shape)
    assert np.isfinite(img).all(), label
    scale = float(np.abs(ref).max())
    assert scale > 0.0, label
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=label)


def _jax(load, integrator=None):
    with jax.disable_jit():
        kw = {} if integrator is None else {
            "integrator": mj.load_dict(integrator)}
        return np.asarray(mj.render(load(), spp=SPP, seed=0, **kw))


def _port(load, integrator=None):
    kw = {} if integrator is None else {
        "integrator": mt.load_dict(integrator)}
    return mt.render(load(), spp=SPP, seed=0, **kw).numpy()


def _canonical(pkg):
    if pkg is mj:
        return lambda: mj.load_file(CANONICAL, spp=SPP, resx=RES, resy=RES)
    return lambda: mt.load_file(CANONICAL, device="cpu", spp=SPP, resx=RES,
                                resy=RES)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_cie_functions_match_jax():
    """The CMFs, D65 and the emission spectra on 4,096 seeded wavelengths
    (tolerance FN_TOL), the reflectance spectra and the hero wavelengths
    bit for bit, hero_to_srgb (rtol 1e-5, atol 2e-6 of the largest
    value), and the host constants: the matrices, the y and D65-y
    integrals, the fit tables (rtol 1e-7)."""
    rng = np.random.default_rng(3)
    lam = rng.uniform(tcie.LAMBDA_MIN, tcie.LAMBDA_MAX, N).astype(np.float32)
    lj, lt = jnp.asarray(lam), torch.from_numpy(lam)
    for name in ("cie_xbar", "cie_ybar", "cie_zbar", "d65_spd"):
        _close(getattr(tcie, name)(lt), getattr(jcie, name)(lj), name)
    c = rng.uniform(-4.0, 4.0, (3, N)).astype(np.float32)
    scale = rng.uniform(0.5, 20.0, N).astype(np.float32)
    cj = [jnp.asarray(v) for v in c]
    ct = [torch.from_numpy(v) for v in c]
    refl_t = tcie.eval_reflectance_spectrum(*ct, lt)
    refl_j = jcie.eval_reflectance_spectrum(*cj, lj)
    np.testing.assert_array_equal(refl_t.numpy(), np.asarray(refl_j))
    inv = 1.0 / tcie.d65_y_norm()
    _close(tcie.eval_emission_spectrum(*ct, torch.from_numpy(scale), lt,
                                       inv),
           jcie.eval_emission_spectrum(*cj, jnp.asarray(scale), lj,
                                       1.0 / jcie.d65_y_norm()), "emission")
    u = rng.random(N).astype(np.float32)
    spec = rng.uniform(0.0, 3.0, (3, N)).astype(np.float32)
    w_t = tcie.hero_wavelengths(torch.from_numpy(u))
    with jax.disable_jit():
        w_j = JVec3(*(jcie.LAMBDA_MIN + (v - jnp.floor(v))
                      * jcie.LAMBDA_RANGE
                      for v in (jnp.asarray(u) + k * (1.0 / 3.0)
                                for k in range(3))))
        rgb_j = jcie.hero_to_srgb(JVec3(*(jnp.asarray(s) for s in spec)),
                                  w_j)
    for a, b in zip(w_t, w_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rgb_t = tcie.hero_to_srgb(TVec3(*(torch.from_numpy(s) for s in spec)),
                              w_t)
    # the XYZ -> sRGB rows cancel terms of up to ~10^3: absolute
    # tolerance on the scale of the largest value
    scale = max(float(np.abs(np.asarray(b)).max()) for b in rgb_j)
    for a, b, ch in zip(rgb_t, rgb_j, "rgb"):
        _close(a, b, f"hero_to_srgb {ch}", rtol=1e-5, atol=2e-6 * scale)
    for ours, theirs in ((tcie._matrices(), jcie._matrices()),
                         (tcie._fit_tables(), jcie._fit_tables()),
                         (tcie.y_integral(), jcie.y_integral()),
                         (tcie.d65_y_norm(), jcie.d65_y_norm())):
        # integrals of float32 CMF samples an ulp apart here and there
        np.testing.assert_allclose(ours, theirs, rtol=1e-7, atol=1e-9)


def _spectra_64(coeffs):
    lam = np.linspace(tcie.LAMBDA_MIN, tcie.LAMBDA_MAX, 64)
    return np.stack([tcie._spectrum_np(c, lam) for c in
                     np.asarray(coeffs, np.float64)])


def test_reflectance_fits_match_jax():
    """The batched fit (torch float64 in the port, numpy in the JAX
    package) on 64 seeded colours and the per-colour fit on 8: their
    sigmoid spectra on a 64-point grid agree to 1e-4 (the batched fit's
    reductions run in another order, which can tip an accept / reject
    step), and each spectrum reproduces its colour to 1e-3."""
    rng = np.random.default_rng(5)
    rgbs = rng.uniform(0.02, 0.98, (64, 3))
    ours = tcie.fit_reflectance_coeffs_batch(rgbs)
    theirs = jcie.fit_reflectance_coeffs_batch(rgbs)
    assert ours.shape == (64, 3) and ours.dtype == np.float32
    np.testing.assert_allclose(_spectra_64(ours), _spectra_64(theirs),
                               atol=1e-4)
    back = np.stack([tcie.rgb_of_coeffs(c.astype(np.float64))
                     for c in ours])
    np.testing.assert_allclose(back, np.clip(rgbs, 1e-4, 0.9999), atol=1e-3)
    one_t = np.stack([tcie.fit_reflectance_coeffs(c) for c in rgbs[:8]])
    one_j = np.stack([jcie.fit_reflectance_coeffs(c) for c in rgbs[:8]])
    np.testing.assert_allclose(_spectra_64(one_t), _spectra_64(one_j),
                               atol=1e-4)


def test_lattice_and_upsampling_match_jax(lattice):
    """The 4^3 lattice fitted by the port (no cache) against the JAX
    package's, as spectra (1e-4), and the trilinear lookup of 500 seeded
    colours in the same lattice: equal bit for bit."""
    ours = tcie.fit_coeff_lattice(4)
    assert ours.shape == lattice.shape == (4, 4, 4, 3)
    np.testing.assert_allclose(_spectra_64(ours.reshape(-1, 3)),
                               _spectra_64(lattice.reshape(-1, 3)),
                               atol=1e-4)
    rgb = np.random.default_rng(9).random((500, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcie.upsample_rgb_array(rgb),
                                  jcie.upsample_rgb_array(rgb))
    np.testing.assert_array_equal(
        tcie.upsample_rgb_array(rgb, lattice=lattice),
        jcie.upsample_rgb_array(rgb))


SPECTRA = {
    "uniform": {"type": "uniform", "value": 0.4},
    "d65": {"type": "d65", "scale": 2.0},
    "srgb": {"type": "srgb", "color": [0.2, 0.5, 0.7]},
    "blackbody": {"type": "blackbody", "temperature": 3200.0},
    "regular": {"type": "regular", "lambda_min": 400.0, "lambda_max": 700.0,
                "values": "0.1, 0.4, 0.9, 0.3"},
    "irregular": {"type": "irregular", "wavelengths": "420, 500, 640",
                  "values": "0.8, 0.2, 0.5"},
}


def _spectrum_scene(spec, tf):
    """A diffuse rectangle whose reflectance is ``spec`` under an area
    light whose radiance is ``spec`` (times 5)."""
    return {"type": "scene",
            "wall": {"type": "rectangle",
                     "bsdf": {"type": "diffuse", "reflectance": dict(spec)}},
            "lamp": {"type": "rectangle",
                     "to_world": tf.translate([0, 0, 2])
                     @ tf.rotate([1, 0, 0], 180),
                     "emitter": {"type": "area", "radiance": dict(spec)}},
            "sensor": {"type": "perspective",
                       "to_world": tf.look_at([0, 0, 3], [0, 0, 0],
                                              [0, 1, 0]),
                       "film": {"type": "hdrfilm", "width": 4,
                                "height": 4}}}


@pytest.mark.parametrize("kind", sorted(SPECTRA))
def test_spectra_match_jax(kind, variant, lattice):
    """Each spectrum plugin: its rgb and SRF table equal the JAX
    package's, and a scene whose reflectance and radiance it gives
    compiles to the same BSDF and emitter rows in rgb and in spectral:
    the sigmoid coefficients as spectra on a 64-point grid (to 1e-4: a
    near-white colour's fit has flat directions), every other column to
    rtol 1e-6."""
    ours = mt.load_dict(SPECTRA[kind])
    theirs = mj.load_dict(SPECTRA[kind])
    np.testing.assert_array_equal(ours.mean_rgb(), theirs.mean_rgb())
    if hasattr(theirs, "srf_table"):
        for a, b in zip(ours.srf_table(), theirs.srf_table()):
            np.testing.assert_array_equal(a, b)
    for name in ("rgb", "spectral"):
        variant(name)
        sa_t = mt.load_dict(_spectrum_scene(SPECTRA[kind], ttf),
                            device="cpu").compile()
        sa_j = mj.load_dict(_spectrum_scene(SPECTRA[kind], jtf)).compile()
        assert sa_t.spectral == sa_j.spectral == (name == "spectral")
        for k, coeff in (("bsdf_params", slice(0, 3)),
                         ("emitter_params", slice(12, 15))):
            a = getattr(sa_t, k).numpy()
            b = np.asarray(getattr(sa_j, k))
            assert a.shape == b.shape
            if name == "spectral":
                np.testing.assert_allclose(_spectra_64(a[coeff].T),
                                           _spectra_64(b[coeff].T),
                                           atol=1e-4)
                a, b = np.delete(a, coeff, 0), np.delete(b, coeff, 0)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{kind} {name} {k}")


def test_variants_and_refusals(variant):
    assert mt.variants() == ["cuda_rgb", "cuda_spectral", "cuda_mono",
                             "cuda_rgb_polarized", "cuda_spectral_polarized"]
    for name in ("spectral", "mono", "rgb_polarized", "spectral_polarized",
                 "rgb"):
        assert variant(name) == mt.variant() == f"cuda_{name}"
    assert mt.variant() == "cuda_rgb"
    for kind in ("polarizer", "retarder", "circular"):
        assert mt.load_dict({"type": kind}).type_id in (12, 13, 14)
    for kind in ("prb_basic", "prb"):
        with pytest.raises(NotImplementedError, match="item 12"):
            mt.load_dict({"type": kind})
    film = mt.load_dict(ss.specfilm_film(8))
    assert film.srf_names == ["srf_0", "srf_1", "srf_2"]
    assert (film.channel_count, film.weight_index) == (4, 3)


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def test_canonical_spectral_matches_jax(variant):
    """dopplertofpath with hero-wavelength transport, through moment: the
    sRGB channels and the second moments of the hero samples."""
    variant("spectral")

    def load(pkg):
        def f():
            sc = _canonical(pkg)()
            sc.integrator = (mj if pkg is mj else mt).load_dict(
                {"type": "moment", "nested": sc.integrator})
            return sc
        return f
    ref = _jax(load(mj))
    img = _port(load(mt))
    assert img.shape == (RES, RES, 6)
    _match(img, ref, "canonical spectral moment")


def test_canonical_mono_matches_jax(variant):
    """path (max_depth 2) on the canonical scene compiled in mono."""
    variant("mono")
    integ = {"type": "path", "max_depth": 2}
    ref = _jax(_canonical(mj), integ)
    img = _port(_canonical(mt), integ)
    _match(img, ref, "canonical mono")
    assert np.array_equal(img[..., 0], img[..., 1])
    assert np.array_equal(img[..., 0], img[..., 2])


def _surface(pkg, assets, integrator=None, film=None):
    tf = jtf if pkg is mj else ttf

    def load():
        d = ss.spectral_surface_scene(assets, SPP, RES, tf, integrator)
        if film is not None:
            d["sensor"]["film"] = film
        return (mj.load_dict(d) if pkg is mj
                else mt.load_dict(d, device="cpu"))
    return load


def test_surface_specfilm_matches_jax(variant, lattice, assets):
    """volpath (max_depth 2) into a specfilm of three SRFs: the gold
    conductor's eta / k, the plastics' and the lights' spectra, the
    sky's per-texel spectra, the medium cube's sigma_t and albedo
    spectra (volpath, as the JAX package's, reads no texture: the floor's
    texels are held by test_bitmap_texels_match_jax)."""
    variant("spectral")
    film = ss.specfilm_film(RES)
    integ = {"type": "volpath", "max_depth": 2}
    ref = _jax(_surface(mj, assets, integrator=integ, film=film))
    sa = _surface(mt, assets, integrator=integ, film=film)().compile()
    assert sa.spectral and sa.ior_spectra and sa.env_kind == "envmap"
    assert sa.env_coeff.shape == (4, 16 * 8)
    assert sa.tex_atlas_c0.shape[0] == 32 * 32
    img = _port(_surface(mt, assets, integrator=integ, film=film))
    _match(img, ref, "surface volpath specfilm")


def test_bitmap_texels_match_jax(variant, lattice, assets):
    """The floor's bitmap at 4,096 seeded uvs and hero wavelengths: each
    texel's upsampled spectrum, bilinear over four texels."""
    from mitsuba3dopplertof_tpu.textures import eval_texture as jeval
    from mitsuba3dopplertof_tpu_torch.textures import eval_texture as teval
    variant("spectral")
    sa_t = _surface(mt, assets)().compile()
    sa_j = _surface(mj, assets)().compile()
    rng = np.random.default_rng(13)
    uv = rng.uniform(-0.2, 1.2, (2, N)).astype(np.float32)
    lam = rng.uniform(tcie.LAMBDA_MIN, tcie.LAMBDA_MAX, (3, N)).astype(
        np.float32)
    with jax.disable_jit():
        theirs = jeval(sa_j, jnp.zeros(N, jnp.int32), *map(jnp.asarray, uv),
                       wavelengths=JVec3(*map(jnp.asarray, lam)))
    ours = teval(sa_t, torch.zeros(N, dtype=torch.int32),
                 *map(torch.from_numpy, uv),
                 wavelengths=TVec3(*map(torch.from_numpy, lam)))
    for a, b, c in zip(ours, theirs, "xyz"):
        _close(a, b, f"texel spectrum {c}", rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("integ", [
    {"type": "aov", "aovs": "dd:depth,nn:sh_normal,aa:albedo",
     "nested": {"type": "direct"}},
    {"type": "ptracer", "max_depth": 2}], ids=["aov_direct", "ptracer"])
def test_canonical_integrators_spectral_match_jax(variant, integ):
    variant("spectral")
    ref = _jax(_canonical(mj), integ)
    img = _port(_canonical(mt), integ)
    _match(img, ref, integ["type"])


# ---------------------------------------------------------------------------
# the SGGX check at compile
# ---------------------------------------------------------------------------

def test_sggx_not_positive_definite_warns(tmp_path):
    """The media scene's S grid with an off-diagonal Sxy up to 0.3 (above
    sqrt(0.02) on its right half: 32 of its 128 texels) warns, naming the
    medium and the count; the scene as written (Sxy up to 0.1) does not.
    The warning repairs nothing: the compiled S grid is the file's."""
    msgs = []
    tlog.add_appender(lambda level, msg: msgs.append((level, msg)))
    try:
        for sxy in (0.1, 0.3):
            vol = str(tmp_path / f"sggx_{sxy}.vol")
            ts.write_sggx_vol(vol, sxy_max=sxy)
            sc = mt.load_dict(ts.media_scene(vol, 4, 4, ttf), device="cpu")
            n_before = len(msgs)
            sa = sc.compile()
            new = [m for lv, m in msgs[n_before:] if lv >= tlog.WARN]
            if sxy == 0.1:
                assert new == []
            else:
                assert len(new) == 1, new
                assert "medium 'interior'" in new[0]
                assert "32 of 128 texels" in new[0]
            grid = next(m.phase.S_grid for m in
                        (sh.interior_medium for sh in sc.shapes)
                        if getattr(m, "phase", None) is not None
                        and getattr(m.phase, "S_grid", None) is not None)
            np.testing.assert_array_equal(
                sa.sggx_grid.numpy(), grid.data[..., :6].reshape(-1, 6))
    finally:
        tlog._appenders.pop()
    S = np.array([[1.0, 0.02, 1.0, 0.3, 0.0, 0.0],
                  [1.0, 0.02, 1.0, 0.1, 0.0, 0.0]])
    assert tmedia.sggx_not_pd(S).tolist() == [True, False]
