"""The measured BSDF in the PyTorch port against the JAX package on the
CPU, on the synthetic GGX-copper RGL file that the port writes
(``utils/measured_data.py``, the port's copy of the JAX package's
synthesis in tests/test_measured.py): the tensor file read and written by
both packages; the histogram tables of ``build_tables`` bit for bit; the
luminance and VNDF warps (``warp_sample`` / ``warp_invert``) and the
eval / pdf of ``_fr_common`` and the sampling record of
``measured_eval_pdf_sample`` on 4,096 seeded lanes (rtol 1e-4, atol
1e-6, but for at most 0.5% of the lanes, each within 1%: a direction on a
histogram cell's edge moves one cell when asin, atan2 or sqrt differ in
the last bit; sampled directions to atol 2e-4); and a sphere of it over the
benchmark floor under a point light (path, max_depth 2: the BSDF's value
toward the light at the first hit, its sampled bounce), 16x16 x 16 spp,
in the rgb variant
(three representative wavelengths) and the spectral one (hero
wavelengths), each against the JAX package's eager render at PERF.md
section 2's tolerance (rtol 1e-4, atol 1e-4 * max|ref|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu.bsdfs import measured_impl as jmi
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.core.vec import Vec3 as JVec3
from mitsuba3dopplertof_tpu.io import tensor_file as jtfile

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.bsdfs import measured_impl as tmi
from mitsuba3dopplertof_tpu_torch.core import transform as ttf
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3dopplertof_tpu_torch.io import tensor_file as ttfile
from mitsuba3dopplertof_tpu_torch.utils import measured_data as md

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 4096
TOL = dict(rtol=1e-4, atol=1e-6)
RES, SPP = 16, 16


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


@pytest.fixture(scope="module")
def bsdf_file(tmp_path_factory):
    return md.write_ggx_copper_bsdf(
        str(tmp_path_factory.mktemp("rgl") / "ggx_cu.bsdf"))


@pytest.fixture(scope="module")
def tables(bsdf_file):
    """(port tables, JAX tables) from the file."""
    return (tmi.build_tables(ttfile.read_tensor_file(bsdf_file)),
            jmi.build_tables(jtfile.read_tensor_file(bsdf_file)))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, theirs, label, outliers=0, atol=TOL["atol"]):
    """Within TOL but for at most ``outliers`` lanes, and those within 1%:
    a direction on a histogram cell's edge can land in the next cell when
    asin / atan2 / sqrt differ in the last bit (XLA's against PyTorch's)."""
    a, b = _np(ours), _np(theirs)
    bad = ~np.isclose(a, b, rtol=TOL["rtol"], atol=atol)
    assert bad.sum() <= outliers, (label, int(bad.sum()),
                                   np.abs(a - b)[bad].max())
    np.testing.assert_allclose(a[bad], b[bad], rtol=1e-2, err_msg=label)


def _dirs(rng, n, below=0.1):
    """Unit directions, a share ``below`` of them under the surface."""
    v = rng.standard_normal((n, 3))
    v[:, 2] = np.abs(v[:, 2]) * np.where(rng.random(n) < below, -1, 1)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                   for i in range(3)))


def test_tensor_file_both_ways(bsdf_file, tmp_path):
    """The port reads what it wrote, the JAX package reads it too, and
    the port reads what the JAX package writes: every field equal."""
    ours = ttfile.read_tensor_file(bsdf_file)
    theirs = jtfile.read_tensor_file(bsdf_file)
    fields = md.ggx_copper_fields()
    assert set(ours) == set(theirs) == set(fields)
    for k, v in fields.items():
        for got in (ours[k], theirs[k]):
            assert got.dtype == v.dtype and got.shape == v.shape, k
            np.testing.assert_array_equal(got, v, err_msg=k)
    other = str(tmp_path / "jax.bsdf")
    jtfile.write_tensor_file(other, fields)
    back = ttfile.read_tensor_file(other)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with open(other, "rb") as f, open(bsdf_file, "rb") as g:
        assert f.read() == g.read()


def test_build_tables_match_jax(tables):
    ours, theirs = tables
    assert (ours.isotropic, ours.jacobian) == (theirs.isotropic,
                                               theirs.jacobian) == (True,
                                                                    True)
    for k in ("phi_i", "theta_i", "wavelengths", "ndf", "sigma",
              "spectra"):
        np.testing.assert_array_equal(_np(getattr(ours, k)),
                                      _np(getattr(theirs, k)), err_msg=k)
    for w in ("vndf", "luminance"):
        a, b = getattr(ours, w), getattr(theirs, w)
        assert (a.ry, a.rx) == (b.ry, b.rx)
        for k in ("cw", "cond_cdf", "marg_cdf", "total"):
            np.testing.assert_array_equal(_np(getattr(a, k)),
                                          _np(getattr(b, k)),
                                          err_msg=f"{w}.{k}")


@pytest.mark.parametrize("warp", ["vndf", "luminance"])
def test_warps_match_jax(tables, warp):
    """Corner ids and weights at seeded incident elevations, then
    warp_sample of seeded uniforms and warp_invert of its output."""
    ours, theirs = tables
    rng = np.random.default_rng({"vndf": 1, "luminance": 2}[warp])
    theta = rng.uniform(0.0, 1.5, N).astype(np.float32)
    u = rng.random((2, N)).astype(np.float32)
    ids_t, wts_t = tmi._corner_ids(ours, torch.zeros(N),
                                   torch.from_numpy(theta))
    ids_j, wts_j = jmi._corner_ids(theirs, jnp.zeros(N), jnp.asarray(theta))
    for a, b in zip(ids_t, ids_j):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(wts_t, wts_j):
        np.testing.assert_array_equal(_np(a), _np(b))
    out_t = tmi.warp_sample(getattr(ours, warp), ids_t, wts_t,
                            *(torch.from_numpy(v) for v in u))
    out_j = jmi.warp_sample(getattr(theirs, warp), ids_j, wts_j,
                            *(jnp.asarray(v) for v in u))
    for a, b, k in zip(out_t, out_j, ("x", "y", "density")):
        _close(a, b, f"sample {k}")
    inv_t = tmi.warp_invert(getattr(ours, warp), ids_t, wts_t, *out_t[:2])
    inv_j = jmi.warp_invert(getattr(theirs, warp), ids_j, wts_j,
                            *out_j[:2])
    for a, b, k in zip(inv_t, inv_j, ("ux", "uy", "density")):
        _close(a, b, f"invert {k}")
    np.testing.assert_allclose(_np(inv_t[0]), u[0], atol=2e-3)


@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
def test_fr_and_sampling_match_jax(tables, spectral):
    """_fr_common (value, pdf, active) between seeded directions and the
    full dispatch record (NEE value and pdf, sampled direction, weight,
    pdf) of seeded samples, at the rgb variant's three wavelengths or
    seeded hero wavelengths."""
    ours, theirs = tables
    rng = np.random.default_rng(7 if spectral else 8)
    wi, wo = _dirs(rng, N), _dirs(rng, N)
    s = rng.random((2, N)).astype(np.float32)
    lam = rng.uniform(360.0, 830.0, (N, 3)).astype(np.float32)
    w_t = _tv(lam) if spectral else None
    w_j = _jv(lam) if spectral else None
    spec_t, pdf_t, act_t = tmi._fr_common(ours, _tv(wi), _tv(wo), w_t)
    spec_j, pdf_j, act_j = jmi._fr_common(theirs, _jv(wi), _jv(wo), w_j)
    np.testing.assert_array_equal(_np(act_t), _np(act_j))
    assert 0.5 < float(act_t.float().mean()) < 1.0
    for a, b, c in zip(spec_t, spec_j, "xyz"):
        _close(a, b, f"f cos {c}", outliers=N // 200)
    _close(pdf_t, pdf_j, "pdf", outliers=N // 200)
    rec_t = tmi.measured_eval_pdf_sample(
        ours, _tv(wi), _tv(wo), *(torch.from_numpy(v) for v in s), w_t)
    with jax.disable_jit():
        rec_j = jmi.measured_eval_pdf_sample(
            theirs, _jv(wi), _jv(wo), *(jnp.asarray(v) for v in s), w_j)
    for k in ("val_nee", "wo", "weight"):
        # the sampled direction's components to 2e-4: the inverse-CDF
        # steps divide an ulp of the blended CDFs by a row's mass
        for a, b, c in zip(getattr(rec_t, k), getattr(rec_j, k), "xyz"):
            _close(a, b, f"{k}.{c}", outliers=N // 200,
                   atol=2e-4 if k == "wo" else TOL["atol"])
    for k in ("pdf_nee", "pdf"):
        _close(getattr(rec_t, k), getattr(rec_j, k), k, outliers=N // 200)
    assert float((rec_t.pdf > 0).float().mean()) > 0.5


@pytest.fixture
def variant():
    def set_both(name):
        mj.set_variant("tpu_" + name)
        return mt.set_variant("cuda_" + name)
    yield set_both
    mj.set_variant("tpu_rgb")
    mt.set_variant("cuda_rgb")


@pytest.mark.parametrize("name", ["rgb", "spectral"])
def test_measured_sphere_matches_jax(bsdf_file, variant, name):
    variant(name)
    integ = {"type": "path", "max_depth": 2}
    with jax.disable_jit():
        ref = np.asarray(mj.render(mj.load_dict(md.measured_sphere_dict(
            bsdf_file, None, SPP, RES, jtf, integ)), spp=SPP, seed=0))
    scene = mt.load_dict(md.measured_sphere_dict(bsdf_file, None, SPP, RES,
                                                 ttf, integ), device="cpu")
    sa = scene.compile()
    assert len(sa.measured) == 1 and sa.spectral == (name == "spectral")
    img = mt.render(scene, spp=SPP, seed=0).numpy()
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all()
    scale = float(np.abs(ref).max())
    assert scale > 0.0
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4 * scale)
