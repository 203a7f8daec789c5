"""The hero scene's plugins in the PyTorch port against the JAX package on
the CPU, function by function: EXR (NONE, ZIPS, ZIP and PIZ) and .vol I/O,
``eval_texture`` (checkerboard; bitmap with each filter and wrap mode),
the null, conductor, plastic and roughplastic BSDFs and a textured diffuse
under twosided, the envmap's eval, pdf and sampling, the HG phase, and
volpath's grid density. Inputs are made from a seed with numpy; values
agree within atol 1e-6, rtol 1e-5, and bit for bit where the work is
integer arithmetic or a gather."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu import bsdfs as jbsdfs
from mitsuba3dopplertof_tpu import emitters as jem
from mitsuba3dopplertof_tpu import media as jmedia
from mitsuba3dopplertof_tpu import textures as jtex
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.core.vec import Vec3 as JVec3
from mitsuba3dopplertof_tpu.integrators import volpath as jvol
from mitsuba3dopplertof_tpu.io import bitmap as jbm
from mitsuba3dopplertof_tpu.io import exr_piz as jpiz

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch import bsdfs as tbsdfs
from mitsuba3dopplertof_tpu_torch import emitters as tem
from mitsuba3dopplertof_tpu_torch import media as tmedia
from mitsuba3dopplertof_tpu_torch import textures as ttex
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3dopplertof_tpu_torch.integrators import volpath as tvol
from mitsuba3dopplertof_tpu_torch.io import bitmap as tbm
from mitsuba3dopplertof_tpu_torch.volumes import GridVolume
from mitsuba3dopplertof_tpu_torch.core.properties import Properties

from torch_port_helpers import (jax_mini_hero_scene, mini_hero_dict,
                                mini_hero_dir)
from torch_threads import shared_cores  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# PIZ-compressed EXRs written by OpenEXR (the JAX package's native shim):
# 48x40 rgb, HALF and FLOAT channels
PIZ_FILES = [os.path.join(ROOT, "tests", "data", f"piz_{k}_48x40.exr")
             for k in ("half", "float")]
TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_reads_through_openexr() -> bool:
    """The JAX package reads EXRs through OpenEXR where it can build its
    native shim; its own fallback codec reads no
    PIZ and misreads OpenEXR's ZIP (ROADMAP Queue C)."""
    return jbm._shim() is not None


def _jax_read_exr(path):
    """{channel: (H, W)} as the JAX package reads ``path``: through
    OpenEXR, or, without it, block by block with its ``exr_piz``."""
    if _jax_reads_through_openexr():
        return jbm.read_exr(path)
    import struct
    buf = open(path, "rb").read()
    off, channels, dw = 8, [], None
    while buf[off] != 0:
        name, off = jbm._read_null_str(buf, off)
        _, off = jbm._read_null_str(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        val = buf[off + 4:off + 4 + size]
        off += 4 + size
        if name == "channels":
            c = 0
            while val[c] != 0:
                cn, c = jbm._read_null_str(val, c)
                channels.append((cn, struct.unpack_from("<i", val, c)[0]))
                c += 16
        elif name == "dataWindow":
            dw = struct.unpack("<4i", val)
    off += 1
    W, H = dw[2] - dw[0] + 1, dw[3] - dw[1] + 1
    dt = {1: np.float16, 2: np.float32}
    out = {c: np.zeros((H, W), np.float32) for c, _ in channels}
    for boff in struct.unpack_from(f"<{-(-H // 32)}q", buf, off):
        y, size = struct.unpack_from("<ii", buf, boff)
        ny = min(32, dw[3] - y + 1)
        raw = jpiz.piz_uncompress(buf[boff + 8:boff + 8 + size], channels,
                                  W, ny)
        p = 0
        for ly in range(ny):
            for c, pt in channels:
                n = W * np.dtype(dt[pt]).itemsize
                out[c][y - dw[1] + ly] = np.frombuffer(raw[p:p + n], dt[pt])
                p += n
    return out


def _same_bits(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k


@pytest.mark.parametrize("path", PIZ_FILES, ids=["half", "float"])
def test_piz_exr_reads_bit_equal(path):
    """Both packages read the committed PIZ files to the same bits."""
    _same_bits(tbm.read_exr(path), _jax_read_exr(path))


@pytest.mark.parametrize("name", ["marble.exr", "sky.exr"])
def test_port_reads_jax_written_exr(name):
    """The hero's EXRs as the JAX package writes them (PIZ through its
    OpenEXR shim where that builds), read by the port bit for bit."""
    path = os.path.join(mini_hero_dir(), name)
    ref = jbm.read_exr(path)
    _same_bits(tbm.read_exr(path), ref)
    assert ref["R"].shape == ((128, 128) if name == "marble.exr"
                              else (64, 128))


@pytest.mark.parametrize("half", [True, False], ids=["half", "float"])
@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_port_written_exr_reads_back(tmp_path, compression, half):
    """The port writes EXRs OpenEXR reads: through OpenEXR the JAX package
    reads them bit for bit; the port reads them back to the written
    values, rounded to half where asked."""
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:37, 0:29] / 29.0
    img = np.stack([x, y, x * y], -1) * (1.0 + 0.01 * rng.standard_normal(
        (37, 29, 3)))
    img = img.astype(np.float32)
    path = str(tmp_path / f"w_{compression}.exr")
    tbm.write_exr(path, {"R": img[..., 0], "G": img[..., 1],
                         "B": img[..., 2]}, half=half,
                  compression=compression)
    got = tbm.read_exr_rgb(path)
    want = img.astype(np.float16).astype(np.float32) if half else img
    assert np.array_equal(got, want)
    if _jax_reads_through_openexr():
        assert np.array_equal(jbm.read_exr_rgb(path), want)


def test_vol_reads_bit_equal():
    """The smoke column's .vol grid, read by both packages."""
    path = os.path.join(mini_hero_dir(), "smoke.vol")
    props = Properties("gridvolume")
    props["filename"] = path
    ours = GridVolume(props).data
    theirs = mj.load_dict({"type": "gridvolume", "filename": path}).data
    assert ours.shape == theirs.shape == (24, 24, 24, 1)
    assert np.array_equal(ours.view(np.uint32), theirs.view(np.uint32))


# ---------------------------------------------------------------------------
# Device-side functions
# ---------------------------------------------------------------------------

def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i], jnp.float32) for i in range(3)))


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i],
                                                         np.float32))
                   for i in range(3)))


def _close(ours, theirs, label, exact=False):
    ours = (ours.numpy() if torch.is_tensor(ours) else np.asarray(ours))
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, label
    if exact or ours.dtype == bool or ours.dtype.kind in "iu":
        assert np.array_equal(ours, theirs), label
    else:
        np.testing.assert_allclose(ours, theirs, err_msg=label, **TOL)


def _close3(ours, theirs, label, exact=False):
    for c in "xyz":
        _close(getattr(ours, c), getattr(theirs, c), f"{label}.{c}", exact)


def _unit(rng, n):
    v = rng.standard_normal((n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _plugin_scene(tf, bsdfs):
    """A scene with one rectangle per BSDF, a camera and a point light."""
    d = {"type": "scene",
         "sensor": {"type": "perspective", "film": {"type": "hdrfilm",
                                                    "width": 4,
                                                    "height": 4}},
         "light": {"type": "point", "position": [0, 4, 0]}}
    for i, b in enumerate(bsdfs):
        d[f"r{i}"] = {"type": "rectangle", "bsdf": b,
                      "to_world": tf.translate([2.5 * i, 0, 0])}
    return d


def _texture_bsdfs():
    tex = [{"type": "checkerboard",
            "color0": {"type": "rgb", "value": [0.1, 0.2, 0.3]},
            "color1": {"type": "rgb", "value": [0.7, 0.6, 0.5]},
            "to_uv": jtf.translate([0.3, -0.2, 0]) @ jtf.scale([3, 5, 1])}]
    for filt in ("bilinear", "nearest"):
        for wrap in ("repeat", "mirror", "clamp"):
            tex.append({"type": "bitmap", "filename": PIZ_FILES[0],
                        "filter_type": filt, "wrap_mode": wrap,
                        "to_uv": jtf.scale([1.5, 1.25, 1])})
    return [{"type": "diffuse", "reflectance": t} for t in tex]


def test_eval_texture_matches_jax():
    """Checkerboard and bitmap textures (bilinear and nearest, repeat,
    mirror and clamp) at uv across several periods: the gathers exact,
    the bilinear blend within the tolerance."""
    bsdfs = _texture_bsdfs()
    sa_j = mj.load_dict(_plugin_scene(jtf, bsdfs)).compile()
    sa_t = mt.load_dict(_plugin_scene(jtf, bsdfs), device="cpu").compile()
    assert sa_t.tex_types_present == (0, 1) and sa_t.n_textures == 7
    rng = np.random.default_rng(11)
    n = 20000
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    tid = rng.integers(0, 7, n).astype(np.int32)
    out_j = jtex.eval_texture(sa_j, jnp.asarray(tid), jnp.asarray(uv[:, 0]),
                              jnp.asarray(uv[:, 1]))
    out_t = ttex.eval_texture(sa_t, torch.from_numpy(tid),
                              torch.from_numpy(uv[:, 0]),
                              torch.from_numpy(uv[:, 1]))
    # nearest bitmaps (ids 4-6) and the checkerboard (id 0) are gathers
    gather = (tid == 0) | (tid >= 4)
    for c in "xyz":
        a, b = getattr(out_t, c).numpy(), np.asarray(getattr(out_j, c))
        assert np.array_equal(a[gather], b[gather]), c
        np.testing.assert_allclose(a, b, err_msg=c, **TOL)


def _bsdf_inputs(n, n_rows, seed):
    rng = np.random.default_rng(seed)
    wi, wo = _unit(rng, n), _unit(rng, n)
    s = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    lane = rng.integers(0, n_rows, n).astype(np.int32)
    tex = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    mask = rng.uniform(0.0, 1.0, n) < 0.5
    return wi, wo, s, lane, tex, mask


def test_bsdfs_match_jax():
    """eval / pdf / sample of null, conductor (default and Au), plastic,
    roughplastic (two roughnesses) and a bitmap-textured diffuse under
    twosided, on every lane against every row, with a textured reflectance
    on half the lanes (the plastic and diffuse rows take it)."""
    bsdfs = [{"type": "null"}, {"type": "conductor"},
             {"type": "conductor", "material": "Au"},
             {"type": "plastic", "diffuse_reflectance": {
                 "type": "rgb", "value": [0.3, 0.5, 0.2]}},
             {"type": "roughplastic", "alpha": 0.08},
             {"type": "roughplastic", "alpha": 0.4, "int_ior": 1.7,
              "nonlinear": True},
             {"type": "twosided", "bsdf": {
                 "type": "diffuse", "reflectance": {
                     "type": "bitmap", "filename": PIZ_FILES[0]}}}]
    sa_j = mj.load_dict(_plugin_scene(jtf, bsdfs)).compile()
    sa_t = mt.load_dict(_plugin_scene(jtf, bsdfs), device="cpu").compile()
    assert np.array_equal(sa_t.bsdf_params.numpy(),
                          np.asarray(sa_j.bsdf_params))
    assert sa_t.bsdf_types_present == (0, 1, 2, 5, 6)
    wi, wo, s, lane, tex, mask = _bsdf_inputs(20000, len(bsdfs), 5)
    r_j = jbsdfs.eval_pdf_sample(
        sa_j, jnp.asarray(lane), _jv(wi), _jv(wo), jnp.asarray(s[:, 0]),
        jnp.asarray(s[:, 1]), jnp.asarray(s[:, 2]), _jv(tex),
        jnp.asarray(mask))
    r_t = tbsdfs.eval_pdf_sample(
        sa_t, torch.from_numpy(lane), _tv(wi), _tv(wo),
        torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1]),
        torch.from_numpy(s[:, 2]), _tv(tex), torch.from_numpy(mask))
    # everything but the sampled direction and its weight: every lane
    for f in ("val_nee", "pdf_nee", "pdf", "eta", "sampled_delta",
              "sampled_null"):
        a, b = getattr(r_t, f), getattr(r_j, f)
        if isinstance(a, TVec3):
            _close3(a, b, f)
        else:
            _close(a, b, f)
    # the sample: on lanes that took one (a rejected sample's direction is
    # not used). The GGX lobe amplifies the last bit of sin / cos (they
    # differ between XLA and PyTorch) by about 1 / alpha^2 at grazing
    # angles: 99.9% of those lanes within the tolerance, all within 1e-3.
    valid = np.asarray(r_j.pdf) > 0.0
    rough = np.isin(lane, (4, 5))
    for f in ("wo", "weight"):
        for c in "xyz":
            a = getattr(getattr(r_t, f), c).numpy()
            b = np.asarray(getattr(getattr(r_j, f), c))
            ok = np.isclose(a, b, **TOL)
            assert ok[valid & ~rough].all(), (f, c)
            assert ok[valid & rough].mean() >= 0.999, (f, c)
            np.testing.assert_allclose(a[valid], b[valid], rtol=1e-3,
                                       atol=1e-6, err_msg=f"{f}.{c}")
    # the null rows pass straight through with weight 1
    null = lane == 0
    assert np.array_equal(r_t.wo.x.numpy()[null], -wi[null, 0])
    assert r_t.sampled_null.numpy()[null].all()


def test_envmap_matches_jax():
    """The mini hero's sky: eval in random directions (a gather: exact),
    the pdf of those directions, and NEE sampling, alone and through the
    emitter dispatch (the area lamp and the envmap, chosen by s_x)."""
    sa_j = jax_mini_hero_scene()
    sa_t = mt.load_dict(mini_hero_dict(True, "dopplertofpath"),
                        device="cpu").compile()
    assert sa_t.env_kind == "envmap" and sa_t.env_shape == (64, 128)
    rng = np.random.default_rng(3)
    n = 20000
    d = _unit(rng, n)
    p = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    s = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    _close3(tem.envmap_eval(sa_t, _tv(d)), jem.envmap_eval(sa_j, _jv(d)),
            "eval", exact=True)
    _close(tem.envmap_pdf_direction(sa_t, _tv(d)),
           jem.envmap_pdf_direction(sa_j, _jv(d)), "pdf")
    sx, sy = torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1])
    jx, jy = jnp.asarray(s[:, 0]), jnp.asarray(s[:, 1])
    for label, (ds_t, w_t), (ds_j, w_j) in (
            ("envmap", tem.envmap_sample_direction(sa_t, _tv(p), sx, sy),
             jem.envmap_sample_direction(sa_j, _jv(p), jx, jy)),
            ("dispatch", tem.sample_direction(sa_t, _tv(p),
                                              torch.zeros(n), sx, sy),
             jem.sample_direction(sa_j, _jv(p), jnp.zeros(n), jx, jy))):
        for f in ("p", "n", "d"):
            _close3(getattr(ds_t, f), getattr(ds_j, f), f"{label} {f}")
        for f in ("dist", "pdf", "delta", "emitter"):
            _close(getattr(ds_t, f), getattr(ds_j, f), f"{label} {f}")
        _close3(w_t, w_j, f"{label} weight")


def test_hg_matches_jax():
    """hg_sample and hg_eval, with asymmetries near 0 (the isotropic
    branch) and up to +-0.95."""
    rng = np.random.default_rng(13)
    n = 20000
    wi = _unit(rng, n)
    g = rng.uniform(-0.95, 0.95, n).astype(np.float32)
    g[:2000] = rng.uniform(-1e-3, 1e-3, 2000)
    s = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    wo_t, pdf_t = tmedia.hg_sample(_tv(wi), torch.from_numpy(g),
                                   torch.from_numpy(s[:, 0]),
                                   torch.from_numpy(s[:, 1]))
    wo_j, pdf_j = jmedia.hg_sample(_jv(wi), jnp.asarray(g),
                                   jnp.asarray(s[:, 0]), jnp.asarray(s[:, 1]))
    _close3(wo_t, wo_j, "wo")
    _close(pdf_t, pdf_j, "pdf")
    cos = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    _close(tmedia.hg_eval(torch.from_numpy(cos), torch.from_numpy(g)),
           jmedia.hg_eval(jnp.asarray(cos), jnp.asarray(g)), "eval")


def test_grid_density_matches_jax():
    """volpath's trilinear grid lookup in the smoke column's medium, at
    points in and around its box, and 0 for lanes in no grid."""
    sa_j = jax_mini_hero_scene()
    sa_t = mt.load_dict(mini_hero_dict(True, "dopplertofpath"),
                        device="cpu").compile()
    assert sa_t.any_hetero and sa_t.n_media == 1
    rng = np.random.default_rng(17)
    n = 20000
    p = rng.uniform([0.3, -0.1, -1.4], [1.3, 1.5, -0.4],
                    (n, 3)).astype(np.float32)
    med = rng.integers(-1, 1, n).astype(np.int32)
    ours = tvol._grid_density(sa_t, torch.from_numpy(med), _tv(p))
    theirs = jvol._grid_density(sa_j, jnp.asarray(med), _jv(p))
    _close(ours, theirs, "density")
    assert float(ours.max()) > 0.0


@pytest.mark.parametrize("kind,item", [("measured_polarized", None),
                                       ("polarizer", None),
                                       ("prb_basic", "item 12"),
                                       ("prb", "item 12")])
def test_deferred_plugins_name_item_10(kind, item, tmp_path):
    """The plugins still deferred (the AD integrators) name their ROADMAP
    Queue A item; item 11's polarized plugins are ported."""
    if item is None:
        d = {"type": kind}
        if kind == "measured_polarized":
            from mitsuba3dopplertof_tpu_torch.utils.measured_data import \
                write_pbsdf
            d["filename"] = write_pbsdf(str(tmp_path / "m.pbsdf"))
        assert type(mt.load_dict(d)).__name__ in ("MeasuredPolarized",
                                                  "Polarizer")
        return
    with pytest.raises(NotImplementedError, match=item):
        mt.load_dict({"type": kind})
