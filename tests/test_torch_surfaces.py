"""The surfaces and lights of the scene dialect in the PyTorch port against
the JAX package on the CPU, function by function: the roughconductor,
dielectric, thindielectric, roughdielectric, principled, principledthin,
pplastic, mask and blendbsdf BSDFs,
the sphere area light (static and animated), the constant, directional
and spot emitters, the PLY and ``.serialized`` loaders, and the disk,
cylinder, shapegroup, instance and merge shapes with ``load_string``
(their renders are in tests/test_torch_scene_dialect.py). Inputs are made
from a seed with numpy; function values agree within rtol 1e-5, atol
1e-6, integers and choices exactly, loaders and compiled tables bit for
bit."""

import gzip
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu import bsdfs as jbsdfs
from mitsuba3dopplertof_tpu import emitters as jem
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.core.transform import AnimatedTransform as JAnim
from mitsuba3dopplertof_tpu.io import mesh_loaders as jml
from mitsuba3dopplertof_tpu.render.types import DirectionSample as JDS

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch import bsdfs as tbsdfs
from mitsuba3dopplertof_tpu_torch import emitters as tem
from mitsuba3dopplertof_tpu_torch.core import transform as ttf
from mitsuba3dopplertof_tpu_torch.core.transform import \
    AnimatedTransform as TAnim
from mitsuba3dopplertof_tpu_torch.io import mesh_loaders as tml
from mitsuba3dopplertof_tpu_torch.render.scene import (SceneArrays,
                                                       from_jax_scene_arrays)
from mitsuba3dopplertof_tpu_torch.render.types import DirectionSample as TDS

from test_torch_hero_plugins import (_bsdf_inputs, _close, _close3, _jv,
                                     _plugin_scene, _tv)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# BSDFs
# ---------------------------------------------------------------------------

DIALECT_BSDFS = [
    {"type": "roughconductor", "material": "Al", "alpha": 0.2},
    {"type": "roughconductor", "material": "Au", "alpha_u": 0.05,
     "alpha_v": 0.4},
    {"type": "roughconductor", "distribution": "beckmann", "alpha": 0.3},
    {"type": "roughconductor", "distribution": "beckmann", "material": "Cu",
     "alpha_u": 0.3, "alpha_v": 0.08},
    {"type": "dielectric", "int_ior": "bk7",
     "specular_transmittance": {"type": "rgb", "value": [0.9, 0.8, 0.7]}},
    {"type": "thindielectric", "int_ior": 1.7},
    {"type": "roughdielectric", "alpha": 0.1, "int_ior": "water"},
    {"type": "roughdielectric", "alpha": 0.45, "int_ior": 2.1,
     "ext_ior": 1.2},
    {"type": "mask", "opacity": 0.6, "bsdf": {"type": "diffuse"}},
    {"type": "blendbsdf", "weight": 0.3,
     "a": {"type": "dielectric", "int_ior": 1.33},
     "b": {"type": "conductor", "material": "Au"}},
    # the principled family: anisotropic with every lobe and transmission;
    # eta given, flat, no transmission, under twosided; the thin sheet
    # with both transmissions and a tint; the thin sheet reflecting only;
    # pplastic
    {"type": "principled", "base_color": {"type": "rgb",
                                          "value": [0.8, 0.35, 0.2]},
     "metallic": 0.3, "roughness": 0.3, "anisotropic": 0.6, "sheen": 0.3,
     "sheen_tint": 0.5, "clearcoat": 0.5, "clearcoat_gloss": 0.4,
     "spec_trans": 0.4, "spec_tint": 0.3},
    {"type": "twosided", "bsdf": {
        "type": "principled", "eta": 1.7, "roughness": 0.6,
        "flatness": 0.7, "main_specular_sampling_rate": 0.5}},
    {"type": "principledthin", "base_color": {"type": "rgb",
                                              "value": [0.2, 0.5, 0.7]},
     "roughness": 0.25, "anisotropic": 0.3, "spec_trans": 0.5,
     "diff_trans": 0.8, "spec_tint": 0.4, "sheen": 0.5, "eta": 1.4},
    {"type": "principledthin", "roughness": 0.5, "flatness": 0.4},
    {"type": "pplastic", "alpha": 0.15, "int_ior": 1.6},
]
MICROFACET = (0, 1, 2, 3, 6, 7)     # the rough rows
PRINCIPLED = (10, 11, 12, 13, 14)   # the principled family's rows


@pytest.fixture(scope="module")
def bsdf_scenes():
    sa_j = mj.load_dict(_plugin_scene(jtf, DIALECT_BSDFS)).compile()
    sa_t = mt.load_dict(_plugin_scene(jtf, DIALECT_BSDFS),
                        device="cpu").compile()
    return sa_j, sa_t


def test_bsdf_rows_match_jax(bsdf_scenes):
    """The wrappers' nested rows and the shared null row join the table
    after the shapes' rows, in the JAX package's order, bit for bit."""
    sa_j, sa_t = bsdf_scenes
    assert np.array_equal(sa_t.bsdf_params.numpy(),
                          np.asarray(sa_j.bsdf_params))
    assert np.array_equal(sa_t.bsdf_type.numpy(), np.asarray(sa_j.bsdf_type))
    assert sa_t.bsdf_flags_host == sa_j.bsdf_flags_host
    # 15 rows of the shapes, the mask's diffuse and the null row, the
    # blend's two nested rows
    assert sa_t.bsdf_types_present == (0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11,
                                       17)
    assert sa_t.bsdf_type.shape[0] == 19


def test_remap_wrapper_rows_matches_jax(bsdf_scenes):
    """mask and blendbsdf lanes move to the same nested row in both
    packages, with the lobe sample rescaled alike; other lanes keep
    theirs."""
    sa_j, sa_t = bsdf_scenes
    rng = np.random.default_rng(2)
    n = 20000
    lane = rng.integers(0, 19, n).astype(np.int32)
    s1 = rng.uniform(0.0, 1.0, n).astype(np.float32)
    rows_j, s_j = jbsdfs.remap_wrapper_rows(sa_j, jnp.asarray(lane),
                                            jnp.asarray(s1))
    rows_t, s_t = tbsdfs.remap_wrapper_rows(sa_t, torch.from_numpy(lane),
                                            torch.from_numpy(s1))
    assert np.array_equal(rows_t.numpy(), np.asarray(rows_j))
    _close(s_t, s_j, "s1")
    moved = rows_t.numpy() != lane
    assert set(np.unique(lane[moved])) == {8, 9}
    assert set(np.unique(rows_t.numpy()[lane == 8])) == {15, 16}


def test_bsdfs_match_jax(bsdf_scenes):
    """eval / pdf / sample of every new row on the same random directions
    (both sides of the surface) and samples: sampled_delta, sampled_null,
    eta and the chosen lobe (reflection or transmission) exactly equal;
    the NEE value and pdf on every lane, and the sample (direction, weight
    and pdf) on the lanes that took one (a rejected sample's direction is
    not used), within rtol 1e-5, atol 1e-6, except on a few lanes of the
    microfacet rows: there the last bits of sin / cos / exp (XLA's against
    PyTorch's) grow by about 1 / alpha^2 at grazing angles, and a
    transmission half vector normalize(wi + eta wo) near a vanishing sum.
    The old rows 0-9 take the 20,000 lanes of their own draw and the
    principled family's rows 10-14 10,000 of a second one. Measured on
    these inputs: at most 3 of the 7,424 sampled lanes of the microfacet
    rows, and at most 2 of the 8,803 of the principled family's rows,
    outside 1e-5 in any field; so at most 4 lanes per field and row group
    outside 1e-5, and every lane within rtol 1e-4, atol 1e-6. (A single
    draw of 30,000 lanes over all 15 rows meets sampled directions within
    1e-3 of the tangent plane in rows 1 and 10, whose weight differs by up
    to 9e-4 relative, and a thin-sheet direction 4e-5 from it, whose z
    differs by 7.7e-6.)"""
    sa_j, sa_t = bsdf_scenes
    old_rows = _bsdf_inputs(20000, 10, 9)[:4]
    new_rows = _bsdf_inputs(10000, 5, 10)[:4]
    wi, wo, s = (np.concatenate([a, b])
                 for a, b in zip(old_rows[:3], new_rows[:3]))
    lane = np.concatenate([old_rows[3], new_rows[3] + 10]).astype(np.int32)
    assert (wi[:, 2] < 0).mean() > 0.4 and (wi[:, 2] > 0).mean() > 0.4
    r_j = jbsdfs.eval_pdf_sample(
        sa_j, jnp.asarray(lane), _jv(wi), _jv(wo), jnp.asarray(s[:, 0]),
        jnp.asarray(s[:, 1]), jnp.asarray(s[:, 2]))
    r_t = tbsdfs.eval_pdf_sample(
        sa_t, torch.from_numpy(lane), _tv(wi), _tv(wo),
        torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1]),
        torch.from_numpy(s[:, 2]))
    for f in ("sampled_delta", "sampled_null"):
        _close(getattr(r_t, f), getattr(r_j, f), f, exact=True)
    valid = np.asarray(r_j.pdf) > 0.0
    assert valid.mean() > 0.5
    # the lobe: the sampled direction on wi's side or across
    lobe_t = r_t.wo.z.numpy() * wi[:, 2] > 0.0
    lobe_j = np.asarray(r_j.wo.z) * wi[:, 2] > 0.0
    assert np.array_equal(lobe_t[valid], lobe_j[valid])
    assert np.array_equal(r_t.eta.numpy()[valid], np.asarray(r_j.eta)[valid])
    for row in (4, 6, 7, 9, 10, 12):
        # the dielectric and transmitting principled rows both reflect and
        # refract, from both sides
        m = valid & (lane == row)
        for side in (wi[:, 2] > 0, wi[:, 2] < 0):
            assert lobe_t[m & side].any() and (~lobe_t[m & side]).any(), row
    groups = [np.isin(lane, MICROFACET), np.isin(lane, PRINCIPLED)]
    rough = groups[0] | groups[1]
    everywhere = np.ones_like(valid)
    fields = [("pdf_nee", r_t.pdf_nee, r_j.pdf_nee, everywhere),
              ("eta", r_t.eta, r_j.eta, everywhere),
              ("pdf", r_t.pdf, r_j.pdf, valid)]
    for f, where in (("val_nee", everywhere), ("wo", valid),
                     ("weight", valid)):
        for c in "xyz":
            fields.append((f"{f}.{c}", getattr(getattr(r_t, f), c),
                           getattr(getattr(r_j, f), c), where))
    for label, a, b, where in fields:
        a, b = a.numpy(), np.asarray(b)
        ok = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        assert ok[where & ~rough].all(), label
        for group in groups:
            assert (~ok[where & group]).sum() <= 4, label
        np.testing.assert_allclose(a[where], b[where], rtol=1e-4,
                                   atol=1e-6, err_msg=label)


@pytest.mark.parametrize("props", [
    {"specular": 0.0, "spec_trans": 0.5},          # specular 0 -> 1e-3
    {"eta": 1.0, "spec_trans": 0.2},               # eta 1 -> 1.001
    {"specular": 0.9, "anisotropic": 0.9, "roughness": 0.02},
    {"eta": 2.2, "thin": True, "diff_trans": 1.5},
    {"thin": True, "anisotropic": 0.5},            # thin: eta 1.5
])
def test_principled_rows_match_jax(props):
    """The principled rows from their properties, the eta <-> specular
    mapping and its edge cases, and the anisotropic alpha clamp: the same
    float64 row in both packages, bit for bit."""
    props = dict(props)
    kind = "principledthin" if props.pop("thin", False) else "principled"
    row_j = mj.load_dict(dict(props, type=kind)).params_row()
    row_t = mt.load_dict(dict(props, type=kind)).params_row()
    assert row_t.dtype == row_j.dtype and np.array_equal(row_t, row_j)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_principled_eta_and_specular_exclude_each_other(pkg):
    m = mj if pkg == "jax" else mt
    with pytest.raises(ValueError, match="either 'eta' or 'specular'"):
        m.load_dict({"type": "principled", "eta": 1.5, "specular": 0.5})


# ---------------------------------------------------------------------------
# Emitters
# ---------------------------------------------------------------------------

def _emitter_scene(tf, anim_cls):
    """Five emitters: a static and an animated sphere light, a spot, a
    directional light and a constant sky, over a floor."""
    def rgb(v):
        return {"type": "rgb", "value": v}
    return {
        "type": "scene",
        "sensor": {"type": "perspective", "film": {"type": "hdrfilm",
                                                   "width": 4,
                                                   "height": 4}},
        "floor": {"type": "rectangle", "to_world": tf.translate([0, -1, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([3, 3, 1])},
        "ball": {"type": "sphere", "center": [0.5, 1.5, 0.2], "radius": 0.4,
                 "emitter": {"type": "area", "radiance": rgb([5, 4, 3])}},
        "mover": {"type": "sphere", "to_world": anim_cls([
            (0.0, tf.translate([-1.0, 0.8, 0.5]) @ tf.scale([0.3] * 3)),
            (1.0, tf.translate([-0.2, 1.2, 0.1]) @ tf.scale([0.5] * 3))]),
            "emitter": {"type": "area", "radiance": rgb(7.0)}},
        "spot": {"type": "spot", "cutoff_angle": 30.0, "beam_width": 12.0,
                 "to_world": tf.look_at([1, 3, -1], [0, -1, 0], [0, 1, 0]),
                 "intensity": rgb([20, 18, 16])},
        "sun": {"type": "directional", "direction": [0.2, -1.0, 0.3],
                "irradiance": rgb(2.0)},
        "sky": {"type": "constant", "radiance": rgb([0.1, 0.2, 0.3])},
    }


def test_emitters_match_jax():
    """sample_direction through the emitter dispatch (the five emitters
    chosen by s_x) from random points at random times, and pdf_direction
    of the JAX package's samples given to both packages: the emitter
    table bit for bit; the samples' directions, distances and pdfs within
    the tolerance, index and delta flags exactly, the weights outside the
    spot's falloff band within the tolerance; the sampled points and
    normals on all but 12 of the 20,000 lanes within the tolerance and
    all within atol 1e-5, the weights in the band within rtol 4e-4; the
    pdf of the delta lights is 0, the sky's 1 / (4 pi), the spheres'
    their sampling pdf."""
    sa_j = mj.load_dict(_emitter_scene(jtf, JAnim)).compile()
    sa_t = mt.load_dict(_emitter_scene(ttf, TAnim), device="cpu").compile()
    for k in ("emitter_type", "emitter_params", "emitter_m", "sph_m0c",
              "sph_m1c"):
        assert np.array_equal(getattr(sa_t, k).numpy(),
                              np.asarray(getattr(sa_j, k))), k
    assert sa_t.emitter_types_present == (2, 4, 5, 9)
    assert sa_t.env_kind == "constant" and sa_t.env_radiance == tuple(
        float(x) for x in np.float32([0.1, 0.2, 0.3]))
    rng = np.random.default_rng(23)
    n = 20000
    p = rng.uniform([-2, -1, -2], [2, 2.5, 2], (n, 3)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, n).astype(np.float32)
    s = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    ds_j, w_j = jem.sample_direction(sa_j, _jv(p), jnp.asarray(t),
                                     jnp.asarray(s[:, 0]),
                                     jnp.asarray(s[:, 1]))
    ds_t, w_t = tem.sample_direction(sa_t, _tv(p), torch.from_numpy(t),
                                     torch.from_numpy(s[:, 0]),
                                     torch.from_numpy(s[:, 1]))
    _close3(ds_t.d, ds_j.d, "d")
    for f in ("dist", "pdf"):
        _close(getattr(ds_t, f), getattr(ds_j, f), f)
    for f in ("delta", "emitter"):
        _close(getattr(ds_t, f), getattr(ds_j, f), f, exact=True)
    kinds = np.asarray(sa_j.emitter_type)[np.asarray(ds_j.emitter)]
    # the spot's falloff band, where its weight is a difference of cosines
    # near the cutoff over the band's width
    full = np.asarray(sa_j.emitter_params)[3, np.asarray(ds_j.emitter)] / (
        np.asarray(ds_j.dist) ** 2) * 5
    fall = np.asarray(w_j.x) / full
    band = (kinds == 5) & (fall > 0.0) & (fall < 1.0 - 1e-6)
    assert band.sum() > 50
    # the sphere's sampled point and normal (its near-side distance is a
    # square root of a difference that vanishes at the silhouette; the
    # normal is that point's offset over the radius) and the weight in the
    # spot's band (a difference of cosines over the band's width) carry
    # the last bits of rsqrt / sin / cos amplified on a few lanes.
    # Measured on these inputs: at most 10 lanes of a point's or normal's
    # component outside 1e-5, all on the spheres, none off by more than
    # 8.1e-6; 24 of the band's 1,618 weights outside it, none by more
    # than 3.3e-4 relative; no weight off the band
    for label, a, b in (("p", ds_t.p, ds_j.p), ("n", ds_t.n, ds_j.n)):
        for c in "xyz":
            x, y = getattr(a, c).numpy(), np.asarray(getattr(b, c))
            ok = np.isclose(x, y, rtol=1e-5, atol=1e-6)
            assert (~ok).sum() <= 12, f"{label}.{c}"
            assert set(np.unique(kinds[~ok])) <= {9}, f"{label}.{c}"
            np.testing.assert_allclose(x, y, rtol=0.0, atol=1e-5,
                                       err_msg=f"{label}.{c}")
    for c in "xyz":
        x, y = getattr(w_t, c).numpy(), np.asarray(getattr(w_j, c))
        np.testing.assert_allclose(x[~band], y[~band], rtol=1e-5, atol=1e-6,
                                   err_msg=f"weight.{c}")
        np.testing.assert_allclose(x[band], y[band], rtol=4e-4, atol=1e-6,
                                   err_msg=f"weight.{c} in the band")
    assert set(np.unique(kinds)) == {2, 4, 5, 9}
    # the spheres' cones from points inside a sphere have no pdf
    assert (np.asarray(ds_j.pdf)[kinds == 9] > 0).mean() > 0.9
    # pdf_direction of the JAX package's samples, in both packages
    np_ds = {f: np.array(getattr(ds_j, f)) for f in ("dist", "emitter")}
    vec = {f: np.stack([np.asarray(c) for c in getattr(ds_j, f)], 1)
           for f in ("p", "n", "d")}
    z = np.zeros(n, bool)
    jds = JDS(_jv(vec["p"]), _jv(vec["n"]), _jv(vec["d"]),
              jnp.asarray(np_ds["dist"]), jnp.zeros(n), jnp.asarray(z),
              jnp.asarray(np_ds["emitter"]))
    tds = TDS(_tv(vec["p"]), _tv(vec["n"]), _tv(vec["d"]),
              torch.from_numpy(np_ds["dist"]), torch.zeros(n),
              torch.from_numpy(z), torch.from_numpy(np_ds["emitter"]))
    pdf_j = jem.pdf_direction(sa_j, jds, time=jnp.asarray(t))
    pdf_t = tem.pdf_direction(sa_t, tds, time=torch.from_numpy(t))
    _close(pdf_t, pdf_j, "pdf_direction")
    pdf_t = pdf_t.numpy()
    assert (pdf_t[np.isin(kinds, (4, 5))] == 0.0).all()
    np.testing.assert_allclose(pdf_t[kinds == 2], 1.0 / (4 * np.pi) / 5,
                               rtol=1e-6)
    sph = kinds == 9
    np.testing.assert_allclose(pdf_t[sph], np.asarray(ds_j.pdf)[sph],
                               rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------

def _mesh_data(rng, nv=40, nf=60, quads=False):
    v = rng.standard_normal((nv, 3)).astype(np.float32)
    n = rng.standard_normal((nv, 3)).astype(np.float32)
    uv = rng.uniform(0.0, 1.0, (nv, 2)).astype(np.float32)
    col = rng.integers(0, 256, (nv, 3)).astype(np.uint8)
    k = 4 if quads else 3
    f = np.stack([rng.choice(nv, k, replace=False) for _ in range(nf)])
    return v, n, uv, col, f


def _write_ply(path, fmt, v, n, uv, col, faces):
    """A PLY file of float positions, normals and uvs, uchar colors and
    faces (uchar counts, int indices; every row of ``faces`` a polygon,
    plus one triangle so that the lists are not uniform when ``faces``
    are quads)."""
    faces = list(faces) + [faces[0][:3]]
    props = ["x", "y", "z", "nx", "ny", "nz", "u", "v"]
    head = (f"ply\nformat {fmt} 1.0\ncomment written by a test\n"
            f"element vertex {len(v)}\n"
            + "".join(f"property float {p}\n" for p in props)
            + "property uchar red\nproperty uchar green\n"
            "property uchar blue\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    fl = np.concatenate([v, n, uv], 1)
    if fmt == "ascii":
        body = "".join(" ".join([repr(float(x)) for x in row]
                                + [str(int(c)) for c in cc]) + "\n"
                       for row, cc in zip(fl, col))
        body += "".join(" ".join(str(int(x)) for x in [len(f), *f]) + "\n"
                        for f in faces)
        data = (head + body).encode("ascii")
    else:
        e = "<" if "little" in fmt else ">"
        rec = np.empty(len(v), [(p, e + "f4") for p in props]
                       + [(c, "u1") for c in ("red", "green", "blue")])
        for j, p in enumerate(props):
            rec[p] = fl[:, j]
        for j, c in enumerate(("red", "green", "blue")):
            rec[c] = col[:, j]
        body = rec.tobytes() + b"".join(
            struct.pack(f"{e}B{len(f)}i", len(f), *[int(x) for x in f])
            for f in faces)
        data = head.encode("ascii") + body
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as fh:
        fh.write(data)


def _same_mesh(a, b):
    for k in ("vertices", "faces", "normals", "uvs"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert sorted(a.attributes) == sorted(b.attributes)
    for k in a.attributes:
        assert np.array_equal(a.attributes[k], b.attributes[k]), k


@pytest.mark.parametrize("quads", [False, True], ids=["triangles", "quads"])
@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian",
                                 "binary_big_endian", "gz"])
def test_ply_reads_bit_equal(tmp_path, fmt, quads):
    """PLY files (ascii, binary little- and big-endian, gzip'd) with
    normals, uvs and vertex colors, triangles or quads (fanned), read by
    both packages to the same arrays bit for bit."""
    rng = np.random.default_rng(31 + quads)
    v, n, uv, col, f = _mesh_data(rng, quads=quads)
    path = str(tmp_path / ("m.ply.gz" if fmt == "gz" else "m.ply"))
    _write_ply(path, "binary_little_endian" if fmt == "gz" else fmt,
               v, n, uv, col, f)
    ours, theirs = tml.load_ply(path), jml.load_ply(path)
    _same_mesh(ours, theirs)
    assert ours.n_triangles == len(f) * (2 if quads else 1) + 1
    assert np.array_equal(ours.vertices, v.astype(np.float64))


def _write_serialized(path, version, shapes):
    """A Mitsuba .serialized file: per shape the 0x041C header and a zlib
    stream (flags, the name from version 4 on, counts, positions, normals,
    uvs, colors, uint32 faces), then the shapes' offsets and count."""
    out, offsets = b"", []
    for name, double, v, n, uv, col, f in shapes:
        flags = ((n is not None) * 0x1 | (uv is not None) * 0x2
                 | (col is not None) * 0x8 | double * 0x2000)
        ft = "<f8" if double else "<f4"
        body = struct.pack("<I", flags)
        if version >= 4:
            body += name.encode() + b"\0"
        body += struct.pack("<QQ", len(v), len(f))
        for a in (v, n, uv, col):
            if a is not None:
                body += np.asarray(a, ft).tobytes()
        body += np.asarray(f, "<u4").tobytes()
        offsets.append(len(out))
        out += struct.pack("<HH", 0x041C, version) + zlib.compress(body)
    table = struct.pack(f"<{len(offsets)}{'Q' if version >= 4 else 'I'}",
                        *offsets)
    with open(path, "wb") as fh:
        fh.write(out + table + struct.pack("<I", len(offsets)))


@pytest.mark.parametrize("version", [3, 4])
def test_serialized_reads_bit_equal(tmp_path, version):
    """Two shapes in a .serialized file (float32 with normals, uvs and
    colors; float64 with positions only), each read by both packages by
    its shape_index to the same arrays bit for bit; and the serialized
    shape plugin loads the second."""
    rng = np.random.default_rng(41 + version)
    v, n, uv, col, f = _mesh_data(rng)
    v2 = rng.standard_normal((12, 3))
    f2 = rng.integers(0, 12, (7, 3))
    path = str(tmp_path / "m.serialized")
    _write_serialized(path, version, [
        ("first", False, v, n, uv, col.astype(np.float32) / 255.0, f),
        ("second", True, v2, None, None, None, f2)])
    for k in (0, 1):
        _same_mesh(tml.load_serialized(path, k), jml.load_serialized(path, k))
    shape = mt.load_dict({"type": "serialized", "filename": path,
                          "shape_index": 1})
    assert np.array_equal(shape.mesh.vertices, v2)
    assert np.array_equal(shape.mesh.faces, f2)


# ---------------------------------------------------------------------------
# Shapes and compiled tables
# ---------------------------------------------------------------------------

def _dialect_scene(tf, anim_cls, ply, ser):
    """disk, cylinder, merge, a serialized mesh, and a shapegroup (a cube,
    a PLY mesh of 120 triangles and an emitting sphere) placed by an
    animated and a static instance."""
    return {
        "type": "scene",
        "sensor": {"type": "perspective", "film": {"type": "hdrfilm",
                                                   "width": 4,
                                                   "height": 4}},
        "light": {"type": "point", "position": [0, 4, -2]},
        "grp": {"type": "shapegroup",
                "box": {"type": "cube", "to_world": tf.scale([0.3] * 3),
                        "bsdf": {"type": "roughconductor",
                                 "distribution": "beckmann"}},
                "mesh": {"type": "ply", "filename": ply,
                         "to_world": tf.translate([0.5, 0, 0]),
                         "bsdf": {"type": "dielectric"}},
                "bulb": {"type": "sphere", "radius": 0.2,
                         "center": [0, 0.6, 0],
                         "emitter": {"type": "area", "radiance": {
                             "type": "rgb", "value": 3.0}}}},
        "moving": {"type": "instance", "g": {"type": "ref", "id": "grp"},
                   "to_world": anim_cls([
                       (0.0, tf.translate([-1, 0, 1])),
                       (1.0, tf.translate([-0.5, 0.3, 1])
                        @ tf.rotate([0, 1, 0], 40))])},
        "still": {"type": "instance", "g": {"type": "ref", "id": "grp"},
                  "to_world": tf.translate([1.5, 0, 2])
                  @ tf.scale([1.2] * 3)},
        "disk": {"type": "disk", "to_world": tf.translate([0, -1, 1])
                 @ tf.rotate([1, 0, 0], -90),
                 "bsdf": {"type": "mask", "opacity": 0.25,
                          "bsdf": {"type": "diffuse"}}},
        "cyl": {"type": "cylinder", "to_world": tf.translate([2, -1, 3])
                @ tf.rotate([1, 0, 0], -90) @ tf.scale([0.5, 0.5, 2]),
                "emitter": {"type": "area"}},
        "merged": {"type": "merge",
                   "a": {"type": "rectangle",
                         "to_world": tf.translate([0, 0, 4])},
                   "b": {"type": "cube", "to_world": tf.translate([-2, 0, 4])
                         @ tf.scale([0.5] * 3),
                         "bsdf": {"type": "thindielectric"}}},
        "ser": {"type": "serialized", "filename": ser, "shape_index": 1,
                "to_world": tf.translate([0, 2, 5])},
    }


@pytest.fixture(scope="module")
def dialect_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dialect")
    rng = np.random.default_rng(5)
    ply = str(d / "m.ply")
    v, n, uv, col, f = _mesh_data(rng, nv=50, nf=120)
    _write_ply(ply, "binary_little_endian", v, n, uv, col, f)
    ser = str(d / "m.serialized")
    _write_serialized(ser, 4, [("a", False, v, None, None, None, f[:10]),
                               ("b", False, v, n, uv, None, f)])
    return ply, ser


def _same_tables(sa_p, sa_j):
    via = from_jax_scene_arrays(
        {k: np.asarray(getattr(sa_j, k)) for k in SceneArrays.ARRAY_FIELDS
         + ["chunk_aabb"]}, sa_j)
    for k in SceneArrays.ARRAY_FIELDS:
        a, b = getattr(sa_p, k), getattr(via, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert torch.equal(sa_p.chunk_aabb, via.chunk_aabb)
    for k in SceneArrays.META_FIELDS:
        assert getattr(sa_p, k) == getattr(via, k), k


def test_dialect_scene_compiles_to_jax_tables(dialect_files):
    """disk, cylinder, merge, a serialized mesh and two instances (one
    animated) of a shapegroup compile to the JAX package's tables bit for
    bit, every array and metadata field; the group itself is not
    rendered, and each instance of the emitting sphere is a light."""
    ply, ser = dialect_files
    sa_j = mj.load_dict(_dialect_scene(jtf, JAnim, ply, ser)).compile()
    sa_p = mt.load_dict(_dialect_scene(ttf, TAnim, ply, ser),
                        device="cpu").compile()
    _same_tables(sa_p, sa_j)
    # two instances x (cube + mesh) animated or static, the disk (64),
    # the cylinder (128), the merge (2 + 12), the serialized mesh (120)
    assert (sa_p.n_static_tris, sa_p.n_anim_tris, sa_p.n_spheres,
            sa_p.sphere_animated, sa_p.n_emitters) == (
        12 + 121 + 64 + 128 + 14 + 120, 12 + 121, 2, (True, False), 4)
    assert sa_p.emitter_types_present == (0, 3, 9)


DIALECT_XML = """<scene version="3.0.0">
  <default name="spp" value="4"/>
  <sensor type="perspective">
    <sampler type="independent"><integer name="sample_count"
      value="$spp"/></sampler>
    <film type="hdrfilm"><integer name="width" value="4"/>
      <integer name="height" value="4"/></film>
  </sensor>
  <emitter type="constant"><rgb name="radiance" value="0.2"/></emitter>
  <emitter type="spot">
    <float name="cutoff_angle" value="25"/>
    <transform name="to_world"><lookat origin="1, 3, 1" target="0, 0, 0"
      up="0, 1, 0"/></transform>
  </emitter>
  <shape type="shapegroup" id="pair">
    <shape type="cylinder"><bsdf type="roughdielectric"/></shape>
    <shape type="disk">
      <bsdf type="blendbsdf">
        <float name="weight" value="0.7"/>
        <bsdf type="diffuse"/>
        <bsdf type="roughconductor"><string name="material" value="Ag"/>
        </bsdf>
      </bsdf>
    </shape>
  </shape>
  <shape type="instance"><ref id="pair"/>
    <transform name="to_world"><translate x="1"/></transform>
  </shape>
  <shape type="instance"><ref id="pair"/>
    <animation name="to_world">
      <transform time="0"><translate y="-1"/></transform>
      <transform time="1"><translate y="1"/></transform>
    </animation>
  </shape>
  <shape type="sphere"><float name="radius" value="0.25"/>
    <emitter type="area"/>
    <transform name="to_world"><translate z="3"/></transform>
  </shape>
</scene>"""


def test_load_string_matches_jax():
    """mi.load_string on an XML scene with shapegroup / instance (one
    static, one <animation>), a blendbsdf, a constant sky, a spot and a
    sphere light: the JAX package's tables bit for bit, and ``<default>``
    overridden by a parameter."""
    sc_j = mj.load_string(DIALECT_XML, spp=8)
    sc_p = mt.load_string(DIALECT_XML, device="cpu", spp=8)
    assert sc_p.sensor.sampler.sample_count == 8
    sa_p = sc_p.compile()
    _same_tables(sa_p, sc_j.compile())
    assert (sa_p.n_static_tris, sa_p.n_anim_tris, sa_p.env_kind) == (
        192, 192, "constant")


def test_blender_shape_raises_as_in_jax():
    with pytest.raises(RuntimeError, match="Blender"):
        mt.load_dict({"type": "blender"})
