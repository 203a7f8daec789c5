"""The textured-surface and textured-emitter plugins in the PyTorch port
against the JAX package on the CPU: ``normalmap``, ``bumpmap``, the
``mesh_attribute`` and ``volume`` textures and area emitters with a
radiance texture on rectangles, meshes and spheres.

The scenes are ``utils/textured_scenes.py``'s at a small size: the
surface scene (normal-mapped wall, bump-mapped roughplastic floor,
volume-textured panel, checkerboard rectangle light, bitmap sphere light)
and the mesh-light scene with an 8x8 vertex-coloured UV sphere under a
4x4 grid light with uvs. Their compiled tables equal the JAX package's
bit for bit; ``eval_texture``, ``_apply_normal_maps`` and the emitters'
sample, pdf and hit radiance agree on about 10^4 lanes within rtol 1e-4,
atol 1e-5; the surface scene's ``dopplertofpath`` and ``ptracer`` images
agree at PERF.md section 2's tolerance (rtol 1e-4, atol 1e-4 * max|ref|).
Inputs are made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu import emitters as jem
from mitsuba3dopplertof_tpu import integrators as ji
from mitsuba3dopplertof_tpu import textures as jtex
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.core.transform import AnimatedTransform as JAnim
from mitsuba3dopplertof_tpu.core.vec import Vec3 as JVec3
from mitsuba3dopplertof_tpu.render.scene import ray_intersect as j_intersect
from mitsuba3dopplertof_tpu.render.types import DirectionSample as JDS
from mitsuba3dopplertof_tpu.render.types import Ray as JRay

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch import emitters as tem
from mitsuba3dopplertof_tpu_torch import integrators as ti
from mitsuba3dopplertof_tpu_torch import textures as ttex
from mitsuba3dopplertof_tpu_torch.bsdfs import P_BMAP_SCALE, P_NMAP_TEX
from mitsuba3dopplertof_tpu_torch.core import transform as ttf
from mitsuba3dopplertof_tpu_torch.core.transform import \
    AnimatedTransform as TAnim
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3dopplertof_tpu_torch.emitters import E_RAD_TEX
from mitsuba3dopplertof_tpu_torch.render.scene import (SceneArrays,
                                                       from_jax_scene_arrays)
from mitsuba3dopplertof_tpu_torch.render.scene import \
    ray_intersect as t_intersect
from mitsuba3dopplertof_tpu_torch.render.types import DirectionSample as TDS
from mitsuba3dopplertof_tpu_torch.render.types import Ray as TRay
from mitsuba3dopplertof_tpu_torch.utils import textured_scenes as ts

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_ties import TieRecorder

TOL = dict(rtol=1e-4, atol=1e-5)
RES, SPP = 16, 16
N = 10000


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i], jnp.float32) for i in range(3)))


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i],
                                                         np.float32))
                   for i in range(3)))


def _close(ours, theirs, label, exact=False):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, label
    if exact or ours.dtype == bool or ours.dtype.kind in "iu":
        assert np.array_equal(ours, theirs), label
    else:
        np.testing.assert_allclose(ours, theirs, err_msg=label, **TOL)


def _close3(ours, theirs, label):
    for c in "xyz":
        _close(getattr(ours, c), getattr(theirs, c), f"{label}.{c}")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("textured"))
    assets = ts.write_surface_assets(d)
    assets["sphere"] = f"{d}/sphere_8x8.ply"
    assets["light"] = f"{d}/light_4x4.ply"
    assert ts.write_colored_sphere_ply(assets["sphere"], 8, 8) == 128
    assert ts.write_light_grid_ply(assets["light"], 4) == 32
    return assets


def _scene_dict(name, files, tf, anim_cls, spp=SPP, res=RES):
    if name == "surface":
        return ts.surface_scene(files, spp, res, tf, anim_cls)
    return ts.mesh_light_scene(files["sphere"], files["light"],
                               files["glow"], spp, res, tf, anim_cls)


@pytest.fixture(scope="module")
def compiled(files):
    """name -> (port tables, JAX tables) of a scene, compiled once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (
                mt.load_dict(_scene_dict(name, files, ttf, TAnim),
                             device="cpu").compile(),
                mj.load_dict(_scene_dict(name, files, jtf, JAnim)).compile())
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["surface", "mesh_light"])
def test_tables_match_jax(compiled, name):
    """Every array and metadata field of the port's compile equals the JAX
    package's carried over by from_jax_scene_arrays, bit for bit: the
    texture rows and the atlas (volume grids in it), the mesh_attr table
    in the Morton order of the triangle slots, the BSDF rows' normal-map
    columns and the emitters' radiance-texture column."""
    sa_t, sa_j = compiled(name)
    arrays = {k: np.asarray(getattr(sa_j, k))
              for k in SceneArrays.ARRAY_FIELDS + ["chunk_aabb"]}
    arrays["mesh_attr"] = (None if sa_j.mesh_attr is None
                           else np.asarray(sa_j.mesh_attr))
    via = from_jax_scene_arrays(arrays, sa_j)
    for k in SceneArrays.ARRAY_FIELDS + ["chunk_aabb"]:
        a, b = getattr(sa_t, k), getattr(via, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for k in SceneArrays.META_FIELDS:
        assert getattr(sa_t, k) == getattr(via, k), k
    nmap = sa_t.bsdf_params[P_NMAP_TEX]
    rad = sa_t.emitter_params[E_RAD_TEX]
    if name == "surface":
        assert sa_t.mesh_attr is None and via.mesh_attr is None
        assert sa_t.any_nmap and sa_t.tex_types_present == (0, 1, 2)
        # wall: normal map 0; floor: height map 1 with its scale; panel
        # none; the emitters' checkerboard and bitmap
        assert nmap.tolist() == [0.0, 1.0, -1.0, -1.0, -1.0]
        assert sa_t.bsdf_params[P_BMAP_SCALE].tolist()[:2] == [
            0.0, np.float32(0.02)]
        assert rad.tolist() == [3.0, 4.0]
        assert (sa_t.n_static_tris, sa_t.n_anim_tris, sa_t.n_spheres,
                sa_t.sphere_animated) == (6, 2, 1, (True,))
    else:
        assert torch.equal(sa_t.mesh_attr, via.mesh_attr)
        assert tuple(sa_t.mesh_attr.shape) == (9, 2 + 32 + 128)
        assert not sa_t.any_nmap and sa_t.tex_types_present == (1, 3)
        assert rad.tolist()[1] == 1.0


def test_mesh_attr_follows_the_morton_order(compiled, files):
    """The animated sphere's 128 triangles are reordered by Morton code
    (above 64 faces); each slot's attribute corners are the PLY's vertex
    colours of that slot's triangle, in the order of its corners."""
    sa_t, _ = compiled("mesh_light")
    from mitsuba3dopplertof_tpu_torch.io.mesh_loaders import load_ply
    mesh = load_ply(files["sphere"])
    col = mesh.attributes["vertex_color"].astype(np.float32)
    assert len(sa_t.anim_ranges) == 1
    _, start, cnt = sa_t.anim_ranges[0]
    slots = sa_t.n_static_tris + start + np.arange(cnt)
    v0 = np.stack([sa_t.a_v0x, sa_t.a_v0y, sa_t.a_v0z], 1)[start:start + cnt]
    attr = sa_t.mesh_attr.numpy()[:, slots].T
    # the slot's first corner is the vertex at v0: its colour
    idx = np.argmin(np.linalg.norm(
        mesh.vertices[None, :, :] - v0[:, None, :], axis=-1), axis=1)
    assert np.array_equal(attr[:, :3], col[idx])
    # the file's order is not the slots'
    assert not np.array_equal(idx, mesh.faces[:, 0])


def _texture_lanes(sa_t, kind, rng):
    """(tex ids, u, v, p, b_u, b_v, prim) of N lanes on the textures of
    ``kind`` ("volume": world points around the panel's volume;
    "mesh_attribute": barycentrics on random triangle slots)."""
    u, v = (rng.random(N).astype(np.float32) for _ in range(2))
    types = sa_t.tex_type.numpy()
    tid = int(np.flatnonzero(types == (ttex.TEX_VOLUME if kind == "volume"
                                       else ttex.TEX_MESHATTR))[0])
    ids = np.full(N, tid, np.int32)
    ids[::7] = -1                      # lanes the caller masks
    p = rng.uniform([-2.0, -1.4, -0.1], [0.0, 0.8, 1.7],
                    (N, 3)).astype(np.float32)
    b_u = rng.random(N).astype(np.float32)
    b_v = (rng.random(N) * (1.0 - b_u)).astype(np.float32)
    n_tri = sa_t.n_static_tris + sa_t.n_anim_tris
    prim = rng.integers(0, n_tri, N).astype(np.int32)
    return ids, u, v, p, b_u, b_v, prim


@pytest.mark.parametrize("kind,with_si", [
    ("volume", True), ("volume", False), ("mesh_attribute", True),
    ("mesh_attribute", False)])
def test_eval_texture_matches_jax(compiled, kind, with_si):
    """eval_texture of the volume texture at world points (trilinear in
    the atlas through T_W2G) and of the mesh attribute at barycentrics on
    triangle slots; without the surface interaction's arguments both
    packages return 0.5 gray."""
    sa_t, sa_j = compiled("surface" if kind == "volume" else "mesh_light")
    rng = np.random.default_rng(31 if kind == "volume" else 37)
    ids, u, v, p, b_u, b_v, prim = _texture_lanes(sa_t, kind, rng)
    kw_t, kw_j = {}, {}
    if with_si:
        kw_t = dict(p=_tv(p), b_u=torch.from_numpy(b_u),
                    b_v=torch.from_numpy(b_v), prim=torch.from_numpy(prim))
        kw_j = dict(p=_jv(p), b_u=jnp.asarray(b_u), b_v=jnp.asarray(b_v),
                    prim=jnp.asarray(prim))
    ours = ttex.eval_texture(sa_t, torch.from_numpy(ids),
                             torch.from_numpy(u), torch.from_numpy(v),
                             **kw_t)
    theirs = jtex.eval_texture(sa_j, jnp.asarray(ids), jnp.asarray(u),
                               jnp.asarray(v), **kw_j)
    _close3(ours, theirs, kind)
    if with_si:
        assert float(ours.x.std()) > 0.05
    else:
        assert torch.all(ours.x[ids >= 0] == 0.5)


def _floor_and_wall_si(sa_t, sa_j, rng):
    """Both packages' surface interactions of N camera rays aimed at
    random points of the wall and the floor, at random times."""
    half = N // 2
    tgt = np.concatenate([
        np.stack([rng.uniform(-2.2, 2.2, half), np.full(half, -1.2),
                  rng.uniform(-1.5, 1.9, half)], 1),
        np.stack([rng.uniform(-2.2, 2.2, N - half),
                  rng.uniform(-1.1, 1.8, N - half), np.full(N - half, 2.0)],
                 1)])
    o = np.tile([0.0, 0.5, -4.0], (N, 1))
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    t = rng.uniform(0.0, 0.0015, N).astype(np.float32)
    si_j = j_intersect(sa_j, JRay(_jv(o), _jv(d), jnp.asarray(t),
                                  jnp.full((N,), jnp.inf, jnp.float32)))
    si_t = t_intersect(sa_t, TRay(_tv(o), _tv(d), torch.from_numpy(t),
                                  torch.full((N,), float("inf"))))
    assert np.array_equal(si_t.prim.numpy(), np.asarray(si_j.prim))
    return si_t, si_j


def test_apply_normal_maps_matches_jax(compiled):
    """_apply_normal_maps on lanes that hit the normal-mapped wall and the
    bump-mapped floor: the shading frame and wi in it. Every lane on
    either surface is perturbed."""
    sa_t, sa_j = compiled("surface")
    si_t, si_j = _floor_and_wall_si(sa_t, sa_j, np.random.default_rng(41))
    out_t = ti._apply_normal_maps(sa_t, si_t)
    out_j = ji._apply_normal_maps(sa_j, si_j)
    for f in ("sh_n", "sh_s", "sh_t", "wi"):
        _close3(getattr(out_t, f), getattr(out_j, f), f)
    inst = si_t.inst.numpy()
    moved = np.abs(out_t.sh_n.y.numpy() - si_t.sh_n.y.numpy()) > 1e-4
    assert (inst == 1).sum() > 3000 and moved[inst == 1].mean() > 0.9
    moved = np.abs(out_t.sh_n.z.numpy() - si_t.sh_n.z.numpy()) > 1e-6
    assert (inst == 0).sum() > 3000 and moved[inst == 0].mean() > 0.9


@pytest.mark.parametrize("name,shape", [("surface", "rect"),
                                        ("surface", "sphere"),
                                        ("mesh_light", "mesh")])
def test_textured_emitters_match_jax(compiled, name, shape):
    """sample_direction from random points at random times (s_x chooses
    the emitter; the surface scene's sphere light moves), the weights
    carrying the texture at the sampled point's uv; pdf_direction of the
    JAX package's samples; eval_emitter_hit at random uvs."""
    sa_t, sa_j = compiled(name)
    rng = np.random.default_rng({"rect": 43, "sphere": 47, "mesh": 53}[shape])
    ne = sa_t.n_emitters
    which = {"rect": 0, "sphere": 1, "mesh": 1}[shape]
    p = rng.uniform([-2, -1.1, -1.5], [2, 0.6, 1.8], (N, 3)).astype(
        np.float32)
    t = rng.uniform(0.0, 0.0015, N).astype(np.float32)
    s = rng.random((N, 2)).astype(np.float32)
    s[:, 0] = (which + s[:, 0]) / ne
    ds_j, w_j = jem.sample_direction(sa_j, _jv(p), jnp.asarray(t),
                                     jnp.asarray(s[:, 0]),
                                     jnp.asarray(s[:, 1]))
    ds_t, w_t = tem.sample_direction(sa_t, _tv(p), torch.from_numpy(t),
                                     torch.from_numpy(s[:, 0]),
                                     torch.from_numpy(s[:, 1]))
    _close(ds_t.emitter, ds_j.emitter, "emitter", exact=True)
    assert np.all(np.asarray(ds_j.emitter) == which)
    for f in ("p", "n", "d"):
        _close3(getattr(ds_t, f), getattr(ds_j, f), f)
    _close(ds_t.pdf, ds_j.pdf, "pdf")
    _close3(w_t, w_j, "weight")
    # the texture shows: the radiance over the pdf varies beyond the pdf
    lit = np.asarray(ds_j.pdf) > 0
    rad = w_t.x.numpy()[lit] * ds_t.pdf.numpy()[lit]
    assert lit.sum() > N // 4 and rad.std() > 0.05 * rad.mean()
    vec = {k: np.stack([np.asarray(getattr(getattr(ds_j, k), c))
                        for c in "xyz"], 1) for k in ("p", "n", "d")}
    prim = rng.integers(0, sa_t.n_static_tris + sa_t.n_anim_tris,
                        N).astype(np.int32)
    pdf_j = jem.pdf_direction(sa_j, JDS(
        _jv(vec["p"]), _jv(vec["n"]), _jv(vec["d"]), ds_j.dist, ds_j.pdf,
        ds_j.delta, ds_j.emitter), prim=jnp.asarray(prim),
        time=jnp.asarray(t))
    pdf_t = tem.pdf_direction(sa_t, TDS(
        _tv(vec["p"]), _tv(vec["n"]), _tv(vec["d"]),
        torch.from_numpy(np.array(ds_j.dist)),
        torch.from_numpy(np.array(ds_j.pdf)),
        torch.from_numpy(np.array(ds_j.delta)),
        torch.from_numpy(np.array(ds_j.emitter))),
        prim=torch.from_numpy(prim), time=torch.from_numpy(t))
    _close(pdf_t, pdf_j, "pdf_direction")
    uv = rng.random((N, 2)).astype(np.float32)
    nrm = rng.standard_normal((N, 3)).astype(np.float32)
    towards = rng.standard_normal((N, 3)).astype(np.float32)
    lane = np.where(rng.random(N) < 0.8, which, -1).astype(np.int32)
    e_j = jem.eval_emitter_hit(sa_j, _jv(nrm), _jv(towards),
                               jnp.asarray(lane), uv_u=jnp.asarray(uv[:, 0]),
                               uv_v=jnp.asarray(uv[:, 1]))
    e_t = tem.eval_emitter_hit(sa_t, _tv(nrm), _tv(towards),
                               torch.from_numpy(lane),
                               torch.from_numpy(uv[:, 0]),
                               torch.from_numpy(uv[:, 1]))
    _close3(e_t, e_j, "eval_emitter_hit")
    # 0 off the front side, and more than one texture value (the
    # checkerboard has two)
    assert len(np.unique(e_t.x.numpy())) >= 3


@pytest.mark.parametrize("kind", [
    "normalmap", "bumpmap", "mesh_attribute", "volume", "rayleigh",
    "blendphase", "tabphase", "sggx"])
def test_load_dict_accepts_the_plugin(kind, files):
    """Each plugin of the slice loads through mt.load_dict in a scene of
    its own and compiles, as in the JAX package."""
    rect = {"type": "rectangle"}
    if kind in ("normalmap", "bumpmap"):
        rect["bsdf"] = {"type": kind, "bsdf": {"type": "diffuse"},
                        "map": {"type": "bitmap",
                                "filename": files["height"]}}
    elif kind == "mesh_attribute":
        rect = {"type": "ply", "filename": files["sphere"],
                "bsdf": {"type": "diffuse", "reflectance": {
                    "type": kind, "name": "vertex_color"}}}
    elif kind == "volume":
        rect["bsdf"] = {"type": "diffuse", "reflectance": {
            "type": kind, "volume": {"type": "gridvolume",
                                     "filename": files["tint"]}}}
    else:
        phase = {"rayleigh": {"type": kind},
                 "blendphase": {"type": kind, "a": {"type": "hg"},
                                "b": {"type": "isotropic"}},
                 "tabphase": {"type": kind, "values": "1, 2, 3"},
                 "sggx": {"type": kind, "S": {
                     "type": "constvolume",
                     "value": [1, 1, 0.1, 0, 0, 0]}}}[kind]
        rect = {"type": "cube", "bsdf": {"type": "null"},
                "interior": {"type": "homogeneous", "phase": phase}}
    scene = mt.load_dict({"type": "scene", "shape": rect,
                          "sensor": {"type": "perspective"}}, device="cpu")
    sa = scene.compile()
    assert sa.n_static_tris >= 2


def test_surface_render_matches_jax(files):
    """The surface scene's dopplertofpath at 16x16 x 16 spp, seed 0,
    rendered by the port with its TieRecorder hooked, then by the JAX
    package: no lane meets a tie or grazes an edge (none is left out of
    either film), and every value of the port's image is within rtol
    1e-4, atol 1e-4 * max|ref| of the JAX package's. The JAX package
    renders under jax.disable_jit(): 20 s against 32 s compiled on this
    machine, the images the same to 3e-6 of 0.33."""
    rec = TieRecorder(RES * RES * SPP, "cpu")
    with rec.hooked():
        img = mt.render(mt.load_dict(_scene_dict("surface", files, ttf,
                                                 TAnim), device="cpu"),
                        spp=SPP, seed=0).numpy()
    assert int(rec.marked.sum()) == 0
    with jax.disable_jit():
        ref = np.asarray(mj.render(mj.load_dict(_scene_dict(
            "surface", files, jtf, JAnim)), spp=SPP, seed=0))
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all()
    scale = np.abs(ref).max()
    assert scale > 0.0
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-4 * scale)
    bad = [(tuple(int(i) for i in ix), float(img[tuple(ix)]),
            float(ref[tuple(ix)])) for ix in np.argwhere(~close)]
    assert not bad, bad[:10]


def _uniform_lights(files, textured):
    """Rectangle, sphere and mesh area lights over a diffuse floor, each
    with its radiance as an rgb value or as a checkerboard of that value
    in both colours (whose every lookup is the value exactly)."""
    def radiance(v):
        if not textured:
            return {"type": "rgb", "value": v}
        return {"type": "checkerboard", "color0": {"type": "rgb", "value": v},
                "color1": {"type": "rgb", "value": v}}
    return {
        "type": "scene",
        "floor": {"type": "rectangle", "to_world": ttf.translate(
            [0, -1, 0]) @ ttf.rotate([1, 0, 0], -90) @ ttf.scale([4] * 3)},
        "rect": {"type": "rectangle", "to_world": ttf.translate(
            [1, 1, 0.5]) @ ttf.rotate([1, 0, 0], 90) @ ttf.scale([0.4] * 3),
                 "emitter": {"type": "area", "radiance": radiance(
                     [5.0, 4.0, 3.0])}},
        "ball": {"type": "sphere", "center": [-1, 0.2, 0.8], "radius": 0.3,
                 "emitter": {"type": "area", "radiance": radiance(
                     [2.0, 3.0, 6.0])}},
        "grid": {"type": "ply", "filename": files["light"],
                 "to_world": ttf.translate([0, 1.5, 1]) @ ttf.scale(
                     [0.5] * 3),
                 "emitter": {"type": "area", "radiance": radiance(
                     [3.0, 3.0, 3.0])}},
        "sensor": {"type": "perspective", "fov": 50,
                   "to_world": ttf.look_at([0, 1, -3], [0, 0, 0.5],
                                           [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": 16},
                   "sampler": {"type": "independent", "sample_count": 4}},
    }


@pytest.mark.parametrize("integrator", [
    {"type": "path", "max_depth": 3}, {"type": "ptracer", "max_depth": 3},
    {"type": "direct"}, {"type": "volpath", "max_depth": 3},
    {"type": "aov", "aovs": "dd:depth", "nested": {"type": "path"}}],
    ids=["path", "ptracer", "direct", "volpath", "aov"])
def test_uniform_texture_lights_equal_constant_lights(files, integrator):
    """Every integrator's emission through the textured-emitter code (at
    hits, in NEE and, for ptracer, on light paths from rectangles, spheres
    and meshes): lights whose checkerboard has one colour render the image
    of the same lights with that constant radiance, bit for bit."""
    imgs = [mt.render(mt.load_dict({**_uniform_lights(files, textured),
                                    "integrator": dict(integrator)},
                                   device="cpu"), spp=4, seed=3).numpy()
            for textured in (False, True)]
    assert np.abs(imgs[0]).max() > 0.0
    assert np.array_equal(imgs[0], imgs[1])
