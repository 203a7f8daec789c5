"""The PyTorch port's brute-force intersection (kernel B1's plain version,
mitsuba3dopplertof_tpu_torch/ops/intersect_kernel.py) against the JAX
package: its oracle ``render/scene.py:_hit_reference`` and the Pallas
kernel ``intersect_pallas`` / ``ray_test_pallas`` run in interpret mode on
the CPU, as tests/test_pallas_parity.py runs them. Both sides get the same
compiled tables (``from_jax_scene_arrays``) and the same rays, made with
numpy. Also B1's warp gate (its plain version ``b1_warp_masks``): it never
culls a slot that the exact test accepts. The CUDA kernel itself runs only
on the card (tests/test_torch_cuda.py)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu.core import transform as tf
from mitsuba3dopplertof_tpu.core.transform import AnimatedTransform
from mitsuba3dopplertof_tpu.core.vec import Vec3 as JVec3
from mitsuba3dopplertof_tpu.ops import intersect_kernel as jik
from mitsuba3dopplertof_tpu.render.scene import _hit_reference
from mitsuba3dopplertof_tpu.render.types import Ray as JRay

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.core.transform import \
    AnimatedTransform as TAnimatedTransform
from mitsuba3dopplertof_tpu_torch import emitters as tem
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3dopplertof_tpu_torch.core.warp import cosine_hemisphere_c
from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as tik
from mitsuba3dopplertof_tpu_torch.render.scene import build_si
from mitsuba3dopplertof_tpu_torch.sensors import sample_ray_kind
from mitsuba3dopplertof_tpu_torch.render.scene import (SceneArrays,
                                                       from_jax_scene_arrays)
from mitsuba3dopplertof_tpu_torch.render.types import Ray as TRay

from torch_threads import shared_cores  # noqa: F401 (autouse)

CANONICAL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes", "canonical", "scene.xml")


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port defaults to the card; these tests run on the CPU."""
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


def _scene_dict(animated=True, spheres=True, light=True,
                anim_cls=AnimatedTransform):
    """tests/test_pallas_parity.py::_scene (small regime), rebuilt here.
    ``anim_cls``: the AnimatedTransform of the package that loads it."""

    def _anim(m_from, m_to, t0=0.0, t1=1.0):
        return anim_cls([(t0, m_from), (t1, m_to)])

    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0, -6], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 8, "height": 8},
                   "sampler": {"type": "independent", "sample_count": 1}},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -2, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([4, 4, 1])},
        "back": {"type": "rectangle", "to_world": tf.translate([0, 0, 4])
                 @ tf.scale([4, 4, 1])},
    }
    if light:
        d["light"] = {"type": "point", "position": [0, 4, -4],
                      "intensity": {"type": "rgb", "value": 10.0}}
    if animated:
        d["mover"] = {"type": "cube", "to_world": _anim(
            tf.translate([-1.5, 0, 1]) @ tf.scale([0.5] * 3)
            @ tf.rotate([0, 1, 0], 10),
            tf.translate([-1.5, 1.0, 1]) @ tf.scale([0.5] * 3)
            @ tf.rotate([0, 1, 0], 55))}
        d["mover2"] = {"type": "cube", "to_world": _anim(
            tf.translate([1.2, -0.5, 0]) @ tf.scale([0.4] * 3),
            tf.translate([1.2, -0.5, 2]) @ tf.scale([0.4] * 3),
            t0=0.2, t1=0.8)}
    if spheres:
        d["ball"] = {"type": "sphere", "center": [0.0, 1.5, 1.0],
                     "radius": 0.6}
        d["movingball"] = {"type": "sphere", "to_world": _anim(
            tf.translate([0.5, -1.0, 0.5]) @ tf.scale([0.45] * 3),
            tf.translate([-0.5, -1.0, 0.5]) @ tf.scale([0.45] * 3))}
    return d


def _shell_rays(n, seed):
    """tests/test_pallas_parity.py::_rays: rays from a shell around the
    scene, a quarter of them with finite maxt, times in [0, 1]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3))
    o[:, 2] -= 5.0
    dd = rng.uniform(-2.0, 2.0, (n, 3)) - o
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    maxt = np.full(n, np.inf)
    k = n // 4
    maxt[:k] = rng.uniform(3.0, 9.0, k)
    return o, dd, rng.uniform(0.0, 1.0, n), maxt


def _box_rays(n, seed):
    """Rays inside the canonical Cornell box, times over its exposure."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3))
    o[:, 2] = rng.uniform(0.5, 3.5, n)
    dd = rng.uniform(-1.0, 1.0, (n, 3)) - o
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    maxt = np.full(n, np.inf)
    k = n // 4
    maxt[:k] = rng.uniform(0.5, 4.0, k)
    return o, dd, rng.uniform(0.0, 0.0015, n), maxt


def _both_rays(o, d, time, maxt):
    f32 = np.float32
    jr = JRay(JVec3(*(jnp.asarray(o[:, i], jnp.float32) for i in range(3))),
              JVec3(*(jnp.asarray(d[:, i], jnp.float32) for i in range(3))),
              jnp.asarray(time, jnp.float32), jnp.asarray(maxt, jnp.float32))
    tr = TRay(TVec3(*(torch.from_numpy(o[:, i].astype(f32))
                      for i in range(3))),
              TVec3(*(torch.from_numpy(d[:, i].astype(f32))
                      for i in range(3))),
              torch.from_numpy(time.astype(f32)),
              torch.from_numpy(maxt.astype(f32)))
    return jr, tr


def _port_tables(sa_j):
    arrays = {k: np.asarray(getattr(sa_j, k)) for k in SceneArrays.ARRAY_FIELDS}
    return from_jax_scene_arrays(arrays, sa_j)


def _np_hit(h):
    return {f: np.asarray(getattr(h, f)) for f in tik.HitRecord._fields}


def _assert_hits_match(hp, hr, label, rtol=2e-4, sphere_uv=True):
    """tests/test_pallas_parity.py::_assert_hits_match; with
    ``sphere_uv=False`` the uv of sphere hits is left out (the Pallas
    kernel's polynomial atan2/acos differ from atan2f/acosf by ~1e-5 rad)."""
    hp, hr = _np_hit(hp), _np_hit(hr)
    both_miss = (hp["prim"] < 0) & (hr["prim"] < 0)
    t_close = np.isclose(hp["t"], hr["t"], rtol=rtol, atol=1e-5) | both_miss
    assert t_close.all(), (label, "t mismatch", (~t_close).sum())
    same_prim = hp["prim"] == hr["prim"]
    m = same_prim & ~both_miss
    assert (hp["inst"][m] == hr["inst"][m]).all(), label
    for f in ("u", "v", "uv_u", "uv_v"):
        mm = m
        if f.startswith("uv") and not sphere_uv:
            mm = m & (hr["prim"] < tik._SPH_SLOT_BASE)
        assert np.allclose(hp[f][mm], hr[f][mm], rtol=1e-3, atol=1e-4), \
            (label, f)
    for pre in ("gn", "ns"):
        ap = np.stack([hp[pre + c][m] for c in "xyz"], -1)
        ar = np.stack([hr[pre + c][m] for c in "xyz"], -1)
        ap /= np.maximum(np.linalg.norm(ap, axis=-1, keepdims=True), 1e-20)
        ar /= np.maximum(np.linalg.norm(ar, axis=-1, keepdims=True), 1e-20)
        assert ((ap * ar).sum(-1) > 1.0 - 1e-4).all(), (label, pre)
    bad = ~same_prim & ~both_miss
    assert np.isclose(hp["t"][bad], hr["t"][bad], rtol=1e-3).all(), \
        (label, "prim mismatch at non-tie", bad.sum())
    return m.sum()


SCENES = {
    "static": dict(animated=False, spheres=False),
    "animated": dict(animated=True, spheres=False),
    "spheres": dict(animated=False, spheres=True),
    "animated_spheres": dict(animated=True, spheres=True),
}


@functools.lru_cache(maxsize=None)
def _load(name):
    """(JAX SceneArrays, numpy rays) of a scene, made once per process."""
    if name == "canonical":
        return mj.load_file(CANONICAL, spp=4, resx=8, resy=8).compile(), \
            _box_rays(1024, seed=21)
    return mj.load_dict(_scene_dict(**SCENES[name])).compile(), \
        _shell_rays(1024, seed=7)


@pytest.mark.parametrize("name", ["canonical"] + list(SCENES))
def test_plain_matches_jax_oracle(name):
    sa_j, rays = _load(name)
    jr, tr = _both_rays(*rays)
    sa_t = _port_tables(sa_j)
    hr = jax.jit(_hit_reference)(sa_j, jr)     # one compile, not per op
    n_hit = _assert_hits_match(tik.intersect_reference(sa_t, tr), hr,
                               f"{name} vs _hit_reference")
    assert n_hit > 200, "too few hits to test anything"
    # occlusion: exact
    occ_t = tik.ray_test_reference(sa_t, tr).numpy()
    assert (occ_t == (np.asarray(hr.prim) >= 0)).all()


def test_plain_matches_pallas_kernel():
    """Against the Pallas kernel itself on the main path's scene:
    closest-hit (interpret mode takes ~10 s a form on the CPU, so one
    form is compiled; the occlusion flag is the closest hit's ``prim >= 0`` on
    both sides, held against the kernel's closest hit here and against
    the oracle in ``test_plain_matches_jax_oracle``; the other scenes are
    held against the oracle only, and the JAX package's own tests hold the
    oracle against the Pallas kernel on them). The wrapper runs under one
    ``jax.jit``, as the package's render runs it: with a cold compile
    cache that compiles faster than the wrapper's ops one by one."""
    sa_j, rays = _load("canonical")
    jr, tr = _both_rays(*rays)
    sa_t = _port_tables(sa_j)
    hp = jax.jit(lambda r: jik.intersect_pallas(sa_j, r))(jr)
    _assert_hits_match(tik.intersect_reference(sa_t, tr), hp,
                       "canonical vs intersect_pallas", sphere_uv=False)
    assert (tik.ray_test_reference(sa_t, tr).numpy()
            == (np.asarray(hp.prim) >= 0)).all()


def test_plain_time_clamp_and_maxt():
    """Times outside the keyframe window clamp (transform.h:461-466); rays
    shorter than the first hit miss. (The scene and ray count of the
    oracle test's "animated" case, whose compile of the oracle this
    reuses.)"""
    sa_j, _ = _load("animated")
    n = 1024
    o = np.tile([[-1.5, 0.0, -6.0]], (n, 1))
    d = np.tile([[0.0, 0.0, 1.0]], (n, 1))
    times = np.random.default_rng(5).uniform(-1.0, 2.0, n)
    jr, tr = _both_rays(o, d, times, np.full(n, np.inf))
    sa_t = _port_tables(sa_j)
    _assert_hits_match(tik.intersect_reference(sa_t, tr),
                       jax.jit(_hit_reference)(sa_j, jr), "time clamp")
    short = tr._replace(maxt=torch.full((n,), 1e-3))
    assert (tik.intersect_reference(sa_t, short).prim == -1).all()
    assert not tik.ray_test_reference(sa_t, short).any()


@pytest.mark.parametrize("name", ["canonical", "animated_spheres"])
def test_kernel_tables_match_jax(name):
    """The tables the CUDA kernel reads are the Pallas kernel's (triangle,
    instance and sphere records), and the port compiles the same scene to
    the JAX package's SoA tables."""
    sa_j, _ = _load(name)
    tri, inst, anim, sph, sph_anim = tik.scene_tables(_port_tables(sa_j))
    tri_j, inst_j, sph_j = jik.scene_tables(sa_j)
    assert np.array_equal(tri.numpy(), np.asarray(tri_j))
    if sa_j.anim_ranges:
        assert np.array_equal(inst.numpy(), np.asarray(inst_j))
    assert anim.tolist() == [list(r) for r in sa_j.anim_ranges]
    if sa_j.n_spheres:
        assert np.array_equal(sph.numpy(), np.asarray(sph_j))
    assert sph_anim.tolist() == [int(a) for a in sa_j.sphere_animated]
    if name != "canonical":
        # the port's own compile, point light and chunk boxes included
        sa_p = mt.load_dict(_scene_dict(
            anim_cls=TAnimatedTransform)).compile()
        for k in SceneArrays.ARRAY_FIELDS + ["chunk_aabb"]:
            assert np.array_equal(getattr(sa_p, k).numpy(),
                                  np.asarray(getattr(sa_j, k))), k


def test_wrapper_routes_cpu_to_plain_and_counts_only_launches():
    sa_j, rays = _load("canonical")
    _, tr = _both_rays(*rays)
    sa_t = _port_tables(sa_j)
    tik.reset_launch_counts()
    h = tik.intersect(sa_t, tr)
    occ = tik.ray_test(sa_t, tr)
    assert tik.LAUNCHES == 0
    ref = tik.intersect_reference(sa_t, tr)
    for a, b in zip(h, ref):
        assert torch.equal(a, b)
    assert torch.equal(occ, ref.prim >= 0)
    # the kernel path takes CUDA tensors only: no silent CPU fallback
    with pytest.raises(ValueError, match="need CUDA"):
        tik._launch(sa_t, tr, any_hit=False)
    with pytest.raises(ValueError, match="float32"):
        tik.intersect(sa_t, tr._replace(time=tr.time.double()))


def test_large_scene_raises(monkeypatch):
    """Above STREAM_THRESHOLD every value of MI_STREAM_KERNEL selects a
    ported route (v4 -> B2, v3 -> B5, v2 -> B4, mxu -> B6, v1 and any
    other value -> B3) and none raises; the two-round forms of B2
    (MI_V4_ROUNDS=lite|2) are not ported and raise, naming their ROADMAP
    item, instead of running the single walk in their place. Scenes of at
    most 192 triangles never ask."""
    sa_j, rays = _load("static")
    sa_t = _port_tables(sa_j)
    _, tr = _both_rays(*rays)
    for choice, route in (("v1", "v1"), ("v2", "v2"), ("v3", "v3"),
                          ("mxu", "mxu"), ("v4", "v4"), ("bvh", "v1")):
        monkeypatch.setenv("MI_STREAM_KERNEL", choice)
        assert tik.stream_kernel() == route
    monkeypatch.delenv("MI_STREAM_KERNEL")
    assert tik.stream_kernel() == "v4"
    for rounds in ("lite", "2"):
        monkeypatch.setenv("MI_V4_ROUNDS", rounds)
        tik.intersect(sa_t, tr)           # at most 192 triangles: B1
        sa_t.n_static_tris = tik.STREAM_THRESHOLD + 1
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
            tik.intersect(sa_t, tr)
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
            tik.ray_test(sa_t, tr)
        sa_t.n_static_tris = sa_j.n_static_tris
        monkeypatch.setenv("MI_STREAM_KERNEL", "v3")
        assert tik.stream_kernel() == "v3"    # only B2 has rounds
        monkeypatch.delenv("MI_STREAM_KERNEL")


@functools.lru_cache(maxsize=None)
def _canonical_wavefronts(n=4096, spp=64, seed=3):
    """The port's canonical scene on the CPU and its wavefronts: camera
    rays of ``spp`` lanes a pixel in pixel order from the middle of the
    frame (as a strip pass numbers its lanes, so that a warp holds one
    pixel's samples), the shadow rays from their hits toward light samples
    and the diffuse bounce rays from them; lanes whose camera ray missed
    are dead (maxt -1). Offsets, times and samples drawn with numpy."""
    scene = mt.load_file(CANONICAL, device="cpu")
    sa = scene.compile("cpu")
    W, H = scene.sensor.film.crop_size
    rng = np.random.default_rng(seed)
    pix = (H // 2 * W + W // 2 - n // spp // 2) + np.arange(n) // spp
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    cam, _ = sample_ray_kind(
        scene.sensor.device_params(), None, f32(rng.uniform(0.0, 0.0015, n)),
        f32(((pix % W) + rng.uniform(0.0, 1.0, n)) / W),
        f32(((pix // W) + rng.uniform(0.0, 1.0, n)) / H))
    u = f32(rng.uniform(0.0, 1.0, (4, n)))
    si = build_si(sa, cam, tik.intersect_reference(sa, cam))
    ds, _ = tem.sample_direction(sa, si.p, cam.time, u[0], u[1])
    dead = lambda r: r._replace(maxt=torch.where(si.valid, r.maxt, -1.0))
    return sa, {"camera": cam, "shadow": dead(si.spawn_ray_to(ds.p)),
                "bounce": dead(si.spawn_ray(si.to_world(
                    cosine_hemisphere_c(u[2], u[3]))))}


def _bundle_rays(n, seed):
    """Coherent rays: per 32 lanes, origins within 0.05 of a point on the
    shell of ``_shell_rays`` and directions toward points within 0.3 of a
    target in the scene; times in [0, 1], a quarter at finite maxt."""
    rng = np.random.default_rng(seed)
    w = n // 32
    o = np.repeat(rng.uniform(-3.0, 3.0, (w, 3)) - [0.0, 0.0, 5.0], 32, 0)
    tgt = np.repeat(rng.uniform(-2.0, 2.0, (w, 3)), 32, 0)
    dd = tgt + rng.uniform(-0.3, 0.3, (n, 3)) - o
    o = o + rng.uniform(-0.05, 0.05, (n, 3))
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    maxt = np.where(rng.random(n) < 0.25, rng.uniform(3.0, 9.0, n), np.inf)
    return o, dd, rng.uniform(0.0, 1.0, n), maxt


@pytest.mark.parametrize("wavefront", ["camera", "bounce", "shadow",
                                       "spheres"])
def test_gate_is_conservative(wavefront):
    """B1's gate never culls a slot that the exact test accepts for a lane
    of the warp (any t in (0, maxt), not only the closest): on the
    canonical scene's camera, bounce and shadow wavefronts, and on coherent
    rays through the scene of animated cubes and spheres. The coherent
    wavefronts cull slots, a camera warp most of the 34; diffuse bounce
    rays, whose directions straddle zero on two axes, run no slab
    tests."""
    if wavefront == "spheres":
        sa_j, _ = _load("animated_spheres")
        sa = _port_tables(sa_j)
        _, ray = _both_rays(*_bundle_rays(2048, seed=5))
    else:
        sa, rays = _canonical_wavefronts()
        ray = rays[wavefront]
    hits = tik.slot_hits(sa, ray)
    n, n_slots = hits.shape
    assert n_slots == (sa.n_static_tris + sa.n_anim_tris + sa.n_spheres)
    assert int(hits.any(1).sum()) > n // 10
    m = tik.b1_warp_masks(sa, ray)
    assert m.slots.shape == (n // 32, n_slots)
    culled = hits & ~m.slots.repeat_interleave(32, dim=0)
    assert not culled.any(), int(culled.sum())
    mean = float(m.slots.sum(1).float().mean())
    if wavefront != "bounce":
        assert mean < 0.8 * n_slots, mean
    if wavefront == "camera":
        assert mean < 12.0, mean           # 8.9 of 34 when written
