"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels B1-B6
(csrc/intersect_bruteforce.cu, intersect_v4.cu, intersect_stream.cu,
intersect_v2.cu, intersect_v3.cu, intersect_mxu.cu) against their plain
PyTorch versions, and small renders on the card, through every
large-scene route, against the same renders on the CPU. They skip without
a card. This file imports only the port (no jax), so it also runs on a
machine without the JAX package:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.core import transform as tf
from mitsuba3dopplertof_tpu_torch.core.transform import AnimatedTransform
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3
from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as ik
from mitsuba3dopplertof_tpu_torch.ops import intersect_mxu as mxu
from mitsuba3dopplertof_tpu_torch.ops import intersect_stream as stream
from mitsuba3dopplertof_tpu_torch.ops import intersect_v2 as v2
from mitsuba3dopplertof_tpu_torch.ops import intersect_v3 as v3
from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as v4
from mitsuba3dopplertof_tpu_torch.ops.intersect_mxu import payload_from_prim
from mitsuba3dopplertof_tpu_torch.ops.ray_binning import binned
from mitsuba3dopplertof_tpu_torch.render.types import Ray
from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
    ANIMATED_SIZES, animated_mesh_scene, deep_path_scene, static_mesh_scene,
    write_uv_sphere_obj, write_uv_sphere_ply)

from torch_adversarial_rays import (adversarial_rays, ballot_rays,
                                    equal_t_tables, equal_t_v2_tables,
                                    equal_t_v4_tables)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(ROOT, "scenes", "canonical", "scene.xml")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sphere_scene(device):
    def anim(a, b, t0=0.0, t1=1.0):
        return AnimatedTransform([(t0, a), (t1, b)])
    return mt.load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0, -6], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 8, "height": 8}},
        "floor": {"type": "rectangle", "to_world": tf.translate([0, -2, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([4, 4, 1])},
        "mover": {"type": "cube", "to_world": anim(
            tf.translate([-1.5, 0, 1]) @ tf.scale([0.5] * 3),
            tf.translate([-1.5, 1.0, 1]) @ tf.scale([0.5] * 3), 0.2, 0.8)},
        "ball": {"type": "sphere", "center": [0.0, 1.5, 1.0], "radius": 0.6},
        "movingball": {"type": "sphere", "to_world": anim(
            tf.translate([0.5, -1.0, 0.5]) @ tf.scale([0.45] * 3),
            tf.translate([-0.5, -1.0, 0.5]) @ tf.scale([0.45] * 3))},
    }, device=device)


def _rays(n, seed, device, z0, tmax):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3))
    o[:, 2] = z0
    d = rng.uniform(-1.0, 1.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.where(np.arange(n) < n // 4, rng.uniform(1.0, 9.0, n), np.inf)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return Ray(Vec3(*(f(o[:, i]) for i in range(3))),
               Vec3(*(f(d[:, i]) for i in range(3))),
               f(rng.uniform(0.0, tmax, n)), f(maxt))


def _canonical_wavefront(kind, device, n=1 << 16, spp=256, seed=3):
    """The canonical scene and one of its wavefronts at the main path's
    layout: camera rays of ``spp`` lanes a pixel in pixel order from the
    middle of the frame, the shadow rays from their hits toward light
    samples, or the diffuse bounce rays from them (lanes whose camera ray
    missed dead, maxt -1). Offsets, times and samples drawn with numpy."""
    from mitsuba3dopplertof_tpu_torch import emitters as em
    from mitsuba3dopplertof_tpu_torch.core.warp import cosine_hemisphere_c
    from mitsuba3dopplertof_tpu_torch.render.scene import build_si
    from mitsuba3dopplertof_tpu_torch.sensors import sample_ray_kind
    scene = mt.load_file(CANONICAL, device=device)
    sa = scene.compile()
    W, H = scene.sensor.film.crop_size
    rng = np.random.default_rng(seed)
    pix = (H // 2 * W + W // 2 - n // spp // 2) + np.arange(n) // spp
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    cam, _ = sample_ray_kind(
        scene.sensor.device_params(), None, f(rng.uniform(0.0, 0.0015, n)),
        f(((pix % W) + rng.uniform(0.0, 1.0, n)) / W),
        f(((pix // W) + rng.uniform(0.0, 1.0, n)) / H))
    if kind == "camera":
        return sa, cam
    u = f(rng.uniform(0.0, 1.0, (4, n)))
    si = build_si(sa, cam, ik.intersect_reference(sa, cam))
    if kind == "shadow":
        ds, _ = em.sample_direction(sa, si.p, cam.time, u[0], u[1])
        ray = si.spawn_ray_to(ds.p)
    else:
        ray = si.spawn_ray(si.to_world(cosine_hemisphere_c(u[2], u[3])))
    return sa, ray._replace(maxt=torch.where(si.valid, ray.maxt, -1.0))


@pytest.mark.parametrize("which", ["canonical", "spheres", "camera",
                                   "bounce", "shadow"])
def test_kernel_matches_plain(cuda, which):
    """B1 against its plain version at 65,536 lanes: random rays in the
    canonical scene, rays through a scene of spheres and animated cubes,
    and the canonical scene's camera, bounce and shadow wavefronts, whose
    warps the gate culls (camera, shadow) or mostly cannot (bounce)."""
    if which == "canonical":
        sa = mt.load_file(CANONICAL, device=cuda).compile()
        ray = _rays(1 << 16, 1, cuda, 3.5, 0.0015)
    elif which == "spheres":
        sa = _sphere_scene(cuda).compile()
        ray = _rays(1 << 16, 2, cuda, -6.0, 1.0)
    else:
        sa, ray = _canonical_wavefront(which, cuda)
    ik.reset_launch_counts()
    hk = ik.intersect(sa, ray)
    occ = ik.ray_test(sa, ray)
    torch.cuda.synchronize()
    assert ik.LAUNCHES_BY_FORM == {"closest_hit": 1, "any_hit": 1}
    hr = ik.intersect_reference(sa, ray)
    hit = hr.prim >= 0
    assert torch.equal(hk.prim, hr.prim)
    assert torch.equal(occ, hit)
    assert int(hit.sum()) > 1000
    tri = hit & (hr.prim < ik._SPH_SLOT_BASE)
    # triangles: built with --fmad=false, bit for bit the plain version
    for a, b in zip(hk, hr):
        assert torch.equal(a[tri], b[tri])
    # spheres: the same function, up to atan2f/acosf rounding
    sph = hit & ~tri
    for a, b in zip(hk, hr):
        assert torch.allclose(a[sph].float(), b[sph].float(), rtol=1e-5,
                              atol=1e-6)


def test_render_on_card_matches_cpu(cuda):
    """16x16 x 16 spp: the card against the CPU within the slice test's
    tolerance on >= 99% of values (cos/sin/exp/rsqrt differ in their last
    bits between the devices)."""
    imgs = [mt.render(mt.load_file(CANONICAL, device=dev, spp=16, resx=16,
                                   resy=16), spp=16, seed=0).cpu().numpy()
            for dev in (cuda, "cpu")]
    g, c = imgs
    scale = np.abs(c).max()
    close = np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale)
    assert close.mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())


def _mesh_scene(device, tmp_path, animated, nu=48, nv=32, spp=4, res=16):
    """bench_suite's animated (dopplertofpath) or static (path) UV-sphere
    scene, 2 nu nv triangles."""
    obj = tmp_path / f"sph_{nu}x{nv}.obj"
    write_uv_sphere_obj(str(obj), nu, nv)
    d = (animated_mesh_scene(str(obj), spp=spp, res=res) if animated
         else static_mesh_scene(str(obj), spp=spp, res=res))
    return mt.load_dict(d, device=device)


@pytest.mark.parametrize("animated", [True, False])
def test_v4_kernel_matches_plain(cuda, tmp_path, animated):
    """B2 against its plain version on 3,072 triangles: the same lanes hit
    (closest-hit and any-hit), t bit for bit on hit lanes (--fmad=false,
    the same order of operations), prim different only where t ties (the
    kernel keeps the smallest slot among equal t, as the plain version);
    the kernel over binned rays gives the same result."""
    sa = _mesh_scene(cuda, tmp_path, animated).compile()
    assert sa.n_static_tris + sa.n_anim_tris > ik.STREAM_THRESHOLD
    ray = _rays(1 << 16, 3, cuda, -4.0, 0.0015 if animated else 0.0)
    v4.reset_launch_counts()
    t_k, p_k = v4.intersect_v4(sa, ray)
    _, p_any = v4.intersect_v4(sa, ray, any_hit=True)
    torch.cuda.synchronize()
    assert v4.LAUNCHES_BY_FORM == {"closest_hit": 1, "any_hit": 1}
    t_r, p_r = v4.intersect_v4_reference(sa, ray)
    hit = p_r >= 0
    assert int(hit.sum()) > 5000
    assert torch.equal(p_k >= 0, hit) and torch.equal(p_any >= 0, hit)
    assert torch.equal(t_k[hit], t_r[hit])
    differ = p_k != p_r
    assert int(differ.sum()) <= 20
    assert torch.equal(t_k[differ], t_r[differ])
    t_b, p_b = binned(sa, ray, None, lambda r: list(v4.intersect_v4(sa, r)))
    assert torch.equal(t_b, t_k)
    assert int((p_b != p_k).sum()) <= 20


@pytest.mark.parametrize("cap", [None, 8])
def test_v4_lists_match_visit_order(cuda, tmp_path, cap):
    """The kernel's visit lists (``mi_intersect_v4_lists``, built by the
    same device code as the walk's) against ``_unit_visit_order`` on
    ``prepare``'s inputs: order and t_lo bit for bit, the reachable count
    per block; with a capacity of 8 entries every block takes rounds. The
    walk with that capacity still equals the plain version on hit lanes."""
    sa = _mesh_scene(cuda, tmp_path, True).compile()
    tables = v4.v4_tables(sa)
    ray = _rays((1 << 14) + 100, 5, cuda, -4.0, 0.0015)   # a ragged block
    order_k, tlo_k, len_k = v4.lists(tables, ray, cap)
    order_r, tlo_r = v4.prepare(tables, ray)[4:]
    assert torch.equal(order_k, order_r)
    assert torch.equal(tlo_k.view(torch.int32), tlo_r.view(torch.int32))
    assert torch.equal(len_k, (tlo_r < 3.0e38).sum(dim=1, dtype=torch.int32))
    assert int(len_k.max()) > 8 and int(len_k.min()) < tables.n_units
    for any_hit in (False, True):
        t_k, p_k = v4.launch(tables, ray, any_hit, cap=cap)
        t_r, p_r = v4.intersect_v4_reference(sa, ray)
        hit = p_r >= 0
        assert torch.equal(p_k >= 0, hit)
        if not any_hit:
            assert torch.equal(t_k[hit], t_r[hit])


def test_v4_query_builds_no_lists(cuda, tmp_path, monkeypatch):
    """On the card ``intersect_v4`` and the large-scene route launch B2
    once a query and build no visit lists in PyTorch: ``prepare`` and
    ``_unit_visit_order`` are never called."""
    sa = _mesh_scene(cuda, tmp_path, True).compile()
    ray = _rays(1 << 14, 6, cuda, -4.0, 0.0015)

    def spy(*args, **kwargs):
        raise AssertionError("B2 built its visit lists in PyTorch")
    monkeypatch.setattr(v4, "prepare", spy)
    monkeypatch.setattr(v4, "_unit_visit_order", spy)
    monkeypatch.setattr(v3, "_unit_visit_order", spy)
    v4.reset_launch_counts()
    v4.intersect_v4(sa, ray)
    v4.intersect_v4(sa, ray, any_hit=True)
    ik.intersect(sa, ray)
    ik.ray_test(sa, ray)
    torch.cuda.synchronize()
    assert v4.LAUNCHES_BY_FORM == {"closest_hit": 2, "any_hit": 2}


@pytest.mark.parametrize("animated", [True, False])
def test_v4_kernel_matches_plain_on_adversarial_rays(cuda, tmp_path,
                                                     animated):
    """B2, whose scene-box clamp of maxt (``scene_exit``) lives in
    csrc/intersect_common.cuh, which B4 shares, against its plain version
    on 65,536 ``adversarial_rays``: a quarter of them end within 0.1% of
    their target, and a fifth start about 1e3 away, far outside the scene
    box. The same lanes hit in both forms, t bit for bit on every hit
    lane, a different prim only where t ties."""
    sa = _mesh_scene(cuda, tmp_path, animated).compile()
    ray = adversarial_rays(sa, 1 << 16, 8, cuda)
    t_k, p_k = v4.intersect_v4(sa, ray)
    _, p_any = v4.intersect_v4(sa, ray, any_hit=True)
    torch.cuda.synchronize()
    t_r, p_r = v4.intersect_v4_reference(sa, ray)
    hit = p_r >= 0
    assert int(hit.sum()) > 5000
    assert torch.equal(p_k >= 0, hit) and torch.equal(p_any >= 0, hit)
    assert torch.equal(t_k[hit], t_r[hit])
    assert int((p_k != p_r).sum()) <= 20


# B4's card cases: adversarial rays, dead lanes, an equal-t copy of a
# quarter in a chunk that the walks reach first (made in a chunk of its
# own, so in either scene), lists of 3 chunks a round
V2_CASES = ["adversarial", "dead", "equal_t", "rounds"]


@pytest.mark.parametrize("case", V2_CASES)
@pytest.mark.parametrize("animated", [True, False])
def test_v2_kernel_matches_plain(cuda, tmp_path, monkeypatch, animated,
                                 case):
    """B4 (chunk lists built in the kernel, warps walking on their own
    bounds, each walk shared by the CTA's warps a quarter at a time)
    against its plain version on 3,072 triangles: 65,536
    ``adversarial_rays``; a ragged wavefront (65,436 lanes) with every
    seventh lane, one whole warp and one whole block dead (maxt -1); the
    triangles of one quarter copied into a new chunk whose box is the
    scene's (``equal_t_v2_tables``: equal t in two chunks, the smaller
    slot must win wherever the walks reach the copy first); and lists of 3
    chunks a round (25 chunks: 9 rounds). Closest-hit: t bit for bit and
    prim equal on every lane; any-hit: occlusion exact."""
    sa = _mesh_scene(cuda, tmp_path, animated).compile()
    tmax = 0.0015 if animated else 0.0
    if case == "equal_t":
        ray = _rays(1 << 16, 10, cuda, -4.0, tmax)
    elif case == "dead":
        ray = _rays((1 << 16) - 100, 9, cuda, -4.0, tmax)
        lane = torch.arange(ray.maxt.shape[0], device=cuda)
        dead = (lane % 7 == 3) | ((lane >= 64) & (lane < 96)) \
            | ((lane >= 512) & (lane < 768))
        ray = ray._replace(maxt=torch.where(dead, -1.0, ray.maxt))
    else:
        ray = adversarial_rays(sa, 1 << 16, 12, cuda)
    tables = v2.v2_tables(sa)
    if case == "equal_t":
        tables, k, c = equal_t_v2_tables(
            tables, v2.intersect_v2_reference(sa, ray)[1],
            v2.chunk_keys(tables, ray))
        monkeypatch.setitem(sa._cache, "v2", tables)
    cap = 3 if case == "rounds" else None
    v2.reset_launch_counts()
    t_k, p_k = v2.launch(tables, ray, False, cap=cap)
    _, p_any = v2.launch(tables, ray, True, cap=cap)
    torch.cuda.synchronize()
    assert v2.LAUNCHES_BY_FORM == {"closest_hit": 1, "any_hit": 1}
    t_r, p_r = v2.intersect_v2_reference(sa, ray)
    hit = p_r >= 0
    assert int(hit.sum()) > 5000
    assert torch.equal(p_k >= 0, hit) and torch.equal(p_any >= 0, hit)
    assert torch.equal(t_k[hit], t_r[hit])
    assert torch.equal(p_k, p_r)
    if case == "equal_t":
        q = tables.slots[32 * k:32 * k + 32]
        copied = torch.isin(p_r, q) & hit
        keys = v2.chunk_keys(tables, ray)
        first = (keys[:, c] < keys[:, k // 4]).repeat_interleave(
            v2.BLOCK)[:ray.maxt.shape[0]]
        assert int((copied & first).sum()) > 100
    if case == "rounds":
        assert -(-tables.n_chunks // cap) > 1


@pytest.mark.parametrize("cap", [None, 2])
def test_v2_lists_match_visit_order(cuda, tmp_path, cap):
    """B4's in-kernel visit lists (``intersect_v2.lists``, built by the
    same device code as the walk's) against ``_visit_order`` on
    ``prepare``'s inputs and against their plain version
    (``v2_lists_reference``): order and t_lo bit for bit, the reachable
    count per block; with a capacity of 2 chunks every block takes
    rounds, and a block of dead lanes reaches none."""
    sa = _mesh_scene(cuda, tmp_path, True).compile()
    tables = v2.v2_tables(sa)
    ray = _rays((1 << 14) + 100, 5, cuda, -4.0, 0.0015)   # a ragged block
    lane = torch.arange(ray.maxt.shape[0], device=cuda)
    ray = ray._replace(maxt=torch.where((lane >= 256) & (lane < 512), -1.0,
                                        ray.maxt))
    order_k, tlo_k, len_k = v2.lists(tables, ray, cap)
    order_r, tlo_r = v2.prepare(tables, ray)[4:]
    assert torch.equal(order_k, order_r)
    assert torch.equal(tlo_k.view(torch.int32), tlo_r.view(torch.int32))
    assert torch.equal(len_k, (tlo_r < 3.0e38).sum(dim=1, dtype=torch.int32))
    assert int(len_k.max()) > 2 and int(len_k[1]) == 0
    order_p, tlo_p, len_p = v2.v2_lists_reference(tables, ray, cap)
    assert torch.equal(order_p, order_k) and torch.equal(len_p, len_k)
    assert torch.equal(tlo_p.view(torch.int32), tlo_k.view(torch.int32))


def test_v2_query_builds_no_lists(cuda, tmp_path, monkeypatch):
    """On the card ``intersect_v2`` and the ``v2`` route launch B4 once a
    query and build no visit lists in PyTorch: ``prepare`` and
    ``_visit_order`` are never called."""
    sa = _mesh_scene(cuda, tmp_path, True).compile()
    ray = _rays(1 << 14, 6, cuda, -4.0, 0.0015)

    def spy(*args, **kwargs):
        raise AssertionError("B4 built its visit lists in PyTorch")
    monkeypatch.setattr(v2, "prepare", spy)
    monkeypatch.setattr(v2, "_visit_order", spy)
    monkeypatch.setattr(mxu, "_visit_order", spy)
    monkeypatch.setenv("MI_STREAM_KERNEL", "v2")
    v2.reset_launch_counts()
    v2.intersect_v2(sa, ray)
    v2.intersect_v2(sa, ray, any_hit=True)
    ik.intersect(sa, ray)
    ik.ray_test(sa, ray)
    torch.cuda.synchronize()
    assert v2.LAUNCHES_BY_FORM == {"closest_hit": 2, "any_hit": 2}


def test_large_scene_route_matches_plain(cuda, tmp_path):
    """The card's large-scene route (binned B2, payload, B1's spheres-only
    pass) against the same route built from plain versions (B2's plain
    version, the payload rebuild, the plain spheres): equal on triangle
    hits, spheres within atan2f/acosf rounding. Against the plain Möller
    intersector: the same lanes hit, t to 2e-4, the same prim on > 99% of
    hits, and barycentrics of equal prims within 1e-3 on >= 99.9% of them
    (the rebuild solves a 2x2 Gram system at the hit point, which loses
    digits on sliver triangles near the poles)."""
    obj = tmp_path / "sph_48x32.obj"
    write_uv_sphere_obj(str(obj), 48, 32)
    d = animated_mesh_scene(str(obj), spp=4, res=16)
    d["ball"] = {"type": "sphere", "center": [1.2, 0.2, 0.5], "radius": 0.4}
    sa = mt.load_dict(d, device=cuda).compile()
    ray = _rays(1 << 16, 4, cuda, -4.0, 0.0015)
    ik.reset_launch_counts()
    v4.reset_launch_counts()
    hk = ik.intersect(sa, ray)
    occ = ik.ray_test(sa, ray)
    torch.cuda.synchronize()
    assert ik.LAUNCHES_BY_FORM == {"closest_hit": 1, "any_hit": 1}
    assert v4.LAUNCHES_BY_FORM == {"closest_hit": 1, "any_hit": 1}

    t_p, p_p = v4.intersect_v4_reference(sa, ray)
    hp = payload_from_prim(sa, ray, t_p, p_p)
    hp = ik._spheres_reference(sa, ray, hp)
    tri = (hp.prim >= 0) & (hp.prim < ik._SPH_SLOT_BASE) \
        & (hk.prim == hp.prim)
    assert int(tri.sum()) > 0.99 * int(((hp.prim >= 0)
                                        & (hp.prim < ik._SPH_SLOT_BASE)).sum())
    for a, b in zip(hk, hp):
        assert torch.equal(a[tri], b[tri])
    sph = hp.prim >= ik._SPH_SLOT_BASE
    assert torch.equal(hk.prim[sph], hp.prim[sph])
    for a, b in zip(hk, hp):
        assert torch.allclose(a[sph].float(), b[sph].float(), rtol=1e-5,
                              atol=1e-6)

    hr = ik.intersect_reference(sa, ray)
    hit = hr.prim >= 0
    assert torch.equal(hk.prim >= 0, hit) and torch.equal(occ, hit)
    assert torch.allclose(hk.t[hit], hr.t[hit], rtol=2e-4, atol=1e-5)
    same = hit & (hk.prim == hr.prim)
    assert int(same.sum()) > 0.99 * int(hit.sum())
    assert torch.equal(hk.inst[same], hr.inst[same])
    m = same & (hr.prim < ik._SPH_SLOT_BASE)
    for f in ("u", "v", "uv_u", "uv_v"):
        close = torch.isclose(getattr(hk, f)[m], getattr(hr, f)[m],
                              rtol=1e-3, atol=1e-4)
        assert close.float().mean() >= 0.999, f
    assert int((hr.prim >= ik._SPH_SLOT_BASE).sum()) > 100


def test_large_scene_render_on_card_matches_cpu(cuda, tmp_path):
    """The 2k animated-mesh scene (32x32 sphere) at 16x16 x 16 spp: the
    card against the CPU within test_render_on_card_matches_cpu's
    tolerance (Woop + Gram barycentrics on the card, Möller on the CPU)."""
    imgs = [mt.render(_mesh_scene(dev, tmp_path, True, 32, 32, 16, 16),
                      spp=16, seed=0).cpu().numpy()
            for dev in (cuda, "cpu")]
    g, c = imgs
    scale = np.abs(c).max()
    close = np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale)
    assert close.mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())


# the alternate large-scene routes: MI_STREAM_KERNEL value -> (module,
# wrapper, plain version)
ALTERNATES = {
    "v3": (v3, v3.intersect_v3, v3.intersect_v3_reference),
    "v2": (v2, v2.intersect_v2, v2.intersect_v2_reference),
    "v1": (stream, stream.intersect_stream,
           stream.intersect_stream_reference),
    "mxu": (mxu, mxu.intersect_mxu, mxu.intersect_mxu_reference),
}


@pytest.mark.parametrize("animated", [True, False])
@pytest.mark.parametrize("route", list(ALTERNATES))
def test_alternate_kernel_matches_plain(cuda, tmp_path, route, animated):
    """B5, B4, B3 and B6 against their plain versions on 3,072 triangles:
    the same lanes hit (closest-hit and any-hit), t bit for bit on hit
    lanes (--fmad=false, the same order of operations), prim different
    only where t ties (B3 takes chunks in table order: no lane differs);
    B3's whole hit record bit for bit; the kernel over binned rays gives
    the same result."""
    mod, isect, plain = ALTERNATES[route]
    sa = _mesh_scene(cuda, tmp_path, animated).compile()
    ray = _rays(1 << 16, 3, cuda, -4.0, 0.0015 if animated else 0.0)
    mod.reset_launch_counts()
    v4.reset_launch_counts()
    out_k = isect(sa, ray)
    _, p_any = isect(sa, ray, any_hit=True)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_BY_FORM == {"closest_hit": 1, "any_hit": 1}
    assert v4.LAUNCHES == 0
    out_r = plain(sa, ray)
    t_k, p_k, t_r, p_r = out_k[0], out_k[1], out_r[0], out_r[1]
    hit = p_r >= 0
    assert int(hit.sum()) > 5000
    assert torch.equal(p_k >= 0, hit) and torch.equal(p_any >= 0, hit)
    assert torch.equal(t_k[hit], t_r[hit])
    assert int((p_k != p_r).sum()) <= (0 if route == "v1" else 20)
    if route == "v1":
        for a, b in zip(out_k, out_r):
            assert torch.equal(a, b)
    out_b = binned(sa, ray, None, lambda r: list(isect(sa, r)))
    assert torch.equal(out_b[0], t_k)
    assert int((out_b[1] != p_k).sum()) <= 20


@pytest.mark.parametrize("route", list(ALTERNATES))
def test_alternate_route_render_on_card_matches_cpu(cuda, tmp_path,
                                                    monkeypatch, route):
    """The 2k animated-mesh scene at 16x16 x 16 spp with MI_STREAM_KERNEL
    set: the card (the route's kernel, never B2) against the CPU (the
    route's plain version) within test_render_on_card_matches_cpu's
    tolerance."""
    monkeypatch.setenv("MI_STREAM_KERNEL", route)
    mod = ALTERNATES[route][0]
    mod.reset_launch_counts()
    v4.reset_launch_counts()
    imgs = [mt.render(_mesh_scene(dev, tmp_path, True, 32, 32, 16, 16),
                      spp=16, seed=0).cpu().numpy()
            for dev in (cuda, "cpu")]
    assert min(mod.LAUNCHES_BY_FORM.values()) > 0 and v4.LAUNCHES == 0
    g, c = imgs
    scale = np.abs(c).max()
    close = np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale)
    assert close.mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())


@pytest.mark.parametrize("animated", [True, False])
def test_mxu_kernel_matches_plain_on_adversarial_rays(cuda, tmp_path,
                                                      animated):
    """B6 (its tensor-core gate ahead of the exact test) against its plain
    version on 65,536 ``adversarial_rays`` of 3,072 triangles: the same
    lanes hit in both forms (any-hit occlusion exact), t bit for bit on
    every hit lane, and a different prim only where t ties bit for bit
    (rays through shared edges and vertices tie often; the kernel keeps
    the first chunk it visits among equal t, the plain version the lowest
    slot). The gate's plain version (``mxu_gate_reference``) passes some
    of these rays' pairs to the exact test, not all."""
    sa = _mesh_scene(cuda, tmp_path, animated).compile()
    ray = adversarial_rays(sa, 1 << 16, 8, cuda)
    tables = mxu.mxu_tables(sa)
    prep = mxu.prepare(tables, ray)
    mxu.reset_launch_counts()
    t_k, p_k = mxu.launch(tables, prep, False)
    _, p_any = mxu.launch(tables, prep, True)
    torch.cuda.synchronize()
    assert mxu.LAUNCHES_BY_FORM == {"closest_hit": 1, "any_hit": 1}
    n = 1 << 16
    t_k, p_k, p_any = t_k[:n], p_k[:n], p_any[:n]
    t_r, p_r = mxu.intersect_mxu_reference(sa, ray)
    hit = p_r >= 0
    assert int(hit.sum()) > 5000
    assert torch.equal(p_k >= 0, hit) and torch.equal(p_any >= 0, hit)
    assert torch.equal(t_k[hit], t_r[hit])
    differ = p_k != p_r
    assert torch.equal(t_k[differ], t_r[differ])
    gate = mxu.mxu_gate_reference(tables, prep[0], prep[1], 0,
                                  tables.n_chunks)
    assert 0 < int(gate.sum()) < gate.numel()


@pytest.mark.parametrize("case", ["adversarial", "dead", "equal_t",
                                  "rounds"])
@pytest.mark.parametrize("animated", [True, False])
def test_stream_kernel_matches_plain(cuda, tmp_path, monkeypatch, animated,
                                     case):
    """B3 (block lists built in the kernel, warps walking alone on their
    live lanes' bounds) against its plain version on 3,072 triangles:
    65,536 ``adversarial_rays``; a ragged wavefront (65,436 lanes, the last
    block padded with dead lanes) with every seventh lane, one whole warp
    and one whole block dead (maxt -1); the triangles of one chunk copied
    into a pad chunk of another group that the walks of rays from outside
    the mesh reach first (``equal_t_tables``: equal t in two groups, the
    first row must win; adversarial rays start too close to the mesh for
    any block to order the two groups apart); and lists of 3 groups a
    round (the scene's 13 groups in 5 rounds).
    Closest-hit: t bit for bit, prim and the whole record equal on every
    lane; any-hit: occlusion exact."""
    sa = _mesh_scene(cuda, tmp_path, animated).compile()
    tmax = 0.0015 if animated else 0.0
    if case == "equal_t":
        ray = _rays(1 << 16, 10, cuda, -4.0, tmax)
    elif case == "dead":
        ray = _rays((1 << 16) - 100, 9, cuda, -4.0, tmax)
        lane = torch.arange(ray.maxt.shape[0], device=cuda)
        dead = (lane % 7 == 3) | ((lane >= 64) & (lane < 96)) \
            | ((lane >= 512) & (lane < 768))
        ray = ray._replace(maxt=torch.where(dead, -1.0, ray.maxt))
    else:
        ray = adversarial_rays(sa, 1 << 16, 12, cuda)
    tables = stream.stream_tables(sa)
    if case == "equal_t":
        tables, k, p = equal_t_tables(
            tables, stream.intersect_stream_reference(sa, ray).prim,
            stream.group_keys(tables, stream.prepare(tables, ray)))
        monkeypatch.setitem(sa._cache, "stream", tables)
    cap = 3 if case == "rounds" else None
    prep = stream.prepare(tables, ray)
    stream.reset_launch_counts()
    out_k = stream.launch(tables, prep, False, cap=cap)
    _, p_any = stream.launch(tables, prep, True, cap=cap)
    torch.cuda.synchronize()
    assert stream.LAUNCHES_BY_FORM == {"closest_hit": 1, "any_hit": 1}
    n = ray.maxt.shape[0]
    out_r = stream.intersect_stream_reference(sa, ray)
    hit = out_r.prim >= 0
    assert int(hit.sum()) > 5000
    for f, a, b in zip(ik.HitRecord._fields, out_k, out_r):
        assert torch.equal(a[:n], b), f
    assert torch.equal(p_any[:n] >= 0, hit)
    assert not bool((out_k.prim[n:] >= 0).any())
    if case == "equal_t":
        copied = torch.isin(out_r.prim, tables.slots[32 * k:32 * k + 32])
        assert int((copied & hit).sum()) > 100
        keys = stream.group_keys(tables, prep)
        assert bool((keys[:, p // 8] < keys[:, k // 8]).any())
    if case == "rounds":
        assert -(-tables.n_chunks // 8 // cap) > 1


# B5's card cases: the per-lane box test's rays (zero and -0 direction
# components, origins on box faces and edges, grazing rays, maxt at a hit,
# NaN maxt, a ragged last block), adversarial rays, dead lanes, an equal-t
# copy of a unit in a unit that the walks reach first, lists of 1 and of 3
# units a round
V3_CASES = ["ballot", "adversarial", "dead", "equal_t", "rounds1", "rounds3"]


@pytest.mark.parametrize("case", V3_CASES)
@pytest.mark.parametrize("animated", [True, False])
def test_v3_kernel_matches_plain(cuda, tmp_path, monkeypatch, animated,
                                 case):
    """B5 (B2's lists and shared walks, a per-lane ray-box ballot ahead of
    each unit) against its plain version on 3,072 triangles: 65,436
    ``ballot_rays``; 65,536 ``adversarial_rays``; a ragged wavefront
    (65,436 lanes) with every seventh lane, one whole warp and one whole
    block dead (maxt -1); one unit's triangles copied into a new unit whose
    box is the scene's (``equal_t_v4_tables``: equal t in two units, the
    smaller slot must win wherever the walks reach the copy first); and
    lists of 1 and of 3 units a round. Closest-hit: t bit for bit and prim
    equal on every lane; any-hit: occlusion exact; B2 never launched."""
    sa = _mesh_scene(cuda, tmp_path, animated).compile()
    tmax = 0.0015 if animated else 0.0
    tables = v4.v4_tables(sa)
    if case == "ballot":
        ray = ballot_rays(sa, tables, (1 << 16) - 100, 4, cuda)
    elif case == "equal_t":
        ray = _rays(1 << 16, 10, cuda, -4.0, tmax)
    elif case == "dead":
        ray = _rays((1 << 16) - 100, 9, cuda, -4.0, tmax)
        lane = torch.arange(ray.maxt.shape[0], device=cuda)
        dead = (lane % 7 == 3) | ((lane >= 64) & (lane < 96)) \
            | ((lane >= 512) & (lane < 768))
        ray = ray._replace(maxt=torch.where(dead, -1.0, ray.maxt))
    else:
        ray = adversarial_rays(sa, 1 << 16, 12, cuda)

    def keys(tb):
        order, tlo = v4.prepare(tb, ray)[4:]
        return torch.empty_like(tlo).scatter_(1, order.long(), tlo)
    if case == "equal_t":
        tables, k, c = equal_t_v4_tables(
            tables, v3.intersect_v3_reference(sa, ray)[1], keys(tables))
        monkeypatch.setitem(sa._cache, "v4", tables)
    cap = {"rounds1": 1, "rounds3": 3}.get(case)
    v3.reset_launch_counts()
    v4.reset_launch_counts()
    t_k, p_k = v3.launch(tables, ray, False, cap=cap)
    _, p_any = v3.launch(tables, ray, True, cap=cap)
    torch.cuda.synchronize()
    assert v3.LAUNCHES_BY_FORM == {"closest_hit": 1, "any_hit": 1}
    assert v4.LAUNCHES == 0
    t_r, p_r = v3.intersect_v3_reference(sa, ray)
    hit = p_r >= 0
    assert int(hit.sum()) > 5000
    assert torch.equal(p_k >= 0, hit) and torch.equal(p_any >= 0, hit)
    assert torch.equal(t_k[hit], t_r[hit])
    assert torch.equal(p_k, p_r)
    if case == "equal_t":
        copied = torch.isin(p_r, tables.meta[k, 1] + torch.arange(
            32, device=cuda)) & hit
        kk = keys(tables)
        first = (kk[:, c] < kk[:, k]).repeat_interleave(
            v3.BLOCK)[:ray.maxt.shape[0]]
        assert int((copied & first).sum()) > 100
    if case == "ballot":
        assert bool(torch.isnan(ray.maxt).any())


def test_v3_query_builds_no_lists(cuda, tmp_path, monkeypatch):
    """On the card ``intersect_v3`` and the ``v3`` route launch B5 once a
    query and build no visit lists in PyTorch: ``prepare`` and
    ``_unit_visit_order`` are never called."""
    sa = _mesh_scene(cuda, tmp_path, True).compile()
    ray = _rays(1 << 14, 6, cuda, -4.0, 0.0015)

    def spy(*args, **kwargs):
        raise AssertionError("B5 built its visit lists in PyTorch")
    monkeypatch.setattr(v4, "prepare", spy)
    monkeypatch.setattr(v4, "_unit_visit_order", spy)
    monkeypatch.setattr(v3, "_unit_visit_order", spy)
    monkeypatch.setenv("MI_STREAM_KERNEL", "v3")
    v3.reset_launch_counts()
    v3.intersect_v3(sa, ray)
    v3.intersect_v3(sa, ray, any_hit=True)
    ik.intersect(sa, ray)
    ik.ray_test(sa, ray)
    torch.cuda.synchronize()
    assert v3.LAUNCHES_BY_FORM == {"closest_hit": 2, "any_hit": 2}


@pytest.mark.parametrize("integrator", [{"type": "velocity"},
                                        {"type": "depth"}],
                         ids=["velocity", "depth"])
def test_velocity_and_depth_on_card_match_cpu(cuda, integrator):
    """The canonical scene at 16x16 x 16 spp through B1: the card against
    the CPU within the slice test's tolerance on >= 99% of values."""
    imgs = [mt.render(mt.load_file(CANONICAL, device=dev, spp=16, resx=16,
                                   resy=16), spp=16, seed=0,
                      integrator=mt.load_dict(dict(integrator), device=dev)
                      ).cpu().numpy() for dev in (cuda, "cpu")]
    g, c = imgs
    scale = np.abs(c).max()
    assert scale > 0.0 and np.isfinite(g).all()
    assert np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale).mean() >= 0.99


def test_checkpoint_resume_on_card(cuda, tmp_path):
    """A render stopped by cancel() after 2 of 4 spp-sliced passes and
    resumed from its checkpoint equals the uninterrupted render on the
    card bit for bit."""
    def scene():
        sc = mt.load_file(CANONICAL, device=cuda, spp=16, resx=32, resy=32)
        sc.integrator.samples_per_pass = 4
        return sc

    full = scene()
    full = full.integrator.render(full, seed=0)
    ck = str(tmp_path / "ck.npz")
    sc = scene()
    integ = sc.integrator
    calls = []

    def stop_at_second(start):
        calls.append(start)
        if len(calls) == 2:
            integ.cancel()
        return type(integ).should_stop(integ, start)

    integ.should_stop = stop_at_second
    integ.render(sc, seed=0, checkpoint_path=ck, checkpoint_every=1)
    with np.load(ck) as f:
        assert int(f["pass_idx"]) == 2
    sc = scene()
    resumed = sc.integrator.render(sc, seed=0, checkpoint_path=ck)
    assert resumed.device.type == "cuda"
    assert torch.equal(resumed, full)


@pytest.mark.parametrize("integrator", [None, {"type": "volpath",
                                               "max_depth": 4}],
                         ids=["dopplertofpath", "volpath"])
def test_mini_hero_on_card_matches_cpu(cuda, tmp_path, integrator):
    """The hero scene with a 192-triangle knot and a 96-triangle sphere
    (every plugin kept: textures, envmap, conductor, roughplastic, the
    null-bounded smoke grid) at 16x16 x 16 spp through B2, card against
    CPU as chip_smoke's phase 10 holds them: the lanes whose paths meet a
    tie or graze an edge (marked on the CPU, torch_ties.TieRecorder; at
    most 10%) left out of both films, >= 99% of values within rtol 1e-4,
    atol 1e-4 * max|cpu|, and the mean within 1e-3."""
    from mitsuba3dopplertof_tpu_torch.utils import hero_scene as th
    from torch_ties import TieRecorder
    d = str(tmp_path)
    th._knot_obj(os.path.join(d, "knot.obj"), nu=12, nv=8)
    th._icosphere_obj(os.path.join(d, "sphere.obj"), nu=8, nv=6)
    kw = dict(res=16, spp=16, max_depth=4, cache_dir=d)
    if integrator is not None:
        kw["integrator"] = dict(integrator)
    load = lambda dev: mt.load_dict(th.hero_scene_dict(**kw), device=dev)
    rec = TieRecorder(16 * 16 * 16, "cpu")
    with rec.hooked():
        mt.render(load("cpu"), spp=16, seed=0)
    assert int(rec.marked.sum()) <= 0.1 * rec.marked.numel()
    imgs = []
    with rec.dropped():
        for dev in (cuda, "cpu"):
            v4.reset_launch_counts()
            imgs.append(mt.render(load(dev), spp=16, seed=0).cpu().numpy())
            if dev is cuda:
                forms = v4.LAUNCHES_BY_FORM
                assert forms["closest_hit"] > 0
                # volpath's shadow rays walk the null boundaries by
                # closest hits
                assert (forms["any_hit"] > 0) == (integrator is None)
    g, c = imgs
    scale = np.abs(c).max()
    assert scale > 0.0 and np.isfinite(g).all()
    assert np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale).mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())


def _dialect_loader(scene, tmp_path):
    """(loader by device, the kernel row of its render) of chip_smoke.py's
    phase 11 scenes at 16x16 x 16 spp: the deep-path row (B1) or the
    glass scene with the 2k sphere (B2, and B1's sphere pass)."""
    if scene == "deep_path":
        return (lambda dev: mt.load_dict(deep_path_scene(16, 16),
                                         device=dev)), ik
    import sys
    sys.path.insert(0, ROOT)
    from chip_smoke import glass_dict
    ply = str(tmp_path / "sphere_32x32.ply")
    write_uv_sphere_ply(ply, *ANIMATED_SIZES["2k"])
    return (lambda dev: mt.load_dict(glass_dict(ply, 16, 16),
                                     device=dev)), v4


@pytest.mark.parametrize("scene", ["deep_path", "glass"])
def test_dialect_scene_on_card_matches_cpu(cuda, tmp_path, scene):
    """chip_smoke.py's phase 11 scenes at 16x16 x 16 spp, card against
    CPU as that phase holds them: the lanes whose paths meet a tie or
    graze an edge (marked on the CPU, torch_ties.TieRecorder; at most
    10%) left out of both films, >= 99% of values within rtol 1e-4,
    atol 1e-4 * max|cpu|, the mean within 1e-3; the deep-path scene
    through B1, the glass scene through B2 with B1's sphere pass."""
    from torch_ties import TieRecorder
    load, mod = _dialect_loader(scene, tmp_path)
    rec = TieRecorder(16 * 16 * 16, "cpu")
    with rec.hooked():
        mt.render(load("cpu"), spp=16, seed=0)
    assert int(rec.marked.sum()) <= 0.1 * rec.marked.numel()
    imgs = []
    with rec.dropped():
        for dev in (cuda, "cpu"):
            ik.reset_launch_counts()
            v4.reset_launch_counts()
            imgs.append(mt.render(load(dev), spp=16, seed=0).cpu().numpy())
            if dev is cuda:
                assert min(mod.LAUNCHES_BY_FORM.values()) > 0
                assert min(ik.LAUNCHES_BY_FORM.values()) > 0
                if mod is ik:
                    assert v4.LAUNCHES == 0
    g, c = imgs
    scale = np.abs(c).max()
    assert scale > 0.0 and np.isfinite(g).all()
    assert np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale).mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())


def test_glass_scene_v3_route_gives_b2_image(cuda, tmp_path, monkeypatch):
    """The glass scene with the 2k sphere on the card through B5
    (MI_STREAM_KERNEL=v3) gives B2's image within phase 7's tolerance
    (every value within rtol 1e-4, atol 1e-4 * max)."""
    load, _ = _dialect_loader("glass", tmp_path)
    b2 = mt.render(load(cuda), spp=16, seed=0).cpu().numpy()
    monkeypatch.setenv("MI_STREAM_KERNEL", "v3")
    v3.reset_launch_counts()
    b5 = mt.render(load(cuda), spp=16, seed=0).cpu().numpy()
    assert min(v3.LAUNCHES_BY_FORM.values()) > 0
    scale = np.abs(b2).max()
    assert np.isclose(b5, b2, rtol=1e-4, atol=1e-4 * scale).all()


def _chip_smoke():
    import sys
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def _canonical_integrator(integ):
    """A loader of (the canonical stand-in at 16x16 x 16 spp, the
    integrator ``integ``; nested "own": around the scene's own); aov's
    scene has a box filter and an alpha channel
    (``chip_smoke.aov_check_dict``)."""
    def load(dev):
        chip_smoke = _chip_smoke()
        scene = (mt.load_dict(chip_smoke.aov_check_dict(mt), device=dev)
                 if integ.get("type") == "aov"
            else mt.load_file(CANONICAL, device=dev, spp=16, resx=16,
                              resy=16))
        d = dict(integ)
        if d.get("nested") == "own":
            d["nested"] = scene.integrator
        return scene, mt.load_dict(d, device=dev)
    return load


def _new_path(case, tmp_path):
    """(loader of (scene, integrator or None), kernel module, whether to
    leave tie lanes out) of a phase-12 path at 16x16 x 16 spp."""
    chip_smoke = _chip_smoke()
    if case == "principled":
        obj = str(tmp_path / "sphere_2k.obj")
        write_uv_sphere_obj(obj, *ANIMATED_SIZES["2k"])
        return (lambda dev: (mt.load_dict(chip_smoke.principled_dict(
            obj, 16, 16), device=dev), None)), v4, True
    if case == "ptracer":
        return (lambda dev: (mt.load_dict(
            chip_smoke.ptracer_emitters_dict(16), device=dev), None)), ik, \
            False
    integ = {"moment": {"type": "moment", "nested": "own"},
             "aov": {"type": "aov", "aovs": chip_smoke.AOV_CHECK,
                     "nested": {"type": "path", "max_depth": 4}},
             "direct": {"type": "direct"}}[case]
    return _canonical_integrator(integ), ik, False


@pytest.mark.parametrize("case", ["moment", "aov", "direct", "ptracer",
                                  "principled"])
def test_new_path_on_card_matches_cpu(cuda, tmp_path, case):
    """chip_smoke.py's phase 12 paths at 16x16 x 16 spp, card against CPU
    with phase 8's criteria (>= 99% of values within rtol 1e-4, atol 1e-4
    * max|cpu|, the mean within 1e-3): moment, aov (box filter; its
    triangle and instance ids equal), direct and ptracer (the projector /
    directionalarea scene) through B1; the principled scene with the 2k
    sphere through B2, the lanes that meet a tie or graze an edge left out
    of both films (torch_ties.TieRecorder, at most 10% of the lanes).
    aov's channels are compared on every pixel: on a missed lane its
    shading normal and uv are the plain intersector's on both devices."""
    import contextlib
    from torch_ties import TieRecorder
    load, mod, ties = _new_path(case, tmp_path)
    ctx = contextlib.nullcontext()
    if ties:
        rec = TieRecorder(16 * 16 * 16, "cpu")
        with rec.hooked():
            scene, integ = load("cpu")
            mt.render(scene, spp=16, seed=0, integrator=integ)
        assert int(rec.marked.sum()) <= 0.1 * rec.marked.numel()
        ctx = rec.dropped()
    imgs = []
    with ctx:
        for dev in (cuda, "cpu"):
            mod.reset_launch_counts()
            scene, integ = load(dev)
            imgs.append(mt.render(scene, spp=16, seed=0,
                                  integrator=integ).cpu().numpy())
            if dev is cuda:
                assert mod.LAUNCHES_BY_FORM["closest_hit"] > 0
    g, c = imgs
    scale = np.abs(c).max()
    assert scale > 0.0 and np.isfinite(g).all()
    close = np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale)
    if case == "aov":
        chip_smoke = _chip_smoke()
        hit = chip_smoke.aov_all_hit(g, c)
        assert np.array_equal(g[..., chip_smoke.AOV_IDS],
                              c[..., chip_smoke.AOV_IDS])
        assert 0.5 <= hit.mean() < 1.0
        assert close[~hit][:, chip_smoke.AOV_HIT_ONLY].mean() >= 0.99
    assert close.mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())


def _textured_scene(case, tmp_path):
    """(loader of a scene on a device, kernel module) of chip_smoke.py's
    phase 13 at 16x16 x 16 spp: the surface scene (B1), the mesh-light
    scene with the 2k vertex-coloured sphere (B2), the media scene."""
    from mitsuba3dopplertof_tpu_torch.utils import textured_scenes as ts
    d = str(tmp_path)
    if case == "surface":
        assets = ts.write_surface_assets(d)
        return (lambda dev: mt.load_dict(ts.surface_scene(assets, 16, 16),
                                         device=dev)), ik
    if case == "mesh_light":
        assets = ts.write_surface_assets(d)
        ts.write_colored_sphere_ply(f"{d}/sphere.ply",
                                    *ANIMATED_SIZES["2k"])
        ts.write_light_grid_ply(f"{d}/light.ply", 32)
        return (lambda dev: mt.load_dict(ts.mesh_light_scene(
            f"{d}/sphere.ply", f"{d}/light.ply", assets["glow"], 16, 16),
            device=dev)), v4
    ts.write_sggx_vol(f"{d}/sggx.vol")
    return (lambda dev: mt.load_dict(ts.media_scene(f"{d}/sggx.vol", 16,
                                                    16), device=dev)), ik


@pytest.mark.parametrize("case,integrator", [
    ("surface", None), ("surface", "direct"), ("surface", "aov"),
    ("surface", "ptracer"), ("mesh_light", None), ("media", None)])
def test_textured_scene_on_card_matches_cpu(cuda, tmp_path, case,
                                            integrator):
    """chip_smoke.py's phase-13 scenes at 16x16 x 16 spp, card against
    CPU with phase 8's criteria (>= 99% of values within rtol 1e-4, atol
    1e-4 * max|cpu|, the mean within 1e-3): the surface scene through B1
    with its own dopplertofpath and with direct, aov (albedo and depth:
    both zero on a missed lane, where the query's payload differs between
    the card and the CPU) and ptracer; the mesh-light scene through B2 and the media
    scene's volpath with their own integrators. The lanes that meet a tie
    or graze an edge (torch_ties.TieRecorder, at most 10%) are left out
    of both films."""
    from torch_ties import TieRecorder
    load, mod = _textured_scene(case, tmp_path)
    integ = {None: None, "direct": {"type": "direct"},
             "aov": {"type": "aov", "aovs": "aa:albedo,dd:depth",
                     "nested": {"type": "path", "max_depth": 4}},
             "ptracer": {"type": "ptracer", "max_depth": 4}}[integrator]

    def render(dev):
        kw = {} if integ is None else {"integrator": mt.load_dict(integ)}
        return mt.render(load(dev), spp=16, seed=0, **kw)
    rec = TieRecorder(16 * 16 * 16, "cpu")
    if integrator != "ptracer":
        with rec.hooked():
            render("cpu")
    assert int(rec.marked.sum()) <= 0.1 * rec.marked.numel()
    imgs = []
    with rec.dropped():
        for dev in (cuda, "cpu"):
            mod.reset_launch_counts()
            imgs.append(render(dev).cpu().numpy())
            if dev is cuda:
                assert mod.LAUNCHES_BY_FORM["closest_hit"] > 0
    g, c = imgs
    scale = np.abs(c).max()
    assert scale > 0.0 and np.isfinite(g).all()
    close = np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale)
    assert close.mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())


@pytest.fixture
def variant():
    """Sets the port's variant for one test; cuda_rgb again afterwards."""
    yield mt.set_variant
    mt.set_variant("cuda_rgb")


def _spectral_case(case, tmp_path):
    """(variant, loader of a scene on a device, kernel module, whether to
    leave tie lanes out) of chip_smoke.py's phase-14 card-vs-CPU cases at
    16x16 x 16 spp."""
    from mitsuba3dopplertof_tpu_torch.utils import measured_data as md
    from mitsuba3dopplertof_tpu_torch.utils import spectral_scenes as ss
    from mitsuba3dopplertof_tpu_torch.utils import textured_scenes as ts
    from mitsuba3dopplertof_tpu_torch.utils import hero_scene as th
    d = str(tmp_path)
    if case in ("mono", "specfilm"):
        def load(dev):
            sc = mt.load_file(CANONICAL, device=dev, spp=16, resx=16,
                              resy=16)
            if case == "specfilm":
                film = mt.load_dict(ss.specfilm_film(16))
                sc.sensor.film = film
            return sc
        return ("cuda_mono" if case == "mono" else "cuda_spectral", load,
                ik, False)
    if case.startswith("measured"):
        bsdf = md.write_ggx_copper_bsdf(os.path.join(d, "cu.bsdf"))
        obj = os.path.join(d, "sphere_2k.obj")
        write_uv_sphere_obj(obj, *ANIMATED_SIZES["2k"])
        return ("cuda_" + case.split("_")[1],
                lambda dev: mt.load_dict(md.measured_sphere_dict(
                    bsdf, obj, 16, 16), device=dev), v4, True)
    if case == "media":
        ts.write_sggx_vol(f"{d}/sggx.vol")
        return ("cuda_spectral", lambda dev: mt.load_dict(
            ts.media_scene(f"{d}/sggx.vol", 16, 16), device=dev), ik, False)
    th._knot_obj(os.path.join(d, "knot.obj"), nu=12, nv=8)
    th._icosphere_obj(os.path.join(d, "sphere.obj"), nu=8, nv=6)
    th._sky_exr(os.path.join(d, "sky.exr"), 32, 16)
    return ("cuda_spectral", lambda dev: mt.load_dict(th.hero_scene_dict(
        res=16, spp=16, max_depth=4, cache_dir=d), device=dev), v4, True)


@pytest.mark.parametrize("case", ["mono", "specfilm", "measured_rgb",
                                  "measured_spectral", "mini_hero", "media"])
def test_spectral_on_card_matches_cpu(cuda, tmp_path, variant, case):
    """chip_smoke.py's phase-14 cases at 16x16 x 16 spp, card against CPU
    with phase 8's criteria (>= 99% of values within rtol 1e-4, atol 1e-4
    * max|cpu|, the mean within 1e-3): the canonical scene in cuda_mono
    (its three channels equal) and in cuda_spectral into a specfilm of
    three regular SRFs (B1); measured in cuda_rgb and cuda_spectral on the
    2k sphere (B2); the mini hero in cuda_spectral (B2; a 32x16 sky); the
    media scene's volpath in cuda_spectral (B1). Where the scene has
    triangles above 192, the lanes that meet a tie or graze an edge
    (torch_ties.TieRecorder, at most 10%) are left out of both films. The
    card compiles first, so that a cold coefficient lattice is fitted
    there."""
    import contextlib
    from torch_ties import TieRecorder
    name, load, mod, ties = _spectral_case(case, tmp_path)
    variant(name)
    load(cuda).compile()
    ctx = contextlib.nullcontext()
    if ties:
        rec = TieRecorder(16 * 16 * 16, "cpu")
        with rec.hooked():
            mt.render(load("cpu"), spp=16, seed=0)
        assert int(rec.marked.sum()) <= 0.1 * rec.marked.numel()
        ctx = rec.dropped()
    imgs = []
    with ctx:
        for dev in (cuda, "cpu"):
            mod.reset_launch_counts()
            imgs.append(mt.render(load(dev), spp=16, seed=0).cpu().numpy())
            if dev is cuda:
                assert mod.LAUNCHES_BY_FORM["closest_hit"] > 0
    g, c = imgs
    scale = np.abs(c).max()
    assert scale > 0.0 and np.isfinite(g).all()
    assert np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale).mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())
    if case == "mono":
        assert np.array_equal(g[..., 0], g[..., 1])
        assert np.array_equal(g[..., 0], g[..., 2])


def _polarized_case(case, tmp_path):
    """(variant, loader of a scene on a device, kernel module, whether to
    leave tie lanes out) of chip_smoke.py's phase-15 card-vs-CPU cases at
    16x16 x 16 spp."""
    from mitsuba3dopplertof_tpu_torch.utils import measured_data as md
    from mitsuba3dopplertof_tpu_torch.utils import polarized_scenes as ps
    from mitsuba3dopplertof_tpu_torch.utils import textured_scenes as ts
    d = str(tmp_path)
    if case == "plates":
        return ("cuda_rgb_polarized", lambda dev: mt.load_dict(
            ps.plate_scene(ps.ELEMENTS, spp=16, res=16), device=dev), ik,
            False)
    if case.startswith("canonical") or case == "ptracer":
        xml = ps.polarizing_canonical_xml(
            stokes=case != "ptracer",
            integrator=('<integrator type="ptracer"><integer '
                        'name="max_depth" value="4"/></integrator>'
                        if case == "ptracer" else None))
        return ("cuda_spectral_polarized" if case.endswith("spectral")
                else "cuda_rgb_polarized",
                lambda dev: mt.load_string(xml, spp=16, resx=16, resy=16,
                                           device=dev), ik, False)
    if case == "media":
        ts.write_sggx_vol(f"{d}/sggx.vol")

        def media(dev):
            sd = ts.media_scene(f"{d}/sggx.vol", 16, 16)
            sd["integrator"] = {"type": "stokes",
                                "nested": sd["integrator"]}
            return mt.load_dict(sd, device=dev)
        return "cuda_rgb_polarized", media, ik, False
    stokes = {"type": "stokes", "nested": {"type": "path", "max_depth": 4}}
    if case == "measured":
        pbsdf = md.write_pbsdf(os.path.join(d, "pol.pbsdf"))
        obj = os.path.join(d, "sphere_2k.obj")
        write_uv_sphere_obj(obj, *ANIMATED_SIZES["2k"])
        return ("cuda_rgb_polarized",
                lambda dev: mt.load_dict(md.measured_polarized_sphere_dict(
                    pbsdf, obj, 16, 16, integrator=stokes), device=dev),
                v4, True)
    glass_dict = _chip_smoke().glass_dict
    ply = os.path.join(d, "sphere_2k.ply")
    write_uv_sphere_ply(ply, *ANIMATED_SIZES["2k"])

    def glass(dev):
        gd = glass_dict(ply, 16, 16)
        gd["integrator"] = {"type": "stokes", "nested": gd["integrator"]}
        return mt.load_dict(gd, device=dev)
    return "cuda_rgb_polarized", glass, v4, True


@pytest.mark.parametrize("case", ["plates", "canonical", "canonical_spectral",
                                  "ptracer", "glass", "measured", "media"])
def test_polarized_on_card_matches_cpu(cuda, tmp_path, variant, case):
    """chip_smoke.py's phase-15 cases at 16x16 x 16 spp, card against CPU
    with phase 8's criteria over every channel (the 12 Stokes AOVs too):
    the three elements' plates and the polarizing canonical under
    stokes(dopplertofpath) in cuda_rgb_polarized and
    cuda_spectral_polarized, and under ptracer (B1); glass and
    measured_polarized on the 2k sphere (B2; tie lanes left out, at most
    10%); the media scene under stokes(volpath) (B1)."""
    import contextlib
    from torch_ties import TieRecorder
    name, load, mod, ties = _polarized_case(case, tmp_path)
    variant(name)
    ctx = contextlib.nullcontext()
    if ties:
        rec = TieRecorder(16 * 16 * 16, "cpu")
        with rec.hooked():
            mt.render(load("cpu"), spp=16, seed=0)
        assert int(rec.marked.sum()) <= 0.1 * rec.marked.numel()
        ctx = rec.dropped()
    imgs = []
    with ctx:
        for dev in (cuda, "cpu"):
            mod.reset_launch_counts()
            imgs.append(mt.render(load(dev), spp=16, seed=0).cpu().numpy())
            if dev is cuda:
                assert mod.LAUNCHES_BY_FORM["closest_hit"] > 0
    g, c = imgs
    assert g.shape[-1] == (3 if case == "ptracer" else 15)
    scale = np.abs(c).max()
    assert scale > 0.0 and np.isfinite(g).all()
    assert np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale).mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())
