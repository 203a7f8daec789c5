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
    animated_mesh_scene, static_mesh_scene, write_uv_sphere_obj)

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


@pytest.mark.parametrize("which", ["canonical", "spheres"])
def test_kernel_matches_plain(cuda, which):
    if which == "canonical":
        sa = mt.load_file(CANONICAL, device=cuda).compile()
        ray = _rays(1 << 16, 1, cuda, 3.5, 0.0015)
    else:
        sa = _sphere_scene(cuda).compile()
        ray = _rays(1 << 16, 2, cuda, -6.0, 1.0)
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
    the same order of operations), prim different only where t ties; the
    kernel over binned rays gives the same result."""
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
    assert int((p_k != p_r).sum()) <= 20
    t_b, p_b = binned(sa, ray, None, lambda r: list(v4.intersect_v4(sa, r)))
    assert torch.equal(t_b, t_k)
    assert int((p_b != p_k).sum()) <= 20


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
