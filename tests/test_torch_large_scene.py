"""The port's large-scene path (scenes above 192 triangles) against the JAX
package on the CPU: OBJ meshes, the point light, the compiled tables with
the chunk boxes, the helpers of kernel B2 (chunk layout, Woop records,
visit lists, scene-box exit, ray binning, payload), B2's plain version
``intersect_v4_reference`` against the Pallas kernel ``intersect_v4`` run
in interpret mode (as tests/test_v4_kernel.py runs it), the vectorized
plain intersector against ``_hit_reference``, and the slice as a whole: the
2k animated-mesh benchmark scene rendered by both packages. Inputs are made
with numpy from a seed; each tolerance is stated where it is used. The
CUDA kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3dopplertof_tpu import emitters as jem
from mitsuba3dopplertof_tpu.core.vec import Vec3 as JVec3
from mitsuba3dopplertof_tpu.io.mesh_loaders import load_obj as jax_load_obj
from mitsuba3dopplertof_tpu.ops import intersect_mxu as jmxu
from mitsuba3dopplertof_tpu.ops import intersect_stream as jstream
from mitsuba3dopplertof_tpu.ops import intersect_v2 as jv2
from mitsuba3dopplertof_tpu.ops import intersect_v3 as jv3
from mitsuba3dopplertof_tpu.ops import intersect_v4 as jv4
from mitsuba3dopplertof_tpu.ops import ray_binning as jbin
from mitsuba3dopplertof_tpu.render.scene import _hit_reference

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch import emitters as tem
from mitsuba3dopplertof_tpu_torch.core.transform import \
    AnimatedTransform as TAnimatedTransform
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3dopplertof_tpu_torch.io.mesh_loaders import load_obj
from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as tik
from mitsuba3dopplertof_tpu_torch.ops import intersect_stream as tstream
from mitsuba3dopplertof_tpu_torch.ops import intersect_v3 as tv3
from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as tv4
from mitsuba3dopplertof_tpu_torch.ops import ray_binning as tbin
from mitsuba3dopplertof_tpu_torch.ops.intersect_mxu import payload_from_prim
from mitsuba3dopplertof_tpu_torch.ops.intersect_v2 import scene_box_exit
from mitsuba3dopplertof_tpu_torch.render.scene import SceneArrays
from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
    animated_mesh_scene, write_uv_sphere_obj)

from torch_port_helpers import (F32_ULP, assert_t_prim as _assert_t_prim,
                                both_rays as _both, build_mixed_scene,
                                fresh_import_report, jax_mesh_render,
                                mixed_dict as _mixed_dict,
                                shell_rays as _rays)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's oracle under one jit: compiled once for the mixed scene
# and 2,048 rays, not op by op
_oracle = jax.jit(_hit_reference)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(JAX SceneArrays, port SceneArrays carried over from it, port
    SceneArrays of the port's own compile, OBJ path)."""
    return build_mixed_scene(tmp_path_factory.mktemp("large"))


# ---------------------------------------------------------------------------
# Front end: OBJ, point light, compiled tables
# ---------------------------------------------------------------------------

def test_load_obj_matches_jax(scene, tmp_path):
    """Vertices within one float32 rounding (the JAX package parses with
    its native float32 shim where it can build it), everything else
    exact; with and without normals/uvs, and a fanned quad."""
    plain = tmp_path / "plain.obj"
    write_uv_sphere_obj(str(plain), 12, 7)
    quad = tmp_path / "quad.obj"
    quad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\n"
                    "vt 1 1\nvt 0 1\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1 -1/4/1\n")
    for path in (scene[3], plain, quad):
        mp, mjx = load_obj(str(path)), jax_load_obj(str(path))
        assert np.array_equal(mp.faces, mjx.faces)
        for k in ("vertices", "normals", "uvs"):
            a, b = getattr(mp, k), getattr(mjx, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=F32_ULP, atol=1e-12)


def test_point_emitter_matches_jax(scene):
    """NEE toward the point light: position, direction, distance, pdf 1,
    delta flag and intensity / dist^2 within 2 float32 ulps (rsqrt); the
    MIS pdf of a delta light is 0."""
    sa_j, sa_t = scene[0], scene[1]
    rng = np.random.default_rng(3)
    n = 512
    p = rng.uniform(-2.0, 2.0, (n, 3))
    s = rng.uniform(0.0, 1.0, (n, 2))
    f32 = np.float32
    ds_j, spec_j = jem.sample_direction(
        sa_j, JVec3(*(jnp.asarray(p[:, i], f32) for i in range(3))),
        jnp.zeros(n, f32), jnp.asarray(s[:, 0], f32),
        jnp.asarray(s[:, 1], f32))
    ds_t, spec_t = tem.sample_direction(
        sa_t, TVec3(*(torch.from_numpy(p[:, i].astype(f32))
                      for i in range(3))),
        torch.zeros(n), torch.from_numpy(s[:, 0].astype(f32)),
        torch.from_numpy(s[:, 1].astype(f32)))
    for a, b in ((ds_t.p, ds_j.p), (ds_t.d, ds_j.d), (spec_t, spec_j)):
        for c in "xyz":
            np.testing.assert_allclose(getattr(a, c).numpy(),
                                       np.asarray(getattr(b, c)),
                                       rtol=2 * F32_ULP, atol=1e-7)
    np.testing.assert_allclose(ds_t.dist.numpy(), np.asarray(ds_j.dist),
                               rtol=2 * F32_ULP)
    assert (ds_t.pdf.numpy() == 1.0).all() and ds_t.delta.all()
    assert np.array_equal(ds_t.emitter.numpy(), np.asarray(ds_j.emitter))
    pdf_t = tem.pdf_direction(sa_t, ds_t)
    pdf_j = jem.pdf_direction(sa_j, ds_j)
    assert (pdf_t.numpy() == 0.0).all() and (np.asarray(pdf_j) == 0.0).all()


def test_compiled_tables_match_jax(scene):
    """The port's own compile of the OBJ scene against the JAX package's
    tables carried over by ``from_jax_scene_arrays``: metadata and integer
    columns exact, float columns (chunk boxes included) within one float32
    rounding (the two OBJ parsers round the file's decimals apart)."""
    sa_j, sa_t, sa_p, _ = scene
    for k in SceneArrays.META_FIELDS:
        assert getattr(sa_p, k) == getattr(sa_t, k), k
    for k in SceneArrays.ARRAY_FIELDS + ["chunk_aabb"]:
        a, b = getattr(sa_p, k), getattr(sa_t, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == torch.int32:
            assert torch.equal(a, b), k
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=4e-7,
                                       atol=1e-7, err_msg=k)
    assert np.array_equal(sa_t.chunk_aabb.numpy(), np.asarray(sa_j.chunk_aabb))
    assert (sa_p.n_static_tris, sa_p.n_anim_tris) == (1538, 12)


# ---------------------------------------------------------------------------
# B2's helpers
# ---------------------------------------------------------------------------

def test_chunk_layout_woop_and_visit_order_match_jax(scene):
    """Chunk layout and instance table exact; Woop coefficients within 4
    float32 ulps of the larger magnitude (XLA may contract the adjugate's
    products); the visit lists' order exact and their sorted entry
    distances bitwise, both computed on the same rays and boxes."""
    sa_j, sa_t = scene[0], scene[1]
    seg_j, meta_j = jstream._chunked_layout(sa_j.n_static_tris,
                                            sa_j.anim_ranges)
    seg_t, meta_t = tstream._chunked_layout(sa_t.n_static_tris,
                                            sa_t.anim_ranges)
    assert seg_j == seg_t and np.array_equal(meta_j, meta_t)
    n_units = meta_t.shape[0]
    assert np.array_equal(tstream._inst_table(sa_t).numpy(),
                          np.asarray(jstream._inst_table(sa_j)))

    # (unit, triangle, coefficient)
    w_j = np.asarray(jv3._woop_records(sa_j, seg_j, n_units)).reshape(
        n_units, -1)[:, :tv3.UNIT_REC].reshape(n_units, 12, 32)
    w_j = w_j.transpose(0, 2, 1)
    w_t = tv3._woop_records(sa_t, seg_t, n_units).numpy().reshape(
        n_units, 12, 32).transpose(0, 2, 1)
    # triangles of zero area in exact arithmetic (pads, the sphere's pole
    # rows): zero rows in the port; XLA's fused multiply-adds leave a
    # rounding residue in the JAX package's cross product there
    geom = np.concatenate([
        np.zeros((c, 9)) if k == "pad" else np.stack(
            [sa_t.tri(k, g)[s:s + c].numpy() for g in tik._GEOM], -1)
        for k, s, c in seg_t]).astype(np.float64)
    nrm = np.cross(geom[:, 3:6], geom[:, 6:9])
    degenerate = ((nrm * nrm).sum(-1) == 0.0).reshape(n_units, 32)
    assert degenerate.sum() > 200 and (w_t[degenerate] == 0.0).all()
    scale = np.abs(w_j).max(axis=2, keepdims=True)
    err = np.abs(w_t - w_j) / np.maximum(scale, 1e-30)
    assert err[~degenerate].max() <= 4 * F32_ULP, err[~degenerate].max()

    o, d, time, maxt = _rays(2048, seed=5)
    maxt = np.where(np.isinf(maxt), 3e38, maxt)
    x = np.stack([o[:, 0], o[:, 1], o[:, 2], np.ones(2048), d[:, 0],
                  d[:, 1], d[:, 2], maxt]).astype(np.float32)
    box = np.array(sa_j.chunk_aabb)
    c_pad = -(-n_units // 128) * 128
    order_j, tlo_j = jv3._unit_visit_order(jnp.asarray(box), n_units,
                                           c_pad, jnp.asarray(x), 256)
    order_t, tlo_t = tv3._unit_visit_order(torch.from_numpy(box), n_units,
                                           torch.from_numpy(x), 256)
    nb = 2048 // 256
    assert np.array_equal(order_t.numpy(),
                          np.asarray(order_j).reshape(-1, c_pad)[:nb,
                                                                 :n_units])
    assert np.array_equal(tlo_t.numpy(),
                          np.asarray(tlo_j).reshape(-1, c_pad)[:nb,
                                                               :n_units])
    assert (tlo_t.numpy() < 3e38).any() and (tlo_t.numpy() == 3e38).any()


def test_scene_box_exit_matches_jax(scene):
    """Within 2 float32 ulps (XLA may fuse the pad's multiply-add); rays
    that miss the box are -1 on both sides."""
    box = np.array(scene[0].chunk_aabb)
    o, d, _, _ = _rays(2048, seed=9)
    o[:64] = 50.0                         # far outside, pointing away
    f32 = np.float32
    ej = np.asarray(jv2.scene_box_exit(
        jnp.asarray(box), tuple(jnp.asarray(o[:, i], f32) for i in range(3)),
        tuple(jnp.asarray(d[:, i], f32) for i in range(3))))
    et = scene_box_exit(torch.from_numpy(box),
                        tuple(torch.from_numpy(o[:, i].astype(f32))
                              for i in range(3)),
                        tuple(torch.from_numpy(d[:, i].astype(f32))
                              for i in range(3))).numpy()
    assert ((et == -1.0) == (ej == -1.0)).all() and (et == -1.0).any()
    np.testing.assert_allclose(et, ej, rtol=2 * F32_ULP)


def test_bin_key_bitwise_and_binned_equals_unbinned(scene):
    """``bin_key`` equals the JAX package's bit for bit (dead lanes
    included); running B2's plain version through ``binned`` gives the
    unbinned (t, prim) bit for bit (binning is a permutation)."""
    sa_j, sa_t = scene[0], scene[1]
    o, d, time, maxt = _rays(2048, seed=13)
    maxt[::7] = -1.0
    jr, tr = _both(o, d, time, maxt)
    box = np.array(sa_j.chunk_aabb)
    lo, hi = box[:, :3].min(0), box[:, 3:].max(0)
    k_j = np.asarray(jbin.bin_key(jr, jnp.asarray(lo), jnp.asarray(hi)))
    k_t = tbin.bin_key(tr, torch.from_numpy(lo), torch.from_numpy(hi))
    assert k_t.dtype == torch.int32
    assert np.array_equal(k_t.numpy(), k_j)
    assert len(np.unique(k_j)) > 500

    assert tbin.should_bin(sa_t, 2048, tv4.BLOCK)
    active = torch.from_numpy(np.arange(2048) % 5 != 0)
    t_b, p_b = tbin.binned(sa_t, tr, active, lambda r: list(
        tv4.intersect_v4_reference(sa_t, r)))
    t_u, p_u = tv4.intersect_v4_reference(
        sa_t, tr._replace(maxt=torch.where(active, tr.maxt, -1.0)))
    assert torch.equal(t_b, t_u) and torch.equal(p_b, p_u)
    assert int((p_u >= 0).sum()) > 300


def test_payload_from_prim_matches_jax(scene):
    """The same (t, prim) (the JAX oracle's) through both payload
    rebuilds: prim/inst exact, floats within 1e-5 relative to each field's
    scale (the JAX package evaluates the same expressions in XLA)."""
    sa_j, sa_t = scene[0], scene[1]
    jr, tr = _both(*_rays(2048, seed=17))
    hr = _oracle(sa_j, jr)
    hj = jmxu.payload_from_prim(sa_j, jr, hr.t, hr.prim)
    ht = payload_from_prim(sa_t, tr, torch.from_numpy(np.asarray(hr.t)),
                           torch.from_numpy(np.asarray(hr.prim)))
    for f in tik.HitRecord._fields:
        a, b = getattr(ht, f).numpy(), np.asarray(getattr(hj, f))
        if f in ("prim", "inst"):
            assert np.array_equal(a, b), f
        else:
            fin = np.isfinite(b)
            assert (np.isfinite(a) == fin).all(), f
            scale = np.abs(b[fin]).max()
            np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                       atol=1e-5 * scale, err_msg=f)


# ---------------------------------------------------------------------------
# B2's plain version against the Pallas kernel, and the plain intersector
# ---------------------------------------------------------------------------

@pytest.fixture
def pallas_v4_group1(monkeypatch):
    """JAX ``intersect_v4`` with its walk taking one unit per loop step
    (GROUP = 1) instead of 8. The group size only decides how many units
    one step of the walk tests, not what the kernel computes; interpret
    mode compiles the 8-unit body for ~2 minutes on the CPU and the 1-unit
    body in ~12 s. The compiled-kernel cache, whose key leaves the group
    size out, is cleared before and after."""
    jv4._compiled_v4.cache_clear()
    monkeypatch.setattr(jv4, "GROUP", 1)
    yield jv4.intersect_v4
    jv4._compiled_v4.cache_clear()


def test_v4_reference_matches_pallas_interpret(scene, pallas_v4_group1):
    """``intersect_v4_reference`` against JAX ``intersect_v4`` in
    interpret mode on 2,048 rays. Closest-hit (one interpret-mode compile),
    with a quarter of the lanes at finite maxt, then every lane at maxt 2
    (no hit beyond it): the same lanes hit, t within 2 float32 ulps (the
    same Woop arithmetic; XLA may fuse products into FMAs), prim equal but
    at shared-edge ties. Any-hit: the plain version's occlusion equals the
    kernel's closest-hit occlusion and the oracle's, exactly."""
    sa_j, sa_t = scene[0], scene[1]
    rays = _rays(2048, seed=7)
    jr, tr = _both(*rays)
    t_j, p_j = pallas_v4_group1(sa_j, jr)
    t_t, p_t = tv4.intersect_v4(sa_t, tr)           # CPU: the plain version
    n_hit = _assert_t_prim(t_t, p_t, t_j, p_j, 2 * F32_ULP, "closest")
    assert n_hit > 400

    jr2, tr2 = _both(*rays[:3], np.full(2048, 2.0))
    t_j, p_j = pallas_v4_group1(sa_j, jr2)          # same shapes: compiled
    t_t, p_t = tv4.intersect_v4_reference(sa_t, tr2)
    _assert_t_prim(t_t, p_t, t_j, p_j, 2 * F32_ULP, "maxt 2")
    assert (t_t[p_t >= 0] < 2.0).all() and int((p_t >= 0).sum()) > 50

    _, p_j = pallas_v4_group1(sa_j, jr)             # cached
    _, p_t = tv4.intersect_v4_reference(sa_t, tr, any_hit=True)
    assert np.array_equal(p_t.numpy() >= 0, np.asarray(p_j) >= 0)
    assert np.array_equal(p_t.numpy() >= 0,
                          np.asarray(_oracle(sa_j, jr).prim) >= 0)


def test_plain_intersector_matches_hit_reference(scene):
    """The vectorized plain intersector (chunks of triangles, first slot on
    ties) against ``_hit_reference`` on the large scene, with
    tests/test_pallas_parity.py's criteria (t within 2e-4 where both hit,
    payload of equal prims close, prim differing only at ties; XLA fuses
    some of the JAX side's products into FMAs, the port rounds each);
    occlusion exact. The card's large-scene route on the CPU (B2's plain
    version + payload) gives the same hits."""
    from test_torch_intersect import _assert_hits_match
    sa_j, sa_t = scene[0], scene[1]
    jr, tr = _both(*_rays(2048, seed=23))
    hr = _oracle(sa_j, jr)
    hp = tik.intersect_reference(sa_t, tr)
    assert _assert_hits_match(hp, hr, "vectorized scan") > 400
    assert np.array_equal(hp.prim.numpy() >= 0, np.asarray(hr.prim) >= 0)
    hl = tik.intersect_large(sa_t, tr)
    _assert_t_prim(hl.t, hl.prim, hp.t, hp.prim, 1e-5, "large route")
    assert torch.equal(tik.ray_test_large(sa_t, tr), hp.prim >= 0)


def test_large_route_merges_spheres(scene):
    """With an analytic sphere the large route merges B1's spheres-only
    pass: the same hits as the plain intersector (port only)."""
    sc = mt.load_dict(_mixed_dict(scene[3], TAnimatedTransform,
                                  spheres=True))
    sa = sc.compile()
    _, tr = _both(*_rays(2048, seed=29))
    hp = tik.intersect_reference(sa, tr)
    hl = tik.intersect_large(sa, tr)
    sph = hp.prim >= tik._SPH_SLOT_BASE
    assert int(sph.sum()) > 20
    _assert_t_prim(hl.t, hl.prim, hp.t, hp.prim, 1e-5, "spheres")
    assert torch.equal(hl.inst[sph], hp.inst[sph])
    assert torch.equal(tik.ray_test_large(sa, tr), hp.prim >= 0)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def test_animated_mesh_scene_matches_jax():
    """scripts/bench_suite.py's 2k animated-mesh scene (32x32 UV sphere,
    2,048 triangles, point light, dopplertofpath, correlated sampler) at
    16x16 x 4 spp, seed 0: every pixel within rtol 1e-4 / atol 1e-4 * max
    of the JAX package's render."""
    obj, ref = jax_mesh_render()
    img = mt.render(mt.load_dict(animated_mesh_scene(obj, spp=4, res=16)),
                    spp=4, seed=0).numpy()
    assert img.shape == ref.shape == (16, 16, 3)
    scale = np.abs(ref).max()
    assert scale > 0.0 and np.isfinite(img).all()
    assert np.allclose(img, ref, rtol=1e-4, atol=1e-4 * scale), \
        np.abs(img - ref).max()


def test_default_device_is_cuda_and_nothing_imports_jax():
    """A fresh import defaults to CUDA and, with no card, loading a scene
    on the default raises; importing every module of the port pulls in
    neither jax nor the JAX package, and chip_smoke.py imports neither."""
    out = fresh_import_report()
    assert out == ("cuda", "[]", "raised"), out
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m == "jax" or m.startswith("jax.")
                or m.split(".")[0] == "mitsuba3dopplertof_tpu"], names
