"""The port's alternate large-scene routes (MI_STREAM_KERNEL = v3, v2, v1,
mxu: kernels B5, B4, B3, B6) against the JAX package on the CPU, on the
mixed static + animated scene of tests/torch_port_helpers.py: the new
per-kernel tables against the JAX package's, each plain version against
the oracle ``_hit_reference`` and against the Pallas kernel run in
interpret mode (as tests/test_v3_kernel.py, test_v2_kernel.py,
test_mxu_kernel.py and test_pallas_parity.py run them), and each route as a
whole: the 2k animated-mesh scene rendered by the port with the route
selected against the JAX package's render. Inputs are made with numpy from
a seed; each tolerance is stated where it is used. The CUDA kernels run
only on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3dopplertof_tpu.ops import intersect_mxu as jmxu
from mitsuba3dopplertof_tpu.ops import intersect_stream as jstream
from mitsuba3dopplertof_tpu.ops import intersect_v2 as jv2
from mitsuba3dopplertof_tpu.ops import intersect_v3 as jv3
from mitsuba3dopplertof_tpu.render.scene import _hit_reference

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as tik
from mitsuba3dopplertof_tpu_torch.ops import intersect_mxu as tmxu
from mitsuba3dopplertof_tpu_torch.ops import intersect_stream as tstream
from mitsuba3dopplertof_tpu_torch.ops import intersect_v2 as tv2
from mitsuba3dopplertof_tpu_torch.ops import intersect_v3 as tv3
from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as tv4
from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import \
    animated_mesh_scene

from torch_port_helpers import (F32_ULP, assert_t_prim, both_rays,
                                build_mixed_scene, jax_mesh_render,
                                shell_rays)

# MI_STREAM_KERNEL value -> (kernel row, port module, wrapper, plain version)
ROUTES = {
    "v3": ("B5", tv3, "intersect_v3", "intersect_v3_reference"),
    "v2": ("B4", tv2, "intersect_v2", "intersect_v2_reference"),
    "v1": ("B3", tstream, "intersect_stream", "intersect_stream_reference"),
    "mxu": ("B6", tmxu, "intersect_mxu", "intersect_mxu_reference"),
}
N_RAYS = 2048


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(JAX SceneArrays, port SceneArrays carried over from it)."""
    return build_mixed_scene(tmp_path_factory.mktemp("alt"),
                             port_compile=False)[:2]


@pytest.fixture(scope="module")
def rays():
    """2,048 rays, a quarter at finite maxt, for both packages."""
    return both_rays(*shell_rays(N_RAYS, seed=7))


@pytest.fixture(scope="module")
def oracle(scene, rays):
    """``_hit_reference`` of the JAX package on ``rays`` (numpy fields)."""
    h = jax.jit(_hit_reference)(scene[0], rays[0])
    return {f: np.asarray(getattr(h, f)) for f in h._fields}


def _layout(sa_j):
    seg, meta = jstream._chunked_layout(sa_j.n_static_tris, sa_j.anim_ranges)
    return seg, meta, meta.shape[0]


# ---------------------------------------------------------------------------
# (a) the new tables
# ---------------------------------------------------------------------------

def test_tri_records_match_jax(scene):
    """B4's Möller records: the nine used rows of the JAX package's
    (n_chunks, 16, 128) tile, exact (its other seven rows are zero)."""
    sa_j, sa_t = scene
    seg, _, n_units = _layout(sa_j)
    n_chunks = n_units // tv2.SUBS
    rec_j = np.asarray(jv2._tri_records(sa_j, seg, n_chunks))
    rec_t = tv2._tri_records(sa_t, seg, n_chunks).numpy()
    assert rec_t.shape == (n_chunks, 9, 128)
    assert np.array_equal(rec_t, rec_j[:, :9]) and not rec_j[:, 9:].any()
    tb = tv2.v2_tables(sa_t)
    assert tb.n_chunks == n_chunks and tb.sub.shape == (4 * n_chunks, 6)
    assert np.array_equal(tb.meta.numpy(), _layout(sa_j)[1][::4])


def test_woop_table_matches_jax(scene):
    """B6's W: the structural zeros exact; the coefficients within 4
    float32 ulps of each triangle row's largest magnitude (XLA may
    contract the adjugate's products), but for triangles of zero area,
    where the port stores zero rows and XLA's fused multiply-adds leave a
    rounding residue; and W is B5's Woop records laid out anew, exact."""
    sa_j, sa_t = scene
    seg, _, n_units = _layout(sa_j)
    n_chunks = n_units // tmxu.SUBS
    w_j = np.asarray(jmxu._woop_table(sa_j, seg, n_chunks))
    w_t = tmxu._woop_table(sa_t, seg, n_chunks).numpy()
    assert w_t.shape == w_j.shape == (n_chunks * 8, 768)
    # (chunk, feature k, component c, triangle j) -> (triangle, c, k)
    lay = lambda w: w.reshape(n_chunks, 8, 6, 128).transpose(0, 3, 2, 1) \
        .reshape(-1, 6, 8)
    a, b = lay(w_t), lay(w_j)
    zero = np.ones((6, 8), bool)
    zero[:3, :4] = False
    zero[3:, 4:7] = False
    assert not a[:, zero].any() and not b[:, zero].any()
    rec = tv3._woop_records(sa_t, seg, n_units).numpy().reshape(
        n_units, 12, 32).transpose(0, 2, 1).reshape(-1, 3, 4)
    assert np.array_equal(a[:, :3, :4], rec)
    assert np.array_equal(a[:, 3:, 4:7], rec[:, :, :3])
    degenerate = ~rec.any(axis=(1, 2))
    assert 200 < degenerate.sum() < len(rec) // 2
    scale = np.abs(b).max(axis=2, keepdims=True)
    err = np.abs(a - b) / np.maximum(scale, 1e-30)
    assert err[~degenerate].max() <= 4 * F32_ULP, err[~degenerate].max()


def test_visit_order_matches_jax(scene, rays):
    """The chunk visit lists of B4 and B6 (``_visit_order``, the union of
    four 32-triangle boxes per chunk): order exact, sorted entry distances
    bitwise, on the same rays and boxes."""
    sa_j = scene[0]
    n_chunks = _layout(sa_j)[2] // 4
    x = np.stack([np.asarray(c) for c in (
        rays[0].o.x, rays[0].o.y, rays[0].o.z, np.ones(N_RAYS),
        rays[0].d.x, rays[0].d.y, rays[0].d.z,
        np.minimum(np.asarray(rays[0].maxt), 3e38))]).astype(np.float32)
    box = np.array(sa_j.chunk_aabb)
    c_pad = -(-n_chunks // 128) * 128
    order_j, tlo_j = jax.jit(
        lambda b, xx: jmxu._visit_order(b, n_chunks, c_pad, xx, 256))(
            jnp.asarray(box), jnp.asarray(x))
    order_t, tlo_t = tmxu._visit_order(torch.from_numpy(box), n_chunks,
                                       torch.from_numpy(x), 256)
    nb = N_RAYS // 256
    assert order_t.shape == (nb, n_chunks)
    assert np.array_equal(
        order_t.numpy(), np.asarray(order_j).reshape(-1, c_pad)[:nb,
                                                                 :n_chunks])
    assert np.array_equal(
        tlo_t.numpy(), np.asarray(tlo_j).reshape(-1, c_pad)[:nb, :n_chunks])
    assert (tlo_t.numpy() < 3e38).any()


def test_stream_tables_match_jax(scene):
    """B3's tables: the padded triangle table exact; chunk meta and boxes
    padded to a multiple of CPG with never-visited chunks, and the group
    boxes, as the JAX package's ``intersect_stream`` builds them."""
    sa_j, sa_t = scene
    seg, meta, n_chunks = _layout(sa_j)
    tb = tstream.stream_tables(sa_t)
    tri_j = np.asarray(jstream._assemble_tri_table(sa_j, seg))
    assert np.array_equal(tb.tri.numpy()[:len(tri_j)], tri_j)
    assert np.array_equal(
        tstream._assemble_tri_table(sa_t, seg).numpy(), tri_j)
    pad_c = (-n_chunks) % jstream.CPG
    assert tstream.CPG == jstream.CPG and tb.n_chunks == n_chunks + pad_c
    assert not tb.tri.numpy()[len(tri_j):].any()
    aabb = np.concatenate([np.asarray(sa_j.chunk_aabb), np.concatenate(
        [np.full((pad_c, 3), 3e38, np.float32),
         np.full((pad_c, 3), -3e38, np.float32)], axis=1)])
    ga = aabb.reshape(-1, jstream.CPG, 6)
    grp = np.concatenate([ga[:, :, :3].min(axis=1), ga[:, :, 3:].max(axis=1)],
                         axis=1)
    assert np.array_equal(tb.aabb.numpy(), aabb)
    assert np.array_equal(tb.grp.numpy(), grp)
    assert np.array_equal(tb.meta.numpy(), np.concatenate(
        [meta, np.zeros((pad_c, 2), np.int32)]))
    assert np.array_equal(
        tb.slots.numpy()[:len(tri_j)],
        (meta[:, 1:2] + np.arange(32, dtype=np.int32)).reshape(-1))


# ---------------------------------------------------------------------------
# (b) the plain versions against the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_plain_matches_hit_reference(scene, rays, oracle, route):
    """Each plain version against ``_hit_reference``: the same lanes hit,
    t within rtol 2e-4 / atol 1e-5 (the JAX package's own tolerance for
    its kernels, tests/test_mxu_kernel.py), the same prim on > 99.9% of
    lanes (shared-edge ties), any-hit occlusion exact. B3's record: the
    payload of equal prims within the criteria of
    tests/test_pallas_parity.py."""
    _, mod, _, plain = ROUTES[route]
    sa_t, tr = scene[1], rays[1]
    out = getattr(mod, plain)(sa_t, tr)
    t, prim = out[0].numpy(), out[1].numpy()
    hit = oracle["prim"] >= 0
    assert hit.sum() > 400
    assert ((prim >= 0) == hit).all()
    assert np.allclose(t[hit], oracle["t"][hit], rtol=2e-4, atol=1e-5)
    assert (prim == oracle["prim"]).mean() > 0.999
    assert np.isinf(t[~hit]).all() and (prim[~hit] == -1).all()
    _, p_any = getattr(mod, plain)(sa_t, tr, any_hit=True)
    assert np.array_equal(p_any.numpy() >= 0, hit)
    if route == "v1":
        from test_torch_intersect import _assert_hits_match
        ref = tik.HitRecord(*(torch.from_numpy(oracle[f].copy())
                              for f in tik.HitRecord._fields))
        assert _assert_hits_match(out, ref, "B3 record") > 400
        miss = torch.from_numpy(~hit)
        for f in tik.HitRecord._fields[2:]:   # missed lanes carry zeros
            assert not getattr(out, f)[miss].any(), f


# ---------------------------------------------------------------------------
# (c) the plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.fixture
def pallas_stream_cpg1(monkeypatch):
    """JAX ``intersect_stream`` testing one chunk per grid step (CPG = 1)
    instead of 8: the group size only decides how many chunks one step
    unrolls (with one chunk per group, the group's box is the chunk's),
    not what the kernel computes, and interpret mode compiles the 32
    unrolled triangles of one chunk far faster than 256. The
    compiled-kernel cache, whose key leaves CPG out, is cleared before and
    after."""
    jstream._compiled_stream.cache_clear()
    monkeypatch.setattr(jstream, "CPG", 1)
    yield jstream.intersect_stream
    jstream._compiled_stream.cache_clear()


def _pallas(route, request):
    """The JAX package's kernel of ``route``, closest-hit, one 2,048-lane
    block (16 rows of 128 lanes), under one ``jax.jit`` as the package's
    render runs it (eagerly the wrapper's hundred small ops compile one by
    one, which doubles the time)."""
    if route == "v3":
        fn = lambda sa, r: jv3.intersect_v3(sa, r, rows_per_block=16)
    elif route == "v2":
        fn = lambda sa, r: jv2.intersect_v2(sa, r, rows_per_block=16,
                                            profile="")
    elif route == "mxu":
        fn = lambda sa, r: jmxu.intersect_mxu(sa, r, blk=N_RAYS)
    else:
        stream = request.getfixturevalue("pallas_stream_cpg1")
        fn = lambda sa, r: stream(sa, r, rows_per_block=16)
    return lambda sa, r: jax.jit(lambda ray: fn(sa, ray))(r)


# t of the plain version against the Pallas kernel's, relative. B5 repeats
# the kernel's Woop arithmetic on coefficients that may differ in their last
# bits (XLA contracts the adjugate's products into FMAs): 2 float32 ulps,
# as for B2. B6 also sums its product in XLA's dot, in an order of its own:
# 4 ulps (2.1 measured). B4 and B3 repeat Möller-Trumbore, where XLA may
# fuse a product and a sum of the cross and dot products that the port
# rounds apart, and the determinant's cancellation amplifies that: 16 ulps
# (3.7 measured).
PALLAS_RTOL = {"v3": 2 * F32_ULP, "v2": 16 * F32_ULP, "v1": 16 * F32_ULP,
               "mxu": 4 * F32_ULP}

# B4's kernel unrolls 4 x 32 triangles, which no module constant shrinks
# without changing the record layout: interpret mode takes ~25-30 s for it,
# so its case runs only with the slow tests. B4's plain version is still
# held against the oracle, its tables against the JAX package's and its
# route against the JAX package's render.
PALLAS_ROUTES = [pytest.param(r, marks=pytest.mark.slow) if r == "v2" else r
                 for r in ROUTES]


@pytest.mark.parametrize("route", PALLAS_ROUTES)
def test_plain_matches_pallas_interpret(scene, rays, route, request):
    """Each plain version against the Pallas kernel it stands for, in
    interpret mode, closest-hit (one compile per kernel; any-hit is held
    against the oracle above): the same lanes hit, t within
    ``PALLAS_RTOL``, prim equal but at shared-edge ties; for B3 the whole
    record."""
    _, mod, isect, _ = ROUTES[route]
    (sa_j, sa_t), (jr, tr) = scene, rays
    out_j = _pallas(route, request)(sa_j, jr)
    out_t = getattr(mod, isect)(sa_t, tr)         # CPU: the plain version
    n_hit = assert_t_prim(out_t[0], out_t[1], out_j[0], out_j[1],
                          PALLAS_RTOL[route], route)
    assert n_hit > 400
    if route == "v1":
        from test_torch_intersect import _assert_hits_match
        ref = tik.HitRecord(*(torch.from_numpy(np.array(x))
                              for x in out_j))
        _assert_hits_match(out_t, ref, "B3 record vs Pallas")
        assert np.array_equal(out_t.inst.numpy(), np.asarray(out_j[2]))


# ---------------------------------------------------------------------------
# (d) each route as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_route_render_matches_jax(monkeypatch, route):
    """The port's render with MI_STREAM_KERNEL set goes through the
    route's own plain version (never B2's, never the plain Möller
    intersector) and gives the JAX package's image of the 2k animated-mesh
    scene at 16x16 x 4 spp: every pixel within rtol 1e-4 / atol 1e-4 *
    max."""
    obj, ref = jax_mesh_render()
    _, mod, _, plain = ROUTES[route]
    calls = {"route": 0, "other": 0}

    def spy(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(mod, plain, spy("route", getattr(mod, plain)))
    if route != "v3":       # B5's plain version is B2's
        monkeypatch.setattr(tv4, "intersect_v4_reference",
                            spy("other", tv4.intersect_v4_reference))
    monkeypatch.setattr(tik, "intersect_reference",
                        spy("other", tik.intersect_reference))
    monkeypatch.setenv("MI_STREAM_KERNEL", route)
    img = mt.render(mt.load_dict(animated_mesh_scene(obj, spp=4, res=16)),
                    spp=4, seed=0).numpy()
    assert calls["route"] >= 2 and calls["other"] == 0, calls
    assert img.shape == ref.shape == (16, 16, 3)
    scale = np.abs(ref).max()
    assert scale > 0.0 and np.isfinite(img).all()
    assert np.allclose(img, ref, rtol=1e-4, atol=1e-4 * scale), \
        np.abs(img - ref).max()
