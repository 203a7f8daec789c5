"""The port's alternate large-scene routes (MI_STREAM_KERNEL = v3, v2, v1,
mxu: kernels B5, B4, B3, B6) against the JAX package on the CPU, on the
mixed static + animated scene of tests/torch_port_helpers.py: the new
per-kernel tables against the JAX package's, each plain version against
the oracle ``_hit_reference`` and against the Pallas kernel run in
interpret mode (as tests/test_v3_kernel.py, test_v2_kernel.py,
test_mxu_kernel.py and test_pallas_parity.py run them), and each route as a
whole: the 2k animated-mesh scene rendered by the port with the route
selected against the JAX package's render; and B3's, B4's and B5's walks
(B4's chunk lists and B5's per-lane box test too), simulated step by step
in plain PyTorch, against their plain versions and against the work that
chip_smoke.py's bounds count (no JAX call). Inputs are made with numpy
from a seed; each tolerance is stated where it is used. The CUDA kernels
run only on the card (tests/test_torch_cuda.py)."""

import importlib.util
import itertools
import os

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
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3
from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as tik
from mitsuba3dopplertof_tpu_torch.ops import intersect_mxu as tmxu
from mitsuba3dopplertof_tpu_torch.ops import intersect_stream as tstream
from mitsuba3dopplertof_tpu_torch.ops import intersect_v2 as tv2
from mitsuba3dopplertof_tpu_torch.ops import intersect_v3 as tv3
from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as tv4
from mitsuba3dopplertof_tpu_torch.render.types import Ray
from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import \
    animated_mesh_scene

from torch_adversarial_rays import (adversarial_rays, ballot_rays,
                                    equal_t_tables, equal_t_v2_tables,
                                    equal_t_v4_tables, tight_boxes,
                                    unit_of_slot)
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
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---------------------------------------------------------------------------
# (e) B6's design: the tensor-core gate and the exact test behind it
# ---------------------------------------------------------------------------

N_ADVERSARIAL = 1024


@pytest.fixture(scope="module")
def gate_case(scene, rays):
    """B6's tables of the mixed scene, the shell rays followed by 1,024
    adversarial rays (``adversarial_rays``: edges, vertices, grazing,
    beside the plane, origins ~1e3 away) as ``prepare`` pads them, and per
    pair of lanes and triangles the plain version's t (``_affine_hit``,
    the 8-term ordered sums; +inf where the exact test rejects, with no
    best so far): (tables, x, time, t8)."""
    sa_t = scene[1]
    tb = tmxu.mxu_tables(sa_t)
    adv = adversarial_rays(sa_t, N_ADVERSARIAL, 11, "cpu")
    cat = lambda a, b: torch.cat([a, b])
    tr = rays[1]
    ray = type(tr)(type(tr.o)(*(cat(a, b) for a, b in zip(tr.o, adv.o))),
                   type(tr.d)(*(cat(a, b) for a, b in zip(tr.d, adv.d))),
                   cat(tr.time, adv.time), cat(tr.maxt, adv.maxt))
    x, time, _, _ = tmxu.prepare(tb, ray)
    assert x.shape[1] == N_RAYS + N_ADVERSARIAL
    inf = torch.full((x.shape[1], 1), float("inf"))
    t8 = torch.cat([tmxu._affine_hit(_chunk_w(tb, a, b), _features(tb, ci, x,
                                                                  time), inf)
                    for ci, a, b in tb.runs], dim=1)
    return tb, x, time, t8


def _chunk_w(tb, a, b):
    """The float32 W of chunks a..b-1 as ``_affine_hit`` takes it."""
    return tb.w[a * 8:b * 8].reshape(b - a, 8, 6, tmxu.T).permute(
        1, 2, 0, 3).reshape(8, 6, 1, (b - a) * tmxu.T)


def _features(tb, ci, x, time):
    """The eight ray features in transform group ``ci``'s hit space, as
    (L, 1) columns, with X's row 3 (ones) and row 7 (maxt)."""
    r = tstream._unit_ray(tb, ci, (x[0], x[1], x[2]), (x[4], x[5], x[6]),
                          time)
    return [c[:, None] for c in (*r[:3], x[3], *r[3:], x[7])]


def test_mxu_gate_covers_every_exact_hit(gate_case):
    """(a) The gate (``mxu_gate_reference``, the kernel's radius and reject
    rule in float32) passes every pair that the exact test accepts with
    t < maxt, on the shell rays and on the adversarial ones, with no
    tolerance; it rejects most of the shell rays' pairs (all but 2%; a
    warp of adversarial rays, with origins 1e3 away among them, has a
    radius too wide to reject much), and the adversarial rays give the
    exact test hundreds of pairs to accept. With a best t per lane and
    chunk (here each chunk's smallest exact t, on the adversarial rays),
    the gate still passes each chunk's nearest exact hit, and only pairs
    it passes with no best."""
    tb, x, time, t8 = gate_case
    gate = torch.cat([tmxu.mxu_gate_reference(
        tb, x[:, l0:l0 + 1024], time[l0:l0 + 1024], 0, tb.n_chunks)
        for l0 in range(0, x.shape[1], 1024)])
    exact = torch.isfinite(t8)
    assert int(exact[N_RAYS:].sum()) > 300 and int(exact[:N_RAYS].sum()) > 400
    assert not bool((exact & ~gate).any()), int((exact & ~gate).sum())
    assert float(gate[:N_RAYS].float().mean()) < 0.02
    adv = slice(N_RAYS, None)
    t_chunk = t8[adv].reshape(N_ADVERSARIAL, tb.n_chunks, tmxu.T)
    nearest = t_chunk.amin(dim=2)
    gate_best = tmxu.mxu_gate_reference(tb, x[:, adv], time[adv], 0,
                                        tb.n_chunks, nearest)
    first = exact[adv] & (t_chunk == nearest[:, :, None]).reshape(
        N_ADVERSARIAL, -1)
    assert int(first.sum()) > 100
    assert not bool((first & ~gate_best).any())
    assert not bool((gate_best & ~gate[adv]).any())


def test_mxu_gate_radius_covers_any_summation_order(gate_case):
    """(b) The radius GATE_EPS * S * M (M of the lane itself, not the
    warp's larger one) bounds |approximate - exact| of every component of
    every pair, where exact is the plain version's float32 8-term ordered
    sum of the float32 products and approximate sums the exact products
    of the TF32-rounded table and features in float32 forward, in
    reverse and pairwise, and in float64. No tolerance: the bound must
    hold (the differences are taken in float64); the largest ratio is
    reported."""
    tb, x, time, _ = gate_case
    w = tb.w.reshape(tb.n_chunks, 8, 6, tmxu.T)
    wt = tmxu._unfragment(tb.frag, tb.n_chunks).reshape(w.shape)
    s = w.abs().sum(dim=1).double() * tmxu.GATE_EPS     # (n, 6, T)
    worst = 0.0
    for (ci, a, b), l0 in itertools.product(tb.runs,
                                            range(0, x.shape[1], 512)):
        # 512 lanes at a time: temporaries that stay in the CPU's caches
        f = _features(tb, ci, x[:, l0:l0 + 512], time[l0:l0 + 512])
        f[7] = torch.zeros_like(f[7])               # maxt meets zeros
        ft = [tmxu.tf32_round(c) for c in f]
        m = (torch.cat(f[:4], dim=1).abs().amax(dim=1, keepdim=True),
             torch.cat(f[4:7], dim=1).abs().amax(dim=1, keepdim=True))
        for c in range(6):
            wc = w[a:b, :, c].permute(1, 0, 2).reshape(8, -1)
            wtc = wt[a:b, :, c].permute(1, 0, 2).reshape(8, -1)
            exact = wc[0] * f[0]
            for k in range(1, 8):
                exact = exact + wc[k] * f[k]
            exact = exact.double()
            p = [wtc[k] * ft[k] for k in range(8)]  # exact in float32
            fwd, rev = p[0], p[7]
            for k in range(1, 8):
                fwd, rev = fwd + p[k], rev + p[7 - k]
            pair = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5])
                                                      + (p[6] + p[7]))
            f64 = p[0].double()
            for k in range(1, 8):
                f64 = f64 + p[k]
            err = (f64 - exact).abs()
            for approx in (fwd, rev, pair):
                err = torch.maximum(err, (approx.double() - exact).abs())
            rad = s[a:b, c].reshape(-1) * m[c // 3].double()
            assert bool((err <= rad).all()), (ci, c)
            worst = max(worst, float((err / rad.clamp(min=1e-300)).max()))
    assert 0.0 < worst <= 1.0
    print(f"largest |approximate - exact| / radius: {worst:.3g}")


def test_mxu_zero_skipped_sums_match_ordered_sums(gate_case):
    """(c) The exact test as the kernel computes it, from the float32
    Woop rows with W's structural zeros skipped (o' = ((w0 ox + w1 oy) +
    w2 oz) + w3, d' = (w4 dx + w5 dy) + w6 dz), gives the same hit
    decision on every pair and bitwise the same t on every hit as the
    plain version's 8-term ordered sums: no tolerance."""
    tb, x, time, t8 = gate_case
    rec = tb.rec.reshape(-1, 3, 4)
    out = []
    for ci, a, b in tb.runs:
        f = _features(tb, ci, x, time)
        rw = rec[a * tmxu.T:b * tmxu.T]
        o = [((rw[:, i, 0] * f[0] + rw[:, i, 1] * f[1]) + rw[:, i, 2] * f[2])
             + rw[:, i, 3] for i in range(3)]
        d = [(rw[:, i, 0] * f[4] + rw[:, i, 1] * f[5]) + rw[:, i, 2] * f[6]
             for i in range(3)]
        dz_ok = d[2].abs() > 1e-30
        t = -o[2] / torch.where(dz_ok, d[2], 1.0)
        u = o[0] + t * d[0]
        v = o[1] + t * d[1]
        hit = (dz_ok & (torch.minimum(u, v) >= 0.0) & (u + v <= 1.0)
               & (t > 0.0) & (t < f[7]))
        out.append(torch.where(hit, t, float("inf")))
    t_skip = torch.cat(out, dim=1)
    assert int(torch.isfinite(t8).sum()) > 700
    assert torch.equal(t_skip.view(torch.int32), t8.view(torch.int32))


def test_mxu_prepare_leaves_out_nan_maxt(scene, rays):
    """B6's ``prepare`` on a 256-lane block of the shell rays in which one
    lane's maxt is NaN: the block's visit list is the one it has with that
    lane dead (maxt -1), and every other lane that the plain version hits
    finds its hit's chunk on the list, entered no later than the hit (the
    walk reaches it). JAX's amax would carry the NaN and empty the list."""
    sa_t = scene[1]
    tb = tmxu.mxu_tables(sa_t)
    ray = _head(rays[1], tmxu.BLOCK)
    lane = torch.arange(tmxu.BLOCK)
    nan_lane = 5
    with_nan = ray._replace(maxt=torch.where(lane == nan_lane, float("nan"),
                                             ray.maxt))
    dead = ray._replace(maxt=torch.where(lane == nan_lane, -1.0, ray.maxt))
    x, _, order, tlo = tmxu.prepare(tb, with_nan)
    assert bool(torch.isnan(x[7, nan_lane]))      # the kernel still sees it
    _, _, order_d, tlo_d = tmxu.prepare(tb, dead)
    assert torch.equal(order, order_d) and torch.equal(tlo, tlo_d)
    t, prim = tmxu.intersect_mxu_reference(sa_t, with_nan)
    hit = torch.isfinite(t) & (lane != nan_lane)
    assert int(hit.sum()) >= 48
    slots = (tb.meta[:, 1:2] + torch.arange(tmxu.T)).reshape(-1)
    chunk_of = torch.full((int(slots.max()) + 1,), -1, dtype=torch.int64)
    chunk_of[slots.long()] = torch.arange(tb.n_chunks).repeat_interleave(
        tmxu.T)
    entry = torch.full((tb.n_chunks,), float("inf"))
    entry[order[0].long()] = torch.where(tlo[0] < tmxu._BIG, tlo[0],
                                         float("inf"))
    reach = entry[chunk_of[prim[hit].long()]]
    assert bool((reach <= t[hit]).all())


def test_mxu_fragment_table_is_tf32_woop_table(scene):
    """(d) The fragment-ordered table, read as ``mma.m16n8k8``'s A
    fragments are defined (lane 4g + c holds A[g][c], A[g+8][c],
    A[g][c+4], A[g+8][c+4]; tile m of group q has components 2m and
    2m + 1 of triangle 8q + g in rows g and g + 8), equals ``_woop_table``
    rounded to TF32 (to nearest, ties away from zero), exactly; and the
    radius table holds GATE_EPS times each component's sum of |w|, with
    -1 for o'z and d'z of the zero rows."""
    sa_j, sa_t = scene
    seg, _, n_units = _layout(sa_j)
    n_chunks = n_units // tmxu.SUBS
    tb = tmxu.mxu_tables(sa_t)
    w = tmxu._woop_table(sa_t, seg, n_chunks).numpy().reshape(
        n_chunks, 8, 6, tmxu.T)
    frag = tb.frag.numpy().reshape(n_chunks, tmxu.T // 8, 3, 32, 4)
    a = np.zeros((n_chunks, tmxu.T // 8, 3, 16, 8), np.float32)
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for i, (row, col) in enumerate(((g, c), (g + 8, c), (g, c + 4),
                                        (g + 8, c + 4))):
            a[:, :, :, row, col] = frag[:, :, :, lane, i]
    # a[n, q, m, half * 8 + g, k] = W[n, k, 2m + half, 8q + g]
    back = a.reshape(n_chunks, tmxu.T // 8, 3, 2, 8, 8).transpose(
        0, 5, 2, 3, 1, 4).reshape(w.shape)
    bits = w.view(np.int32).astype(np.int64)
    want = (((bits + 0x1000) & ~0x1FFF) & 0xFFFFFFFF).astype(
        np.uint32).view(np.float32)
    assert np.array_equal(back, want)
    assert np.array_equal(tmxu.tf32_round(torch.from_numpy(w)).numpy(), want)
    rel = np.abs(want - w) / np.maximum(np.abs(w), 1e-38)
    assert rel.max() <= 2.0 ** -11 and (want != w).any()
    s = tb.rad.numpy().reshape(n_chunks, tmxu.T, 8)
    ref = np.abs(w).sum(axis=1).transpose(0, 2, 1) * tmxu.GATE_EPS
    dead = ref[:, :, 5] == 0
    assert 200 < dead.sum()
    ref[dead, 2] = ref[dead, 5] = -1.0
    assert np.allclose(s[:, :, :6], ref, rtol=1e-6, atol=0.0)
    assert not s[:, :, 6:].any()


# ---------------------------------------------------------------------------
# (f) B3's walk: block lists by entry distance, warps alone on their live
#     lanes, the (t, row) tie rule
# ---------------------------------------------------------------------------

N_COHERENT = 1024


def _coherent_rays(n, seed):
    """``n`` rays from the mixed scene's camera position (0, 0, -6), 32 a
    pixel of a 6 x 6 unit window at z = 0 in pixel order, as a camera
    wavefront lays them out; times in [0, 1]. Made with numpy."""
    rng = np.random.default_rng(seed)
    pix = np.arange(n) // 32
    side = int(np.ceil(np.sqrt(n / 32)))
    tgt = np.stack([((pix % side) + rng.uniform(0.0, 1.0, n)) / side,
                    ((pix // side) + rng.uniform(0.0, 1.0, n)) / side],
                   axis=1) * 6.0 - 3.0
    d = np.concatenate([tgt, np.full((n, 1), 6.0)], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile([0.0, 0.0, -6.0], (n, 1))
    return o, d, rng.uniform(0.0, 1.0, n), np.full(n, np.inf)


@pytest.fixture(scope="module")
def walk_case(scene, rays):
    """B3's tables of the mixed scene and 4,096 rays: the shell rays, 1,024
    coherent rays (``_coherent_rays``, whose warps' gates cull) and 1,024
    ``adversarial_rays``, with every seventh lane, the lanes of one warp
    and those of one 256-lane block dead (maxt -1, as the lanes whose
    camera ray missed): (tables, rays, the plain version's record)."""
    sa_t = scene[1]
    coh = both_rays(*_coherent_rays(N_COHERENT, 14))[1]
    adv = adversarial_rays(sa_t, N_ADVERSARIAL, 13, "cpu")
    parts = (rays[1], coh, adv)
    cat = lambda f: torch.cat([f(r) for r in parts])
    lane = torch.arange(N_RAYS + N_COHERENT + N_ADVERSARIAL)
    dead = (lane % 7 == 3) | ((lane >= 64) & (lane < 96)) \
        | ((lane >= 512) & (lane < 768))
    tr = rays[1]
    ray = type(tr)(type(tr.o)(*(cat(lambda r: r.o[i]) for i in range(3))),
                   type(tr.d)(*(cat(lambda r: r.d[i]) for i in range(3))),
                   cat(lambda r: r.time),
                   torch.where(dead, -1.0, cat(lambda r: r.maxt)))
    return (tstream.stream_tables(sa_t), ray,
            tstream.intersect_stream_reference(sa_t, ray))


def _head(ray, n):
    """The first ``n`` lanes of ``ray``."""
    return type(ray)(type(ray.o)(*(c[:n] for c in ray.o)),
                     type(ray.d)(*(c[:n] for c in ray.d)), ray.time[:n],
                     ray.maxt[:n])


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_walk_matches_plain(scene, walk_case, monkeypatch, any_hit):
    """The walk (``stream_walk_reference``) on 4,000 of the rays (the last
    block padded with dead lanes): closest-hit t bit for bit and prim
    equal to the plain version's on every lane, any-hit occlusion exact;
    then with the triangles of one chunk copied into a pad chunk of another
    group whose box is the scene's (``equal_t_tables``: equal t in two
    groups, the copy's group first in many blocks' lists), where the
    first row must still win; a tie rule of strict t < best would return
    the copy's slot on those lanes."""
    tb, ray, ref = walk_case
    n = 4000
    ray = _head(ray, n)
    walk = tstream.stream_walk_reference(tb, tstream.prepare(tb, ray),
                                         any_hit)
    hit = ref.prim[:n] >= 0
    assert int(hit.sum()) > 700
    assert torch.equal(walk.prim[:n] >= 0, hit)
    assert not bool((walk.prim[n:] >= 0).any())
    if not any_hit:
        assert torch.equal(walk.t[:n][hit], ref.t[:n][hit])
        assert torch.equal(walk.prim[:n], ref.prim[:n])

    tb2, k, p = equal_t_tables(tb, ref.prim, tstream.group_keys(
        tb, tstream.prepare(tb, ray)))
    monkeypatch.setitem(scene[1]._cache, "stream", tb2)
    ref2 = tstream.intersect_stream_reference(scene[1], ray)
    prep = tstream.prepare(tb2, ray)
    walk = tstream.stream_walk_reference(tb2, prep, any_hit)
    hit = ref2.prim >= 0
    copied = torch.isin(ref2.prim, tb2.slots[32 * k:32 * k + 32]) & hit
    keys = tstream.group_keys(tb2, prep)
    first = (keys[:, p // 8] < keys[:, k // 8]).repeat_interleave(
        tstream.BLOCK)[:n]
    assert int((copied & first).sum()) > 10
    assert torch.equal(walk.prim[:n] >= 0, hit)
    if not any_hit:
        assert torch.equal(walk.t[:n][hit], ref2.t[hit])
        assert torch.equal(walk.prim[:n], ref2.prim)


def test_stream_group_lists_in_rounds(walk_case):
    """The block lists (``group_keys``, ``group_rounds``): the reachable
    groups of each block in the order of a stable ``torch.argsort`` of the
    keys, whatever the capacity; capacities of 1 and 2 groups force rounds,
    and the walk over them tests the same chunks and finds the same hits
    as over one round."""
    tb, ray, _ = walk_case
    prep = tstream.prepare(tb, ray)
    keys = tstream.group_keys(tb, prep)
    n_groups = tb.n_chunks // tstream.CPG
    assert keys.shape == (ray.maxt.shape[0] // tstream.BLOCK, n_groups)
    reach = keys < 3e38
    assert bool(reach.any()) and not bool(reach.all())
    assert not bool(reach[2].any())          # the block whose lanes are dead
    order = torch.argsort(keys, dim=1, stable=True)
    one = tstream.stream_walk_reference(tb, prep, False)
    assert one.rounds == 1
    for cap in (1, 2, n_groups):
        rounds = tstream.group_rounds(keys, cap)
        assert len(rounds) == -(-int(reach.sum(dim=1).max()) // cap)
        ent = torch.cat(rounds, dim=1)
        for b in range(keys.shape[0]):
            got = ent[b][ent[b] >= 0] & 0xFFFFFFFF
            assert torch.equal(got, order[b, :int(reach[b].sum())]), (cap, b)
        if cap < n_groups:
            walk = tstream.stream_walk_reference(tb, prep, False, cap=cap)
            assert walk.rounds == len(rounds) > 1
            assert torch.equal(walk.tested, one.tested)
            assert torch.equal(walk.t, one.t)
            assert torch.equal(walk.prim, one.prim)


@pytest.fixture(scope="module")
def v2_case(scene, walk_case):
    """B4's tables of the mixed scene, ``walk_case``'s 4,096 rays (shell,
    coherent and adversarial, with dead lanes) and B4's plain (t, prim) on
    them."""
    ray = walk_case[1]
    return (tv2.v2_tables(scene[1]), ray,
            tv2.intersect_v2_reference(scene[1], ray))


@pytest.fixture(scope="module")
def v3_case(scene, walk_case):
    """B2's tables of the mixed scene (which B5 walks), ``walk_case``'s
    4,096 rays and B5's plain (t, prim) on them (B2's)."""
    ray = walk_case[1]
    return (tv4.v4_tables(scene[1]), ray,
            tv3.intersect_v3_reference(scene[1], ray))


@pytest.fixture(scope="module")
def walk_work(scene, walk_case, v2_case, v3_case):
    """chip_smoke.py's ``WalkWork`` on ``walk_case``'s rays, one for each
    form (any_hit False, True), with B5's (B2's) plain t as its final t,
    B3's and B4's: built once for the B3, B4 and B5 count tests."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ray, ref = walk_case[1:]
    t_b4 = v2_case[2][0]
    t_b5 = v3_case[2][0]
    return {a: chip_smoke.WalkWork(scene[1], ray, t_b5, a, t_b3=ref.t,
                                   t_b4=t_b4)
            for a in (False, True)}


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_walk_counts_match_chip_smoke(walk_case, walk_work, any_hit):
    """chip_smoke.py's count of the chunks B3's warps must test
    (``WalkWork.b3_warps``, vectorised) equals the step-by-step walk's with
    the same far ends, chunk for chunk and warp by warp, and that walk
    finds the plain version's hits. The walk on its own far ends tests
    those chunks and more closest-hit (its far end only shrinks to the
    final one), and no others any-hit (it stops inside an entry once every
    live lane is occluded)."""
    tb, ray, ref = walk_case
    per_warp, tested, far, _, _ = walk_work[any_hit].b3_warps()
    prep = tstream.prepare(tb, ray)
    walk = tstream.stream_walk_reference(tb, prep, any_hit, far=far)
    assert torch.equal(walk.tested, tested)
    assert torch.equal(walk.tested.sum(dim=1), per_warp)
    coherent = slice(N_RAYS // 32, (N_RAYS + N_COHERENT) // 32)
    assert 0 < int(per_warp[coherent].sum()) < tested[coherent].numel() // 2
    hit = ref.prim >= 0
    assert torch.equal(walk.prim >= 0, hit)
    if not any_hit:
        assert torch.equal(walk.t[hit], ref.t[hit])
    own = tstream.stream_walk_reference(tb, prep, any_hit).tested
    assert torch.equal(own | tested, tested if any_hit else own)


# ---------------------------------------------------------------------------
# (g) B4's lists and walk: chunk lists by entry distance in rounds, warps
#     on their own far ends and live-lane quarter gates, the (t, slot) tie
#     rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 1, 3])
def test_v2_lists_match_visit_order(v2_case, cap):
    """B4's in-kernel lists in plain PyTorch (``v2_lists_reference``)
    equal ``_visit_order`` on ``prepare``'s inputs bit for bit: the same
    order and bitwise-equal t_lo, in one round and in rounds of 1 and 3
    chunks; the reachable count per block, with some blocks reaching every
    chunk and the block of dead lanes none."""
    tb, ray, _ = v2_case
    order_r, tlo_r = tv2.prepare(tb, ray)[4:]
    order, tlo, length = tv2.v2_lists_reference(tb, ray, cap)
    assert torch.equal(order, order_r)
    assert torch.equal(tlo.view(torch.int32), tlo_r.view(torch.int32))
    assert torch.equal(length, (tlo_r < 3e38).sum(dim=1, dtype=torch.int32))
    assert int(length[2]) == 0 and int(length.max()) == tb.n_chunks
    assert torch.equal(tv2.lists(tb, ray, cap)[0], order)
    keys = tv2.chunk_keys(tb, ray)
    rounds = tstream.group_rounds(keys, cap or tb.n_chunks)
    assert len(rounds) == -(-tb.n_chunks // (cap or tb.n_chunks))


@pytest.mark.parametrize("any_hit", [False, True])
def test_v2_walk_matches_plain(scene, v2_case, monkeypatch, any_hit):
    """B4's walk (``v2_walk_reference``) on 4,000 of the rays (the last
    block padded with dead lanes): closest-hit t bit for bit and prim
    equal to ``intersect_v2_reference`` on every lane, any-hit occlusion
    exact; then with one quarter's triangles copied into a new chunk whose
    box is the scene's (``equal_t_v2_tables``: equal t at a higher slot,
    the copy's chunk first in many blocks' lists), where the smaller slot
    must still win; a tie rule of strict t < best would return the copy's
    slot on those lanes."""
    tb, ray, (t_ref, p_ref) = v2_case
    n = 4000
    ray = _head(ray, n)
    walk = tv2.v2_walk_reference(tb, tv2.prepare(tb, ray), any_hit)
    hit = p_ref[:n] >= 0
    assert int(hit.sum()) > 700
    assert torch.equal(walk.prim[:n] >= 0, hit)
    assert not bool((walk.prim[n:] >= 0).any())
    if not any_hit:
        assert torch.equal(walk.t[:n][hit], t_ref[:n][hit])
        assert torch.equal(walk.prim[:n], p_ref[:n])

    tb2, k, c = equal_t_v2_tables(tb, p_ref[:n], tv2.chunk_keys(tb, ray))
    monkeypatch.setitem(scene[1]._cache, "v2", tb2)
    t2, p2 = tv2.intersect_v2_reference(scene[1], ray)
    walk = tv2.v2_walk_reference(tb2, tv2.prepare(tb2, ray), any_hit)
    hit = p2 >= 0
    copied = torch.isin(p2, tb2.slots[32 * k:32 * k + 32]) & hit
    keys = tv2.chunk_keys(tb2, ray)
    first = (keys[:, c] < keys[:, k // 4]).repeat_interleave(tv2.BLOCK)[:n]
    assert int((copied & first).sum()) > 10
    assert torch.equal(walk.prim[:n] >= 0, hit)
    if not any_hit:
        assert torch.equal(walk.t[:n][hit], t2[hit])
        assert torch.equal(walk.prim[:n], p2)


@pytest.mark.parametrize("any_hit", [False, True])
def test_v2_walk_counts_match_chip_smoke(v2_case, walk_work, any_hit):
    """chip_smoke.py's count of the quarters B4's warps must test
    (``WalkWork.b4_warps``, vectorised) equals the step-by-step walk's with
    the same far ends, quarter for quarter and warp by warp, and that walk
    finds the plain version's hits. The walk on its own far ends tests
    those quarters and more closest-hit (its far end only shrinks to the
    final one), and no others any-hit (it stops once every live lane is
    occluded)."""
    tb, ray, (t_ref, p_ref) = v2_case
    per_warp, tested, far, reach = walk_work[any_hit].b4_warps()
    prep = tv2.prepare(tb, ray)
    walk = tv2.v2_walk_reference(tb, prep, any_hit, far=far)
    assert torch.equal(walk.tested, tested)
    assert torch.equal(walk.tested.sum(dim=1), per_warp)
    coherent = slice(N_RAYS // 32, (N_RAYS + N_COHERENT) // 32)
    assert 0 < int(per_warp[coherent].sum()) < tested[coherent].numel() // 2
    assert int(reach.max()) <= tb.n_chunks
    hit = p_ref >= 0
    assert torch.equal(walk.prim >= 0, hit)
    if not any_hit:
        assert torch.equal(walk.t[hit], t_ref[hit])
    own = tv2.v2_walk_reference(tb, prep, any_hit).tested
    assert torch.equal(own | tested, tested if any_hit else own)


# ---------------------------------------------------------------------------
# (h) B5's walk: B2's lists and shared walks, and a per-lane ray-box test
#     (a ballot of the warp) ahead of each unit
# ---------------------------------------------------------------------------

def _unit_keys(tb, ray):
    """(n_blocks, n_units): each block's entry distance into each unit box
    (``intersect_v4.prepare``'s lists, unsorted)."""
    order, tlo = tv4.prepare(tb, ray)[4:]
    return torch.empty_like(tlo).scatter_(1, order.long(), tlo)


@pytest.mark.parametrize("any_hit", [False, True])
def test_v3_walk_matches_plain(scene, v3_case, monkeypatch, any_hit):
    """B5's walk (``v3_walk_reference``) on 4,000 of the rays (the last
    block padded with dead lanes): closest-hit t bit for bit and prim
    equal to the plain version's on every lane, any-hit occlusion exact;
    then with one unit's triangles copied into a new unit whose box is the
    scene's (``equal_t_v4_tables``: equal t at a higher slot, the copy
    first in many blocks' lists), where the smaller slot must still win; a
    tie rule of strict t < best would return the copy's slot there, and a
    far end that left out ties would skip the original."""
    tb, ray, (t_ref, p_ref) = v3_case
    n = 4000
    ray = _head(ray, n)
    walk = tv3.v3_walk_reference(tb, ray, any_hit)
    hit = p_ref[:n] >= 0
    assert int(hit.sum()) > 700
    assert torch.equal(walk.prim[:n] >= 0, hit)
    assert not bool((walk.prim[n:] >= 0).any())
    if not any_hit:
        assert torch.equal(walk.t[:n][hit], t_ref[:n][hit])
        assert torch.equal(walk.prim[:n], p_ref[:n])

    tb2, k, c = equal_t_v4_tables(tb, p_ref[:n], _unit_keys(tb, ray))
    monkeypatch.setitem(scene[1]._cache, "v4", tb2)
    t2, p2 = tv3.intersect_v3_reference(scene[1], ray)
    walk = tv3.v3_walk_reference(tb2, ray, any_hit)
    hit = p2 >= 0
    copied = torch.isin(p2, tb2.meta[k, 1] + torch.arange(32)) & hit
    keys = _unit_keys(tb2, ray)
    first = (keys[:, c] < keys[:, k]).repeat_interleave(tv3.BLOCK)[:n]
    assert int((copied & first).sum()) > 10
    assert torch.equal(walk.prim[:n] >= 0, hit)
    if not any_hit:
        assert torch.equal(walk.t[:n][hit], t2[hit])
        assert torch.equal(walk.prim[:n], p2)


@pytest.mark.parametrize("cap", [1, 3])
def test_v3_lists_in_rounds(v3_case, cap):
    """B5's lists are B2's, built in the kernel in rounds of ``cap``
    entries (``list_round``; ``intersect_stream.group_rounds`` in plain
    PyTorch): rounds of 1 and 3 units take each block's reachable units in
    ``prepare``'s order, the order ``v3_walk_reference`` walks, in as
    many rounds as the largest block needs."""
    tb, ray, _ = v3_case
    keys = _unit_keys(tb, ray)
    order, tlo = tv4.prepare(tb, ray)[4:]
    reach = (tlo < 3e38).sum(dim=1)
    assert int(reach.max()) > 3 and int(reach.min()) < tb.n_units
    rounds = tstream.group_rounds(keys, cap)
    assert len(rounds) == -(-int(reach.max()) // cap)
    ent = torch.cat(rounds, dim=1)
    for b in range(keys.shape[0]):
        got = ent[b][ent[b] >= 0] & 0xFFFFFFFF
        assert torch.equal(got, order[b, :int(reach[b])].long()), b


@pytest.mark.parametrize("any_hit", [False, True])
def test_v3_walk_counts_match_chip_smoke(v3_case, walk_work, any_hit):
    """chip_smoke.py's count of the units B5's warps must test
    (``WalkWork.b5_warps``, vectorised) equals the step-by-step walk's with
    the same far ends, unit for unit and warp by warp, and that walk finds
    the plain version's hits. On the incoherent shell rays the per-lane
    test leaves fewer units than B2's gate on the warp's ray bounds
    (``WalkWork.b2_warps``); on the coherent rays it culls most of each
    warp's units. The walk on its own far ends tests those units and more
    closest-hit (its far ends only shrink to the final ones), and the same
    any-hit (a lane takes part up to its first hit either way)."""
    tb, ray, (t_ref, p_ref) = v3_case
    per_warp, tested, far, reach = walk_work[any_hit].b5_warps()
    walk = tv3.v3_walk_reference(tb, ray, any_hit, far=far)
    assert torch.equal(walk.tested, tested)
    assert torch.equal(tested.sum(dim=1), per_warp)
    assert bool((per_warp <= reach).all())
    shell = slice(0, N_RAYS // 32)
    coherent = slice(N_RAYS // 32, (N_RAYS + N_COHERENT) // 32)
    b2 = walk_work[any_hit].b2_warps()[0]
    assert 0 < int(per_warp[shell].sum()) < int(b2[shell].sum())
    assert 0 < int(per_warp[coherent].sum()) < tested[coherent].numel() // 2
    hit = p_ref >= 0
    assert torch.equal(walk.prim[:hit.shape[0]] >= 0, hit)
    if not any_hit:
        assert torch.equal(walk.t[:hit.shape[0]][hit], t_ref[hit])
    own = tv3.v3_walk_reference(tb, ray, any_hit).tested
    assert torch.equal(own | tested, own)
    if any_hit:
        assert torch.equal(own, tested)


def test_v3_ballot_keeps_every_hit(scene):
    """B5's per-lane box test in its plain form (``lane_box_test``) never
    drops the unit of a plain-version hit: on 4,000 ``ballot_rays`` (zero
    and -0 direction components through edges and vertices, origins on
    box faces and edges, rays grazing box corners, maxt exactly at or just
    past a hit, NaN maxt; the last block ragged), each hit lane's own ray
    passes the test against its winner's unit with the tightest far end a
    walk can hold there (the hit's own t), against the table's boxes and
    against boxes shrunk to their triangles' exact bounds
    (``tight_boxes``). There, rays with a zero direction component start
    in a face plane of the winner's box ((b - o) / 0 = NaN): a test with
    fminf/fmaxf, which drop the NaN, would reject them, and one without
    the scaled far side would reject others. The walk over these rays
    (``v3_walk_reference``) equals the plain version."""
    sa_t = scene[1]
    tb = tv4.v4_tables(sa_t)
    n = 4000
    ray = ballot_rays(sa_t, tb, n, 3, "cpu")
    t, p = tv3.intersect_v3_reference(sa_t, ray)
    hit = p >= 0
    assert int(hit.sum()) > 1500 and int(torch.isnan(ray.maxt).sum()) > 500
    unit = unit_of_slot(tb)[p[hit].long()]
    assert bool((unit >= 0).all())
    o = tuple(c[hit] for c in ray.o)
    inv = tuple(1.0 / c[hit] for c in ray.d)
    for boxes in (tb.box, tight_boxes(sa_t, tb)):
        box = boxes[unit]
        assert bool(tv3.lane_box_test(o, inv, box, t[hit]).all())
        lo, hi = torch.zeros_like(t[hit]), t[hit]
        lo_u, hi_u = lo, hi
        nan = torch.zeros_like(hit[hit])
        for ax in range(3):
            t0 = (box[:, ax] - o[ax]) * inv[ax]
            t1 = (box[:, 3 + ax] - o[ax]) * inv[ax]
            nan |= torch.isnan(t0) | torch.isnan(t1)
            lo = torch.fmax(lo, torch.fmin(t0, t1))
            hi = torch.fmin(hi, torch.fmax(t0, t1))
            en, ex = torch.minimum(t0, t1), torch.maximum(t0, t1)
            lo_u = torch.where(en > lo_u, en, lo_u)
            hi_u = torch.where(ex < hi_u, ex, hi_u)
        dropped_nan = int((lo > hi * tv3.SLAB_SLACK).sum())
        dropped_unscaled = int((lo_u > hi_u).sum())
        assert dropped_unscaled > 0
        if boxes is not tb.box:
            assert int(nan.sum()) > 20 and dropped_nan == int(nan.sum())
    for any_hit in (False, True):
        walk = tv3.v3_walk_reference(tb, ray, any_hit)
        assert torch.equal(walk.prim[:n] >= 0, hit)
        if not any_hit:
            assert torch.equal(walk.t[:n][hit], t[hit])
            assert torch.equal(walk.prim[:n], p)


def test_v3_query_builds_no_lists(scene, monkeypatch):
    """``intersect_v3`` on tensors that are not on the CPU (here "meta"
    tensors, which carry no data) takes the card's path: one launch of the
    kernel over B2's tables and the rays as given, with no visit list
    built in PyTorch (``prepare`` and ``_unit_visit_order`` never
    called)."""
    sa_t = scene[1]
    calls = []

    def spy(*args, **kwargs):
        raise AssertionError("B5 built its visit lists in PyTorch")

    def launch(tables, ray, any_hit, cap=None):
        calls.append((tables, ray, any_hit, cap))
        n = ray.maxt.shape[0]
        return (torch.empty(n, device="meta"),
                torch.empty(n, dtype=torch.int32, device="meta"))
    monkeypatch.setattr(tv4, "prepare", spy)
    monkeypatch.setattr(tv4, "_unit_visit_order", spy)
    monkeypatch.setattr(tv3, "_unit_visit_order", spy)
    monkeypatch.setattr(tv3, "launch", launch)
    col = lambda: torch.empty(300, device="meta")
    r = Ray(Vec3(col(), col(), col()), Vec3(col(), col(), col()), col(),
            col())
    for any_hit in (False, True):
        t, prim = tv3.intersect_v3(sa_t, r, any_hit=any_hit)
        assert t.shape == (300,) and prim.dtype == torch.int32
    assert [c[2:] for c in calls] == [(False, None), (True, None)]
    assert all(c[0] is tv4.v4_tables(sa_t) and c[1] is r for c in calls)
