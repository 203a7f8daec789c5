"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; without one (or
without the package beside it) it exits non-zero and prints no result.
Every phase raises on failure:

  1. the card: name and power limit (nvidia-smi);
  2. build both kernels from the checkout, one nvcc each, started together:
     B1 (csrc/intersect_bruteforce.cu) and B2 (csrc/intersect_v4.cu), with
     their registers and spills (ptxas -v);
  3. B1 against its plain PyTorch version on the card: 1M random rays in
     the canonical scene, the canonical scene's camera wavefront and its
     shadow wavefront (the main path's shapes), and a scene with spheres
     and animated cubes; closest-hit and any-hit, with the hit-matching
     criteria of tests/test_pallas_parity.py and an exact occlusion match;
     then kernel and plain times at the main path's shapes;
  4. B2 against its plain PyTorch version on the card, on the 40k animated
     UV-sphere scene and the static 50k one (utils/bench_scenes.py, the
     JAX package's scripts/bench_suite.py scenes): a camera wavefront of
     1,048,576 lanes (one strip pass), shadow rays toward the point light
     and diffuse bounce rays from the camera hits; closest-hit and any-hit,
     binned and unbinned. t bitwise equal on hit lanes, prim different
     only at ties in t, occlusion exact; then kernel and plain times;
  5. the main path of the small scenes: scenes/canonical/scene.xml rendered
     at 256x256 x 1024 spp by dopplertofpath through B1 (launch counts read
     around the render), twice, the second render timed;
  6. the main path of the large scenes: the 40k animated scene at 256x256
     x 256 spp through B2 on the default device (launch counts read around
     the render), twice, the second render timed;
  7. binning is a permutation: the 40k scene at 64x64 x 16 spp with and
     without MI_NO_RAY_BINNING gives equal images;
  8. the port on the card against the port on the CPU at 16x16 x 16 spp:
     the canonical scene (dopplertofpath and path) and the 2k animated
     scene (B2 and binning on the card, the plain intersector on the CPU);
  9. a JSON line with the kernels, then the contract line
     {"ok": true, "device": {...}}.

Bounds (``bound_ms``): the larger of the bytes a kernel must move (each
input read once, each output written once) over the card's memory rate and
the float32 operations it must do on this run's inputs over the card's
float32 rate (NVIDIA's H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s outside
the tensor cores). For B2 the operations count the units that the blocks
of the timed wavefront really visited. No single PyTorch call computes a
ray-triangle query, so ``library_ms`` is null.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CANONICAL = os.path.join(ROOT, "scenes", "canonical", "scene.xml")
B1_SOURCE = "mitsuba3dopplertof_tpu_torch/csrc/intersect_bruteforce.cu"
B1_TPU = "mitsuba3dopplertof_tpu/ops/intersect_kernel.py:139"
B2_SOURCE = "mitsuba3dopplertof_tpu_torch/csrc/intersect_v4.cu"
B2_TPU = "mitsuba3dopplertof_tpu/ops/intersect_v4.py:68"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
# float32 operations of one ray-triangle test, counted in the kernels'
# source: Möller-Trumbore in B1 (edge crosses, determinant, division,
# three dot products, six compares), the Woop test in B2 (three affine
# rows of 11, division, two multiply-adds, seven compares)
MOLLER_OPS = 56
WOOP_OPS = 48
# per lane and animated range: lerp of 12 entries, adjugate inverse and
# the ray's transform
INV_LERP_OPS = 130
WAVEFRONT = 1 << 20             # lanes of one strip pass


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by) of work that moves ``n_bytes`` and does
    ``n_ops`` float32 operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_hits(hk, hr, label, sph_base):
    """tests/test_pallas_parity.py::_assert_hits_match criteria; returns
    the largest absolute difference over the compared payload."""
    import numpy as np
    k = {f: getattr(hk, f).cpu().numpy() for f in hk._fields}
    r = {f: getattr(hr, f).cpu().numpy() for f in hr._fields}
    both_miss = (k["prim"] < 0) & (r["prim"] < 0)
    t_close = np.isclose(k["t"], r["t"], rtol=2e-4, atol=1e-5) | both_miss
    if not t_close.all():
        fail(f"{label}: t mismatch on {(~t_close).sum()} lanes")
    same = k["prim"] == r["prim"]
    m = same & ~both_miss
    if not (k["inst"][m] == r["inst"][m]).all():
        fail(f"{label}: instance mismatch")
    err = float(np.abs(k["t"][m] - r["t"][m]).max(initial=0.0))
    for f in ("u", "v", "uv_u", "uv_v"):
        if not np.allclose(k[f][m], r[f][m], rtol=1e-3, atol=1e-4):
            fail(f"{label}: {f} mismatch")
        err = max(err, float(np.abs(k[f][m] - r[f][m]).max(initial=0.0)))
    for pre in ("gn", "ns"):
        a = np.stack([k[pre + c][m] for c in "xyz"], -1)
        b = np.stack([r[pre + c][m] for c in "xyz"], -1)
        err = max(err, float(np.abs(a - b).max(initial=0.0)))
        a /= np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)
        b /= np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-20)
        if not ((a * b).sum(-1) > 1.0 - 1e-4).all():
            fail(f"{label}: {pre} direction mismatch")
    bad = ~same & ~both_miss
    if not np.isclose(k["t"][bad], r["t"][bad], rtol=1e-3).all():
        fail(f"{label}: prim mismatch at a non-tie on {bad.sum()} lanes")
    if m.sum() < len(m) // 20:
        fail(f"{label}: only {m.sum()} hits, too few to test anything")
    # triangle hits of the two versions agree bit for bit (--fmad=false)
    tri = m & (r["prim"] < sph_base)
    return err, int(tri.sum()), int((k["t"][tri] != r["t"][tri]).sum())


def camera_wavefront(scene, n, lane0, spp, shutter, seed):
    """``n`` camera rays of consecutive lanes from ``lane0``, ``spp``
    lanes per pixel in pixel order (the integrator's strip-pass layout),
    film offsets and times drawn with numpy."""
    import numpy as np
    import torch
    from mitsuba3dopplertof_tpu_torch.sensors import sample_ray_kind
    sensor = scene.sensor
    W, H = sensor.film.crop_size
    rng = np.random.default_rng(seed)
    pix = (lane0 + np.arange(n)) // spp
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                    device=scene.device)
    ray, _ = sample_ray_kind(
        sensor.device_params(), f32(rng.uniform(0.0, shutter, n)),
        f32(((pix % W) + rng.uniform(0.0, 1.0, n)) / W),
        f32(((pix // W) + rng.uniform(0.0, 1.0, n)) / H))
    return ray


def secondary_wavefronts(sa, cam, seed):
    """From the camera hits: shadow rays toward emitter samples (finite
    maxt) and cosine-weighted diffuse bounce rays; lanes whose camera ray
    missed are dead (maxt -1)."""
    import numpy as np
    import torch
    from mitsuba3dopplertof_tpu_torch import emitters as em
    from mitsuba3dopplertof_tpu_torch.core.warp import cosine_hemisphere_c
    from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as ik
    from mitsuba3dopplertof_tpu_torch.render.scene import build_si
    n = cam.o.x.shape[0]
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(0.0, 1.0, (4, n)).astype(np.float32),
                        device=cam.o.x.device)
    si = build_si(sa, cam, ik.intersect(sa, cam))
    ds, _ = em.sample_direction(sa, si.p, cam.time, u[0], u[1])
    shadow = si.spawn_ray_to(ds.p)
    bounce = si.spawn_ray(si.to_world(cosine_hemisphere_c(u[2], u[3])))
    dead = lambda r: r._replace(maxt=torch.where(si.valid, r.maxt, -1.0))
    return dead(shadow), dead(bounce), int(si.valid.sum())


def v4_visits(sa, ray, any_hit, bin_rays):
    """One B2 launch over ``ray`` (through ``binned`` when ``bin_rays``)
    with the per-block group counts read back. Returns (the ray as
    launched, prepared inputs, unit visits per block, distinct units
    visited by any block)."""
    import torch
    from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as v4
    from mitsuba3dopplertof_tpu_torch.ops.ray_binning import binned
    tables = v4.v4_tables(sa)
    seen = {}

    def run(r):
        prep = v4.prepare(tables, r)
        groups = torch.zeros((prep[3].shape[0] // v4.BLOCK,),
                             dtype=torch.int32, device=r.o.x.device)
        t, prim = v4.launch(tables, prep, any_hit, groups_out=groups)
        seen.update(ray=r, prep=prep, groups=groups)
        n = r.o.x.shape[0]
        return [t[:n], prim[:n]]

    if bin_rays:
        binned(sa, ray, None, run)
    else:
        run(ray)
    visits = torch.clamp(seen["groups"].long() * v4.GROUP,
                         max=tables.n_units)
    order = seen["prep"][4]
    col = torch.arange(tables.n_units, device=order.device)[None, :]
    units = torch.zeros((tables.n_units,), dtype=torch.bool,
                        device=order.device)
    units[order[col < visits[:, None]].long()] = True
    return seen["ray"], seen["prep"], visits, int(units.sum())


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        fail("no CUDA device: this script measures the port on a GPU")
    if not os.path.isdir(os.path.join(ROOT, "mitsuba3dopplertof_tpu_torch")):
        fail("run from a checkout: mitsuba3dopplertof_tpu_torch/ is missing")
    sys.path.insert(0, ROOT)
    import numpy as np
    t_start = time.perf_counter()

    # ---- 1. the card --------------------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    import mitsuba3dopplertof_tpu_torch as mi
    from mitsuba3dopplertof_tpu_torch.core import transform as tf
    from mitsuba3dopplertof_tpu_torch.core.transform import AnimatedTransform
    from mitsuba3dopplertof_tpu_torch.core.vec import Vec3
    from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as ik
    from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as v4
    from mitsuba3dopplertof_tpu_torch.ops.cuda_build import (BUILD_DIR,
                                                             build_all)
    from mitsuba3dopplertof_tpu_torch.ops.intersect_v3 import UNIT_REC
    from mitsuba3dopplertof_tpu_torch.ops.ray_binning import binned
    from mitsuba3dopplertof_tpu_torch.render.scene import build_si
    from mitsuba3dopplertof_tpu_torch.render.types import Ray
    from mitsuba3dopplertof_tpu_torch import emitters as em
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
        ANIMATED_SIZES, STATIC_SIZE, animated_mesh_scene, static_mesh_scene,
        write_uv_sphere_obj)
    if "jax" in sys.modules:
        fail("the port imported jax")

    def reset_counts():
        ik.reset_launch_counts()
        v4.reset_launch_counts()

    def read_counts():
        return {"B1": dict(ik.LAUNCHES_BY_FORM),
                "B2": dict(v4.LAUNCHES_BY_FORM)}

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    build_all([ik.LIBRARY, v4.LIBRARY])
    print(f"build: {time.perf_counter() - t0:.2f} s for both, nvcc "
          f"{ik.LIBRARY.seconds:.2f} s (B1) and {v4.LIBRARY.seconds:.2f} s "
          f"(B2) in parallel", flush=True)
    for lib in (ik.LIBRARY, v4.LIBRARY):
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {lib.name}: {line.strip()}", flush=True)

    mi.set_variant("cuda_rgb")
    if mi.get_device().type != "cuda":
        fail(f"the default device is {mi.get_device()}, not cuda")
    dev = torch.device("cuda")

    # ---- 3. B1 against plain --------------------------------------------
    scene = mi.load_file(CANONICAL)
    sa = scene.compile()
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)
    rng = np.random.default_rng(0)
    n = WAVEFRONT
    o = rng.uniform(-0.9, 0.9, (n, 3))
    o[:, 2] = rng.uniform(0.5, 3.5, n)
    d = rng.uniform(-1.0, 1.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.full(n, np.inf)
    maxt[: n // 4] = rng.uniform(0.5, 4.0, n // 4)
    random_rays = Ray(Vec3(*(f32(o[:, i]) for i in range(3))),
                      Vec3(*(f32(d[:, i]) for i in range(3))),
                      f32(rng.uniform(0.0, 0.0015, n)), f32(maxt))

    # the main path's first wavefront: one strip pass of camera rays, from
    # the middle of the frame (the top rows look out of the open box)
    from mitsuba3dopplertof_tpu_torch.samplers import TIME_ANTITHETIC
    from mitsuba3dopplertof_tpu_torch.sensors import sample_ray_kind
    sensor, sampler = scene.sensor, scene.sensor.sampler
    W, H = sensor.film.crop_size
    spp = 1024
    sampler.set_sample_count(spp)
    sampler.set_samples_per_wavefront(spp)
    st = sampler.seed(0, (n // (W * spp)) * W * spp,
                      lane0=(H // 2) * W * spp, device=dev)
    pix = st.lane // spp
    off, st = sampler.next_2d_correlate(st, None, True)
    ts, st = sampler.next_1d_time(st, None, TIME_ANTITHETIC, 0.5, True)
    tcam = ts * 0.0015
    tcam = torch.where(tcam < 0.0015, tcam, tcam - 0.0015)
    cam_rays, _ = sample_ray_kind(
        sensor.device_params(), tcam,
        ((pix % W).float() + off[0]) * (1.0 / W),
        ((pix // W).float() + off[1]) * (1.0 / H))
    # ... and its shadow rays towards light samples
    si = build_si(sa, cam_rays, ik.intersect_reference(sa, cam_rays))
    (ux, uy), st = sampler.next_2d(st, None)
    ds, _ = em.sample_direction(sa, si.p, cam_rays.time, ux, uy)
    shadow_rays = si.spawn_ray_to(ds.p)

    # a scene with static and animated spheres and animated cubes
    def anim(a, b, t0=0.0, t1=1.0):
        return AnimatedTransform([(t0, a), (t1, b)])
    sph_scene = mi.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0, -6], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 8, "height": 8}},
        "floor": {"type": "rectangle", "to_world": tf.translate([0, -2, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([4, 4, 1])},
        "back": {"type": "rectangle",
                 "to_world": tf.translate([0, 0, 4]) @ tf.scale([4, 4, 1])},
        "mover": {"type": "cube", "to_world": anim(
            tf.translate([-1.5, 0, 1]) @ tf.scale([0.5] * 3)
            @ tf.rotate([0, 1, 0], 10),
            tf.translate([-1.5, 1.0, 1]) @ tf.scale([0.5] * 3)
            @ tf.rotate([0, 1, 0], 55))},
        "mover2": {"type": "cube", "to_world": anim(
            tf.translate([1.2, -0.5, 0]) @ tf.scale([0.4] * 3),
            tf.translate([1.2, -0.5, 2]) @ tf.scale([0.4] * 3), 0.2, 0.8)},
        "ball": {"type": "sphere", "center": [0.0, 1.5, 1.0], "radius": 0.6},
        "movingball": {"type": "sphere", "to_world": anim(
            tf.translate([0.5, -1.0, 0.5]) @ tf.scale([0.45] * 3),
            tf.translate([-0.5, -1.0, 0.5]) @ tf.scale([0.45] * 3))},
    })
    sa_sph = sph_scene.compile()
    o = rng.uniform(-3.0, 3.0, (n, 3))
    o[:, 2] -= 5.0
    d = rng.uniform(-2.0, 2.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sph_rays = Ray(Vec3(*(f32(o[:, i]) for i in range(3))),
                   Vec3(*(f32(d[:, i]) for i in range(3))),
                   f32(rng.uniform(0.0, 1.0, n)),
                   f32(np.where(np.arange(n) < n // 4,
                                rng.uniform(3.0, 9.0, n), np.inf)))

    errs = {"closest_hit": 0.0, "any_hit": 0.0}
    for label, s_a, rays in (("random", sa, random_rays),
                             ("camera", sa, cam_rays),
                             ("shadow", sa, shadow_rays),
                             ("spheres", sa_sph, sph_rays)):
        hk = ik.intersect(s_a, rays)
        torch.cuda.synchronize()
        hr = ik.intersect_reference(s_a, rays)
        torch.cuda.synchronize()
        err, n_tri, n_diff = check_hits(hk, hr, label, ik._SPH_SLOT_BASE)
        occ_k = ik.ray_test(s_a, rays)
        torch.cuda.synchronize()
        occ_r = ik.ray_test_reference(s_a, rays)
        mism = int((occ_k != occ_r).sum())
        if mism:
            fail(f"B1 {label}: occlusion differs on {mism} lanes")
        errs["closest_hit"] = max(errs["closest_hit"], err)
        errs["any_hit"] = max(errs["any_hit"], float(mism))
        print(f"B1 parity {label}: {rays.o.x.shape[0]} rays, max abs err "
              f"{err:.3g}, triangle hits {n_tri} with t bitwise equal on "
              f"{n_tri - n_diff}; occlusion equal on all lanes", flush=True)

    n_tri_c = sa.n_static_tris + sa.n_anim_tris
    n_cam = cam_rays.o.x.shape[0]
    tri_bytes = n_tri_c * 25 * 4 + len(sa.anim_ranges) * 26 * 4
    b1_ops = n_cam * (n_tri_c * MOLLER_OPS
                      + len(sa.anim_ranges) * INV_LERP_OPS)
    b1 = {
        "closest_hit": (cuda_time_ms(lambda: ik.intersect(sa, cam_rays)),
                        cuda_time_ms(lambda: ik.intersect_reference(
                            sa, cam_rays), reps=5),
                        bound(n_cam * (32 + 52) + tri_bytes, b1_ops)),
        "any_hit": (cuda_time_ms(lambda: ik.ray_test(sa, shadow_rays)),
                    cuda_time_ms(lambda: ik.ray_test_reference(
                        sa, shadow_rays), reps=5),
                    bound(n_cam * (32 + 4) + tri_bytes, b1_ops)),
    }
    for form, (k_ms, p_ms, (b_ms, b_by)) in b1.items():
        print(f"B1 time {form} at {n_cam} lanes, {n_tri_c} triangles: "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) ({card})", flush=True)

    # ---- 4. B2 against plain --------------------------------------------
    scene_dir = BUILD_DIR / "scenes"
    scene_dir.mkdir(parents=True, exist_ok=True)
    big = {}
    for label, (nu, nv), animated in (("40k animated", ANIMATED_SIZES["40k"],
                                       True),
                                      ("50k static", STATIC_SIZE, False)):
        obj = str(scene_dir / f"sphere_{nu}x{nv}.obj")
        write_uv_sphere_obj(obj, nu, nv)
        d = (animated_mesh_scene(obj, spp=256) if animated
             else static_mesh_scene(obj, spp=256))
        sc = mi.load_dict(d)
        big[label] = (obj, sc, sc.compile())

    errs2 = {"closest_hit": 0.0, "any_hit": 0.0}
    b2_rays = {}
    for label, (obj, sc, sab) in big.items():
        shutter = 0.0015 if sab.anim_ranges else 0.0
        W, H = sc.sensor.film.crop_size
        spp = 256
        cam = camera_wavefront(sc, WAVEFRONT, (H // 2 - WAVEFRONT // (W * spp)
                                               // 2) * W * spp, spp,
                               shutter, seed=1)
        shadow, bounce, n_valid = secondary_wavefronts(sab, cam, seed=2)
        if n_valid < WAVEFRONT // 4:
            fail(f"B2 {label}: only {n_valid} camera hits")
        b2_rays[label] = (cam, shadow, bounce)
        print(f"B2 scene {label}: {sab.n_static_tris + sab.n_anim_tris} "
              f"triangles, {v4.v4_tables(sab).n_units} units; camera "
              f"wavefront {WAVEFRONT} lanes, {n_valid} hit", flush=True)
        for wname, ray in (("camera", cam), ("shadow", shadow),
                           ("bounce", bounce)):
            t_r, p_r = v4.intersect_v4_reference(sab, ray)
            hit = p_r >= 0
            for bin_it in (False, True):
                for any_hit in (False, True):
                    run = (lambda r, a=any_hit:
                           list(v4.intersect_v4(sab, r, any_hit=a)))
                    t_k, p_k = (binned(sab, ray, None, run) if bin_it
                                else run(ray))
                    torch.cuda.synchronize()
                    tag = (f"B2 {label} {wname} "
                           f"{'binned' if bin_it else 'unbinned'} "
                           f"{'any-hit' if any_hit else 'closest-hit'}")
                    occ = int(((p_k >= 0) != hit).sum())
                    if occ:
                        fail(f"{tag}: occlusion differs on {occ} lanes")
                    if any_hit:
                        print(f"{tag}: occlusion equal on all "
                              f"{ray.o.x.shape[0]} lanes ({int(hit.sum())} "
                              f"occluded)", flush=True)
                        continue
                    n_tdiff = int((t_k[hit] != t_r[hit]).sum())
                    n_pdiff = int((hit & (p_k != p_r)).sum())
                    err = float((t_k[hit] - t_r[hit]).abs().max()) \
                        if bool(hit.any()) else 0.0
                    errs2["closest_hit"] = max(errs2["closest_hit"], err)
                    print(f"{tag}: {int(hit.sum())} hit lanes, t differs on "
                          f"{n_tdiff} (max abs {err:.3g}), prim differs on "
                          f"{n_pdiff} (ties in t)", flush=True)
                    if n_tdiff:
                        fail(f"{tag}: t not bitwise equal on {n_tdiff} lanes")
                    if n_pdiff > max(20, int(hit.sum()) // 10000):
                        fail(f"{tag}: prim differs on {n_pdiff} lanes")

    # times at the main path's shapes: the binned camera wavefront of the
    # 40k animated scene (closest-hit) and its binned shadow wavefront
    # (any-hit); kernel launch alone, over prepared inputs
    sa40 = big["40k animated"][2]
    cam40, shadow40, bounce40 = b2_rays["40k animated"]
    tables40 = v4.v4_tables(sa40)
    b2 = {}
    for form, any_hit, ray in (("closest_hit", False, cam40),
                               ("any_hit", True, shadow40)):
        ray_s, prep, visits, uniq = v4_visits(sa40, ray, any_hit, True)
        k_ms = cuda_time_ms(lambda: v4.launch(tables40, prep, any_hit))
        prep_ms = cuda_time_ms(lambda: v4.prepare(tables40, ray_s), reps=5)
        p_ms = cuda_time_ms(lambda: v4.intersect_v4_reference(
            sa40, ray_s, any_hit), reps=1)
        n_lanes = prep[3].shape[0]
        n_visit = int(visits.sum())
        n_bytes = (n_lanes * (32 + 8) + uniq * UNIT_REC * 4
                   + n_visit * (8 + 8))
        n_ops = (n_visit * v4.BLOCK * 32 * WOOP_OPS
                 + n_lanes * INV_LERP_OPS)
        b2[form] = (k_ms, p_ms, bound(n_bytes, n_ops))
        print(f"B2 time {form} at {n_lanes} lanes (binned), "
              f"{tables40.n_units} units: kernel {k_ms:.4f} ms, visit lists "
              f"{prep_ms:.3f} ms, plain {p_ms:.3f} ms; blocks visit "
              f"{n_visit / visits.numel():.1f} units on average (max "
              f"{int(visits.max())}), {uniq} distinct; bound "
              f"{b2[form][2][0]:.4f} ms ({b2[form][2][1]}) ({card})",
              flush=True)
    _, _, visits_u, _ = v4_visits(sa40, bounce40, False, False)
    _, _, visits_b, _ = v4_visits(sa40, bounce40, False, True)
    print(f"B2 bounce wavefront, units per block: unbinned "
          f"{float(visits_u.float().mean()):.1f}, binned "
          f"{float(visits_b.float().mean()):.1f}", flush=True)
    del b2_rays, cam40, shadow40, bounce40

    # ---- 5. the main path, small scene (B1) -------------------------------
    scene = mi.load_file(CANONICAL)
    reset_counts()
    t0 = time.perf_counter()
    img = mi.render(scene, spp=1024, seed=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches_c = read_counts()
    if tuple(img.shape) != (256, 256, 3):
        fail(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        fail("image has non-finite values")
    if not bool((img != 0).any()):
        fail("image is all zero")
    for form, count in launches_c["B1"].items():
        if count <= 0:
            fail(f"the canonical render launched B1 {form} {count} times")
    t0 = time.perf_counter()
    img2 = mi.render(scene, spp=1024, seed=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    msps = 256 * 256 * 1024 / warm_s / 1e6
    print(f"render canonical 256x256x1024 dopplertofpath: first "
          f"{first_s:.3f} s, warm {warm_s:.3f} s = {msps:.3f} Msamples/s "
          f"({card}); launches {launches_c}; image mean "
          f"{float(img.mean()):.6g}, max |v| {float(img.abs().max()):.6g}",
          flush=True)
    if not torch.equal(img, img2):
        print("note: two renders differ (max "
              f"{float((img - img2).abs().max()):.3g})", flush=True)

    # ---- 6. the main path, large scene (B2) -------------------------------
    obj40 = big["40k animated"][0]
    scene = mi.load_dict(animated_mesh_scene(obj40, spp=256))
    reset_counts()
    t0 = time.perf_counter()
    img = mi.render(scene, spp=256, seed=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches_l = read_counts()
    if tuple(img.shape) != (256, 256, 3):
        fail(f"40k image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        fail("40k image has non-finite values")
    if not bool((img != 0).any()):
        fail("40k image is all zero")
    for form, count in launches_l["B2"].items():
        if count <= 0:
            fail(f"the 40k render launched B2 {form} {count} times")
    t0 = time.perf_counter()
    img2 = mi.render(scene, spp=256, seed=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    msps = 256 * 256 * 256 / warm_s / 1e6
    print(f"render 40k animated 256x256x256 dopplertofpath: first "
          f"{first_s:.3f} s, warm {warm_s:.3f} s = {msps:.3f} Msamples/s "
          f"({card}); launches {launches_l}; image mean "
          f"{float(img.mean()):.6g}, max |v| {float(img.abs().max()):.6g}",
          flush=True)
    if not torch.equal(img, img2):
        print("note: two renders differ (max "
              f"{float((img - img2).abs().max()):.3g})", flush=True)
    del img, img2

    # ---- 7. binning is a permutation ------------------------------------
    imgs = []
    for no_bin in (False, True):
        if no_bin:
            os.environ["MI_NO_RAY_BINNING"] = "1"
        try:
            s64 = mi.load_dict(animated_mesh_scene(obj40, spp=16, res=64))
            imgs.append(mi.render(s64, spp=16, seed=0))
        finally:
            os.environ.pop("MI_NO_RAY_BINNING", None)
    n_diff = int((imgs[0] != imgs[1]).sum())
    print(f"binned vs unbinned 40k 64x64x16: {n_diff} of "
          f"{imgs[0].numel()} values differ (max abs "
          f"{float((imgs[0] - imgs[1]).abs().max()):.3g})", flush=True)
    if n_diff:
        fail("binned and unbinned renders differ")

    # ---- 8. port on the card against the port on the CPU ----------------
    # Tolerance: the slice test's (rtol 1e-4, atol 1e-4 * max |cpu|) on at
    # least 99% of values, and the image mean to 1e-3 relative. The two
    # devices differ in cos/sin/exp/rsqrt (CUDA's against the CPU's, last
    # bits), in the kernels' payload on missed lanes and, for the large
    # scene, in the intersector (Woop test and a Gram-system payload on the
    # card, Möller-Trumbore on the CPU); a changed last bit can flip a
    # sampling branch on a few paths. The film splat is a fixed order of
    # elementwise adds on both devices (no atomics).
    obj2k = str(scene_dir / "sphere_32x32.obj")
    write_uv_sphere_obj(obj2k, *ANIMATED_SIZES["2k"])
    cases = (("canonical dopplertofpath",
              lambda dv: mi.load_file(CANONICAL, spp=16, resx=16, resy=16,
                                      device=dv), None),
             ("canonical path",
              lambda dv: mi.load_file(CANONICAL, spp=16, resx=16, resy=16,
                                      device=dv),
              {"type": "path", "max_depth": 4}),
             ("2k animated dopplertofpath",
              lambda dv: mi.load_dict(animated_mesh_scene(obj2k, spp=16,
                                                          res=16),
                                      device=dv), None))
    for label, load, integ in cases:
        out = []
        for dv in (None, "cpu"):
            kw = {}
            if integ is not None:
                kw["integrator"] = mi.load_dict(integ, device=dv)
            reset_counts()
            out.append(mi.render(load(dv), spp=16, seed=0,
                                 **kw).cpu().numpy())
            if dv is None and label.startswith("2k"):
                if min(v4.LAUNCHES_BY_FORM.values()) <= 0:
                    fail("the 2k render on the card did not launch B2")
        ig, ic = out
        scale = float(np.abs(ic).max())
        close = np.isclose(ig, ic, rtol=1e-4, atol=1e-4 * scale)
        rel_mean = abs(ig.mean() - ic.mean()) / max(abs(ic.mean()), 1e-30)
        print(f"cuda vs cpu {label} 16x16x16: {close.mean() * 100:.2f}% "
              f"of values within tolerance, mean rel diff {rel_mean:.3g}, "
              f"max abs diff {float(np.abs(ig - ic).max()):.3g} (scale "
              f"{scale:.3g})", flush=True)
        if close.mean() < 0.99 or rel_mean > 1e-3 or scale <= 0.0:
            fail(f"cuda vs cpu {label}: outside tolerance")

    if "jax" in sys.modules:
        fail("the port imported jax")
    kernels = []
    for name, src, tpu, times, launches, errs_k in (
            ("intersect_bruteforce", B1_SOURCE, B1_TPU, b1,
             launches_c["B1"], errs),
            ("intersect_v4", B2_SOURCE, B2_TPU, b2, launches_l["B2"],
             errs2)):
        for form in ("closest_hit", "any_hit"):
            k_ms, p_ms, (b_ms, b_by) = times[form]
            kernels.append({
                "name": f"{name} ({form.replace('_', '-')})",
                "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[form], "max_abs_err": errs_k[form],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None})
    print(f"wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
