"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; without one (or
without the package beside it) it exits non-zero and prints no result.
Every phase raises on failure:

  1. the card: name and power limit (nvidia-smi);
  2. build the B1 kernel (csrc/intersect_bruteforce.cu) from the checkout;
  3. the kernel against its plain PyTorch version on the card: 1M random
     rays in the canonical scene, the canonical scene's camera wavefront and
     its shadow wavefront (the main path's shapes), and a scene with
     spheres and animated cubes; closest-hit and any-hit, with the
     hit-matching criteria of tests/test_pallas_parity.py and an exact
     occlusion match; then kernel and plain times at the main path's shapes;
  4. the main path: scenes/canonical/scene.xml rendered at 256x256 x 1024
     spp by dopplertofpath on the card, through the kernel (launch counts
     read around the render), twice, the second render timed;
  5. the port on the card against the port on the CPU at 16x16 x 16 spp,
     dopplertofpath and path;
  6. a JSON line with the kernels, then the contract line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CANONICAL = os.path.join(ROOT, "scenes", "canonical", "scene.xml")
KERNEL_SOURCE = "mitsuba3dopplertof_tpu_torch/csrc/intersect_bruteforce.cu"
TPU_KERNEL = "mitsuba3dopplertof_tpu/ops/intersect_kernel.py:139"


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
    from mitsuba3dopplertof_tpu_torch.render.scene import build_si
    from mitsuba3dopplertof_tpu_torch.render.types import Ray
    from mitsuba3dopplertof_tpu_torch import emitters as em
    from mitsuba3dopplertof_tpu_torch.samplers import TIME_ANTITHETIC
    from mitsuba3dopplertof_tpu_torch.sensors import sample_ray_kind
    if "jax" in sys.modules:
        fail("the port imported jax")

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    build_s = ik.build()
    print(f"build: {build_s:.2f} s nvcc, {time.perf_counter() - t0:.2f} s "
          f"with loading ({ik.library_path().name})", flush=True)
    for line in ik.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    mi.set_variant("cuda_rgb")
    dev = torch.device("cuda")
    mi.set_device(dev)

    # ---- 3. kernel against plain --------------------------------------
    scene = mi.load_file(CANONICAL)
    sa = scene.compile()
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)
    rng = np.random.default_rng(0)
    n = 1 << 20
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
            fail(f"{label}: occlusion differs on {mism} lanes")
        errs["closest_hit"] = max(errs["closest_hit"], err)
        errs["any_hit"] = max(errs["any_hit"], float(mism))
        print(f"parity {label}: {rays.o.x.shape[0]} rays, max abs err "
              f"{err:.3g}, triangle hits {n_tri} with t bitwise equal on "
              f"{n_tri - n_diff}; occlusion equal on all lanes", flush=True)

    times = {
        "closest_hit": (cuda_time_ms(lambda: ik.intersect(sa, cam_rays)),
                        cuda_time_ms(lambda: ik.intersect_reference(
                            sa, cam_rays), reps=5)),
        "any_hit": (cuda_time_ms(lambda: ik.ray_test(sa, shadow_rays)),
                    cuda_time_ms(lambda: ik.ray_test_reference(
                        sa, shadow_rays), reps=5)),
    }
    for form, (k_ms, p_ms) in times.items():
        print(f"time {form} at {cam_rays.o.x.shape[0]} lanes, "
              f"{sa.n_static_tris + sa.n_anim_tris} triangles: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.3f} ms ({card})", flush=True)

    # ---- 4. the main path ---------------------------------------------
    scene = mi.load_file(CANONICAL)
    ik.reset_launch_counts()
    t0 = time.perf_counter()
    img = mi.render(scene, spp=1024, seed=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(ik.LAUNCHES_BY_FORM)
    if tuple(img.shape) != (256, 256, 3):
        fail(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        fail("image has non-finite values")
    if not bool((img != 0).any()):
        fail("image is all zero")
    for form, count in launches.items():
        if count <= 0:
            fail(f"the render launched the {form} kernel {count} times")
    t0 = time.perf_counter()
    img2 = mi.render(scene, spp=1024, seed=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    msps = 256 * 256 * 1024 / warm_s / 1e6
    print(f"render 256x256x1024 dopplertofpath: first {first_s:.3f} s, "
          f"warm {warm_s:.3f} s = {msps:.3f} Msamples/s ({card}); "
          f"launches {launches}; image mean {float(img.mean()):.6g}, "
          f"max |v| {float(img.abs().max()):.6g}", flush=True)
    if not torch.equal(img, img2):
        print("note: two renders differ (max "
              f"{float((img - img2).abs().max()):.3g})", flush=True)

    # ---- 5. port on the card against the port on the CPU --------------
    # Tolerance: the slice test's (rtol 1e-4, atol 1e-4 * max |cpu|) on at
    # least 99% of pixels, and the image mean to 1e-3 relative. The two
    # devices differ in cos/sin/exp/rsqrt (CUDA's against the CPU's, last
    # bits) and in the kernel's payload on missed lanes; a changed last bit
    # can flip a sampling branch on a few paths. The film splat is a fixed
    # order of elementwise adds on both devices (no atomics).
    for integ in ("dopplertofpath", "path"):
        small_g = mi.load_file(CANONICAL, spp=16, resx=16, resy=16)
        small_c = mi.load_file(CANONICAL, spp=16, resx=16, resy=16,
                               device="cpu")
        kw = {}
        if integ == "path":
            kw["integrator"] = mi.load_dict({"type": "path",
                                             "max_depth": 4})
        ig = mi.render(small_g, spp=16, seed=0, **kw).cpu().numpy()
        ic = mi.render(small_c, spp=16, seed=0, **kw).numpy()
        scale = float(np.abs(ic).max())
        close = np.isclose(ig, ic, rtol=1e-4, atol=1e-4 * scale)
        rel_mean = abs(ig.mean() - ic.mean()) / max(abs(ic.mean()), 1e-30)
        print(f"cuda vs cpu {integ} 16x16x16: {close.mean() * 100:.2f}% "
              f"of values within tolerance, mean rel diff {rel_mean:.3g}, "
              f"max abs diff {float(np.abs(ig - ic).max()):.3g} (scale "
              f"{scale:.3g})", flush=True)
        if close.mean() < 0.99 or rel_mean > 1e-3:
            fail(f"cuda vs cpu {integ}: outside tolerance")

    if "jax" in sys.modules:
        fail("the port imported jax")
    kernels = []
    for form in ("closest_hit", "any_hit"):
        kernels.append({
            "name": f"intersect_bruteforce ({form.replace('_', '-')})",
            "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": launches[form], "max_abs_err": errs[form],
            "ms": times[form][0], "plain_ms": times[form][1]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
