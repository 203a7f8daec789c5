"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; without one (or
without the package beside it) it exits non-zero and prints no result.
Every phase raises on failure:

  1. the card: name and power limit (nvidia-smi);
  2. build all six kernels from the checkout, one nvcc each, started
     together: B1 (csrc/intersect_bruteforce.cu), B2 (intersect_v4.cu), B3
     (intersect_stream.cu), B4 (intersect_v2.cu), B5 (intersect_v3.cu) and
     B6 (intersect_mxu.cu), with their registers and spills (ptxas -v);
  3. B1 against its plain PyTorch version on the card: 1M random rays in
     the canonical scene, the canonical scene's camera wavefront and its
     shadow wavefront (the main path's shapes), and a scene with spheres
     and animated cubes; closest-hit and any-hit, with the hit-matching
     criteria of tests/test_pallas_parity.py and an exact occlusion match;
     then kernel and plain times at the main path's shapes;
  4. the large-scene kernels B2-B6 against their plain PyTorch versions on
     the card, on the 40k animated UV-sphere scene and the static 50k one
     (utils/bench_scenes.py, the JAX package's scripts/bench_suite.py
     scenes): a camera wavefront of 1,048,576 lanes (one strip pass),
     shadow rays toward the point light and diffuse bounce rays from the
     camera hits; closest-hit and any-hit, over binned rays (B2 unbinned
     too). t bitwise equal on hit lanes, prim different only at ties in t,
     occlusion exact, and for B3 the whole hit record equal where prim is;
     then kernel times, and bounds from the work a plain walk of the same
     lists needs on the timed wavefronts;
  5. the main path of the small scenes: scenes/canonical/scene.xml rendered
     at 256x256 x 1024 spp by dopplertofpath through B1 (launch counts read
     around the render), twice, the second render timed;
  6. the main path of the large scenes: the 40k animated scene at 256x256
     x 256 spp on the default device (launch counts read around the
     render), twice, the second render timed: through B2, then with
     MI_STREAM_KERNEL=v3, v2, v1 and mxu through B5, B4, B3 and B6, each
     route launching its own kernel and never B2;
  7. binning is a permutation: the 40k scene at 64x64 x 16 spp with and
     without MI_NO_RAY_BINNING gives equal images; each alternate route's
     64x64 x 16 spp image against B2's;
  8. the port on the card against the port on the CPU at 16x16 x 16 spp:
     the canonical scene (dopplertofpath and path) and the 2k animated
     scene (B2 and binning on the card, the plain intersector on the CPU);
  9. a JSON line with the kernels, then the contract line
     {"ok": true, "device": {...}}.

Bounds (``bound_ms``): the larger of the bytes a kernel must move (each
input read once, each output written once) over the card's memory rate and
the float32 operations it must do on this run's inputs over the card's
float32 rate (NVIDIA's H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s outside
the tensor cores). For B2-B6 the operations count the units, quarters or
chunks that a walk of the timed wavefront's visit lists must test, computed
in PyTorch from the lists and the plain versions' results (``WalkWork``),
not from counters in the kernels. No single PyTorch call computes a
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
# the alternate large-scene kernels: row, MI_STREAM_KERNEL value, module of
# mitsuba3dopplertof_tpu_torch.ops, line of the TPU kernel in the module of
# the same name of the JAX package
ALTERNATES = (("B5", "v3", "intersect_v3", 53),
              ("B4", "v2", "intersect_v2", 74),
              ("B3", "v1", "intersect_stream", 80),
              ("B6", "mxu", "intersect_mxu", 80))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
# float32 operations of one ray-triangle test, counted in the kernels'
# source: Möller-Trumbore in B1 (edge crosses, determinant, division,
# three dot products, six compares), the Woop test in B2 (three affine
# rows of 11, division, two multiply-adds, seven compares). B6 computes
# Woop's affine map as a (768 x 8) product per chunk of 128 triangles, half
# of whose coefficients are structural zeros: its bound counts the 128 Woop
# tests the function needs, not the zero terms
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


def sort_wavefront(sa, ray):
    """The wavefront in binned order (``ray_binning.binned``'s) and, per
    original lane, its position there."""
    import torch
    from mitsuba3dopplertof_tpu_torch.ops.ray_binning import binned
    seen = {}

    def run(r):
        seen["ray"] = r
        return [torch.arange(r.o.x.shape[0], device=r.o.x.device)]

    (pos,) = binned(sa, ray, None, run)
    return seen["ray"], pos


class WalkWork:
    """What walks of one binned wavefront's visit lists must test: per
    kernel the units, quarters or chunks whose gate passes, computed in
    PyTorch from the lists each kernel's ``prepare`` builds and from the
    plain version's result, the same whatever implements the walk.

    Closest-hit: a walk over a sorted list tests exactly the entries whose
    t_lo is at most the block's final bound (the bound never grows, and a
    hit found in a unit is no nearer than the unit's t_lo), so the final
    bound from the plain version's t decides; B3, which has no order, must
    at least test the chunks that pass under its final t_hi. Any-hit: the
    bound before rank v is the largest maxt among the lanes that no
    earlier unit occludes, from each lane's first rank with a hit; the hit
    sets come from one dense pass of B2's plain version (every kernel
    agrees with it on every lane's occlusion in the parity phase)."""

    BLOCK = 256
    BIG = 3.0e38
    CAP = 1.0e37

    def __init__(self, sa, ray_s, t_ref, any_hit):
        import torch
        from mitsuba3dopplertof_tpu_torch.ops import intersect_mxu as mxu
        from mitsuba3dopplertof_tpu_torch.ops import intersect_v2 as v2
        from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as v4
        from mitsuba3dopplertof_tpu_torch.ops.intersect_v3 import \
            _slab_visit_order
        self.torch = torch
        self.any_hit = any_hit
        n = ray_s.o.x.shape[0]
        if n % self.BLOCK:
            raise ValueError("WalkWork: whole blocks only")
        self.n, self.nb = n, n // self.BLOCK
        tb4 = v4.v4_tables(sa)
        self.n_units = tb4.n_units
        _, _, _, maxtp, self.order32, self.tlo32 = v4.prepare(tb4, ray_s)
        self.key32 = self._unsort(self.order32, self.tlo32)
        tb2 = v2.v2_tables(sa)
        self.order128, self.tlo128 = v2.prepare(tb2, ray_s)[4:]
        x, _, self.order128r, self.tlo128r = mxu.prepare(mxu.mxu_tables(sa),
                                                         ray_s)
        # unit keys without the scene-box clamp (B6's and B3's gates)
        o32r, t32r = _slab_visit_order(tb4.box[:, :3], tb4.box[:, 3:], x,
                                       self.BLOCK)
        self.key32r = self._unsort(o32r, t32r)
        self.mt_blk = torch.clamp(self._blockmax(x[7]), max=self.BIG)
        if any_hit:
            hits = torch.zeros((n, tb4.n_units), dtype=torch.bool,
                               device=maxtp.device)
            v4.intersect_v4_reference(sa, ray_s, unit_hits=hits)
            self.hits = hits
            self.maxtp = maxtp
        else:
            # the ordered walks' final bound, and B6's and B3's final t_hi
            self.bound = torch.clamp(self._blockmax(
                torch.minimum(t_ref, maxtp)), max=self.CAP)
            self.t_hi = torch.minimum(self.mt_blk, torch.clamp(
                self._blockmax(t_ref), max=self.BIG))

    def _blockmax(self, v):
        return v.reshape(self.nb, self.BLOCK).amax(dim=1)

    def _unsort(self, order, key):
        out = self.torch.empty_like(key)
        out.scatter_(1, order.long(), key)
        return out

    def _first_rank(self, order, per_chunk):
        """Per lane the first rank of ``order`` with a hit (its length:
        none). ``per_chunk``: the list is over 128-triangle chunks."""
        torch = self.torch
        n_list = order.shape[1]
        rank = torch.empty_like(order)
        rank.scatter_(1, order.long(), torch.arange(
            n_list, dtype=order.dtype, device=order.device).expand_as(order))
        out = torch.empty((self.n,), dtype=torch.int64, device=order.device)
        step = 64
        for b0 in range(0, self.nb, step):
            sl = slice(b0 * self.BLOCK, (b0 + step) * self.BLOCK)
            h = self.hits[sl]
            if per_chunk:
                h = h.reshape(h.shape[0], n_list, -1).any(dim=2)
            r = rank[b0:b0 + step].repeat_interleave(self.BLOCK, dim=0)
            out[sl] = torch.where(h, r, n_list).amin(dim=1)
        return out

    def far_ends(self, order, per_chunk, block_maxt):
        """(n_blocks, n_list) far end of the gate before each rank.
        ``block_maxt``: B6 and B3 bound a block by its largest maxt until
        every lane is occluded; B2, B5 and B4 by the unoccluded lanes'
        own (clamped) maxt."""
        torch = self.torch
        n_list = order.shape[1]
        if not self.any_hit:
            g = self.t_hi if block_maxt else self.bound
            return g[:, None].expand(self.nb, n_list)
        first = self._first_rank(order, per_chunk)
        m = (self.mt_blk.repeat_interleave(self.BLOCK) if block_maxt
             else self.maxtp)
        a = torch.full((self.nb, n_list + 1), -self.BIG, device=m.device)
        a.scatter_reduce_(1, first.reshape(self.nb, self.BLOCK),
                          m.reshape(self.nb, self.BLOCK), reduce="amax")
        g = a.flip(1).cummax(dim=1).values.flip(1)[:, :n_list]
        return g if block_maxt else torch.clamp(g, max=self.CAP)

    def _prefix(self, tlo, g):
        """Entries a sorted walk reaches: t_lo within the far end, up to
        the first that is not."""
        ok = (tlo <= g) & (tlo < self.BIG)
        return ok.to(self.torch.int8).cummin(dim=1).values.bool()

    def _distinct(self, order, mask, n_list):
        seen = self.torch.zeros((n_list,), dtype=self.torch.bool,
                                device=order.device)
        seen[order[mask].long()] = True
        return int(seen.sum())

    def _quarters(self, order, key32, g):
        """(n_blocks, n_chunks, 4): the quarter boxes of each ranked chunk
        that pass the slab test with the far end ``g``."""
        k = key32.reshape(self.nb, -1, 4).gather(
            1, order.long()[:, :, None].expand(-1, -1, 4))
        return (k <= g[:, :, None]) & (k < self.BIG)

    def work(self, row):
        """(entries tested over all blocks, distinct records read, label of
        an entry) for kernel ``row``."""
        torch = self.torch
        if row in ("B2", "B5"):
            g = self.far_ends(self.order32, False, False)
            # one count for both: B2 walks the same list in groups of 8,
            # which is its own rounding, not work the function needs
            vis = self._prefix(self.tlo32, g)
            return (int(vis.sum()),
                    self._distinct(self.order32, vis, self.n_units),
                    "units")
        if row == "B4":
            g = self.far_ends(self.order128, True, False)
            vis = self._prefix(self.tlo128, g)
            q = self._quarters(self.order128, self.key32, g) \
                & vis[:, :, None]
            return (int(q.sum()), self._distinct(
                self.order128, q.any(dim=2), self.order128.shape[1]),
                "quarters")
        if row == "B6":
            g = self.far_ends(self.order128r, True, True)
            vis = self._prefix(self.tlo128r, g) & self._quarters(
                self.order128r, self.key32r, g).any(dim=2)
            return (int(vis.sum()), self._distinct(
                self.order128r, vis, self.order128r.shape[1]), "chunks")
        if row == "B3":                 # table order, no list
            ident = torch.arange(self.n_units, dtype=torch.int32,
                                 device=self.key32r.device).expand(
                                     self.nb, self.n_units).contiguous()
            g = self.far_ends(ident, False, True)
            vis = (self.key32r <= g) & (self.key32r < self.BIG)
            return (int(vis.sum()), int(vis.any(dim=0).sum()), "chunks")
        raise KeyError(row)


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
    import importlib
    from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as ik
    from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as v4
    from mitsuba3dopplertof_tpu_torch.ops.cuda_build import (BUILD_DIR,
                                                             build_all)
    from mitsuba3dopplertof_tpu_torch.ops.intersect_v3 import UNIT_REC
    alt_mod = {row: importlib.import_module(
        f"mitsuba3dopplertof_tpu_torch.ops.{name}")
        for row, _, name, _ in ALTERNATES}
    # per alternate: tables, prepare, wrapper, plain version (B5 shares
    # B2's tables, visit lists and plain version)
    alt_fn = {
        "B5": (v4.v4_tables, v4.prepare, alt_mod["B5"].intersect_v3,
               alt_mod["B5"].intersect_v3_reference),
        "B4": (alt_mod["B4"].v2_tables, alt_mod["B4"].prepare,
               alt_mod["B4"].intersect_v2,
               alt_mod["B4"].intersect_v2_reference),
        "B3": (alt_mod["B3"].stream_tables, alt_mod["B3"].prepare,
               alt_mod["B3"].intersect_stream,
               alt_mod["B3"].intersect_stream_reference),
        "B6": (alt_mod["B6"].mxu_tables, alt_mod["B6"].prepare,
               alt_mod["B6"].intersect_mxu,
               alt_mod["B6"].intersect_mxu_reference)}
    from mitsuba3dopplertof_tpu_torch.ops.ray_binning import binned
    from mitsuba3dopplertof_tpu_torch.render.scene import build_si
    from mitsuba3dopplertof_tpu_torch.render.types import Ray
    from mitsuba3dopplertof_tpu_torch import emitters as em
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
        ANIMATED_SIZES, STATIC_SIZE, animated_mesh_scene, static_mesh_scene,
        write_uv_sphere_obj)
    if "jax" in sys.modules:
        fail("the port imported jax")

    counted = {"B1": ik, "B2": v4, **alt_mod}

    def reset_counts():
        for m in counted.values():
            m.reset_launch_counts()

    def read_counts():
        return {row: dict(m.LAUNCHES_BY_FORM) for row, m in counted.items()}

    def timed_ms(fn):
        """(fn(), its time on the card in ms) by CUDA events."""
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    libs = [m.LIBRARY for m in counted.values()]
    build_all(libs)
    print(f"build: {time.perf_counter() - t0:.2f} s for all six in "
          f"parallel; nvcc " + ", ".join(
              f"{lib.seconds:.2f} s ({row})"
              for row, lib in zip(counted, libs)), flush=True)
    for lib in libs:
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

    def zero_area_winner(sa, p_r):
        """Lanes whose plain winner is a triangle of zero area. Möller's
        determinant is rounding noise there and can pass the 1e-12 guard
        with a meaningless t; the dense plain versions of B4 and B3 test
        such a triangle against every ray, while the kernels never reach
        it for a ray that does not enter its chunk's box. Such lanes are
        counted and left out of the comparison (Woop records of zero-area
        triangles are zero rows and never hit)."""
        tri = ik.scene_tables(sa)[0]
        e1x, e1y, e1z, e2x, e2y, e2z = (tri[:, c] for c in range(3, 9))
        # one rounding per product and difference (a fused cross product
        # leaves a residue where e1 = e2)
        nx = e1y * e2z - e1z * e2y
        ny = e1z * e2x - e1x * e2z
        nz = e1x * e2y - e1y * e2x
        flat = nx * nx + ny * ny + nz * nz <= 1e-32
        return (p_r >= 0) & flat[torch.clamp(p_r, min=0).long()]

    def check_t_prim(tag, t_k, p_k, t_r, p_r, any_hit, errs_k, skip=None):
        """Occlusion exact on every lane; closest-hit: t bitwise equal on
        hit lanes, prim different only at ties in t. ``skip``: lanes left
        out (``zero_area_winner``), at most one in 100,000."""
        if skip is not None and bool(skip.any()):
            n_skip = int(skip.sum())
            print(f"{tag}: {n_skip} lanes left out, the plain version's "
                  f"winner there is a triangle of zero area", flush=True)
            if n_skip > p_r.numel() // 100000:
                fail(f"{tag}: {n_skip} lanes with a zero-area winner")
            keep = ~skip
            t_k, p_k, t_r, p_r = t_k[keep], p_k[keep], t_r[keep], p_r[keep]
        hit = p_r >= 0
        occ = int(((p_k >= 0) != hit).sum())
        if occ:
            fail(f"{tag}: occlusion differs on {occ} lanes")
        if any_hit:
            # the any-hit form's error: lanes whose occlusion differs
            errs_k["any_hit"] = max(errs_k["any_hit"], float(occ))
            print(f"{tag}: occlusion equal on all {hit.numel()} lanes "
                  f"({int(hit.sum())} occluded)", flush=True)
            return
        n_tdiff = int((t_k[hit] != t_r[hit]).sum())
        n_pdiff = int((hit & (p_k != p_r)).sum())
        err = float((t_k[hit] - t_r[hit]).abs().max()) \
            if bool(hit.any()) else 0.0
        errs_k["closest_hit"] = max(errs_k["closest_hit"], err)
        print(f"{tag}: {int(hit.sum())} hit lanes, t differs on {n_tdiff} "
              f"(max abs {err:.3g}), prim differs on {n_pdiff} (ties in t)",
              flush=True)
        if n_tdiff:
            fail(f"{tag}: t not bitwise equal on {n_tdiff} lanes")
        if n_pdiff > max(20, int(hit.sum()) // 10000):
            fail(f"{tag}: prim differs on {n_pdiff} lanes")

    rows = ["B2"] + [row for row, *_ in ALTERNATES]
    errs_l = {row: {"closest_hit": 0.0, "any_hit": 0.0} for row in rows}
    plain_ms = {row: {} for row in rows}
    b2_rays = {}
    refs40 = {}
    for label, (obj, sc, sab) in big.items():
        shutter = 0.0015 if sab.anim_ranges else 0.0
        W, H = sc.sensor.film.crop_size
        spp = 256
        cam = camera_wavefront(sc, WAVEFRONT, (H // 2 - WAVEFRONT // (W * spp)
                                               // 2) * W * spp, spp,
                               shutter, seed=1)
        shadow, bounce, n_valid = secondary_wavefronts(sab, cam, seed=2)
        if n_valid < WAVEFRONT // 4:
            fail(f"{label}: only {n_valid} camera hits")
        b2_rays[label] = (cam, shadow, bounce)
        print(f"scene {label}: {sab.n_static_tris + sab.n_anim_tris} "
              f"triangles, {v4.v4_tables(sab).n_units} units; camera "
              f"wavefront {WAVEFRONT} lanes, {n_valid} hit", flush=True)
        for wname, ray in (("camera", cam), ("shadow", shadow),
                           ("bounce", bounce)):
            # the plain version's time is taken here, on the wavefronts the
            # kernels are timed on below (camera: closest-hit, shadow:
            # any-hit; a plain version computes the closest hit for both)
            form = {"camera": "closest_hit", "shadow": "any_hit"}.get(wname)
            timed = label == "40k animated" and form is not None
            (t_r, p_r), ms = timed_ms(
                lambda: v4.intersect_v4_reference(sab, ray))
            if timed:
                plain_ms["B2"][form] = plain_ms["B5"][form] = ms
            if label == "40k animated":
                refs40[wname] = t_r
            for bin_it in (False, True):
                for any_hit in (False, True):
                    run = (lambda r, a=any_hit:
                           list(v4.intersect_v4(sab, r, any_hit=a)))
                    t_k, p_k = (binned(sab, ray, None, run) if bin_it
                                else run(ray))
                    torch.cuda.synchronize()
                    check_t_prim(
                        f"B2 {label} {wname} "
                        f"{'binned' if bin_it else 'unbinned'} "
                        f"{'any-hit' if any_hit else 'closest-hit'}",
                        t_k, p_k, t_r, p_r, any_hit, errs_l["B2"])
            for row, route, _, _ in ALTERNATES:
                _, _, isect, plain = alt_fn[row]
                skip = None
                if row == "B5":       # B5's plain version is B2's
                    ref = (t_r, p_r)
                else:
                    ref, ms = timed_ms(lambda: plain(sab, ray))
                    if timed:
                        plain_ms[row][form] = ms
                    if row in ("B4", "B3"):
                        skip = zero_area_winner(sab, ref[1])
                for any_hit in (False, True):
                    out = binned(sab, ray, None, lambda r, a=any_hit: list(
                        isect(sab, r, any_hit=a)))
                    torch.cuda.synchronize()
                    tag = (f"{row} {label} {wname} binned "
                           f"{'any-hit' if any_hit else 'closest-hit'}")
                    check_t_prim(tag, out[0], out[1], ref[0], ref[1],
                                 any_hit, errs_l[row], skip)
                    if row == "B3" and not any_hit:
                        # the hit record, where the winning slot is equal
                        same = (out[1] == ref[1]) & ~skip
                        for f, a, b in zip(ik.HitRecord._fields, out, ref):
                            n_bad = int((a[same] != b[same]).sum())
                            if n_bad:
                                fail(f"{tag}: {f} differs from the plain "
                                     f"version on {n_bad} lanes")
                        print(f"{tag}: all 13 fields equal on "
                              f"{int(same.sum())} lanes", flush=True)
                del out, ref

    # times at the main path's shapes: the binned camera wavefront of the
    # 40k animated scene (closest-hit) and its binned shadow wavefront
    # (any-hit); kernel launch alone, over prepared inputs. Bounds from
    # the work a plain walk of the same lists needs (WalkWork).
    sa40 = big["40k animated"][2]
    cam40, shadow40, bounce40 = b2_rays["40k animated"]
    n_anim = len(sa40.anim_ranges)
    times_l = {row: {} for row in rows}
    for form, any_hit, wname, ray in (
            ("closest_hit", False, "camera", cam40),
            ("any_hit", True, "shadow", shadow40)):
        ray_s, pos = sort_wavefront(sa40, ray)
        t_ref = torch.empty_like(refs40[wname])
        t_ref[pos] = refs40[wname]
        walk = WalkWork(sa40, ray_s, t_ref, any_hit)
        n_lanes = ray_s.o.x.shape[0]
        for row in rows:
            if row == "B2":
                tables, prepare, mod = v4.v4_tables(sa40), v4.prepare, v4
            else:
                tables, prepare, mod = (alt_fn[row][0](sa40),
                                        alt_fn[row][1], alt_mod[row])
            prep = prepare(tables, ray_s)
            k_ms = cuda_time_ms(lambda: mod.launch(tables, prep, any_hit))
            prep_ms = cuda_time_ms(lambda: prepare(tables, ray_s), reps=5)
            need, distinct, what = walk.work(row)
            ray_ops = n_lanes * n_anim * INV_LERP_OPS
            if row in ("B2", "B5"):
                n_ops = need * walk.BLOCK * 32 * WOOP_OPS + ray_ops
                n_bytes = (n_lanes * (32 + 8) + distinct * UNIT_REC * 4
                           + need * (8 + 8))
            elif row == "B4":
                n_ops = need * walk.BLOCK * 32 * MOLLER_OPS + ray_ops
                n_bytes = (n_lanes * (32 + 8) + distinct * 9 * 128 * 4
                           + need * (8 + 8 + 24))
            elif row == "B3":
                n_ops = need * walk.BLOCK * 32 * MOLLER_OPS + ray_ops
                n_bytes = (n_lanes * (32 + (8 if any_hit else 52))
                           + distinct * 32 * 25 * 4 + need * 24)
            else:
                n_ops = need * walk.BLOCK * 128 * WOOP_OPS + ray_ops
                n_bytes = (n_lanes * (36 + 8) + distinct * 8 * 768 * 4
                           + need * (8 + 8 + 4 * 24))
            times_l[row][form] = (k_ms, plain_ms[row][form],
                                  bound(n_bytes, n_ops))
            b_ms, b_by = times_l[row][form][2]
            print(f"{row} time {form} at {n_lanes} lanes (binned), 40k "
                  f"animated: kernel {k_ms:.4f} ms, its inputs "
                  f"({prepare.__module__.split('.')[-1]}.prepare) "
                  f"{prep_ms:.3f} ms, plain {plain_ms[row][form]:.3f} ms; a "
                  f"plain walk needs {need} {what} over "
                  f"{n_lanes // walk.BLOCK} blocks "
                  f"({need / (n_lanes // walk.BLOCK):.1f} per block, "
                  f"{distinct} distinct records); "
                  f"bound {b_ms:.4f} ms ({b_by}) ({card})", flush=True)
        del walk
    # what binning saves: the units a closest-hit walk of the bounce
    # wavefront needs per block, in the wavefront's own order and binned
    bounce_s, pos = sort_wavefront(sa40, bounce40)
    t_ref = torch.empty_like(refs40["bounce"])
    t_ref[pos] = refs40["bounce"]
    per_block = [WalkWork(sa40, r, t, False).work("B2")[0]
                 / (WAVEFRONT // WalkWork.BLOCK)
                 for r, t in ((bounce40, refs40["bounce"]),
                              (bounce_s, t_ref))]
    print(f"bounce wavefront, units a walk needs per block: unbinned "
          f"{per_block[0]:.1f}, binned {per_block[1]:.1f}", flush=True)
    del bounce_s, t_ref
    del b2_rays, cam40, shadow40, bounce40, refs40

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

    # ---- 6. the main path, large scene: B2, then each alternate route ----
    obj40 = big["40k animated"][0]
    row_of = {"v4": "B2", **{route: row for row, route, _, _ in ALTERNATES}}
    launches_l = {}
    for route, row in row_of.items():
        if route != "v4":
            os.environ["MI_STREAM_KERNEL"] = route
        try:
            scene = mi.load_dict(animated_mesh_scene(obj40, spp=256))
            reset_counts()
            t0 = time.perf_counter()
            img = mi.render(scene, spp=256, seed=0)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = read_counts()
            t0 = time.perf_counter()
            img2 = mi.render(scene, spp=256, seed=0)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        finally:
            os.environ.pop("MI_STREAM_KERNEL", None)
        tag = f"40k render through {row} (MI_STREAM_KERNEL={route})"
        if tuple(img.shape) != (256, 256, 3):
            fail(f"{tag}: image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            fail(f"{tag}: image has non-finite values")
        if not bool((img != 0).any()):
            fail(f"{tag}: image is all zero")
        for other, by_form in counts.items():
            for form, count in by_form.items():
                if other == row and count <= 0:
                    fail(f"{tag} launched {row} {form} {count} times")
                if other not in (row, "B1") and count != 0:
                    fail(f"{tag} launched {other} {form} {count} times")
        launches_l[row] = counts[row]
        msps = 256 * 256 * 256 / warm_s / 1e6
        print(f"render 40k animated 256x256x256 dopplertofpath through "
              f"{row} (MI_STREAM_KERNEL={route}): first {first_s:.3f} s, "
              f"warm {warm_s:.3f} s = {msps:.3f} Msamples/s ({card}); "
              f"launches {counts[row]}; image mean {float(img.mean()):.6g}, "
              f"max |v| {float(img.abs().max()):.6g}", flush=True)
        if not torch.equal(img, img2):
            print("note: two renders differ (max "
                  f"{float((img - img2).abs().max()):.3g})", flush=True)
        del img, img2

    # ---- 7. binning is a permutation; the routes agree -------------------
    def render64(**env):
        os.environ.update(env)
        try:
            s64 = mi.load_dict(animated_mesh_scene(obj40, spp=16, res=64))
            return mi.render(s64, spp=16, seed=0)
        finally:
            for k in env:
                os.environ.pop(k, None)

    img_b2 = render64()
    img_nobin = render64(MI_NO_RAY_BINNING="1")
    n_diff = int((img_b2 != img_nobin).sum())
    print(f"binned vs unbinned 40k 64x64x16: {n_diff} of "
          f"{img_b2.numel()} values differ (max abs "
          f"{float((img_b2 - img_nobin).abs().max()):.3g})", flush=True)
    if n_diff:
        fail("binned and unbinned renders differ")
    # Tolerance: every value within rtol 1e-4, atol 1e-4 * max |B2's
    # image|. The routes find the same hits (t bitwise equal to a plain
    # version each), but may pick different triangles at ties in t, test
    # Möller-Trumbore against Woop (t differs in its last bits), and B3
    # takes Möller's barycentrics where the others solve a Gram system at
    # the hit point. On this scene that moves no value by more than 1e-7.
    ref64 = img_b2.cpu().numpy()
    scale64 = float(np.abs(ref64).max())
    for row, route, _, _ in ALTERNATES:
        got = render64(MI_STREAM_KERNEL=route).cpu().numpy()
        close = np.isclose(got, ref64, rtol=1e-4, atol=1e-4 * scale64)
        n_out = int((~close).sum())
        print(f"{row} (MI_STREAM_KERNEL={route}) vs B2 40k 64x64x16: "
              f"{n_out} of {close.size} values outside tolerance, "
              f"{int((got != ref64).sum())} differ at all, max abs diff "
              f"{float(np.abs(got - ref64).max()):.3g} (scale "
              f"{scale64:.3g})", flush=True)
        if n_out or got.shape != ref64.shape:
            fail(f"{row} vs B2: {n_out} values outside tolerance")

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
    entries = [("intersect_bruteforce", B1_SOURCE, B1_TPU, b1,
                launches_c["B1"], errs),
               ("intersect_v4", B2_SOURCE, B2_TPU, times_l["B2"],
                launches_l["B2"], errs_l["B2"])]
    entries += [(name, f"mitsuba3dopplertof_tpu_torch/csrc/{name}.cu",
                 f"mitsuba3dopplertof_tpu/ops/{name}.py:{line}",
                 times_l[row], launches_l[row], errs_l[row])
                for row, _, name, line in ALTERNATES]
    kernels = []
    for name, src, tpu, times, launches, errs_k in entries:
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
