"""Where a render's time goes on the card.

    python -m mitsuba3dopplertof_tpu_torch.utils.profile_render 40k canonical
    python -m mitsuba3dopplertof_tpu_torch.utils.profile_render 40k@v3 40k@v1

``name@route`` renders the scene with ``MI_STREAM_KERNEL=route`` (v4, v3,
v2, v1, mxu: the large-scene kernels B2, B5, B4, B3, B6). For each named
scene: one first render and three warm renders timed on
the host clock (each ends in ``torch.cuda.synchronize()``), then one warm
render under ``torch.profiler`` (CPU and CUDA activities) with its device
kernel time summed by group: the six ray-query kernels B1-B6 by their
kernel names (B2: ``v4_walk_kernel``, B5: ``v3_walk_kernel``, B4:
``v2_walk_kernel``, which build their visit lists themselves), the visit
lists that B6 builds in PyTorch (every kernel that runs inside its
``prepare``, marked by a profiler range),
sorts, gathers and scatters, and the rest. The device
busy share is the kernel time over the median unprofiled wall time; the
rest of the wall the card idles. The phases of ``core/logger.profile_phase``
(ray queries, film splat) are listed with their spans on the device
timeline, gaps included, and the large-scene query kernels' launches in
the order they ran; for the scenes that B1 serves, its launches split by
the query that made them (camera, bounce and shadow rays by depth). Prints
the card's name and power limit first. Needs a CUDA card.

Scenes: ``canonical`` (scenes/canonical/scene.xml, 256x256 x 1024 spp),
the benchmark meshes of ``utils/bench_scenes.py`` at 256x256 x 256 spp:
``2k``, ``10k``, ``40k``, ``100k`` (animated, dopplertofpath) and
``50k-static`` (path), and the hero scene of ``utils/hero_scene.py`` at
its defaults, 256x256 x 64 spp: ``hero`` (dopplertofpath) and
``hero-volpath`` (volpath, max_depth 6; its phases DeltaTracking and
ShadowTransmittance are listed with the others). The OBJ files and the
hero's assets go to the port's ignored build directory.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import statistics
import subprocess
import sys
import time

import torch

# kernel-name fragments of each group, first match wins
_GROUPS = (("B1 intersect_bruteforce", ("intersect_kernel",)),
           ("B5 intersect_v3", ("v3_walk_kernel",)),
           ("B4 intersect_v2", ("v2_walk_kernel", "v2_lists_kernel")),
           ("B3 intersect_stream", ("stream_kernel",)),
           ("B6 intersect_mxu", ("mxu_kernel",)),
           ("B2 intersect_v4", ("v4_walk_kernel", "v4_lists_kernel")),
           ("sort", ("sort", "Sort", "radix")),
           ("gather/scatter", ("index", "gather", "scatter")))
_LISTS = "visit lists"
_LISTS_GROUP = "visit lists (PyTorch prepare of B6)"


@contextlib.contextmanager
def _marked_lists():
    """Every route's visit lists built in PyTorch (``prepare`` of B6; B2,
    B3, B4 and B5 build their own in the kernel) under one profiler
    range."""
    from ..ops import intersect_mxu
    saved = [(m, m.prepare) for m in (intersect_mxu,)]

    def marked(fn):
        def prepare(*args, **kwargs):
            with torch.profiler.record_function(_LISTS):
                return fn(*args, **kwargs)
        return prepare
    for m, fn in saved:
        m.prepare = marked(fn)
    try:
        yield
    finally:
        for m, fn in saved:
            m.prepare = fn


@contextlib.contextmanager
def _labelled_queries(labels):
    """Appends to ``labels`` each ray query of the path loop, in the order
    the render makes them: "camera" (the first closest hit of a pass),
    "bounce d<k>" (the closest hit that finds the k-th vertex) and "shadow
    d<k>" (the shadow rays from the k-th vertex)."""
    from .. import integrators
    saved = (integrators._path_loop, integrators.ray_intersect,
             integrators.ray_test)
    depth = [0]

    def path_loop(*args, **kwargs):
        depth[0] = 0
        return saved[0](*args, **kwargs)

    def ray_intersect(*args, **kwargs):
        depth[0] += 1
        labels.append("camera" if depth[0] == 1 else f"bounce d{depth[0]}")
        return saved[1](*args, **kwargs)

    def ray_test(*args, **kwargs):
        labels.append(f"shadow d{depth[0]}")
        return saved[2](*args, **kwargs)

    (integrators._path_loop, integrators.ray_intersect,
     integrators.ray_test) = path_loop, ray_intersect, ray_test
    try:
        yield
    finally:
        (integrators._path_loop, integrators.ray_intersect,
         integrators.ray_test) = saved


def _lists_kernels(prof, device_type):
    """(name, ms) of each device kernel that started inside a ``visit
    lists`` range on the device timeline; None if the trace has no such
    ranges on the device."""
    evs = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.name == _LISTS and e.device_type == device_type)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    out = []
    for e in evs:
        if (e.device_type != device_type or e.name == _LISTS
                or getattr(e, "is_user_annotation", False)):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i][1]:
            out.append((e.name, e.time_range.elapsed_us() / 1e3))
    return out


def _load(mi, name: str):
    from ..ops.cuda_build import BUILD_DIR
    from .bench_scenes import (ANIMATED_SIZES, STATIC_SIZE,
                               animated_mesh_scene, static_mesh_scene,
                               write_uv_sphere_obj)
    if name == "canonical":
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        return mi.load_file(os.path.join(root, "scenes", "canonical",
                                         "scene.xml")), 1024
    if name in ("hero", "hero-volpath"):
        from .hero_scene import hero_scene_dict
        integ = ({"type": "volpath", "max_depth": 6}
                 if name == "hero-volpath" else None)
        return mi.load_dict(hero_scene_dict(
            cache_dir=str(BUILD_DIR / "scenes" / "hero"),
            integrator=integ)), 64
    static = name == "50k-static"
    nu, nv = STATIC_SIZE if static else ANIMATED_SIZES[name]
    (BUILD_DIR / "scenes").mkdir(parents=True, exist_ok=True)
    obj = str(BUILD_DIR / "scenes" / f"sphere_{nu}x{nv}.obj")
    write_uv_sphere_obj(obj, nu, nv)
    d = (static_mesh_scene(obj, spp=256) if static
         else animated_mesh_scene(obj, spp=256))
    return mi.load_dict(d), 256


def _render_s(mi, scene, spp: int) -> float:
    t0 = time.perf_counter()
    mi.render(scene, spp=spp, seed=0)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _kernel_modules():
    from ..ops import (intersect_kernel, intersect_mxu, intersect_stream,
                       intersect_v2, intersect_v3, intersect_v4)
    return {"B1": intersect_kernel, "B2": intersect_v4,
            "B3": intersect_stream, "B4": intersect_v2, "B5": intersect_v3,
            "B6": intersect_mxu}


def profile_scene(mi, name: str, top: int = 8) -> None:
    """``name`` or ``name@route``; the route is set for this scene only."""
    scene_name, _, route = name.partition("@")
    prev = os.environ.get("MI_STREAM_KERNEL")
    if route:
        os.environ["MI_STREAM_KERNEL"] = route
    try:
        _profile(mi, name, scene_name, top)
    finally:
        if prev is None:
            os.environ.pop("MI_STREAM_KERNEL", None)
        else:
            os.environ["MI_STREAM_KERNEL"] = prev


def _profile(mi, name: str, scene_name: str, top: int) -> None:
    mods = _kernel_modules()
    scene, spp = _load(mi, scene_name)
    W, H = scene.sensor.film.crop_size
    first = _render_s(mi, scene, spp)
    for m in mods.values():
        m.reset_launch_counts()
    warm = [_render_s(mi, scene, spp) for _ in range(3)]
    launches = {b: {k: v // 3 for k, v in m.LAUNCHES_BY_FORM.items()}
                for b, m in mods.items() if m.LAUNCHES}
    med = statistics.median(warm)
    print(f"{name} {W}x{H}x{spp}: first {first:.3f} s, warm "
          f"{', '.join(f'{w:.3f}' for w in warm)} s (median {med:.3f} s = "
          f"{W * H * spp / med / 1e6:.3f} Msamples/s); launches per render "
          f"{launches}", flush=True)
    device_breakdown(mi, scene, spp, med, top)


def device_breakdown(mi, scene, spp: int, wall_s: float,
                     top: int = 8) -> float:
    """One warm render of ``scene`` under torch.profiler: its device
    kernel time by group, the phases' spans, the large-scene query
    kernels' launches in order and B1's launches by query, printed; the
    busy share is the device time over ``wall_s``, a warm render's wall
    time without the profiler. Returns the idle share (1 - busy)."""
    from torch.profiler import ProfilerActivity, profile
    med = wall_s
    t0 = time.perf_counter()
    labels = []
    with _marked_lists(), _labelled_queries(labels), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mi.render(scene, spp=spp, seed=0)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    # device kernels (and copies) only: CPU ops and the phases' ranges
    # (core/logger.profile_phase) would count each kernel again
    from torch.autograd import DeviceType
    avgs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in avgs
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]
    ranges = [(e.key, e.device_time_total / 1e3, e.count) for e in avgs
              if e.is_user_annotation]
    total = sum(ms for _, ms, _ in rows)
    groups = {g: [0.0, 0] for g, _ in _GROUPS}
    groups["other"] = [0.0, 0]
    def group_of(key):
        return next((g for g, frags in _GROUPS
                     if any(f in key for f in frags)), "other")
    for key, ms, count in rows:
        groups[group_of(key)][0] += ms
        groups[group_of(key)][1] += count
    in_lists = _lists_kernels(prof, DeviceType.CUDA)
    if in_lists is not None:
        groups[_LISTS_GROUP] = [0.0, 0]
        for key, ms in in_lists:
            for g, d_ms, d_n in ((group_of(key), -ms, -1),
                                 (_LISTS_GROUP, ms, 1)):
                groups[g][0] += d_ms
                groups[g][1] += d_n
    elif any(key == _LISTS for key, _, _ in ranges):
        print(f"  {_LISTS_GROUP}: not measured (no device ranges in the "
              f"trace)", flush=True)
    print(f"  profiled render {prof_s:.3f} s wall; device kernel time "
          f"{total:.1f} ms = {100 * total / 1e3 / med:.1f}% of the median "
          f"unprofiled wall (idle {100 - 100 * total / 1e3 / med:.1f}%)",
          flush=True)
    for g, (ms, count) in groups.items():
        print(f"  {g}: {ms:.1f} ms in {count} launches "
              f"({100 * ms / max(total, 1e-9):.1f}% of device time)",
              flush=True)
    for key, ms, count in sorted(ranges, key=lambda r: -r[1]):
        print(f"  phase {key}: {ms:.1f} ms of device timeline in {count} "
              f"calls", flush=True)
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"    {ms:9.1f} ms {count:7d}x  {key[:110]}", flush=True)
    # each large-scene query kernel's launches in the order they ran (per
    # strip pass: the camera rays, then one bounce after another)
    per_launch = {}
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and group_of(e.name)[:2] in ("B2", "B3", "B4", "B5",
                                                  "B6")),
                    key=lambda e: e.time_range.start):
        per_launch.setdefault(e.name, []).append(
            e.time_range.elapsed_us() / 1e3)
    for key, times in per_launch.items():
        print(f"  per launch, ms, {key[:60]}: "
              + " ".join(f"{t:.2f}" for t in times), flush=True)
    # B1's launches by the kind of query that made them, where every query
    # of the render is one B1 launch (scenes of at most 192 triangles)
    b1 = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and group_of(e.name).startswith("B1")),
                key=lambda e: e.time_range.start)
    if b1 and len(b1) == len(labels):
        kinds = {}
        for label, e in zip(labels, b1):
            kinds.setdefault(label, []).append(
                e.time_range.elapsed_us() / 1e3)
        print("  B1 by query: " + "; ".join(
            f"{k} {len(v)} launches {sum(v):.1f} ms (mean {sum(v) / len(v):.4f}"
            f", max {max(v):.4f})" for k, v in sorted(kinds.items())),
            flush=True)
    elif b1:
        print(f"  B1 by query: not measured ({len(b1)} launches, "
              f"{len(labels)} queries)", flush=True)
    return 1.0 - total / 1e3 / med


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_render: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    import mitsuba3dopplertof_tpu_torch as mi
    from ..ops.cuda_build import build_all
    build_all([m.LIBRARY for m in _kernel_modules().values()])
    for name in argv or ["canonical", "40k"]:
        profile_scene(mi, name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
