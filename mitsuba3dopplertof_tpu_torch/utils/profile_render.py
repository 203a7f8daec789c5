"""Where a render's time goes on the card.

    python -m mitsuba3dopplertof_tpu_torch.utils.profile_render 40k canonical
    python -m mitsuba3dopplertof_tpu_torch.utils.profile_render 40k@v3 40k@v1

``name@route`` renders the scene with ``MI_STREAM_KERNEL=route`` (v4, v3,
v2, v1, mxu: the large-scene kernels B2, B5, B4, B3, B6). For each named
scene: one first render and three warm renders timed on
the host clock (each ends in ``torch.cuda.synchronize()``), then one warm
render under ``torch.profiler`` (CPU and CUDA activities) with its device
kernel time summed by group: the six ray-query kernels B1-B6 by their
kernel names, sorts, gathers and scatters, and the rest. The device
busy share is the kernel time over the median unprofiled wall time; the
rest of the wall the card idles. The phases of ``core/logger.profile_phase``
(ray queries, film splat) are listed with their spans on the device
timeline, gaps included. Prints the card's name and power limit
first. Needs a CUDA card.

Scenes: ``canonical`` (scenes/canonical/scene.xml, 256x256 x 1024 spp) and
the benchmark meshes of ``utils/bench_scenes.py`` at 256x256 x 256 spp:
``2k``, ``10k``, ``40k``, ``100k`` (animated, dopplertofpath) and
``50k-static`` (path). The OBJ files go to the port's ignored build
directory.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import torch

# kernel-name fragments of each group, first match wins
_GROUPS = (("B1 intersect_bruteforce", ("intersect_kernel",)),
           ("B5 intersect_v3", ("v3_walk_kernel",)),
           ("B4 intersect_v2", ("v2_walk_kernel",)),
           ("B3 intersect_stream", ("stream_kernel",)),
           ("B6 intersect_mxu", ("mxu_kernel",)),
           ("B2 intersect_v4", ("walk_kernel",)),
           ("sort", ("sort", "Sort", "radix")),
           ("gather/scatter", ("index", "gather", "scatter")))


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

    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    for key, ms, count in rows:
        g = next((g for g, frags in _GROUPS
                  if any(f in key for f in frags)), "other")
        groups[g][0] += ms
        groups[g][1] += count
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
