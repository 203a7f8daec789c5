"""Where a render's time goes on the card.

    python -m mitsuba3dopplertof_tpu_torch.utils.profile_render 40k canonical

For each named scene: one first render and three warm renders timed on
the host clock (each ends in ``torch.cuda.synchronize()``), then one warm
render under ``torch.profiler`` (CPU and CUDA activities) with its device
kernel time summed by group: B1 (``intersect_kernel``), B2
(``walk_kernel``), sorts, gathers and scatters, and the rest. The device
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


def profile_scene(mi, name: str, top: int = 8) -> None:
    from ..ops import intersect_kernel as ik
    from ..ops import intersect_v4 as v4
    scene, spp = _load(mi, name)
    W, H = scene.sensor.film.crop_size
    first = _render_s(mi, scene, spp)
    ik.reset_launch_counts()
    v4.reset_launch_counts()
    warm = [_render_s(mi, scene, spp) for _ in range(3)]
    launches = {"B1": {k: v // 3 for k, v in ik.LAUNCHES_BY_FORM.items()},
                "B2": {k: v // 3 for k, v in v4.LAUNCHES_BY_FORM.items()}}
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
    from ..ops import intersect_kernel as ik
    from ..ops import intersect_v4 as v4
    from ..ops.cuda_build import build_all
    build_all([ik.LIBRARY, v4.LIBRARY])
    for name in argv or ["canonical", "40k"]:
        profile_scene(mi, name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
