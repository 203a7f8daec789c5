"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --spectral
    python3 chip_smoke.py --polarized
    python3 chip_smoke.py --b2-walk CHECKOUT
    python3 chip_smoke.py --b1-walk CHECKOUT
    python3 chip_smoke.py --b6-walk CHECKOUT
    python3 chip_smoke.py --b3-walk CHECKOUT
    python3 chip_smoke.py --b4-walk CHECKOUT
    python3 chip_smoke.py --b5-walk CHECKOUT

Runs from the root of a checkout and needs one CUDA card; without one (or
without the package beside it) it exits non-zero and prints no result.
``--spectral`` runs the build and phase 14 alone, with no kernel or
contract line, and ``--polarized`` the build and phase 15 alone.
``--b2-walk CHECKOUT`` runs only B2's walk report (phase 4's B2 lines) on
the package of another checkout, such as the parent commit unpacked with
``git archive``, so that two commits compare on one card in one call;
``--b1-walk CHECKOUT`` likewise times that checkout's B1 on phase 3's
four canonical wavefronts, and ``--b6-walk CHECKOUT`` its B6 on the 40k
scene's binned camera, bounce and shadow wavefronts (kernel and query)
and its 40k render through MI_STREAM_KERNEL=mxu; ``--b3-walk CHECKOUT``
its B3 on those wavefronts and on those of the lower strip (phase 4a)
and its 40k render through MI_STREAM_KERNEL=v1, and ``--b4-walk
CHECKOUT`` its B4 (kernel, query and lists) on the same six wavefronts and
its 40k render through MI_STREAM_KERNEL=v2, and ``--b5-walk CHECKOUT`` its
B5 (kernel, query, and an earlier B5's PyTorch lists) and its B2 kernel on
those six wavefronts and its 40k render through MI_STREAM_KERNEL=v3. Every
phase raises on failure:

  1. the card: name and power limit (nvidia-smi);
  2. build all six kernels from the checkout, one nvcc each, started
     together: B1 (csrc/intersect_bruteforce.cu), B2 (intersect_v4.cu), B3
     (intersect_stream.cu), B4 (intersect_v2.cu), B5 (intersect_v3.cu) and
     B6 (intersect_mxu.cu), with their registers and spills (ptxas -v),
     and the count of tensor-core instructions (HMMA) in B6's library
     (cuobjdump --dump-sass; fails if there are none);
  3. B1 against its plain PyTorch version on the card: 1M random rays in
     the canonical scene, the canonical scene's wavefronts of one strip
     pass (camera rays, depth-1 shadow rays, depth-2 bounce rays and
     depth-2 shadow rays: the main path's shapes), and a scene with
     spheres and animated cubes; closest-hit and any-hit, with the
     hit-matching criteria of tests/test_pallas_parity.py, t bitwise on
     triangle hits, prim equal and an exact occlusion match; then kernel
     (device time, by torch.profiler) and plain times
     on the four canonical wavefronts, the slots a warp's gate passes
     (mean, p99, max) and the bound from the gated walk's work per warp
     beside the dense one;
  4. the large-scene kernels B2-B6 against their plain PyTorch versions on
     the card, on the 40k animated UV-sphere scene and the static 50k one
     (utils/bench_scenes.py, the JAX package's scripts/bench_suite.py
     scenes): a camera wavefront of 1,048,576 lanes (one strip pass),
     shadow rays toward the point light and diffuse bounce rays from the
     camera hits; closest-hit and any-hit, over binned rays (B2 unbinned
     too). t bitwise equal on hit lanes, prim different only at ties in t,
     occlusion exact, for B4 and B5 prim equal on every lane, and for B3
     the whole hit record equal where prim is;
     then times on the binned camera (closest-hit) and shadow (any-hit)
     wavefronts, and B2's, B4's and B5's on the binned bounce wavefront
     too: kernel, visit lists in PyTorch (prepare) or the kernel's own
     lists alone (B2, B4) and query; for B5 the units its warps' walks
     test behind its per-lane box test beside those B2's warp gate leaves
     on the same lists, and its walk with lists of 16 units a round
     (rounds) against the plain version; for B2 the units a walk
     needs per 256-lane block and per 32-lane warp (mean, p99, max, share
     of the tests in the slowest 1%); bounds from the work a plain walk
     needs (WalkWork); B2's and B4's in-kernel visit lists against
     _unit_visit_order and _visit_order, bit for bit, also with a
     capacity that forces rounds (and each walk with it against its plain
     version); for B4 the quarters its warps' walks test; for B6
     also its bounce wavefront, the chunks its warps' walks test per
     32-lane warp, and the share of those pairs that its gate passes to
     the exact test, by the gate's plain version (mxu_gate_reference) on
     the first 65,536 lanes of each wavefront, with each lane's best t at
     the chunk's start; for B3 also its bounce wavefront, the chunks its
     warps' walks test per 32-lane warp, and a walk with lists of 16
     groups a round (rounds) against the plain version;
  4a. the lower strip of the 40k frame (pixel rows 192-207: camera rays
     that pass under the sphere's lower half to the floor, the render's
     longest walks), its camera, bounce and shadow wavefronts, binned: B3,
     B4 and B5 against their plain versions (t bitwise, prim equal, B3's
     record equal, occlusion exact), their times and bounds (B5's beside
     B2's); B2's times and walk there as a measurement;
  4b. B2 on a 65,536-lane slice of the 100k animated scene's camera
     wavefront and its bounce and shadow rays: the in-kernel lists (one
     round and rounds of 1,024) and the walk against the plain version;
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
  9. the rest of the Doppler core: velocity and depth on the canonical
     scene at 256x256 x 1024 spp through B1 (velocity: two closest-hit
     launches a pass) and on the 40k animated scene at 256x256 x 256 spp
     through B2; dopplertofpath with the timestratified sampler on the
     canonical scene, and through a thin lens with the mitchell filter on
     the 40k scene; each twice, the second render timed, launch counts
     read around the first; on the card against the CPU at 16x16 x 16 spp
     with phase 8's criteria: velocity and depth (canonical and the 2k
     mesh), the five new samplers, a batch sensor (thinlens, orthographic,
     distant, perspective) and the lanczos and catmullrom filters; a
     timed-out render, and checkpoint resumes (spp-sliced and strip passes)
     equal to the uninterrupted render bit for bit, at 64x64 x 64 spp;
 10. the hero scene (utils/hero_scene.py, assets written by the port):
     dopplertofpath at 256x256 x 64 spp and volpath (max_depth 6) at the
     largest of 64, 32 and 16 spp that fits 60 s, each twice with B2's
     launches; B2 against its plain version on the hero's camera and
     shadow wavefronts, timed with its bound; the card against the CPU on
     the mini hero (a 192-triangle knot, a 96-triangle sphere) at 16x16 x
     16 spp for both integrators and through MI_STREAM_KERNEL=v3, the
     lanes whose paths meet a tie or graze an edge (tests/torch_ties.py)
     left out of both films, with phase 8's criteria; and the card's mean of
     seeds 0 and 1 at 512 spp against QUALITY_HERO_ref.npz at pyramid
     levels 3-5, within 3x the Monte Carlo error of QUALITY_HERO.md's
     table plus the anchor's float16 rounding;
 11. the scene dialect's surfaces and lights: the JAX package's deep-path
     row (scripts/bench_suite.py:118-139: path, max_depth 48, a sphere
     area light in a two-sided diffuse box) at 256x256 x 256 spp through
     B1, and the glass scene (``glass_dict``: the 40k UV sphere of
     utils/bench_scenes.py written as a binary PLY, in a shapegroup placed by an
     animated instance, with roughdielectric; a roughconductor floor, a
     thindielectric pane, a disk under mask, a cylinder under blendbsdf; a
     sphere area light, a spot, a directional light and a constant sky)
     at 256x256 x 256 spp
     through B2 and B1's sphere pass, each twice with their launches, the
     idle share of one glass strip pass by torch.profiler; the card
     against the CPU at 16x16 x 16 spp with phase 8's criteria (marked
     lanes left out, as in phase 10): the deep-path scene, and the glass
     scene with the 2k sphere through B2 and through MI_STREAM_KERNEL=v3,
     whose image must be B2's within phase 7's tolerance;
 12. the rgb variant's other integrators, each timed warm after a
     one-pass warm-up with its launches: moment around the canonical
     dopplertofpath at 256x256 x 1024 spp through B1 (its RGB the plain
     render's bit for bit, m2 >= mean^2), ptracer on the canonical scene
     (max_depth 4, 1024 light paths a pixel: the JAX package's
     bench_suite.py:218-223 row) through B1, aov (depth, position, shading
     normal, albedo) around dopplertofpath and direct on the hero scene
     at 256x256 x 64 spp through B2, volpathmis on the volpath row
     (bench_suite.py:95-116) at the largest of 256, 64 and 16 spp that
     fits 15 s, and the principled scene (``principled_dict``: the 40k
     sphere principled, a pplastic floor, a principledthin pane) at
     256x256 x 256 spp through B2, with the launches and device time of
     one BSDF dispatch with and without the principled family; the card
     against the CPU at 16x16 x 16 spp with phase 8's criteria: moment,
     aov (box filter, alpha; triangle and instance ids equal; every
     pixel, the shading normal and uv of missed lanes the plain
     intersector's on both devices), direct,
     use_nee=false, volpathmis, the principled scene with the 2k sphere
     through B2 and through MI_STREAM_KERNEL=v3 (marked lanes left out),
     and ptracer on the projector / directionalarea scene;
 13. textured surfaces and lights and the other phases
     (utils/textured_scenes.py, assets written by the port into a temp
     dir), each timed warm with its launches: the surface scene (normalmap,
     bumpmap, a volume texture, checkerboard rectangle and bitmap sphere
     lights; dopplertofpath 256x256 x 64, B1), the 40k vertex-coloured
     sphere under mesh_attribute below a 2k textured mesh light (256x256
     x 64, B2), the media scene (rayleigh, blendphase, tabphase, sggx with
     a varying S grid; volpath, the spp a probe fits in 15 s); card
     against CPU at 16x16 x 16 (the surface scene also with direct, aov
     and ptracer; the mesh light with the 2k sphere);
 14. the spectral and mono variants and the measured BSDF (scenes of
     utils/{spectral_scenes,measured_data,textured_scenes,hero_scene}.py
     and the glass scene), each timed warm with its launches, in
     cuda_spectral unless named: the canonical dopplertofpath 256x256 x
     1024 (B1, its launches equal to phase 5's), the hero 256x256 x 64
     (B2) with its compile timed apart (the cold rgb2spec lattice and
     the sky's per-texel fits on the card), glass 40k 256x256 x 64 (named
     conductors through their eta / k spectra; B2 and B1's sphere pass),
     measured on the 40k sphere 256x256 x 64 in cuda_rgb and
     cuda_spectral (B2) with one measured BSDF dispatch over 2^20 lanes
     each, the media scene's volpath (the spp a probe fits in 15 s, B1);
     card against CPU at 16x16 x 16: the canonical scene in cuda_mono
     and into a specfilm of three regular SRFs, measured rgb and spectral
     on the 2k sphere, the mini hero and the media scene (marked lanes
     left out where B2 runs);
 15. the polarized variants (utils/polarized_scenes.py, the glass and
     media scenes, measured_polarized on a synthetic pBRDF), each timed
     warm with its launches, in cuda_rgb_polarized unless named: the
     canonical dopplertofpath 256x256 x 1024 on the depolarizing fast path
     (image and B1 launches equal to cuda_rgb's), the canonical scene under
     stokes(dopplertofpath) with the fast path off at 256x256 x 256 (S0
     within 1e-6 of the fast path's), glass 40k under stokes 256x256 x 64
     (B2 and B1's sphere pass) with the idle share of one strip pass,
     measured_polarized on the 40k sphere 256x256 x 64 in both polarized
     variants (B2), the media scene under stokes(volpath) (the spp a probe
     fits in 15 s, B1); Malus's law and a quarter-wave plate; card against
     CPU at 16x16 x 16 over every Stokes channel: the elements' plates,
     the polarizing canonical (stokes in both polarized variants, and
     ptracer), glass and measured_polarized on the 2k sphere, the media
     scene;
 16. a JSON line with the kernels (B2 twice more: on the hero's
     wavefronts; B1's and B2's entries carry their launches in phase
     11's to 15's renders as ``launches_<scene>``), then the contract
     line {"ok": true, "device": {...}}.

Bounds (``bound_ms``): the larger of the bytes a kernel must move (each
input read once, each output written once) over the card's memory rate and
the float32 operations it must do on this run's inputs over the card's
float32 rate (NVIDIA's H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s outside
the tensor cores). For B2-B6 the operations count the units, quarters or
chunks that a walk of the timed wavefront's visit lists must test, computed
in PyTorch from the lists and the plain versions' results (``WalkWork``),
not from counters in the kernels: per 32-lane warp for B2-B6 (whose warps
stop on their own bounds; B6's, B4's and B3's each with its own slab test
of a chunk's or quarter's boxes over its live lanes, B5's with each
lane's own ray against a unit's box), plus B2's, B3's, B4's and B5's
lists (a slab test per block and unit, group or chunk, n log2 n compares
to sort), B3's chunk and B4's quarter gates and B5's per-lane tests (one
per lane and unit of its warp's list prefix); B4's per-block bound is
printed beside its own, B2's per-warp bound beside B5's.
B1's count the slots, instances and boxes that each warp's gate makes it
test (``b1_work``, from
the gate's plain version ``b1_warp_masks``); the dense count (every lane
tests every slot) is printed beside it. B6 has a second bound, for its
tensor cores: the larger of the bytes over the memory rate, the product's
96 flops a pair over the TF32 rate of the tensor cores (495 TFLOP/s) and
the Woop epilogue's 15 float32 operations a pair (with the rays'
transforms) over the float32 rate; its ``bound_ms`` is the smaller of the
two. No single PyTorch call computes a ray-triangle query, so
``library_ms`` is null.
"""

from __future__ import annotations

import importlib
import json
import math
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
TF32_OPS_PER_S = 495e12         # H100 SXM TF32 on the tensor cores, dense
# float32 operations of one ray-triangle test, counted in the kernels'
# source: Möller-Trumbore in B1 (edge crosses, determinant, division,
# three dot products, six compares), the Woop test in B2 (three affine
# rows of 11, division, two multiply-adds, seven compares). B6 computes
# Woop's affine map as a (768 x 8) product per chunk of 128 triangles, half
# of whose coefficients are structural zeros: its bound counts the 128 Woop
# tests the function needs, not the zero terms
MOLLER_OPS = 56
WOOP_OPS = 48
# B6 on the tensor cores: the (6 x 8) . (8 x 1) product of a pair (48
# multiply-adds) and the Woop epilogue's float32 operations (division,
# two multiply-adds, seven compares)
MXU_PRODUCT_FLOPS = 96
WOOP_EPILOGUE_OPS = 15
# per lane and animated range: lerp of 12 entries, adjugate inverse and
# the ray's transform
INV_LERP_OPS = 130
# per lane and sphere: the inverse and the ray's transform, then the
# quadratic (three dot products, discriminant, square root, two divisions,
# compares)
SPHERE_OPS = INV_LERP_OPS + 30
# B1's warp gate: per lane, the shuffle reductions of the ray bounds (12
# minima or maxima of 5 rounds, the largest maxt), six reciprocals and the
# pad; per box, the slab test (per axis two pads, four differences, eight
# products, fourteen minima or maxima, two clamps; the final compare)
B1_GATE_LANE_OPS = 80
B1_SLAB_OPS = 91
# one slab test of a block's ray bounds against a unit box in the kernel's
# list (per axis four differences, eight products, eight minima, eight
# maxima and the two clamps; then the final compare), and the scene-box
# exit of one lane
SLAB_OPS = 92
EXIT_OPS = 40
# B5's per-lane test of a lane's ray against a unit box (lane_box): per
# axis two differences, two products, a minimum, a maximum and two
# compares; the far end, the scale and the final compare
BALLOT_OPS = 27
UNIT_BYTES = 12 * 32 * 4        # a unit's Woop record: 12 floats a triangle
WAVEFRONT = 1 << 20             # lanes of one strip pass
# first pixel rows of the two strips of the 40k frame (256 x 256, 256 lanes
# a pixel: a strip pass is 16 rows) whose wavefronts are timed: the middle
# strip, and the lower one, whose camera rays pass under the sphere's
# lower half to the floor (the render's longest walks)
MIDDLE_ROW = 120
LOWER_ROW = 192


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


def check_t_prim(tag, t_k, p_k, t_r, p_r, any_hit, errs_k, skip=None,
                 exact_prim=False):
    """Occlusion exact on every lane; closest-hit: t bitwise equal on
    hit lanes, prim different only at ties in t (with ``exact_prim``
    on no lane). ``skip``: lanes left out (``zero_area_winner``), at
    most one in 100,000."""
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
    if n_pdiff > (0 if exact_prim else max(20, int(hit.sum()) // 10000)):
        fail(f"{tag}: prim differs on {n_pdiff} lanes")


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
        sensor.device_params(), None, f32(rng.uniform(0.0, shutter, n)),
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


def b2_times(v4, sa, ray_s, any_hit):
    """(kernel, query, prepare, lists) ms of B2 on one wavefront: the
    query is ``intersect_v4`` as the route calls it, the kernel one launch
    over its inputs, ``prepare`` the visit lists in PyTorch. A B2 that
    builds its lists itself (``v4.lists`` exists) launches on the rays,
    and ``lists`` times the same list code alone (with the lists' write to
    device memory); an earlier one launches on ``prepare``'s lists and
    ``lists`` is None."""
    tables = v4.v4_tables(sa)
    q_ms = cuda_time_ms(lambda: v4.intersect_v4(sa, ray_s, any_hit=any_hit))
    p_ms = cuda_time_ms(lambda: v4.prepare(tables, ray_s), reps=5)
    l_ms = None
    if hasattr(v4, "lists"):
        k_ms = cuda_time_ms(lambda: v4.launch(tables, ray_s, any_hit))
        l_ms = cuda_time_ms(lambda: v4.lists(tables, ray_s), reps=5)
    else:
        prep = v4.prepare(tables, ray_s)
        k_ms = cuda_time_ms(lambda: v4.launch(tables, prep, any_hit))
    return k_ms, q_ms, p_ms, l_ms


def walk_line(tag, wname, any_hit, times, dist, card):
    """One line of the B2 walk report: times and the walk's distribution
    (``WalkWork.b2_distribution``)."""
    k_ms, q_ms, p_ms, l_ms = times
    (bm, bp, bx, bs), (wm, wp, wx, ws) = dist
    alt = "" if l_ms is None else f" (its lists alone {l_ms:.4f} ms)"
    return (f"{tag} {wname} wavefront "
            f"({'any-hit' if any_hit else 'closest-hit'}, binned, 40k "
            f"animated): kernel {k_ms:.4f} ms{alt}, query {q_ms:.4f} ms, "
            f"prepare {p_ms:.3f} ms; units a walk needs per 256-lane block: mean "
            f"{bm:.1f}, p99 {bp:.1f}, max {bx:.0f}, slowest 1% of blocks "
            f"{100 * bs:.1f}% of the tests; per 32-lane warp: mean {wm:.1f}, "
            f"p99 {wp:.1f}, max {wx:.0f}, slowest 1% of warps "
            f"{100 * ws:.1f}% ({card})")


def strip_waves(sc, sa, row0, seed):
    """The camera wavefront of one strip pass of the 40k (or 50k) scene,
    from pixel row ``row0`` (256 lanes a pixel, 1.5 ms shutter where the
    scene moves), and its bounce and shadow rays: ((name, any_hit, ray),
    ...) for camera (closest-hit), bounce (closest-hit) and shadow
    (any-hit), and the number of camera hits."""
    W = sc.sensor.film.crop_size[0]
    cam = camera_wavefront(sc, WAVEFRONT, row0 * W * 256, 256,
                           0.0015 if sa.anim_ranges else 0.0, seed=seed)
    shadow, bounce, n_valid = secondary_wavefronts(sa, cam, seed=seed + 1)
    return (("camera", False, cam), ("bounce", False, bounce),
            ("shadow", True, shadow)), n_valid


def checkout_40k(root: str, module: str, lower: bool = False):
    """The package of the checkout at ``root`` (another commit, to compare
    with this one on one card in one call), its kernel module ``module``
    of ``ops`` built and loaded, and the 40k animated scene's camera,
    bounce and shadow wavefronts of the middle strip as the full run
    builds them, with ``lower`` also those of the lower strip (names
    prefixed "lower "). Returns (card, mi, the module, OBJ path,
    SceneArrays, ((name, any_hit, ray), ...))."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    root = os.path.abspath(root)
    if not os.path.isdir(os.path.join(root, "mitsuba3dopplertof_tpu_torch")):
        fail(f"{root} holds no mitsuba3dopplertof_tpu_torch/")
    sys.path.insert(0, root)
    card = card_line()
    print(card, flush=True)
    import mitsuba3dopplertof_tpu_torch as mi
    from mitsuba3dopplertof_tpu_torch.ops.cuda_build import BUILD_DIR
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
        ANIMATED_SIZES, animated_mesh_scene, write_uv_sphere_obj)
    mod = importlib.import_module(f"mitsuba3dopplertof_tpu_torch.ops.{module}")
    if not mod.__file__.startswith(root):
        fail(f"imported {mod.__file__}, not the package under {root}")
    mod.LIBRARY.load()
    for line in mod.LIBRARY.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {mod.LIBRARY.name}: {line.strip()}", flush=True)
    mi.set_variant("cuda_rgb")
    (BUILD_DIR / "scenes").mkdir(parents=True, exist_ok=True)
    nu, nv = ANIMATED_SIZES["40k"]
    obj = str(BUILD_DIR / "scenes" / f"sphere_{nu}x{nv}.obj")
    write_uv_sphere_obj(obj, nu, nv)
    sc = mi.load_dict(animated_mesh_scene(obj, spp=256))
    sa = sc.compile()
    waves = strip_waves(sc, sa, MIDDLE_ROW, seed=1)[0]
    if lower:
        waves += tuple((f"lower {name}", any_hit, ray) for name, any_hit, ray
                       in strip_waves(sc, sa, LOWER_ROW, seed=5)[0])
    return card, mi, mod, obj, sa, waves


def b2_walk_main(root: str) -> int:
    """``--b2-walk DIR``: B2's walk report alone, on the package of the
    checkout at DIR: the 40k animated scene's binned camera, bounce and
    shadow wavefronts, as the full run builds them."""
    card, _, v4, _, sa, waves = checkout_40k(root, "intersect_v4")
    tag = f"B2 at {os.path.basename(os.path.abspath(root).rstrip(os.sep))}"
    for wname, any_hit, ray in waves:
        ray_s, _ = sort_wavefront(sa, ray)
        t_ref = v4.intersect_v4_reference(sa, ray_s)[0]
        walk = WalkWork(sa, ray_s, t_ref, any_hit)
        print(walk_line(tag, wname, any_hit, b2_times(v4, sa, ray_s, any_hit),
                        walk.b2_distribution(), card), flush=True)
        del walk, ray_s, t_ref
    return 0


def b6_times(mxu, sa, ray_s, any_hit):
    """(kernel, query) ms of B6 on one binned wavefront: one launch over
    ``prepare``'s inputs, and the query as the route calls it (visit
    lists in PyTorch included)."""
    tables = mxu.mxu_tables(sa)
    prep = mxu.prepare(tables, ray_s)
    k_ms = cuda_time_ms(lambda: mxu.launch(tables, prep, any_hit))
    q_ms = cuda_time_ms(lambda: mxu.intersect_mxu(sa, ray_s, any_hit=any_hit),
                        reps=5)
    return k_ms, q_ms


def b3_times(stream, sa, ray_s, any_hit):
    """(kernel, query) ms of B3 on one binned wavefront: one launch over
    ``prepare``'s inputs (the padded columns), and the query as the route
    calls it."""
    tables = stream.stream_tables(sa)
    prep = stream.prepare(tables, ray_s)
    k_ms = cuda_time_ms(lambda: stream.launch(tables, prep, any_hit))
    q_ms = cuda_time_ms(lambda: stream.intersect_stream(
        sa, ray_s, any_hit=any_hit), reps=5)
    return k_ms, q_ms


def b3_bound(walk, ray_ops):
    """B3's bound on a walk's wavefront (``WalkWork.b3_warps``): the
    Möller tests of the chunks its warps' walks test, the block lists (a
    slab test per block and group, n log2 n compares to sort) and the
    warps' chunk gates (a slab test per chunk of each entry they reach)
    over the float32 rate; the rays, the results, the geometry of each
    chunk tested once (48 bytes a triangle) and the boxes over the memory
    rate. Returns ((bound_ms, bound_by), a summary of the walk)."""
    import torch
    per_warp, tested, _, reach, length = walk.b3_warps()
    tb = walk.tb3
    n_groups = tb.n_chunks // 8
    m = length.double()
    sort_ops = float((m * torch.log2(torch.clamp(m, min=2.0))).sum())
    need = int(per_warp.sum())
    distinct = int(tested.any(dim=0).sum())
    n_ops = (need * 32 * 32 * MOLLER_OPS + ray_ops
             + walk.nb * n_groups * SLAB_OPS + sort_ops
             + int(reach.sum()) * 8 * SLAB_OPS)
    n_bytes = (walk.n * (32 + (8 if walk.any_hit else 52))
               + distinct * 32 * 48 + (n_groups + tb.n_chunks) * 24)
    pw = per_warp.double()
    summary = (f"a plain walk tests {need} chunks over {walk.n // 32} warps "
               f"(per warp mean {float(pw.mean()):.2f}, p99 "
               f"{float(torch.quantile(pw, 0.99)):.0f}, max "
               f"{int(per_warp.max())}; {distinct} distinct), reaching "
               f"{float(reach.double().mean()):.2f} of a mean "
               f"{float(m.mean()):.2f} list entries per warp")
    return bound(n_bytes, n_ops), summary


def b4_times(v2, sa, ray_s, any_hit):
    """(kernel, query, lists) ms of B4 on one binned wavefront: the query
    is ``intersect_v2`` as the route calls it. A B4 that builds its lists
    itself (``v2.lists`` exists) launches on the rays, and ``lists`` times
    the same list code alone (with the lists' write to device memory); an
    earlier one launches on ``prepare``'s lists, and ``lists`` times
    ``prepare``."""
    tables = v2.v2_tables(sa)
    q_ms = cuda_time_ms(lambda: v2.intersect_v2(sa, ray_s, any_hit=any_hit))
    if hasattr(v2, "lists"):
        k_ms = cuda_time_ms(lambda: v2.launch(tables, ray_s, any_hit))
        l_ms = cuda_time_ms(lambda: v2.lists(tables, ray_s), reps=5)
    else:
        prep = v2.prepare(tables, ray_s)
        k_ms = cuda_time_ms(lambda: v2.launch(tables, prep, any_hit))
        l_ms = cuda_time_ms(lambda: v2.prepare(tables, ray_s), reps=5)
    return k_ms, q_ms, l_ms


def b4_bound(walk, ray_ops):
    """B4's bound on a walk's wavefront (``WalkWork.b4_warps``): the
    Möller tests of the quarters its warps' walks test, the scene-box
    clamp of each lane, the block lists (a slab test per block and chunk,
    n log2 n compares to sort) and the warps' quarter gates (a slab test
    per quarter of each entry they reach) over the float32 rate; the rays,
    the results, the geometry of each quarter tested once (36 bytes a
    triangle) and the boxes over the memory rate. Returns ((bound_ms,
    bound_by), a summary of the walk)."""
    import torch
    per_warp, tested, _, reach = walk.b4_warps()
    n_chunks = walk.tb2.n_chunks
    m = (walk.tlo128 < walk.BIG).sum(dim=1).double()
    sort_ops = float((m * torch.log2(torch.clamp(m, min=2.0))).sum())
    need = int(per_warp.sum())
    distinct = int(tested.any(dim=0).sum())
    n_ops = (need * 32 * 32 * MOLLER_OPS + ray_ops + walk.n * EXIT_OPS
             + walk.nb * n_chunks * SLAB_OPS + sort_ops
             + int(reach.sum()) * 4 * SLAB_OPS)
    n_bytes = (walk.n * (32 + 8) + distinct * 32 * 36
               + n_chunks * (5 * 24 + 8))
    pw = per_warp.double()
    summary = (f"a plain walk tests {need} quarters over {walk.n // 32} "
               f"warps (per warp mean {float(pw.mean()):.2f}, p99 "
               f"{float(torch.quantile(pw, 0.99)):.0f}, max "
               f"{int(per_warp.max())}; {distinct} distinct), reaching "
               f"{float(reach.double().mean()):.2f} of a mean "
               f"{float(m.mean()):.2f} list entries per warp")
    return bound(n_bytes, n_ops), summary


def b4_line(tag, wname, any_hit, times, n_lanes, card, extra=""):
    """One line of B4's times on a binned 40k wavefront (``b4_times``)."""
    k_ms, q_ms, l_ms = times
    return (f"{tag} {wname} wavefront "
            f"({'any-hit' if any_hit else 'closest-hit'}, binned, {n_lanes} "
            f"lanes, 40k animated): kernel {k_ms:.4f} ms, query {q_ms:.4f} "
            f"ms, lists {l_ms:.4f} ms{extra} ({card})")


def b2_walk_bound(walk, ray_ops):
    """B2's bound on a walk's wavefront (``WalkWork.b2_work``): the Woop
    tests of the units its warps' walks test, the scene-box clamp of each
    lane and the lists over the float32 rate; the rays, the results, the
    records of the units tested once and the boxes over the memory rate.
    Returns ((bound_ms, bound_by), units tested, distinct units, the
    lists' operations)."""
    need, distinct, list_ops = walk.b2_work()
    n_ops = (need * 32 * 32 * WOOP_OPS + ray_ops + walk.n * EXIT_OPS
             + list_ops)
    n_bytes = (walk.n * (32 + 8) + distinct * UNIT_BYTES
               + walk.n_units * (24 + 8))
    return bound(n_bytes, n_ops), need, distinct, list_ops


def b5_times(v3, v4, sa, ray_s, any_hit):
    """(kernel, query, lists) ms of B5 on one binned wavefront: the query
    is ``intersect_v3`` as the route calls it. A B5 that builds its lists
    itself (``v3.v3_walk_reference`` exists) launches on the rays, and
    ``lists`` is None (its lists are B2's, timed alone with B2); an
    earlier one launches on ``v4.prepare``'s lists, and ``lists`` times
    ``prepare``."""
    tables = v4.v4_tables(sa)
    q_ms = cuda_time_ms(lambda: v3.intersect_v3(sa, ray_s, any_hit=any_hit))
    if hasattr(v3, "v3_walk_reference"):
        k_ms = cuda_time_ms(lambda: v3.launch(tables, ray_s, any_hit))
        return k_ms, q_ms, None
    prep = v4.prepare(tables, ray_s)
    k_ms = cuda_time_ms(lambda: v3.launch(tables, prep, any_hit))
    return k_ms, q_ms, cuda_time_ms(lambda: v4.prepare(tables, ray_s),
                                    reps=5)


def b5_line(tag, wname, any_hit, times, n_lanes, card, extra=""):
    """One line of B5's times on a binned 40k wavefront (``b5_times``)."""
    k_ms, q_ms, l_ms = times
    lists = "" if l_ms is None else f", prepare {l_ms:.4f} ms"
    return (f"{tag} {wname} wavefront "
            f"({'any-hit' if any_hit else 'closest-hit'}, binned, {n_lanes} "
            f"lanes, 40k animated): kernel {k_ms:.4f} ms, query {q_ms:.4f} "
            f"ms{lists}{extra} ({card})")


def b5_bound(walk, ray_ops, b2_bound):
    """B5's bound on a walk's wavefront (``WalkWork.b5_warps``): the Woop
    tests of the units its warps' walks test, one per-lane box test per
    lane for every unit of each warp's list prefix, the scene-box clamp of
    each lane and the lists (``list_ops``) over the float32 rate; the rays,
    the results, the records of the units tested once and the boxes over
    the memory rate. Returns ((bound_ms, bound_by), a summary of the walk
    beside B2's on the same lists: the units a warp tests under the
    per-lane test and under B2's warp gate, B2's bound ``b2_bound``)."""
    import torch
    per_warp, tested, _, reach = walk.b5_warps()
    need = int(per_warp.sum())
    distinct = int(tested.any(dim=0).sum())
    n_ops = (need * 32 * 32 * WOOP_OPS + int(reach.sum()) * 32 * BALLOT_OPS
             + ray_ops + walk.n * EXIT_OPS + walk.list_ops())
    n_bytes = (walk.n * (32 + 8) + distinct * UNIT_BYTES
               + walk.n_units * (24 + 8))
    b2 = walk.b2_warps()[0]

    def dist(v):
        v = v.double()
        return (f"mean {float(v.mean()):.2f}, p99 "
                f"{float(torch.quantile(v, 0.99)):.0f}, max "
                f"{int(v.max())}")
    summary = (f"a plain walk tests {need} units over {walk.n // 32} warps "
               f"(per warp {dist(per_warp)}; {distinct} distinct), reaching "
               f"{float(reach.double().mean()):.2f} list entries per warp; "
               f"B2's warp gate leaves {int(b2.sum())} (per warp "
               f"{dist(b2)}): the per-lane test "
               f"{100 * need / max(int(b2.sum()), 1):.1f}% of them; B2's "
               f"bound per warp {b2_bound[0]:.4f} ms")
    return bound(n_bytes, n_ops), summary


def b5_walk_main(root: str) -> int:
    """``--b5-walk DIR``: B5's times alone, on the package of the checkout
    at DIR: kernel, query and (an earlier B5's) ``prepare`` on the 40k
    animated scene's binned camera, bounce and shadow wavefronts of the
    middle and the lower strip, with that checkout's B2 kernel beside them,
    then the 40k render through MI_STREAM_KERNEL=v3."""
    import torch
    card, mi, v3, obj, sa, waves = checkout_40k(root, "intersect_v3",
                                                lower=True)
    v4 = importlib.import_module("mitsuba3dopplertof_tpu_torch.ops."
                                 "intersect_v4")
    v4.LIBRARY.load()
    for line in v4.LIBRARY.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {v4.LIBRARY.name}: {line.strip()}", flush=True)
    tag = f"B5 at {os.path.basename(os.path.abspath(root).rstrip(os.sep))}"
    tables = v4.v4_tables(sa)
    for wname, any_hit, ray in waves:
        ray_s, _ = sort_wavefront(sa, ray)
        b2_ms = cuda_time_ms(lambda: v4.launch(tables, ray_s, any_hit))
        print(b5_line(tag, wname, any_hit,
                      b5_times(v3, v4, sa, ray_s, any_hit),
                      ray_s.o.x.shape[0], card,
                      f"; B2's kernel {b2_ms:.4f} ms"), flush=True)
        del ray_s
    img, _, first_s, warm_s, counts = render_40k(
        mi, obj, "v3", v3.reset_launch_counts,
        lambda: dict(v3.LAUNCHES_BY_FORM))
    if not bool(torch.isfinite(img).all()) or min(counts.values()) <= 0:
        fail(f"{tag}: the 40k render did not run through B5")
    print(f"{tag} render 40k animated 256x256x256 (MI_STREAM_KERNEL=v3): "
          f"first {first_s:.3f} s, warm {warm_s:.3f} s = "
          f"{256 ** 3 / warm_s / 1e6:.3f} Msamples/s; launches "
          f"{counts} ({card})", flush=True)
    return 0


def render_40k(mi, obj, route, reset, read):
    """The 40k animated scene at 256x256 x 256 spp through
    MI_STREAM_KERNEL=``route``, twice, with ``reset()`` just before the
    first render and ``read()`` just after it: (image, second image,
    first s, warm s, what ``read`` returned)."""
    import torch
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import \
        animated_mesh_scene
    os.environ["MI_STREAM_KERNEL"] = route
    try:
        scene = mi.load_dict(animated_mesh_scene(obj, spp=256))
        reset()
        t0 = time.perf_counter()
        img = mi.render(scene, spp=256, seed=0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read()
        t0 = time.perf_counter()
        img2 = mi.render(scene, spp=256, seed=0)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        os.environ.pop("MI_STREAM_KERNEL", None)
    return img, img2, first_s, warm_s, counts


def b6_walk_main(root: str) -> int:
    """``--b6-walk DIR``: B6's times alone, on the package of the checkout
    at DIR: kernel and query on the 40k animated scene's binned camera,
    bounce and shadow wavefronts, then the 40k render through
    MI_STREAM_KERNEL=mxu."""
    import torch
    card, mi, mxu, obj, sa, waves = checkout_40k(root, "intersect_mxu")
    tag = f"B6 at {os.path.basename(os.path.abspath(root).rstrip(os.sep))}"
    for wname, any_hit, ray in waves:
        ray_s, _ = sort_wavefront(sa, ray)
        k_ms, q_ms = b6_times(mxu, sa, ray_s, any_hit)
        print(f"{tag} {wname} wavefront "
              f"({'any-hit' if any_hit else 'closest-hit'}, binned, "
              f"{ray_s.o.x.shape[0]} lanes, 40k animated): kernel "
              f"{k_ms:.4f} ms, query {q_ms:.4f} ms ({card})", flush=True)
        del ray_s
    img, _, first_s, warm_s, counts = render_40k(
        mi, obj, "mxu", mxu.reset_launch_counts,
        lambda: dict(mxu.LAUNCHES_BY_FORM))
    if not bool(torch.isfinite(img).all()) or min(counts.values()) <= 0:
        fail(f"{tag}: the 40k render did not run through B6")
    print(f"{tag} render 40k animated 256x256x256 (MI_STREAM_KERNEL=mxu): "
          f"first {first_s:.3f} s, warm {warm_s:.3f} s = "
          f"{256 ** 3 / warm_s / 1e6:.3f} Msamples/s; launches "
          f"{counts} ({card})", flush=True)
    return 0


def b3_walk_main(root: str) -> int:
    """``--b3-walk DIR``: B3's times alone, on the package of the checkout
    at DIR: kernel and query on the 40k animated scene's binned camera,
    bounce and shadow wavefronts of the middle and the lower strip, then
    the 40k render through MI_STREAM_KERNEL=v1."""
    import torch
    card, mi, stream, obj, sa, waves = checkout_40k(root, "intersect_stream",
                                                    lower=True)
    tag = f"B3 at {os.path.basename(os.path.abspath(root).rstrip(os.sep))}"
    for wname, any_hit, ray in waves:
        ray_s, _ = sort_wavefront(sa, ray)
        k_ms, q_ms = b3_times(stream, sa, ray_s, any_hit)
        print(f"{tag} {wname} wavefront "
              f"({'any-hit' if any_hit else 'closest-hit'}, binned, "
              f"{ray_s.o.x.shape[0]} lanes, 40k animated): kernel "
              f"{k_ms:.4f} ms, query {q_ms:.4f} ms ({card})", flush=True)
        del ray_s
    img, _, first_s, warm_s, counts = render_40k(
        mi, obj, "v1", stream.reset_launch_counts,
        lambda: dict(stream.LAUNCHES_BY_FORM))
    if not bool(torch.isfinite(img).all()) or min(counts.values()) <= 0:
        fail(f"{tag}: the 40k render did not run through B3")
    print(f"{tag} render 40k animated 256x256x256 (MI_STREAM_KERNEL=v1): "
          f"first {first_s:.3f} s, warm {warm_s:.3f} s = "
          f"{256 ** 3 / warm_s / 1e6:.3f} Msamples/s; launches "
          f"{counts} ({card})", flush=True)
    return 0


def b4_walk_main(root: str) -> int:
    """``--b4-walk DIR``: B4's times alone, on the package of the checkout
    at DIR: kernel, query and lists (the kernel's lists alone, or an
    earlier B4's ``prepare``) on the 40k animated scene's binned camera,
    bounce and shadow wavefronts of the middle and the lower strip, then
    the 40k render through MI_STREAM_KERNEL=v2."""
    import torch
    card, mi, v2, obj, sa, waves = checkout_40k(root, "intersect_v2",
                                                lower=True)
    tag = f"B4 at {os.path.basename(os.path.abspath(root).rstrip(os.sep))}"
    for wname, any_hit, ray in waves:
        ray_s, _ = sort_wavefront(sa, ray)
        print(b4_line(tag, wname, any_hit, b4_times(v2, sa, ray_s, any_hit),
                      ray_s.o.x.shape[0], card), flush=True)
        del ray_s
    img, _, first_s, warm_s, counts = render_40k(
        mi, obj, "v2", v2.reset_launch_counts,
        lambda: dict(v2.LAUNCHES_BY_FORM))
    if not bool(torch.isfinite(img).all()) or min(counts.values()) <= 0:
        fail(f"{tag}: the 40k render did not run through B4")
    print(f"{tag} render 40k animated 256x256x256 (MI_STREAM_KERNEL=v2): "
          f"first {first_s:.3f} s, warm {warm_s:.3f} s = "
          f"{256 ** 3 / warm_s / 1e6:.3f} Msamples/s; launches "
          f"{counts} ({card})", flush=True)
    return 0


def b6_chunk_t(mxu, tables, x, time):
    """(lanes, n_chunks): each lane's smallest t that B6's exact test
    accepts in each chunk (+inf: none), by the plain version's arithmetic
    (``_affine_hit``, with no best so far)."""
    import torch
    from mitsuba3dopplertof_tpu_torch.ops.intersect_stream import _unit_ray
    T = mxu.T
    inf = torch.full((x.shape[1], 1), float("inf"), device=x.device)
    out = []
    for ci, c0, c1 in tables.runs:
        r = _unit_ray(tables, ci, (x[0], x[1], x[2]), (x[4], x[5], x[6]),
                      time)
        xp = [c[:, None] for c in (*r[:3], x[3], *r[3:], x[7])]
        for a in range(c0, c1, 4):
            b = min(a + 4, c1)
            w = tables.w[a * 8:b * 8].reshape(b - a, 8, 6, T).permute(
                1, 2, 0, 3).reshape(8, 6, 1, (b - a) * T)
            out.append(mxu._affine_hit(w, xp, inf).reshape(
                -1, b - a, T).amin(dim=2))
    return torch.cat(out, dim=1)


def b6_gate_share(mxu, sa, ray_s, walk, n_lanes=1 << 16):
    """What B6's gate passes to the exact test, by its plain version
    ``mxu_gate_reference``, on the first ``n_lanes`` of a binned
    wavefront: over the pairs (each lane of a warp, each triangle of a
    chunk) of the chunks that the warp's walk tests
    (``WalkWork.b6_warps``), with each lane's best t at the chunk's start
    as the kernel has it: the smallest exact t (``b6_chunk_t``) of the
    chunks before it in its block's list; any-hit, a lane with a hit
    before the chunk is occluded and its pairs go nowhere. Returns
    (pairs passed, pairs tested)."""
    import torch
    from mitsuba3dopplertof_tpu_torch.core.vec import Vec3
    from mitsuba3dopplertof_tpu_torch.render.types import Ray
    cut = lambda v: v[:n_lanes].contiguous()
    ray = Ray(Vec3(*map(cut, ray_s.o)), Vec3(*map(cut, ray_s.d)),
              cut(ray_s.time), cut(ray_s.maxt))
    tables = mxu.mxu_tables(sa)
    x, t, order, _ = mxu.prepare(tables, ray)
    n_chunks = tables.n_chunks
    ordl = order.long().repeat_interleave(WalkWork.BLOCK, dim=0)
    by_rank = b6_chunk_t(mxu, tables, x, t).gather(1, ordl)
    start = torch.cat([torch.full_like(by_rank[:, :1], float("inf")),
                       by_rank[:, :-1]], dim=1).cummin(dim=1).values
    best = torch.empty_like(start).scatter_(1, ordl, start)
    if walk.any_hit:
        best = torch.where(torch.isinf(best), float("inf"), float("-inf"))
    _, tested, ow, _ = walk.b6_warps()
    nwl = n_lanes // 32
    tested_c = torch.zeros((nwl, n_chunks), dtype=torch.bool,
                           device=x.device).scatter_(1, ow[:nwl],
                                                     tested[:nwl])
    lane_t = tested_c.repeat_interleave(32, dim=0)
    passed = 0
    for c0 in range(0, n_chunks, 4):
        c1 = min(c0 + 4, n_chunks)
        g = mxu.mxu_gate_reference(tables, x, t, c0, c1, best[:, c0:c1])
        passed += int((g.reshape(n_lanes, c1 - c0, mxu.T).sum(dim=2)
                       * lane_t[:, c0:c1]).sum())
    return passed, int(lane_t.sum()) * mxu.T


def b6_bytes(n_lanes, distinct, reach):
    """Bytes B6 must move: per lane X, time and the result; each chunk a
    walk needs once (its W); per entry of a block's list that its warps
    reach, the entry, the chunk's meta and its four boxes."""
    return n_lanes * (36 + 8) + distinct * 8 * 768 * 4 + reach * (8 + 8
                                                                 + 4 * 24)


def b6_bounds(pairs, ray_ops, n_bytes):
    """B6's two bounds for a walk that tests ``pairs`` pairs of lane and
    triangle: on the CUDA cores (a Woop test a pair in float32) and with
    the product on the tensor cores (the larger of the bytes, the
    product's flops at the TF32 rate and the epilogue's float32
    operations). Each a (bound_ms, bound_by)."""
    cuda_cores = bound(n_bytes, pairs * WOOP_OPS + ray_ops)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(pairs * MXU_PRODUCT_FLOPS / TF32_OPS_PER_S,
                (pairs * WOOP_EPILOGUE_OPS + ray_ops) / F32_OPS_PER_S) * 1e3
    tensor = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                          "operations")
    return cuda_cores, tensor


def sass_count(lib, opcode: str) -> int:
    """Instructions of ``opcode`` in a built library's SASS (cuobjdump
    --dump-sass, from the CUDA toolkit of nvcc)."""
    from mitsuba3dopplertof_tpu_torch.ops.cuda_build import nvcc
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", str(lib.path())],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return sum(1 for line in out.splitlines()
               if line.strip().startswith("/*") and f" {opcode}" in line)


def b1_wavefronts(scene, ik, dev, n):
    """The canonical scene's wavefronts of one strip pass (``n`` lanes from
    the middle of the frame, 1024 lanes a pixel in pixel order), drawn
    from its correlated sampler as the render draws them: the camera rays,
    the depth-1 shadow rays toward light samples, the depth-2 bounce rays
    (cosine-weighted; a lane whose camera ray missed keeps it, as in the
    render) and the depth-2 shadow rays from their hits. Hits come from
    the plain version."""
    import torch
    from mitsuba3dopplertof_tpu_torch import emitters as em
    from mitsuba3dopplertof_tpu_torch.core.vec import where3
    from mitsuba3dopplertof_tpu_torch.core.warp import cosine_hemisphere_c
    from mitsuba3dopplertof_tpu_torch.render.scene import build_si
    from mitsuba3dopplertof_tpu_torch.render.types import Ray
    from mitsuba3dopplertof_tpu_torch.samplers import TIME_ANTITHETIC
    from mitsuba3dopplertof_tpu_torch.sensors import sample_ray_kind
    sa = scene.compile()
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
    cam, _ = sample_ray_kind(
        sensor.device_params(), None, tcam,
        ((pix % W).float() + off[0]) * (1.0 / W),
        ((pix // W).float() + off[1]) * (1.0 / H))
    si = build_si(sa, cam, ik.intersect_reference(sa, cam))
    (ux, uy), st = sampler.next_2d(st, None)
    ds, _ = em.sample_direction(sa, si.p, cam.time, ux, uy)
    shadow = si.spawn_ray_to(ds.p)
    (bx, by), st = sampler.next_2d(st, None)
    b = si.spawn_ray(si.to_world(cosine_hemisphere_c(bx, by)))
    bounce = Ray(where3(si.valid, b.o, cam.o), where3(si.valid, b.d, cam.d),
                 cam.time, b.maxt)
    si2 = build_si(sa, bounce, ik.intersect_reference(sa, bounce))
    (ux, uy), st = sampler.next_2d(st, None)
    ds2, _ = em.sample_direction(sa, si2.p, bounce.time, ux, uy)
    return sa, {"camera": cam, "shadow": shadow, "bounce": bounce,
                "shadow2": si2.spawn_ray_to(ds2.p)}


# B1's timed wavefronts: name, label, any-hit
B1_WAVEFRONTS = (("camera", "camera", False), ("bounce", "bounce (depth 2)",
                                                False),
                 ("shadow", "shadow (depth 1)", True),
                 ("shadow2", "shadow (depth 2)", True))


def b1_work(ik, sa, ray, any_hit):
    """What B1's gated walk must do on one wavefront, per 32-lane warp,
    from the gate's plain version (``b1_warp_masks``) and the exact tests'
    acceptance (``slot_hits``): the slots it tests (a round of 32 whose
    mask passes three quarters or more, whole), the instances it inverts
    and the boxes it slab-tests. The any-hit walk stops after the slot
    where the warp's last live lane finds its first hit (in a dense round,
    after the round). Returns the per-warp slots tested and the float32
    operations of the whole wavefront."""
    import torch
    m = ik.b1_warp_masks(sa, ray)
    n = ray.o.x.shape[0]
    n_w = m.slots.shape[0]
    ns, nt = sa.n_static_tris, sa.n_static_tris + sa.n_anim_tris
    ranges = m.ranges
    # a round of 32 slots whose mask passes three quarters or more is
    # tested whole
    slots = m.slots.clone()
    rounds = [(c, min(c + 32, ns)) for c in range(0, ns, 32)]
    dense = []
    for c0, c1 in rounds:
        dense.append(m.slots[:, c0:c1].sum(1) * 4 >= 3 * (c1 - c0))
        slots[:, c0:c1] |= dense[-1][:, None]
    first_slot = torch.tensor([ns + start for _, start, _ in sa.anim_ranges],
                              device=slots.device)
    if any_hit:
        hits = ik.slot_hits(sa, ray)
        pos = torch.arange(hits.shape[1], device=hits.device)
        big = hits.shape[1]
        first = torch.where(hits, pos, big).amin(1)
        live = ray.maxt > 0.0
        first = torch.where(live, first, -1)
        first = torch.cat([first, first.new_full((n_w * 32 - n,), -1)])
        stop = first.reshape(n_w, 32).amax(1)
        # a dense round, and an instance's triangles, vote once at the end
        ends = rounds + [(ns + st + c, ns + st + min(c + 32, count))
                         for _, st, count in sa.anim_ranges
                         for c in range(0, count, 32)]
        for i, (c0, c1) in enumerate(ends):
            whole = dense[i] if i < len(rounds) else True
            stop = torch.where(whole & (stop >= c0) & (stop < c1), c1 - 1,
                               stop)
        slots = slots & (pos[None, :] <= stop[:, None])
        ranges = ranges & (first_slot[None, :] <= stop[:, None])
    tests = (slots[:, :nt].sum(1) * MOLLER_OPS
             + slots[:, nt:].sum(1) * SPHERE_OPS
             + ranges.sum(1) * INV_LERP_OPS)
    n_boxes = ns + len(sa.anim_ranges) + sa.n_spheres
    ops = 32 * (tests + B1_GATE_LANE_OPS) + B1_SLAB_OPS * n_boxes * m.culls
    return slots.sum(1), float(ops.sum())


def kernel_ms(fn, name: str, reps: int = 50) -> float:
    """Device ms of one launch of the kernel whose name holds ``name``: the
    mean over ``reps`` calls of ``fn`` under torch.profiler, after 10.
    For kernels shorter than the wrapper's host time per call, where CUDA
    events around a series of calls time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if name in e.key]
    count = sum(e.count for e in evs)
    if count < reps // 2:     # the profiler may drop an event or two
        fail(f"profiled {count} launches of {name} in {reps} calls")
    return sum(e.self_device_time_total for e in evs) / count / 1e3


def b1_time(ik, sa, ray, any_hit):
    """Device ms of one B1 launch on ``ray``, by the wrapper's call as the
    main path makes it."""
    fn = ik.ray_test if any_hit else ik.intersect
    return kernel_ms(lambda: fn(sa, ray), "intersect_kernel")


def b1_walk_main(root: str) -> int:
    """``--b1-walk DIR``: B1's times alone, on the package of the checkout
    at DIR (another commit, to compare with this one on one card in one
    call): the canonical scene's camera, bounce and shadow wavefronts, as
    the full run builds them."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    root = os.path.abspath(root)
    if not os.path.isdir(os.path.join(root, "mitsuba3dopplertof_tpu_torch")):
        fail(f"{root} holds no mitsuba3dopplertof_tpu_torch/")
    sys.path.insert(0, root)
    card = card_line()
    print(card, flush=True)
    import mitsuba3dopplertof_tpu_torch as mi
    from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as ik
    if not ik.__file__.startswith(root):
        fail(f"imported {ik.__file__}, not the package under {root}")
    ik.LIBRARY.load()
    for line in ik.LIBRARY.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {ik.LIBRARY.name}: {line.strip()}", flush=True)
    mi.set_variant("cuda_rgb")
    sa, waves = b1_wavefronts(mi.load_file(CANONICAL), ik,
                              torch.device("cuda"), WAVEFRONT)
    tag = f"B1 at {os.path.basename(root.rstrip(os.sep)) or root}"
    for name, label, any_hit in B1_WAVEFRONTS:
        print(f"{tag} {label} wavefront "
              f"({'any-hit' if any_hit else 'closest-hit'}, "
              f"{waves[name].o.x.shape[0]} lanes): kernel "
              f"{b1_time(ik, sa, waves[name], any_hit):.4f} ms ({card})",
              flush=True)
    return 0


def check_lists(mod, tables, n_items, tag, ray, cap=None, what="units"):
    """A kernel's visit lists (``mod.lists``: B2's over its units, B4's
    over its chunks) against those of ``mod.prepare`` (``_unit_visit_order``,
    ``_visit_order``) on the same rays: order and t_lo bit for bit, and the
    count of reachable items per block. Returns the largest count and the
    most rounds a block took."""
    import torch
    order_k, tlo_k, len_k = mod.lists(tables, ray, cap)
    order_r, tlo_r = mod.prepare(tables, ray)[4:]
    len_r = (tlo_r < 3.0e38).sum(dim=1, dtype=torch.int32)
    n_ord = int((order_k != order_r).sum())
    n_tlo = int((tlo_k.view(torch.int32) != tlo_r.view(torch.int32)).sum())
    n_len = int((len_k != len_r).sum())
    top = int(len_r.max())
    c = cap or min(n_items, 4096)
    print(f"lists {tag}: {order_r.shape[0]} blocks x {n_items} {what}, "
          f"capacity {c}: reachable per block mean "
          f"{float(len_r.float().mean()):.1f}, max {top} "
          f"({-(-top // c)} rounds); order differs on {n_ord}, t_lo bits "
          f"on {n_tlo}, length on {n_len} blocks", flush=True)
    if n_ord or n_tlo or n_len:
        fail(f"lists {tag}: the kernel's visit lists differ from "
             f"{mod.prepare.__module__.split('.')[-1]}.prepare's")
    return top, -(-top // c)


class WalkWork:
    """What walks of one binned wavefront's visit lists must test: per
    kernel the units, quarters or chunks whose gate passes, computed in
    PyTorch from the lists each kernel's ``prepare`` builds and from the
    plain version's result, the same whatever implements the walk.

    Closest-hit: a walk over a sorted list tests exactly the entries whose
    t_lo is at most the block's final bound (the warp's, for B2, B3 and
    B6, whose warps walk alone; the bound never grows, and a hit found in a
    unit is no nearer than the unit's t_lo), so the final bound from the
    plain version's t decides. Any-hit: the bound before rank v is the
    largest maxt among the lanes that no earlier unit occludes, from each
    lane's first rank with a hit; the hit sets come from one dense pass of
    B2's plain version (every kernel agrees with it on every lane's
    occlusion in the parity phase), B3's from its own Möller test
    (``stream_chunk_hits``)."""

    BLOCK = 256
    BIG = 3.0e38
    CAP = 1.0e37

    def __init__(self, sa, ray_s, t_ref, any_hit, t_b3=None, t_b4=None):
        import torch
        from mitsuba3dopplertof_tpu_torch.ops import intersect_mxu as mxu
        from mitsuba3dopplertof_tpu_torch.ops import intersect_stream as st
        from mitsuba3dopplertof_tpu_torch.ops import intersect_v2 as v2
        from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as v4
        self.torch = torch
        self.any_hit = any_hit
        self._b2 = self._b3 = self._b4 = self._b5 = self._b6 = None
        n = ray_s.o.x.shape[0]
        if n % self.BLOCK:
            raise ValueError("WalkWork: whole blocks only")
        self.n, self.nb = n, n // self.BLOCK
        tb4 = v4.v4_tables(sa)
        self.n_units = tb4.n_units
        self.o4, self.d4, _, maxtp, self.order32, self.tlo32 = v4.prepare(
            tb4, ray_s)
        self.key32 = self._unsort(self.order32, self.tlo32)
        self.tb2 = v2.v2_tables(sa)
        self.prep2 = v2.prepare(self.tb2, ray_s)
        self.order128, self.tlo128 = self.prep2[4:]
        tb6 = mxu.mxu_tables(sa)
        x, _, self.order128r, self.tlo128r = mxu.prepare(tb6, ray_s)
        self.sub6 = tb6.sub
        self.x, self.box, self.maxtp, self.t_ref = x, tb4.box, maxtp, t_ref
        self.st, self.tb3 = st, st.stream_tables(sa)
        self.prep3 = st.prepare(self.tb3, ray_s)
        self.t_b3 = t_ref if t_b3 is None else t_b3
        self.t_b4 = t_ref if t_b4 is None else t_b4
        if any_hit:
            hits = torch.zeros((n, tb4.n_units), dtype=torch.bool,
                               device=maxtp.device)
            v4.intersect_v4_reference(sa, ray_s, unit_hits=hits)
            self.hits = hits
        else:
            # the ordered walks' final bound
            self.bound = torch.clamp(self._blockmax(
                torch.minimum(t_ref, maxtp)), max=self.CAP)

    def _blockmax(self, v):
        return v.reshape(self.nb, self.BLOCK).amax(dim=1)

    def _unsort(self, order, key):
        out = self.torch.empty_like(key)
        out.scatter_(1, order.long(), key)
        return out

    def _first_rank(self, order, per_chunk, hits=None):
        """Per lane the first rank of ``order`` with a hit (its length:
        none). ``per_chunk``: the list is over groups of units (B4's and
        B6's 128-triangle chunks, B3's groups). ``hits``: (lanes, units)
        hit sets in place of B2's."""
        torch = self.torch
        n_list = order.shape[1]
        rank = torch.empty_like(order)
        rank.scatter_(1, order.long(), torch.arange(
            n_list, dtype=order.dtype, device=order.device).expand_as(order))
        out = torch.empty((self.n,), dtype=torch.int64, device=order.device)
        step = 64
        for b0 in range(0, self.nb, step):
            sl = slice(b0 * self.BLOCK, (b0 + step) * self.BLOCK)
            h = (self.hits if hits is None else hits)[sl]
            if per_chunk:
                h = h.reshape(h.shape[0], n_list, -1).any(dim=2)
            r = rank[b0:b0 + step].repeat_interleave(self.BLOCK, dim=0)
            out[sl] = torch.where(h, r, n_list).amin(dim=1)
        return out

    def far_ends(self, order, per_chunk):
        """(n_blocks, n_list) far end of a whole block's walk before each
        rank: the unoccluded lanes' own (clamped) maxt (the per-block walks
        of ``block_units`` and of B4's per-block bound)."""
        torch = self.torch
        n_list = order.shape[1]
        if not self.any_hit:
            return self.bound[:, None].expand(self.nb, n_list)
        first = self._first_rank(order, per_chunk)
        a = torch.full((self.nb, n_list + 1), -self.BIG,
                       device=self.maxtp.device)
        a.scatter_reduce_(1, first.reshape(self.nb, self.BLOCK),
                          self.maxtp.reshape(self.nb, self.BLOCK),
                          reduce="amax")
        return torch.clamp(a.flip(1).cummax(dim=1).values.flip(1)
                           [:, :n_list], max=self.CAP)

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

    def _slab_lohi(self, blk, box=None, live_only=False, x=None):
        """(t_lo, t_hi), (groups, boxes): the slab test of each group of
        ``blk`` lanes' ray bounds against each box of ``box`` (default: the
        unit boxes) with no far end (``_slab_visit_order``'s algebra;
        csrc/intersect_v4.cu's warp gate with blk = 32). ``live_only``: the
        bounds of the live lanes (maxt > 0) alone, as
        csrc/intersect_mxu.cu takes them. ``x``: (8, N) ray rows in place
        of B6's (``self.x``, whose maxt is not clamped)."""
        torch = self.torch
        box = self.box if box is None else box
        x = self.x if x is None else x
        blo, bhi = box[:, :3], box[:, 3:]
        ng = x.shape[1] // blk
        xb = x.reshape(8, ng, blk)
        if live_only:
            live = xb[7:8] > 0.0
            inf = float("inf")
            ol = torch.where(live, xb[0:3], inf).amin(dim=2).T
            oh = torch.where(live, xb[0:3], -inf).amax(dim=2).T
            dl = torch.where(live, xb[4:7], inf).amin(dim=2).T
            dh = torch.where(live, xb[4:7], -inf).amax(dim=2).T
        else:
            ol, oh = xb[0:3].amin(dim=2).T, xb[0:3].amax(dim=2).T
            dl, dh = xb[4:7].amin(dim=2).T, xb[4:7].amax(dim=2).T
        t_lo = torch.zeros((ng, box.shape[0]), device=x.device)
        t_hi = torch.full((ng, box.shape[0]), self.BIG, device=x.device)
        for ax in range(3):
            dla, dha = dl[:, ax:ax + 1], dh[:, ax:ax + 1]
            same = (dla > 1e-12) | (dha < -1e-12)
            ivs = (1.0 / torch.where(same, dla, 1.0),
                   1.0 / torch.where(same, dha, 1.0))
            lo = torch.full_like(t_lo, self.BIG)
            hi = torch.full_like(t_lo, -self.BIG)
            for p in (blo[None, :, ax], bhi[None, :, ax]):
                for oo in (ol[:, ax:ax + 1], oh[:, ax:ax + 1]):
                    for iv in ivs:
                        val = (p - oo) * iv
                        lo = torch.minimum(lo, val)
                        hi = torch.maximum(hi, val)
            t_lo = torch.maximum(t_lo, torch.where(same, lo, -self.BIG))
            t_hi = torch.minimum(t_hi, torch.where(same, hi, self.BIG))
        return t_lo, t_hi

    def b2_warps(self):
        if self._b2 is None:
            self._b2 = self._b2_warps()
        return self._b2

    def _b2_warps(self):
        """The units csrc/intersect_v4.cu's walk must test per 32-lane warp:
        entries of its CTA's sorted list up to the first whose t_lo exceeds
        the warp's far end, less those whose box the warp's own rays cannot
        enter within it (the warp gate). Far ends as ``far_ends``, over the
        warp's lanes. Returns (units per warp, (warps, n_units) tested)."""
        torch = self.torch
        wl = 32
        k = self.BLOCK // wl
        nw = self.n // wl
        t_lo_w, t_hi_w = self._slab_lohi(wl)
        ow = self.order32.long().repeat_interleave(k, dim=0)
        glo, ghi = t_lo_w.gather(1, ow), t_hi_w.gather(1, ow)
        del t_lo_w, t_hi_w
        tw = self.tlo32.repeat_interleave(k, dim=0)
        if self.any_hit:
            first = self._first_rank(self.order32, False)
            a = torch.full((nw, self.n_units + 1), -self.BIG,
                           device=tw.device)
            a.scatter_reduce_(1, first.reshape(nw, wl),
                              self.maxtp.reshape(nw, wl), reduce="amax")
            g = torch.clamp(a.flip(1).cummax(dim=1).values.flip(1)
                            [:, :self.n_units], max=self.CAP)
        else:
            g = torch.clamp(torch.minimum(self.t_ref, self.maxtp).reshape(
                nw, wl).amax(dim=1), max=self.CAP)[:, None]
        tested = self._prefix(tw, g) & (glo <= torch.minimum(ghi, g))
        return tested.sum(dim=1), tested, ow

    def b6_warps(self):
        if self._b6 is None:
            self._b6 = self._b6_warps()
        return self._b6

    def _b6_warps(self):
        """The chunks csrc/intersect_mxu.cu's walk must test per 32-lane
        warp: the entries of its block's chunk list up to the first whose
        t_lo exceeds the warp's own far end (or is unreachable), less
        those none of whose four 32-triangle boxes the warp's live rays can
        enter within it (the kernel's slab test). Far ends: closest-hit the
        largest over the warp's lanes of min(final t, maxt); any-hit the
        largest maxt of the warp's lanes that no earlier entry occludes
        (-3e38 once all are). Returns (entries tested per warp, (warps,
        n_chunks) tested by rank, (warps, n_chunks) chunk at each rank,
        (blocks,) entries of its list each block reads: its warps' longest
        prefix)."""
        torch = self.torch
        wl = 32
        k = self.BLOCK // wl
        nw = self.n // wl
        n_list = self.order128r.shape[1]
        t_lo_w, t_hi_w = self._slab_lohi(wl, self.sub6, live_only=True)
        ow = self.order128r.long().repeat_interleave(k, dim=0)
        idx = ow[:, :, None].expand(-1, -1, 4)
        glo = t_lo_w.reshape(nw, n_list, 4).gather(1, idx)
        ghi = t_hi_w.reshape(nw, n_list, 4).gather(1, idx)
        del t_lo_w, t_hi_w, idx
        tw = self.tlo128r.repeat_interleave(k, dim=0)
        maxt = self.x[7]
        if self.any_hit:
            first = self._first_rank(self.order128r, True)
            a = torch.full((nw, n_list + 1), -self.BIG, device=tw.device)
            a.scatter_reduce_(1, first.reshape(nw, wl),
                              maxt.reshape(nw, wl), reduce="amax")
            g = torch.clamp(a.flip(1).cummax(dim=1).values.flip(1)
                            [:, :n_list], max=self.BIG)
        else:
            g = torch.clamp(torch.minimum(self.t_ref, maxt).reshape(
                nw, wl).amax(dim=1), max=self.BIG)[:, None]
        reach = self._prefix(tw, g)
        tested = reach & (glo <= torch.minimum(ghi, g[:, :, None])).any(
            dim=2)
        per_block = reach.sum(dim=1).reshape(self.nb, k).amax(dim=1)
        return tested.sum(dim=1), tested, ow, per_block

    def b3_warps(self):
        if self._b3 is None:
            self._b3 = self._b3_warps()
        return self._b3

    def _b3_warps(self):
        """The chunks csrc/intersect_stream.cu's walk must test per 32-lane
        warp: the entries of its block's group list (the groups whose boxes
        the block's live rays can enter within their largest maxt, by entry
        distance, ties by group) up to the first whose t_lo exceeds the
        warp's far end, then the chunks of those entries whose boxes the
        warp's live rays can enter within it. Far ends: closest-hit the
        largest over the warp's live lanes of min(final t, maxt) (``t_b3``,
        B3's plain t, or else ``t_ref``), any-hit the largest maxt of its
        live lanes that no earlier entry occludes (B3's own hit sets),
        capped at 3e38 (-3e38 where none). The slab tests are the
        kernel's (``_slab_lohi`` of the live lanes, inverted boxes never
        entered). Returns (chunks per warp, (warps, n_chunks)
        tested, (warps, n_groups) far end before each rank, (warps,)
        entries each warp reaches, (blocks,) entries of each block's
        list)."""
        torch = self.torch
        tb = self.tb3
        wl = 32
        k = self.BLOCK // wl
        nw = self.n // wl
        n_groups = tb.n_chunks // 8
        maxt = self.x[7]
        live = maxt > 0.0
        lo_b, hi_b = self._slab_lohi(self.BLOCK, tb.grp, live_only=True)
        far_b = torch.where(live, maxt, -self.BIG).reshape(
            self.nb, self.BLOCK).amax(dim=1)
        far_b = torch.where(far_b > 0.0, torch.clamp(far_b, max=self.BIG),
                            -self.BIG)[:, None]
        ok = (lo_b <= torch.minimum(hi_b, far_b)) & (tb.grp[:, 0]
                                                     <= tb.grp[:, 3])
        key = torch.where(ok, lo_b, self.BIG)
        del lo_b, hi_b, ok
        tlo, order = key.sort(dim=1, stable=True)
        if self.any_hit:
            hits = self.st.stream_chunk_hits(tb, self.prep3)
            first = self._first_rank(order.to(torch.int32), True, hits)
            del hits
            a = torch.full((nw, n_groups + 1), -self.BIG, device=maxt.device)
            a.scatter_reduce_(1, first.reshape(nw, wl), torch.where(
                live, maxt, -self.BIG).reshape(nw, wl), reduce="amax")
            g = torch.clamp(a.flip(1).cummax(dim=1).values.flip(1)
                            [:, :n_groups], max=self.BIG)
        else:
            g = torch.clamp(torch.where(
                live, torch.minimum(self.t_b3, maxt), -self.BIG).reshape(
                    nw, wl).amax(dim=1), max=self.BIG)[:, None].expand(
                        nw, n_groups)
        reach = self._prefix(tlo.repeat_interleave(k, dim=0), g)
        lo_w, hi_w = self._slab_lohi(wl, tb.aabb, live_only=True)
        idx = (order.repeat_interleave(k, dim=0)[:, :, None] * 8
               + torch.arange(8, device=maxt.device)).reshape(nw, -1)
        clo = lo_w.gather(1, idx).reshape(nw, n_groups, 8)
        chi = hi_w.gather(1, idx).reshape(nw, n_groups, 8)
        del lo_w, hi_w
        run = (reach[:, :, None] & (clo <= torch.minimum(chi, g[:, :, None]))
               & (tb.aabb[:, 0] <= tb.aabb[:, 3])[idx].reshape(nw, n_groups,
                                                               8))
        tested = torch.zeros((nw, tb.n_chunks), dtype=torch.bool,
                             device=maxt.device).scatter_(
                                 1, idx, run.reshape(nw, -1))
        return (run.sum(dim=(1, 2)), tested, g, reach.sum(dim=1),
                (tlo < self.BIG).sum(dim=1))

    def b4_warps(self):
        if self._b4 is None:
            self._b4 = self._b4_warps()
        return self._b4

    def _b4_warps(self):
        """The quarters csrc/intersect_v2.cu's walks must test per 32-lane
        warp: the entries of its block's chunk list (``prepare``'s, which
        the kernel's rounds take in the same order) up to the first whose
        t_lo exceeds the warp's far end, then the quarters of those
        entries whose boxes the warp's live rays can enter within it.
        Far ends: closest-hit the largest over the warp's live lanes of
        min(final t, clamped maxt) (``t_b4``, B4's plain t, or else
        ``t_ref``), any-hit the largest clamped maxt of its
        live lanes that no earlier entry occludes (B4's own Möller hit
        sets, ``stream_chunk_hits`` over the same rows with the clamped
        maxt), capped at 1e37 (-3e38 where none). The slab tests are the
        kernel's (``_slab_lohi`` of the live lanes, inverted boxes never
        entered). Returns (quarters per warp, (warps, 4 n_chunks) tested,
        (warps, n_chunks) far end before each rank, (warps,) entries each
        warp reaches)."""
        torch = self.torch
        tb = self.tb2
        wl = 32
        k = self.BLOCK // wl
        nw = self.n // wl
        o, d, time, maxt = self.prep2[:4]
        order, n_list = self.order128, self.tb2.n_chunks
        live = maxt > 0.0
        if self.any_hit:
            hits = self.st.stream_chunk_hits(
                self.tb3, (o, d, time, maxt))[:, :4 * n_list]
            first = self._first_rank(order, True, hits)
            del hits
            a = torch.full((nw, n_list + 1), -self.BIG, device=maxt.device)
            a.scatter_reduce_(1, first.reshape(nw, wl), torch.where(
                live, maxt, -self.BIG).reshape(nw, wl), reduce="amax")
            g = torch.clamp(a.flip(1).cummax(dim=1).values.flip(1)
                            [:, :n_list], max=self.CAP)
        else:
            g = torch.clamp(torch.where(
                live, torch.minimum(self.t_b4, maxt), -self.BIG).reshape(
                    nw, wl).amax(dim=1), max=self.CAP)[:, None].expand(
                        nw, n_list)
        reach = self._prefix(self.tlo128.repeat_interleave(k, dim=0), g)
        x = torch.stack(list(o) + [torch.ones_like(maxt)] + list(d) + [maxt])
        lo_w, hi_w = self._slab_lohi(wl, tb.sub, live_only=True, x=x)
        idx = (order.long().repeat_interleave(k, dim=0)[:, :, None] * 4
               + torch.arange(4, device=maxt.device)).reshape(nw, -1)
        qlo = lo_w.gather(1, idx).reshape(nw, n_list, 4)
        qhi = hi_w.gather(1, idx).reshape(nw, n_list, 4)
        del lo_w, hi_w
        run = (reach[:, :, None] & (qlo <= torch.minimum(qhi, g[:, :, None]))
               & (tb.sub[:, 0] <= tb.sub[:, 3])[idx].reshape(nw, n_list, 4))
        tested = torch.zeros((nw, 4 * n_list), dtype=torch.bool,
                             device=maxt.device).scatter_(
                                 1, idx, run.reshape(nw, -1))
        return run.sum(dim=(1, 2)), tested, g, reach.sum(dim=1)

    def b5_warps(self):
        if self._b5 is None:
            self._b5 = self._b5_warps()
        return self._b5

    def _b5_warps(self):
        """The units csrc/intersect_v3.cu's walks must test per 32-lane
        warp: the entries of its block's unit list (``prepare``'s, the
        kernel's order) up to the first whose t_lo exceeds the warp's far
        end, less those whose box no live lane's own ray can enter within
        the lane's own far end (the kernel's per-lane test,
        ``intersect_v3.lane_box_test``). Lane far ends: closest-hit
        min(final t, clamped maxt) (``t_ref``, B2's plain t; torch.fmin, as
        the kernel's fminf), any-hit the clamped maxt up to the rank of the
        lane's first hit (B2's dense hit sets) and none after; a warp's far
        end before a rank is the largest of its lanes' there, capped at
        1e37 (-3e38 where none). Returns (units per warp, (warps, n_units)
        tested, (f, last): the lanes' far ends as ``v3_walk_reference``
        takes them, (warps,) list entries each warp reaches)."""
        torch = self.torch
        from mitsuba3dopplertof_tpu_torch.ops.intersect_v3 import \
            lane_box_test
        wl = 32
        k = self.BLOCK // wl
        nw = self.n // wl
        n_list = self.n_units
        maxt = self.maxtp
        dev = maxt.device
        if self.any_hit:
            f = maxt
            last = self._first_rank(self.order32, False)
        else:
            f = torch.fmin(self.t_ref, maxt)
            last = torch.full((self.n,), n_list, dtype=torch.int64,
                              device=dev)
        term = torch.where(torch.isnan(f), -float("inf"), f)
        a = torch.full((nw, n_list + 1), -self.BIG, device=dev)
        a.scatter_reduce_(1, last.reshape(nw, wl), term.reshape(nw, wl),
                          reduce="amax")
        g = torch.clamp(a.flip(1).cummax(dim=1).values.flip(1)[:, :n_list],
                        max=self.CAP)
        reach = self._prefix(self.tlo32.repeat_interleave(k, dim=0), g)
        live = maxt > 0.0
        inv = tuple(1.0 / c for c in self.d4)
        tested_r = torch.zeros_like(reach)
        step = 64                    # blocks at a time
        for b0 in range(0, self.nb, step):
            b1 = min(b0 + step, self.nb)
            nbk = b1 - b0
            r_max = int(reach[b0 * k:b1 * k].sum(dim=1).max())
            if r_max == 0:
                continue
            sl = slice(b0 * self.BLOCK, b1 * self.BLOCK)
            lane = lambda v: v[sl].reshape(nbk, self.BLOCK, 1)
            box = self.box[self.order32[b0:b1, :r_max].long()][:, None]
            rank = torch.arange(r_max, device=dev)
            far = torch.where(rank <= lane(last), lane(f), -float("inf"))
            ok = lane(live) & lane_box_test(
                tuple(lane(c) for c in self.o4), tuple(lane(c) for c in inv),
                box, far)
            tested_r[b0 * k:b1 * k, :r_max] = ok.reshape(
                nbk, k, wl, r_max).any(dim=2).reshape(nbk * k, r_max)
        tested_r &= reach
        ow = self.order32.long().repeat_interleave(k, dim=0)
        tested = torch.zeros((nw, n_list), dtype=torch.bool,
                             device=dev).scatter_(1, ow, tested_r)
        return tested_r.sum(dim=1), tested, (f, last), reach.sum(dim=1)

    def list_ops(self):
        """Operations of B2's and B5's lists: a slab test per block and
        unit, and n log2 n compares to sort each block's reachable
        units."""
        torch = self.torch
        m = (self.tlo32 < self.BIG).sum(dim=1).double()
        sort_ops = float((m * torch.log2(torch.clamp(m, min=2.0))).sum())
        return self.nb * self.n_units * SLAB_OPS + sort_ops

    def b2_work(self):
        """(units tested over all warps, distinct units, operations of the
        lists: ``list_ops``)."""
        torch = self.torch
        per_warp, tested, ow = self.b2_warps()
        seen = torch.zeros((self.n_units,), dtype=torch.bool,
                           device=tested.device)
        seen[ow[tested]] = True
        return int(per_warp.sum()), int(seen.sum()), self.list_ops()

    def b2_distribution(self):
        """Units a walk needs per 256-lane block (the parent kernel's
        granularity) and per 32-lane warp (the kernel's): for each, mean,
        p99, max and the share of all tested units that fall in the
        slowest 1% of blocks or warps."""
        torch = self.torch
        g = self.far_ends(self.order32, False)
        per_block = self._prefix(self.tlo32, g).sum(dim=1).double()
        per_warp = self.b2_warps()[0].double()
        out = []
        for v in (per_block, per_warp):
            top = v.sort(descending=True).values[:max(1, -(-v.numel()
                                                          // 100))]
            out.append((float(v.mean()), float(torch.quantile(v, 0.99)),
                        float(v.max()), float(top.sum() / max(float(
                            v.sum()), 1.0))))
        return out

    def block_units(self):
        """Units that walks of whole 256-lane blocks' lists need (each
        block on its own final far end, no gate): summed over the blocks."""
        return int(self._prefix(self.tlo32, self.far_ends(self.order32,
                                                          False)).sum())

    def work(self, row):
        """(entries tested over all blocks or warps, distinct records read,
        label of an entry) for kernel ``row`` (B2's: ``b2_work``, B5's:
        ``b5_warps``)."""
        torch = self.torch
        if row == "B4":
            g = self.far_ends(self.order128, True)
            vis = self._prefix(self.tlo128, g)
            q = self._quarters(self.order128, self.key32, g) \
                & vis[:, :, None]
            return (int(q.sum()), self._distinct(
                self.order128, q.any(dim=2), self.order128.shape[1]),
                "quarters")
        if row == "B6":
            per_warp, tested, ow, _ = self.b6_warps()
            seen = torch.zeros((self.order128r.shape[1],), dtype=torch.bool,
                               device=tested.device)
            seen[ow[tested]] = True
            return int(per_warp.sum()), int(seen.sum()), "chunks"
        if row == "B3":
            per_warp, tested = self.b3_warps()[:2]
            return (int(per_warp.sum()), int(tested.any(dim=0).sum()),
                    "chunks")
        raise KeyError(row)


def canonical_dict(mi, sampler=None, rfilter=None, sensor=None, **params):
    """scenes/canonical/scene.xml as a scene dict (``params`` override its
    defaults spp, resx, resy), with its sampler, its film's filter or its
    sensor replaced by the given plugin dicts."""
    d = mi.xml_to_dict(CANONICAL, {k: str(v) for k, v in params.items()},
                       is_file=True)
    key = next(k for k, v in d.items()
               if isinstance(v, dict) and v.get("type") == "perspective")
    cam = dict(d[key])
    for k, v in list(cam.items()):
        if not isinstance(v, dict):
            continue
        if sampler is not None and v.get("type") == "correlated":
            cam[k] = dict(sampler, sample_count=v["sample_count"])
        elif rfilter is not None and v.get("type") == "hdrfilm":
            cam[k] = {fk: (dict(rfilter) if isinstance(fv, dict) else fv)
                      for fk, fv in v.items()}
    d[key] = cam if sensor is None else sensor(cam)
    return d


def batch_sensor(cam: dict) -> dict:
    """A batch sensor over the canonical camera: a thin lens, an
    orthographic and a distant sensor looking down the box, and the
    perspective camera itself, side by side on a film four times as wide."""
    import numpy as np
    film = next(v for v in cam.values()
                if isinstance(v, dict) and v.get("type") == "hdrfilm")
    sampler = next(v for v in cam.values()
                   if isinstance(v, dict) and v.get("type") == "correlated")
    child_film = dict(film)
    ortho = np.array(cam["to_world"], dtype=np.float64)
    ortho[:3, :3] = ortho[:3, :3] * 1.1
    plain = {k: v for k, v in cam.items() if not isinstance(v, dict)}
    return {"type": "batch", "shutter_open": cam["shutter_open"],
            "shutter_close": cam["shutter_close"],
            "film": dict(film, width=4 * film["width"]),
            "sampler": dict(sampler),
            "lens": dict(plain, type="thinlens", aperture_radius=0.08,
                         focus_distance=4.5, film=dict(child_film)),
            "ortho": {"type": "orthographic", "to_world": ortho,
                      "film": dict(child_film)},
            "distant": {"type": "distant", "direction": [0.0, 0.0, -1.0],
                        "film": dict(child_film)},
            "pinhole": dict(plain, film=dict(child_film))}


def doppler_core_phase(mi, obj40, obj2k, reset, read, card, res=256,
                       spp_small=1024, spp_large=256) -> None:
    """Phase 9: the velocity and depth integrators, the timestratified
    sampler, the thin lens and the mitchell filter at the main path's
    sizes (``res`` x ``res`` at ``spp_small`` spp on the canonical scene,
    ``spp_large`` on the 40k one); the new samplers, sensors and filters on
    the card against the CPU; a timed-out render and checkpoint resumes on
    the card."""
    import numpy as np
    import tempfile
    import torch
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import \
        animated_mesh_scene
    t_phase = time.perf_counter()

    def twice(tag, load, spp, integ, forms, kernel):
        """Render twice (counts read around the first), time the second;
        ``forms``: the forms of ``kernel`` that must be launched (the
        others must not be)."""
        scene = load()
        kw = {} if integ is None else {"integrator": mi.load_dict(integ)}
        reset()
        t0 = time.perf_counter()
        img = mi.render(scene, spp=spp, seed=0, **kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read()[kernel]
        t0 = time.perf_counter()
        img2 = mi.render(scene, spp=spp, seed=0, **kw)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        w, h = img.shape[1], img.shape[0]
        if tuple(img.shape) != (res, res, 3):
            fail(f"{tag}: image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()) or not bool(
                (img != 0).any()):
            fail(f"{tag}: image not finite or all zero")
        for form, count in counts.items():
            if (count > 0) != (form in forms):
                fail(f"{tag} launched {kernel} {form} {count} times")
        print(f"render {tag} {w}x{h}x{spp}: first {first_s:.3f} s, warm "
              f"{warm_s:.3f} s = {w * h * spp / warm_s / 1e6:.3f} "
              f"Msamples/s ({card}); launches {kernel} {counts}; image "
              f"mean {float(img.mean()):.6g}, max |v| "
              f"{float(img.abs().max()):.6g}", flush=True)
        if not torch.equal(img, img2):
            print("note: two renders differ (max "
                  f"{float((img - img2).abs().max()):.3g})", flush=True)

    closest = ("closest_hit",)
    both = ("closest_hit", "any_hit")
    velocity = {"type": "velocity", "time": 0.0015}
    canon = lambda: mi.load_file(CANONICAL, spp=spp_small, resx=res,
                                 resy=res)
    mesh40 = lambda d=None: mi.load_dict(
        d or animated_mesh_scene(obj40, spp=spp_large, res=res))
    twice("canonical velocity through B1", canon, spp_small, velocity,
          closest, "B1")
    twice("canonical depth through B1", canon, spp_small, {"type": "depth"},
          closest, "B1")
    twice("40k animated velocity through B2", mesh40, spp_large, velocity,
          closest, "B2")
    twice("40k animated depth through B2", mesh40, spp_large,
          {"type": "depth"}, closest, "B2")
    twice("canonical dopplertofpath timestratified through B1",
          lambda: mi.load_dict(canonical_dict(
              mi, sampler={"type": "timestratified"}, spp=spp_small,
              resx=res, resy=res)), spp_small, None, both, "B1")
    d40 = animated_mesh_scene(obj40, spp=spp_large, res=res)
    d40["sensor"] = dict(d40["sensor"], type="thinlens",
                         aperture_radius=0.05, focus_distance=4.0,
                         film=dict(d40["sensor"]["film"],
                                   rfilter={"type": "mitchell"}))
    twice("40k animated dopplertofpath thinlens + mitchell through B2",
          lambda: mesh40(d40), spp_large, None, both, "B2")

    # card against CPU at 16x16 x 16 spp, phase 8's criteria
    small = dict(spp=16, resx=16, resy=16)
    cases = [("canonical velocity", lambda dv: mi.load_file(
                  CANONICAL, device=dv, **small), velocity),
             ("canonical depth", lambda dv: mi.load_file(
                  CANONICAL, device=dv, **small), {"type": "depth"}),
             ("2k animated velocity", lambda dv: mi.load_dict(
                  animated_mesh_scene(obj2k, spp=16, res=16), device=dv),
              velocity),
             ("2k animated depth", lambda dv: mi.load_dict(
                  animated_mesh_scene(obj2k, spp=16, res=16), device=dv),
              {"type": "depth"})]
    for kind in ("timestratified", "stratified", "multijitter", "ldsampler",
                 "orthogonal"):
        cases.append((f"canonical dopplertofpath {kind}",
                      lambda dv, k=kind: mi.load_dict(canonical_dict(
                          mi, sampler={"type": k}, **small), device=dv),
                      None))
    cases.append(("canonical dopplertofpath batch(thinlens, orthographic, "
                  "distant, perspective)",
                  lambda dv: mi.load_dict(canonical_dict(
                      mi, sensor=batch_sensor, **small), device=dv), None))
    for kind in ("lanczos", "catmullrom"):
        cases.append((f"canonical dopplertofpath {kind}",
                      lambda dv, k=kind: mi.load_dict(canonical_dict(
                          mi, rfilter={"type": k}, **small), device=dv),
                      None))
    for label, load, integ in cases:
        out = []
        for dv in (None, "cpu"):
            kw = {} if integ is None else {
                "integrator": mi.load_dict(integ, device=dv)}
            out.append(mi.render(load(dv), spp=16, seed=0,
                                 **kw).cpu().numpy())
        ig, ic = out
        scale = float(np.abs(ic).max())
        close = np.isclose(ig, ic, rtol=1e-4, atol=1e-4 * scale)
        rel_mean = abs(ig.mean() - ic.mean()) / max(abs(ic.mean()), 1e-30)
        print(f"cuda vs cpu {label} {ig.shape[1]}x{ig.shape[0]}x16: "
              f"{close.mean() * 100:.2f}% of values within tolerance, mean "
              f"rel diff {rel_mean:.3g}, max abs diff "
              f"{float(np.abs(ig - ic).max()):.3g} (scale {scale:.3g})",
              flush=True)
        if (close.mean() < 0.99 or rel_mean > 1e-3 or scale <= 0.0
                or not np.isfinite(ig).all()):
            fail(f"cuda vs cpu {label}: outside tolerance")

    # a timed-out render, and checkpoint resumes in both kinds of passes:
    # 64x64 x 64 spp in four passes of 16 spp, or of 16 pixel rows
    mid = dict(spp=64, resx=64, resy=64)
    timed = mi.load_file(CANONICAL, **mid)
    timed.integrator.timeout = 1e-9
    timed.integrator.samples_per_pass = 16
    img = mi.render(timed, spp=64, seed=0)
    if not bool(torch.isfinite(img).all()) or not bool((img != 0).any()):
        fail("the timed-out render is not finite or all zero")
    print(f"timed-out render canonical 64x64x64 (timeout 1e-9 s, 16 spp a "
          f"pass): finite, mean {float(img.mean()):.6g}", flush=True)
    for mode, setup, kw in (("spp-sliced", {"samples_per_pass": 16}, {}),
                            ("strip", {}, {"max_lanes": 64 * 64 * 16})):
        def scene_with():
            sc = mi.load_file(CANONICAL, **mid)
            for k, v in setup.items():
                setattr(sc.integrator, k, v)
            return sc
        full = scene_with()
        full = full.integrator.render(full, spp=64, seed=0, **kw)
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck.npz")
            sc = scene_with()
            integ = sc.integrator
            calls = []

            def stop_at_second(start, integ=integ, calls=calls):
                calls.append(start)
                if len(calls) == 2:
                    integ.cancel()
                return type(integ).should_stop(integ, start)
            integ.should_stop = stop_at_second
            integ.render(sc, spp=64, seed=0, checkpoint_path=ck,
                         checkpoint_every=1, **kw)
            with np.load(ck) as f:
                stopped_at = int(f["pass_idx"])
            sc = scene_with()
            resumed = sc.integrator.render(sc, spp=64, seed=0,
                                           checkpoint_path=ck, **kw)
        same = torch.equal(resumed, full)
        print(f"checkpoint resume canonical 64x64x64 ({mode}, 4 passes, "
              f"stopped after {stopped_at}): resumed == uninterrupted bit "
              f"for bit: {same}", flush=True)
        if stopped_at != 2 or not same:
            fail(f"checkpoint resume ({mode}) differs from the "
                 "uninterrupted render")
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)


# the hero scene (phase 10): utils/hero_scene.py at its full width
HERO_RES = 256
HERO_SPP = 64                   # dopplertofpath's render
HERO_ANCHOR_SPP = 512           # QUALITY_HERO_ref.npz's spp per pass
HERO_VOLPATH = {"type": "volpath", "max_depth": 6}
HERO_VOLPATH_BUDGET_S = 60.0    # volpath's first + warm render at most
HERO_ANCHOR = os.path.join(ROOT, "QUALITY_HERO_ref.npz")


def down2(img):
    """2x2 box average (scripts/hero_quality.py's pyramid step)."""
    h, w = img.shape[:2]
    return img[:h - h % 2, :w - w % 2].reshape(
        h // 2, 2, w // 2, 2, -1).mean(axis=(1, 3))


def half_mean_table() -> dict:
    """QUALITY_HERO.md's half-mean RMSE per pyramid level, as a fraction
    of the anchor's level-0 signal RMS."""
    import re
    out = {}
    with open(os.path.join(ROOT, "QUALITY_HERO.md")) as f:
        for line in f:
            m = re.match(r"\|\s*(\d)\s*\|\s*\d+x\d+\s*\|\s*([\d.]+)%", line)
            if m:
                out[int(m.group(1))] = float(m.group(2)) / 100.0
    if sorted(out) != list(range(6)):
        fail(f"QUALITY_HERO.md: half-mean table unreadable ({out})")
    return out


def hero_phase(mi, reset, read, card, res=HERO_RES, spp=HERO_SPP,
               anchor_spp=HERO_ANCHOR_SPP) -> dict:
    """Phase 10: the hero scene (utils/hero_scene.py) with the port's own
    assets: dopplertofpath at ``res`` x ``res`` x ``spp`` and volpath
    (max_depth 6) at the largest of 64, 32 and 16 spp that fits
    HERO_VOLPATH_BUDGET_S, each twice (launches read around the first,
    the second timed); B2 against its plain version on the hero's camera
    and shadow wavefronts, with its times and bound; the card against the
    CPU on the mini hero at 16x16 x 16 spp (both integrators, and
    dopplertofpath through MI_STREAM_KERNEL=v3), the lanes that meet a
    tie or graze an edge left out of both films; and the card's 2-seed
    mean at ``anchor_spp`` against QUALITY_HERO_ref.npz. Returns what the
    kernel line's hero entries need."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as v4
    from mitsuba3dopplertof_tpu_torch.ops.ray_binning import binned
    from mitsuba3dopplertof_tpu_torch.utils.hero_scene import (
        hero_assets, hero_scene_dict)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="hero_")
    try:
        t0 = time.perf_counter()
        hero_assets(tmp)
        print(f"hero assets (knot, sphere, marble and sky EXRs, smoke .vol) "
              f"written by the port: {time.perf_counter() - t0:.2f} s",
              flush=True)

        def load(spp_, integ=None, device=None, r=res, assets=tmp):
            return mi.load_dict(hero_scene_dict(
                res=r, spp=spp_, cache_dir=assets,
                integrator=None if integ is None else dict(integ)),
                device=device)

        def twice(tag, spp_, integ):
            scene = load(spp_, integ)
            reset()
            t0 = time.perf_counter()
            img = mi.render(scene, spp=spp_, seed=0)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = read()
            t0 = time.perf_counter()
            img2 = mi.render(scene, spp=spp_, seed=0)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            if tuple(img.shape) != (res, res, 3):
                fail(f"hero {tag}: image shape {tuple(img.shape)}")
            if not bool(torch.isfinite(img).all()) or not bool(
                    (img != 0).any()):
                fail(f"hero {tag}: image not finite or all zero")
            b2 = counts["B2"]
            others = {row: c for row, c in counts.items()
                      if row not in ("B1", "B2") and sum(c.values())}
            # volpath's shadow rays walk the smoke's null boundaries by
            # closest hits: it launches no any-hit query
            want_any = integ is None
            if (b2["closest_hit"] <= 0 or (b2["any_hit"] > 0) != want_any
                    or others):
                fail(f"hero {tag}: launches {counts}")
            print(f"render hero {tag} {res}x{res}x{spp_}: first "
                  f"{first_s:.3f} s, warm {warm_s:.3f} s = "
                  f"{res * res * spp_ / warm_s / 1e6:.3f} Msamples/s "
                  f"({card}); launches B2 {b2}, B1 {counts['B1']}; image "
                  f"mean {float(img.mean()):.6g}, max |v| "
                  f"{float(img.abs().max()):.6g}", flush=True)
            if not torch.equal(img, img2):
                print("note: two renders differ (max "
                      f"{float((img - img2).abs().max()):.3g})", flush=True)
            return b2

        launches = {"dopplertofpath": twice("dopplertofpath", spp, None)}
        # volpath: a 16 spp probe sets the spp that fits the budget
        probe = load(16, HERO_VOLPATH)
        t0 = time.perf_counter()
        mi.render(probe, spp=16, seed=0)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
        vol_spp = next((s for s in (64, 32, 16) if 2.0 * probe_s * s / 16
                        <= HERO_VOLPATH_BUDGET_S), 16)
        print(f"volpath probe {res}x{res}x16: {probe_s:.3f} s; volpath at "
              f"{vol_spp} spp, the largest of 64, 32, 16 whose first and "
              f"warm renders fit {HERO_VOLPATH_BUDGET_S:.0f} s", flush=True)
        launches["volpath"] = twice(f"volpath (max_depth 6, {vol_spp} spp)",
                                    vol_spp, HERO_VOLPATH)

        # B2 on the hero's wavefronts: the camera rays of one strip pass
        # from the middle of the frame (closest-hit) and their shadow rays
        # toward emitter samples, the lamp and the sky (any-hit): against
        # the plain version over binned rays, then timed with its bound
        t_step = time.perf_counter()
        sc = load(spp)
        sa = sc.compile()
        waves, n_valid = strip_waves(sc, sa, MIDDLE_ROW, seed=7)
        print(f"hero: {sa.n_static_tris + sa.n_anim_tris} triangles, "
              f"{v4.v4_tables(sa).n_units} units; camera wavefront "
              f"{WAVEFRONT} lanes, {n_valid} hit", flush=True)
        errs = {"closest_hit": 0.0, "any_hit": 0.0}
        times = {}
        n_anim = len(sa.anim_ranges)
        for wname, any_hit, ray in waves:
            if wname == "bounce":
                continue
            form = "any_hit" if any_hit else "closest_hit"
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t_r, p_r = v4.intersect_v4_reference(sa, ray)
            e1.record()
            torch.cuda.synchronize()
            plain_ms = e0.elapsed_time(e1)
            t_k, p_k = binned(sa, ray, None, lambda r, a=any_hit: list(
                v4.intersect_v4(sa, r, any_hit=a)))
            torch.cuda.synchronize()
            check_t_prim(f"B2 hero {wname} binned "
                         f"{'any-hit' if any_hit else 'closest-hit'}",
                         t_k, p_k, t_r, p_r, any_hit, errs)
            ray_s, pos = sort_wavefront(sa, ray)
            t_ref = torch.empty_like(t_r)
            t_ref[pos] = t_r
            walk = WalkWork(sa, ray_s, t_ref, any_hit)
            k_ms, q_ms, _, _ = b2_times(v4, sa, ray_s, any_hit)
            n_lanes = ray_s.o.x.shape[0]
            b_bound, need, distinct, _ = b2_walk_bound(
                walk, n_lanes * n_anim * INV_LERP_OPS)
            times[form] = (k_ms, plain_ms, b_bound)
            print(f"B2 time hero {wname} ({form.replace('_', '-')}, "
                  f"binned): kernel {k_ms:.4f} ms, query {q_ms:.4f} ms, "
                  f"plain {plain_ms:.3f} ms; a walk needs {need} units over "
                  f"{n_lanes // 32} warps ({distinct} distinct); bound "
                  f"{b_bound[0]:.4f} ms ({b_bound[1]}) ({card})", flush=True)
            del t_r, p_r, t_k, p_k, walk
        del sc, sa, waves
        print(f"B2 on the hero's wavefronts: {time.perf_counter() - t_step:.1f}"
              " s", flush=True)
        t_step = time.perf_counter()

        # card against CPU at 16x16 x 16 spp, on the mini hero: the hero
        # with a 192-triangle knot and a 96-triangle sphere (312 triangles
        # in all, through B2 on the card; every plugin kept), whose CPU
        # renders take seconds where the full hero's dense CPU scans take
        # minutes (tests/test_torch_cuda.py renders it the same way). The
        # smoke cube's bottom face
        # lies in the floor's plane: rays through it meet both at one t,
        # and the last bits of t decide, which differ between the card
        # (Woop, CUDA's rsqrt, sin, exp) and the CPU (Möller); so do rays
        # that graze a wall's edge. The CPU render marks those lanes
        # (tests/torch_ties.TieRecorder: a rival hit within 2^-20 of t, or
        # an edge within 2^-17 in barycentrics, on any query). Phase 8's
        # measures of the whole images are printed; phase 8's criteria
        # (>= 99% of values within rtol 1e-4, atol 1e-4 * max|cpu|, mean
        # within 1e-3 relative) must hold for the images with the marked
        # lanes left out of both films, and the marked lanes must be at
        # most 10% of the lanes.
        from mitsuba3dopplertof_tpu_torch.utils import hero_scene as hs
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from torch_ties import TieRecorder
        mini = os.path.join(tmp, "mini")
        os.makedirs(mini)
        hs._knot_obj(os.path.join(mini, "knot.obj"), nu=12, nv=8)
        hs._icosphere_obj(os.path.join(mini, "sphere.obj"), nu=8, nv=6)
        hero_assets(mini)
        small = lambda integ, device: load(16, integ, device, 16, mini)
        cpu = {}
        for label, integ, env in (
                ("dopplertofpath", None, {}),
                ("volpath", HERO_VOLPATH, {}),
                ("dopplertofpath through B5 (MI_STREAM_KERNEL=v3)", None,
                 {"MI_STREAM_KERNEL": "v3"})):
            key = "volpath" if integ else "dopplertofpath"
            if key not in cpu:
                rec = TieRecorder(16 * 16 * 16, "cpu")
                with rec.hooked():
                    whole = mi.render(small(integ, "cpu"), spp=16,
                                      seed=0).numpy()
                with rec.dropped():
                    kept = mi.render(small(integ, "cpu"), spp=16,
                                     seed=0).numpy()
                cpu[key] = (rec, whole, kept)
            rec, whole_c, kept_c = cpu[key]
            os.environ.update(env)
            try:
                whole_g = mi.render(small(integ, None), spp=16,
                                    seed=0).cpu().numpy()
                reset()
                with rec.dropped():
                    kept_g = mi.render(small(integ, None), spp=16,
                                       seed=0).cpu().numpy()
                counts = read()
            finally:
                for k in env:
                    os.environ.pop(k, None)
            row = "B5" if env else "B2"
            if counts[row]["closest_hit"] <= 0:
                fail(f"mini hero card vs cpu {label}: launches {counts}")

            def measure(ig, ic):
                scale = float(np.abs(ic).max())
                close = np.isclose(ig, ic, rtol=1e-4, atol=1e-4 * scale)
                rel_mean = (abs(ig.mean() - ic.mean())
                            / max(abs(ic.mean()), 1e-30))
                return scale, close.mean(), rel_mean, float(
                    np.abs(ig - ic).max())

            sw, cw, mw, dw = measure(whole_g, whole_c)
            sk, ck, mk, dk = measure(kept_g, kept_c)
            n_marked = int(rec.marked.sum())
            print(f"cuda vs cpu mini hero {label} 16x16x16: whole images "
                  f"{cw * 100:.2f}% of values within tolerance, mean rel "
                  f"diff {mw:.3g}, max abs diff {dw:.3g} (scale {sw:.3g}); "
                  f"{n_marked} of 4096 lanes marked (ties, grazed edges); "
                  f"without them {ck * 100:.2f}% within tolerance, mean "
                  f"rel diff {mk:.3g}, max abs diff {dk:.3g} (scale "
                  f"{sk:.3g})", flush=True)
            if (ck < 0.99 or mk > 1e-3 or sk <= 0.0 or n_marked > 409
                    or not np.isfinite(whole_g).all()):
                fail(f"cuda vs cpu mini hero {label}: outside tolerance")

        print(f"card vs cpu, mini hero: {time.perf_counter() - t_step:.1f} "
              "s", flush=True)

        # the anchor: QUALITY_HERO_ref.npz, the mean of K passes of
        # ``anchor_spp`` spp at seeds 0..K-1 (scripts/hero_quality.py),
        # against the card's mean of seeds 0 and 1 at box-downsampled
        # pyramid levels 3-5, RMSE over the anchor's level-0 signal RMS.
        # Limit: 3x the Monte Carlo error of a 2-pass mean against the
        # K-pass mean, taken as independent (the card's seeds 0 and 1
        # repeat two of the anchor's passes, which only lowers the error),
        # plus the anchor's float16 rounding (half a float16 ulp, RMS).
        # QUALITY_HERO.md's half-means are K/2-pass means: their difference
        # has 4/K of one pass's variance, so one pass's error is the
        # table's value times sqrt(K)/2.
        with np.load(HERO_ANCHOR) as f:
            ref16, K = f["mean"], int(f["K"])
            if int(f["spp"]) != anchor_spp:
                fail(f"anchor spp {int(f['spp'])} != {anchor_spp}")
        ref = ref16.astype(np.float32)
        table = half_mean_table()
        scene = load(anchor_spp)
        t0 = time.perf_counter()
        mean2 = sum(mi.render(scene, spp=anchor_spp, seed=s).cpu().numpy()
                    for s in (0, 1)) / 2.0
        anchor_s = time.perf_counter() - t0
        sig0 = float(np.sqrt(np.mean(ref ** 2)))
        f16 = float(np.sqrt(np.mean((np.spacing(np.abs(ref16))
                                     .astype(np.float32) / 2) ** 2))) / sig0
        a, b = mean2, ref
        for lvl in range(6):
            if lvl >= 3:
                err = float(np.sqrt(np.mean((a - b) ** 2))) / sig0
                expected = table[lvl] * math.sqrt(K) / 2 * math.sqrt(
                    1.0 / 2 + 1.0 / K)
                limit = 3.0 * expected + f16
                print(f"hero anchor level {lvl} ({a.shape[0]}x"
                      f"{a.shape[1]}): RMSE {100 * err:.3f}% of the "
                      f"level-0 signal RMS {sig0:.5g}; limit "
                      f"{100 * limit:.3f}% = 3 x {100 * expected:.3f}% "
                      f"(2-pass vs {K}-pass mean, from QUALITY_HERO.md's "
                      f"{100 * table[lvl]:.2f}%) + {100 * f16:.3f}% "
                      f"(float16)", flush=True)
                if not err <= limit:
                    fail(f"hero anchor level {lvl}: {err:.4g} > {limit:.4g}")
            if lvl < 5:
                a, b = down2(a), down2(b)
        print(f"hero anchor renders {res}x{res}x{anchor_spp}, seeds 0 and "
              f"1: {anchor_s:.3f} s ({card})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": launches, "times": times, "errs": errs}


def hero_entries(hero: dict) -> list:
    """The kernel line's entries of B2 on the hero: its launches in the
    dopplertofpath render (and in the volpath render, an extra key), its
    times on the hero's wavefronts and their bound."""
    out = []
    for form in ("closest_hit", "any_hit"):
        k_ms, p_ms, (b_ms, b_by) = hero["times"][form]
        out.append({
            "name": f"intersect_v4 on the hero ({form.replace('_', '-')})",
            "route": "cuda", "source": B2_SOURCE, "replaces": B2_TPU,
            "launches": hero["launches"]["dopplertofpath"][form],
            "launches_volpath": hero["launches"]["volpath"][form],
            "max_abs_err": hero["errs"][form], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return out


# the scene dialect (phase 11): the JAX package's deep-path benchmark row
# (utils/bench_scenes.py) and the glass scene
DIALECT_RES = 256
DEEP_SPP = 256
GLASS_SPP = 256
GLASS_PROFILE_SPP = 16          # one strip pass of the glass scene


def glass_dict(ply: str, spp: int, res: int, tf=None, anim_cls=None) -> dict:
    """The glass scene, built here (not a published scene): the animated
    mesh scene of utils/bench_scenes.py (its camera, shutter, correlated
    sampler, floor and dopplertofpath, at max_depth 6) with its sphere
    read from the PLY file ``ply`` into a shapegroup and placed by an
    instance with the mesh's animated to_world; a GGX roughdielectric
    sphere (alpha 0.1, bk7); a Beckmann roughconductor floor (Al, alpha_u
    0.05, alpha_v 0.3); a thindielectric pane; a disk under mask (opacity
    0.6) over diffuse; a cylinder under blendbsdf (weight 0.3) of
    dielectric and conductor Au; a sphere area light (radius 0.3, radiance
    20), a spot (cutoff 25 degrees), a directional light and a constant sky
    of 0.05. ``tf``/``anim_cls``: the transform module and
    AnimatedTransform class of the package that loads the dict (default:
    the port's)."""
    from mitsuba3dopplertof_tpu_torch.core import transform as port_tf
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import \
        animated_mesh_scene
    tf = tf or port_tf
    base = animated_mesh_scene(ply, spp, res, tf, anim_cls)

    def rgb(v):
        return {"type": "rgb", "value": v}
    return {
        "type": "scene",
        "group": {"type": "shapegroup",
                  "mesh": {"type": "ply", "filename": ply,
                           "bsdf": {"type": "roughdielectric",
                                    "distribution": "ggx", "alpha": 0.1,
                                    "int_ior": "bk7"}}},
        "glass": {"type": "instance", "group": {"type": "ref",
                                                "id": "group"},
                  "to_world": base["mesh"]["to_world"]},
        "floor": {**base["floor"],
                  "bsdf": {"type": "roughconductor",
                           "distribution": "beckmann", "material": "Al",
                           "alpha_u": 0.05, "alpha_v": 0.3}},
        "pane": {"type": "rectangle",
                 "to_world": tf.translate([-1.9, -0.2, 0.9])
                 @ tf.rotate([0, 1, 0], 35) @ tf.scale([0.7, 0.9, 1]),
                 "bsdf": {"type": "thindielectric", "int_ior": 1.5}},
        "disk": {"type": "disk",
                 "to_world": tf.translate([1.8, -0.5, 0.6])
                 @ tf.rotate([0, 1, 0], -30) @ tf.scale([0.6] * 3),
                 "bsdf": {"type": "mask", "opacity": 0.6,
                          "bsdf": {"type": "diffuse",
                                   "reflectance": rgb([0.8, 0.3, 0.2])}}},
        "can": {"type": "cylinder",
                "to_world": tf.translate([1.2, -1.15, 2.0])
                @ tf.rotate([1, 0, 0], -90) @ tf.scale([0.4, 0.4, 1.1]),
                "bsdf": {"type": "blendbsdf", "weight": 0.3,
                         "a": {"type": "dielectric", "int_ior": 1.33},
                         "b": {"type": "conductor", "material": "Au"}}},
        "lamp": {"type": "sphere", "center": [0.0, 2.4, 0.5],
                 "radius": 0.3,
                 "emitter": {"type": "area", "radiance": rgb(20.0)}},
        "spot": {"type": "spot", "cutoff_angle": 25.0,
                 "to_world": tf.look_at([-2.5, 3.0, -2.5], [0, -0.5, 0],
                                        [0, 1, 0]),
                 "intensity": rgb(30.0)},
        "sun": {"type": "directional", "direction": [0.3, -1.0, 0.5],
                "irradiance": rgb(1.5)},
        "sky": {"type": "constant", "radiance": rgb(0.05)},
        "sensor": base["sensor"],
        "integrator": {**base["integrator"], "max_depth": 6},
    }


def dialect_phase(mi, reset, read, card) -> dict:
    """Phase 11: the scene dialect's surfaces and lights on the card. The
    deep-path row (scripts/bench_suite.py:118-139, B1 with its sphere
    light) and the glass scene (the 40k UV sphere written as a PLY, in a
    shapegroup placed by an animated instance: B2, and B1's sphere pass),
    each rendered twice at 256x256 x 256 spp (launches read around the
    first, the second timed), the glass scene's idle share from one
    profiled warm strip pass (utils/profile_render.device_breakdown); then
    the card against the CPU at 16x16 x 16 spp with phase 8's criteria,
    the lanes that meet a tie or graze an edge (tests/torch_ties.py) left
    out of both films: the deep-path scene, and the glass scene with the 2k
    sphere through B2 and through MI_STREAM_KERNEL=v3, whose image must be
    B2's within phase 7's tolerance. Returns the launches of the two
    renders by kernel row."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
        ANIMATED_SIZES, deep_path_scene, write_uv_sphere_ply)
    from mitsuba3dopplertof_tpu_torch.utils.profile_render import \
        device_breakdown
    res = DIALECT_RES
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dialect_")
    try:
        plys = {}
        for size in ("40k", "2k"):
            nu, nv = ANIMATED_SIZES[size]
            plys[size] = os.path.join(tmp, f"sphere_{nu}x{nv}.ply")
            write_uv_sphere_ply(plys[size], nu, nv)

        def deep(spp, device=None, r=res):
            return mi.load_dict(deep_path_scene(spp, r), device=device)

        def glass(spp, device=None, r=res, size="40k"):
            return mi.load_dict(glass_dict(plys[size], spp, r),
                                device=device)

        def twice(tag, scene, spp, rows):
            reset()
            t0 = time.perf_counter()
            img = mi.render(scene, spp=spp, seed=0)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = read()
            t0 = time.perf_counter()
            img2 = mi.render(scene, spp=spp, seed=0)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            if tuple(img.shape) != (res, res, 3):
                fail(f"{tag}: image shape {tuple(img.shape)}")
            if not bool(torch.isfinite(img).all()) or not bool(
                    (img != 0).any()):
                fail(f"{tag}: image not finite or all zero")
            for row, c in counts.items():
                want = row in rows
                if any((n > 0) != want for n in c.values()):
                    fail(f"{tag}: launches {counts}")
            print(f"render {tag} {res}x{res}x{spp}: first {first_s:.3f} s, "
                  f"warm {warm_s:.3f} s = "
                  f"{res * res * spp / warm_s / 1e6:.3f} Msamples/s "
                  f"({card}); launches " + ", ".join(
                      f"{row} {counts[row]}" for row in rows)
                  + f"; image mean {float(img.mean()):.6g}, max |v| "
                  f"{float(img.abs().max()):.6g}", flush=True)
            if not torch.equal(img, img2):
                print("note: two renders differ (max "
                      f"{float((img - img2).abs().max()):.3g})", flush=True)
            return counts, warm_s

        launches = {}
        launches["deep_path"], _ = twice(
            "deep path (path, max_depth 48, rr_depth 5; sphere light)",
            deep(DEEP_SPP), DEEP_SPP, ("B1",))
        scene = glass(GLASS_SPP)
        sa = scene.compile()
        print(f"glass scene: {sa.n_static_tris} static and "
              f"{sa.n_anim_tris} animated triangles, {sa.n_spheres} sphere; "
              f"BSDF types {sa.bsdf_types_present}, emitter types "
              f"{sa.emitter_types_present}", flush=True)
        launches["glass"], warm_s = twice(
            "glass 40k (dopplertofpath, max_depth 6)", scene, GLASS_SPP,
            ("B2", "B1"))
        # the idle share of one strip pass: a 256x256 x 16 spp render is
        # one wavefront of 1,048,576 lanes, whose trace torch.profiler
        # reads back in seconds (the whole render's takes minutes)
        one_pass = GLASS_PROFILE_SPP
        mi.render(scene, spp=one_pass, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mi.render(scene, spp=one_pass, seed=0)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        idle = device_breakdown(mi, scene, one_pass, pass_s)
        print(f"glass 40k, one strip pass ({res}x{res}x{one_pass}, warm "
              f"{pass_s:.3f} s): the card idles {100 * idle:.1f}% of it "
              f"({card})", flush=True)
        del scene, sa

        # card against CPU at 16x16 x 16 spp: phase 8's criteria (>= 99%
        # of values within rtol 1e-4, atol 1e-4 * max|cpu|, mean within
        # 1e-3 relative) on the images with the lanes the CPU render marks
        # left out of both films, at most 10% of the lanes marked
        t_step = time.perf_counter()
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from torch_ties import TieRecorder
        cases = (("deep path", lambda dv: deep(16, dv, 16), {}, "B1"),
                 ("glass 2k", lambda dv: glass(16, dv, 16, "2k"), {}, "B2"),
                 ("glass 2k through B5 (MI_STREAM_KERNEL=v3)",
                  lambda dv: glass(16, dv, 16, "2k"),
                  {"MI_STREAM_KERNEL": "v3"}, "B5"))
        cpu, card_imgs = {}, {}
        for label, load, env, row in cases:
            key = label.split(" through")[0]
            if key not in cpu:
                rec = TieRecorder(16 * 16 * 16, "cpu")
                with rec.hooked():
                    whole = mi.render(load("cpu"), spp=16, seed=0).numpy()
                with rec.dropped():
                    kept = mi.render(load("cpu"), spp=16, seed=0).numpy()
                cpu[key] = (rec, whole, kept)
            rec, whole_c, kept_c = cpu[key]
            os.environ.update(env)
            try:
                whole_g = mi.render(load(None), spp=16,
                                    seed=0).cpu().numpy()
                reset()
                with rec.dropped():
                    kept_g = mi.render(load(None), spp=16,
                                       seed=0).cpu().numpy()
                counts = read()
            finally:
                for k in env:
                    os.environ.pop(k, None)
            if counts[row]["closest_hit"] <= 0:
                fail(f"{label} card vs cpu: launches {counts}")
            card_imgs[label] = whole_g

            def measure(ig, ic):
                scale = float(np.abs(ic).max())
                close = np.isclose(ig, ic, rtol=1e-4, atol=1e-4 * scale)
                rel_mean = (abs(ig.mean() - ic.mean())
                            / max(abs(ic.mean()), 1e-30))
                return scale, close.mean(), rel_mean, float(
                    np.abs(ig - ic).max())

            sw, cw, mw, dw = measure(whole_g, whole_c)
            sk, ck, mk, dk = measure(kept_g, kept_c)
            n_marked = int(rec.marked.sum())
            print(f"cuda vs cpu {label} 16x16x16: whole images "
                  f"{cw * 100:.2f}% of values within tolerance, mean rel "
                  f"diff {mw:.3g}, max abs diff {dw:.3g} (scale {sw:.3g}); "
                  f"{n_marked} of 4096 lanes marked (ties, grazed edges); "
                  f"without them {ck * 100:.2f}% within tolerance, mean "
                  f"rel diff {mk:.3g}, max abs diff {dk:.3g} (scale "
                  f"{sk:.3g})", flush=True)
            if (ck < 0.99 or mk > 1e-3 or sk <= 0.0 or n_marked > 409
                    or not np.isfinite(whole_g).all()):
                fail(f"cuda vs cpu {label}: outside tolerance")
        # B5 against B2 on the card, phase 7's tolerance on every value
        b2 = card_imgs["glass 2k"]
        b5 = card_imgs["glass 2k through B5 (MI_STREAM_KERNEL=v3)"]
        scale = float(np.abs(b2).max())
        n_out = int((~np.isclose(b5, b2, rtol=1e-4,
                                 atol=1e-4 * scale)).sum())
        print(f"glass 2k 16x16x16, B5 (v3) vs B2 on the card: {n_out} of "
              f"{b2.size} values outside tolerance, "
              f"{int((b5 != b2).sum())} differ at all", flush=True)
        if n_out:
            fail("glass 2k: B5's image is not B2's")
        print(f"card vs cpu, scene dialect: "
              f"{time.perf_counter() - t_step:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# the rgb variant's other integrators (phase 12)
INTEG_RES = 256
MOMENT_SPP = 1024               # the canonical scene's own spp
PTRACER_SPP = 1024              # bench_suite.py:218-223's row
HERO_AOV_SPP = 64
PRINCIPLED_SPP = 256
VOLPATHMIS_SPPS = (256, 64, 16)
VOLPATHMIS_BUDGET_S = 15.0      # volpathmis' warm render at most
HERO_AOVS = "dd:depth,pp:position,nn:sh_normal,aa:albedo"
# aov's card-vs-CPU image: RGB, alpha, then these AOVs; the triangle and
# instance ids at 4:6, the shading normal and uv at 13:18
AOV_CHECK = ("pi:prim_index,si:shape_index,dd:depth,pp:position,aa:albedo,"
             "nn:sh_normal,uv:uv")
AOV_IDS, AOV_HIT_ONLY = slice(4, 6), slice(13, 18)


def aov_check_dict(mi) -> dict:
    """The canonical scene at 16x16 x 16 spp with a box filter and an
    alpha channel, for aov's card-vs-CPU check: the scene has no
    environment, so a pixel's alpha is 1 exactly where every one of its
    samples hit."""
    d = canonical_dict(mi, rfilter={"type": "box"}, spp=16, resx=16,
                       resy=16)
    cam = next(v for v in d.values()
               if isinstance(v, dict) and v.get("type") == "perspective")
    next(v for v in cam.values() if isinstance(v, dict)
         and v.get("type") == "hdrfilm")["pixel_format"] = "rgba"
    return d


def aov_all_hit(img_g, img_c):
    """The pixels of aov's card-vs-CPU image every sample of which hit on
    both sides. Every pixel is compared: on a missed lane aov's shading
    normal and uv are the plain intersector's on both devices; this mask
    only splits the report."""
    return (img_g[..., 3] == 1.0) & (img_c[..., 3] == 1.0)


def principled_dict(mesh: str, spp: int, res: int) -> dict:
    """The principled scene, built here (not a published scene): the
    animated mesh scene of utils/bench_scenes.py (its camera, shutter,
    correlated sampler, point light and dopplertofpath) with its sphere
    (the OBJ file ``mesh``) made ``principled`` (base_color [0.8, 0.35,
    0.2], metallic 0.3, roughness 0.3, sheen 0.3, clearcoat 0.5,
    anisotropic 0.4), the floor ``pplastic`` (alpha 0.1), a
    ``principledthin`` pane (spec_trans 0.5, diff_trans 0.6) and a
    rectangle area light."""
    from mitsuba3dopplertof_tpu_torch.core import transform as tf
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import \
        animated_mesh_scene
    d = animated_mesh_scene(mesh, spp, res)

    def rgb(v):
        return {"type": "rgb", "value": v}
    d["mesh"]["bsdf"] = {"type": "principled",
                         "base_color": rgb([0.8, 0.35, 0.2]),
                         "metallic": 0.3, "roughness": 0.3, "sheen": 0.3,
                         "clearcoat": 0.5, "anisotropic": 0.4}
    d["floor"]["bsdf"] = {"type": "pplastic", "alpha": 0.1,
                          "diffuse_reflectance": rgb([0.5, 0.55, 0.6])}
    d["pane"] = {"type": "rectangle",
                 "to_world": tf.translate([-1.6, -0.3, 0.8])
                 @ tf.rotate([0, 1, 0], 30) @ tf.scale([0.6, 0.8, 1]),
                 "bsdf": {"type": "principledthin",
                          "base_color": rgb([0.3, 0.6, 0.8]),
                          "roughness": 0.2, "spec_trans": 0.5,
                          "diff_trans": 0.6}}
    d["panel"] = {"type": "rectangle",
                  "to_world": tf.translate([1.5, 2.5, -1.0])
                  @ tf.rotate([1, 0, 0], 90) @ tf.scale([0.5, 0.5, 1]),
                  "emitter": {"type": "area", "radiance": rgb(8.0)}}
    return d


def ptracer_emitters_dict(spp: int, tf=None, projector_image=None) -> dict:
    """The light tracer's test scene: a diffuse floor under an area-lit
    panel, a projector and a collimated directionalarea rectangle (the
    emitters of the JAX package's tests/test_ptracer_emitters.py:200-230,
    in one scene), a 16x16 perspective camera with a box filter,
    ``ptracer`` with max_depth 3. ``tf``: the transform module of the
    package that loads the dict (default: the port's). ``projector_image``: a texture dict for the
    projector's image (default: a constant irradiance of 25)."""
    from mitsuba3dopplertof_tpu_torch.core import transform as port_tf
    tf = tf or port_tf

    def rgb(v):
        return {"type": "rgb", "value": v}
    return {
        "type": "scene",
        "integrator": {"type": "ptracer", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 60,
                   "to_world": tf.look_at([0, 1.5, -3], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": 16,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "floor": {"type": "rectangle",
                  "to_world": tf.rotate([1, 0, 0], -90)
                  @ tf.scale([3, 3, 1]),
                  "bsdf": {"type": "diffuse", "reflectance": rgb(0.7)}},
        "panel": {"type": "rectangle",
                  "to_world": tf.translate([1.2, 1.0, 0.5])
                  @ tf.rotate([1, 0, 0], 90) @ tf.scale([0.3, 0.3, 1]),
                  "emitter": {"type": "area",
                              "radiance": rgb([4.0, 3.0, 2.0])}},
        "proj": {"type": "projector",
                 "to_world": tf.look_at([0, 3, 0], [0, 0, 0], [0, 0, 1]),
                 "fov": 40.0,
                 "irradiance": projector_image or rgb(25.0)},
        "beam": {"type": "rectangle",
                 "to_world": tf.translate([-0.8, 2, 0])
                 @ tf.rotate([1, 0, 0], 90) @ tf.scale([0.5, 0.5, 1]),
                 "emitter": {"type": "directionalarea",
                             "radiance": rgb(5.0)}},
    }


def timed_render(mi, reset, read, card, res, tag, scene, spp, warm_spp,
                 integ, rows, n_ch=3):
    """A warm-up render of ``scene`` at ``warm_spp``, then the timed render
    at ``spp`` (``integ``: an integrator in place of the scene's, or None)
    with the launches read around it; ``rows``: the kernels and forms it
    must launch (no other). Returns (image, launches by row, warm s)."""
    import torch
    kw = {} if integ is None else {"integrator": integ}
    mi.render(scene, spp=warm_spp, seed=0, **kw)
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    img = mi.render(scene, spp=spp, seed=0, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = read()
    if tuple(img.shape) != (res, res, n_ch):
        fail(f"{tag}: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or not bool(
            (img[..., :3] != 0).any()):
        fail(f"{tag}: image not finite or all zero")
    for row, c in counts.items():
        for form, n in c.items():
            if (n > 0) != (form in rows.get(row, ())):
                fail(f"{tag}: launches {counts}")
    print(f"render {tag} {res}x{res}x{spp}: warm {warm_s:.3f} s = "
          f"{res * res * spp / warm_s / 1e6:.3f} Msamples/s ({card}); "
          "launches " + ", ".join(f"{row} {counts[row]}" for row in rows)
          + f"; image mean {float(img[..., :3].mean()):.6g}, max |v| "
          f"{float(img[..., :3].abs().max()):.6g}", flush=True)
    return img, {row: counts[row] for row in rows}, warm_s


def integrators_phase(mi, reset, read, card) -> dict:
    """Phase 12: the rgb variant's other integrators on the card, each
    render timed warm after a one-pass warm-up, the launches read around
    the timed render: moment around the canonical dopplertofpath (256x256
    x 1024 spp, B1; its RGB against the plain render of the same seed, its
    m2 >= mean^2), ptracer on the canonical scene (max_depth 4, 1024 light
    paths a pixel, B1), aov and direct on the hero scene (256x256 x 64
    spp, B2), volpathmis on the volpath row (the largest of 256, 64 and 16
    spp that fits VOLPATHMIS_BUDGET_S), the principled scene (the 40k
    sphere, 256x256 x 256 spp, B2) with the launches and device time of
    one principled BSDF dispatch on a 2^20-lane wavefront; then the card
    against the CPU at 16x16 x 16 spp with phase 8's criteria: moment,
    aov (box filter: its triangle and instance ids exact, its shading
    normal and uv compared on the pixels all hit), direct,
    use_nee=false, volpathmis, the principled scene with the 2k sphere
    through B2 and MI_STREAM_KERNEL=v3 (the lanes that meet a tie or
    graze an edge left out of both films), and ptracer on the projector /
    directionalarea scene. Returns the timed renders' launches by scene
    and kernel row."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mitsuba3dopplertof_tpu_torch import bsdfs
    from mitsuba3dopplertof_tpu_torch.core.vec import Vec3
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
        ANIMATED_SIZES, volpath_scene, write_uv_sphere_obj)
    from mitsuba3dopplertof_tpu_torch.utils.hero_scene import (
        hero_assets, hero_scene_dict)
    res = INTEG_RES
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="integrators_")
    launches = {}
    try:
        objs = {}
        for size in ("40k", "2k"):
            objs[size] = os.path.join(tmp, f"sphere_{size}.obj")
            write_uv_sphere_obj(objs[size], *ANIMATED_SIZES[size])
        hero_assets(tmp)

        def hero(spp, integ=None):
            d = hero_scene_dict(res=res, spp=spp, cache_dir=tmp)
            if integ == "aov":
                d["integrator"] = {"type": "aov", "aovs": HERO_AOVS,
                                   "nested": d["integrator"]}
            elif integ is not None:
                d["integrator"] = dict(integ)
            return mi.load_dict(d)

        def timed(tag, scene, spp, warm_spp, integ, rows, n_ch=3):
            return timed_render(mi, reset, read, card, res, tag, scene,
                                spp, warm_spp, integ, rows, n_ch)

        both = ("closest_hit", "any_hit")
        # ---- moment around the canonical dopplertofpath ----------------
        canon = mi.load_file(CANONICAL, resx=res, resy=res)
        plain = mi.render(canon, spp=MOMENT_SPP, seed=0)
        img, launches["moment"], _ = timed(
            "canonical moment (dopplertofpath) through B1", canon,
            MOMENT_SPP, 16, mi.load_dict({"type": "moment",
                                          "nested": canon.integrator}),
            {"B1": both}, n_ch=6)
        rgb, m2 = img[..., :3], img[..., 3:]
        same = bool(torch.equal(rgb, plain))
        # m2 >= mean^2 per pixel, to rounding (the filter's weights are
        # positive: Jensen)
        short = float((rgb * rgb * (1.0 - 1e-5) - m2).clamp(min=0).max())
        print(f"moment: RGB equal to the plain render bit for bit: {same} "
              f"(max diff {float((rgb - plain).abs().max()):.3g}); m2 "
              f"below mean^2 by at most {short:.3g}; m2 mean "
              f"{float(m2.mean()):.6g}", flush=True)
        if not same or short > 0.0:
            fail("moment: RGB is not the plain render or m2 < mean^2")
        del img, rgb, m2, plain

        # ---- ptracer on the canonical scene ----------------------------
        _, launches["ptracer"], _ = timed(
            "canonical ptracer (max_depth 4, light paths per pixel)", canon,
            PTRACER_SPP, 16, mi.load_dict({"type": "ptracer",
                                           "max_depth": 4}),
            {"B1": both})
        del canon

        # ---- aov and direct on the hero scene ---------------------------
        scene = hero(HERO_AOV_SPP, "aov")
        img, launches["hero_aov"], _ = timed(
            f"hero aov ({HERO_AOVS}) around dopplertofpath through B2",
            scene, HERO_AOV_SPP, 16, None, {"B2": both}, n_ch=13)
        depth = img[..., 3]
        print(f"hero aov: depth in [{float(depth.min()):.4g}, "
              f"{float(depth.max()):.4g}], albedo mean "
              f"{float(img[..., 10:13].mean()):.4g}", flush=True)
        if float(depth.max()) <= 0.0:
            fail("hero aov: no depth")
        del img, depth, scene
        _, launches["hero_direct"], _ = timed(
            "hero direct through B2", hero(HERO_AOV_SPP, {"type": "direct"}),
            HERO_AOV_SPP, 16, None, {"B2": both})

        # ---- volpathmis on the volpath row -------------------------------
        d = volpath_scene(16, res)
        d["integrator"] = dict(d["integrator"], type="volpathmis")
        scene = mi.load_dict(d)
        mi.render(scene, spp=16, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mi.render(scene, spp=16, seed=0)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
        spp_v = next((s for s in VOLPATHMIS_SPPS
                      if probe_s * s / 16 <= VOLPATHMIS_BUDGET_S), 16)
        print(f"volpathmis probe 16 spp: warm {probe_s:.3f} s; rendering "
              f"at {spp_v} spp", flush=True)
        _, launches["volpathmis"], _ = timed(
            "volpath row (volpathmis, homogeneous medium) through B1",
            scene, spp_v, 16, None, {"B1": ("closest_hit",)})
        del scene

        # ---- the principled scene ---------------------------------------
        scene = mi.load_dict(principled_dict(objs["40k"], PRINCIPLED_SPP,
                                             res))
        sa = scene.compile()
        print(f"principled scene: {sa.n_static_tris} static and "
              f"{sa.n_anim_tris} animated triangles; BSDF types "
              f"{sa.bsdf_types_present}, emitter types "
              f"{sa.emitter_types_present}", flush=True)
        _, launches["principled"], _ = timed(
            "principled 40k (dopplertofpath) through B2", scene,
            PRINCIPLED_SPP, 16, None, {"B2": both})
        # one BSDF dispatch over a strip pass's wavefront: every type of
        # the scene runs on every lane (the masked dispatch)
        n = WAVEFRONT
        g = torch.Generator(device=sa.device).manual_seed(0)
        u = lambda: torch.rand(n, device=sa.device, generator=g)
        wi = Vec3(u() - 0.5, u() - 0.5, u() - 0.3)
        wo = Vec3(u() - 0.5, u() - 0.5, u() - 0.3)
        lane = torch.randint(0, int(sa.bsdf_type.shape[0]), (n,),
                             device=sa.device, generator=g)
        s1, s2x, s2y = u(), u(), u()
        from torch.profiler import ProfilerActivity, profile
        for types in ((bsdfs.BSDF_PRINCIPLED, bsdfs.BSDF_PRINCIPLED_THIN,
                       bsdfs.BSDF_ROUGHPLASTIC), (bsdfs.BSDF_ROUGHPLASTIC,)):
            saved = sa.bsdf_types_present
            sa.bsdf_types_present = types
            try:
                bsdfs.eval_pdf_sample(sa, lane, wi, wo, s1, s2x, s2y)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    bsdfs.eval_pdf_sample(sa, lane, wi, wo, s1, s2x, s2y)
                    torch.cuda.synchronize()
            finally:
                sa.bsdf_types_present = saved
            kern = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation
                    and e.self_device_time_total > 0]
            n_launch = sum(e.count for e in kern)
            dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
            print(f"BSDF dispatch over {n} lanes, types {types}: "
                  f"{n_launch} kernel launches, {dev_ms:.3f} ms of device "
                  f"time ({card})", flush=True)
        del scene, sa

        # ---- the card against the CPU at 16x16 x 16 spp -------------------
        t_step = time.perf_counter()
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from torch_ties import TieRecorder

        def canon16(dv):
            return mi.load_file(CANONICAL, spp=16, resx=16, resy=16,
                                device=dv)

        def canon_aov(dv):
            return mi.load_dict(aov_check_dict(mi), device=dv)

        def with_integ(load, integ=None):
            """(scene, integrator) on a device; None: the scene's own."""
            def f(dv):
                sc = load(dv)
                if integ is None:
                    return sc, None
                return sc, mi.load_dict(
                    integ(sc) if callable(integ) else dict(integ))
            return f

        def principled16(dv):
            return mi.load_dict(principled_dict(objs["2k"], 16, 16),
                                device=dv)

        cases = (
            ("canonical moment", with_integ(canon16, lambda sc: {
                "type": "moment", "nested": sc.integrator}), {}, "B1",
             False),
            ("canonical aov (box filter, alpha)", with_integ(canon_aov, {
                "type": "aov", "aovs": AOV_CHECK,
                "nested": {"type": "path", "max_depth": 4}}), {}, "B1",
             False),
            ("canonical direct", with_integ(canon16, {"type": "direct"}),
             {}, "B1", False),
            ("canonical path use_nee=false", with_integ(canon16, {
                "type": "path", "max_depth": 4, "use_nee": False}), {},
             "B1", False),
            ("volpath row volpathmis", with_integ(
                lambda dv: mi.load_dict(volpath_scene(16, 16), device=dv),
                {"type": "volpathmis", "max_depth": 6}), {}, "B1", False),
            ("principled 2k", with_integ(principled16), {}, "B2", True),
            ("principled 2k through B5 (MI_STREAM_KERNEL=v3)",
             with_integ(principled16), {"MI_STREAM_KERNEL": "v3"}, "B5",
             True),
            ("ptracer projector + directionalarea", with_integ(
                lambda dv: mi.load_dict(ptracer_emitters_dict(16),
                                        device=dv),
                {"type": "ptracer", "max_depth": 3}), {}, "B1", False))
        cpu = {}
        for label, load, env, row, ties in cases:
            key = label.split(" through")[0]
            if key not in cpu:
                sc, integ = load("cpu")
                if ties:
                    rec = TieRecorder(16 * 16 * 16, "cpu")
                    with rec.hooked():
                        mi.render(sc, spp=16, seed=0, integrator=integ)
                    with rec.dropped():
                        img_c = mi.render(load("cpu")[0], spp=16, seed=0,
                                          integrator=integ).numpy()
                else:
                    rec = None
                    img_c = mi.render(sc, spp=16, seed=0,
                                      integrator=integ).numpy()
                cpu[key] = (rec, img_c)
            rec, img_c = cpu[key]
            os.environ.update(env)
            try:
                sc, integ = load(None)
                reset()
                if rec is not None:
                    with rec.dropped():
                        img_g = mi.render(sc, spp=16, seed=0,
                                          integrator=integ).cpu().numpy()
                else:
                    img_g = mi.render(sc, spp=16, seed=0,
                                      integrator=integ).cpu().numpy()
                counts = read()
            finally:
                for k in env:
                    os.environ.pop(k, None)
            if counts[row]["closest_hit"] <= 0:
                fail(f"{label} card vs cpu: launches {counts}")
            scale = float(np.abs(img_c).max())
            close = np.isclose(img_g, img_c, rtol=1e-4, atol=1e-4 * scale)
            extra = ""
            if label.startswith("canonical aov"):
                hit = aov_all_hit(img_g, img_c)
                # triangle and instance ids: box-filtered means of equal
                # integers, exact
                ids_equal = bool(np.array_equal(img_g[..., AOV_IDS],
                                                img_c[..., AOV_IDS]))
                on_hit = close[hit][:, AOV_HIT_ONLY].mean()
                on_miss = (close[~hit][:, AOV_HIT_ONLY].mean()
                           if (~hit).any() else 1.0)
                extra = (f"; prim_index and shape_index equal: {ids_equal}"
                         f"; sh_normal and uv within tolerance on "
                         f"{on_hit * 100:.2f}% of the values of the "
                         f"{int(hit.sum())} pixels all hit, "
                         f"{on_miss * 100:.2f}% on the others")
                if (not ids_equal or hit.mean() < 0.5 or on_hit < 0.99
                        or on_miss < 0.99):
                    fail("aov card vs cpu: the index channels differ, or "
                         "sh_normal / uv")
            rel_mean = (abs(img_g.mean() - img_c.mean())
                        / max(abs(img_c.mean()), 1e-30))
            marked = ("" if rec is None else
                      f"; {int(rec.marked.sum())} of 4096 lanes marked "
                      "(ties, grazed edges) left out of both films")
            print(f"cuda vs cpu {label} 16x16x16: {close.mean() * 100:.2f}% "
                  f"of values within tolerance, mean rel diff "
                  f"{rel_mean:.3g}, max abs diff "
                  f"{float(np.abs(img_g - img_c).max()):.3g} (scale "
                  f"{scale:.3g}){marked}{extra}", flush=True)
            if (close.mean() < 0.99 or rel_mean > 1e-3 or scale <= 0.0
                    or not np.isfinite(img_g).all()
                    or (rec is not None and rec.marked.sum() > 409)):
                fail(f"cuda vs cpu {label}: outside tolerance")
        print(f"card vs cpu, integrators: "
              f"{time.perf_counter() - t_step:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


TEXTURED_RES = 256
TEXTURED_SPP = 64               # the surface and mesh-light renders
MEDIA_SPPS = (256, 128, 64, 32, 16)
MEDIA_BUDGET_S = 15.0           # the media scene's warm render at most


def textured_phase(mi, reset, read, card) -> dict:
    """Phase 13: the textured-surface, textured-emitter and phase plugins
    on the card (scenes of utils/textured_scenes.py, their assets written
    here), each render timed warm after a one-pass warm-up with the
    launches read around the timed render: (a) the surface scene
    (normalmap wall, bumpmap roughplastic floor, volume-textured panel,
    checkerboard rectangle light, bitmap sphere light; dopplertofpath,
    256x256 x 64 spp, B1); (b) the 40k animated sphere as a vertex-coloured
    PLY under mesh_attribute, below a 2k-triangle grid light with a bitmap
    radiance (256x256 x 64, B2); (c) the media scene (rayleigh,
    blendphase, tabphase, sggx with a varying S grid; volpath at 256x256,
    the largest of MEDIA_SPPS whose warm render a 16 spp probe puts within
    MEDIA_BUDGET_S). Then the card against the CPU at 16x16 x 16 spp with
    phase 8's criteria: (a) with dopplertofpath, direct, aov and ptracer,
    (b) with the 2k sphere, (c), the lanes that meet a tie or graze an
    edge left out of both films. Returns the timed renders' launches by
    scene and kernel row."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mitsuba3dopplertof_tpu_torch.utils import textured_scenes as ts
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import \
        ANIMATED_SIZES
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_ties import TieRecorder
    res = TEXTURED_RES
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="textured_")
    launches = {}
    try:
        assets = ts.write_surface_assets(tmp)
        sggx = os.path.join(tmp, "sggx.vol")
        ts.write_sggx_vol(sggx)
        light = os.path.join(tmp, "light_2k.ply")
        n_light = ts.write_light_grid_ply(light, 32)
        spheres = {}
        for size in ("40k", "2k"):
            spheres[size] = os.path.join(tmp, f"sphere_{size}.ply")
            ts.write_colored_sphere_ply(spheres[size], *ANIMATED_SIZES[size])

        def surface(spp, r, dv=None):
            return mi.load_dict(ts.surface_scene(assets, spp, r), device=dv)

        def mesh_light(size, spp, r, dv=None):
            return mi.load_dict(ts.mesh_light_scene(
                spheres[size], light, assets["glow"], spp, r), device=dv)

        def media(spp, r, dv=None):
            return mi.load_dict(ts.media_scene(sggx, spp, r), device=dv)

        def timed(tag, scene, spp, rows):
            _, counts, _ = timed_render(mi, reset, read, card, res, tag,
                                        scene, spp, 16, None, rows)
            return counts

        both = ("closest_hit", "any_hit")
        scene = surface(TEXTURED_SPP, res)
        sa = scene.compile()
        print(f"surface scene: {sa.n_static_tris} static and "
              f"{sa.n_anim_tris} animated triangles, {sa.n_spheres} sphere; "
              f"texture types {sa.tex_types_present}, normal maps "
              f"{sa.any_nmap}", flush=True)
        launches["surface"] = timed(
            "surface (normalmap, bumpmap, volume, textured lights; "
            "dopplertofpath) through B1", scene, TEXTURED_SPP, {"B1": both})
        scene = mesh_light("40k", TEXTURED_SPP, res)
        sa = scene.compile()
        print(f"mesh-light scene: {sa.n_static_tris} static ({n_light} of "
              f"the light) and {sa.n_anim_tris} animated triangles; "
              f"mesh_attr {tuple(sa.mesh_attr.shape)}", flush=True)
        launches["mesh_light"] = timed(
            "40k mesh_attribute + 2k textured mesh light (dopplertofpath) "
            "through B2", scene, TEXTURED_SPP, {"B2": both})
        scene = media(16, res)
        mi.render(scene, spp=16, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mi.render(scene, spp=16, seed=0)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
        spp_m = next((s for s in MEDIA_SPPS
                      if probe_s * s / 16 <= MEDIA_BUDGET_S), 16)
        print(f"media probe 16 spp: warm {probe_s:.3f} s; rendering at "
              f"{spp_m} spp", flush=True)
        launches["media"] = timed(
            "media (rayleigh, blendphase, tabphase, sggx grid; volpath) "
            "through B1", scene, spp_m, {"B1": ("closest_hit",)})
        del scene, sa

        # ---- the card against the CPU at 16x16 x 16 spp -------------------
        t_step = time.perf_counter()
        integs = {"direct": {"type": "direct"},
                  "aov": {"type": "aov", "aovs": "aa:albedo,dd:depth",
                          "nested": {"type": "path", "max_depth": 4}},
                  "ptracer": {"type": "ptracer", "max_depth": 4}}
        cases = (("surface dopplertofpath", lambda dv: surface(16, 16, dv),
                  None, "B1"),
                 *((f"surface {k}", lambda dv: surface(16, 16, dv), k, "B1")
                   for k in integs),
                 ("mesh-light 2k dopplertofpath",
                  lambda dv: mesh_light("2k", 16, 16, dv), None, "B2"),
                 ("media volpath", lambda dv: media(16, 16, dv), None, "B1"))
        for label, load, integ, row in cases:
            def render(dv):
                kw = ({} if integ is None
                      else {"integrator": mi.load_dict(integs[integ])})
                return mi.render(load(dv), spp=16, seed=0, **kw)
            rec = TieRecorder(16 * 16 * 16, "cpu")
            if integ != "ptracer":
                with rec.hooked():
                    render("cpu")
            with rec.dropped():
                img_c = render("cpu").numpy()
                reset()
                img_g = render(None).cpu().numpy()
            counts = read()
            if counts[row]["closest_hit"] <= 0:
                fail(f"{label} card vs cpu: launches {counts}")
            scale = float(np.abs(img_c).max())
            close = np.isclose(img_g, img_c, rtol=1e-4, atol=1e-4 * scale)
            rel_mean = (abs(img_g.mean() - img_c.mean())
                        / max(abs(img_c.mean()), 1e-30))
            n_marked = int(rec.marked.sum())
            print(f"cuda vs cpu {label} 16x16x16: {close.mean() * 100:.2f}% "
                  f"of values within tolerance, mean rel diff "
                  f"{rel_mean:.3g}, max abs diff "
                  f"{float(np.abs(img_g - img_c).max()):.3g} (scale "
                  f"{scale:.3g}); {n_marked} of 4096 lanes marked (ties, "
                  "grazed edges) left out of both films", flush=True)
            if (close.mean() < 0.99 or rel_mean > 1e-3 or scale <= 0.0
                    or not np.isfinite(img_g).all() or n_marked > 409):
                fail(f"cuda vs cpu {label}: outside tolerance")
        print(f"card vs cpu, textured: {time.perf_counter() - t_step:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# the spectral and mono variants (phase 14)
SPECTRAL_RES = 256
SPECTRAL_CANON_SPP = 1024       # the canonical scene's own spp
SPECTRAL_SPP = 64               # the hero, glass and measured renders
SPECTRAL_MEDIA_SPPS = (256, 128, 64, 32, 16)
SPECTRAL_MEDIA_BUDGET_S = 15.0  # the media scene's warm render at most


def spectral_phase(mi, reset, read, card, canon_rgb=None) -> dict:
    """Phase 14: the spectral and mono variants and the measured BSDF on
    the card, each render timed warm after a 16 spp warm-up with the
    launches read around the timed render, in cuda_spectral unless named:
    (a) the canonical dopplertofpath, 256x256 x 1024 spp, through B1 (its
    launches equal to ``canon_rgb``, the rgb render's, where given); (b)
    the hero's dopplertofpath, 256x256 x 64, through B2, the cold rgb2spec
    lattice fit on the card and the hero's compile (the sky's per-texel
    fit) timed apart; (c)
    the glass scene with the 40k sphere (named conductors Al and Au
    through their eta / k spectra, the dielectric family), 256x256 x 64,
    through B2 and B1's sphere pass; (d) measured on the 40k sphere,
    256x256 x 64, through B2, in cuda_rgb and cuda_spectral, and one
    measured BSDF dispatch over 2^20 lanes in each (launches, device ms);
    (e) the media scene's volpath, through B1, at the largest of
    SPECTRAL_MEDIA_SPPS whose warm render a 16 spp probe puts within
    SPECTRAL_MEDIA_BUDGET_S. Then (f) the card against the CPU at 16x16 x
    16 spp with phase 8's criteria: the canonical scene in cuda_mono (its
    three channels equal) and in cuda_spectral into a specfilm of three
    regular SRFs, measured in cuda_rgb and cuda_spectral on the 2k sphere,
    the mini hero (a 32x16 sky) and the media scene in cuda_spectral; the
    lanes that meet a tie or graze an edge left out of both films where
    the scene has more than 192 triangles. Leaves the variant at cuda_rgb.
    Returns the timed renders' launches by scene and kernel row."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mitsuba3dopplertof_tpu_torch import bsdfs
    from mitsuba3dopplertof_tpu_torch.core import cie
    from mitsuba3dopplertof_tpu_torch.core.vec import Vec3
    from mitsuba3dopplertof_tpu_torch.utils import hero_scene as hs
    from mitsuba3dopplertof_tpu_torch.utils import measured_data as md
    from mitsuba3dopplertof_tpu_torch.utils import spectral_scenes as ss
    from mitsuba3dopplertof_tpu_torch.utils import textured_scenes as ts
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
        ANIMATED_SIZES, write_uv_sphere_obj, write_uv_sphere_ply)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_ties import TieRecorder
    res = SPECTRAL_RES
    both = ("closest_hit", "any_hit")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="spectral_")
    launches = {}

    def timed(tag, scene, spp, rows, integ=None):
        _, counts, warm_s = timed_render(mi, reset, read, card, res, tag,
                                         scene, spp, 16, integ, rows)
        return counts, warm_s

    try:
        bsdf_path = md.write_ggx_copper_bsdf(os.path.join(tmp, "cu.bsdf"))
        mesh = {}
        for size in ("40k", "2k"):
            nu, nv = ANIMATED_SIZES[size]
            mesh[size] = os.path.join(tmp, f"sphere_{nu}x{nv}")
            write_uv_sphere_obj(mesh[size] + ".obj", nu, nv)
            write_uv_sphere_ply(mesh[size] + ".ply", nu, nv)
        sggx = os.path.join(tmp, "sggx.vol")
        ts.write_sggx_vol(sggx)
        hero_dir = os.path.join(tmp, "hero")
        hs.hero_assets(hero_dir)

        def measured(size, spp, r, dv=None):
            return mi.load_dict(md.measured_sphere_dict(
                bsdf_path, mesh[size] + ".obj", spp, r), device=dv)

        def media(spp, r, dv=None):
            return mi.load_dict(ts.media_scene(sggx, spp, r), device=dv)

        mi.set_variant("cuda_spectral")
        # ---- (a) the canonical scene ------------------------------------
        scene = mi.load_file(CANONICAL, spp=SPECTRAL_CANON_SPP)
        launches["canonical_spectral"], _ = timed(
            "canonical dopplertofpath (cuda_spectral) through B1", scene,
            SPECTRAL_CANON_SPP, {"B1": both})
        if canon_rgb is not None:
            same = launches["canonical_spectral"]["B1"] == canon_rgb
            print(f"canonical cuda_spectral B1 launches "
                  f"{launches['canonical_spectral']['B1']} against cuda_rgb's "
                  f"{canon_rgb}: equal {same}", flush=True)
            if not same:
                fail("the spectral canonical render's launches differ from "
                     "the rgb render's")
        # ---- (b) the hero: the lattice, its compile, then its render -------
        cold = not os.path.exists(cie.lattice_cache_path())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cie.coeff_lattice(device="cuda")
        torch.cuda.synchronize()
        lat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene = mi.load_dict(hs.hero_scene_dict(res=res, spp=SPECTRAL_SPP,
                                                cache_dir=hero_dir))
        sa = scene.compile()
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        print(f"rgb2spec 32^3 lattice: {lat_s:.3f} s ("
              + ("a cold fit on the card" if cold else "read from its cache")
              + f"); hero compile (cuda_spectral) after it: {compile_s:.3f} "
              f"s; env_coeff {tuple(sa.env_coeff.shape)} (the sky's "
              f"{sa.env_shape[1]}x{sa.env_shape[0]} texels fitted on the "
              f"card), atlas coefficients {tuple(sa.tex_atlas_c0.shape)} "
              f"({card})", flush=True)
        if not sa.spectral or sa.env_coeff.shape[1] != (
                sa.env_shape[0] * sa.env_shape[1]):
            fail("the hero did not compile spectral tables")
        launches["hero_spectral"], _ = timed(
            "hero dopplertofpath (cuda_spectral) through B2", scene,
            SPECTRAL_SPP, {"B2": both})
        del scene, sa
        # ---- (c) the glass scene ----------------------------------------
        scene = mi.load_dict(glass_dict(mesh["40k"] + ".ply", SPECTRAL_SPP,
                                        res))
        sa = scene.compile()
        print(f"glass scene (cuda_spectral): named-conductor spectra "
              f"{len(sa.ior_spectra)} (rows {sa.bsdf_ior_host}); BSDF types "
              f"{sa.bsdf_types_present}", flush=True)
        if len(sa.ior_spectra) != 2:
            fail("the glass scene's Al and Au did not take their spectra")
        launches["glass_spectral"], _ = timed(
            "glass 40k (cuda_spectral) through B2 and B1's sphere pass",
            scene, SPECTRAL_SPP, {"B2": both, "B1": both})
        del scene, sa
        # ---- (d) measured, rgb and spectral; one BSDF dispatch ------------
        for name in ("cuda_rgb", "cuda_spectral"):
            mi.set_variant(name)
            scene = measured("40k", SPECTRAL_SPP, res)
            key = f"measured_{name.split('_')[1]}"
            launches[key], _ = timed(
                f"measured 40k ({name}) through B2", scene, SPECTRAL_SPP,
                {"B2": both})
            sa = scene.compile()
            n = WAVEFRONT
            g = torch.Generator(device=sa.device).manual_seed(0)
            u = lambda: torch.rand(n, device=sa.device, generator=g)
            wi = Vec3(u() - 0.5, u() - 0.5, u())
            wo = Vec3(u() - 0.5, u() - 0.5, u())
            lam = (None if name == "cuda_rgb" else
                   cie.hero_wavelengths(u()))
            lane = torch.zeros(n, dtype=torch.int64, device=sa.device)
            s1, s2x, s2y = u(), u(), u()
            saved = sa.bsdf_types_present
            sa.bsdf_types_present = (bsdfs.BSDF_MEASURED,)
            try:
                bsdfs.eval_pdf_sample(sa, lane, wi, wo, s1, s2x, s2y,
                                      wavelengths=lam)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    bsdfs.eval_pdf_sample(sa, lane, wi, wo, s1, s2x, s2y,
                                          wavelengths=lam)
                    torch.cuda.synchronize()
            finally:
                sa.bsdf_types_present = saved
            kern = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation
                    and e.self_device_time_total > 0]
            n_launch = sum(e.count for e in kern)
            dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
            print(f"measured BSDF dispatch over {n} lanes ({name}): "
                  f"{n_launch} kernel launches, {dev_ms:.3f} ms of device "
                  f"time ({card})", flush=True)
            del scene, sa
        mi.set_variant("cuda_spectral")
        # ---- (e) the media scene ------------------------------------------
        scene = media(16, res)
        mi.render(scene, spp=16, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mi.render(scene, spp=16, seed=0)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
        spp_m = next((s for s in SPECTRAL_MEDIA_SPPS
                      if probe_s * s / 16 <= SPECTRAL_MEDIA_BUDGET_S), 16)
        print(f"media probe (cuda_spectral) 16 spp: warm {probe_s:.3f} s; "
              f"rendering at {spp_m} spp", flush=True)
        launches["media_spectral"], _ = timed(
            "media volpath (cuda_spectral) through B1", scene, spp_m,
            {"B1": ("closest_hit",)})
        del scene

        # ---- (f) the card against the CPU at 16x16 x 16 spp -------------
        t_step = time.perf_counter()
        mini = os.path.join(tmp, "mini")
        os.makedirs(mini)
        hs._knot_obj(os.path.join(mini, "knot.obj"), nu=12, nv=8)
        hs._icosphere_obj(os.path.join(mini, "sphere.obj"), nu=8, nv=6)
        hs._sky_exr(os.path.join(mini, "sky.exr"), 32, 16)
        hs.hero_assets(mini)

        def canonical(film=None):
            def load(dv):
                sc = mi.load_file(CANONICAL, spp=16, resx=16, resy=16,
                                  device=dv)
                if film is not None:
                    sc.sensor.film = mi.load_dict(film)
                return sc
            return load

        cases = (
            ("canonical", "cuda_mono", canonical(), "B1", False),
            ("canonical specfilm (3 regular SRFs)", "cuda_spectral",
             canonical(ss.specfilm_film(16)), "B1", False),
            ("measured 2k", "cuda_rgb",
             lambda dv: measured("2k", 16, 16, dv), "B2", True),
            ("measured 2k", "cuda_spectral",
             lambda dv: measured("2k", 16, 16, dv), "B2", True),
            ("mini hero (32x16 sky)", "cuda_spectral",
             lambda dv: mi.load_dict(hs.hero_scene_dict(
                 res=16, spp=16, max_depth=4, cache_dir=mini), device=dv),
             "B2", True),
            ("media volpath", "cuda_spectral", lambda dv: media(16, 16, dv),
             "B1", False))
        for label, name, load, row, ties in cases:
            mi.set_variant(name)
            rec = TieRecorder(16 * 16 * 16, "cpu")
            if ties:
                with rec.hooked():
                    mi.render(load("cpu"), spp=16, seed=0)
            with rec.dropped():
                img_c = mi.render(load("cpu"), spp=16, seed=0).numpy()
                reset()
                img_g = mi.render(load(None), spp=16, seed=0).cpu().numpy()
            counts = read()
            if counts[row]["closest_hit"] <= 0:
                fail(f"{label} ({name}) card vs cpu: launches {counts}")
            scale = float(np.abs(img_c).max())
            close = np.isclose(img_g, img_c, rtol=1e-4, atol=1e-4 * scale)
            rel_mean = (abs(img_g.mean() - img_c.mean())
                        / max(abs(img_c.mean()), 1e-30))
            n_marked = int(rec.marked.sum())
            extra = ""
            if name == "cuda_mono":
                grey = bool(np.array_equal(img_g[..., 0], img_g[..., 1])
                            and np.array_equal(img_g[..., 0], img_g[..., 2]))
                extra = f"; the three channels equal: {grey}"
                if not grey:
                    fail("cuda_mono: the channels differ")
            print(f"cuda vs cpu {label} ({name}) 16x16x16: "
                  f"{close.mean() * 100:.2f}% of values within tolerance, "
                  f"mean rel diff {rel_mean:.3g}, max abs diff "
                  f"{float(np.abs(img_g - img_c).max()):.3g} (scale "
                  f"{scale:.3g}); {n_marked} of 4096 lanes marked (ties, "
                  f"grazed edges) left out of both films{extra}", flush=True)
            if (close.mean() < 0.99 or rel_mean > 1e-3 or scale <= 0.0
                    or not np.isfinite(img_g).all() or n_marked > 409):
                fail(f"cuda vs cpu {label} ({name}): outside tolerance")
        print(f"card vs cpu, spectral: {time.perf_counter() - t_step:.1f} s",
              flush=True)
    finally:
        mi.set_variant("cuda_rgb")
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# the polarized variants (phase 15)
POLARIZED_RES = 256
POLARIZED_CANON_SPP = 1024      # the canonical scene's own spp
POLARIZED_MUELLER_SPP = 256     # the Mueller canonical, cut from 1024
POLARIZED_SPP = 64              # glass and measured_polarized
POLARIZED_MEDIA_SPPS = (64, 32, 16)
POLARIZED_MEDIA_BUDGET_S = 15.0  # the media scene's warm render at most


def polarized_phase(mi, reset, read, card, canon_rgb=None) -> dict:
    """Phase 15: the polarized variants on the card, in cuda_rgb_polarized
    unless named, each timed render warm after a 16 spp warm-up with the
    launches read around it: (a) the canonical dopplertofpath, 256x256 x
    1024 spp, on the depolarizing fast path: its image and B1 launches
    equal to the cuda_rgb render's (``canon_rgb``: (image, B1 launches)
    of phase 5's render, else rendered here); (b) the canonical scene under
    stokes(dopplertofpath) with MI_NO_DEPOL_FASTPATH=1, 256x256 x 256 spp
    (the full Mueller chain; its S0 within 1e-6 of the largest value of
    the fast path's render at that spp); (c) the glass scene with the 40k
    sphere under stokes(dopplertofpath), 256x256 x 64 (the dielectric,
    thindielectric and conductor Mueller factors through B2 and B1's
    sphere pass) and the idle share of one profiled strip pass; (d)
    measured_polarized on the 40k sphere under stokes(path), 256x256 x
    64, in cuda_rgb_polarized and cuda_spectral_polarized (B2); (e) the
    media scene under stokes(volpath) (Rayleigh's Mueller matrix, B1) at
    the largest of POLARIZED_MEDIA_SPPS whose warm render a 16 spp probe
    puts within POLARIZED_MEDIA_BUDGET_S. Then (f) Malus's law through two
    polarizers (S0 0.5, 0.25 and 0 at 0, 45 and 90 degrees, within 1e-3)
    and circular light behind a quarter-wave plate (|S3| / S0 > 0.99),
    and the card against the CPU at 16x16 x 16 spp with phase 8's
    criteria over every channel (the 12 Stokes AOVs too): the three
    elements' plates, the polarizing canonical
    (utils/polarized_scenes.py) under stokes(dopplertofpath), in both
    polarized variants, and under ptracer, glass and measured_polarized
    on the 2k sphere, the media scene. Leaves the
    variant at cuda_rgb. Returns the timed renders' launches by scene and
    kernel row."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mitsuba3dopplertof_tpu_torch.utils import measured_data as md
    from mitsuba3dopplertof_tpu_torch.utils import polarized_scenes as ps
    from mitsuba3dopplertof_tpu_torch.utils import textured_scenes as ts
    from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
        ANIMATED_SIZES, write_uv_sphere_obj, write_uv_sphere_ply)
    from mitsuba3dopplertof_tpu_torch.utils.profile_render import \
        device_breakdown
    res = POLARIZED_RES
    both = ("closest_hit", "any_hit")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="polarized_")
    launches = {}

    def stokes(nested: dict):
        return mi.load_dict({"type": "stokes", "nested": nested})

    def timed(tag, scene, spp, rows, integ=None, n_ch=15):
        img, counts, warm_s = timed_render(mi, reset, read, card, res, tag,
                                           scene, spp, 16, integ, rows,
                                           n_ch)
        return img, counts, warm_s

    def summary(tag, img):
        s0, s1, s2, s3 = (img[..., 3 + 3 * i:6 + 3 * i].sum(-1)
                          for i in range(4))
        lit = s0.abs() > 1e-3 * float(s0.abs().max())
        dolp = torch.sqrt(s1 * s1 + s2 * s2)[lit] / s0[lit].abs()
        docp = s3.abs()[lit] / s0[lit].abs()
        print(f"{tag}: mean degree of linear polarization "
              f"{float(dolp.mean()):.4g}, of circular {float(docp.mean()):.4g}"
              f" over {int(lit.sum())} lit pixels", flush=True)

    try:
        pbsdf = md.write_pbsdf(os.path.join(tmp, "pol.pbsdf"))
        mesh = {}
        for size in ("40k", "2k"):
            nu, nv = ANIMATED_SIZES[size]
            mesh[size] = os.path.join(tmp, f"sphere_{nu}x{nv}")
            write_uv_sphere_obj(mesh[size] + ".obj", nu, nv)
            write_uv_sphere_ply(mesh[size] + ".ply", nu, nv)
        sggx = os.path.join(tmp, "sggx.vol")
        ts.write_sggx_vol(sggx)
        def glass(size, spp, r, dv=None):
            d = glass_dict(mesh[size] + ".ply", spp, r)
            d["integrator"] = {"type": "stokes", "nested": d["integrator"]}
            return mi.load_dict(d, device=dv)

        def measured(size, spp, r, dv=None):
            return mi.load_dict(md.measured_polarized_sphere_dict(
                pbsdf, mesh[size] + ".obj", spp, r, integrator={
                    "type": "stokes",
                    "nested": {"type": "path", "max_depth": 4}}), device=dv)

        def media(spp, r, dv=None):
            d = ts.media_scene(sggx, spp, r)
            d["integrator"] = {"type": "stokes", "nested": d["integrator"]}
            return mi.load_dict(d, device=dv)

        # ---- (a) the canonical scene on the fast path ---------------------
        if canon_rgb is None:
            mi.set_variant("cuda_rgb")
            scene = mi.load_file(CANONICAL, spp=POLARIZED_CANON_SPP,
                                 resx=res, resy=res)
            rgb, rgb_counts, _ = timed(
                "canonical dopplertofpath (cuda_rgb)", scene,
                POLARIZED_CANON_SPP, {"B1": both}, n_ch=3)
            rgb_b1 = rgb_counts["B1"]
        else:
            rgb, rgb_b1 = canon_rgb
        mi.set_variant("cuda_rgb_polarized")
        scene = mi.load_file(CANONICAL, spp=POLARIZED_CANON_SPP, resx=res,
                              resy=res)
        fast, launches["canonical_fast_polarized"], _ = timed(
            "canonical dopplertofpath (cuda_rgb_polarized, fast path)",
            scene, POLARIZED_CANON_SPP, {"B1": both}, n_ch=3)
        same = bool(torch.equal(fast, rgb))
        fast_l = launches["canonical_fast_polarized"]["B1"]
        same_l = fast_l == rgb_b1
        print(f"canonical fast path against cuda_rgb: image equal bit for "
              f"bit {same}; B1 launches {fast_l} against {rgb_b1}: equal "
              f"{same_l}", flush=True)
        if not (same and same_l):
            fail("the polarized fast path differs from the cuda_rgb render")
        del rgb, fast

        # ---- (b) the full Mueller chain on the canonical scene ------------
        spp_m = POLARIZED_MUELLER_SPP
        scene = mi.load_file(CANONICAL, spp=spp_m, resx=res, resy=res)
        fast = mi.render(scene, spp=spp_m, seed=0)
        integ = stokes(scene.integrator)
        os.environ["MI_NO_DEPOL_FASTPATH"] = "1"
        try:
            full, launches["canonical_mueller_polarized"], warm_s = timed(
                "canonical stokes(dopplertofpath) (cuda_rgb_polarized, "
                "MI_NO_DEPOL_FASTPATH=1)", scene, spp_m, {"B1": both},
                integ)
        finally:
            del os.environ["MI_NO_DEPOL_FASTPATH"]
        scale = float(fast.abs().max())
        err = float((full[..., :3] - fast).abs().max())
        s_rest = float(full[..., 6:].abs().max())
        print(f"canonical Mueller S0 against the fast path at {spp_m} spp: "
              f"max abs diff {err:.3g} (scale {scale:.3g}, relative "
              f"{err / max(scale, 1e-30):.3g}); max |S1..S3| {s_rest:.3g}; "
              f"B1 launches {launches['canonical_mueller_polarized']['B1']}",
              flush=True)
        if not err <= 1e-6 * scale:
            fail("the Mueller canonical's S0 differs from the fast path")
        del scene, fast, full

        # ---- (c) glass 40k under stokes -----------------------------------
        scene = glass("40k", POLARIZED_SPP, res)
        img, launches["glass_polarized"], warm_s = timed(
            "glass 40k stokes(dopplertofpath) (cuda_rgb_polarized) through "
            "B2 and B1's sphere pass", scene, POLARIZED_SPP,
            {"B2": both, "B1": both})
        summary("glass 40k", img)
        # the idle share of one strip pass (the warm-up was one)
        one_pass = GLASS_PROFILE_SPP
        t0 = time.perf_counter()
        mi.render(scene, spp=one_pass, seed=0)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        idle = device_breakdown(mi, scene, one_pass, pass_s)
        print(f"glass 40k stokes, one strip pass ({res}x{res}x{one_pass}, "
              f"warm {pass_s:.3f} s): the card idles {100 * idle:.1f}% of it "
              f"({card})", flush=True)
        del scene, img

        # ---- (d) measured_polarized, rgb and spectral ---------------------
        for name in ("cuda_rgb_polarized", "cuda_spectral_polarized"):
            mi.set_variant(name)
            key = f"measured_{name.split('_')[1]}_polarized"
            img, launches[key], _ = timed(
                f"measured_polarized 40k stokes(path) ({name}) through B2",
                measured("40k", POLARIZED_SPP, res), POLARIZED_SPP,
                {"B2": both})
            summary(f"measured_polarized 40k ({name})", img)
        mi.set_variant("cuda_rgb_polarized")

        # ---- (e) the media scene under stokes(volpath) --------------------
        scene = media(16, res)
        mi.render(scene, spp=16, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mi.render(scene, spp=16, seed=0)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
        spp_v = next((s for s in POLARIZED_MEDIA_SPPS
                      if probe_s * s / 16 <= POLARIZED_MEDIA_BUDGET_S), 16)
        print(f"media stokes(volpath) probe 16 spp: warm {probe_s:.3f} s; "
              f"rendering at {spp_v} spp", flush=True)
        img, launches["media_polarized"], _ = timed(
            "media stokes(volpath) (cuda_rgb_polarized) through B1", scene,
            spp_v, {"B1": ("closest_hit",)})
        summary("media stokes(volpath)", img)
        del scene, img

        # ---- (f) Malus, a quarter-wave plate, card against the CPU --------
        t_step = time.perf_counter()
        for t2, expect in ((0.0, 0.5), (45.0, 0.25), (90.0, 0.0)):
            sc = mi.load_dict(ps.plate_scene(
                [({"type": "polarizer", "theta": 0.0}, 2.0),
                 ({"type": "polarizer", "theta": t2}, 1.0)], spp=16))
            s0 = float(mi.render(sc, spp=16, seed=0)[..., :3].mean())
            print(f"Malus: polarizers at 0 and {t2:g} degrees: S0 {s0:.6f} "
                  f"(expected {expect})", flush=True)
            if not abs(s0 - expect) < 1e-3:
                fail("Malus's law does not hold on the card")
        img = mi.render(mi.load_dict(ps.plate_scene(ps.QUARTER_WAVE,
                                                    spp=16)),
                        spp=16, seed=0).cpu().numpy()
        S = ps.stokes_channels(img)
        circ = np.abs(S[3]) / np.maximum(S[0], 1e-9)
        print(f"quarter-wave plate: |S3| / S0 {circ.min():.6f} (at least "
              "0.99)", flush=True)
        if not (circ > 0.99).all():
            fail("no circular light behind the quarter-wave plate")

        def canonical(integrator=None, stokes_on=True):
            xml = ps.polarizing_canonical_xml(stokes=stokes_on,
                                              integrator=integrator)

            def load(dv):
                return mi.load_string(xml, spp=16, resx=16, resy=16,
                                      device=dv)
            return load

        ptracer = ('<integrator type="ptracer"><integer name="max_depth" '
                   'value="4"/></integrator>')
        cases = (
            ("plates (polarizer, retarder, circular)", "cuda_rgb_polarized",
             lambda dv: mi.load_dict(ps.plate_scene(ps.ELEMENTS, spp=16,
                                                    res=16), device=dv),
             "B1"),
            ("polarizing canonical stokes(dopplertofpath)",
             "cuda_rgb_polarized", canonical(), "B1"),
            ("polarizing canonical stokes(dopplertofpath)",
             "cuda_spectral_polarized", canonical(), "B1"),
            ("polarizing canonical ptracer", "cuda_rgb_polarized",
             canonical(ptracer, False), "B1"),
            ("glass 2k stokes", "cuda_rgb_polarized",
             lambda dv: glass("2k", 16, 16, dv), "B2"),
            ("measured_polarized 2k stokes", "cuda_rgb_polarized",
             lambda dv: measured("2k", 16, 16, dv), "B2"),
            ("media stokes(volpath)", "cuda_rgb_polarized",
             lambda dv: media(16, 16, dv), "B1"))
        for label, name, load, row in cases:
            mi.set_variant(name)
            img_c = mi.render(load("cpu"), spp=16, seed=0).numpy()
            reset()
            img_g = mi.render(load(None), spp=16, seed=0).cpu().numpy()
            counts = read()
            if counts[row]["closest_hit"] <= 0:
                fail(f"{label} ({name}) card vs cpu: launches {counts}")
            scale = float(np.abs(img_c).max())
            close = np.isclose(img_g, img_c, rtol=1e-4, atol=1e-4 * scale)
            rel_mean = (abs(img_g.mean() - img_c.mean())
                        / max(abs(img_c.mean()), 1e-30))
            print(f"cuda vs cpu {label} ({name}) 16x16x16, {img_g.shape[-1]}"
                  f" channels: {close.mean() * 100:.2f}% of values within "
                  f"tolerance, mean rel diff {rel_mean:.3g}, max abs diff "
                  f"{float(np.abs(img_g - img_c).max()):.3g} (scale "
                  f"{scale:.3g})", flush=True)
            if (close.mean() < 0.99 or rel_mean > 1e-3 or scale <= 0.0
                    or not np.isfinite(img_g).all()):
                fail(f"cuda vs cpu {label} ({name}): outside tolerance")
        print(f"Malus, quarter-wave and card vs cpu, polarized: "
              f"{time.perf_counter() - t_step:.1f} s", flush=True)
    finally:
        mi.set_variant("cuda_rgb")
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


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
    alt_mod = {row: importlib.import_module(
        f"mitsuba3dopplertof_tpu_torch.ops.{name}")
        for row, _, name, _ in ALTERNATES}
    mxu = alt_mod["B6"]
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
    n_hmma = sass_count(alt_mod["B6"].LIBRARY, "HMMA")
    print(f"B6 ({alt_mod['B6'].LIBRARY.name}): {n_hmma} tensor-core "
          f"instructions (HMMA) in its SASS", flush=True)
    if n_hmma == 0:
        fail("B6's library holds no tensor-core instruction")

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

    # the main path's wavefronts: one strip pass of camera rays from the
    # middle of the frame (the top rows look out of the open box), its
    # shadow rays, its bounce rays and their shadow rays
    sa, b1_waves = b1_wavefronts(scene, ik, dev, n)
    cam_rays, shadow_rays = b1_waves["camera"], b1_waves["shadow"]

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
                             ("bounce (depth 2)", sa, b1_waves["bounce"]),
                             ("shadow (depth 2)", sa, b1_waves["shadow2"]),
                             ("spheres", sa_sph, sph_rays)):
        hk = ik.intersect(s_a, rays)
        torch.cuda.synchronize()
        hr = ik.intersect_reference(s_a, rays)
        torch.cuda.synchronize()
        err, n_tri, n_diff = check_hits(hk, hr, label, ik._SPH_SLOT_BASE)
        if n_diff:
            fail(f"B1 {label}: t differs from the plain version on {n_diff} "
                 f"triangle hits")
        if not torch.equal(hk.prim, hr.prim):
            fail(f"B1 {label}: prim differs on "
                 f"{int((hk.prim != hr.prim).sum())} lanes")
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
              f"{n_tri - n_diff}; occlusion equal on all lanes; prim equal "
              f"on all lanes", flush=True)

    # times on the main path's wavefronts: the kernel as the wrapper
    # launches it, and the plain version;
    # the slots a warp's gate passes; the bound from the gated walk's work
    # per warp, and the dense one (every lane tests every slot)
    n_tri_c = sa.n_static_tris + sa.n_anim_tris
    n_anim_c = len(sa.anim_ranges)
    tri_bytes = (n_tri_c * 25 * 4 + n_anim_c * 26 * 4
                 + 6 * 4 * (sa.n_static_tris + n_anim_c))
    b1_rows = {}
    for name, label, any_hit in B1_WAVEFRONTS:
        rays = b1_waves[name]
        n_l = rays.o.x.shape[0]
        k_ms = b1_time(ik, sa, rays, any_hit)
        plain = ik.ray_test_reference if any_hit else ik.intersect_reference
        p_ms = cuda_time_ms(lambda: plain(sa, rays), reps=5)
        per_warp, ops = b1_work(ik, sa, rays, any_hit)
        q = torch.quantile(per_warp.float(), 0.99).item()
        n_bytes = n_l * (32 + (4 if any_hit else 52)) + tri_bytes
        dense = bound(n_bytes, n_l * (n_tri_c * MOLLER_OPS
                                      + n_anim_c * INV_LERP_OPS))
        b_ms, b_by = bound(n_bytes, ops)
        b1_rows[name] = (k_ms, p_ms, (b_ms, b_by))
        print(f"B1 time {label} wavefront "
              f"({'any-hit' if any_hit else 'closest-hit'}) at {n_l} lanes, "
              f"{n_tri_c} triangles: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; dense {dense[0]:.4f} ms, "
              f"{dense[1]}); slots a warp tests: mean "
              f"{per_warp.float().mean().item():.2f}, p99 {q:.0f}, max "
              f"{int(per_warp.max())} of {n_tri_c + sa.n_spheres} ({card})",
              flush=True)
    b1 = {"closest_hit": b1_rows["camera"], "any_hit": b1_rows["shadow"]}

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

    def check_record(tag, out, ref, skip):
        """B3's hit record equal to the plain version's on every field,
        where the winning slot is equal (every hit lane, but the ``skip``
        lanes)."""
        same = (out[1] == ref[1]) & ~skip
        for f, a, b in zip(ik.HitRecord._fields, out, ref):
            n_bad = int((a[same] != b[same]).sum())
            if n_bad:
                fail(f"{tag}: {f} differs from the plain version on "
                     f"{n_bad} lanes")
        print(f"{tag}: all 13 fields equal on {int(same.sum())} lanes",
              flush=True)

    rows = ["B2"] + [row for row, *_ in ALTERNATES]
    errs_l = {row: {"closest_hit": 0.0, "any_hit": 0.0} for row in rows}
    plain_ms = {row: {} for row in rows}
    b2_rays = {}
    refs40 = {}
    refs40_b3 = {}
    refs40_b4 = {}
    for label, (obj, sc, sab) in big.items():
        waves, n_valid = strip_waves(sc, sab, MIDDLE_ROW, seed=1)
        (_, _, cam), (_, _, bounce), (_, _, shadow) = waves
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
                refs40[wname] = (t_r, p_r)
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
                                 any_hit, errs_l[row], skip,
                                 exact_prim=row in ("B4", "B5"))
                    if row == "B3" and not any_hit:
                        check_record(tag, out, ref, skip)
                if row == "B3" and label == "40k animated":
                    refs40_b3[wname] = (ref.t, ref.prim)
                if row == "B4" and label == "40k animated":
                    refs40_b4[wname] = (ref[0], ref[1], skip)
                del out, ref

    # times at the main path's shapes: the binned camera wavefront of the
    # 40k animated scene (closest-hit), its binned bounce wavefront
    # (closest-hit; B2 only) and its binned shadow wavefront (any-hit). B2
    # builds its visit lists in the kernel: its kernel time is its query.
    # The others: kernel launch alone over prepared inputs, their inputs
    # (prepare: the visit lists in PyTorch, B3's only padding) and the
    # query. Bounds from the work a plain walk needs (WalkWork). Then the
    # kernel's visit lists against _unit_visit_order on the same wavefronts,
    # and with a capacity that forces rounds, in the lists and in the walk.
    sa40 = big["40k animated"][2]
    cam40, shadow40, bounce40 = b2_rays["40k animated"]
    n_anim = len(sa40.anim_ranges)
    n_units40 = v4.v4_tables(sa40).n_units
    times_l = {row: {} for row in rows}
    for wname, any_hit, ray in (("camera", False, cam40),
                                ("bounce", False, bounce40),
                                ("shadow", True, shadow40)):
        form = "any_hit" if any_hit else "closest_hit"
        ray_s, pos = sort_wavefront(sa40, ray)
        t_ref, p_ref = (torch.empty_like(r) for r in refs40[wname])
        t_ref[pos], p_ref[pos] = refs40[wname]
        t_b3, p_b3 = (torch.empty_like(r) for r in refs40_b3[wname])
        t_b3[pos], p_b3[pos] = refs40_b3[wname]
        t_b4, p_b4, skip4 = (torch.empty_like(r) for r in refs40_b4[wname])
        t_b4[pos], p_b4[pos], skip4[pos] = refs40_b4[wname]
        walk = WalkWork(sa40, ray_s, t_ref, any_hit, t_b3, t_b4)
        n_lanes = ray_s.o.x.shape[0]
        ray_ops = n_lanes * n_anim * INV_LERP_OPS
        b2_t = b2_times(v4, sa40, ray_s, any_hit)
        print(walk_line("B2", wname, any_hit, b2_t, walk.b2_distribution(),
                        card), flush=True)
        b2_bound, need, distinct, list_ops = b2_walk_bound(walk, ray_ops)
        print(f"B2 bound {wname}: a walk needs {need} units over "
              f"{n_lanes // 32} warps ({need / (n_lanes // 32):.2f} per "
              f"warp, {distinct} distinct), its lists {list_ops:.4g} "
              f"operations; bound {b2_bound[0]:.4f} ms ({b2_bound[1]}) "
              f"({card})", flush=True)
        check_lists(v4, v4.v4_tables(sa40), n_units40, f"B2 40k {wname}",
                    ray_s)
        # B6: the chunks its warps' walks test, and the share of those
        # pairs that its gate passes (plain version, on a slice)
        need6, distinct6, _ = walk.work("B6")
        b6_pairs = need6 * 32 * mxu.T
        b6_n_bytes = b6_bytes(n_lanes, distinct6,
                              int(walk.b6_warps()[3].sum()))
        passed, gated = b6_gate_share(mxu, sa40, ray_s, walk)
        b6_share = (f"its gate passes {100 * passed / gated:.3f}% of those "
                    f"pairs ({passed} of {gated}) on the first {1 << 16} "
                    f"lanes (mxu_gate_reference)")
        print(f"B6 walk {wname} ({'any-hit' if any_hit else 'closest-hit'}):"
              f" a plain walk tests {need6} chunks over {n_lanes // 32} "
              f"warps ({need6 / (n_lanes // 32):.2f} per warp, {distinct6} "
              f"distinct), {b6_pairs} pairs; {b6_share}", flush=True)
        b3_b, b3_walk = b3_bound(walk, ray_ops)
        print(f"B3 walk {wname} ({'any-hit' if any_hit else 'closest-hit'}):"
              f" {b3_walk}", flush=True)
        # B4: its in-kernel lists against _visit_order; its times beside
        # its bound per warp (WalkWork.b4_warps) and the earlier per-block
        # one (WalkWork.work)
        tb2 = alt_mod["B4"].v2_tables(sa40)
        check_lists(alt_mod["B4"], tb2, tb2.n_chunks, f"B4 40k {wname}",
                    ray_s, what="chunks")
        b4_t = b4_times(alt_mod["B4"], sa40, ray_s, any_hit)
        b4_b, b4_walk = b4_bound(walk, ray_ops)
        need4, distinct4, _ = walk.work("B4")
        b4_block = bound(n_lanes * (32 + 8) + distinct4 * 9 * 128 * 4
                         + need4 * (8 + 8 + 24),
                         need4 * walk.BLOCK * 32 * MOLLER_OPS + ray_ops)
        plain4 = ("" if wname == "bounce" else
                  f", plain {plain_ms['B4'][form]:.3f} ms")
        print(b4_line("B4 time", wname, any_hit, b4_t, n_lanes, card,
                      f"{plain4}; {b4_walk}; bound per warp {b4_b[0]:.4f} ms "
                      f"({b4_b[1]}); per 256-lane block {b4_block[0]:.4f} ms "
                      f"({need4} quarters)"), flush=True)
        # B5: its times beside its bound per warp (WalkWork.b5_warps), the
        # units its per-lane test leaves beside those of B2's warp gate on
        # the same lists, and B2's bound
        v3m = alt_mod["B5"]
        b5_t = b5_times(v3m, v4, sa40, ray_s, any_hit)
        b5_b, b5_walk = b5_bound(walk, ray_ops, b2_bound)
        plain5 = ("" if wname == "bounce" else
                  f", plain {plain_ms['B5'][form]:.3f} ms")
        print(b5_line("B5 time", wname, any_hit, b5_t, n_lanes, card,
                      f"{plain5}; {b5_walk}; bound per warp {b5_b[0]:.4f} "
                      f"ms ({b5_b[1]})"), flush=True)
        if wname == "bounce":
            k_ms, q_ms = b3_times(alt_mod["B3"], sa40, ray_s, False)
            print(f"B3 time bounce (closest-hit) at {n_lanes} lanes (binned),"
                  f" 40k animated: kernel {k_ms:.4f} ms, query {q_ms:.4f} "
                  f"ms; bound {b3_b[0]:.4f} ms ({b3_b[1]}) ({card})",
                  flush=True)
            # rounds: B3's group lists with a capacity of 16 entries
            st3 = alt_mod["B3"]
            tb3 = st3.stream_tables(sa40)
            out = st3.launch(tb3, st3.prepare(tb3, ray_s), False, cap=16)
            torch.cuda.synchronize()
            check_t_prim(f"B3 40k bounce binned closest-hit, capacity 16 "
                         f"({-(-tb3.n_chunks // 8 // 16)} rounds at most)",
                         out[0], out[1], t_b3, p_b3, False, errs_l["B3"],
                         zero_area_winner(sa40, p_b3))
            del out
            k_ms, q_ms = b6_times(mxu, sa40, ray_s, False)
            b_cc, b_tc = b6_bounds(b6_pairs, ray_ops, b6_n_bytes)
            print(f"B6 time bounce (closest-hit) at {n_lanes} lanes (binned),"
                  f" 40k animated: kernel {k_ms:.4f} ms, query {q_ms:.4f} "
                  f"ms; bound {b_cc[0]:.4f} ms ({b_cc[1]}) on the CUDA "
                  f"cores, {b_tc[0]:.4f} ms ({b_tc[1]}) with the tensor "
                  f"cores ({card})", flush=True)
            # rounds: B4's lists and walk with a capacity of 16 chunks
            check_lists(alt_mod["B4"], tb2, tb2.n_chunks, f"B4 40k {wname}",
                        ray_s, cap=16, what="chunks")
            t_k, p_k = alt_mod["B4"].launch(tb2, ray_s, False, cap=16)
            torch.cuda.synchronize()
            check_t_prim("B4 40k bounce binned closest-hit, capacity 16",
                         t_k, p_k, t_b4, p_b4, False, errs_l["B4"], skip4,
                         exact_prim=True)
            # rounds: lists and walk with a capacity of 100 entries
            check_lists(v4, v4.v4_tables(sa40), n_units40,
                        f"B2 40k {wname}", ray_s, cap=100)
            t_k, p_k = v4.launch(v4.v4_tables(sa40), ray_s, False, cap=100)
            torch.cuda.synchronize()
            check_t_prim("B2 40k bounce binned closest-hit, capacity 100",
                         t_k, p_k, t_ref, p_ref, False, errs_l["B2"])
            # rounds: B5's walk with lists of 16 units a round
            for ah in (False, True):
                t_k, p_k = v3m.launch(v4.v4_tables(sa40), ray_s, ah, cap=16)
                torch.cuda.synchronize()
                check_t_prim(f"B5 40k bounce binned "
                             f"{'any-hit' if ah else 'closest-hit'}, "
                             f"capacity 16 ({-(-n_units40 // 16)} rounds at "
                             f"most)", t_k, p_k, t_ref, p_ref, ah,
                             errs_l["B5"], exact_prim=True)
            del walk, ray_s, t_ref, p_ref, t_b3, p_b3, t_b4, p_b4, skip4
            del t_k, p_k
            continue
        times_l["B2"][form] = (b2_t[0], plain_ms["B2"][form], b2_bound)
        times_l["B4"][form] = (b4_t[0], plain_ms["B4"][form], b4_b)
        times_l["B5"][form] = (b5_t[0], plain_ms["B5"][form], b5_b)
        for row in ("B3", "B6"):
            tables, prepare, isect, _ = alt_fn[row]
            tables = tables(sa40)
            mod = alt_mod[row]
            prep = prepare(tables, ray_s)
            k_ms = cuda_time_ms(lambda: mod.launch(tables, prep, any_hit))
            prep_ms = cuda_time_ms(lambda: prepare(tables, ray_s), reps=5)
            q_ms = cuda_time_ms(lambda: isect(sa40, ray_s, any_hit=any_hit),
                                reps=5)
            del prep
            need, distinct, what = walk.work(row)
            n_bytes = b6_n_bytes
            n_ops = b6_pairs * WOOP_OPS + ray_ops
            times_l[row][form] = (k_ms, plain_ms[row][form],
                                  b3_b if row == "B3" else
                                  bound(n_bytes, n_ops))
            b_ms, b_by = times_l[row][form][2]
            extra = ""
            if row == "B6":
                b_cc, b_tc = b6_bounds(b6_pairs, ray_ops, n_bytes)
                extra = (f"; {b6_share}; tensor-core bound "
                         f"{b_tc[0]:.4f} ms ({b_tc[1]})")
                times_l[row][form] = (k_ms, plain_ms[row][form],
                                      min(b_cc, b_tc))
            print(f"{row} time {form} at {n_lanes} lanes (binned), 40k "
                  f"animated: kernel {k_ms:.4f} ms, its inputs "
                  f"({prepare.__module__.split('.')[-1]}.prepare) "
                  f"{prep_ms:.3f} ms, query {q_ms:.4f} ms, plain "
                  f"{plain_ms[row][form]:.3f} ms; a plain walk needs {need} "
                  f"{what} over {n_lanes // 32} warps "
                  f"({need / (n_lanes // 32):.1f} per warp, "
                  f"{distinct} distinct records); "
                  f"bound {b_ms:.4f} ms ({b_by}){extra} ({card})",
                  flush=True)
        del walk, ray_s, t_ref, p_ref, t_b3, p_b3, t_b4, p_b4, skip4
    # what binning saves: the units a closest-hit walk of the bounce
    # wavefront needs per 256-lane block, in the wavefront's own order and
    # binned
    bounce_s, pos = sort_wavefront(sa40, bounce40)
    t_ref = torch.empty_like(refs40["bounce"][0])
    t_ref[pos] = refs40["bounce"][0]
    per_block = [WalkWork(sa40, r, t, False).block_units()
                 / (WAVEFRONT // WalkWork.BLOCK)
                 for r, t in ((bounce40, refs40["bounce"][0]),
                              (bounce_s, t_ref))]
    print(f"bounce wavefront, units a walk needs per block: unbinned "
          f"{per_block[0]:.1f}, binned {per_block[1]:.1f}", flush=True)
    del bounce_s, t_ref
    del b2_rays, cam40, shadow40, bounce40, refs40, refs40_b3, refs40_b4

    # ---- 4a. the lower strip of the 40k frame -----------------------------
    # camera rays of pixel rows LOWER_ROW.. that pass under the sphere's
    # lower half to the floor, and their bounce and shadow rays, binned: B3,
    # B4 and B5 against their plain versions (t bitwise, prim equal, B3's
    # record equal where prim is, occlusion exact), their kernel and query
    # times and their bounds; B2's times and walk as a measurement
    st3, v2m, v3m = alt_mod["B3"], alt_mod["B4"], alt_mod["B5"]
    waves_lo, n_valid = strip_waves(big["40k animated"][1], sa40, LOWER_ROW,
                                    seed=5)
    print(f"40k lower strip, pixel rows {LOWER_ROW}-{LOWER_ROW + 15}: "
          f"camera wavefront {WAVEFRONT} lanes, {n_valid} hit", flush=True)
    for wname, any_hit, ray in waves_lo:
        ray_s, _ = sort_wavefront(sa40, ray)
        ref, p_ms = timed_ms(lambda: st3.intersect_stream_reference(sa40,
                                                                    ray_s))
        skip = zero_area_winner(sa40, ref.prim)
        for ah in (False, True):
            out = st3.intersect_stream(sa40, ray_s, any_hit=ah)
            torch.cuda.synchronize()
            tag = (f"B3 40k lower {wname} binned "
                   f"{'any-hit' if ah else 'closest-hit'}")
            check_t_prim(tag, out[0], out[1], ref.t, ref.prim, ah,
                         errs_l["B3"], skip)
            if not ah:
                check_record(tag, out, ref, skip)
        del out
        ref4, p4_ms = timed_ms(lambda: v2m.intersect_v2_reference(sa40,
                                                                 ray_s))
        skip4 = zero_area_winner(sa40, ref4[1])
        for ah in (False, True):
            out = v2m.intersect_v2(sa40, ray_s, any_hit=ah)
            torch.cuda.synchronize()
            check_t_prim(f"B4 40k lower {wname} binned "
                         f"{'any-hit' if ah else 'closest-hit'}", out[0],
                         out[1], ref4[0], ref4[1], ah, errs_l["B4"], skip4,
                         exact_prim=True)
        del out
        (t5, p5), p5_ms = timed_ms(lambda: v4.intersect_v4_reference(sa40,
                                                                    ray_s))
        for ah in (False, True):
            out = v3m.intersect_v3(sa40, ray_s, any_hit=ah)
            torch.cuda.synchronize()
            check_t_prim(f"B5 40k lower {wname} binned "
                         f"{'any-hit' if ah else 'closest-hit'}", out[0],
                         out[1], t5, p5, ah, errs_l["B5"], exact_prim=True)
        del out
        walk = WalkWork(sa40, ray_s, t5, any_hit, t_b3=ref.t, t_b4=ref4[0])
        n_lanes = ray_s.o.x.shape[0]
        ray_ops = n_lanes * n_anim * INV_LERP_OPS
        b5_b, b5_walk = b5_bound(walk, ray_ops,
                                 b2_walk_bound(walk, ray_ops)[0])
        print(b5_line("B5 time", f"lower {wname}", any_hit,
                      b5_times(v3m, v4, sa40, ray_s, any_hit), n_lanes, card,
                      f", plain {p5_ms:.3f} ms; {b5_walk}; bound per warp "
                      f"{b5_b[0]:.4f} ms ({b5_b[1]})"), flush=True)
        b4_b, b4_walk = b4_bound(walk, ray_ops)
        print(b4_line("B4 time", f"lower {wname}", any_hit,
                      b4_times(v2m, sa40, ray_s, any_hit), n_lanes, card,
                      f", plain {p4_ms:.3f} ms; {b4_walk}; bound per warp "
                      f"{b4_b[0]:.4f} ms ({b4_b[1]})"), flush=True)
        b3_b, b3_walk = b3_bound(walk, ray_ops)
        k_ms, q_ms = b3_times(st3, sa40, ray_s, any_hit)
        print(f"B3 time lower {wname} "
              f"({'any-hit' if any_hit else 'closest-hit'}) at {n_lanes} "
              f"lanes (binned), 40k animated: kernel {k_ms:.4f} ms, query "
              f"{q_ms:.4f} ms, plain {p_ms:.3f} ms; {b3_walk}; bound "
              f"{b3_b[0]:.4f} ms ({b3_b[1]}) ({card})", flush=True)
        print(walk_line("B2", f"lower {wname}", any_hit,
                        b2_times(v4, sa40, ray_s, any_hit),
                        walk.b2_distribution(), card), flush=True)
        del walk, ray_s, ref, skip, ref4, skip4, t5, p5
    del waves_lo

    # ---- 4b. B2 on the 100k animated scene: a 65,536-lane slice -------------
    # of its camera wavefront and that slice's bounce and shadow rays,
    # binned: the kernel's lists against _unit_visit_order (all units in
    # one round, and in rounds of 1,024), and B2 against its plain version
    nu, nv = ANIMATED_SIZES["100k"]
    obj100 = str(scene_dir / f"sphere_{nu}x{nv}.obj")
    write_uv_sphere_obj(obj100, nu, nv)
    sc100 = mi.load_dict(animated_mesh_scene(obj100, spp=256))
    sa100 = sc100.compile()
    W, H = sc100.sensor.film.crop_size
    n_sl = 1 << 16
    cam100 = camera_wavefront(sc100, n_sl, (H // 2) * W * 256, 256, 0.0015,
                              seed=3)
    shadow100, bounce100, n_valid = secondary_wavefronts(sa100, cam100,
                                                         seed=4)
    print(f"scene 100k animated: {sa100.n_static_tris + sa100.n_anim_tris} "
          f"triangles, {v4.v4_tables(sa100).n_units} units; slice of "
          f"{n_sl} camera lanes, {n_valid} hit", flush=True)
    for wname, ray in (("camera", cam100), ("bounce", bounce100),
                       ("shadow", shadow100)):
        ray_s, _ = sort_wavefront(sa100, ray)
        tb100 = v4.v4_tables(sa100)
        check_lists(v4, tb100, tb100.n_units, f"B2 100k {wname}", ray_s)
        check_lists(v4, tb100, tb100.n_units, f"B2 100k {wname}", ray_s,
                    cap=1024)
        t_r, p_r = v4.intersect_v4_reference(sa100, ray_s)
        for any_hit in (False, True):
            t_k, p_k = v4.intersect_v4(sa100, ray_s, any_hit=any_hit)
            torch.cuda.synchronize()
            check_t_prim(f"B2 100k {wname} binned "
                         f"{'any-hit' if any_hit else 'closest-hit'}",
                         t_k, p_k, t_r, p_r, any_hit, errs_l["B2"])
        del ray_s, t_r, p_r, t_k, p_k
    del sc100, sa100, cam100, shadow100, bounce100

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
    canon_rgb = (img, dict(launches_c["B1"]))

    # ---- 6. the main path, large scene: B2, then each alternate route ----
    obj40 = big["40k animated"][0]
    row_of = {"v4": "B2", **{route: row for row, route, _, _ in ALTERNATES}}
    launches_l = {}
    for route, row in row_of.items():
        img, img2, first_s, warm_s, counts = render_40k(
            mi, obj40, route, reset_counts, read_counts)
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

    # ---- 9. the rest of the Doppler core ----------------------------------
    doppler_core_phase(mi, obj40, obj2k, reset_counts, read_counts, card)

    # ---- 10. the hero scene ----------------------------------------------
    hero = hero_phase(mi, reset_counts, read_counts, card)

    # ---- 11. the scene dialect's surfaces and lights ----------------------
    dialect = dialect_phase(mi, reset_counts, read_counts, card)

    # ---- 12. the rgb variant's other integrators ---------------------------
    integrators = integrators_phase(mi, reset_counts, read_counts, card)

    # ---- 13. textured surfaces and lights, the other phases ---------------
    textured = textured_phase(mi, reset_counts, read_counts, card)

    # ---- 14. the spectral and mono variants, the measured BSDF -------------
    spectral = spectral_phase(mi, reset_counts, read_counts, card,
                              launches_c["B1"])

    # ---- 15. the polarized variants ----------------------------------------
    polarized = polarized_phase(mi, reset_counts, read_counts, card,
                                canon_rgb)

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
    # the launches of phase 11's to 15's renders, under the kernels they
    # ran
    dialect_rows = {"intersect_bruteforce": "B1", "intersect_v4": "B2"}
    for name, src, tpu, times, launches, errs_k in entries:
        for form in ("closest_hit", "any_hit"):
            k_ms, p_ms, (b_ms, b_by) = times[form]
            kernels.append({
                "name": f"{name} ({form.replace('_', '-')})",
                "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[form], "max_abs_err": errs_k[form],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None})
            if name in dialect_rows:
                for scene_name, counts in (*dialect.items(),
                                           *integrators.items(),
                                           *textured.items(),
                                           *spectral.items(),
                                           *polarized.items()):
                    if dialect_rows[name] in counts:
                        kernels[-1][f"launches_{scene_name}"] = counts[
                            dialect_rows[name]][form]
    kernels += hero_entries(hero)
    print(f"wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def spectral_main(phase=None) -> int:
    """``--spectral``: the card, the build and phase 14 alone (no kernel
    line, no contract line): a quick check of the spectral path; with
    ``phase`` (``--polarized``: ``polarized_phase``) that phase instead."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    sys.path.insert(0, ROOT)
    card = card_line()
    print(card, flush=True)
    import mitsuba3dopplertof_tpu_torch as mi
    from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as ik
    from mitsuba3dopplertof_tpu_torch.ops import intersect_v4 as v4
    from mitsuba3dopplertof_tpu_torch.ops.cuda_build import build_all
    counted = {"B1": ik, "B2": v4, **{row: importlib.import_module(
        f"mitsuba3dopplertof_tpu_torch.ops.{name}")
        for row, _, name, _ in ALTERNATES}}
    build_all([m.LIBRARY for m in counted.values()])

    def reset_counts():
        for m in counted.values():
            m.reset_launch_counts()

    def read_counts():
        return {row: dict(m.LAUNCHES_BY_FORM) for row, m in counted.items()}
    t0 = time.perf_counter()
    (phase or spectral_phase)(mi, reset_counts, read_counts, card)
    print(f"wall {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] == "--spectral":
        sys.exit(spectral_main())
    if len(sys.argv) == 2 and sys.argv[1] == "--polarized":
        sys.exit(spectral_main(polarized_phase))
    if len(sys.argv) == 3 and sys.argv[1] == "--b2-walk":
        sys.exit(b2_walk_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--b1-walk":
        sys.exit(b1_walk_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--b6-walk":
        sys.exit(b6_walk_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--b3-walk":
        sys.exit(b3_walk_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--b4-walk":
        sys.exit(b4_walk_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--b5-walk":
        sys.exit(b5_walk_main(sys.argv[2]))
    if len(sys.argv) != 1:
        fail("usage: chip_smoke.py [--spectral | --polarized | "
             "--b2-walk CHECKOUT | "
             "--b1-walk CHECKOUT | --b6-walk CHECKOUT | --b3-walk CHECKOUT | "
             "--b4-walk CHECKOUT | --b5-walk CHECKOUT]")
    sys.exit(main())
