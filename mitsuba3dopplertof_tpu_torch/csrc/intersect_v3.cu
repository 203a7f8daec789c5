// Kernel B5: closest-hit / any-hit (t, prim) over 32-triangle Woop units,
// walked front to back one unit a step with a per-lane gate ahead of each
// unit, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_v3.py
// `_build_v3_kernel` (Pallas, reached through `intersect_v3`) together with
// the visit lists that the JAX package builds outside it
// (`_unit_visit_order`). It computes the same function as that kernel and as
// the plain PyTorch version `intersect_v3_reference` (= B2's
// `intersect_v4_reference`) of mitsuba3dopplertof_tpu_torch/ops/
// intersect_v3.py, over B2's tables: 12 Woop coefficients per triangle, 32
// triangles per unit, triangle-major (`V4Tables.woop_tri`), the unit boxes
// covering an animated unit's motion over the shutter.
//
// What bounds it on this card: arithmetic. Each unit a warp tests costs
// each of its lanes 32 Woop tests of about 48 float operations; the rays
// (32 bytes in, 8 out per lane) and the unit boxes are read once, a unit's
// record (1.5 KB) once per warp that tests it, from L1 and L2. What a walk
// must test sets the time: the TPU kernel re-tested each unit's box against
// the block's ray bounds and its shrinking bound, because a gate per unit
// cost it scalar-pipeline time; on this card a gate costs little beside 32
// Woop tests, so it can be taken down to one ray.
//
// What the design does about it:
//  * The lists are B2's, built in the kernel: one CTA of 256 threads per
//    block of 256 lanes clamps each lane's maxt by the scene-box exit,
//    slab-tests every unit box against the block's ray bounds and sorts the
//    reachable units by (t_lo, unit) in shared memory, in rounds of at most
//    `cap` entries (intersect_common.cuh's load_lane, ray_bounds, unit_key,
//    list_round), so no visit list is built in PyTorch.
//  * The walk is B2's (intersect_common.cuh's unit_walk): each warp goes
//    down the list on its own bound, and every warp's walk is shared by the
//    CTA's 8 warps entry by entry (entry p of warp a's walk to warp p mod 8,
//    which loads a's rays); results meet by a 64-bit atomicMin of (t bits,
//    prim) in shared memory, read back before each entry.
//  * The gate ahead of a unit is B5's own: each lane tests its own world
//    ray against the unit's world box within its own far end (closest-hit
//    min(best t as read back, maxt), any-hit maxt while it has no hit), and
//    the warp skips the unit, unstaged and with no ray moved into object
//    space, unless some lane passes (`__ballot_sync`). Diffuse bounce rays,
//    whose directions straddle zero on most axes, defeat a gate on the
//    warp's ray bounds; one ray's test does not. The lane's reciprocal
//    direction is computed once per walk. The test is conservative in
//    float32 (lane_box: Ize's scaled far side, NaN where the origin lies in
//    a face plane of a zero direction component passes), so a unit that
//    holds a lane's hit is never skipped and t stays the plain version's.
//  * Measured on an NVIDIA H100 (chip_smoke.py --b5-walk) and left out:
//    B2's gate on the warp's ray bounds ahead of the per-lane one (6-19%
//    slower), and a vote of the warp after each triangle's t that leaves
//    it where no lane can take it (B4's vote, after u there; up to 9%
//    slower here).
// Built with --fmad=false: t on hit lanes matches the plain version bit for
// bit, and prim too (the smallest slot among equal t); zero rows of
// degenerate and pad triangles give t = NaN, which every comparison
// rejects.

#include "intersect_common.cuh"

namespace {

using mi::kBlock;
using mi::units::kMaxCap;
using mi::units::launch_walk;
using mi::units::make_rays;
using mi::units::make_scene;
using mi::units::Rays;
using mi::units::Scene;
using mi::units::unit_walk;

// The walk (intersect_common.cuh's unit_walk, B2's) with the per-lane
// ballot in place of B2's warp gate.
template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    v3_walk_kernel(Scene sc, Rays ry, float* t_out, int* prim_out) {
  extern __shared__ mi::u64e s_list[];
  unit_walk<kAnyHit, false, true>(sc, ry, t_out, prim_out, s_list);
}

}  // namespace

extern "C" int mi_intersect_v3_block() { return kBlock; }
extern "C" int mi_intersect_v3_max_cap() { return kMaxCap; }

// Launch on `stream` over n lanes, one CTA per block of kBlock lanes (the
// last one ragged), with lists of at most `cap` entries a round; returns
// cudaGetLastError() of the launch (0 = ok). The arguments are B2's
// (mi_intersect_v4).
extern "C" int mi_intersect_v3(
    const void* woop, const void* meta, const void* inst, const void* box,
    const void* scene_box, int n_units, int has_anim, int cap,
    const void* ox, const void* oy, const void* oz, const void* dx,
    const void* dy, const void* dz, const void* time, const void* maxt,
    long long n, int any_hit, void* t_out, void* prim_out, void* stream) {
  if (n <= 0 || n_units <= 0 || cap <= 0 || cap > kMaxCap)
    return (int)cudaErrorInvalidValue;
  const Scene sc = make_scene(woop, meta, inst, box, scene_box, n_units,
                              has_anim, cap);
  const Rays ry = make_rays(ox, oy, oz, dx, dy, dz, time, maxt, n);
  float* t = static_cast<float*>(t_out);
  int* prim = static_cast<int*>(prim_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch_walk(v3_walk_kernel<true>, sc, ry, t, prim, s)
                 : launch_walk(v3_walk_kernel<false>, sc, ry, t, prim, s);
}
