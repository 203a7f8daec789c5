// Kernel B2: closest-hit / any-hit (t, prim) over 32-triangle Woop units,
// walked front to back per block of rays, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_v4.py
// `_build_v4_kernel` (Pallas, reached through `_v4_call` / `intersect_v4`)
// together with the visit lists that the JAX package builds outside it
// (`intersect_v3._unit_visit_order`). It computes the same function as that
// kernel and as the plain PyTorch version `intersect_v4_reference` in
// mitsuba3dopplertof_tpu_torch/ops/intersect_v4.py. Each unit holds 32
// triangles as 12 Woop coefficients each (the rows of [e1 | e2 | n]^-1 and
// their offsets). A unit of an animated range is tested with the lane's ray
// moved into object space by the inverse of the keyframe-lerped 3x4 matrix
// at the lane's own time.
//
// What bounds it on this card: arithmetic. Each unit a warp tests costs
// each of its lanes 32 ray-triangle tests of about 48 float operations; the
// rays (32 bytes in, 8 out per lane) and the unit boxes are read once, the
// Woop records (1.5 KB per unit) once per warp that tests the unit, from L1
// and L2.
//
// What the design does about it:
//  * The lists are built in the kernel. One CTA of 256 threads owns one
//    block of 256 lanes. It clamps each lane's maxt by the scene-box exit
//    (`scene_box_exit`'s order of operations), reduces the block's ray
//    bounds, slab-tests every unit box against them (`_slab_visit_order`'s
//    algebra) and sorts the reachable units by (t_lo, unit) in shared
//    memory with a bitonic network: the order of a stable argsort (the
//    network and its rounds are intersect_common.cuh's list_sort and
//    list_round, shared with B3).
//  * Capacity: the sorted list holds at most `cap` entries (a launch
//    argument up to kMaxCap). Where more units are reachable the kernel
//    works in rounds: each round takes the next <= cap keys after the last
//    (t_lo, unit) it took, so the walk is exact at any scene size.
//  * Warp-granular bounds: the walk of warp a's 32 lanes goes down the
//    list on their own bound (the largest min(t, maxt) of the 32; -3e38 for
//    an any-hit lane with a hit), with no CTA barrier per unit, and skips a
//    unit whose box those 32 rays cannot enter within it (the block's slab
//    test on the warp's ray bounds).
//  * The tail is split: every warp's walk is shared by all 8 warps of the
//    CTA. Entry p of warp a's walk goes to warp p mod 8, which loads a's
//    rays, so a long walk (a lane that escapes the scene, a lit shadow
//    lane) runs on the whole CTA instead of one warp. The lanes' results
//    meet in shared memory by a 64-bit atomicMin of (float bits of t) << 32
//    | prim, read back before each entry as the walk's bound: t > 0 on
//    every hit, so its bits order as an unsigned integer, and the smaller
//    prim wins at equal t, which is the plain version's rule (strict
//    t < best in slot order); prim equals the plain version's on every
//    closest-hit lane. A warp stages each unit's record in its own slot of
//    shared memory (three coalesced 16-byte loads a lane) and reads the
//    triangles back as broadcasts. The walk and the list code are
//    intersect_common.cuh's (unit_walk with the warp gate on), which B5
//    (intersect_v3.cu) runs with a per-lane gate of its own.
// The file is built with --fmad=false: every product and sum rounds on its
// own, in the plain version's order, so t on hit lanes matches it bit for
// bit; degenerate and pad triangles have zero rows, t = -0/0 is NaN, and
// every comparison rejects it.

#include "intersect_common.cuh"

namespace {

typedef unsigned long long u64;

using mi::kBig;
using mi::kBlock;
using mi::units::kBounds;
using mi::units::kGate;
using mi::units::kMaxCap;
using mi::kWarps;
using mi::units::launch_walk;
using mi::units::load_lane;
using mi::units::make_rays;
using mi::units::make_scene;
using mi::units::ray_bounds;
using mi::units::Rays;
using mi::units::Scene;
using mi::units::unit_key;
using mi::units::unit_walk;

// The walk (intersect_common.cuh's unit_walk, which B5 shares): each warp
// on its own bound, skipping a unit whose box the warp's 32 rays cannot
// enter within it (warp_gate).
template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    v4_walk_kernel(Scene sc, Rays ry, float* t_out, int* prim_out) {
  extern __shared__ u64 s_list[];
  unit_walk<kAnyHit, true, false>(sc, ry, t_out, prim_out, s_list);
}

// The visit lists alone (a check of the walk's lists, not a path): per
// block the reachable units sorted by (t_lo, unit), then the unreachable
// ones in index order with key 3e38 -- the rows of a stable argsort of the
// keys -- and the number reachable.
__global__ void __launch_bounds__(kBlock)
    v4_lists_kernel(Scene sc, Rays ry, int* order_out, float* tlo_out,
                    int* len_out) {
  extern __shared__ u64 s_list[];
  __shared__ float s_part[kWarps * 13];
  __shared__ float s_bb[kBounds];
  __shared__ float s_gate[kWarps * kGate];
  __shared__ int s_count[kWarps];
  __shared__ int s_n, s_more;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)blockIdx.x * kBlock;
  float w[6], time, maxt;
  load_lane(ry, sc.scene_box, base + tid, w, &time, &maxt);
  ray_bounds(w, maxt, s_part, s_bb, s_gate + warp * kGate);
  int* order = order_out + (long long)blockIdx.x * sc.n_units;
  float* tlo = tlo_out + (long long)blockIdx.x * sc.n_units;

  int written = 0;
  bool has_last = false;
  u64 last = 0;
  for (;;) {
    const int m = mi::list_round(
        sc.n_units, sc.cap,
        [&](int u) { return unit_key(s_bb, sc.box + 6LL * u); }, has_last,
        last, s_list, &s_n, &s_more);
    const bool more = s_more != 0;
    for (int i = tid; i < m; i += kBlock) {
      const int unit = mi::list_item(s_list[i]);
      order[written + i] = unit;
      tlo[written + i] = unit_key(s_bb, sc.box + 6LL * unit);
    }
    written += m;
    if (!more) break;
    last = s_list[m - 1];
    has_last = true;
    __syncthreads();
  }
  if (tid == 0) len_out[blockIdx.x] = written;
  for (int u0 = 0; u0 < sc.n_units; u0 += kBlock) {
    const int u = u0 + tid;
    const bool out = u < sc.n_units && !(unit_key(s_bb, sc.box + 6LL *
                                                    min(u, sc.n_units - 1))
                                         < kBig);
    const unsigned bal = __ballot_sync(0xffffffffu, out);
    if (lane == 0) s_count[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int q = 0; q < kWarps; ++q) {
      off += q < warp ? s_count[q] : 0;
      total += s_count[q];
    }
    if (out) {
      const int at = written + off + __popc(bal & ((1u << lane) - 1u));
      order[at] = u;
      tlo[at] = kBig;
    }
    written += total;
    __syncthreads();
  }
}

}  // namespace

extern "C" int mi_intersect_v4_block() { return kBlock; }
extern "C" int mi_intersect_v4_max_cap() { return kMaxCap; }

// Launch on `stream` over n lanes, one CTA per block of kBlock lanes (the
// last one ragged), with lists of at most `cap` entries a round; returns
// cudaGetLastError() of the launch (0 = ok).
extern "C" int mi_intersect_v4(
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
  return any_hit ? launch_walk(v4_walk_kernel<true>, sc, ry, t, prim, s)
                 : launch_walk(v4_walk_kernel<false>, sc, ry, t, prim, s);
}

// The visit lists of the n lanes' blocks: order_out and tlo_out (n_blocks,
// n_units), len_out (n_blocks,) reachable units per block.
extern "C" int mi_intersect_v4_lists(
    const void* box, const void* scene_box, int n_units, int cap,
    const void* ox, const void* oy, const void* oz, const void* dx,
    const void* dy, const void* dz, const void* time, const void* maxt,
    long long n, void* order_out, void* tlo_out, void* len_out,
    void* stream) {
  if (n <= 0 || n_units <= 0 || cap <= 0 || cap > kMaxCap)
    return (int)cudaErrorInvalidValue;
  Scene sc = make_scene(nullptr, nullptr, nullptr, box, scene_box, n_units,
                        0, cap);
  Rays ry = make_rays(ox, oy, oz, dx, dy, dz, time, maxt, n);
  unsigned int blocks = (unsigned int)((n + kBlock - 1) / kBlock);
  size_t bytes;
  int err;
  if ((err = mi::list_bytes(v4_lists_kernel, n_units, cap, &bytes)))
    return err;
  v4_lists_kernel<<<blocks, kBlock, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      sc, ry, static_cast<int*>(order_out), static_cast<float*>(tlo_out),
      static_cast<int*>(len_out));
  return (int)cudaGetLastError();
}
