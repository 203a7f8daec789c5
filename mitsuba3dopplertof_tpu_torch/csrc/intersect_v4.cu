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
//    triangles back as broadcasts.
// The file is built with --fmad=false: every product and sum rounds on its
// own, in the plain version's order, so t on hit lanes matches it bit for
// bit; degenerate and pad triangles have zero rows, t = -0/0 is NaN, and
// every comparison rejects it.

#include "intersect_common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 256;            // lanes per CTA = lanes per list
constexpr int kWarps = kBlock / 32;
constexpr int kChunk = 32;             // triangles per unit
constexpr int kInstRec = 26;           // m0 (3x4) | m1 (3x4) | t0 | t1
constexpr int kMaxCap = 4096;          // largest list a round may hold
constexpr int kGate = 15;              // per warp and axis: ol oh ia ib same
constexpr int kBounds = 22;            // block bounds, maxt, 3 per axis
constexpr float kBig = 3.0e38f;
constexpr float kBoundCap = 1.0e37f;   // below the 3e38 key of unreachable
constexpr u64 kNoHit = (0x7F800000ull << 32) | 0xFFFFFFFFull;  // (inf, -1)

struct Scene {
  const float* woop;       // (n_units, 32, 12): triangle j's coefficients
  const int* meta;         // (n_units, 2): animated range | -1, slot of tri 0
  const float* inst;       // (n_ranges, 26)
  const float* box;        // (n_units, 6): lo xyz, hi xyz
  const float* scene_box;  // (6,): the union of the unit boxes
  int n_units;
  int has_anim;
  int cap;
};

struct Rays {
  const float* ox; const float* oy; const float* oz;
  const float* dx; const float* dy; const float* dz;
  const float* time; const float* maxt;
  long long n;
};

using mi::clamp_big;
using mi::scene_exit;
using mi::tmax;
using mi::tmin;

// Lane `lane` of the rays: the world ray w (o, d), its time and its maxt
// clamped to 3e38 and to the scene-box exit. Lanes past n repeat the last
// ray with maxt -1 (dead), as the wrapper's padding did.
__device__ __forceinline__ void load_lane(const Rays& ry, const float* sb,
                                          long long lane, float* w,
                                          float* time, float* maxt) {
  long long src = lane < ry.n ? lane : ry.n - 1;
  w[0] = ry.ox[src]; w[1] = ry.oy[src]; w[2] = ry.oz[src];
  w[3] = ry.dx[src]; w[4] = ry.dy[src]; w[5] = ry.dz[src];
  *time = ry.time[src];
  if (maxt != nullptr) {
    float m = lane < ry.n ? ry.maxt[src] : -1.0f;
    *maxt = tmin(clamp_big(m), scene_exit(sb, w));
  }
}

// The ray in the hit space of a unit of transform group `ci` (-1 static):
// fa * (M(t)^-1 x) + om * x with fa = 1 for animated units, as the plain
// version (and the TPU kernel) compute it; M(t) is the clamped keyframe lerp
// of the record's two matrices (reference transform.h:458-466).
__device__ __forceinline__ void unit_ray(const float* rec, int ci,
                                         float time, const float* w,
                                         float* r) {
  float tw0 = rec[24], tw1 = rec[25];
  float span = tw1 - tw0;
  float denom = span != 0.0f ? span : 1.0f;
  float uu = fminf(fmaxf((time - tw0) / denom, 0.0f), 1.0f);
  float c[12];
  for (int j = 0; j < 12; ++j) c[j] = rec[j] * (1.0f - uu) + rec[12 + j] * uu;
  float a00 = c[0], a01 = c[1], a02 = c[2], t0 = c[3];
  float a10 = c[4], a11 = c[5], a12 = c[6], t1 = c[7];
  float a20 = c[8], a21 = c[9], a22 = c[10], t2 = c[11];
  float c00 = a11 * a22 - a12 * a21;
  float c01 = a02 * a21 - a01 * a22;
  float c02 = a01 * a12 - a02 * a11;
  float c10 = a12 * a20 - a10 * a22;
  float c11 = a00 * a22 - a02 * a20;
  float c12 = a02 * a10 - a00 * a12;
  float c20 = a10 * a21 - a11 * a20;
  float c21 = a01 * a20 - a00 * a21;
  float c22 = a00 * a11 - a01 * a10;
  float det = a00 * c00 + a01 * c10 + a02 * c20;
  float inv = 1.0f / det;
  float i0 = c00 * inv, i1 = c01 * inv, i2 = c02 * inv;
  float i3 = c10 * inv, i4 = c11 * inv, i5 = c12 * inv;
  float i6 = c20 * inv, i7 = c21 * inv, i8 = c22 * inv;
  float n0 = -(i0 * t0 + i1 * t1 + i2 * t2);
  float n1 = -(i3 * t0 + i4 * t1 + i5 * t2);
  float n2 = -(i6 * t0 + i7 * t1 + i8 * t2);
  float fa = ci >= 0 ? 1.0f : 0.0f;
  float om = 1.0f - fa;
  float ox = w[0], oy = w[1], oz = w[2], dx = w[3], dy = w[4], dz = w[5];
  r[0] = fa * (i0 * ox + i1 * oy + i2 * oz + n0) + om * ox;
  r[1] = fa * (i3 * ox + i4 * oy + i5 * oz + n1) + om * oy;
  r[2] = fa * (i6 * ox + i7 * oy + i8 * oz + n2) + om * oz;
  r[3] = fa * (i0 * dx + i1 * dy + i2 * dz) + om * dx;
  r[4] = fa * (i3 * dx + i4 * dy + i5 * dz) + om * dy;
  r[5] = fa * (i6 * dx + i7 * dy + i8 * dz) + om * dz;
}

// The block's ray bounds into s_bb[kBounds]: min of o (0-2), max of o
// (3-5), min of d (6-8), max of d (9-11) and the largest clamped maxt capped
// at 3e38 (12), over all kBlock lanes (fminf/fmaxf: a NaN lane would be
// skipped where PyTorch's amin propagates it); then per axis the
// reciprocals of the d bounds and whether they share a sign (13 + 3 * axis
// + 0, 1, 2). The warp's own bounds, with the same per axis, go to s_gate
// (kGate floats).
__device__ __forceinline__ void ray_bounds(const float* w, float maxt,
                                           float* s_part, float* s_bb,
                                           float* s_gate) {
  float v[13];
  for (int a = 0; a < 3; ++a) {
    v[a] = w[a];
    v[3 + a] = w[a];
    v[6 + a] = w[3 + a];
    v[9 + a] = w[3 + a];
  }
  v[12] = maxt;
  for (int off = 16; off > 0; off >>= 1) {
    for (int a = 0; a < 13; ++a) {
      float o = __shfl_xor_sync(0xffffffffu, v[a], off);
      bool is_min = a < 3 || (a >= 6 && a < 9);
      v[a] = is_min ? fminf(v[a], o) : fmaxf(v[a], o);
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int a = 0; a < 13; ++a) s_part[warp * 13 + a] = v[a];
    for (int ax = 0; ax < 3; ++ax) {
      float dl = v[6 + ax], dh = v[9 + ax];
      bool same = (dl > 1e-12f) || (dh < -1e-12f);
      s_gate[5 * ax] = v[ax];
      s_gate[5 * ax + 1] = v[3 + ax];
      s_gate[5 * ax + 2] = 1.0f / (same ? dl : 1.0f);
      s_gate[5 * ax + 3] = 1.0f / (same ? dh : 1.0f);
      s_gate[5 * ax + 4] = same ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  if (threadIdx.x < 13) {
    int a = threadIdx.x;
    bool is_min = a < 3 || (a >= 6 && a < 9);
    float r = s_part[a];
    for (int q = 1; q < kWarps; ++q) {
      float o = s_part[q * 13 + a];
      r = is_min ? fminf(r, o) : fmaxf(r, o);
    }
    s_bb[a] = a == 12 ? clamp_big(r) : r;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int ax = threadIdx.x;
    float dl = s_bb[6 + ax], dh = s_bb[9 + ax];
    bool same = (dl > 1e-12f) || (dh < -1e-12f);
    s_bb[13 + 3 * ax] = 1.0f / (same ? dl : 1.0f);
    s_bb[14 + 3 * ax] = 1.0f / (same ? dh : 1.0f);
    s_bb[15 + 3 * ax] = same ? 1.0f : 0.0f;
  }
  __syncthreads();
}

// The conservative entry distance of the block's rays into a unit box, as
// `_slab_visit_order` computes it: per axis the plane parameters (p - o) / d
// over both planes and both ends of the o and d intervals span an interval;
// a d interval that straddles zero leaves its axis unbounded. 3e38 where
// no ray of the block can enter the box within the block's maxt. The
// reciprocals are the block's (``ray_bounds``), the same quotients as
// PyTorch's per unit. fminf/fmaxf stand for torch.minimum/maximum: the
// products are never NaN for bounds that are not (a NaN bound makes every
// key 3e38 either way), except maxt, whose minimum keeps PyTorch's rule.
__device__ __forceinline__ float unit_key(const float* s_bb,
                                          const float* box) {
  float t_lo = 0.0f, t_hi = s_bb[12];
  for (int ax = 0; ax < 3; ++ax) {
    const float ol = s_bb[ax], oh = s_bb[3 + ax];
    const float inv_a = s_bb[13 + 3 * ax], inv_b = s_bb[14 + 3 * ax];
    const bool same = s_bb[15 + 3 * ax] != 0.0f;
    float lo = kBig, hi = -kBig;
    for (int pi = 0; pi < 2; ++pi) {
      float p = __ldg(box + 3 * pi + ax);
      for (int oi = 0; oi < 2; ++oi) {
        float num = p - (oi == 0 ? ol : oh);
        float va = num * inv_a;
        lo = fminf(lo, va);
        hi = fmaxf(hi, va);
        float vb = num * inv_b;
        lo = fminf(lo, vb);
        hi = fmaxf(hi, vb);
      }
    }
    lo = same ? lo : -kBig;
    hi = same ? hi : kBig;
    t_lo = fmaxf(t_lo, lo);
    t_hi = tmin(t_hi, hi);
  }
  bool live = __ldg(box) <= __ldg(box + 3);
  return (t_lo <= t_hi && live) ? t_lo : kBig;
}

// A lane's best hit as (float bits of t) << 32 | prim: the smaller value is
// the nearer hit, or at equal t the smaller prim.
__device__ __forceinline__ u64 pack_hit(float t, int prim) {
  return ((u64)__float_as_uint(t) << 32) | (unsigned)prim;
}

// Largest term of the warp's lanes, capped: the far end of its walk.
template <bool kAnyHit>
__device__ __forceinline__ float warp_bound(float best_t, int best_p,
                                            float maxt) {
  float v = kAnyHit ? (best_p >= 0 ? -kBig : maxt) : fminf(best_t, maxt);
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return fminf(v, kBoundCap);
}

// May a ray of the warp whose bounds are `g` enter `box` at a distance in
// [0, t_hi]? The block's slab test on the warp's 32 rays.
__device__ __forceinline__ bool warp_gate(const float* g, const float* box,
                                          float t_hi) {
  float t_lo = 0.0f;
  for (int ax = 0; ax < 3; ++ax) {
    if (g[5 * ax + 4] == 0.0f) continue;
    float ol = g[5 * ax], oh = g[5 * ax + 1];
    float ia = g[5 * ax + 2], ib = g[5 * ax + 3];
    float bmin = __ldg(box + ax), bmax = __ldg(box + 3 + ax);
    float n0 = bmin - ol, n1 = bmin - oh, n2 = bmax - ol, n3 = bmax - oh;
    float v0 = n0 * ia, v1 = n0 * ib, v2 = n1 * ia, v3 = n1 * ib;
    float v4 = n2 * ia, v5 = n2 * ib, v6 = n3 * ia, v7 = n3 * ib;
    float lo = fminf(fminf(fminf(v0, v1), fminf(v2, v3)),
                     fminf(fminf(v4, v5), fminf(v6, v7)));
    float hi = fmaxf(fmaxf(fmaxf(v0, v1), fmaxf(v2, v3)),
                     fmaxf(fmaxf(v4, v5), fmaxf(v6, v7)));
    t_lo = fmaxf(t_lo, lo);
    t_hi = fminf(t_hi, hi);
  }
  return t_lo <= t_hi;
}

// The lane's ray against the 32 triangles of `unit`: Woop's test in the
// plain version's order of operations. A hit replaces (bt, bp) if nearer,
// or as near with a smaller slot. `lim` is the largest float below maxt
// (-inf for a NaN maxt), so that one compare t <= min(bt, lim) stands for
// t < maxt and t <= bt (a finite bt is below maxt); the triangles go from
// the last to the first, so the smallest slot among the unit's equal t is
// the one kept, and a tie with the best of earlier units is settled once
// per unit.
__device__ __forceinline__ void test_unit(const Scene& sc, int unit,
                                          const float* w, float time,
                                          float lim, int& cur_ci, float* r,
                                          float4* stage, float& bt, int& bp) {
  const int ci = __ldg(sc.meta + 2 * unit);
  const int slot0 = __ldg(sc.meta + 2 * unit + 1);
  if (sc.has_anim && ci != cur_ci) {
    unit_ray(sc.inst + (ci > 0 ? ci : 0) * kInstRec, ci, time, w, r);
    cur_ci = ci;
  }
  const float rox = r[0], roy = r[1], roz = r[2];
  const float rdx = r[3], rdy = r[4], rdz = r[5];
  // the unit's 1.5 KB record into the warp's stage: three coalesced
  // 16-byte loads a lane, then read back as broadcasts
  const float4* src =
      reinterpret_cast<const float4*>(sc.woop) + (long long)unit * kChunk * 3;
  const int lane = threadIdx.x & 31;
  const float4 c0 = __ldg(src + lane), c1 = __ldg(src + 32 + lane);
  const float4 c2 = __ldg(src + 64 + lane);
  __syncwarp();
  stage[lane] = c0;
  stage[32 + lane] = c1;
  stage[64 + lane] = c2;
  __syncwarp();
  const float4* tri = stage;
  float ut = fminf(bt, lim);
  int uj = -1;
#pragma unroll 4
  for (int j = kChunk - 1; j >= 0; --j) {
    const float4 w0 = tri[3 * j];
    const float4 w1 = tri[3 * j + 1];
    const float4 w2 = tri[3 * j + 2];
    float ozp = w2.x * rox + w2.y * roy + w2.z * roz + w2.w;
    float dzp = w2.x * rdx + w2.y * rdy + w2.z * rdz;
    float t = -ozp / dzp;
    float o0 = w0.x * rox + w0.y * roy + w0.z * roz + w0.w;
    float d0 = w0.x * rdx + w0.y * rdy + w0.z * rdz;
    float u = o0 + t * d0;
    float o1 = w1.x * rox + w1.y * roy + w1.z * roz + w1.w;
    float d1 = w1.x * rdx + w1.y * rdy + w1.z * rdz;
    float v = o1 + t * d1;
    if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t <= ut) {
      ut = t;
      uj = j;
    }
  }
  if (uj >= 0 && (ut < bt || slot0 + uj < bp)) {
    bt = ut;
    bp = slot0 + uj;
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    v4_walk_kernel(Scene sc, Rays ry, float* t_out, int* prim_out) {
  extern __shared__ u64 s_list[];
  __shared__ u64 s_best[kBlock];
  __shared__ float s_maxt[kBlock];
  __shared__ float s_part[kWarps * 13];
  __shared__ float s_bb[kBounds];
  __shared__ float s_gate[kWarps * kGate];
  __shared__ float4 s_stage[kWarps][kChunk * 3];
  __shared__ int s_n, s_more;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)blockIdx.x * kBlock;
  {
    float w[6], time, maxt;
    load_lane(ry, sc.scene_box, base + tid, w, &time, &maxt);
    s_maxt[tid] = maxt;
    s_best[tid] = kNoHit;
    ray_bounds(w, maxt, s_part, s_bb, s_gate + warp * kGate);
  }

  bool has_last = false;
  u64 last = 0;
  for (;;) {
    const int m = mi::list_round(
        sc.n_units, sc.cap,
        [&](int u) { return unit_key(s_bb, sc.box + 6LL * u); }, has_last,
        last, s_list, &s_n, &s_more);
    const bool more = s_more != 0;
    // entry p of warp a's walk goes to warp p mod kWarps, which holds warp
    // a's 32 rays; a walk ends at the first entry past its warp's bound
    for (int a = 0; a < kWarps; ++a) {
      const int ta = a * 32 + lane;
      float wa[6], time_a;
      load_lane(ry, sc.scene_box, base + ta, wa, &time_a, nullptr);
      const float maxt_a = s_maxt[ta];
      const float lim = maxt_a == maxt_a ? nextafterf(maxt_a, -INFINITY)
                                         : -INFINITY;
      float r[6] = {wa[0], wa[1], wa[2], wa[3], wa[4], wa[5]};
      int cur_ci = -2;
      volatile u64* best_a = s_best + ta;
      for (int p = warp; p < m; p += kWarps) {
        const u64 cb = *best_a;
        float bt = __uint_as_float((unsigned)(cb >> 32));
        int bp = (int)(unsigned)(cb & 0xFFFFFFFFull);
        const float bound = warp_bound<kAnyHit>(bt, bp, maxt_a);
        const u64 e = s_list[p];
        if (mi::list_key(e) > bound) break;
        const int unit = mi::list_item(e);
        if (!warp_gate(s_gate + a * kGate, sc.box + 6LL * unit, bound))
          continue;
        const int bp0 = bp;
        test_unit(sc, unit, wa, time_a, lim, cur_ci, r, s_stage[warp], bt,
                  bp);
        if (bp != bp0) atomicMin(s_best + ta, pack_hit(bt, bp));
      }
    }
    __syncthreads();
    if (!more) break;
    last = s_list[m - 1];
    has_last = true;
  }
  if (base + tid < ry.n) {
    const u64 cb = s_best[tid];
    t_out[base + tid] = __uint_as_float((unsigned)(cb >> 32));
    prim_out[base + tid] = (int)(unsigned)(cb & 0xFFFFFFFFull);
  }
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

Scene make_scene(const void* woop, const void* meta, const void* inst,
                 const void* box, const void* scene_box, int n_units,
                 int has_anim, int cap) {
  Scene s;
  s.woop = static_cast<const float*>(woop);
  s.meta = static_cast<const int*>(meta);
  s.inst = static_cast<const float*>(inst);
  s.box = static_cast<const float*>(box);
  s.scene_box = static_cast<const float*>(scene_box);
  s.n_units = n_units;
  s.has_anim = has_anim;
  s.cap = cap;
  return s;
}

Rays make_rays(const void* ox, const void* oy, const void* oz,
               const void* dx, const void* dy, const void* dz,
               const void* time, const void* maxt, long long n) {
  Rays r;
  r.ox = static_cast<const float*>(ox);
  r.oy = static_cast<const float*>(oy);
  r.oz = static_cast<const float*>(oz);
  r.dx = static_cast<const float*>(dx);
  r.dy = static_cast<const float*>(dy);
  r.dz = static_cast<const float*>(dz);
  r.time = static_cast<const float*>(time);
  r.maxt = static_cast<const float*>(maxt);
  r.n = n;
  return r;
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
  Scene sc = make_scene(woop, meta, inst, box, scene_box, n_units, has_anim,
                        cap);
  Rays ry = make_rays(ox, oy, oz, dx, dy, dz, time, maxt, n);
  unsigned int blocks = (unsigned int)((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t bytes;
  int err;
  if (any_hit) {
    if ((err = mi::list_bytes(v4_walk_kernel<true>, n_units, cap,
                              &bytes)))
      return err;
    v4_walk_kernel<true><<<blocks, kBlock, bytes, s>>>(
        sc, ry, static_cast<float*>(t_out),
        static_cast<int*>(prim_out));
  } else {
    if ((err = mi::list_bytes(v4_walk_kernel<false>, n_units, cap,
                              &bytes)))
      return err;
    v4_walk_kernel<false><<<blocks, kBlock, bytes, s>>>(
        sc, ry, static_cast<float*>(t_out),
        static_cast<int*>(prim_out));
  }
  return (int)cudaGetLastError();
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
