// Shared device code of the large-scene kernels B2-B6 (intersect_v4.cu,
// intersect_stream.cu, intersect_v2.cu, intersect_v3.cu, intersect_mxu.cu):
// the ray in a transform group's hit space, the block's ray bounds and its
// conservative slab test against a box, Moller-Trumbore, the scene-box
// clamp of maxt, the sorted lists of the boxes a group of rays can enter,
// and the walk over 32-triangle Woop units that B2 and B5 share (B5 with a
// per-lane ray-box test ahead of each unit). Every function keeps the order of
// operations of the plain PyTorch versions (and of the TPU kernels they
// come from); the files that include it are built with --fmad=false, so
// each product and sum rounds on its own.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mi {

constexpr int kBlock = 256;            // lanes per CTA = lanes per block
constexpr int kWarps = kBlock / 32;
constexpr int kChunk = 32;             // triangles per culling box
constexpr int kInstRec = 26;           // m0 (3x4) | m1 (3x4) | t0 | t1
constexpr int kTriStride = 12;         // staged triangle: 9 or 12 floats used
constexpr float kBig = 3.0e38f;
constexpr float kBoundCap = 1.0e37f;   // below the 3e38 key of unreachable

struct RayCols {
  const float* ox; const float* oy; const float* oz;
  const float* dx; const float* dy; const float* dz;
  const float* time; const float* maxt;
};

inline RayCols ray_cols(const void* ox, const void* oy, const void* oz,
                        const void* dx, const void* dy, const void* dz,
                        const void* time, const void* maxt) {
  RayCols c;
  c.ox = static_cast<const float*>(ox);
  c.oy = static_cast<const float*>(oy);
  c.oz = static_cast<const float*>(oz);
  c.dx = static_cast<const float*>(dx);
  c.dy = static_cast<const float*>(dy);
  c.dz = static_cast<const float*>(dz);
  c.time = static_cast<const float*>(time);
  c.maxt = static_cast<const float*>(maxt);
  return c;
}

// Inverse of the clamped keyframe lerp of an instance record's two 3x4
// matrices at `time` (reference transform.h:458-466; `_inv_lerped` of the
// plain versions): i[9] the 3x3 inverse, it[3] its translation.
__device__ __forceinline__ void inv_lerped(const float* rec, float time,
                                           float* i, float* it) {
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
  i[0] = c00 * inv; i[1] = c01 * inv; i[2] = c02 * inv;
  i[3] = c10 * inv; i[4] = c11 * inv; i[5] = c12 * inv;
  i[6] = c20 * inv; i[7] = c21 * inv; i[8] = c22 * inv;
  it[0] = -(i[0] * t0 + i[1] * t1 + i[2] * t2);
  it[1] = -(i[3] * t0 + i[4] * t1 + i[5] * t2);
  it[2] = -(i[6] * t0 + i[7] * t1 + i[8] * t2);
}

// The world ray w[6] (o, d) in the hit space of transform group `ci` (-1
// static): fa * (M(t)^-1 x) + om * x with fa = 1 for animated groups; the
// static form still evaluates the first record, as the plain versions do.
__device__ __forceinline__ void unit_ray(const float* inst, int ci,
                                         float time, const float* w,
                                         float* r) {
  float i[9], n[3];
  inv_lerped(inst + (ci > 0 ? ci : 0) * kInstRec, time, i, n);
  float fa = ci >= 0 ? 1.0f : 0.0f;
  float om = 1.0f - fa;
  r[0] = fa * (i[0] * w[0] + i[1] * w[1] + i[2] * w[2] + n[0]) + om * w[0];
  r[1] = fa * (i[3] * w[0] + i[4] * w[1] + i[5] * w[2] + n[1]) + om * w[1];
  r[2] = fa * (i[6] * w[0] + i[7] * w[1] + i[8] * w[2] + n[2]) + om * w[2];
  r[3] = fa * (i[0] * w[3] + i[1] * w[4] + i[2] * w[5]) + om * w[3];
  r[4] = fa * (i[3] * w[3] + i[4] * w[4] + i[5] * w[5]) + om * w[4];
  r[5] = fa * (i[6] * w[3] + i[7] * w[4] + i[8] * w[5]) + om * w[5];
}

// Conservative slab test of the block's ray bounds against one box (lo xyz,
// hi xyz): per axis the plane parameters (p - o) / d over both planes and
// both ends of the o and d intervals span an interval; a d interval that
// straddles zero leaves its axis unbounded. True if some ray of the block
// may enter the box at a distance in [0, t_hi].
__device__ __forceinline__ bool slab_test(const float* s_bb, const float* box,
                                          float t_hi) {
  float t_lo = 0.0f;
  for (int ax = 0; ax < 3; ++ax) {
    float ol = s_bb[ax], oh = s_bb[3 + ax];
    float dl = s_bb[6 + ax], dh = s_bb[9 + ax];
    float bmin = __ldg(box + ax), bmax = __ldg(box + 3 + ax);
    bool same = (dl > 1e-12f) || (dh < -1e-12f);
    float inv_a = 1.0f / (same ? dl : 1.0f);
    float inv_b = 1.0f / (same ? dh : 1.0f);
    float lo = kBig, hi = -kBig;
    for (int pi = 0; pi < 2; ++pi) {
      float p = pi == 0 ? bmin : bmax;
      for (int oi = 0; oi < 2; ++oi) {
        float num = p - (oi == 0 ? ol : oh);
        float va = num * inv_a, vb = num * inv_b;
        lo = fminf(lo, fminf(va, vb));
        hi = fmaxf(hi, fmaxf(va, vb));
      }
    }
    lo = same ? lo : -kBig;
    hi = same ? hi : kBig;
    t_lo = fmaxf(t_lo, lo);
    t_hi = fminf(t_hi, hi);
  }
  return t_lo <= t_hi;
}

// Möller-Trumbore of the ray r[6] against the staged triangle g (v0 e1 e2),
// with the |det| > 1e-12 guard; true on a hit in (0, maxt) closer than
// best_t, with t, u, v set.
__device__ __forceinline__ bool moller_hit(const float* g, const float* r,
                                           float maxt, float best_t,
                                           float* t_out, float* u_out,
                                           float* v_out) {
  const float4 g0 = reinterpret_cast<const float4*>(g)[0];
  const float4 g1 = reinterpret_cast<const float4*>(g)[1];
  const float4 g2 = reinterpret_cast<const float4*>(g)[2];
  float v0x = g0.x, v0y = g0.y, v0z = g0.z;
  float e1x = g0.w, e1y = g1.x, e1z = g1.y;
  float e2x = g1.z, e2y = g1.w, e2z = g2.x;
  float rox = r[0], roy = r[1], roz = r[2];
  float rdx = r[3], rdy = r[4], rdz = r[5];
  float px = rdy * e2z - rdz * e2y;
  float py = rdz * e2x - rdx * e2z;
  float pz = rdx * e2y - rdy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  bool ok = fabsf(det) > 1e-12f;
  float inv = 1.0f / (ok ? det : 1.0f);
  float tx = rox - v0x;
  float ty = roy - v0y;
  float tz = roz - v0z;
  float u = (tx * px + ty * py + tz * pz) * inv;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v = (rdx * qx + rdy * qy + rdz * qz) * inv;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
      t < maxt && t < best_t) {
    *t_out = t;
    *u_out = u;
    *v_out = v;
    return true;
  }
  return false;
}

// torch.minimum / torch.maximum: NaN if either is NaN, else the same
// instruction PyTorch's CUDA kernels issue
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp(x, max=3e38): NaN stays NaN
__device__ __forceinline__ float clamp_big(float x) {
  return x > kBig ? kBig : x;
}

// Exit distance of the scene box, as intersect_v2.scene_box_exit (B2 and B4
// clamp each lane's maxt by it): a ray hits nothing past the point where it
// leaves the box; -1 if it misses it.
__device__ __forceinline__ float scene_exit(const float* sb, const float* w) {
  float t_en = -kBig, t_ex = kBig;
  for (int ax = 0; ax < 3; ++ax) {
    float oa = w[ax], da = w[3 + ax];
    float lo = __ldg(sb + ax), hi = __ldg(sb + 3 + ax);
    bool ok = fabsf(da) > 1e-20f;
    float inv = 1.0f / (ok ? da : 1.0f);
    float ta = (lo - oa) * inv;
    float tb = (hi - oa) * inv;
    float alo = tmin(ta, tb), ahi = tmax(ta, tb);
    bool inside = (oa >= lo) && (oa <= hi);
    alo = ok ? alo : (inside ? -kBig : kBig);
    ahi = ok ? ahi : (inside ? kBig : -kBig);
    t_en = tmax(t_en, alo);
    t_ex = tmin(t_ex, ahi);
  }
  bool hit_box = (t_en <= t_ex) && (t_ex > 0.0f);
  float ex = clamp_big(t_ex) * 1.001f;
  ex = ex + 1e-4f;
  return hit_box ? ex : -1.0f;
}

// A lane's term of the ordered walks' bound: min(t, maxt) for closest-hit;
// for any-hit maxt while the lane is unoccluded, -3e38 once it has a hit.
template <bool kAnyHit>
__device__ __forceinline__ float lane_term(float best_t, int best_p,
                                           float maxt) {
  if (kAnyHit) return best_p >= 0 ? -kBig : maxt;
  return fminf(best_t, maxt);
}

// ---------------------------------------------------------------------------
// Gates of a group of rays' live lanes (maxt > 0), and sorted lists of the
// boxes they can enter (B2's and B3's walks).
// ---------------------------------------------------------------------------

constexpr int kGateLen = 16;   // per axis o lo, o hi, 1/d lo, 1/d hi, same;
                               // then the far end
typedef unsigned long long u64e;

__device__ __forceinline__ float lanes_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float lanes_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The gate of bounds v[13] (min of o 0-2, max of o 3-5, min of d 6-8, max
// of d 9-11, the largest maxt 12) into g[kGateLen]: per axis o lo, o hi,
// the reciprocals of the d bounds (1 where d does not keep one sign) and
// whether it does; then the far end, the largest maxt capped at 3e38
// (-3e38 where no lane is live).
__device__ __forceinline__ void gate_from_bounds(const float* v, float* g) {
  for (int ax = 0; ax < 3; ++ax) {
    const float dl = v[6 + ax], dh = v[9 + ax];
    const bool same = (dl > 1e-12f) || (dh < -1e-12f);
    g[5 * ax] = v[ax];
    g[5 * ax + 1] = v[3 + ax];
    g[5 * ax + 2] = 1.0f / (same ? dl : 1.0f);
    g[5 * ax + 3] = 1.0f / (same ? dh : 1.0f);
    g[5 * ax + 4] = same ? 1.0f : 0.0f;
  }
  g[15] = v[12] > 0.0f ? fminf(v[12], kBig) : -kBig;
}

// The gates of the CTA's live lanes (s_block) and of each warp's (s_warp,
// kGateLen floats a warp, this warp's at s_warp + warp * kGateLen), from
// the lane's world ray w[6] and maxt; a dead lane (maxt <= 0, or NaN)
// takes no part. s_part: kWarps * 13 floats. Starts and ends with the CTA
// in step.
__device__ __forceinline__ void live_gates(const float* w, float maxt,
                                           float* s_part, float* s_block,
                                           float* s_warp) {
  const bool live = maxt > 0.0f;
  float v[13];
  for (int a = 0; a < 3; ++a) {
    v[a] = live ? w[a] : INFINITY;
    v[3 + a] = live ? w[a] : -INFINITY;
    v[6 + a] = live ? w[3 + a] : INFINITY;
    v[9 + a] = live ? w[3 + a] : -INFINITY;
  }
  v[12] = live ? maxt : -INFINITY;
  for (int a = 0; a < 13; ++a) {
    const bool is_min = a < 3 || (a >= 6 && a < 9);
    v[a] = is_min ? lanes_min(v[a]) : lanes_max(v[a]);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int a = 0; a < 13; ++a) s_part[warp * 13 + a] = v[a];
    gate_from_bounds(v, s_warp + warp * kGateLen);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float b[13];
    for (int a = 0; a < 13; ++a) {
      const bool is_min = a < 3 || (a >= 6 && a < 9);
      float r = s_part[a];
      for (int q = 1; q < kWarps; ++q) {
        const float o = s_part[q * 13 + a];
        r = is_min ? fminf(r, o) : fmaxf(r, o);
      }
      b[a] = r;
    }
    gate_from_bounds(b, s_block);
  }
  __syncthreads();
}

// The slab test of the rays of gate g against one box (lo xyz, hi xyz):
// per axis whose d keeps one sign, the plane parameters (p - o) / d over
// both planes and both ends of the o and d intervals span [lo, hi]; *t_lo
// is the largest lo, at least 0, and *t_ex the smallest hi, at most 3e38.
// Some ray may enter the box within a far end f if *t_lo <= min(*t_ex, f).
// An inverted box (a pad chunk's, or a group of pad chunks) gives
// *t_lo = 3e38, *t_ex = -3e38.
__device__ __forceinline__ void gate_span(const float* g, const float* box,
                                          float* t_lo, float* t_ex) {
  float lo_all = 0.0f, hi_all = kBig;
  for (int ax = 0; ax < 3; ++ax) {
    const float* ga = g + 5 * ax;
    const float bmin = __ldg(box + ax), bmax = __ldg(box + 3 + ax);
    float lo = kBig, hi = -kBig;
    for (int pi = 0; pi < 2; ++pi) {
      const float pl = pi == 0 ? bmin : bmax;
      for (int oi = 0; oi < 2; ++oi) {
        const float num = pl - ga[oi];
        const float va = num * ga[2], vb = num * ga[3];
        lo = fminf(lo, fminf(va, vb));
        hi = fmaxf(hi, fmaxf(va, vb));
      }
    }
    if (ga[4] != 0.0f) {
      lo_all = fmaxf(lo_all, lo);
      hi_all = fminf(hi_all, hi);
    }
  }
  const bool live = __ldg(box) <= __ldg(box + 3);
  *t_lo = live ? lo_all : kBig;
  *t_ex = live ? hi_all : -kBig;
}

// The entry distance of the rays of gate g into `box` within the gate's far
// end, or 3e38 where none can enter it: a sorted list's key.
__device__ __forceinline__ float gate_key(const float* g, const float* box) {
  float lo, ex;
  gate_span(g, box, &lo, &ex);
  return lo <= fminf(ex, g[15]) ? lo : kBig;
}

// A list entry: the key's bits (sign cleared: keys are >= 0, and -0 sorts
// as +0, as in PyTorch's sort) above the item index, so that the entries
// order as (key, item).
__device__ __forceinline__ u64e list_entry(float key, int item) {
  return ((u64e)(__float_as_uint(key) & 0x7FFFFFFFu) << 32) | (unsigned)item;
}
__device__ __forceinline__ float list_key(u64e e) {
  return __uint_as_float((unsigned)(e >> 32));
}
__device__ __forceinline__ int list_item(u64e e) {
  return (int)(unsigned)(e & 0xFFFFFFFFull);
}

// Ascending sort of s[0, n) with a bitonic network whose comparators all
// put the smaller entry at the lower index, so entries past n behave as +inf
// and need no storage. Starts and ends with the CTA in step.
__device__ inline void list_sort(u64e* s, int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int k = 2; k <= n2; k <<= 1) {
    const int half = k >> 1;
    for (int i = threadIdx.x; i < (n2 >> 1); i += kBlock) {
      int blk = i / half, off = i - blk * half;
      int a = blk * k + off, b = blk * k + k - 1 - off;
      if (b < n) {
        u64e x = s[a], y = s[b];
        if (y < x) { s[a] = y; s[b] = x; }
      }
    }
    __syncthreads();
    for (int j = k >> 2; j >= 1; j >>= 1) {
      for (int i = threadIdx.x; i < (n2 >> 1); i += kBlock) {
        int blk = i / j, off = i - blk * j;
        int a = blk * 2 * j + off, b = a + j;
        if (b < n) {
          u64e x = s[a], y = s[b];
          if (y < x) { s[a] = y; s[b] = x; }
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

// One round of a CTA's sorted list into s_list: the (up to cap) smallest
// entries above `last` (all entries in the first round), sorted; item i of
// n_items enters with key(i) where that is below 3e38. Items are keyed cap
// at a time; whenever more than cap entries are held, they are sorted and
// the largest dropped, and *s_more is set. s_list holds
// n_items <= cap ? n_items : 2 * cap entries. Returns the round's length,
// the same on every thread. The CTA must be in step when it starts (the
// previous round's list read by every thread).
template <typename KeyFn>
__device__ int list_round(int n_items, int cap, KeyFn key, bool has_last,
                          u64e last, u64e* s_list, int* s_n, int* s_more) {
  if (threadIdx.x == 0) {
    *s_n = 0;
    *s_more = 0;
  }
  __syncthreads();
  for (int u0 = 0; u0 < n_items; u0 += cap) {
    const int u1 = min(u0 + cap, n_items);
    for (int u = u0 + threadIdx.x; u < u1; u += kBlock) {
      const float k = key(u);
      if (k < kBig) {
        const u64e e = list_entry(k, u);
        if (!has_last || e > last) s_list[atomicAdd(s_n, 1)] = e;
      }
    }
    __syncthreads();
    const int n = *s_n;
    if (n > cap) {
      list_sort(s_list, n);
      if (threadIdx.x == 0) {
        *s_n = cap;
        *s_more = 1;
      }
      __syncthreads();
    }
  }
  const int n = *s_n;
  list_sort(s_list, n);
  return n;
}

// Dynamic shared memory of a round's list of n_items with capacity cap;
// raises the kernel's limit above the default 48 KB where needed.
template <typename K>
int list_bytes(K kernel, int n_items, int cap, size_t* bytes) {
  *bytes = (size_t)(n_items <= cap ? n_items : 2 * cap) * sizeof(u64e);
  if (*bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  return 0;
}

// ---------------------------------------------------------------------------
// The walk over 32-triangle Woop units (B2's csrc/intersect_v4.cu, B5's
// csrc/intersect_v3.cu): one CTA per block of kBlock lanes builds the
// block's visit list (the scene-box clamp of maxt, a slab test of every
// unit box against the block's ray bounds, the bitonic sort and rounds
// above), then walks it for each warp's 32 lanes on their own bound, every
// walk shared by the CTA's warps entry by entry.
// ---------------------------------------------------------------------------

// In a namespace of its own: B3's, B4's and B6's files, which take all of
// mi, define some of these names themselves.
namespace units {

constexpr int kGate = 15;              // per warp and axis: ol oh ia ib same
constexpr int kBounds = 22;            // block bounds, maxt, 3 per axis
constexpr int kMaxCap = 4096;          // largest list a round may hold
constexpr u64e kNoHit = (0x7F800000ull << 32) | 0xFFFFFFFFull;  // (inf, -1)
// 1 + 2^-19: the far side of B5's per-lane box test is scaled by it. Ize,
// "Robust BVH Ray Traversal" (JCGT 2(2), 2013), shows that 1 + 2 gamma_3
// (gamma_3 = 3 eps / (1 - 3 eps), 3.6e-7 in all) makes the float32 slab
// test of a ray conservative against the exact one; 2^-19 (1.9e-6) also
// covers the rounding of that product and of the Woop test's own t, which
// may lie a few ulps past the exact ray's box exit or far end.
constexpr float kSlabSlack = 1.0f + 1.0f / 524288.0f;

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

inline Scene make_scene(const void* woop, const void* meta, const void* inst,
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

inline Rays make_rays(const void* ox, const void* oy, const void* oz,
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
__device__ __forceinline__ u64e pack_hit(float t, int prim) {
  return ((u64e)__float_as_uint(t) << 32) | (unsigned)prim;
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
// [0, t_hi]? The block's slab test on the warp's 32 rays (B2's gate).
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

// May the lane's own world ray w (o, d; inv: 1 / d, per axis) enter `box`
// (a unit's, lo xyz hi xyz, never inverted: an inverted box never enters a
// list) at a distance in [0, far]? B5's per-lane test, in the order of
// operations of its plain version (ops/intersect_v3.lane_box_test). It
// never rejects a box that the exact ray enters within far:
//  * each plane parameter (b - o) * inv rounds three times (the
//    difference, the reciprocal, the product), and a rounding never
//    changes a sign, so a box behind the ray stays behind it;
//  * the far side, the smaller of far and the three exits, is scaled by
//    kSlabSlack (Ize's 1 + 2 gamma_3, widened) before it is compared with
//    the near side, the larger of 0 and the three entries;
//  * a direction component of +-0 has an infinite reciprocal, and
//    (b - o) * inf is NaN where the origin lies on the plane: the ray runs
//    in that face. tmin/tmax keep a NaN, and a NaN entry or exit moves
//    neither side (`x > lo` and `x < hi` are false for it), so that axis
//    bounds nothing and the test passes where fminf/fmaxf, which drop a
//    NaN, would take the other plane's +-inf and reject.
// A far end of -inf (an occluded any-hit lane) passes nothing.
__device__ __forceinline__ bool lane_box(const float* w, const float* inv,
                                         const float* box, float far) {
  float lo = 0.0f, hi = far;
  for (int ax = 0; ax < 3; ++ax) {
    const float t0 = (__ldg(box + ax) - w[ax]) * inv[ax];
    const float t1 = (__ldg(box + 3 + ax) - w[ax]) * inv[ax];
    const float t_en = tmin(t0, t1), t_ex = tmax(t0, t1);
    lo = t_en > lo ? t_en : lo;
    hi = t_ex < hi ? t_ex : hi;
  }
  return lo <= hi * kSlabSlack;
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
    unit_ray(sc.inst, ci, time, w, r);
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

// The walk of one CTA over its block's visit list. Entry p of warp a's walk
// goes to warp p mod kWarps, which loads warp a's 32 rays; a walk ends at
// the first entry past its warp's bound (the largest lane term of
// warp_bound over the lanes' best as read back). Before a unit, kWarpGate:
// the slab test of the warp's ray bounds against its box within that bound
// (B2); kBallot: each lane's own ray against the box within its own far end
// (lane_box: closest-hit min(best t, maxt), any-hit maxt while the lane has
// no hit), the unit skipped unstaged where no lane passes (B5); a dead lane
// (maxt <= 0 or NaN) passes nothing. The lanes' results meet in shared
// memory by a 64-bit atomicMin of pack_hit: t > 0 on every hit, so its bits
// order as an unsigned integer, and the smaller prim wins at equal t, the
// plain version's rule. `s_list`: the kernel's dynamic shared memory.
template <bool kAnyHit, bool kWarpGate, bool kBallot>
__device__ __forceinline__ void unit_walk(const Scene& sc, const Rays& ry,
                                          float* t_out, int* prim_out,
                                          u64e* s_list) {
  __shared__ u64e s_best[kBlock];
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
  u64e last = 0;
  for (;;) {
    const int m = list_round(
        sc.n_units, sc.cap,
        [&](int u) { return unit_key(s_bb, sc.box + 6LL * u); }, has_last,
        last, s_list, &s_n, &s_more);
    const bool more = s_more != 0;
    for (int a = 0; a < kWarps; ++a) {
      const int ta = a * 32 + lane;
      float wa[6], time_a;
      load_lane(ry, sc.scene_box, base + ta, wa, &time_a, nullptr);
      const float maxt_a = s_maxt[ta];
      const float lim = maxt_a == maxt_a ? nextafterf(maxt_a, -INFINITY)
                                         : -INFINITY;
      const bool live_a = maxt_a > 0.0f;
      float inv_a[3];
      if (kBallot)
        for (int ax = 0; ax < 3; ++ax) inv_a[ax] = 1.0f / wa[3 + ax];
      float r[6] = {wa[0], wa[1], wa[2], wa[3], wa[4], wa[5]};
      int cur_ci = -2;
      volatile u64e* best_a = s_best + ta;
      for (int p = warp; p < m; p += kWarps) {
        const u64e cb = *best_a;
        float bt = __uint_as_float((unsigned)(cb >> 32));
        int bp = (int)(unsigned)(cb & 0xFFFFFFFFull);
        const float bound = warp_bound<kAnyHit>(bt, bp, maxt_a);
        const u64e e = s_list[p];
        if (list_key(e) > bound) break;
        const int unit = list_item(e);
        const float* box = sc.box + 6LL * unit;
        if (kWarpGate && !warp_gate(s_gate + a * kGate, box, bound)) continue;
        if (kBallot) {
          const float far = kAnyHit ? (bp >= 0 ? -INFINITY : maxt_a)
                                    : fminf(bt, maxt_a);
          if (!__ballot_sync(0xffffffffu,
                             live_a && lane_box(wa, inv_a, box, far)))
            continue;
        }
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
    const u64e cb = s_best[tid];
    t_out[base + tid] = __uint_as_float((unsigned)(cb >> 32));
    prim_out[base + tid] = (int)(unsigned)(cb & 0xFFFFFFFFull);
  }
}

// Launch the walk kernel `kernel` (one of unit_walk's instances) over n
// rays, one CTA per block of kBlock lanes (the last one ragged), with
// lists of at most sc.cap entries a round; returns the launch's
// cudaGetLastError() (0 = ok).
template <typename K>
int launch_walk(K kernel, const Scene& sc, const Rays& ry, float* t_out,
                int* prim_out, cudaStream_t s) {
  size_t bytes;
  int err;
  if ((err = list_bytes(kernel, sc.n_units, sc.cap, &bytes))) return err;
  const unsigned int blocks = (unsigned int)((ry.n + kBlock - 1) / kBlock);
  kernel<<<blocks, kBlock, bytes, s>>>(sc, ry, t_out, prim_out);
  return (int)cudaGetLastError();
}

}  // namespace units
}  // namespace mi
