// Shared device code of the large-scene kernels B2-B6 (intersect_v4.cu,
// intersect_stream.cu, intersect_v2.cu, intersect_v3.cu, intersect_mxu.cu):
// the ray in a transform group's hit space, the block's ray bounds and its
// conservative slab test against a box, block-wide reductions, the two
// ray-triangle tests, the scene-box clamp of maxt, and the sorted lists of
// the boxes a group of rays can enter. Every function keeps the order of
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

// CTA-wide max; the same value on every thread. Its first barrier also
// ends every thread's reads of whatever was staged in shared memory.
__device__ __forceinline__ float block_max(float v, float* s_red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = s_red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, s_red[w]);
  return r;
}

// The block's ray bounds into s_bb[12]: min of o (0-2), max of o (3-5), min
// of d (6-8), max of d (9-11), over all kBlock lanes. s_part: kWarps * 12.
__device__ __forceinline__ void block_ray_bounds(const float* w,
                                                 float* s_part,
                                                 float* s_bb) {
  float v[12];
  for (int a = 0; a < 3; ++a) {
    v[a] = w[a];
    v[3 + a] = w[a];
    v[6 + a] = w[3 + a];
    v[9 + a] = w[3 + a];
  }
  for (int off = 16; off > 0; off >>= 1) {
    for (int a = 0; a < 12; ++a) {
      float o = __shfl_xor_sync(0xffffffffu, v[a], off);
      bool is_min = a < 3 || (a >= 6 && a < 9);
      v[a] = is_min ? fminf(v[a], o) : fmaxf(v[a], o);
    }
  }
  if ((threadIdx.x & 31) == 0)
    for (int a = 0; a < 12; ++a) s_part[(threadIdx.x >> 5) * 12 + a] = v[a];
  __syncthreads();
  if (threadIdx.x < 12) {
    int a = threadIdx.x;
    bool is_min = a < 3 || (a >= 6 && a < 9);
    float r = s_part[a];
    for (int q = 1; q < kWarps; ++q) {
      float o = s_part[q * 12 + a];
      r = is_min ? fminf(r, o) : fmaxf(r, o);
    }
    s_bb[a] = r;
  }
  __syncthreads();
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

// The Woop test of the ray r[6] against the staged triangle g (12
// coefficients: the rows of [e1 | e2 | n]^-1 with their offsets). A
// degenerate or pad triangle has zero rows: t = -0/0 is NaN and every
// comparison rejects it. True on a hit in (0, maxt) closer than best_t,
// with t set.
__device__ __forceinline__ bool woop_hit(const float* g, const float* r,
                                         float maxt, float best_t,
                                         float* t_out) {
  const float4 w0 = reinterpret_cast<const float4*>(g)[0];
  const float4 w1 = reinterpret_cast<const float4*>(g)[1];
  const float4 w2 = reinterpret_cast<const float4*>(g)[2];
  float rox = r[0], roy = r[1], roz = r[2];
  float rdx = r[3], rdy = r[4], rdz = r[5];
  float ozp = w2.x * rox + w2.y * roy + w2.z * roz + w2.w;
  float dzp = w2.x * rdx + w2.y * rdy + w2.z * rdz;
  float t = -ozp / dzp;
  float o0 = w0.x * rox + w0.y * roy + w0.z * roz + w0.w;
  float d0 = w0.x * rdx + w0.y * rdy + w0.z * rdz;
  float u = o0 + t * d0;
  float o1 = w1.x * rox + w1.y * roy + w1.z * roz + w1.w;
  float d1 = w1.x * rdx + w1.y * rdy + w1.z * rdz;
  float v = o1 + t * d1;
  if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t < maxt &&
      t < best_t) {
    *t_out = t;
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

}  // namespace mi
