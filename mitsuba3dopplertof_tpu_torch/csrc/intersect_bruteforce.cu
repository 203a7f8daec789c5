// Closest-hit / any-hit ray intersection for small scenes (at most 192
// triangles), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_kernel.py
// `_build_kernel` (Pallas, reached through `intersect_pallas` and
// `ray_test_pallas`). It computes the same function as that kernel and as
// the plain PyTorch version `intersect_reference` in
// mitsuba3dopplertof_tpu_torch/ops/intersect_kernel.py: Möller-Trumbore over
// the static triangles in world space, then each animated instance's
// triangles in its object space (the ray moved by the inverse of the
// keyframe-lerped 3x4 matrix at the ray's own time), then analytic unit
// spheres; with the full payload (t, slot, instance, barycentrics,
// world-space geometric and shading normals, uv), or an occlusion flag.
//
// What bounds it on this card: the arithmetic of the exact tests. A dense
// walk tests every triangle on every ray (56 float operations each, and an
// IEEE division, with every product and sum its own instruction under
// --fmad=false) and inverts every animated instance's lerped matrix; per
// ray only 32 bytes come in and 52 go out.
//
// What the design does about it: it does fewer tests. The strip passes put
// 32 samples of one pixel in a warp, so a warp's camera rays, and the
// shadow rays from their hits, are coherent. Each warp votes on the sign of
// its rays' directions per axis; where two axes or three keep one sign, it
// reduces its rays' bounds with shuffles (origin box, direction intervals,
// the largest maxt) and lane k slab-tests the conservative box of slot k
// (a static triangle's world box, an animated instance's swept world box,
// a sphere's world box), in rounds of 32; `__ballot_sync` gives the warp's
// masks, which wait in shared memory. The warp walks only the set bits, in
// slot order (static, animated ranges, spheres), with the same strict
// `t < best` as the dense walk, so ties resolve to the same slot. An
// instance's inverse is computed only when its swept box is reached, and
// then its triangles are tested whole (a second gate on their object-space
// boxes against the warp's object-space ray bounds measured faster on the
// camera and depth-1 shadow wavefronts but slower on the depth-2 shadow
// one, and cost more in the render's mix). A warp whose directions
// straddle zero on two axes (the hemisphere of diffuse bounce rays) runs
// no slab tests and no mask words, and a round whose mask passes three
// quarters of its slots is tested whole by a counted loop, as the dense
// kernel does. Boxes are padded in the tables, and by a multiple of the warp's
// largest |origin| here, so that rounding never culls a slot the exact
// test accepts. The winner's inverse is kept from the walk (in shared
// memory, per lane) for the payload. Each block copies the tables and
// boxes into shared memory once (boxes by row, so the 32 lanes of a gate
// round read 32 banks); a persistent grid that stages them once per
// resident block measured no faster and is not used.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTriRec = 25;     // v0 e1 e2 | n0 n1 n2 | uv0 uv1 uv2 | inst
constexpr int kInstRec = 26;    // m0 (3x4) | m1 (3x4) | t0 | t1
constexpr int kSphRec = 27;     // m0 (3x4) | m1 (3x4) | t0 | t1 | inst
constexpr int kSphSlotBase = 1 << 28;
constexpr int kThreads = 256;
// resident blocks per multiprocessor: at most 64 registers a thread, so
// that four fit (three measured slower)
constexpr int kMinBlocks = 4;
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* tri;      // (n_tri, 25)
  const float* inst;     // (n_anim, 26)
  const int* anim;       // (n_anim, 3): instance id, start, count
  const float* sph;      // (n_sph, 27)
  const int* sph_anim;   // (n_sph,)
  const float* box;      // (6, box_stride): lo xyz, hi xyz of each
                         // static triangle, animated range and sphere
  int n_tri, n_static, n_anim, n_sph;
  int box_stride, box_col0;  // the launch's first column
  float origin_pad;      // box pad per unit of the warp's largest |origin|
  const float* ox; const float* oy; const float* oz;
  const float* dx; const float* dy; const float* dz;
  const float* time; const float* maxt;
  long long n;
  float* outf;           // (11, n): t u v gx gy gz nx ny nz uu vv
  int* outi;             // (2, n): prim inst — or (1, n): occluded
};

// Inverse of the clamped keyframe lerp of two 3x4 matrices at `time`
// (reference transform.h:458-466; the TPU kernel's `_inv_lerped`):
// i[9] is the 3x3 inverse, it[3] its translation.
__device__ __forceinline__ void inv_lerped(const float* m0, const float* m1,
                                           float tw0, float tw1, float time,
                                           bool animated, float* i,
                                           float* it) {
  float c[12];
  if (animated) {
    float span = tw1 - tw0;
    float denom = span != 0.0f ? span : 1.0f;
    float uu = fminf(fmaxf((time - tw0) / denom, 0.0f), 1.0f);
    for (int j = 0; j < 12; ++j) c[j] = m0[j] * (1.0f - uu) + m1[j] * uu;
  } else {
    for (int j = 0; j < 12; ++j) c[j] = m0[j];
  }
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

// The ray (o, d) moved by the inverse (i, it).
__device__ __forceinline__ void to_object(const float* i, const float* it,
                                          const float* o, const float* d,
                                          float* oo, float* od) {
  oo[0] = i[0] * o[0] + i[1] * o[1] + i[2] * o[2] + it[0];
  oo[1] = i[3] * o[0] + i[4] * o[1] + i[5] * o[2] + it[1];
  oo[2] = i[6] * o[0] + i[7] * o[1] + i[8] * o[2] + it[2];
  od[0] = i[0] * d[0] + i[1] * d[1] + i[2] * d[2];
  od[1] = i[3] * d[0] + i[4] * d[1] + i[5] * d[2];
  od[2] = i[6] * d[0] + i[7] * d[1] + i[8] * d[2];
}


struct Best {
  float t, u, v;
  int slot;        // -1 none; >= kSphSlotBase a sphere
};

// One Möller-Trumbore test, in the plain version's operation order: true
// on a hit in (0, maxt), with t, u, v set.
__device__ __forceinline__ bool moller(const float* r, const float* o,
                                       const float* d, float maxt,
                                       float& t, float& u, float& v) {
  float rox = o[0], roy = o[1], roz = o[2];
  float rdx = d[0], rdy = d[1], rdz = d[2];
  float v0x = r[0], v0y = r[1], v0z = r[2];
  float e1x = r[3], e1y = r[4], e1z = r[5];
  float e2x = r[6], e2y = r[7], e2z = r[8];
  float px = rdy * e2z - rdz * e2y;
  float py = rdz * e2x - rdx * e2z;
  float pz = rdx * e2y - rdy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  bool ok = fabsf(det) > 1e-12f;
  float inv = 1.0f / (ok ? det : 1.0f);
  float tx = rox - v0x;
  float ty = roy - v0y;
  float tz = roz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  v = (rdx * qx + rdy * qy + rdz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
         t < maxt;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The warp's ray bounds, the same on every lane: per axis the origin
// interval, the reciprocals of the direction interval's ends and whether
// they share a sign; the largest maxt (capped) and the box pad. Lanes that
// cannot hit anything (`live` false: maxt not above 0, NaN, or past the
// end) stay out. A direction component shares the warp's sign only if it
// is beyond ±1e-12 on every live lane (a NaN one never is); origins
// reduce with fminf/fmaxf, which skip a NaN component, whose lane's exact
// tests fail anyway.
struct Gate {
  float ol[3], oh[3], ia[3], ib[3];
  bool same[3];
  bool culls;      // two axes bounded or three: the slab tests run
  float t_hi, pad;
};

__device__ __forceinline__ Gate warp_bounds(const float* o, const float* d,
                                            float maxt, bool live,
                                            float origin_pad) {
  Gate g;
  int n_same = 0;
  for (int ax = 0; ax < 3; ++ax) {
    g.same[ax] = __all_sync(kFull, !live || d[ax] > 1e-12f) ||
                 __all_sync(kFull, !live || d[ax] < -1e-12f);
    n_same += g.same[ax] ? 1 : 0;
  }
  // a warp whose directions straddle zero on two axes or three (the
  // hemisphere of diffuse bounce rays) culls too little to pay for the
  // slab tests: every slot passes (warp-uniform)
  g.culls = n_same >= 2;
  g.t_hi = kBig;
  g.pad = 0.0f;
  if (!g.culls) return g;
  float omax = 0.0f;
  for (int ax = 0; ax < 3; ++ax) {
    if (g.same[ax]) {
      float dl = warp_min(live ? d[ax] : INFINITY);
      float dh = warp_max(live ? d[ax] : -INFINITY);
      g.ia[ax] = 1.0f / dl;
      g.ib[ax] = 1.0f / dh;
    }
    g.ol[ax] = warp_min(live ? o[ax] : INFINITY);
    g.oh[ax] = warp_max(live ? o[ax] : -INFINITY);
    omax = fmaxf(omax, fmaxf(fabsf(g.ol[ax]), fabsf(g.oh[ax])));
  }
  g.t_hi = fminf(warp_max(live ? maxt : -INFINITY), kBig);
  g.pad = origin_pad * omax;
  return g;
}

// May a ray of the warp enter box `col` (s_box: 6 rows of `nb`) at a
// distance in [0, t_hi]? Per bounded axis the plane parameters (p - o) / d
// over both padded planes and both ends of the o and d intervals span an
// interval that holds every ray's.
__device__ __forceinline__ bool box_pass(const Gate& g, const float* s_box,
                                         int nb, int col) {
  float t_lo = 0.0f, t_hi = g.t_hi;
  for (int ax = 0; ax < 3; ++ax) {
    if (!g.same[ax]) continue;
    float bmin = s_box[ax * nb + col] - g.pad;
    float bmax = s_box[(3 + ax) * nb + col] + g.pad;
    float n0 = bmin - g.ol[ax], n1 = bmin - g.oh[ax];
    float n2 = bmax - g.ol[ax], n3 = bmax - g.oh[ax];
    float ia = g.ia[ax], ib = g.ib[ax];
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

// The low `count` bits (count <= 32).
__device__ __forceinline__ unsigned lower_bits(int count) {
  return count >= 32 ? kFull : ((1u << count) - 1u);
}

// The warp's masks of `count` boxes from column `col0`, in rounds of 32
// (lane k tests box col0 + 32 r + k), into words[0 ..]. Lane 0 writes; the
// caller syncs the warp.
__device__ __forceinline__ void gate_masks(const Gate& g, const float* s_box,
                                           int nb, int col0, int count,
                                           int lane, unsigned* words) {
  for (int r0 = 0; r0 < count; r0 += 32) {
    const int c = min(32, count - r0);
    const unsigned m = __ballot_sync(
        kFull, lane < c && box_pass(g, s_box, nb, col0 + r0 + lane));
    if (lane == 0) words[r0 >> 5] = m;
  }
}

// One exact test of slot k settled against the lane's state: a hit in
// (0, maxt) closer than b.t replaces b (closest-hit), or marks the lane
// done (any-hit).
template <bool kAnyHit>
__device__ __forceinline__ void settle(bool h, float t, float u, float v,
                                       int k, Best& b, bool& done,
                                       bool& changed) {
  if (kAnyHit) {
    done = done || h;
  } else if (h && t < b.t) {
    b = Best{t, u, v, k};
    changed = true;
  }
}

// The lane's exact tests of the `cnt` (<= 32) slots from `base` whose bits
// are set in `m`, in slot order, against the ray (o, d). A mask that
// passes three quarters of the slots or more is walked as a counted loop
// over all of them, as the dense kernel does (testing a culled slot
// changes nothing), with the any-hit vote once at its end; a sparse one
// bit by bit, with the vote after each test. Returns whether b changed;
// for any-hit, `stop` is set once every lane of the warp is done.
template <bool kAnyHit>
__device__ __forceinline__ bool walk(unsigned m, int base, int cnt,
                                     const float* s_tri, const float* o,
                                     const float* d, float maxt, Best& b,
                                     bool& done, bool& stop) {
  bool changed = false;
  float t, u, v;
  if (__popc(m) * 4 >= 3 * cnt) {
#pragma unroll 1
    for (int k = base; k < base + cnt; ++k) {
      bool h = moller(s_tri + k * kTriRec, o, d, maxt, t, u, v);
      settle<kAnyHit>(h, t, u, v, k, b, done, changed);
    }
    if (kAnyHit && __all_sync(kFull, done)) stop = true;
    return changed;
  }
  while (m) {
    const int k = base + __ffs(m) - 1;
    m &= m - 1;
    bool h = moller(s_tri + k * kTriRec, o, d, maxt, t, u, v);
    settle<kAnyHit>(h, t, u, v, k, b, done, changed);
    if (kAnyHit && __all_sync(kFull, done)) { stop = true; break; }
  }
  return changed;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
intersect_kernel(Params p) {
  extern __shared__ float smem[];
  const int nb = p.n_static + p.n_anim + p.n_sph;   // staged box columns
  // per warp: the gate's mask words (static, ranges, spheres)
  const int w_static = (p.n_static + 31) >> 5;
  const int w_rng = (p.n_anim + 31) >> 5;
  const int w_warp = w_static + w_rng + ((p.n_sph + 31) >> 5);
  float* s_tri = smem;
  float* s_inst = s_tri + p.n_tri * kTriRec;
  float* s_sph = s_inst + p.n_anim * kInstRec;
  float* s_box = s_sph + p.n_sph * kSphRec;
  // closest-hit, per lane: the winner's inverse, and the current
  // instance's (later the winning sphere's hit point)
  float* s_bi = s_box + 6 * nb;                  // (9, kThreads)
  float* s_cur = s_bi + 9 * kThreads;            // (9, kThreads)
  int* s_anim = reinterpret_cast<int*>(s_bi + (kAnyHit ? 0 : 18 * kThreads));
  int* s_sph_anim = s_anim + p.n_anim * 3;
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_sph_anim + p.n_sph);

  // the tables and the boxes, once per block
  for (int k = threadIdx.x; k < p.n_tri * kTriRec; k += blockDim.x)
    s_tri[k] = p.tri[k];
  for (int k = threadIdx.x; k < p.n_anim * kInstRec; k += blockDim.x)
    s_inst[k] = p.inst[k];
  for (int k = threadIdx.x; k < p.n_sph * kSphRec; k += blockDim.x)
    s_sph[k] = p.sph[k];
  for (int k = threadIdx.x; k < 6 * nb; k += blockDim.x) {
    int row = k / nb, c = k - row * nb;
    s_box[k] = p.box[(long long)row * p.box_stride + p.box_col0 + c];
  }
  for (int k = threadIdx.x; k < p.n_anim * 3; k += blockDim.x)
    s_anim[k] = p.anim[k];
  for (int k = threadIdx.x; k < p.n_sph; k += blockDim.x)
    s_sph_anim[k] = p.sph_anim[k];
  __syncthreads();

  const long long lane_id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane_id - (threadIdx.x & 31) >= p.n) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  const bool valid = lane_id < p.n;
  unsigned* wm = s_mask + (threadIdx.x >> 5) * w_warp;

  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  float time = 0.0f, maxt = -1.0f;
  if (valid) {
    o[0] = p.ox[lane_id]; o[1] = p.oy[lane_id]; o[2] = p.oz[lane_id];
    d[0] = p.dx[lane_id]; d[1] = p.dy[lane_id]; d[2] = p.dz[lane_id];
    time = p.time[lane_id];
    maxt = p.maxt[lane_id];
  }
  const bool live = maxt > 0.0f;
  // any-hit: a lane is done once occluded (or if it cannot hit); the warp
  // stops when all are
  bool done = !live, stop = false;

  Best b{INFINITY, 0.0f, 0.0f, -1};
  int best_anim = -1;          // animated range of the winner, -1 none
  int best_sph = -1;           // sphere of the winner: its inverse waits
                               // in s_bi, its hit point in s_cur
  // whether the gate ran slab tests (else every slot passes)
  bool world_culls = false;

  if (__any_sync(kFull, live)) {
    {
      const Gate g = warp_bounds(o, d, maxt, live, p.origin_pad);
      world_culls = g.culls;
      if (world_culls) {
        gate_masks(g, s_box, nb, 0, p.n_static, lane, wm);
        gate_masks(g, s_box, nb, p.n_static, p.n_anim, lane, wm + w_static);
        gate_masks(g, s_box, nb, p.n_static + p.n_anim, p.n_sph, lane,
                   wm + w_static + w_rng);
        __syncwarp();
      }
    }
    // a warp that ran no slab tests walks every slot
    auto mask = [&](int word, int count) {
      return world_culls ? wm[word] : lower_bits(count);
    };

    // ---- static triangles (world space) ---------------------------------
    for (int w = 0; w < w_static && !stop; ++w) {
      const int cnt = min(32, p.n_static - 32 * w);
      walk<kAnyHit>(mask(w, cnt), 32 * w, cnt, s_tri, o, d, maxt, b, done,
                    stop);
    }

    // ---- animated instances (object space at the ray's time) ------------
    for (int wa = 0; wa < w_rng && !stop; ++wa) {
      unsigned ma = mask(w_static + wa, min(32, p.n_anim - 32 * wa));
      while (ma && !stop) {
        const int a = 32 * wa + __ffs(ma) - 1;
        ma &= ma - 1;
        const float* rec = s_inst + a * kInstRec;
        float oo[3], od[3];
        {
          float i3[9], it3[3];
          inv_lerped(rec, rec + 12, rec[24], rec[25], time, true, i3, it3);
          to_object(i3, it3, o, d, oo, od);
          if (!kAnyHit)
            for (int j = 0; j < 9; ++j)
              s_cur[j * kThreads + threadIdx.x] = i3[j];
        }
        const int start = p.n_static + s_anim[a * 3 + 1];
        const int count = s_anim[a * 3 + 2];
        // the instance's triangles, all of them
        bool changed = false;
        for (int r0 = 0; r0 < count && !stop; r0 += 32) {
          const int cnt = min(32, count - r0);
          changed |= walk<kAnyHit>(lower_bits(cnt), start + r0, cnt, s_tri,
                                   oo, od, maxt, b, done, stop);
        }
        if (!kAnyHit && changed) {
          best_anim = a;
#pragma unroll
          for (int j = 0; j < 9; ++j)
            s_bi[j * kThreads + threadIdx.x] =
                s_cur[j * kThreads + threadIdx.x];
        }
      }
    }

    // ---- analytic spheres (unit sphere in object space) -----------------
    const int w_sph0 = w_static + w_rng;
    for (int s0 = 0; s0 < p.n_sph && !stop; s0 += 32) {
      unsigned m = mask(w_sph0 + (s0 >> 5), min(32, p.n_sph - s0));
      while (m && !stop) {
        const int s = s0 + __ffs(m) - 1;
        m &= m - 1;
        const float* rec = s_sph + s * kSphRec;
        float i3[9], it3[3], oo[3], od[3];
        inv_lerped(rec, rec + 12, rec[24], rec[25], time,
                   s_sph_anim[s] != 0, i3, it3);
        to_object(i3, it3, o, d, oo, od);
        float qa = od[0] * od[0] + od[1] * od[1] + od[2] * od[2];
        float qb = 2.0f * (oo[0] * od[0] + oo[1] * od[1] + oo[2] * od[2]);
        float qc = oo[0] * oo[0] + oo[1] * oo[1] + oo[2] * oo[2] - 1.0f;
        float disc = qb * qb - 4.0f * qa * qc;
        bool ok = disc >= 0.0f;
        float sq = sqrtf(fmaxf(disc, 0.0f));
        float q = -0.5f * (qb + (qb >= 0.0f ? sq : -sq));
        float r0 = q / (qa != 0.0f ? qa : 1.0f);
        float r1 = qc / (q != 0.0f ? q : 1.0f);
        float tn = fminf(r0, r1), tf = fmaxf(r0, r1);
        float ts = tn > 0.0f ? tn : tf;
        bool hit = ok && ts > 0.0f && ts < maxt;
        if (kAnyHit) {
          done = done || hit;
          if (__all_sync(kFull, done)) stop = true;
        } else if (hit && ts < b.t) {
          b.t = ts;
          b.slot = kSphSlotBase + s;
          best_sph = s;
          best_anim = -1;
          // the object-space hit point and the inverse, for the payload
          s_cur[threadIdx.x] = oo[0] + od[0] * ts;
          s_cur[kThreads + threadIdx.x] = oo[1] + od[1] * ts;
          s_cur[2 * kThreads + threadIdx.x] = oo[2] + od[2] * ts;
          for (int j = 0; j < 9; ++j) s_bi[j * kThreads + threadIdx.x] = i3[j];
        }
      }
    }
  }

  if (!valid) return;
  if (kAnyHit) {
    p.outi[lane_id] = (done && live) ? 1 : 0;
    return;
  }

  // ---- payload ------------------------------------------------------------
  const long long n = p.n;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  float uvu = 0.0f, uvv = 0.0f, bu = 0.0f, bv = 0.0f;
  int inst_id = -1;
  float bi[9];
  if (best_sph >= 0 || best_anim >= 0)
    for (int j = 0; j < 9; ++j) bi[j] = s_bi[j * kThreads + threadIdx.x];
  if (best_sph >= 0) {
    // object-space normal = hit point; to world by the inverse transpose
    float pnx = s_cur[threadIdx.x], pny = s_cur[kThreads + threadIdx.x];
    float pnz = s_cur[2 * kThreads + threadIdx.x];
    gx = nx = bi[0] * pnx + bi[3] * pny + bi[6] * pnz;
    gy = ny = bi[1] * pnx + bi[4] * pny + bi[7] * pnz;
    gz = nz = bi[2] * pnx + bi[5] * pny + bi[8] * pnz;
    float uu = atan2f(pny, pnx) * 0.15915494309189535f;
    uvu = uu < 0.0f ? uu + 1.0f : uu;
    uvv = acosf(fminf(fmaxf(pnz, -1.0f), 1.0f)) * 0.3183098861837907f;
    inst_id = (int)s_sph[best_sph * kSphRec + 26];
  } else if (b.slot >= 0) {
    const float* r = s_tri + b.slot * kTriRec;
    bu = b.u; bv = b.v;
    float w = 1.0f - bu - bv;
    gx = r[4] * r[8] - r[5] * r[7];
    gy = r[5] * r[6] - r[3] * r[8];
    gz = r[3] * r[7] - r[4] * r[6];
    nx = w * r[9] + bu * r[12] + bv * r[15];
    ny = w * r[10] + bu * r[13] + bv * r[16];
    nz = w * r[11] + bu * r[14] + bv * r[17];
    uvu = w * r[18] + bu * r[20] + bv * r[22];
    uvv = w * r[19] + bu * r[21] + bv * r[23];
    inst_id = (int)r[24];
    if (best_anim >= 0) {
      // normals of animated hits: world = inv(M(t))^T * n_obj, with the
      // inverse the walk computed
      float wx = bi[0] * gx + bi[3] * gy + bi[6] * gz;
      float wy = bi[1] * gx + bi[4] * gy + bi[7] * gz;
      float wz = bi[2] * gx + bi[5] * gy + bi[8] * gz;
      gx = wx; gy = wy; gz = wz;
      wx = bi[0] * nx + bi[3] * ny + bi[6] * nz;
      wy = bi[1] * nx + bi[4] * ny + bi[7] * nz;
      wz = bi[2] * nx + bi[5] * ny + bi[8] * nz;
      nx = wx; ny = wy; nz = wz;
    }
  }
  float* of = p.outf;
  of[0 * n + lane_id] = b.t;
  of[1 * n + lane_id] = bu;
  of[2 * n + lane_id] = bv;
  of[3 * n + lane_id] = gx;
  of[4 * n + lane_id] = gy;
  of[5 * n + lane_id] = gz;
  of[6 * n + lane_id] = nx;
  of[7 * n + lane_id] = ny;
  of[8 * n + lane_id] = nz;
  of[9 * n + lane_id] = uvu;
  of[10 * n + lane_id] = uvv;
  p.outi[lane_id] = b.slot;
  p.outi[n + lane_id] = inst_id;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = ok).
extern "C" int mi_intersect_bruteforce(
    const void* tri, const void* inst, const void* anim, const void* sph,
    const void* sph_anim, const void* box, int n_tri, int n_static,
    int n_anim, int n_sph, int box_stride, int box_col0, float origin_pad, const void* ox, const void* oy, const void* oz, const void* dx, const void* dy, const void* dz,
    const void* time, const void* maxt, long long n, int any_hit,
    void* outf, void* outi, void* stream) {
  Params p;
  p.tri = static_cast<const float*>(tri);
  p.inst = static_cast<const float*>(inst);
  p.anim = static_cast<const int*>(anim);
  p.sph = static_cast<const float*>(sph);
  p.sph_anim = static_cast<const int*>(sph_anim);
  p.box = static_cast<const float*>(box);
  p.n_tri = n_tri; p.n_static = n_static; p.n_anim = n_anim; p.n_sph = n_sph;
  p.box_stride = box_stride; p.box_col0 = box_col0;
  p.origin_pad = origin_pad;
  p.ox = static_cast<const float*>(ox);
  p.oy = static_cast<const float*>(oy);
  p.oz = static_cast<const float*>(oz);
  p.dx = static_cast<const float*>(dx);
  p.dy = static_cast<const float*>(dy);
  p.dz = static_cast<const float*>(dz);
  p.time = static_cast<const float*>(time);
  p.maxt = static_cast<const float*>(maxt);
  p.n = n;
  p.outf = static_cast<float*>(outf);
  p.outi = static_cast<int*>(outi);

  const size_t nb = (size_t)n_static + n_anim + n_sph;
  const size_t warp_words =
      (size_t)((n_static + 31) / 32 + (n_anim + 31) / 32 + (n_sph + 31) / 32);
  size_t smem = sizeof(float) * ((size_t)n_tri * kTriRec +
                                 (size_t)n_anim * kInstRec +
                                 (size_t)n_sph * kSphRec + 6 * nb +
                                 (any_hit ? 0 : 18 * kThreads)) +
                sizeof(int) * ((size_t)n_anim * 3 + (size_t)n_sph) +
                sizeof(unsigned) * warp_words * (kThreads / 32);
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = any_hit ? intersect_kernel<true> : intersect_kernel<false>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kernel<<<blocks, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}
