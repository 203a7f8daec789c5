// Kernel B6: closest-hit / any-hit (t, prim) with the ray-triangle test as
// an affine map of the ray, for NVIDIA Hopper (sm_90a): per 128-triangle
// chunk the (768 x 8) . (8 x lanes) product runs on the tensor cores in
// TF32 as a conservative gate, and the exact float32 test runs only on the
// pairs that the gate passes.
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_mxu.py
// `_build_mxu_kernel` (Pallas, reached through `intersect_mxu`), which runs
// the product on the TPU's matrix unit at its highest precision. It computes
// the same function as that kernel and as the plain PyTorch version
// `intersect_mxu_reference` of
// mitsuba3dopplertof_tpu_torch/ops/intersect_mxu.py: with the ray features
// X = [ox oy oz 1 dx dy dz maxt] and a chunk's Woop table W, o' and d' of
// every triangle (components o'x o'y o'z d'x d'y d'z), t = -o'z / d'z
// (guarded by |d'z| > 1e-30), u = o'x + t d'x, v = o'y + t d'y; hit if
// min(u, v) >= 0, u + v <= 1 and t in (0, maxt). The chunk's smallest t
// wins (the lowest triangle among equal minima) if it is strictly below the
// lane's best. PyTorch has sorted the chunks per block of kBlock lanes by
// the entry distance of the union of their four 32-triangle boxes (no
// scene-box clamp on this route).
//
// What bounds it on this card: the CUDA cores' instruction rate. The
// product is 96 flops a pair, which the tensor cores do at 495 TF32
// TFLOP/s; the parent kernel formed it with 90 float32 instructions a
// pair (half of W is structural zeros), and TF32 keeps about three
// digits where t must stay float32 bit for bit. What is left on the
// CUDA cores is the gate's epilogue, 32 instructions a pair in the SASS,
// the queueing of the pairs it passes and their exact tests, at 16
// resident warps a SM (94 registers) that hide little of those
// instructions' latency.
//
// What the design does about it:
//  * Each warp owns its 32 rays and walks the block's visit list alone,
//    with its own bound t_hi = the largest over its lanes of min(best,
//    maxt) (any-hit: maxt while unoccluded, -3e38 once occluded), and
//    a slab test of the chunk's four boxes against its live lanes' ray
//    bounds, eight list entries at a time (one box a lane, reciprocals of
//    the bounds taken once); it stops at a t_lo beyond the bound or at
//    the unreachable tail of the list: no block-wide barrier in the
//    walk.
//  * mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, 3 row tiles x 4 ray
//    tiles per group of 8 triangles. A = W, rounded to TF32 in PyTorch
//    (round to nearest, ties away, as cvt.rna.tf32.f32) and stored in
//    fragment order (one 16-byte load per tile and lane, read from L1/L2
//    by the CTA's 8 warps). Rows g and g + 8 of a tile are two components
//    of triangle g (tile 0: o'x, o'y; tile 1: o'z, d'x; tile 2: d'y, d'z),
//    so after a group's mma thread (g, c) holds all six components of
//    triangle g for rays 2c and 2c + 1 of each ray tile: no shuffle.
//    B = [ox oy oz 1 dx dy dz 0] of the warp's rays in the chunk's hit
//    space (unit_ray once per transform-group change, through 1 KB of
//    shared memory per warp), rounded by cvt.rna.tf32.f32; maxt meets
//    zeros in W and is left out, a dead lane (maxt <= 0) gives zeros.
//  * The gate's error radius. With x~, w~ the TF32 values and a^ the
//    plain version's float32 ordered sum of the eight products, the
//    tensor core's value a~ = sum w~_k x~_k differs from the exact sum
//    a = sum w_k x_k by at most (2 * 2^-11 + 2^-22) sum |w_k x_k| from
//    rounding both inputs, plus its accumulation of eight exact products
//    (in an unspecified order and rounding; a few float32 ulps of the
//    largest partial sum, under 8 * 2^-23 sum |w~_k x~_k|), and a^
//    differs from a by at most 8 * 2^-24 sum |w_k x_k|: in all under
//    1.01 * 2^-10 sum |w_k x_k| <= 1.01 * 2^-10 S M, with S = sum_k |w_k|
//    of the component (a table column) and M = max(|ox|, |oy|, |oz|, 1)
//    for o', max(|dx|, |dy|, |dz|) for d' (here the largest over the
//    warp's live lanes, which only widens it). The radius is
//    r = eps S M with eps = 2^-9, twice that.
//  * The reject rule, without a division. Where |d'z~| > r_dz the sign s
//    of d'z is known; with Dz = |d'z~|, Oz = s o'z~, the projective
//    barycentric U = u* Dz = o'x Dz - Oz d'x and likewise V, the
//    intervals [value +- radius] (products by midpoint and radius:
//    |xy - x~y~| <= (|x~| + rx) ry + |y~| rx) prove a miss if Oz >= r_oz
//    (t <= 0), or -(Oz + r_oz) >= T (Dz + r_dz) with
//    T = min(maxt, the lanes' best at the chunk's start) (1 + 2^-20)
//    (t >= T), or U + R_U < 0, or V + R_V < 0, or
//    (U - R_U) + (V - R_V) > Dz + r_dz (u + v > 1). The plain version's
//    own float32 epilogue can accept a pair whose real-number u, v or t
//    lies outside by a few ulps of |u|, |t d'x|, ...; the half of the
//    radius that the input errors do not use is at least 2^-10 of each
//    term, which covers that and the gate's own rounding many times over.
//    A pair whose d'z interval holds 0 always goes to the exact test. A
//    triangle whose d'z row is zero (degenerate, pad) never hits; its
//    table radii for o'z and d'z are -1, so its sign test passes and its
//    t > 0 test rejects. The gate's fused multiply-adds are explicit
//    (__fmaf_rn); the file is built with --fmad=false for the exact test.
//  * Pairs that pass go, by ballot and a prefix count, into a per-warp
//    ring of (triangle, ray); whenever it holds 32, the warp runs 32
//    exact tests at once, one per lane, and each hit goes into its ray's
//    (t bits << 32 | prim) by a 64-bit atomicMin in shared memory: the
//    lowest prim among equal t within the chunk, strict t < the best at
//    the chunk's start across chunks, as the plain version does. The
//    exact test reads the float32 Woop rows, not the TF32 copy, and skips
//    the structural zeros: o' = ((w0 ox + w1 oy) + w2 oz) + w3,
//    d' = (w4 dx + w5 dy) + w6 dz, which differ from the plain version's
//    8-term ordered sums only in the sign of a zero: the same hit
//    decisions and bitwise the same t on hit lanes.

#include "intersect_common.cuh"

namespace {

using namespace mi;

constexpr int kT = 128;                // triangles per chunk
constexpr int kSubs = kT / kChunk;     // 32-triangle boxes per chunk
constexpr int kGroups = kT / 8;        // groups of 8 triangles
constexpr int kFragChunk = kGroups * 3 * 32;   // float4 A fragments a chunk
constexpr int kRing = 128;             // entries of a warp's ring
constexpr float kTSlack = 1.0f + 0x1p-20f;
constexpr unsigned long long kNoHit = 0x7F800000FFFFFFFFull;  // (inf, -1)

struct Params {
  const float4* frag;  // (n_chunks, 16, 3, 32) A fragments of W in TF32
  const float4* rad;   // (n_chunks * 128, 2): eps S of 6 components, 0, 0
  const float4* rec;   // (n_chunks * 128, 3): Woop rows r0 c0 r1 c1 r2 c2
  const int* meta;     // (n_chunks, 2): animated range | -1, slot of tri 0
  const float* inst;   // (n_ranges, 26)
  const float* sub;    // (4 n_chunks, 6): lo xyz, hi xyz
  const int* order;    // (n_blocks, n_chunks): chunks by entry distance
  const float* tlo;    // (n_blocks, n_chunks): the sorted entry distances
  int n_chunks;
  int has_anim;
  const float* x;      // (8, n): ox oy oz 1 dx dy dz maxt
  const float* time;   // (n,)
  long long n;
  float* t_out;        // (n,)
  int* prim_out;       // (n,)
};

struct WarpSmem {
  float ray[32][8];               // o xyz, d xyz in the hit space, maxt
  unsigned long long key[32];     // best (t bits << 32 | prim) per ray
  float bstart[32];               // best t at the chunk's start
  int ring[kRing];                // passed pairs: triangle << 5 | ray
  float gate[15];                 // per axis: the live lanes' o min, o max,
                                  // 1 / d min, 1 / d max, d of one sign
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D = A (16 x 8, TF32) . B (8 x 8, TF32), float32 accumulate from zero.
__device__ __forceinline__ void mma_tf32(float* d, const float4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)),
        "r"(__float_as_uint(a.z)), "r"(__float_as_uint(a.w)), "r"(b0),
        "r"(b1), "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// The slab test of the warp's ray bounds against one box (lo xyz, hi
// xyz), `slab_test` of intersect_common.cuh with the reciprocals of the d
// bounds taken once (g: per axis o lo, o hi, 1 / d lo, 1 / d hi, whether d
// keeps one sign): true if a ray of the warp may enter the box at a
// distance in [0, t_hi].
__device__ __forceinline__ bool warp_slab(const float* g, const float* box,
                                          float t_hi) {
  float t_lo = 0.0f;
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
      t_lo = fmaxf(t_lo, lo);
      t_hi = fminf(t_hi, hi);
    }
  }
  return t_lo <= t_hi;
}

// The conservative gate of one pair (the header note derives it): false
// only where the exact test cannot accept. o, d: the tensor cores' o', d';
// r*: their radii; tq: min(maxt, best) * kTSlack, -inf for a dead lane.
// mxu_gate_reference of ops/intersect_mxu.py is its plain version.
__device__ __forceinline__ bool gate_pass(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float rox, float roy, float roz,
                                          float rdx, float rdy, float rdz,
                                          float tq) {
  const float dzm = fabsf(dz);
  const float ozs = dz < 0.0f ? -oz : oz;
  const float dhi = dzm + rdz;
  const float ozr = fabsf(ozs) + roz;
  const float ru = __fmaf_rn(fabsf(ox) + rox, rdz,
                             __fmaf_rn(dzm, rox,
                                       __fmaf_rn(ozr, rdx, fabsf(dx) * roz)));
  const float rv = __fmaf_rn(fabsf(oy) + roy, rdz,
                             __fmaf_rn(dzm, roy,
                                       __fmaf_rn(ozr, rdy, fabsf(dy) * roz)));
  const float u = __fmaf_rn(ox, dzm, -(ozs * dx));
  const float v = __fmaf_rn(oy, dzm, -(ozs * dy));
  const bool reject = (ozs >= roz) | (__fmaf_rn(tq, dhi, ozs + roz) <= 0.0f) |
                      (u + ru < 0.0f) | (v + rv < 0.0f) |
                      ((u - ru) + (v - rv) > dhi);
  return (tq > 0.0f) & !((dzm > rdz) & reject);
}

// The exact float32 Woop test of ray r[6] against one triangle's rows,
// the plain version's order of operations with W's structural zeros
// skipped; true on a hit in (0, maxt) strictly below best, with t set.
__device__ __forceinline__ bool woop_exact(const float4* rec, const float* r,
                                           float maxt, float best,
                                           float* t_out) {
  const float4 w0 = __ldg(rec), w1 = __ldg(rec + 1), w2 = __ldg(rec + 2);
  const float ozp = ((w2.x * r[0] + w2.y * r[1]) + w2.z * r[2]) + w2.w;
  const float dzp = (w2.x * r[3] + w2.y * r[4]) + w2.z * r[5];
  const float oxp = ((w0.x * r[0] + w0.y * r[1]) + w0.z * r[2]) + w0.w;
  const float dxp = (w0.x * r[3] + w0.y * r[4]) + w0.z * r[5];
  const float oyp = ((w1.x * r[0] + w1.y * r[1]) + w1.z * r[2]) + w1.w;
  const float dyp = (w1.x * r[3] + w1.y * r[4]) + w1.z * r[5];
  const bool dz_ok = fabsf(dzp) > 1e-30f;
  const float t = -ozp / (dz_ok ? dzp : 1.0f);
  const float u = oxp + t * dxp;
  const float v = oyp + t * dyp;
  *t_out = t;
  return dz_ok && fminf(u, v) >= 0.0f && u + v <= 1.0f && t > 0.0f &&
         t < maxt && t < best;
}

// Exact tests of the `cnt` (<= 32) ring entries from `head`, one a lane,
// for chunk k; hits go to their rays' keys.
__device__ __forceinline__ void flush(WarpSmem& sw, const Params& p, int k,
                                      int slot0, int head, int cnt,
                                      int lane) {
  __syncwarp();
  if (lane < cnt) {
    const int e = sw.ring[(head + lane) & (kRing - 1)];
    const int j = e >> 5, rr = e & 31;
    float t;
    if (woop_exact(p.rec + 3 * ((long long)k * kT + j), sw.ray[rr],
                   sw.ray[rr][6], sw.bstart[rr], &t))
      atomicMin(&sw.key[rr],
                ((unsigned long long)__float_as_uint(t) << 32) |
                    (unsigned int)(slot0 + j));
  }
  __syncwarp();
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) mxu_kernel(Params p) {
  __shared__ WarpSmem s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  WarpSmem& sw = s_warp[threadIdx.x >> 5];
  const int g = lane >> 2, c = lane & 3;
  const long long n = p.n;
  const long long id = (long long)blockIdx.x * kBlock + threadIdx.x;
  const float wr[6] = {p.x[id], p.x[n + id], p.x[2 * n + id],
                       p.x[4 * n + id], p.x[5 * n + id], p.x[6 * n + id]};
  const float maxt = p.x[7 * n + id];
  const float time = p.time[id];
  const bool live = maxt > 0.0f;
  const int n_chunks = p.n_chunks;
  const int* order = p.order + (long long)(blockIdx.x) * n_chunks;
  const float* tlo = p.tlo + (long long)(blockIdx.x) * n_chunks;

  // the live lanes' ray bounds for the slab test of a chunk's boxes
  for (int a = 0; a < 3; ++a) {
    const float lo_o = lanes_min(live ? wr[a] : INFINITY);
    const float hi_o = lanes_max(live ? wr[a] : -INFINITY);
    const float lo_d = lanes_min(live ? wr[3 + a] : INFINITY);
    const float hi_d = lanes_max(live ? wr[3 + a] : -INFINITY);
    if (lane == 0) {
      const bool same = (lo_d > 1e-12f) || (hi_d < -1e-12f);
      sw.gate[5 * a] = lo_o;
      sw.gate[5 * a + 1] = hi_o;
      sw.gate[5 * a + 2] = 1.0f / (same ? lo_d : 1.0f);
      sw.gate[5 * a + 3] = 1.0f / (same ? hi_d : 1.0f);
      sw.gate[5 * a + 4] = same ? 1.0f : 0.0f;
    }
  }
  sw.key[lane] = kNoHit;
  sw.ray[lane][6] = maxt;
  __syncwarp();

  float best_t = INFINITY;
  int best_p = -1;
  int cur_ci = -2;                 // transform group of the features (none)
  uint32_t bf[4][2];               // B fragments: 4 ray tiles
  float m_o = 0.0f, m_d = 0.0f;    // the warp's largest |o| (or 1), |d|
  float t_hi = lanes_max(lane_term<kAnyHit>(best_t, best_p, maxt));

  // The walk, 32 / kSubs list entries at a time: lane 4e + s tests box s
  // of entry v0 + e with the bound as it stands; an entry runs if one of
  // its boxes passed and the walk has not stopped at a t_lo beyond the
  // bound (or at the unreachable entries, keyed kBig, at the list's end).
  bool done = false;
  for (int v0 = 0; v0 < n_chunks && !done; v0 += 32 / kSubs) {
    const int ve = v0 + lane / kSubs;
    bool box_ok = false;
    if (ve < n_chunks) {
      const float tl = tlo[ve];
      if (tl <= t_hi && tl < kBig)
        box_ok = warp_slab(sw.gate,
                           p.sub + 6 * ((long long)order[ve] * kSubs +
                                        lane % kSubs),
                           t_hi);
    }
    const unsigned boxes = __ballot_sync(0xffffffffu, box_ok);
    for (int e = 0; e < 32 / kSubs; ++e) {
      const int v = v0 + e;
      if (v >= n_chunks || !(tlo[v] <= t_hi && tlo[v] < kBig)) {
        done = true;
        break;
      }
      if (((boxes >> (kSubs * e)) & ((1u << kSubs) - 1u)) == 0u) continue;
      const int k = order[v];
      const int ci = p.has_anim ? p.meta[2 * k] : -1;
      if (ci != cur_ci) {
        float r[6];
        if (p.has_anim) {
          unit_ray(p.inst, ci, time, wr, r);
        } else {
          for (int a = 0; a < 6; ++a) r[a] = wr[a];
        }
        cur_ci = ci;
        __syncwarp();
        for (int a = 0; a < 6; ++a) sw.ray[lane][a] = r[a];
        m_o = lanes_max(live ? fmaxf(fmaxf(fabsf(r[0]), fabsf(r[1])),
                                    fmaxf(fabsf(r[2]), 1.0f))
                            : 0.0f);
        m_d = lanes_max(live ? fmaxf(fmaxf(fabsf(r[3]), fabsf(r[4])),
                                    fabsf(r[5]))
                            : 0.0f);
        __syncwarp();
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* rr = sw.ray[nt * 8 + g];
          const bool rl = rr[6] > 0.0f;
          const float b0 = c < 3 ? rr[c] : 1.0f;
          const float b1 = c < 3 ? rr[3 + c] : 0.0f;
          bf[nt][0] = tf32_rna(rl ? b0 : 0.0f);
          bf[nt][1] = tf32_rna(rl ? b1 : 0.0f);
        }
      }
      // the gate's bound for the thread's 8 rays: nt * 8 + 2c + j
      __syncwarp();
      sw.bstart[lane] = best_t;
      __syncwarp();
      float tq[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rr = (i >> 1) * 8 + 2 * c + (i & 1);
        const float mt = sw.ray[rr][6], bs = sw.bstart[rr];
        const bool open = mt > 0.0f && (!kAnyHit || bs == INFINITY);
        tq[i] = open ? fminf(mt, bs) * kTSlack : -INFINITY;
      }

      const int slot0 = p.meta[2 * k + 1];
      const float4* fk = p.frag + (long long)k * kFragChunk;
      const float4* rk = p.rad + 2 * (long long)k * kT;
      int head = 0, tail = 0;        // the ring, warp-uniform
      for (int q = 0; q < kGroups; ++q) {
        float4 a[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) a[m] = __ldg(fk + (q * 3 + m) * 32 + lane);
        const float4 s0 = __ldg(rk + 2 * (q * 8 + g));
        const float4 s1 = __ldg(rk + 2 * (q * 8 + g) + 1);
        const float rox = s0.x * m_o, roy = s0.y * m_o, roz = s0.z * m_o;
        const float rdx = s0.w * m_d, rdy = s1.x * m_d, rdz = s1.y * m_d;
        const int tri = q * 8 + g;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float acc[3][4];
          for (int m = 0; m < 3; ++m) mma_tf32(acc[m], a[m], bf[nt][0],
                                               bf[nt][1]);
          bool pass[2];
          for (int j = 0; j < 2; ++j)
            pass[j] = gate_pass(acc[0][j], acc[0][2 + j], acc[1][j],
                                acc[1][2 + j], acc[2][j], acc[2][2 + j], rox,
                                roy, roz, rdx, rdy, rdz, tq[nt * 2 + j]);
          const unsigned b0 = __ballot_sync(0xffffffffu, pass[0]);
          const unsigned b1 = __ballot_sync(0xffffffffu, pass[1]);
          if (b0 | b1) {
            const unsigned below = (1u << lane) - 1u;
            const int n0 = __popc(b0), n1 = __popc(b1);
            const int ray = nt * 8 + 2 * c;
            if (pass[0])
              sw.ring[(tail + __popc(b0 & below)) & (kRing - 1)] =
                  (tri << 5) | ray;
            if (pass[1])
              sw.ring[(tail + n0 + __popc(b1 & below)) & (kRing - 1)] =
                  (tri << 5) | (ray + 1);
            tail += n0 + n1;
            while (tail - head >= 32) {
              flush(sw, p, k, slot0, head, 32, lane);
              head += 32;
            }
          }
        }
      }
      if (tail > head) flush(sw, p, k, slot0, head, tail - head, lane);
      const unsigned long long key = sw.key[lane];
      best_t = __uint_as_float((unsigned int)(key >> 32));
      best_p = (int)(unsigned int)key;
      t_hi = fminf(lanes_max(lane_term<kAnyHit>(best_t, best_p, maxt)), kBig);
    }
  }
  p.t_out[id] = best_t;
  p.prim_out[id] = best_p;
}

}  // namespace

extern "C" int mi_intersect_mxu_block() { return mi::kBlock; }

// Launch on `stream` over n lanes (a multiple of kBlock, one visit list per
// block); returns cudaGetLastError() of the launch (0 = ok).
extern "C" int mi_intersect_mxu(
    const void* frag, const void* rad, const void* rec, const void* meta,
    const void* inst, const void* sub, const void* order, const void* tlo,
    int n_chunks, int has_anim, const void* x, const void* time, long long n,
    int any_hit, void* t_out, void* prim_out, void* stream) {
  if (n <= 0 || n % kBlock != 0 || n_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.frag = static_cast<const float4*>(frag);
  p.rad = static_cast<const float4*>(rad);
  p.rec = static_cast<const float4*>(rec);
  p.meta = static_cast<const int*>(meta);
  p.inst = static_cast<const float*>(inst);
  p.sub = static_cast<const float*>(sub);
  p.order = static_cast<const int*>(order);
  p.tlo = static_cast<const float*>(tlo);
  p.n_chunks = n_chunks;
  p.has_anim = has_anim;
  p.x = static_cast<const float*>(x);
  p.time = static_cast<const float*>(time);
  p.n = n;
  p.t_out = static_cast<float*>(t_out);
  p.prim_out = static_cast<int*>(prim_out);
  unsigned int blocks = (unsigned int)(n / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    mxu_kernel<true><<<blocks, kBlock, 0, s>>>(p);
  else
    mxu_kernel<false><<<blocks, kBlock, 0, s>>>(p);
  return (int)cudaGetLastError();
}
