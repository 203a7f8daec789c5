// Kernel B4: closest-hit / any-hit (t, prim) over 128-triangle chunks with
// Möller-Trumbore, walked front to back, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_v2.py
// `_build_v2_kernel` (Pallas, reached through `intersect_v2`) together with
// the visit lists that the JAX package builds outside it
// (`intersect_mxu._visit_order`). It computes the same function as that
// kernel and as the plain PyTorch version `intersect_v2_reference` of
// mitsuba3dopplertof_tpu_torch/ops/intersect_v2.py: per lane the (t, prim)
// of the Möller-Trumbore winner over the padded chunk table, with maxt
// clamped to 3e38 and to the scene-box exit. A chunk holds 128 triangles of
// one transform group as v0, e1, e2 (nine rows of 128); each of its four
// 32-triangle quarters has a world box, and the chunk's box is their union.
//
// What bounds it on this card: arithmetic, about 56 float operations per
// lane and tested triangle; the quarters (1,152 bytes each) are read once
// per warp that tests them, from L1 and L2.
//
// What the design does about it:
//  * The lists are built in the kernel. One CTA of 256 threads owns one
//    block of 256 lanes. It clamps each lane's maxt by the scene-box exit
//    (`scene_exit`, B2's), reduces the ray bounds of all the block's lanes,
//    slab-tests every chunk box against them within their largest maxt
//    (`_slab_visit_order`'s algebra: `gate_span` / `gate_key`) and sorts the
//    reachable chunks by (t_lo bits << 32 | chunk) with the bitonic network
//    and the capacity rounds of intersect_common.cuh (`list_sort`,
//    `list_round`), so any scene size stays exact.
//  * Warps walk on their own bounds. The walk of warp a's 32 lanes goes
//    down the list with its own far end (closest-hit the largest
//    min(best t, maxt) of its live lanes, any-hit the largest maxt of its
//    live lanes with no hit yet; capped at 1e37), stops at the first entry
//    whose t_lo exceeds it (any-hit also once a ballot shows every live
//    lane occluded) and runs a quarter only if the slab test of its live
//    lanes' ray bounds (`live_gates`) passes the quarter's box within it.
//    There is no CTA barrier in the walk.
//  * Long walks are shared. Every warp's walk is run by all 8 warps of the
//    CTA, a quarter each: quarter s of entry p of warp a's walk goes to
//    warp (p + 2 s) mod 8, which loads a's rays. Each warp thus takes the
//    entries of one parity, a different quarter of each, so the work stays
//    spread whether one quarter of an entry passes its gate or all four.
//    A warp slab-tests 32 of its items at once, one a lane (the boxes'
//    loads in parallel), and runs those that pass in order, each checked
//    again with the far end as it then stands.
//    The lanes' results meet in shared memory by a 64-bit atomicMin of
//    (float bits of t) << 32 | slot, read back before each quarter as the
//    walk's bound: t > 0 on every hit, so its bits order as an unsigned
//    integer. Rows and slots of the table rise together on every triangle
//    that can be hit (the static triangles take slots from 0, then each
//    animated range from n_static + its start, the starts cumulative in
//    `Scene.compile`; pad rows, whose slots may repeat a real one, have
//    zero edges and are never hit; `v2_tables` checks that the chunks'
//    first slots never fall), so the smaller slot at equal t is the plain
//    version's first row: t and prim equal its on every closest-hit lane,
//    in any order of the quarters.
//  * Only what runs is staged: a warp loads a passing quarter (9 rows of
//    32 floats, 1,152 bytes) with coalesced 16-byte loads, stores it in
//    its own slot of shared memory triangle-major between two __syncwarp,
//    and reads each triangle back as three 16-byte broadcasts. A lane
//    moves its ray into a chunk's hit space only when the transform group
//    changes.
//  * Only what can hit is finished: once u is known, a triangle that no
//    lane of the warp can hit (u outside [0, 1] or a failed determinant
//    guard on every lane; u > 1 with v >= 0 gives u + v > 1) is left
//    without v and t. Lanes that go on test the plain version's whole
//    condition, so the decisions and t are unchanged.
// Measured on the H100 (PERF.md): staging the quarter as the table holds
// it (nine rows, four triangles read at a time) took 89 registers, 16
// warps a SM, and ran 13-25% slower; one slab test at a time, with its
// box's load on the walk's critical path, ran 4-12% slower; finishing
// every triangle on every lane ran 7-15% slower.
// The file is built with --fmad=false: every product and sum rounds on its
// own, in the plain version's order, with the |det| > 1e-12 guard, so t on
// hit lanes matches it bit for bit.

#include "intersect_common.cuh"

namespace {

using namespace mi;

constexpr int kT = 128;                  // triangles per chunk
constexpr int kSubs = kT / kChunk;       // 32-triangle quarters per chunk
constexpr int kRows = 9;                 // v0 e1 e2
constexpr int kChunkRec = kRows * kT;    // floats per chunk
constexpr int kQuad = kChunk / 4;        // float4s of a quarter's row
constexpr int kMaxCap = 4096;            // largest list a round may hold
constexpr u64e kNoHit = (0x7F800000ull << 32) | 0xFFFFFFFFull;  // (inf, -1)

struct Scene {
  const float* tri;        // (n_chunks, 9, 128): row c of tri j at c*128+j
  const int* meta;         // (n_chunks, 2): animated range | -1, slot of tri 0
  const float* inst;       // (n_ranges, 26)
  const float* sub;        // (4 n_chunks, 6): quarter boxes, lo xyz, hi xyz
  const float* box;        // (n_chunks, 6): the union of a chunk's quarters
  const float* scene_box;  // (6,): the union of the quarter boxes
  int n_chunks;
  int has_anim;
  int cap;
};

struct Rays {
  RayCols c;
  long long n;
};

// Lane `lane` of the rays: the world ray w (o, d), its time and, where
// maxt is not null, its maxt clamped to 3e38 and to the scene-box exit.
// Lanes past n repeat the last ray with maxt -1 (dead), as
// `intersect_v2.prepare` pads them.
__device__ __forceinline__ void load_lane(const Rays& ry, const float* sb,
                                          long long lane, float* w,
                                          float* time, float* maxt) {
  const long long src = lane < ry.n ? lane : ry.n - 1;
  w[0] = ry.c.ox[src]; w[1] = ry.c.oy[src]; w[2] = ry.c.oz[src];
  w[3] = ry.c.dx[src]; w[4] = ry.c.dy[src]; w[5] = ry.c.dz[src];
  *time = ry.c.time[src];
  if (maxt != nullptr) {
    const float m = lane < ry.n ? ry.c.maxt[src] : -1.0f;
    *maxt = tmin(clamp_big(m), scene_exit(sb, w));
  }
}

// The gate of all the block's lanes, dead ones too, as `_slab_visit_order`
// reduces a block's rays, into s_g (kGateLen floats), with the largest
// clamped maxt as its far end (that function's t_hi; fmaxf skips a NaN
// lane where PyTorch's amax would propagate it). s_part: kWarps * 13
// floats. Starts and ends with the CTA in step.
__device__ __forceinline__ void list_gate(const float* w, float maxt,
                                          float* s_part, float* s_g) {
  float v[13];
  for (int a = 0; a < 3; ++a) {
    v[a] = w[a];
    v[3 + a] = w[a];
    v[6 + a] = w[3 + a];
    v[9 + a] = w[3 + a];
  }
  v[12] = maxt;
  for (int a = 0; a < 13; ++a) {
    const bool is_min = a < 3 || (a >= 6 && a < 9);
    v[a] = is_min ? lanes_min(v[a]) : lanes_max(v[a]);
  }
  if ((threadIdx.x & 31) == 0)
    for (int a = 0; a < 13; ++a) s_part[(threadIdx.x >> 5) * 13 + a] = v[a];
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
    gate_from_bounds(b, s_g);
    s_g[15] = clamp_big(b[12]);
  }
  __syncthreads();
}

// The walk's far end for warp a's lanes: the largest lane_term of its live
// lanes (-3e38 for a dead one), capped at 1e37.
template <bool kAnyHit>
__device__ __forceinline__ float warp_far(bool live, float best_t, int best_p,
                                          float maxt) {
  const float v = live ? lane_term<kAnyHit>(best_t, best_p, maxt) : -kBig;
  return fminf(lanes_max(v), kBoundCap);
}

// The lane's ray against quarter s of chunk k: its nine rows of 32 floats
// are staged in `stage` triangle-major, 12 floats a triangle (v0 e1 e2, 3
// unused), and read back as three 16-byte broadcasts a triangle.
// Möller-Trumbore in the plain version's order of operations, with the
// |det| > 1e-12 guard (`moller_hit`'s arithmetic), leaving a triangle once
// no lane of the warp can hit it; the running best starts just above the
// walk's best t, so that a hit at t = best passes too and meets the
// others by the atomicMin on `best` (whose value was `cb` when the quarter
// started): the smaller slot wins there. Within the quarter the first
// triangle among equal t is kept.
__device__ __forceinline__ void test_quarter(const Scene& sc, int k, int s,
                                             const float* w, float time,
                                             float maxt, u64e cb,
                                             int& cur_ci, float* r,
                                             float* stage, u64e* best) {
  if (sc.has_anim) {
    const int ci = __ldg(sc.meta + 2 * k);
    if (ci != cur_ci) {
      unit_ray(sc.inst, ci, time, w, r);
      cur_ci = ci;
    }
  }
  const int slot0 = __ldg(sc.meta + 2 * k + 1) + s * kChunk;
  // float4 f of the quarter's rows holds component f / 8 of triangles
  // 4 (f % 8) .. 4 (f % 8) + 3: three coalesced loads (the third by 8
  // lanes), then four scalar stores each into the triangle-major stage
  const float4* src = reinterpret_cast<const float4*>(
                          sc.tri + (long long)k * kChunkRec) + s * kQuad;
  const int lane = threadIdx.x & 31;
  const int q = lane & 7;
  const float4 c0 = __ldg(src + (lane >> 3) * (kT / 4) + q);
  const float4 c1 = __ldg(src + (4 + (lane >> 3)) * (kT / 4) + q);
  float4 c2 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (lane < kQuad) c2 = __ldg(src + 8 * (kT / 4) + lane);
  __syncwarp();
  float* d0 = stage + 4 * q * kTriStride;
  d0[lane >> 3] = c0.x;
  d0[kTriStride + (lane >> 3)] = c0.y;
  d0[2 * kTriStride + (lane >> 3)] = c0.z;
  d0[3 * kTriStride + (lane >> 3)] = c0.w;
  d0[4 + (lane >> 3)] = c1.x;
  d0[kTriStride + 4 + (lane >> 3)] = c1.y;
  d0[2 * kTriStride + 4 + (lane >> 3)] = c1.z;
  d0[3 * kTriStride + 4 + (lane >> 3)] = c1.w;
  if (lane < kQuad) {
    float* d2 = stage + 4 * lane * kTriStride + 8;
    d2[0] = c2.x;
    d2[kTriStride] = c2.y;
    d2[2 * kTriStride] = c2.z;
    d2[3 * kTriStride] = c2.w;
  }
  __syncwarp();
  float ub = nextafterf(__uint_as_float((unsigned)(cb >> 32)), INFINITY);
  int uj = -1;
  const float rox = r[0], roy = r[1], roz = r[2];
  const float rdx = r[3], rdy = r[4], rdz = r[5];
#pragma unroll 2
  for (int j = 0; j < kChunk; ++j) {
    const float4* g = reinterpret_cast<const float4*>(stage + j * kTriStride);
    const float4 g0 = g[0], g1 = g[1], g2 = g[2];
    const float v0x = g0.x, v0y = g0.y, v0z = g0.z;
    const float e1x = g0.w, e1y = g1.x, e1z = g1.y;
    const float e2x = g1.z, e2y = g1.w, e2z = g2.x;
    const float px = rdy * e2z - rdz * e2y;
    const float py = rdz * e2x - rdx * e2z;
    const float pz = rdx * e2y - rdy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > 1e-12f;
    const float inv = 1.0f / (ok ? det : 1.0f);
    const float tx = rox - v0x;
    const float ty = roy - v0y;
    const float tz = roz - v0z;
    const float u = (tx * px + ty * py + tz * pz) * inv;
    // u > 1 with v >= 0 makes u + v > 1: no lane of the warp can hit
    if (!__any_sync(0xffffffffu, ok && u >= 0.0f && u <= 1.0f)) continue;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (rdx * qx + rdy * qy + rdz * qz) * inv;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
    if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
        t < maxt && t < ub) {
      ub = t;
      uj = j;
    }
  }
  if (uj >= 0) {
    const u64e h = ((u64e)__float_as_uint(ub) << 32) | (unsigned)(slot0 + uj);
    if (h < cb) atomicMin(best, h);
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    v2_walk_kernel(Scene sc, Rays ry, float* t_out, int* prim_out) {
  extern __shared__ u64e s_list[];
  __shared__ u64e s_best[kBlock];
  __shared__ float s_maxt[kBlock];
  __shared__ float s_part[kWarps * 13];
  __shared__ float s_lgate[kGateLen];
  __shared__ float s_block[kGateLen];
  __shared__ float s_gate[kWarps * kGateLen];
  __shared__ __align__(16) float s_stage[kWarps][kChunk * kTriStride];
  __shared__ int s_n, s_more;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)blockIdx.x * kBlock;
  {
    float w[6], time, maxt;
    load_lane(ry, sc.scene_box, base + tid, w, &time, &maxt);
    s_maxt[tid] = maxt;
    s_best[tid] = kNoHit;
    list_gate(w, maxt, s_part, s_lgate);
    live_gates(w, maxt, s_part, s_block, s_gate);
  }

  bool has_last = false;
  u64e last = 0;
  for (;;) {
    const int m = list_round(
        sc.n_chunks, sc.cap,
        [&](int k) { return gate_key(s_lgate, sc.box + 6LL * k); }, has_last,
        last, s_list, &s_n, &s_more);
    const bool more = s_more != 0;
    for (int a = 0; a < kWarps; ++a) {
      const float* ga = s_gate + a * kGateLen;
      if (!(ga[15] >= 0.0f)) continue;          // no live lane in warp a
      const int ta = a * 32 + lane;
      float wa[6], time_a;
      load_lane(ry, sc.scene_box, base + ta, wa, &time_a, nullptr);
      const float maxt_a = s_maxt[ta];
      const bool live_a = maxt_a > 0.0f;
      float r[6] = {wa[0], wa[1], wa[2], wa[3], wa[4], wa[5]};
      int cur_ci = -2;
      volatile u64e* best_a = s_best + ta;
      // quarter s of entry p goes to warp (p + 2 s) mod kWarps: this warp
      // takes the entries of its parity, 32 at a time, lane i gating the
      // i-th of them with the far end as it stands; then runs the quarters
      // that pass, in order, each with the far end as it stands then
      bool done = false;
      for (int p0 = warp & 1; p0 < m && !done; p0 += 64) {
        u64e cb = *best_a;
        int bp = (int)(unsigned)(cb & 0xFFFFFFFFull);
        if (kAnyHit && __ballot_sync(0xffffffffu, live_a && bp < 0) == 0u)
          break;                                 // every live lane occluded
        float far = warp_far<kAnyHit>(
            live_a, __uint_as_float((unsigned)(cb >> 32)), bp, maxt_a);
        const int p = p0 + 2 * lane;
        float key = kBig, lo = kBig, ex = -kBig;
        int k = 0;
        if (p < m) {
          const u64e e = s_list[p];
          key = list_key(e);
          k = list_item(e);
          if (key <= far)
            gate_span(ga, sc.sub + 6LL * (k * kSubs + (((warp - p) &
                                                        (kWarps - 1)) >> 1)),
                      &lo, &ex);
        }
        // the entries are sorted: those within the far end are a prefix
        done = __ballot_sync(0xffffffffu, p < m && key <= far) != 0xffffffffu;
        unsigned bits = __ballot_sync(0xffffffffu, key <= far &&
                                                       lo <= fminf(ex, far));
        while (bits != 0u) {
          const int i = __ffs(bits) - 1;
          bits &= bits - 1u;
          cb = *best_a;
          bp = (int)(unsigned)(cb & 0xFFFFFFFFull);
          if (kAnyHit &&
              __ballot_sync(0xffffffffu, live_a && bp < 0) == 0u) {
            done = true;                         // every live lane occluded
            break;
          }
          far = warp_far<kAnyHit>(
              live_a, __uint_as_float((unsigned)(cb >> 32)), bp, maxt_a);
          if (__shfl_sync(0xffffffffu, key, i) > far) {
            done = true;                         // and so is every later one
            break;
          }
          if (!(__shfl_sync(0xffffffffu, lo, i) <=
                fminf(__shfl_sync(0xffffffffu, ex, i), far)))
            continue;                            // the far end moved in
          const int pi = p0 + 2 * i;
          test_quarter(sc, __shfl_sync(0xffffffffu, k, i),
                       ((warp - pi) & (kWarps - 1)) >> 1, wa, time_a, maxt_a,
                       cb, cur_ci, r, s_stage[warp], s_best + ta);
        }
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

// The visit lists alone (a check of the walk's lists, not a path): per
// block the reachable chunks sorted by (t_lo, chunk), then the unreachable
// ones in index order with key 3e38 -- the rows of a stable argsort of the
// keys, as `_visit_order` gives them -- and the number reachable.
__global__ void __launch_bounds__(kBlock)
    v2_lists_kernel(Scene sc, Rays ry, int* order_out, float* tlo_out,
                    int* len_out) {
  extern __shared__ u64e s_list[];
  __shared__ float s_part[kWarps * 13];
  __shared__ float s_lgate[kGateLen];
  __shared__ int s_count[kWarps];
  __shared__ int s_n, s_more;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)blockIdx.x * kBlock;
  float w[6], time, maxt;
  load_lane(ry, sc.scene_box, base + tid, w, &time, &maxt);
  list_gate(w, maxt, s_part, s_lgate);
  auto key = [&](int k) { return gate_key(s_lgate, sc.box + 6LL * k); };
  int* order = order_out + (long long)blockIdx.x * sc.n_chunks;
  float* tlo = tlo_out + (long long)blockIdx.x * sc.n_chunks;

  int written = 0;
  bool has_last = false;
  u64e last = 0;
  for (;;) {
    const int m = list_round(sc.n_chunks, sc.cap, key, has_last, last,
                             s_list, &s_n, &s_more);
    const bool more = s_more != 0;
    for (int i = tid; i < m; i += kBlock) {
      const int k = list_item(s_list[i]);
      order[written + i] = k;
      tlo[written + i] = key(k);
    }
    written += m;
    if (!more) break;
    last = s_list[m - 1];
    has_last = true;
    __syncthreads();
  }
  if (tid == 0) len_out[blockIdx.x] = written;
  for (int k0 = 0; k0 < sc.n_chunks; k0 += kBlock) {
    const int k = k0 + tid;
    const bool out = k < sc.n_chunks && !(key(min(k, sc.n_chunks - 1)) < kBig);
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
      order[at] = k;
      tlo[at] = kBig;
    }
    written += total;
    __syncthreads();
  }
}

Scene make_scene(const void* tri, const void* meta, const void* inst,
                 const void* sub, const void* box, const void* scene_box,
                 int n_chunks, int has_anim, int cap) {
  Scene s;
  s.tri = static_cast<const float*>(tri);
  s.meta = static_cast<const int*>(meta);
  s.inst = static_cast<const float*>(inst);
  s.sub = static_cast<const float*>(sub);
  s.box = static_cast<const float*>(box);
  s.scene_box = static_cast<const float*>(scene_box);
  s.n_chunks = n_chunks;
  s.has_anim = has_anim;
  s.cap = cap;
  return s;
}

}  // namespace

extern "C" int mi_intersect_v2_block() { return kBlock; }
extern "C" int mi_intersect_v2_max_cap() { return kMaxCap; }

// Launch on `stream` over n lanes, one CTA per block of kBlock lanes (the
// last one ragged), with lists of at most `cap` chunks a round; returns
// cudaGetLastError() of the launch (0 = ok).
extern "C" int mi_intersect_v2(
    const void* tri, const void* meta, const void* inst, const void* sub,
    const void* box, const void* scene_box, int n_chunks, int has_anim,
    int cap, const void* ox, const void* oy, const void* oz, const void* dx,
    const void* dy, const void* dz, const void* time, const void* maxt,
    long long n, int any_hit, void* t_out, void* prim_out, void* stream) {
  if (n <= 0 || n_chunks <= 0 || cap <= 0 || cap > kMaxCap)
    return (int)cudaErrorInvalidValue;
  const Scene sc = make_scene(tri, meta, inst, sub, box, scene_box, n_chunks,
                              has_anim, cap);
  const Rays ry = {ray_cols(ox, oy, oz, dx, dy, dz, time, maxt), n};
  const unsigned int blocks = (unsigned int)((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(t_out);
  int* prim = static_cast<int*>(prim_out);
  size_t bytes;
  int err;
  if (any_hit) {
    if ((err = list_bytes(v2_walk_kernel<true>, n_chunks, cap, &bytes)))
      return err;
    v2_walk_kernel<true><<<blocks, kBlock, bytes, s>>>(sc, ry, t, prim);
  } else {
    if ((err = list_bytes(v2_walk_kernel<false>, n_chunks, cap, &bytes)))
      return err;
    v2_walk_kernel<false><<<blocks, kBlock, bytes, s>>>(sc, ry, t, prim);
  }
  return (int)cudaGetLastError();
}

// The visit lists of the n lanes' blocks: order_out and tlo_out (n_blocks,
// n_chunks), len_out (n_blocks,) reachable chunks per block.
extern "C" int mi_intersect_v2_lists(
    const void* box, const void* scene_box, int n_chunks, int cap,
    const void* ox, const void* oy, const void* oz, const void* dx,
    const void* dy, const void* dz, const void* time, const void* maxt,
    long long n, void* order_out, void* tlo_out, void* len_out,
    void* stream) {
  if (n <= 0 || n_chunks <= 0 || cap <= 0 || cap > kMaxCap)
    return (int)cudaErrorInvalidValue;
  const Scene sc = make_scene(nullptr, nullptr, nullptr, nullptr, box,
                              scene_box, n_chunks, 0, cap);
  const Rays ry = {ray_cols(ox, oy, oz, dx, dy, dz, time, maxt), n};
  const unsigned int blocks = (unsigned int)((n + kBlock - 1) / kBlock);
  size_t bytes;
  int err;
  if ((err = list_bytes(v2_lists_kernel, n_chunks, cap, &bytes))) return err;
  v2_lists_kernel<<<blocks, kBlock, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      sc, ry, static_cast<int*>(order_out), static_cast<float*>(tlo_out),
      static_cast<int*>(len_out));
  return (int)cudaGetLastError();
}
