// Kernel B3: streamed closest-hit with the full hit record, or any-hit
// (t, prim), over 32-triangle chunks in groups of eight, walked front to
// back by each warp alone, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_stream.py
// `_build_stream_kernel` (Pallas, reached through `intersect_stream`). It
// computes the same function as that kernel and as the plain PyTorch version
// `intersect_stream_reference` of
// mitsuba3dopplertof_tpu_torch/ops/intersect_stream.py: per lane the
// Möller-Trumbore winner over every row of the padded triangle table (25
// floats a triangle: v0 e1 e2, three normals, three uvs, instance id), each
// chunk of 32 rows in its transform group's hit space, with 0 < t < maxt and
// |det| > 1e-12; the first row wins among equal t; the 13-field record is
// interpolated from the winner's row. Rays go to a chunk's object space by
// the per-lane inverse of the keyframe-lerped matrix; the winner's normals
// go back to world space by its inverse transpose. Any-hit promises only
// occlusion. No scene-box clamp, as on the TPU.
//
// What bounds it on this card: arithmetic. Each chunk a warp tests costs
// each of its lanes 32 Möller tests of about 56 float operations; the rays,
// the group and chunk boxes and the geometry (1.5 KB a chunk) are read from
// L1 and L2.
//
// What the design does about it:
//  * Order. One CTA of 256 threads owns one block of 256 lanes. It reduces
//    the ray bounds of its live lanes (maxt > 0: padding and the lanes
//    whose camera ray missed cannot hit, so leaving them out is exact),
//    slab-tests every group box (the union of eight chunk boxes) within
//    the live lanes' largest maxt (capped at 3e38), and sorts the
//    reachable groups by (t_lo bits << 32 | group) in dynamic shared
//    memory: intersect_common.cuh's bitonic network and capacity rounds,
//    shared with B2 (`cap` entries a round, so any scene size stays
//    exact). That is the CTA's one barrier phase; a further round, where
//    more than `cap` groups are reachable, starts with the next.
//  * Warps walk alone. A warp keeps the gate of its own live lanes
//    (shuffle reductions) and its own far end: closest-hit the largest
//    over its live lanes of min(best t, maxt), any-hit the largest maxt of
//    its live lanes that have no hit yet, both capped at 3e38. It stops at
//    the first entry whose block t_lo exceeds the far end (the block's t_lo
//    is never above the warp's), and any-hit as soon as a ballot shows
//    every live lane occluded. Lane 8e + c slab-tests chunk c of entry
//    v0 + e, four entries at a time; a chunk runs if its box passes with
//    the far end as it stands when the walk reaches it (the ballot
//    prefilters with the far end at the four entries' start, the lane's
//    span comes back by shuffle), in entry order, its eight chunks in
//    table order. The warp stages a chunk's geometry (the tables'
//    triangle-major `geom`, three coalesced 16-byte loads a lane) in its
//    own slot of shared memory between two __syncwarp, and a lane moves
//    its ray to a chunk's hit space only when the transform group
//    changes. No CTA barrier inside the walk.
//  * The tie rule does not depend on the order: a lane takes a hit if
//    t < best t, or t equals it and the row is lower. So the winner is the
//    first row among equal t whatever order the chunks run in; during the
//    walk a lane keeps only t, u, v, slot and row, and the record is
//    interpolated once from the winner's row at the end.
// Built with --fmad=false: t, u, v, the normals and the uv match the plain
// version bit for bit.

#include <limits.h>

#include "intersect_common.cuh"

namespace {

using namespace mi;

constexpr int kTriRec = 25;            // floats per triangle of the table
constexpr int kCpg = 8;                // chunks per group box
constexpr int kEntries = 32 / kCpg;    // entries a warp's lanes gate at once
constexpr int kMaxCap = 4096;          // largest list a round may hold

struct Params {
  const float* tri;     // (n_chunks * 32, 25): the records
  const float4* geom;   // (n_chunks * 32, 3): v0 e1 e2, 0 0 0 per triangle
  const int* meta;      // (n_chunks, 2): animated range | -1, slot of tri 0
  const float* aabb;    // (n_chunks, 6): lo xyz, hi xyz
  const float* grp;     // (n_chunks / 8, 6)
  const float* inst;    // (n_ranges, 26)
  int n_chunks;         // a multiple of 8
  int has_anim;
  int cap;
  RayCols ray;
  long long n;
  float* outf;          // (11, n): t u v gx gy gz nx ny nz uu vv, or (1, n)
  int* outi;            // (2, n): prim inst, or (1, n): prim
};

// The warp's far end: the largest term (lane_term) of its live lanes,
// capped at 3e38; -3e38 where no live lane has one.
template <bool kAnyHit>
__device__ __forceinline__ float warp_far(bool live, float best_t, int best_p,
                                          float maxt) {
  const float v = live ? lane_term<kAnyHit>(best_t, best_p, maxt) : -kBig;
  return fminf(lanes_max(v), kBig);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) stream_kernel(Params p) {
  extern __shared__ u64e s_list[];
  __shared__ float s_part[kWarps * 13];
  __shared__ float s_block[kGateLen];
  __shared__ float s_gate[kWarps * kGateLen];
  __shared__ float4 s_stage[kWarps][kChunk * 3];
  __shared__ int s_n, s_more;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long id = (long long)blockIdx.x * kBlock + tid;
  const float w[6] = {p.ray.ox[id], p.ray.oy[id], p.ray.oz[id],
                      p.ray.dx[id], p.ray.dy[id], p.ray.dz[id]};
  const float time = p.ray.time[id], maxt = p.ray.maxt[id];
  const bool live = maxt > 0.0f;
  live_gates(w, maxt, s_part, s_block, s_gate);
  const float* gw = s_gate + warp * kGateLen;
  float4* stage = s_stage[warp];
  const float* tri = reinterpret_cast<const float*>(stage);

  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_p = -1, best_row = INT_MAX;
  int cur_ci = -2;                       // transform group of r[] (-2: none)
  float r[6] = {w[0], w[1], w[2], w[3], w[4], w[5]};
  float far = gw[15];                    // nothing hit yet: the largest maxt
  bool done = !(far >= 0.0f);            // no live lane

  const int n_groups = p.n_chunks / kCpg;
  bool has_last = false;
  u64e last = 0;
  for (;;) {
    const int m = list_round(
        n_groups, p.cap,
        [&](int g) { return gate_key(s_block, p.grp + 6LL * g); }, has_last,
        last, s_list, &s_n, &s_more);
    const bool more = s_more != 0;
    for (int v0 = 0; v0 < m && !done; v0 += kEntries) {
      // lane kCpg * e + c: the span of chunk c of entry v0 + e
      const int ve = v0 + lane / kCpg;
      float c_lo = kBig, c_ex = -kBig;
      if (ve < m) {
        const u64e e = s_list[ve];
        if (list_key(e) <= far)
          gate_span(gw, p.aabb + 6LL * (list_item(e) * kCpg + lane % kCpg),
                    &c_lo, &c_ex);
      }
      const unsigned pass =
          __ballot_sync(0xffffffffu, c_lo <= fminf(c_ex, far));
      for (int e = 0; e < kEntries && !done; ++e) {
        const int v = v0 + e;
        if (v >= m) break;
        const u64e ent = s_list[v];
        if (list_key(ent) > far) {
          done = true;
          break;
        }
        unsigned bits = (pass >> (kCpg * e)) & ((1u << kCpg) - 1u);
        while (bits != 0u) {
          const int c = __ffs(bits) - 1;
          bits &= bits - 1u;
          const float lo = __shfl_sync(0xffffffffu, c_lo, kCpg * e + c);
          const float ex = __shfl_sync(0xffffffffu, c_ex, kCpg * e + c);
          if (!(lo <= fminf(ex, far))) continue;  // the far end moved in
          const int k = list_item(ent) * kCpg + c;
          if (p.has_anim) {
            const int ci = __ldg(p.meta + 2 * k);
            if (ci != cur_ci) {
              unit_ray(p.inst, ci, time, w, r);
              cur_ci = ci;
            }
          }
          const int slot0 = __ldg(p.meta + 2 * k + 1);
          const int row0 = k * kChunk;
          const float4* src = p.geom + 3LL * row0;
          const float4 g0 = __ldg(src + lane), g1 = __ldg(src + 32 + lane);
          const float4 g2 = __ldg(src + 64 + lane);
          __syncwarp();
          stage[lane] = g0;
          stage[32 + lane] = g1;
          stage[64 + lane] = g2;
          __syncwarp();
#pragma unroll 4
          for (int j = 0; j < kChunk; ++j) {
            float t, u, vv;
            if (moller_hit(tri + j * kTriStride, r, maxt, INFINITY, &t, &u,
                           &vv) &&
                (t < best_t || (t == best_t && row0 + j < best_row))) {
              best_t = t;
              best_u = u;
              best_v = vv;
              best_p = slot0 + j;
              best_row = row0 + j;
            }
          }
          far = warp_far<kAnyHit>(live, best_t, best_p, maxt);
          if (kAnyHit &&
              __ballot_sync(0xffffffffu, live && best_p < 0) == 0u) {
            done = true;                 // every live lane occluded
            break;
          }
        }
      }
    }
    __syncthreads();                     // every warp has read the round
    if (!more) break;
    last = s_list[m - 1];
    has_last = true;
  }

  const long long n = p.n;
  p.outf[id] = best_t;
  p.outi[id] = best_p;
  if (kAnyHit) return;

  float out[10] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int inst_id = 0;
  if (best_p >= 0) {
    const float* rec = p.tri + (long long)best_row * kTriRec;
    const float u = best_u, v = best_v;
    const float wgt = 1.0f - u - v;
    const float e1x = rec[3], e1y = rec[4], e1z = rec[5];
    const float e2x = rec[6], e2y = rec[7], e2z = rec[8];
    float gx = e1y * e2z - e1z * e2y;
    float gy = e1z * e2x - e1x * e2z;
    float gz = e1x * e2y - e1y * e2x;
    float nx = wgt * rec[9] + u * rec[12] + v * rec[15];
    float ny = wgt * rec[10] + u * rec[13] + v * rec[16];
    float nz = wgt * rec[11] + u * rec[14] + v * rec[17];
    if (p.has_anim) {
      // normals to world space by the inverse transpose at the lane's time
      int ci = p.meta[2 * (best_row / kChunk)];
      float i3[9], it3[3];
      inv_lerped(p.inst + (ci > 0 ? ci : 0) * kInstRec, time, i3, it3);
      float fa = ci >= 0 ? 1.0f : 0.0f;
      float om = 1.0f - fa;
      float wgx = fa * (i3[0] * gx + i3[3] * gy + i3[6] * gz) + om * gx;
      float wgy = fa * (i3[1] * gx + i3[4] * gy + i3[7] * gz) + om * gy;
      float wgz = fa * (i3[2] * gx + i3[5] * gy + i3[8] * gz) + om * gz;
      float wnx = fa * (i3[0] * nx + i3[3] * ny + i3[6] * nz) + om * nx;
      float wny = fa * (i3[1] * nx + i3[4] * ny + i3[7] * nz) + om * ny;
      float wnz = fa * (i3[2] * nx + i3[5] * ny + i3[8] * nz) + om * nz;
      gx = wgx; gy = wgy; gz = wgz;
      nx = wnx; ny = wny; nz = wnz;
    }
    out[0] = u; out[1] = v;
    out[2] = gx; out[3] = gy; out[4] = gz;
    out[5] = nx; out[6] = ny; out[7] = nz;
    out[8] = wgt * rec[18] + u * rec[20] + v * rec[22];
    out[9] = wgt * rec[19] + u * rec[21] + v * rec[23];
    inst_id = (int)rec[24];
  }
  for (int f = 0; f < 10; ++f) p.outf[(f + 1) * n + id] = out[f];
  p.outi[n + id] = inst_id;
}

}  // namespace

extern "C" int mi_intersect_stream_block() { return mi::kBlock; }
extern "C" int mi_intersect_stream_max_cap() { return kMaxCap; }

// Launch on `stream` over n lanes (a multiple of kBlock), with group lists
// of at most `cap` entries a round; returns cudaGetLastError() of the
// launch (0 = ok).
extern "C" int mi_intersect_stream(
    const void* tri, const void* geom, const void* meta, const void* aabb,
    const void* grp, const void* inst, int n_chunks, int has_anim, int cap,
    const void* ox, const void* oy, const void* oz, const void* dx,
    const void* dy, const void* dz, const void* time, const void* maxt,
    long long n, int any_hit, void* outf, void* outi, void* stream) {
  if (n <= 0 || n % kBlock != 0 || n_chunks <= 0 || n_chunks % kCpg != 0 ||
      cap <= 0 || cap > kMaxCap)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.tri = static_cast<const float*>(tri);
  p.geom = static_cast<const float4*>(geom);
  p.meta = static_cast<const int*>(meta);
  p.aabb = static_cast<const float*>(aabb);
  p.grp = static_cast<const float*>(grp);
  p.inst = static_cast<const float*>(inst);
  p.n_chunks = n_chunks;
  p.has_anim = has_anim;
  p.cap = cap;
  p.ray = ray_cols(ox, oy, oz, dx, dy, dz, time, maxt);
  p.n = n;
  p.outf = static_cast<float*>(outf);
  p.outi = static_cast<int*>(outi);
  unsigned int blocks = (unsigned int)(n / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t bytes;
  int err;
  if (any_hit) {
    if ((err = list_bytes(stream_kernel<true>, n_chunks / kCpg, cap,
                          &bytes)))
      return err;
    stream_kernel<true><<<blocks, kBlock, bytes, s>>>(p);
  } else {
    if ((err = list_bytes(stream_kernel<false>, n_chunks / kCpg, cap,
                          &bytes)))
      return err;
    stream_kernel<false><<<blocks, kBlock, bytes, s>>>(p);
  }
  return (int)cudaGetLastError();
}
