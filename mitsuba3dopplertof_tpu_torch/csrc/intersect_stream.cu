// Kernel B3: streamed closest-hit with the full hit record, or any-hit
// (t, prim), over every 32-triangle chunk that passes a two-level slab test,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_stream.py
// `_build_stream_kernel` (Pallas, reached through `intersect_stream`). It
// computes the same function as that kernel and as the plain PyTorch version
// `intersect_stream_reference` of
// mitsuba3dopplertof_tpu_torch/ops/intersect_stream.py. The padded triangle
// table holds 25 floats per triangle (v0 e1 e2, three normals, three uvs,
// instance id) in chunks of 32, each chunk of one transform group with a
// world box; eight consecutive chunks form a group with the union box. There
// is no ordering and no scene-box clamp: a block of kBlock lanes goes
// through the groups in table order, tests a group's box, then each of its
// chunks' boxes, with t_hi = min(largest maxt, largest best t) of the block
// as the far end (-3e38 once every lane of an any-hit block is occluded),
// and runs Möller-Trumbore over the chunks that pass. Rays go to a chunk's
// object space by the per-lane inverse of the keyframe-lerped matrix; the
// winner's normals go back to world space by its inverse transpose.
//
// What bounds it on this card: arithmetic. Without ordering a block tests
// every chunk its frustum touches up to the largest best t, several times
// the chunks an ordered walk needs; each costs 32 Möller tests of about 56
// float operations per lane. Registers come second: the hit record has 13
// fields.
//
// What the design does about it: one CTA per block, one thread per ray;
// during the scan a thread keeps only t, slot, table row and Möller's u, v of
// its best hit, and the normals and uv are interpolated once after the
// scan from the winner's record (the TPU kernel updates all 13 fields at
// every hit; the values are the same expressions of the same inputs). A
// chunk's nine geometry floats per triangle are staged triangle-major in
// shared memory; the block's t_hi is recomputed (one CTA-wide max) only
// after a chunk that ran. Built with --fmad=false: t, u, v, normals and uv
// match the plain version bit for bit, and since chunks are taken in table
// order with strict t < best, so does the winning slot.

#include "intersect_common.cuh"

namespace {

using namespace mi;

constexpr int kTriRec = 25;            // floats per triangle of the table
constexpr int kGeom = 9;               // v0 e1 e2
constexpr int kCpg = 8;                // chunks per group box

struct Params {
  const float* tri;    // (n_chunks * 32, 25)
  const int* meta;     // (n_chunks, 2): animated range | -1, slot of tri 0
  const float* aabb;   // (n_chunks, 6): lo xyz, hi xyz
  const float* grp;    // (n_chunks / 8, 6)
  const float* inst;   // (n_ranges, 26)
  int n_chunks;        // a multiple of 8
  int has_anim;
  RayCols ray;
  long long n;
  float* outf;         // (11, n): t u v gx gy gz nx ny nz uu vv — or (1, n): t
  int* outi;           // (2, n): prim inst — or (1, n): prim
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) stream_kernel(Params p) {
  __shared__ __align__(16) float s_tri[kChunk * kTriStride];
  __shared__ float s_red[kWarps];
  __shared__ float s_part[kWarps * 12];
  __shared__ float s_bb[12];

  const int tid = threadIdx.x;
  const long long lane = (long long)blockIdx.x * kBlock + tid;
  const float w[6] = {p.ray.ox[lane], p.ray.oy[lane], p.ray.oz[lane],
                      p.ray.dx[lane], p.ray.dy[lane], p.ray.dz[lane]};
  const float time = p.ray.time[lane], maxt = p.ray.maxt[lane];

  block_ray_bounds(w, s_part, s_bb);
  const float mt_blk = fminf(block_max(maxt, s_red), kBig);

  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_p = -1, best_row = 0;
  int cur_ci = -2;                       // transform group of r[] (-2: none)
  float r[6] = {w[0], w[1], w[2], w[3], w[4], w[5]};

  // nothing is hit yet: the largest best t is +inf, capped at 3e38
  float t_hi = mt_blk;
  const int n_groups = p.n_chunks / kCpg;
  for (int g = 0; g < n_groups; ++g) {
    if (!slab_test(s_bb, p.grp + 6 * (long long)g, t_hi)) continue;
    for (int c = 0; c < kCpg; ++c) {
      const int k = g * kCpg + c;
      if (!slab_test(s_bb, p.aabb + 6 * (long long)k, t_hi)) continue;
      for (int q = tid; q < kChunk * kGeom; q += kBlock) {
        int j = q / kGeom, cc = q - j * kGeom;
        s_tri[j * kTriStride + cc] =
            p.tri[((long long)k * kChunk + j) * kTriRec + cc];
      }
      __syncthreads();
      if (p.has_anim) {
        int ci = p.meta[2 * k];
        if (ci != cur_ci) {
          unit_ray(p.inst, ci, time, w, r);
          cur_ci = ci;
        }
      }
      const int slot0 = p.meta[2 * k + 1];
#pragma unroll 4
      for (int j = 0; j < kChunk; ++j) {
        float t, u, v;
        if (moller_hit(s_tri + j * kTriStride, r, maxt, best_t, &t, &u, &v)) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_p = slot0 + j;
          best_row = k * kChunk + j;
        }
      }
      // the first barrier of the max ends the reads of the staged chunk
      float worst = block_max(best_t, s_red);
      t_hi = fminf(mt_blk, fminf(worst, kBig));
      if (kAnyHit && worst < INFINITY) t_hi = -kBig;   // all lanes occluded
    }
  }

  const long long n = p.n;
  p.outf[lane] = best_t;
  p.outi[lane] = best_p;
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
  for (int f = 0; f < 10; ++f) p.outf[(f + 1) * n + lane] = out[f];
  p.outi[n + lane] = inst_id;
}

}  // namespace

extern "C" int mi_intersect_stream_block() { return mi::kBlock; }

// Launch on `stream` over n lanes (a multiple of kBlock); returns
// cudaGetLastError() of the launch (0 = ok).
extern "C" int mi_intersect_stream(
    const void* tri, const void* meta, const void* aabb, const void* grp,
    const void* inst, int n_chunks, int has_anim, const void* ox,
    const void* oy, const void* oz, const void* dx, const void* dy,
    const void* dz, const void* time, const void* maxt, long long n,
    int any_hit, void* outf, void* outi, void* stream) {
  if (n <= 0 || n % kBlock != 0 || n_chunks <= 0 || n_chunks % kCpg != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.tri = static_cast<const float*>(tri);
  p.meta = static_cast<const int*>(meta);
  p.aabb = static_cast<const float*>(aabb);
  p.grp = static_cast<const float*>(grp);
  p.inst = static_cast<const float*>(inst);
  p.n_chunks = n_chunks;
  p.has_anim = has_anim;
  p.ray = ray_cols(ox, oy, oz, dx, dy, dz, time, maxt);
  p.n = n;
  p.outf = static_cast<float*>(outf);
  p.outi = static_cast<int*>(outi);
  unsigned int blocks = (unsigned int)(n / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    stream_kernel<true><<<blocks, kBlock, 0, s>>>(p);
  else
    stream_kernel<false><<<blocks, kBlock, 0, s>>>(p);
  return (int)cudaGetLastError();
}
