// Brute-force closest-hit / any-hit ray intersection for small scenes
// (at most 192 triangles), for NVIDIA Hopper (sm_90a).
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
// What bounds it on this card: every ray tests every triangle, so each
// thread reads the whole table (25 floats per triangle, up to 19.2 KB) and
// spends about 40 float operations per ray-triangle pair; per ray it moves
// 32 bytes in and 52 bytes out of device memory. With at most 192
// triangles the arithmetic stays small and the ray traffic dominates.
//
// What the design does about it: one thread per ray, so ray loads and
// payload stores are coalesced; each block copies the tables into shared
// memory once, and all threads of a warp then read the same record, which
// shared memory broadcasts without bank conflicts. The loop visits slots in
// the TPU kernel's order (static, animated ranges, spheres) with strict
// `t < best` tests, so ties resolve to the same slot. The file is built
// with --fmad=false: every product and sum rounds on its own, as in the
// plain PyTorch version, so triangle hits match it bit for bit. Sphere uv
// uses atan2f/acosf, as the plain version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTriRec = 25;     // v0 e1 e2 | n0 n1 n2 | uv0 uv1 uv2 | inst
constexpr int kInstRec = 26;    // m0 (3x4) | m1 (3x4) | t0 | t1
constexpr int kSphRec = 27;     // m0 (3x4) | m1 (3x4) | t0 | t1 | inst
constexpr int kSphSlotBase = 1 << 28;
constexpr int kThreads = 256;

struct Params {
  const float* tri;      // (n_tri, 25)
  const float* inst;     // (n_anim, 26)
  const int* anim;       // (n_anim, 3): instance id, start, count
  const float* sph;      // (n_sph, 27)
  const int* sph_anim;   // (n_sph,)
  int n_tri, n_static, n_anim, n_sph;
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

struct Best {
  float t, u, v;
  int slot, rec;   // rec: triangle record index of the winner, -1 none
};

// One Möller-Trumbore test, in the plain version's operation order.
__device__ __forceinline__ bool test_tri(const float* r, float rox,
                                         float roy, float roz, float rdx,
                                         float rdy, float rdz, float maxt,
                                         float best_t, float* t_out,
                                         float* u_out, float* v_out) {
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
  float u = (tx * px + ty * py + tz * pz) * inv;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v = (rdx * qx + rdy * qy + rdz * qz) * inv;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  *t_out = t; *u_out = u; *v_out = v;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
         t < maxt && t < best_t;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
intersect_kernel(Params p) {
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_inst = s_tri + p.n_tri * kTriRec;
  float* s_sph = s_inst + p.n_anim * kInstRec;
  int* s_anim = reinterpret_cast<int*>(s_sph + p.n_sph * kSphRec);
  int* s_sph_anim = s_anim + p.n_anim * 3;

  // the tables, once per block
  for (int k = threadIdx.x; k < p.n_tri * kTriRec; k += blockDim.x)
    s_tri[k] = p.tri[k];
  for (int k = threadIdx.x; k < p.n_anim * kInstRec; k += blockDim.x)
    s_inst[k] = p.inst[k];
  for (int k = threadIdx.x; k < p.n_sph * kSphRec; k += blockDim.x)
    s_sph[k] = p.sph[k];
  for (int k = threadIdx.x; k < p.n_anim * 3; k += blockDim.x)
    s_anim[k] = p.anim[k];
  for (int k = threadIdx.x; k < p.n_sph; k += blockDim.x)
    s_sph_anim[k] = p.sph_anim[k];
  __syncthreads();

  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n) return;

  const float ox = p.ox[lane], oy = p.oy[lane], oz = p.oz[lane];
  const float dx = p.dx[lane], dy = p.dy[lane], dz = p.dz[lane];
  const float time = p.time[lane], maxt = p.maxt[lane];

  Best b{INFINITY, 0.0f, 0.0f, -1, -1};
  int best_anim = -1;          // animated range of the winner, -1 none
  float t, u, v;

  // ---- static triangles (world space) -----------------------------------
  for (int k = 0; k < p.n_static; ++k) {
    if (test_tri(s_tri + k * kTriRec, ox, oy, oz, dx, dy, dz, maxt, b.t,
                 &t, &u, &v)) {
      if (kAnyHit) { p.outi[lane] = 1; return; }
      b = Best{t, u, v, k, k};
      best_anim = -1;
    }
  }

  // ---- animated instances (object space at the ray's time) --------------
  for (int a = 0; a < p.n_anim; ++a) {
    const float* rec = s_inst + a * kInstRec;
    float i3[9], it3[3];
    inv_lerped(rec, rec + 12, rec[24], rec[25], time, true, i3, it3);
    float oox = i3[0] * ox + i3[1] * oy + i3[2] * oz + it3[0];
    float ooy = i3[3] * ox + i3[4] * oy + i3[5] * oz + it3[1];
    float ooz = i3[6] * ox + i3[7] * oy + i3[8] * oz + it3[2];
    float odx = i3[0] * dx + i3[1] * dy + i3[2] * dz;
    float ody = i3[3] * dx + i3[4] * dy + i3[5] * dz;
    float odz = i3[6] * dx + i3[7] * dy + i3[8] * dz;
    int start = s_anim[a * 3 + 1], count = s_anim[a * 3 + 2];
    for (int k = 0; k < count; ++k) {
      int slot = p.n_static + start + k;
      if (test_tri(s_tri + slot * kTriRec, oox, ooy, ooz, odx, ody, odz,
                   maxt, b.t, &t, &u, &v)) {
        if (kAnyHit) { p.outi[lane] = 1; return; }
        b = Best{t, u, v, slot, slot};
        best_anim = a;
      }
    }
  }

  // ---- analytic spheres (unit sphere in object space) -------------------
  int best_sph = -1;
  float sph_n[3] = {0.0f, 0.0f, 0.0f}, sph_uv[2] = {0.0f, 0.0f};
  for (int s = 0; s < p.n_sph; ++s) {
    const float* rec = s_sph + s * kSphRec;
    float i3[9], it3[3];
    inv_lerped(rec, rec + 12, rec[24], rec[25], time, s_sph_anim[s] != 0,
               i3, it3);
    float oox = i3[0] * ox + i3[1] * oy + i3[2] * oz + it3[0];
    float ooy = i3[3] * ox + i3[4] * oy + i3[5] * oz + it3[1];
    float ooz = i3[6] * ox + i3[7] * oy + i3[8] * oz + it3[2];
    float odx = i3[0] * dx + i3[1] * dy + i3[2] * dz;
    float ody = i3[3] * dx + i3[4] * dy + i3[5] * dz;
    float odz = i3[6] * dx + i3[7] * dy + i3[8] * dz;
    float qa = odx * odx + ody * ody + odz * odz;
    float qb = 2.0f * (oox * odx + ooy * ody + ooz * odz);
    float qc = oox * oox + ooy * ooy + ooz * ooz - 1.0f;
    float disc = qb * qb - 4.0f * qa * qc;
    bool ok = disc >= 0.0f;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float q = -0.5f * (qb + (qb >= 0.0f ? sq : -sq));
    float r0 = q / (qa != 0.0f ? qa : 1.0f);
    float r1 = qc / (q != 0.0f ? q : 1.0f);
    float tn = fminf(r0, r1), tf = fmaxf(r0, r1);
    float ts = tn > 0.0f ? tn : tf;
    if (!(ok && ts > 0.0f && ts < maxt && ts < b.t)) continue;
    if (kAnyHit) { p.outi[lane] = 1; return; }
    b.t = ts;
    b.slot = kSphSlotBase + s;
    best_sph = s;
    best_anim = -1;
    // object-space normal = hit point; to world by the inverse transpose
    float pnx = oox + odx * ts, pny = ooy + ody * ts, pnz = ooz + odz * ts;
    sph_n[0] = i3[0] * pnx + i3[3] * pny + i3[6] * pnz;
    sph_n[1] = i3[1] * pnx + i3[4] * pny + i3[7] * pnz;
    sph_n[2] = i3[2] * pnx + i3[5] * pny + i3[8] * pnz;
    float uu = atan2f(pny, pnx) * 0.15915494309189535f;
    sph_uv[0] = uu < 0.0f ? uu + 1.0f : uu;
    sph_uv[1] = acosf(fminf(fmaxf(pnz, -1.0f), 1.0f)) * 0.3183098861837907f;
  }

  if (kAnyHit) { p.outi[lane] = 0; return; }

  // ---- payload ------------------------------------------------------------
  const long long n = p.n;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  float uvu = 0.0f, uvv = 0.0f, bu = 0.0f, bv = 0.0f;
  int inst_id = -1;
  if (best_sph >= 0) {
    gx = nx = sph_n[0]; gy = ny = sph_n[1]; gz = nz = sph_n[2];
    uvu = sph_uv[0]; uvv = sph_uv[1];
    inst_id = (int)s_sph[best_sph * kSphRec + 26];
  } else if (b.rec >= 0) {
    const float* r = s_tri + b.rec * kTriRec;
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
      // normals of animated hits: world = inv(M(t))^T * n_obj
      const float* rec = s_inst + best_anim * kInstRec;
      float i3[9], it3[3];
      inv_lerped(rec, rec + 12, rec[24], rec[25], time, true, i3, it3);
      float wx = i3[0] * gx + i3[3] * gy + i3[6] * gz;
      float wy = i3[1] * gx + i3[4] * gy + i3[7] * gz;
      float wz = i3[2] * gx + i3[5] * gy + i3[8] * gz;
      gx = wx; gy = wy; gz = wz;
      wx = i3[0] * nx + i3[3] * ny + i3[6] * nz;
      wy = i3[1] * nx + i3[4] * ny + i3[7] * nz;
      wz = i3[2] * nx + i3[5] * ny + i3[8] * nz;
      nx = wx; ny = wy; nz = wz;
    }
  }
  float* o = p.outf;
  o[0 * n + lane] = b.t;
  o[1 * n + lane] = bu;
  o[2 * n + lane] = bv;
  o[3 * n + lane] = gx;
  o[4 * n + lane] = gy;
  o[5 * n + lane] = gz;
  o[6 * n + lane] = nx;
  o[7 * n + lane] = ny;
  o[8 * n + lane] = nz;
  o[9 * n + lane] = uvu;
  o[10 * n + lane] = uvv;
  p.outi[lane] = b.slot;
  p.outi[n + lane] = inst_id;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = ok).
extern "C" int mi_intersect_bruteforce(
    const void* tri, const void* inst, const void* anim, const void* sph,
    const void* sph_anim, int n_tri, int n_static, int n_anim, int n_sph,
    const void* ox, const void* oy, const void* oz, const void* dx,
    const void* dy, const void* dz, const void* time, const void* maxt,
    long long n, int any_hit, void* outf, void* outi, void* stream) {
  Params p;
  p.tri = static_cast<const float*>(tri);
  p.inst = static_cast<const float*>(inst);
  p.anim = static_cast<const int*>(anim);
  p.sph = static_cast<const float*>(sph);
  p.sph_anim = static_cast<const int*>(sph_anim);
  p.n_tri = n_tri; p.n_static = n_static; p.n_anim = n_anim; p.n_sph = n_sph;
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

  size_t smem = sizeof(float) * ((size_t)n_tri * kTriRec +
                                 (size_t)n_anim * kInstRec +
                                 (size_t)n_sph * kSphRec) +
                sizeof(int) * ((size_t)n_anim * 3 + (size_t)n_sph);
  unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(intersect_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    intersect_kernel<true><<<blocks, kThreads, smem, s>>>(p);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(intersect_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    intersect_kernel<false><<<blocks, kThreads, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}
