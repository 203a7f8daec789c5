// Kernel B2: closest-hit / any-hit (t, prim) over 32-triangle Woop units,
// walked front to back per block of rays, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_v4.py
// `_build_v4_kernel` (Pallas, reached through `_v4_call` / `intersect_v4`).
// It computes the same function as that kernel and as the plain PyTorch
// version `intersect_v4_reference` in
// mitsuba3dopplertof_tpu_torch/ops/intersect_v4.py. Each unit holds 32
// triangles as 12 Woop coefficients each (the rows of [e1 | e2 | n]^-1 and
// their offsets). A unit of an animated range is tested with the lane's ray
// moved into object space by the inverse of the keyframe-lerped 3x4 matrix
// at the lane's own time. PyTorch has already sorted, for every block of
// kBlock lanes, the units by a conservative entry distance t_lo (3e38 for a
// unit the block cannot reach) and clamped each lane's maxt to the scene box
// (dead lanes: maxt < 0).
//
// What bounds it on this card: arithmetic. Each visited unit costs every
// lane 32 ray-triangle tests of about 40 float operations; the rays (32
// bytes in, 8 out per lane) and the visit lists (8 bytes per block and
// unit) are read once, and the Woop records (1.5 KB per unit) are read
// once per block that visits the unit, mostly from L2.
//
// What the design does about it: one CTA per visit block, one thread per
// ray, so the block's bound is a CTA-wide max. The CTA walks its list in
// groups of kGroup units: it stages the group's records into shared memory
// (triangle-major, so a thread reads a triangle's 12 coefficients as three
// 16-byte broadcasts), every thread tests its ray against the group, and a
// block-wide max of min(t, maxt) (-3e38 for an any-hit lane with a hit,
// capped at 1e37) decides whether the next group's first t_lo can still
// matter. Because the list is sorted, the units a block still needs are
// always a prefix, so that one compare is the whole gate. An index past the
// list end repeats the last unit, which is idempotent under strict
// t < best. The lane's object-space ray stays in registers while
// consecutive units share an animated range. The file is built with
// --fmad=false: every product and sum rounds on its own, in the plain
// version's order, so t on hit lanes matches it bit for bit; degenerate and
// pad triangles have zero rows, t = -0/0 is NaN, and every comparison
// rejects it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;            // lanes per CTA = lanes per visit list
constexpr int kGroup = 8;              // units per step of the walk
constexpr int kChunk = 32;             // triangles per unit
constexpr int kCoef = 12;              // Woop coefficients per triangle
constexpr int kUnitRec = kCoef * kChunk;
constexpr int kInstRec = 26;           // m0 (3x4) | m1 (3x4) | t0 | t1
constexpr float kBig = 3.0e38f;
constexpr float kBoundCap = 1.0e37f;   // below the 3e38 key of unreachable

struct Params {
  const float* woop;   // (n_units, 384): coefficient c of triangle j at c*32+j
  const int* meta;     // (n_units, 2): animated range | -1, slot of tri 0
  const float* inst;   // (n_ranges, 26)
  const int* order;    // (n_blocks, n_units): units by entry distance
  const float* tlo;    // (n_blocks, n_units): the sorted entry distances
  int n_units;
  int has_anim;
  const float* ox; const float* oy; const float* oz;
  const float* dx; const float* dy; const float* dz;
  const float* time; const float* maxt;
  float* t_out;        // (n,)
  int* prim_out;       // (n,)
};

// The ray in the hit space of a unit of transform group `ci` (-1 static):
// fa * (M(t)^-1 x) + om * x with fa = 1 for animated units, as the plain
// version (and the TPU kernel) compute it; M(t) is the clamped keyframe lerp
// of the record's two matrices (reference transform.h:458-466).
__device__ __forceinline__ void unit_ray(const float* rec, int ci,
                                         float time, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float* r) {
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
  r[0] = fa * (i0 * ox + i1 * oy + i2 * oz + n0) + om * ox;
  r[1] = fa * (i3 * ox + i4 * oy + i5 * oz + n1) + om * oy;
  r[2] = fa * (i6 * ox + i7 * oy + i8 * oz + n2) + om * oz;
  r[3] = fa * (i0 * dx + i1 * dy + i2 * dz) + om * dx;
  r[4] = fa * (i3 * dx + i4 * dy + i5 * dz) + om * dy;
  r[5] = fa * (i6 * dx + i7 * dy + i8 * dz) + om * dz;
}

// CTA-wide max, capped at kBoundCap; the same value on every thread. Its
// first barrier also ends every thread's reads of the staged units.
__device__ __forceinline__ float block_bound(float v, float* s_red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = s_red[0];
  for (int w = 1; w < kBlock / 32; ++w) r = fmaxf(r, s_red[w]);
  return fminf(r, kBoundCap);
}

template <bool kAnyHit>
__device__ __forceinline__ float lane_term(float best_t, int best_p,
                                           float maxt) {
  if (kAnyHit) return best_p >= 0 ? -kBig : maxt;
  return fminf(best_t, maxt);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) walk_kernel(Params p) {
  // staged group, triangle-major: unit q, triangle j, coefficient c at
  // (q * kChunk + j) * kCoef + c
  __shared__ __align__(16) float s_woop[kGroup * kUnitRec];
  __shared__ int s_meta[kGroup * 2];
  __shared__ float s_red[kBlock / 32];

  const int tid = threadIdx.x;
  const long long lane = (long long)blockIdx.x * kBlock + tid;
  const float ox = p.ox[lane], oy = p.oy[lane], oz = p.oz[lane];
  const float dx = p.dx[lane], dy = p.dy[lane], dz = p.dz[lane];
  const float time = p.time[lane], maxt = p.maxt[lane];
  const int n_units = p.n_units;
  const int* order = p.order + (long long)blockIdx.x * n_units;
  const float* tlo = p.tlo + (long long)blockIdx.x * n_units;
  const int n_groups = (n_units + kGroup - 1) / kGroup;

  float best_t = INFINITY;
  int best_p = -1;
  int cur_ci = -2;                       // transform group of r[] (-2: none)
  float r[6] = {ox, oy, oz, dx, dy, dz};

  float bound = block_bound(lane_term<kAnyHit>(best_t, best_p, maxt), s_red);
  int g = 0;
  while (g < n_groups && tlo[g * kGroup] <= bound) {
    for (int k = tid; k < kGroup * kUnitRec; k += kBlock) {
      int q = k / kUnitRec, rem = k - q * kUnitRec;
      int c = rem / kChunk, j = rem - c * kChunk;
      int unit = order[min(g * kGroup + q, n_units - 1)];
      s_woop[(q * kChunk + j) * kCoef + c] =
          p.woop[(long long)unit * kUnitRec + rem];
    }
    if (tid < kGroup) {
      int unit = order[min(g * kGroup + tid, n_units - 1)];
      s_meta[2 * tid] = p.meta[2 * unit];
      s_meta[2 * tid + 1] = p.meta[2 * unit + 1];
    }
    __syncthreads();

    for (int q = 0; q < kGroup; ++q) {
      if (p.has_anim) {
        int ci = s_meta[2 * q];
        if (ci != cur_ci) {
          unit_ray(p.inst + (ci > 0 ? ci : 0) * kInstRec, ci, time, ox, oy,
                   oz, dx, dy, dz, r);
          cur_ci = ci;
        }
      }
      const float rox = r[0], roy = r[1], roz = r[2];
      const float rdx = r[3], rdy = r[4], rdz = r[5];
      const int slot0 = s_meta[2 * q + 1];
      const float4* tri =
          reinterpret_cast<const float4*>(s_woop + q * kUnitRec);
#pragma unroll 4
      for (int j = 0; j < kChunk; ++j) {
        const float4 w0 = tri[3 * j], w1 = tri[3 * j + 1], w2 = tri[3 * j + 2];
        float ozp = w2.x * rox + w2.y * roy + w2.z * roz + w2.w;
        float dzp = w2.x * rdx + w2.y * rdy + w2.z * rdz;
        float t = -ozp / dzp;
        float o0 = w0.x * rox + w0.y * roy + w0.z * roz + w0.w;
        float d0 = w0.x * rdx + w0.y * rdy + w0.z * rdz;
        float u = o0 + t * d0;
        float o1 = w1.x * rox + w1.y * roy + w1.z * roz + w1.w;
        float d1 = w1.x * rdx + w1.y * rdy + w1.z * rdz;
        float v = o1 + t * d1;
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
            t < maxt && t < best_t) {
          best_t = t;
          best_p = slot0 + j;
        }
      }
    }
    bound = block_bound(lane_term<kAnyHit>(best_t, best_p, maxt), s_red);
    ++g;
  }
  p.t_out[lane] = best_t;
  p.prim_out[lane] = best_p;
}

}  // namespace

extern "C" int mi_intersect_v4_block() { return kBlock; }

// Launch on `stream` over n lanes (a multiple of kBlock, one visit list per
// block); returns cudaGetLastError() of the launch (0 = ok).
extern "C" int mi_intersect_v4(
    const void* woop, const void* meta, const void* inst, const void* order,
    const void* tlo, int n_units, int has_anim, const void* ox,
    const void* oy, const void* oz, const void* dx, const void* dy,
    const void* dz, const void* time, const void* maxt, long long n,
    int any_hit, void* t_out, void* prim_out, void* stream) {
  if (n <= 0 || n % kBlock != 0 || n_units <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.woop = static_cast<const float*>(woop);
  p.meta = static_cast<const int*>(meta);
  p.inst = static_cast<const float*>(inst);
  p.order = static_cast<const int*>(order);
  p.tlo = static_cast<const float*>(tlo);
  p.n_units = n_units;
  p.has_anim = has_anim;
  p.ox = static_cast<const float*>(ox);
  p.oy = static_cast<const float*>(oy);
  p.oz = static_cast<const float*>(oz);
  p.dx = static_cast<const float*>(dx);
  p.dy = static_cast<const float*>(dy);
  p.dz = static_cast<const float*>(dz);
  p.time = static_cast<const float*>(time);
  p.maxt = static_cast<const float*>(maxt);
  p.t_out = static_cast<float*>(t_out);
  p.prim_out = static_cast<int*>(prim_out);
  unsigned int blocks = (unsigned int)(n / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    walk_kernel<true><<<blocks, kBlock, 0, s>>>(p);
  else
    walk_kernel<false><<<blocks, kBlock, 0, s>>>(p);
  return (int)cudaGetLastError();
}
