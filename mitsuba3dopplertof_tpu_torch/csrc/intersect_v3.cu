// Kernel B5: closest-hit / any-hit (t, prim) over 32-triangle Woop units,
// walked front to back one unit per step, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_v3.py
// `_build_v3_kernel` (Pallas, reached through `intersect_v3`). It computes
// the same function as that kernel and as the plain PyTorch version
// `intersect_v3_reference` (= `intersect_v4_reference`) of
// mitsuba3dopplertof_tpu_torch/ops/intersect_v3.py, over the same tables as
// B2 (csrc/intersect_v4.cu): 12 Woop coefficients per triangle, 32 triangles
// per unit, one visit list per block of kBlock lanes sorted by conservative
// entry distance t_lo, maxt clamped to the scene box. Where B2 takes eight
// units per step, B5 takes one, and before each unit it repeats the slab
// test of the block's ray bounds against the unit's box with the block's
// current bound as the far end, so a unit that the shrinking bound has put
// out of reach is skipped without being staged.
//
// What bounds it on this card: arithmetic (32 Woop tests of about 48 float
// operations per lane and visited unit), as for B2; but with one unit per
// step the two barriers of the block-wide bound come after every 32
// triangles instead of every 256, so the walk is bound by synchronisation
// latency long before the float rate.
//
// What the design does about it: one CTA per visit block, one thread per
// ray; the unit's 1.5 KB record is staged triangle-major in shared memory
// (three 16-byte broadcasts per triangle); the bound is recomputed only
// after a unit that was really tested; the lane's object-space ray stays in
// registers while consecutive units share a transform group. The walk stops
// at the first unit whose t_lo exceeds the bound (capped at 1e37, below the
// 3e38 key of unreachable units): the list is sorted and the bound never
// grows, so the needed units are a prefix. Built with --fmad=false: t on
// hit lanes matches the plain version bit for bit; zero rows of degenerate
// and pad triangles give t = NaN, which every comparison rejects.

#include "intersect_common.cuh"

namespace {

using namespace mi;

constexpr int kCoef = 12;              // Woop coefficients per triangle
constexpr int kUnitRec = kCoef * kChunk;

struct Params {
  const float* woop;   // (n_units, 384): coefficient c of triangle j at c*32+j
  const int* meta;     // (n_units, 2): animated range | -1, slot of tri 0
  const float* inst;   // (n_ranges, 26)
  const float* box;    // (n_units, 6): lo xyz, hi xyz
  const int* order;    // (n_blocks, n_units): units by entry distance
  const float* tlo;    // (n_blocks, n_units): the sorted entry distances
  int n_units;
  int has_anim;
  RayCols ray;
  float* t_out;        // (n,)
  int* prim_out;       // (n,)
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) v3_walk_kernel(Params p) {
  __shared__ __align__(16) float s_woop[kChunk * kTriStride];
  __shared__ float s_red[kWarps];
  __shared__ float s_part[kWarps * 12];
  __shared__ float s_bb[12];

  const int tid = threadIdx.x;
  const long long lane = (long long)blockIdx.x * kBlock + tid;
  const float w[6] = {p.ray.ox[lane], p.ray.oy[lane], p.ray.oz[lane],
                      p.ray.dx[lane], p.ray.dy[lane], p.ray.dz[lane]};
  const float time = p.ray.time[lane], maxt = p.ray.maxt[lane];
  const int n_units = p.n_units;
  const int* order = p.order + (long long)blockIdx.x * n_units;
  const float* tlo = p.tlo + (long long)blockIdx.x * n_units;

  block_ray_bounds(w, s_part, s_bb);

  float best_t = INFINITY;
  int best_p = -1;
  int cur_ci = -2;                       // transform group of r[] (-2: none)
  float r[6] = {w[0], w[1], w[2], w[3], w[4], w[5]};

  float bound = fminf(
      block_max(lane_term<kAnyHit>(best_t, best_p, maxt), s_red), kBoundCap);
  int v = 0;
  while (v < n_units && tlo[v] <= bound) {
    const int unit = order[v];
    if (slab_test(s_bb, p.box + 6 * (long long)unit, bound)) {
      for (int k = tid; k < kUnitRec; k += kBlock) {
        int c = k / kChunk, j = k - c * kChunk;
        s_woop[j * kTriStride + c] = p.woop[(long long)unit * kUnitRec + k];
      }
      __syncthreads();
      if (p.has_anim) {
        int ci = p.meta[2 * unit];
        if (ci != cur_ci) {
          unit_ray(p.inst, ci, time, w, r);
          cur_ci = ci;
        }
      }
      const int slot0 = p.meta[2 * unit + 1];
#pragma unroll 4
      for (int j = 0; j < kChunk; ++j) {
        float t;
        if (woop_hit(s_woop + j * kTriStride, r, maxt, best_t, &t)) {
          best_t = t;
          best_p = slot0 + j;
        }
      }
      bound = fminf(
          block_max(lane_term<kAnyHit>(best_t, best_p, maxt), s_red),
          kBoundCap);
    }
    ++v;
  }
  p.t_out[lane] = best_t;
  p.prim_out[lane] = best_p;
}

}  // namespace

extern "C" int mi_intersect_v3_block() { return mi::kBlock; }

// Launch on `stream` over n lanes (a multiple of kBlock, one visit list per
// block); returns cudaGetLastError() of the launch (0 = ok).
extern "C" int mi_intersect_v3(
    const void* woop, const void* meta, const void* inst, const void* box,
    const void* order, const void* tlo, int n_units, int has_anim,
    const void* ox, const void* oy, const void* oz, const void* dx,
    const void* dy, const void* dz, const void* time, const void* maxt,
    long long n, int any_hit, void* t_out, void* prim_out, void* stream) {
  if (n <= 0 || n % kBlock != 0 || n_units <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.woop = static_cast<const float*>(woop);
  p.meta = static_cast<const int*>(meta);
  p.inst = static_cast<const float*>(inst);
  p.box = static_cast<const float*>(box);
  p.order = static_cast<const int*>(order);
  p.tlo = static_cast<const float*>(tlo);
  p.n_units = n_units;
  p.has_anim = has_anim;
  p.ray = ray_cols(ox, oy, oz, dx, dy, dz, time, maxt);
  p.t_out = static_cast<float*>(t_out);
  p.prim_out = static_cast<int*>(prim_out);
  unsigned int blocks = (unsigned int)(n / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    v3_walk_kernel<true><<<blocks, kBlock, 0, s>>>(p);
  else
    v3_walk_kernel<false><<<blocks, kBlock, 0, s>>>(p);
  return (int)cudaGetLastError();
}
