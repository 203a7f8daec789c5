// Kernel B4: closest-hit / any-hit (t, prim) over 128-triangle chunks with
// Möller-Trumbore, walked front to back per block of rays, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_v2.py
// `_build_v2_kernel` (Pallas, reached through `intersect_v2`). It computes
// the same function as that kernel and as the plain PyTorch version
// `intersect_v2_reference` of
// mitsuba3dopplertof_tpu_torch/ops/intersect_v2.py. A chunk holds 128
// triangles of one transform group as v0, e1, e2 (nine rows of 128); its
// four 32-triangle quarters each have a world box. PyTorch has sorted, for
// every block of kBlock lanes, the chunks by the conservative entry distance
// t_lo of the union of their four boxes, and clamped each lane's maxt to the
// scene box. Inside the kernel each quarter of a visited chunk runs only if
// the slab test of the block's ray bounds against the quarter's box passes
// with the block's current bound as the far end.
//
// What bounds it on this card: arithmetic, about 56 float operations per
// lane and tested triangle; the chunk records (4.5 KB) are re-read per
// visiting block from L2. The gate is coarser than B2's and B5's (a chunk is
// 128 triangles), so more triangles are tested per ray for the same scene.
//
// What the design does about it: one CTA per visit block, one thread per
// ray; a visited chunk is staged triangle-major in shared memory (6 KB,
// three 16-byte broadcasts per triangle); the four quarter gates are
// evaluated once per chunk from shared and constant-cached data, all threads
// agreeing; the bound (CTA-wide max of min(t, maxt), -3e38 for an occluded
// any-hit lane, capped at 1e37) is recomputed after each chunk that ran.
// Built with --fmad=false and the |det| > 1e-12 guard in the plain
// version's order of operations: t on hit lanes matches it bit for bit.

#include "intersect_common.cuh"

namespace {

using namespace mi;

constexpr int kT = 128;                // triangles per chunk
constexpr int kSubs = kT / kChunk;     // 32-triangle quarters per chunk
constexpr int kRows = 9;               // v0 e1 e2
constexpr int kChunkRec = kRows * kT;

struct Params {
  const float* tri;    // (n_chunks, 9, 128): row c of triangle j at c*128+j
  const int* meta;     // (n_chunks, 2): animated range | -1, slot of tri 0
  const float* inst;   // (n_ranges, 26)
  const float* sub;    // (4 n_chunks, 6): quarter boxes, lo xyz, hi xyz
  const int* order;    // (n_blocks, n_chunks): chunks by entry distance
  const float* tlo;    // (n_blocks, n_chunks): the sorted entry distances
  int n_chunks;
  int has_anim;
  RayCols ray;
  float* t_out;        // (n,)
  int* prim_out;       // (n,)
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) v2_walk_kernel(Params p) {
  __shared__ __align__(16) float s_tri[kT * kTriStride];
  __shared__ float s_red[kWarps];
  __shared__ float s_part[kWarps * 12];
  __shared__ float s_bb[12];

  const int tid = threadIdx.x;
  const long long lane = (long long)blockIdx.x * kBlock + tid;
  const float w[6] = {p.ray.ox[lane], p.ray.oy[lane], p.ray.oz[lane],
                      p.ray.dx[lane], p.ray.dy[lane], p.ray.dz[lane]};
  const float time = p.ray.time[lane], maxt = p.ray.maxt[lane];
  const int n_chunks = p.n_chunks;
  const int* order = p.order + (long long)blockIdx.x * n_chunks;
  const float* tlo = p.tlo + (long long)blockIdx.x * n_chunks;

  block_ray_bounds(w, s_part, s_bb);

  float best_t = INFINITY;
  int best_p = -1;
  int cur_ci = -2;                       // transform group of r[] (-2: none)
  float r[6] = {w[0], w[1], w[2], w[3], w[4], w[5]};

  float bound = fminf(
      block_max(lane_term<kAnyHit>(best_t, best_p, maxt), s_red), kBoundCap);
  int v = 0;
  while (v < n_chunks && tlo[v] <= bound) {
    const int k = order[v];
    bool run[kSubs];
    bool any = false;
    for (int s = 0; s < kSubs; ++s) {
      run[s] = slab_test(s_bb, p.sub + 6 * ((long long)k * kSubs + s), bound);
      any = any || run[s];
    }
    if (any) {
      for (int q = tid; q < kChunkRec; q += kBlock) {
        int c = q / kT, j = q - c * kT;
        s_tri[j * kTriStride + c] = p.tri[(long long)k * kChunkRec + q];
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
      for (int s = 0; s < kSubs; ++s) {
        if (!run[s]) continue;
#pragma unroll 4
        for (int j = s * kChunk; j < (s + 1) * kChunk; ++j) {
          float t, u, vv;
          if (moller_hit(s_tri + j * kTriStride, r, maxt, best_t, &t, &u,
                         &vv)) {
            best_t = t;
            best_p = slot0 + j;
          }
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

extern "C" int mi_intersect_v2_block() { return mi::kBlock; }

// Launch on `stream` over n lanes (a multiple of kBlock, one visit list per
// block); returns cudaGetLastError() of the launch (0 = ok).
extern "C" int mi_intersect_v2(
    const void* tri, const void* meta, const void* inst, const void* sub,
    const void* order, const void* tlo, int n_chunks, int has_anim,
    const void* ox, const void* oy, const void* oz, const void* dx,
    const void* dy, const void* dz, const void* time, const void* maxt,
    long long n, int any_hit, void* t_out, void* prim_out, void* stream) {
  if (n <= 0 || n % kBlock != 0 || n_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.tri = static_cast<const float*>(tri);
  p.meta = static_cast<const int*>(meta);
  p.inst = static_cast<const float*>(inst);
  p.sub = static_cast<const float*>(sub);
  p.order = static_cast<const int*>(order);
  p.tlo = static_cast<const float*>(tlo);
  p.n_chunks = n_chunks;
  p.has_anim = has_anim;
  p.ray = ray_cols(ox, oy, oz, dx, dy, dz, time, maxt);
  p.t_out = static_cast<float*>(t_out);
  p.prim_out = static_cast<int*>(prim_out);
  unsigned int blocks = (unsigned int)(n / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    v2_walk_kernel<true><<<blocks, kBlock, 0, s>>>(p);
  else
    v2_walk_kernel<false><<<blocks, kBlock, 0, s>>>(p);
  return (int)cudaGetLastError();
}
