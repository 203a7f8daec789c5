// Kernel B6: closest-hit / any-hit (t, prim) with the ray-triangle test as
// an affine map of the ray: per 128-triangle chunk one (768 x 8) . (8 x
// lanes) float32 product inside the kernel, then an epilogue and a min over
// the chunk's triangles; for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba3dopplertof_tpu/ops/intersect_mxu.py
// `_build_mxu_kernel` (Pallas, reached through `intersect_mxu`), which runs
// the product on the TPU's matrix unit at its highest precision. It computes
// the same function as that kernel and as the plain PyTorch version
// `intersect_mxu_reference` of
// mitsuba3dopplertof_tpu_torch/ops/intersect_mxu.py. W holds, per chunk,
// eight rows of 768 coefficients: row k multiplies ray feature k of
// X = [ox oy oz 1 dx dy dz maxt], column c * 128 + j is component c (o'x o'y
// o'z d'x d'y d'z) of triangle j. From the product, t = -o'z / d'z (guarded
// by |d'z| > 1e-30), u = o'x + t d'x, v = o'y + t d'y; hit if min(u, v) >= 0,
// u + v <= 1 and t in (0, maxt). The chunk's smallest t wins (the lowest
// triangle among equal minima) if it is strictly below the lane's best.
// PyTorch has sorted the chunks per block of kBlock lanes by the entry
// distance of the union of their four 32-triangle boxes; the walk stops when
// the next t_lo exceeds t_hi = min(largest maxt, largest best t) of the
// block (-3e38 once every lane of an any-hit block is occluded), and a
// chunk runs if any of its four boxes passes the slab test with that t_hi.
// No scene-box clamp on this route.
//
// What bounds it on this card: arithmetic on the CUDA cores. The product is
// computed whole, 12,288 float operations per lane and chunk although half
// of W is structural zeros, about twice the work of the Woop test written
// out (B2, B5). A tensor-core product would have to keep float32 accuracy in
// t (TF32 keeps about three digits), which needs error compensation.
//
// What the design does about it: one CTA per visit block, one thread per
// ray; the chunk's W (24 KB) is staged in shared memory so that a
// triangle's 48 coefficients are twelve 16-byte broadcasts; each thread
// forms the six sums of its ray for a triangle in registers, k = 0..7 in
// order, runs the epilogue at once and keeps a running (min t, triangle),
// so the (768 x lanes) product never exists in memory. Built with
// --fmad=false: every product and sum rounds on its own, as the plain
// version's ordered sums do, and t on hit lanes matches it bit for bit.

#include "intersect_common.cuh"

namespace {

using namespace mi;

constexpr int kT = 128;                // triangles per chunk
constexpr int kSubs = kT / kChunk;     // 32-triangle boxes per chunk
constexpr int kK = 8;                  // ray features
constexpr int kComp = 6;               // o'x o'y o'z d'x d'y d'z
constexpr int kWRow = kComp * kT;      // 768 columns of W
constexpr int kWChunk = kK * kWRow;    // floats of one chunk's W

struct Params {
  const float* w;      // (n_chunks * 8, 768)
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

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) mxu_kernel(Params p) {
  // staged W, triangle-major: feature k of component c of triangle j at
  // (j * 6 + c) * 8 + k
  __shared__ __align__(16) float s_w[kWChunk];
  __shared__ float s_red[kWarps];
  __shared__ float s_part[kWarps * 12];
  __shared__ float s_bb[12];

  const int tid = threadIdx.x;
  const long long n = p.n;
  const long long lane = (long long)blockIdx.x * kBlock + tid;
  const float wr[6] = {p.x[lane], p.x[n + lane], p.x[2 * n + lane],
                       p.x[4 * n + lane], p.x[5 * n + lane],
                       p.x[6 * n + lane]};
  const float x3 = p.x[3 * n + lane], maxt = p.x[7 * n + lane];
  const float time = p.time[lane];
  const int n_chunks = p.n_chunks;
  const int* order = p.order + (long long)blockIdx.x * n_chunks;
  const float* tlo = p.tlo + (long long)blockIdx.x * n_chunks;

  block_ray_bounds(wr, s_part, s_bb);
  const float mt_blk = fminf(block_max(maxt, s_red), kBig);

  float best_t = INFINITY;
  int best_p = -1;
  int cur_ci = -2;                       // transform group of r[] (-2: none)
  float r[6] = {wr[0], wr[1], wr[2], wr[3], wr[4], wr[5]};

  float t_hi = mt_blk;                   // nothing hit yet
  int v = 0;
  while (v < n_chunks && tlo[v] <= t_hi) {
    const int k = order[v];
    bool poss = false;
    for (int s = 0; s < kSubs; ++s)
      poss = poss ||
             slab_test(s_bb, p.sub + 6 * ((long long)k * kSubs + s), t_hi);
    if (poss) {
      const float* wk = p.w + (long long)k * kWChunk;
      for (int q = tid; q < kWChunk; q += kBlock) {
        int kk = q / kWRow, col = q - kk * kWRow;
        int c = col / kT, j = col - c * kT;
        s_w[(j * kComp + c) * kK + kk] = wk[q];
      }
      __syncthreads();
      if (p.has_anim) {
        int ci = p.meta[2 * k];
        if (ci != cur_ci) {
          unit_ray(p.inst, ci, time, wr, r);
          cur_ci = ci;
        }
      }
      const float xp[kK] = {r[0], r[1], r[2], x3, r[3], r[4], r[5], maxt};
      float tmin = INFINITY;
      int lmin = kT;
#pragma unroll 2
      for (int j = 0; j < kT; ++j) {
        const float4* wj =
            reinterpret_cast<const float4*>(s_w + j * kComp * kK);
        float res[kComp];
#pragma unroll
        for (int c = 0; c < kComp; ++c) {
          const float4 a = wj[2 * c], b = wj[2 * c + 1];
          float acc = a.x * xp[0];
          acc = acc + a.y * xp[1];
          acc = acc + a.z * xp[2];
          acc = acc + a.w * xp[3];
          acc = acc + b.x * xp[4];
          acc = acc + b.y * xp[5];
          acc = acc + b.z * xp[6];
          acc = acc + b.w * xp[7];
          res[c] = acc;
        }
        const float dzp = res[5];
        const bool dz_ok = fabsf(dzp) > 1e-30f;
        const float t = -res[2] / (dz_ok ? dzp : 1.0f);
        const float u = res[0] + t * res[3];
        const float vv = res[1] + t * res[4];
        if (dz_ok && fminf(u, vv) >= 0.0f && u + vv <= 1.0f && t > 0.0f &&
            t < maxt && t < best_t && t < tmin) {
          tmin = t;
          lmin = j;
        }
      }
      if (tmin < best_t) {
        best_t = tmin;
        best_p = p.meta[2 * k + 1] + lmin;
      }
      // the first barrier of the max ends the reads of the staged W
      float worst = block_max(best_t, s_red);
      t_hi = fminf(mt_blk, fminf(worst, kBig));
      if (kAnyHit && worst < INFINITY) t_hi = -kBig;   // all lanes occluded
    }
    ++v;
  }
  p.t_out[lane] = best_t;
  p.prim_out[lane] = best_p;
}

}  // namespace

extern "C" int mi_intersect_mxu_block() { return mi::kBlock; }

// Launch on `stream` over n lanes (a multiple of kBlock, one visit list per
// block); returns cudaGetLastError() of the launch (0 = ok).
extern "C" int mi_intersect_mxu(
    const void* w, const void* meta, const void* inst, const void* sub,
    const void* order, const void* tlo, int n_chunks, int has_anim,
    const void* x, const void* time, long long n, int any_hit, void* t_out,
    void* prim_out, void* stream) {
  if (n <= 0 || n % kBlock != 0 || n_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.w = static_cast<const float*>(w);
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
