// Fused Felsenstein down-pass for a group of divisions that share one tree
// and one state count S, every (division, chain) walk in one launch: the
// CUDA counterpart of the Pallas kernel
// mrbayes_tpu/ops/pruning_pallas.py:_kernel_w (:144, launched by
// _pallas_multiwalk :847, wired by PruningPallasMultiwalk :951).
//
// Walk w = d * C + c is chain c of division d.  Every walk of chain c reads
// that chain's child slots lr[c] (the divisions share the tree); each walk
// has its own per-category operators and its own division's tips, and
// computes what pruning.cu computes for that division alone.
//
// What bounds it on an H100: latency, as for pruning.cu: the n_int-step
// dependent chain of a walk plus the block start and the launch.  At
// test1's shapes (D = 2, C = 8, n_tips 12, K 4, S 4, P 199 and 258) the
// work is about 10 MFLOP and 0.5 MB of compulsory traffic, each well under
// a microsecond.  The first design ran one thread per (walk, pattern) on
// down_pass.cuh's global-scratch walk, whose every step is a round trip
// through L2 (about 3.8 us a step): slower than one pruning.cu launch per
// division, whose on-chip walk takes about 0.8 us a step.
//
// Design: the group launch of group_walk.cuh (shared with stacked.cu).
//   * multiwalk_onchip_kernel: block (c, y) is chain c of tile y of the
//     tile map, T_d patterns of one division d, and runs d's on-chip walk
//     (onchip_walk.cuh): the live partials in shared memory through the
//     live-slot map, the chain's operators and the tile's tips brought in
//     by cp.async, a pattern's K_d*S entries over G_d lanes, the size rule
//     of mb_group_plan.  The group shares S (the engine groups divisions
//     by state count), so the kernel is a template on S and a launch
//     instantiates one: no switch over the six templates, whose registers
//     held the stacked kernel to 128 a thread.
//   * multiwalk_down_kernel: the first design's kernel, kept as it was,
//     one thread per (walk, pattern) on the global-scratch walk, over the
//     divisions of its own table [Dg, 7].  A division whose slots do not
//     fit in a block of 32 threads takes it, launched by the same call
//     before the on-chip kernel; scratch is allocated for those divisions
//     only.  A plan that forces every division onto it
//     (MultiwalkLayout.plan(walk="global")) times the old walk.

#include <cuda_runtime.h>

#include "group_walk.cuh"

namespace {

using mb::kThreads;
using mb::Member;
constexpr int kGlobalTable = 7;   // K, P, pstep, tips, scratch, root, ls

// Block (c, y): chain c of on-chip tile y (division, first pattern).
template <int S_T>
__global__ void __launch_bounds__(256)
multiwalk_onchip_kernel(const int* __restrict__ lr,          // [C, n_int, 2]
                        const float* __restrict__ pstep,     // flat operators
                        const float* __restrict__ tips,      // flat tips
                        float* __restrict__ root,            // flat roots
                        float* __restrict__ ls,              // flat log-scales
                        const long long* __restrict__ table, // [D, kTable]
                        const int* __restrict__ tiles,       // [n_tiles, 2]
                        int n_tips, int n_int) {
  extern __shared__ float4 smem4[];
  const long long* t;
  int p0;
  const Member m = mb::tile_member(table, tiles, lr, pstep, tips, root, ls,
                                   blockIdx.x, blockIdx.y, n_int, &t, &p0);
  mb::onchip_member<S_T>(m, t, n_tips, n_int, p0,
                         reinterpret_cast<float*>(smem4));
}

// The first design's kernel, kept as it was for the divisions that take
// the global-scratch walk: one thread per (walk, pattern), grid
// (ceil(P_max / kThreads), Dg * C), walk w = d * C + c of the Dg global
// divisions, whose rows of gtable [Dg, 7] hold K_d, P_d and the element
// offsets of their operators, tips, scratch, root partials and
// log-scales.  (The same walk read through the tile map, as the stacked
// kernel's is, ran slower.)
template <int S_T>
__global__ void __launch_bounds__(kThreads)
multiwalk_down_kernel(const int* __restrict__ lr,           // [C, n_int, 2]
                      const float* __restrict__ pstep,      // flat operators
                      const float* __restrict__ tips,       // flat tips
                      float* __restrict__ scratch,          // flat scratch
                      float* __restrict__ root,             // flat roots
                      float* __restrict__ ls,               // flat log-scales
                      const long long* __restrict__ gtable, // [Dg, 7]
                      int C, int n_tips, int n_int, int S_rt) {
  const int S = S_T > 0 ? S_T : S_rt;
  const int w = blockIdx.y;
  const int d = w / C;
  const int c = w - d * C;
  const long long* t = gtable + (long long)kGlobalTable * d;
  const int K = (int)t[0];
  const int P = (int)t[1];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const long long KSP = (long long)K * S * P;
  mb::down_pass<S_T>(lr + (long long)c * n_int * 2,
                     pstep + t[2] + (long long)c * n_int * 2 * K * S * S,
                     tips + t[3] + p,
                     scratch + t[4] + (long long)c * n_int * KSP + p,
                     root + t[5] + (long long)c * KSP + p,
                     ls + t[6] + (long long)c * P + p, n_tips, n_int, K, S,
                     P);
}

struct Launch {
  const int* lr;
  const float* pstep;
  const float* tips;
  float* scratch;
  float* root;
  float* ls;
  const long long* table;
  const int* tiles;
  const long long* gtable;
  int n_onchip, Dg, P_max, S, C, n_tips, n_int, T, bytes, device;
  cudaStream_t st;
};

template <int S_T>
cudaError_t launch_global(const Launch& a) {
  const dim3 grid((a.P_max + kThreads - 1) / kThreads, a.Dg * a.C);
  multiwalk_down_kernel<S_T><<<grid, kThreads, 0, a.st>>>(
      a.lr, a.pstep, a.tips, a.scratch, a.root, a.ls, a.gtable, a.C,
      a.n_tips, a.n_int, a.S);
  return cudaGetLastError();
}

template <int S_T>
cudaError_t launch_onchip(const Launch& a, const mb::DeviceLimits& lim) {
  static bool done[64] = {};
  cudaError_t err = mb::allow_smem(multiwalk_onchip_kernel<S_T>, a.device,
                                   a.bytes, done, lim);
  if (err != cudaSuccess) return err;
  multiwalk_onchip_kernel<S_T><<<dim3(a.C, a.n_onchip), a.T, a.bytes, a.st>>>(
      a.lr, a.pstep, a.tips, a.root, a.ls, a.table, a.tiles, a.n_tips,
      a.n_int);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device` for
// a group of state count S: the global-scratch kernel over the Dg
// divisions of gtable (P_max their largest pattern count), then the
// on-chip kernel over the tile map's first n_onchip tiles with the block
// of T threads and the shared-memory bytes of mb_group_plan, whose walks
// the table carries.  Returns the cudaGetLastError() code after the
// launches (0 = success); the kernels themselves run asynchronously.
int mb_multiwalk_down(const void* lr, const void* pstep, const void* tips,
                      void* scratch, void* root, void* ls, const void* table,
                      const void* tiles, const void* gtable, int n_onchip,
                      int Dg, int P_max, int S, int C, int n_tips, int n_int,
                      int T, int bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Launch a{(const int*)lr,         (const float*)pstep,
                 (const float*)tips,     (float*)scratch,
                 (float*)root,           (float*)ls,
                 (const long long*)table, (const int*)tiles,
                 (const long long*)gtable, n_onchip,
                 Dg,                     P_max,
                 S,                      C,
                 n_tips,                 n_int,
                 T,                      bytes,
                 device,                 (cudaStream_t)stream};
  if (Dg > 0) {
    if (scratch == nullptr || gtable == nullptr)
      return (int)cudaErrorInvalidValue;
    switch (S) {
      case 2: err = launch_global<2>(a); break;
      case 4: err = launch_global<4>(a); break;
      case 20: err = launch_global<20>(a); break;
      default: err = launch_global<0>(a); break;
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (n_onchip > 0) {
    mb::DeviceLimits lim;
    err = mb::device_limits(device, &lim);
    if (err != cudaSuccess) return (int)err;
    switch (mb::onchip_templated(S) ? S : 0) {
      case 2: err = launch_onchip<2>(a, lim); break;
      case 3: err = launch_onchip<3>(a, lim); break;
      case 4: err = launch_onchip<4>(a, lim); break;
      case 8: err = launch_onchip<8>(a, lim); break;
      case 20: err = launch_onchip<20>(a, lim); break;
      default: err = launch_onchip<0>(a, lim); break;
    }
  }
  return (int)err;
}

}  // extern "C"
