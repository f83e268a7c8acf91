// Fused Felsenstein down-pass for a stacked group of divisions that share
// one tree, every (division, chain, pattern tile) in one launch (two where
// a division takes the global-scratch walk): the CUDA counterpart of
// mrbayes_tpu/ops/pruning_pallas.py:PruningPallasStacked (:728, its
// __call__ :767), which runs _kernel_g over the divisions stacked
// block-diagonally on one union state axis.
//
// The union exists on the TPU only to feed its matrix unit: each pattern's
// arithmetic involves only its own division (the Pallas class's docstring,
// :729-737).  Here there is no union: block (c, y) is chain c of tile y,
// T_d patterns of one division, found through the tile map and the
// per-division table of group_walk.cuh (shared with multiwalk.cu), and it
// runs that division's own walk at its own K_d and S_d.
//
// Each block dispatches on its own S_d to the templated on-chip walk
// (onchip_walk.cuh): S_d is uniform within a block, so no warp diverges,
// but the switch over six templates costs the kernel registers (128, where
// pruning.cu's instantiations take 64-80; PERF.md).  A division whose slots do not
// fit in a block of 32 threads takes the global-scratch walk of
// down_pass.cuh, one thread a pattern in blocks of kThreads, through a
// second kernel that the same call launches before the on-chip one on the
// same stream.  The size rule is mb_group_plan's.
//
// What bounds it on an H100: latency, the n_int-step chain of the slowest
// division's walk (at cynmix, the 8-state bucket's) plus the launch, as
// long as the grid runs in one wave (blocks a wave: the SMs times the
// blocks an SM holds, by registers and by shared memory).  The work is
// sum_d C * n_int * 2 * 2*K_d*S_d^2 * P_d FLOPs (14.0 MFLOP at cynmix's
// group, C = 8), not the dense union's (sum_d K_d*S_d)^2 per pattern and
// step that a block-diagonal operator would cost.
//
// The same launch carries the gene trees of a BEST analysis, one tree a
// member: the table's last column points each member at its own block of
// child slots (lr [D, C, n_int, 2], group_walk.cuh), which makes it the
// counterpart of the JAX engine's vmapped pass over the genes
// (mrbayes_tpu/mcmc/engine.py:_best_lnl_batched).  At finch's 30 loci (4
// tips, S 4, K 1, 5-30 patterns each) every member is one tile, so a
// launch is D * C blocks of one wave, bound by its launch.

#include <cuda_runtime.h>

#include "group_walk.cuh"

namespace {

using mb::kThreads;
using mb::Member;

// Block (c, y): chain c of on-chip tile y (division, first pattern).
__global__ void __launch_bounds__(256)
stacked_onchip_kernel(const int* __restrict__ lr,  // [(D,) C, n_int, 2]
                      const float* __restrict__ pstep,     // flat operators
                      const float* __restrict__ tips,      // flat tips
                      float* __restrict__ root,            // flat roots
                      float* __restrict__ ls,              // flat log-scales
                      const long long* __restrict__ table, // [D, kTable]
                      const int* __restrict__ tiles,       // [n_tiles, 2]
                      int n_tips, int n_int) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const long long* t;
  int p0;
  const Member m = mb::tile_member(table, tiles, lr, pstep, tips, root, ls,
                                   blockIdx.x, blockIdx.y, n_int, &t, &p0);
  switch (mb::onchip_templated(m.S) ? m.S : 0) {
    case 2:
      mb::onchip_member<2>(m, t, n_tips, n_int, p0, smem);
      break;
    case 3:
      mb::onchip_member<3>(m, t, n_tips, n_int, p0, smem);
      break;
    case 4:
      mb::onchip_member<4>(m, t, n_tips, n_int, p0, smem);
      break;
    case 8:
      mb::onchip_member<8>(m, t, n_tips, n_int, p0, smem);
      break;
    case 20:
      mb::onchip_member<20>(m, t, n_tips, n_int, p0, smem);
      break;
    default:
      mb::onchip_member<0>(m, t, n_tips, n_int, p0, smem);
      break;
  }
}

// Block (c, y): chain c of global-scratch tile y, one thread a pattern (the
// template set of pruning.cu's global walk).
__global__ void __launch_bounds__(kThreads)
stacked_global_kernel(const int* __restrict__ lr,  // [(D,) C, n_int, 2]
                      const float* __restrict__ pstep,     // flat operators
                      const float* __restrict__ tips,      // flat tips
                      float* __restrict__ scratch,         // flat scratch
                      float* __restrict__ root,            // flat roots
                      float* __restrict__ ls,              // flat log-scales
                      const long long* __restrict__ table, // [D, kTable]
                      const int* __restrict__ tiles,       // [n_tiles, 2]
                      int n_tips, int n_int) {
  const long long* t;
  int p0;
  const int c = blockIdx.x;
  const Member m = mb::tile_member(table, tiles, lr, pstep, tips, root, ls, c,
                                   blockIdx.y, n_int, &t, &p0);
  const int p = p0 + threadIdx.x;
  if (p >= m.P) return;
  switch (m.S) {
    case 2:
      mb::global_member<2>(m, t, scratch, c, n_tips, n_int, p);
      break;
    case 4:
      mb::global_member<4>(m, t, scratch, c, n_tips, n_int, p);
      break;
    case 20:
      mb::global_member<20>(m, t, scratch, c, n_tips, n_int, p);
      break;
    default:
      mb::global_member<0>(m, t, scratch, c, n_tips, n_int, p);
      break;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device`: the
// global-scratch kernel over the tile map's last n_global tiles, then the
// on-chip kernel over its first n_onchip tiles with the block of T threads
// and the shared-memory bytes of mb_group_plan, whose walks the table
// carries.  Returns the cudaGetLastError() code after the launches
// (0 = success); the kernels themselves run asynchronously.
int mb_stacked_down(const void* lr, const void* pstep, const void* tips,
                    void* scratch, void* root, void* ls, const void* table,
                    const void* tiles, int n_onchip, int n_global, int C,
                    int n_tips, int n_int, int T, int bytes, int device,
                    void* stream) {
  static bool done[64] = {};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int* tl = (const int*)tiles;
  if (n_global > 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    stacked_global_kernel<<<dim3(C, n_global), kThreads, 0, st>>>(
        (const int*)lr, (const float*)pstep, (const float*)tips,
        (float*)scratch, (float*)root, (float*)ls, (const long long*)table,
        tl + 2 * n_onchip, n_tips, n_int);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_onchip > 0) {
    mb::DeviceLimits lim;
    err = mb::device_limits(device, &lim);
    if (err != cudaSuccess) return (int)err;
    err = mb::allow_smem(stacked_onchip_kernel, device, bytes, done, lim);
    if (err != cudaSuccess) return (int)err;
    stacked_onchip_kernel<<<dim3(C, n_onchip), T, bytes, st>>>(
        (const int*)lr, (const float*)pstep, (const float*)tips,
        (float*)root, (float*)ls, (const long long*)table, tl, n_tips,
        n_int);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
