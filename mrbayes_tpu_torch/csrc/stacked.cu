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
// T_d patterns of one division, found through a tile map [n_tiles, 2] =
// (division, first pattern) built once on the device, and it runs that
// division's own walk at its own K_d and S_d.  The map lists the costliest
// divisions' tiles first and the chains vary fastest in the grid, so the
// longest walks start first.  A per-division table [D, kTable] (as
// multiwalk.cu's) holds K_d, S_d, P_d, the element offsets of its
// operators [C, n_int, 2, K_d, S_d, S_d], tips [n_tips, S_d, P_d], root
// partials [C, K_d, S_d, P_d], log-scales [C, P_d] and scratch in the flat
// buffers, its walk and its lanes a pattern G_d.  The grid is
// C x sum_d ceil(P_d / T_d) tiles, T_d = (threads a block) / G_d.
//
// Each block dispatches on its own S_d to the templated on-chip walk
// (onchip_walk.cuh): S_d is uniform within a block, so no warp diverges.
// A division whose slots do not fit in a block of 32 threads takes the
// global-scratch walk of down_pass.cuh, one thread a pattern in blocks of
// kThreads, through a second kernel that the same call launches before
// the on-chip one on the same stream (scratch is allocated for those divisions
// only).  The two walks are two kernels so that the on-chip kernel's
// registers are the on-chip walk's alone: in one kernel every block would
// hold the registers of the global walk's column arrays, which it never
// runs on the main path.  The tile map lists the on-chip tiles, then the
// global ones.  The size rule and the block are onchip_walk.cuh's,
// applied to all the group's divisions at once; the dynamic shared memory
// of every on-chip block is the largest on-chip division's.
//
// What bounds it on an H100: latency, the n_int-step chain of the slowest
// division's walk (at cynmix, the 8-state bucket's) plus the launch, as
// long as the grid runs in one wave (blocks a wave: the SMs times the
// blocks an SM holds, by registers and by shared memory).  The work is
// sum_d C * n_int * 2 * 2*K_d*S_d^2 * P_d FLOPs (14.0 MFLOP at cynmix's
// group, C = 8), not the dense union's (sum_d K_d*S_d)^2 per pattern and
// step that a block-diagonal operator would cost.

#include <cuda_runtime.h>

#include "down_pass.cuh"
#include "onchip_walk.cuh"

namespace {

using mb::kThreads;

// K, S, P, then the offsets of pstep, tips, root, ls, scratch, the walk
// and the lanes of a pattern
constexpr int kTable = 10;

// Division d's chain c: its slots, operators, root partials and
// log-scales.
struct Member {
  int K, S, P;
  const int* lr;
  const float* op;
  const float* tips;
  float* root;
  float* ls;
};

__device__ __forceinline__ Member member(const long long* t, const int* lr,
                                         const float* pstep,
                                         const float* tips, float* root,
                                         float* ls, int c, int n_int) {
  Member m;
  m.K = (int)t[0];
  m.S = (int)t[1];
  m.P = (int)t[2];
  m.lr = lr + (long long)c * n_int * 2;
  m.op = pstep + t[3] + (long long)c * n_int * 2 * m.K * m.S * m.S;
  m.tips = tips + t[4];
  m.root = root + t[5] + (long long)c * m.K * m.S * m.P;
  m.ls = ls + t[6] + (long long)c * m.P;
  return m;
}

template <int S_T>
__device__ __forceinline__ void onchip_member(const Member& m,
                                              const long long* t, int n_tips,
                                              int n_int, int p0,
                                              float* smem) {
  mb::onchip_walk<S_T>(m.lr, m.op, m.tips, m.root, m.ls, n_tips, n_int, m.K,
                       m.S, m.P, p0, (int)t[9], t[8] == mb::kWalkStaged,
                       smem);
}

// Block (c, y): chain c of on-chip tile y (division, first pattern).
__global__ void __launch_bounds__(256)
stacked_onchip_kernel(const int* __restrict__ lr,          // [C, n_int, 2]
                      const float* __restrict__ pstep,     // flat operators
                      const float* __restrict__ tips,      // flat tips
                      float* __restrict__ root,            // flat roots
                      float* __restrict__ ls,              // flat log-scales
                      const long long* __restrict__ table, // [D, kTable]
                      const int* __restrict__ tiles,       // [n_tiles, 2]
                      int n_tips, int n_int) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int p0 = tiles[2 * blockIdx.y + 1];
  const long long* t = table + (long long)kTable * tiles[2 * blockIdx.y];
  const Member m = member(t, lr, pstep, tips, root, ls, blockIdx.x, n_int);
  switch (mb::onchip_templated(m.S) ? m.S : 0) {
    case 2:
      onchip_member<2>(m, t, n_tips, n_int, p0, smem);
      break;
    case 3:
      onchip_member<3>(m, t, n_tips, n_int, p0, smem);
      break;
    case 4:
      onchip_member<4>(m, t, n_tips, n_int, p0, smem);
      break;
    case 8:
      onchip_member<8>(m, t, n_tips, n_int, p0, smem);
      break;
    case 20:
      onchip_member<20>(m, t, n_tips, n_int, p0, smem);
      break;
    default:
      onchip_member<0>(m, t, n_tips, n_int, p0, smem);
      break;
  }
}

template <int S_T>
__device__ __forceinline__ void global_member(const Member& m,
                                              const long long* t,
                                              float* scratch, int c,
                                              int n_tips, int n_int, int p) {
  const long long KSP = (long long)m.K * m.S * m.P;
  mb::down_pass<S_T>(m.lr, m.op, m.tips + p,
                     scratch + t[7] + (long long)c * n_int * KSP + p,
                     m.root + p, m.ls + p, n_tips, n_int, m.K, m.S, m.P);
}

// Block (c, y): chain c of global-scratch tile y, one thread a pattern (the
// template set of pruning.cu's global walk).
__global__ void __launch_bounds__(kThreads)
stacked_global_kernel(const int* __restrict__ lr,          // [C, n_int, 2]
                      const float* __restrict__ pstep,     // flat operators
                      const float* __restrict__ tips,      // flat tips
                      float* __restrict__ scratch,         // flat scratch
                      float* __restrict__ root,            // flat roots
                      float* __restrict__ ls,              // flat log-scales
                      const long long* __restrict__ table, // [D, kTable]
                      const int* __restrict__ tiles,       // [n_tiles, 2]
                      int n_tips, int n_int) {
  const int p = tiles[2 * blockIdx.y + 1] + threadIdx.x;
  const long long* t = table + (long long)kTable * tiles[2 * blockIdx.y];
  const int c = blockIdx.x;
  const Member m = member(t, lr, pstep, tips, root, ls, c, n_int);
  if (p >= m.P) return;
  switch (m.S) {
    case 2:
      global_member<2>(m, t, scratch, c, n_tips, n_int, p);
      break;
    case 4:
      global_member<4>(m, t, scratch, c, n_tips, n_int, p);
      break;
    case 20:
      global_member<20>(m, t, scratch, c, n_tips, n_int, p);
      break;
    default:
      global_member<0>(m, t, scratch, c, n_tips, n_int, p);
      break;
  }
}

}  // namespace

extern "C" {

// The size rule's choice for a group (onchip_walk.cuh): kps [D, 3] holds
// each division's (K_d, S_d, P_d); out[0] the threads of an on-chip
// block, out[1] its dynamic shared memory in bytes, out[2 + d] division
// d's walk (0 whole, 1 staged, 2 global scratch), out[2 + D + d] its
// patterns a block (kThreads on the global walk) and out[2 + 2D + d] its
// lanes a pattern.  Returns a CUDA error code.
int mb_stacked_plan(const int* kps, int D, int C, int n_tips, int device,
                    int* out) {
  constexpr int kMaxDivisions = 256;
  if (D < 1 || D > kMaxDivisions) return (int)cudaErrorInvalidValue;
  mb::DeviceLimits lim;
  cudaError_t err = mb::device_limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  int K[kMaxDivisions], S[kMaxDivisions], P[kMaxDivisions];
  for (int d = 0; d < D; ++d) {
    K[d] = kps[3 * d];
    S[d] = kps[3 * d + 1];
    P[d] = kps[3 * d + 2];
  }
  int* walk = out + 2;
  int* T = out + 2 + D;
  mb::onchip_plan(D, K, S, P, C, n_tips, lim, out + 2 + 2 * D, walk, T, out,
                  out + 1);
  for (int d = 0; d < D; ++d)
    if (walk[d] == mb::kWalkGlobal) T[d] = kThreads;
  return 0;
}

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device`: the
// global-scratch kernel over the tile map's last n_global tiles, then the
// on-chip kernel over its first n_onchip tiles with the block of T threads
// and the shared-memory bytes of mb_stacked_plan, whose walks the table
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

const char* mb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
