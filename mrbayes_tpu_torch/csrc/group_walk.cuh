// What the stacked kernel (stacked.cu) and the multiwalk kernel
// (multiwalk.cu) share: a group of divisions that share one tree (or, in
// stacked.cu, that each have their own), every (division, chain, pattern
// tile) in one launch (two where a division takes the global-scratch
// walk).
//
// Block (c, y) of either kernel is chain c of tile y, T_d patterns of one
// division d, found through a tile map [n_tiles, 2] = (division, first
// pattern) built once on the device (ops/pruning_cuda.py:GroupLayout.
// tile_map): the on-chip tiles first, the costliest divisions' leading so
// that the longest walks start first, then the global-scratch tiles.  A
// per-division table [D, kTable] holds K_d, S_d, P_d, the element offsets
// of the division's operators [C, n_int, 2, K_d, S_d, S_d], tips
// [n_tips, S_d, P_d], root partials [C, K_d, S_d, P_d], log-scales
// [C, P_d] and scratch in the flat buffers, its walk and its lanes a
// pattern G_d, and the element offset of the division's child slots lr in
// their buffer: 0 for every member of a group that shares one tree
// (lr [C, n_int, 2]), d * C * n_int * 2 for a group of gene trees, one
// tree a member (lr [D, C, n_int, 2], the BEST likelihood of
// mcmc/engine.py).  An on-chip block runs its division's own walk of
// onchip_walk.cuh at its own K_d and S_d; a global-scratch block runs
// down_pass.cuh's walk, one thread a pattern, in a second kernel, so that
// the on-chip kernel's registers are the on-chip walk's alone (scratch is
// allocated for those divisions only).
//
// mb_group_plan below is the size rule of onchip_walk.cuh applied to all
// the group's divisions at once; the dynamic shared memory of every
// on-chip block is the largest on-chip division's.

#pragma once

#include <cuda_runtime.h>

#include "down_pass.cuh"
#include "onchip_walk.cuh"

namespace mb {

// K, S, P, then the offsets of pstep, tips, root, ls, scratch, the walk,
// the lanes of a pattern and the offset of the member's lr block
constexpr int kTable = 11;

// Division d's chain c: its slots, operators, tips, root partials and
// log-scales.
struct Member {
  int K, S, P;
  const int* lr;
  const float* op;
  const float* tips;
  float* root;
  float* ls;
};

// Block (c, y)'s division: its table row *row and first pattern *p0 from
// the tile map, and its member view.
__device__ __forceinline__ Member tile_member(
    const long long* table, const int* tiles, const int* lr,
    const float* pstep, const float* tips, float* root, float* ls, int c,
    int y, int n_int, const long long** row, int* p0) {
  const long long* t = table + (long long)kTable * tiles[2 * y];
  *row = t;
  *p0 = tiles[2 * y + 1];
  Member m;
  m.K = (int)t[0];
  m.S = (int)t[1];
  m.P = (int)t[2];
  m.lr = lr + t[10] + (long long)c * n_int * 2;
  m.op = pstep + t[3] + (long long)c * n_int * 2 * m.K * m.S * m.S;
  m.tips = tips + t[4];
  m.root = root + t[5] + (long long)c * m.K * m.S * m.P;
  m.ls = ls + t[6] + (long long)c * m.P;
  return m;
}

// The on-chip walk of one tile (S_T = 0: S from the table).
template <int S_T>
__device__ __forceinline__ void onchip_member(const Member& m,
                                              const long long* t, int n_tips,
                                              int n_int, int p0,
                                              float* smem) {
  onchip_walk<S_T>(m.lr, m.op, m.tips, m.root, m.ls, n_tips, n_int, m.K,
                   m.S, m.P, p0, (int)t[9], t[8] == kWalkStaged, smem);
}

// The global-scratch walk of pattern p of chain c.
template <int S_T>
__device__ __forceinline__ void global_member(const Member& m,
                                              const long long* t,
                                              float* scratch, int c,
                                              int n_tips, int n_int, int p) {
  const long long KSP = (long long)m.K * m.S * m.P;
  down_pass<S_T>(m.lr, m.op, m.tips + p,
                 scratch + t[7] + (long long)c * n_int * KSP + p, m.root + p,
                 m.ls + p, n_tips, n_int, m.K, m.S, m.P);
}

}  // namespace mb

extern "C" {

// The size rule's choice for a group (onchip_walk.cuh): kps [D, 3] holds
// each division's (K_d, S_d, P_d); out[0] the threads of an on-chip
// block, out[1] its dynamic shared memory in bytes, out[2 + d] division
// d's walk (0 whole, 1 staged, 2 global scratch), out[2 + D + d] its
// patterns a block (kThreads on the global walk) and out[2 + 2D + d] its
// lanes a pattern.  Returns a CUDA error code (0 = success).
int mb_group_plan(const int* kps, int D, int C, int n_tips, int device,
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
    if (walk[d] == mb::kWalkGlobal) T[d] = mb::kThreads;
  return 0;
}

const char* mb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
