// Fused Felsenstein down-pass for a group of divisions that share one tree,
// every (division, chain) walk in one launch: the CUDA counterpart of the
// Pallas kernel mrbayes_tpu/ops/pruning_pallas.py:_kernel_w (launched by
// _pallas_multiwalk, wired by PruningPallasMultiwalk).
//
// Walk w = d * C + c is chain c of division d.  Every walk of chain c reads
// that chain's child slots lr[c] (the divisions share the tree); each walk
// has its own per-category operators and its own division's tips.  The
// arithmetic per (walk, pattern) is mb::down_pass (down_pass.cuh), the same
// as the single-division kernel in pruning.cu.
//
// Design (simple and right first; the redesign comes later):
//   * grid (ceil(max_d P_d / 128), D * C), one thread per (walk, pattern).
//     The walk-to-chain map is plain arithmetic (d = w / C, c = w % C): the
//     TPU kernel's base/c_row bookkeeping existed only for its grid cells.
//   * divisions are ragged: each division d keeps its own rate-category
//     count K_d and pattern count P_d, read from a small table
//     [D, 7] = (K_d, P_d, and the offsets of its operators, tips, scratch,
//     root and log-scales in the flat buffers).  A thread past its
//     division's P_d returns; there is no 128-lane padding and no padding of
//     K_d * S to the group's largest.
//   * the state count S is shared by the group (the engine groups divisions
//     by S): S is the template parameter that keeps child columns in
//     registers, and mixing S in one launch would push every walk onto the
//     slower runtime-S path.
//   * each division's tips are stored once, [n_tips, S, P_d], for all of its
//     chains; scratch is sum_d C * n_int * K_d * S * P_d floats.
//
// What bounds it on an H100: latency, as for pruning.cu.  At test1's shapes
// (D = 2, C = 8, n_tips 12, K 4, S 4, P 199 and 258) the work is about
// 10 MFLOP and 0.5 MB of compulsory traffic, each well under a microsecond;
// the n_int-step dependent chain and the launch dominate.  What one launch
// saves against one launch per division is the second launch and the
// second serial walk.

#include <cuda_runtime.h>

#include "down_pass.cuh"

namespace {

using mb::kThreads;
constexpr int kTable = 7;   // K, P, pstep, tips, scratch, root, ls offsets

template <int S_T>
__global__ void __launch_bounds__(kThreads)
multiwalk_down_kernel(const int* __restrict__ lr,          // [C, n_int, 2]
                      const float* __restrict__ pstep,     // flat operators
                      const float* __restrict__ tips,      // flat tips
                      float* __restrict__ scratch,         // flat scratch
                      float* __restrict__ root,            // flat roots
                      float* __restrict__ ls,              // flat log-scales
                      const long long* __restrict__ table, // [D, 7]
                      int C, int n_tips, int n_int, int S_rt) {
  const int S = S_T > 0 ? S_T : S_rt;
  const int w = blockIdx.y;
  const int d = w / C;
  const int c = w - d * C;
  const long long* t = table + (long long)kTable * d;
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

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device`.
// Returns the cudaGetLastError() code after the launch (0 = success); the
// kernel itself runs asynchronously.
int mb_multiwalk_down(const void* lr, const void* pstep, const void* tips,
                      void* scratch, void* root, void* ls, const void* table,
                      int D, int C, int n_tips, int n_int, int S, int P_max,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P_max + kThreads - 1) / kThreads, D * C);
  const dim3 block(kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  const int* a = (const int*)lr;
  const float* b = (const float*)pstep;
  const float* t = (const float*)tips;
  float* sc = (float*)scratch;
  float* r = (float*)root;
  float* l = (float*)ls;
  const long long* tb = (const long long*)table;
  switch (S) {
    case 2:
      multiwalk_down_kernel<2><<<grid, block, 0, st>>>(
          a, b, t, sc, r, l, tb, C, n_tips, n_int, S);
      break;
    case 4:
      multiwalk_down_kernel<4><<<grid, block, 0, st>>>(
          a, b, t, sc, r, l, tb, C, n_tips, n_int, S);
      break;
    case 20:
      multiwalk_down_kernel<20><<<grid, block, 0, st>>>(
          a, b, t, sc, r, l, tb, C, n_tips, n_int, S);
      break;
    default:
      multiwalk_down_kernel<0><<<grid, block, 0, st>>>(
          a, b, t, sc, r, l, tb, C, n_tips, n_int, S);
      break;
  }
  return (int)cudaGetLastError();
}

const char* mb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
