// Fused Felsenstein down-pass for every chain: the CUDA counterpart of the
// Pallas kernel mrbayes_tpu/ops/pruning_pallas.py:_kernel_g (and of its
// single-walk form _kernel, which nothing launches).
//
// What it computes, per chain c and pattern p, for each postorder step i
// with child slots (l, r) = lr[c, i]:
//     w_l[k,s] = sum_j Pstep[c,i,0,k,s,j] * CL[l][k,j,p]   (likewise w_r)
//     x[k,s]   = w_l[k,s] * w_r[k,s]
//     m        = max(max_{k,s} x[k,s], 1e-30)
//     CL[n_tips+i][k,s,p] = x[k,s] / m,   ls[c,p] += log(m)
// Slots below n_tips are the tips, shared by all chains (tips[slot,s,p],
// the same for every rate category k).  The last slot is the root.
//
// Design (a simple one that is right; the redesign comes later):
//   * grid (ceil(P/128), C), one thread per (chain, pattern).  Every chain
//     is its own slice of the grid: no walk interleaving, no block-diagonal
//     folding of the K categories, no padding of P or K*S (the ragged
//     pattern edge is masked).
//   * the per-category S x S operators of a step are the same for every
//     thread of a block, so they are read through the read-only cache
//     (__ldg), where the warp's loads of one address are broadcast.
//   * partials of internal slots live in a global scratch tensor
//     [C, n_int, K, S, P] with patterns contiguous, so the warp's accesses
//     coalesce.  Primates at C = 32 keeps about 9.3 MB there, which the
//     50 MB L2 holds; a block's 227 KB of shared memory cannot hold every
//     slot of larger trees.  A thread only ever reads back the column it
//     wrote itself, so no __syncthreads is needed.
//   * S in {2, 4, 20} is a template parameter (child columns in
//     registers); other S up to 64 with K <= 16 take the runtime-S path.
//   * the per-thread walk is mb::down_pass (down_pass.cuh), which the
//     multiwalk kernel (multiwalk.cu) shares.
//
// What bounds it on an H100: latency.  The n_int-step dependent chain (each
// step waits on the previous step's global writes through L2) plus the
// launch.  At primates C = 4 (n_tips 12, P 413, K 4, S 4) the work is about
// 4.7 MFLOP (under 0.1 us at 67 TFLOP/s fp32) and about 0.21 MB of
// compulsory traffic (under 0.1 us at 3.35 TB/s), so the FLOP and byte
// bounds are each far below the measured time.  The later redesign must
// attack that latency: keep a chain's walk on chip (shared memory or
// registers across a cooperative block), overlap chains, or fold the
// generation loop into a graph.

#include <cuda_runtime.h>

#include "down_pass.cuh"

namespace {

using mb::kThreads;

template <int S_T>
__global__ void __launch_bounds__(kThreads)
pruning_down_kernel(const int* __restrict__ lr,        // [C, n_int, 2]
                    const float* __restrict__ pstep,   // [C, n_int, 2, K, S, S]
                    const float* __restrict__ tips,    // [n_tips, S, P]
                    float* __restrict__ scratch,       // [C, n_int, K, S, P]
                    float* __restrict__ root,          // [C, K, S, P]
                    float* __restrict__ ls,            // [C, P]
                    int n_tips, int n_int, int K, int S_rt, int P) {
  const int S = S_T > 0 ? S_T : S_rt;
  const int c = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const long long KSP = (long long)K * S * P;
  mb::down_pass<S_T>(lr + (long long)c * n_int * 2,
                     pstep + (long long)c * n_int * 2 * K * S * S, tips + p,
                     scratch + (long long)c * n_int * KSP + p,
                     root + (long long)c * KSP + p,
                     ls + (long long)c * P + p, n_tips, n_int, K, S, P);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device`.
// Returns the cudaGetLastError() code after the launch (0 = success); the
// kernel itself runs asynchronously.
int mb_pruning_down(const void* lr, const void* pstep, const void* tips,
                    void* scratch, void* root, void* ls, int C, int n_tips,
                    int n_int, int K, int S, int P, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + kThreads - 1) / kThreads, C);
  const dim3 block(kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  const int* a = (const int*)lr;
  const float* b = (const float*)pstep;
  const float* t = (const float*)tips;
  float* sc = (float*)scratch;
  float* r = (float*)root;
  float* l = (float*)ls;
  switch (S) {
    case 2:
      pruning_down_kernel<2><<<grid, block, 0, st>>>(a, b, t, sc, r, l,
                                                     n_tips, n_int, K, S, P);
      break;
    case 4:
      pruning_down_kernel<4><<<grid, block, 0, st>>>(a, b, t, sc, r, l,
                                                     n_tips, n_int, K, S, P);
      break;
    case 20:
      pruning_down_kernel<20><<<grid, block, 0, st>>>(a, b, t, sc, r, l,
                                                      n_tips, n_int, K, S, P);
      break;
    default:
      pruning_down_kernel<0><<<grid, block, 0, st>>>(a, b, t, sc, r, l,
                                                     n_tips, n_int, K, S, P);
      break;
  }
  return (int)cudaGetLastError();
}

const char* mb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
