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
// Design:
//   * the on-chip walk (onchip_walk.cuh): grid (ceil(P/T), C), one block
//     per (chain, tile of T patterns), G lanes per pattern (K*S rounded up
//     to a power of two, at most 32), each lane a few entries (k, s) of
//     the step in registers and the step's max a shuffle over the G
//     lanes; every partial in the block's shared memory (at most
//     n_tips / 2 live slots), the chain's operators and the tile's tips
//     copied there asynchronously; templates for S in {2, 3, 4, 8, 20};
//     only the root column and the log-scales are written to global
//     memory.  No padding of P or K*S (the ragged pattern edge is
//     masked), per-category S x S operators (no block-diagonal folding of
//     the K categories).
//   * the size rule in onchip_walk.cuh picks the walk and the block: the
//     whole chain's operators on chip, or staged a step ahead, or, for a
//     shape whose slots do not fit in a block of 32 threads (large n_tips
//     or K*S) or whose K*S needs more than 8 entries a lane (S = 32 with
//     16 categories), the global-scratch walk of down_pass.cuh
//     (grid (ceil(P/128), C), partials in a scratch tensor
//     [C, n_int, K, S, P]).
//
// What bounds it on an H100: latency.  The n_int-step dependent chain,
// each step a few S-long dot products per lane on shared-memory operands,
// log2(G) shuffles and a division, plus the block start (the operator and
// tip copies and thread 0's slot map) and the launch.
// At primates C = 4 (n_tips 12, P 413, K 4, S 4) the work is about 4.7
// MFLOP (under 0.1 us at 67 TFLOP/s fp32) and about 0.21 MB of compulsory
// traffic (under 0.1 us at 3.35 TB/s), so the FLOP and byte bounds are
// each far below the measured time.  The sharded path (sharded_cuda.py)
// launches this kernel once per shard.

#include <cuda_runtime.h>

#include "down_pass.cuh"
#include "onchip_walk.cuh"

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

template <int S_T>
__global__ void __launch_bounds__(256)
pruning_onchip_kernel(const int* __restrict__ lr,      // [C, n_int, 2]
                      const float* __restrict__ pstep, // [C, n_int, 2, K, S, S]
                      const float* __restrict__ tips,  // [n_tips, S, P]
                      float* __restrict__ root,        // [C, K, S, P]
                      float* __restrict__ ls,          // [C, P]
                      int n_tips, int n_int, int K, int S_rt, int P, int G,
                      int staged) {
  extern __shared__ float4 smem4[];
  const int S = S_T > 0 ? S_T : S_rt;
  const int c = blockIdx.y;
  mb::onchip_walk<S_T>(lr + (long long)c * n_int * 2,
                       pstep + (long long)c * n_int * 2 * K * S * S, tips,
                       root + (long long)c * K * S * P, ls + (long long)c * P,
                       n_tips, n_int, K, S, P, blockIdx.x * (blockDim.x / G),
                       G, staged != 0, reinterpret_cast<float*>(smem4));
}

template <int S_T>
cudaError_t launch_onchip(const mb::DeviceLimits& lim, int device, dim3 grid,
                          int T, int bytes, cudaStream_t st, const int* a,
                          const float* b, const float* t, float* r, float* l,
                          int n_tips, int n_int, int K, int S, int P, int G,
                          int staged) {
  static bool done[64] = {};
  cudaError_t err = mb::allow_smem(pruning_onchip_kernel<S_T>, device, bytes,
                                   done, lim);
  if (err != cudaSuccess) return err;
  pruning_onchip_kernel<S_T><<<grid, T, bytes, st>>>(
      a, b, t, r, l, n_tips, n_int, K, S, P, G, staged);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The size rule's choice for one launch (onchip_walk.cuh): out[0] the walk
// (0 whole, 1 staged, 2 global scratch), out[1] the threads of a block,
// out[2] its dynamic shared memory in bytes, out[3] its patterns, out[4]
// the lanes of a pattern.  Returns a CUDA error code (0 = success).
int mb_pruning_plan(int C, int n_tips, int K, int S, int P, int device,
                    int* out) {
  mb::DeviceLimits lim;
  cudaError_t err = mb::device_limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  mb::onchip_plan(1, &K, &S, &P, C, n_tips, lim, out + 4, out, out + 3,
                  out + 1, out + 2);
  if (out[0] == mb::kWalkGlobal) {     // down_pass.cuh's own launch
    out[1] = out[3] = kThreads;
    out[2] = 0;
  }
  return 0;
}

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device` as
// mb_pruning_plan chose for this shape and device: its walk, threads of a
// block, shared-memory bytes, patterns a block and lanes a pattern.
// `scratch` [C, n_int, K, S, P] is read only by the global-scratch walk and
// may be null otherwise.  Returns the cudaGetLastError() code after the
// launch (0 = success); the kernel itself runs asynchronously.
int mb_pruning_down(const void* lr, const void* pstep, const void* tips,
                    void* scratch, void* root, void* ls, int C, int n_tips,
                    int n_int, int K, int S, int P, int walk, int threads,
                    int bytes, int patterns, int lanes, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int* a = (const int*)lr;
  const float* b = (const float*)pstep;
  const float* t = (const float*)tips;
  float* sc = (float*)scratch;
  float* r = (float*)root;
  float* l = (float*)ls;
  if (walk == mb::kWalkGlobal) {
    if (sc == nullptr) return (int)cudaErrorInvalidValue;
    const dim3 grid((P + kThreads - 1) / kThreads, C);
    const dim3 block(kThreads);
    switch (S) {
      case 2:
        pruning_down_kernel<2><<<grid, block, 0, st>>>(
            a, b, t, sc, r, l, n_tips, n_int, K, S, P);
        break;
      case 4:
        pruning_down_kernel<4><<<grid, block, 0, st>>>(
            a, b, t, sc, r, l, n_tips, n_int, K, S, P);
        break;
      case 20:
        pruning_down_kernel<20><<<grid, block, 0, st>>>(
            a, b, t, sc, r, l, n_tips, n_int, K, S, P);
        break;
      default:
        pruning_down_kernel<0><<<grid, block, 0, st>>>(
            a, b, t, sc, r, l, n_tips, n_int, K, S, P);
        break;
    }
    return (int)cudaGetLastError();
  }
  mb::DeviceLimits lim;
  err = mb::device_limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const int T = threads;
  const int G = lanes;
  const dim3 grid((P + patterns - 1) / patterns, C);
  const int staged = walk == mb::kWalkStaged;
  const int s_t = mb::onchip_templated(S) ? S : 0;
  switch (s_t) {
    case 2:
      err = launch_onchip<2>(lim, device, grid, T, bytes, st, a, b, t, r, l,
                             n_tips, n_int, K, S, P, G, staged);
      break;
    case 3:
      err = launch_onchip<3>(lim, device, grid, T, bytes, st, a, b, t, r, l,
                             n_tips, n_int, K, S, P, G, staged);
      break;
    case 4:
      err = launch_onchip<4>(lim, device, grid, T, bytes, st, a, b, t, r, l,
                             n_tips, n_int, K, S, P, G, staged);
      break;
    case 8:
      err = launch_onchip<8>(lim, device, grid, T, bytes, st, a, b, t, r, l,
                             n_tips, n_int, K, S, P, G, staged);
      break;
    case 20:
      err = launch_onchip<20>(lim, device, grid, T, bytes, st, a, b, t, r, l,
                              n_tips, n_int, K, S, P, G, staged);
      break;
    default:
      err = launch_onchip<0>(lim, device, grid, T, bytes, st, a, b, t, r, l,
                             n_tips, n_int, K, S, P, G, staged);
      break;
  }
  return (int)err;
}

const char* mb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
