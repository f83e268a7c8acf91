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
//   * the tiled walk (tiled_walk.cuh) for a shape whose slots do not fit
//     the on-chip walk in a block of 32 threads (large n_tips or K*S) or
//     whose K*S needs more than 8 entries a lane (replicase under M10,
//     K 8 x S 61; S = 32 with 16 categories): one thread-block cluster
//     per (chain, tile of T patterns), the categories split across its
//     blocks, each (step, category) a block-cooperative product on
//     operators that a producer warp streams through a two-stage
//     cp.async ring, the live partials in shared memory and the step's
//     max combined through distributed shared memory; templates for S 61
//     and runtime S.
//   * the size rule in onchip_walk.cuh picks the walk and the block: the
//     whole chain's operators on chip, or staged a step ahead, or the
//     tiled walk (tiled_plan), or, only where the tiled walk's slots do
//     not fit either (the formula in tiled_walk.cuh: beyond 335 tips at
//     S 61), the global-scratch walk of down_pass.cuh
//     (grid (ceil(P/128), C), partials in a scratch tensor
//     [C, n_int, K, S, P]).
//
// What bounds it on an H100: latency, for the on-chip walks.  The
// n_int-step dependent chain, each step a few S-long dot products per
// lane on shared-memory operands, log2(G) shuffles and a division, plus
// the block start (the operator and tip copies and thread 0's slot map)
// and the launch.  The tiled walk: shared-memory loads of its products
// and a cluster barrier a step (its header); the global-scratch walk:
// latency through L2 (down_pass.cuh).
// At primates C = 4 (n_tips 12, P 413, K 4, S 4) the work is about 4.7
// MFLOP (under 0.1 us at 67 TFLOP/s fp32) and about 0.21 MB of compulsory
// traffic (under 0.1 us at 3.35 TB/s), so the FLOP and byte bounds are
// each far below the measured time.  The sharded path (sharded_cuda.py)
// launches this kernel once per shard.

#include <cuda_runtime.h>

#include "down_pass.cuh"
#include "onchip_walk.cuh"
#include "tiled_walk.cuh"

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

template <int S_T, int B>
__global__ void __launch_bounds__(32 * mb::kTiledMaxWarps)
pruning_tiled_kernel(const int* __restrict__ lr,      // [C, n_int, 2]
                     const float* __restrict__ pstep, // [C, n_int, 2, K, S, S]
                     const float* __restrict__ tips,  // [n_tips, S, P]
                     float* __restrict__ root,        // [C, K, S, P]
                     float* __restrict__ ls,          // [C, P]
                     int n_tips, int n_int, int K, int S_rt, int P, int T,
                     int Q) {
  extern __shared__ float4 smem4[];
  const int S = S_T > 0 ? S_T : S_rt;
  const int c = blockIdx.z;
  mb::tiled_walk<S_T, B>(lr + (long long)c * n_int * 2,
                         pstep + (long long)c * n_int * 2 * K * S * S, tips,
                         root + (long long)c * K * S * P,
                         ls + (long long)c * P, n_tips, n_int, K, S, P,
                         blockIdx.y * T, T, Q,
                         reinterpret_cast<float*>(smem4));
}

// One cluster launch of the tiled walk: grid (Q, ceil(P/T), C), clusters
// of Q blocks along x.
template <int S_T, int B>
cudaError_t launch_tiled(const mb::DeviceLimits& lim, int device, int C,
                         int T, int threads, int bytes, int Q,
                         cudaStream_t st, const int* a, const float* b,
                         const float* t, float* r, float* l, int n_tips,
                         int n_int, int K, int S, int P) {
  static bool done[64] = {};
  cudaError_t err = mb::allow_smem(pruning_tiled_kernel<S_T, B>, device,
                                   bytes, done, lim);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q, (P + T - 1) / T, C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pruning_tiled_kernel<S_T, B>, a, b, t, r, l,
                           n_tips, n_int, K, S, P, T, Q);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int S_T>
cudaError_t launch_tiled_width(int width, const mb::DeviceLimits& lim,
                               int device, int C, int T, int threads,
                               int bytes, int Q, cudaStream_t st,
                               const int* a, const float* b, const float* t,
                               float* r, float* l, int n_tips, int n_int,
                               int K, int S, int P) {
  switch (width) {
    case 4:
      return launch_tiled<S_T, 4>(lim, device, C, T, threads, bytes, Q, st,
                                  a, b, t, r, l, n_tips, n_int, K, S, P);
    case 2:
      return launch_tiled<S_T, 2>(lim, device, C, T, threads, bytes, Q, st,
                                  a, b, t, r, l, n_tips, n_int, K, S, P);
    case 1:
      return launch_tiled<S_T, 1>(lim, device, C, T, threads, bytes, Q, st,
                                  a, b, t, r, l, n_tips, n_int, K, S, P);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The tiled walk's plan for one launch (tiled_walk.cuh:tiled_plan), with
// the cluster size `cluster` and the patterns a block `T` forced where
// they are > 0: out[0] the walk (3 tiled; 2 where no T fits), out[1] the
// threads of a block, out[2] its dynamic shared memory in bytes, out[3]
// its patterns, out[4] the lanes of a pattern (along s), out[5] the
// blocks of a cluster.  Returns a CUDA error code (0 = success).
int mb_tiled_plan(int C, int n_tips, int K, int S, int P, int device,
                  int cluster, int T, int* out) {
  mb::DeviceLimits lim;
  cudaError_t err = mb::device_limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  for (int e = 0; e < 6; ++e) out[e] = 0;
  out[0] = mb::tiled_plan(C, n_tips, K, S, P, lim, cluster, T, out + 3,
                          out + 1, out + 2, out + 4, out + 5)
               ? mb::kWalkTiled
               : mb::kWalkGlobal;
  return 0;
}

// The size rule's choice for one launch (onchip_walk.cuh, then
// tiled_walk.cuh where no on-chip walk fits): out[0] the walk (0 whole,
// 1 staged, 2 global scratch, 3 tiled), out[1] the threads of a block,
// out[2] its dynamic shared memory in bytes, out[3] its patterns, out[4]
// the lanes of a pattern (along s on the tiled walk), out[5] the blocks
// of a cluster (0 off the tiled walk).  Returns a CUDA error code
// (0 = success).
int mb_pruning_plan(int C, int n_tips, int K, int S, int P, int device,
                    int* out) {
  mb::DeviceLimits lim;
  cudaError_t err = mb::device_limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  out[5] = 0;
  mb::onchip_plan(1, &K, &S, &P, C, n_tips, lim, out + 4, out, out + 3,
                  out + 1, out + 2);
  if (out[0] != mb::kWalkGlobal) return 0;
  if (mb::tiled_plan(C, n_tips, K, S, P, lim, 0, 0, out + 3, out + 1,
                     out + 2, out + 4, out + 5)) {
    out[0] = mb::kWalkTiled;
    return 0;
  }
  out[1] = out[3] = kThreads;          // down_pass.cuh's own launch
  out[2] = 0;
  out[4] = 1;
  return 0;
}

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device` as
// mb_pruning_plan (or mb_tiled_plan) chose for this shape and device: its
// walk, threads of a block, shared-memory bytes, patterns a block, lanes
// a pattern and blocks of a cluster.  `scratch` [C, n_int, K, S, P] is
// read only by the global-scratch walk and may be null otherwise.
// Returns the launch's error code, else the cudaGetLastError() code after
// it (0 = success); the kernel itself runs asynchronously.  A cluster
// launch the device refuses returns its error: nothing is retried.
int mb_pruning_down(const void* lr, const void* pstep, const void* tips,
                    void* scratch, void* root, void* ls, int C, int n_tips,
                    int n_int, int K, int S, int P, int walk, int threads,
                    int bytes, int patterns, int lanes, int cluster,
                    int device, void* stream) {
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
  if (walk == mb::kWalkTiled) {
    // the consumer warps' patterns a thread, from the plan's block
    const int consumers = threads / 32 - 1;
    const int lp = 32 / mb::tiled_lanes(S);
    const int width = consumers > 0 ? patterns / (lp * consumers) : 0;
    if (cluster < 1 || cluster > mb::kTiledMaxCluster || cluster > K ||
        patterns < 4 || patterns > 32 || patterns % 4 != 0 ||
        threads % 32 != 0 || threads > 32 * mb::kTiledMaxWarps ||
        width * lp * consumers != patterns ||
        lanes != mb::tiled_lanes(S))
      return (int)cudaErrorInvalidValue;
    if (S == 61)
      err = launch_tiled_width<61>(width, lim, device, C, patterns, threads,
                                   bytes, cluster, st, a, b, t, r, l, n_tips,
                                   n_int, K, S, P);
    else
      err = launch_tiled_width<0>(width, lim, device, C, patterns, threads,
                                  bytes, cluster, st, a, b, t, r, l, n_tips,
                                  n_int, K, S, P);
    return (int)err;
  }
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
