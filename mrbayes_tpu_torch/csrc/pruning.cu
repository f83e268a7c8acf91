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

namespace {

constexpr int kThreads = 128;
constexpr float kTiny = 1e-30f;

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
  const long long SP = (long long)S * P;
  const long long KSP = (long long)K * SP;
  const int SS = S * S;
  float* scr = scratch + (long long)c * n_int * KSP + p;
  const int* lr_c = lr + (long long)c * n_int * 2;
  const float* op_c = pstep + (long long)c * n_int * 2 * K * SS;
  float lsum = 0.f;
  for (int i = 0; i < n_int; ++i) {
    const int sl = __ldg(lr_c + 2 * i);
    const int sr = __ldg(lr_c + 2 * i + 1);
    // child column bases; a tip's column is the same for every category
    const float* bl = sl < n_tips ? tips + sl * SP + p
                                  : scr + (long long)(sl - n_tips) * KSP;
    const float* br = sr < n_tips ? tips + sr * SP + p
                                  : scr + (long long)(sr - n_tips) * KSP;
    const long long kl = sl < n_tips ? 0 : SP;
    const long long kr = sr < n_tips ? 0 : SP;
    const float* opl = op_c + (long long)(2 * i) * K * SS;
    const float* opr = opl + K * SS;
    float* out = scr + (long long)i * KSP;
    float m = 0.f;
    for (int k = 0; k < K; ++k) {
      const float* xl = bl + k * kl;
      const float* xr = br + k * kr;
      const float* ol = opl + k * SS;
      const float* orr = opr + k * SS;
      float* o = out + k * SP;
      if constexpr (S_T > 0) {
        float vl[S_T], vr[S_T];
#pragma unroll
        for (int j = 0; j < S_T; ++j) {
          vl[j] = xl[j * P];
          vr[j] = xr[j * P];
        }
#pragma unroll
        for (int s = 0; s < S_T; ++s) {
          float wl = 0.f, wr = 0.f;
#pragma unroll
          for (int j = 0; j < S_T; ++j) {
            wl = fmaf(__ldg(ol + s * S_T + j), vl[j], wl);
            wr = fmaf(__ldg(orr + s * S_T + j), vr[j], wr);
          }
          const float x = wl * wr;
          o[s * P] = x;
          m = fmaxf(m, x);
        }
      } else {
        for (int s = 0; s < S; ++s) {
          float wl = 0.f, wr = 0.f;
          for (int j = 0; j < S; ++j) {
            wl = fmaf(__ldg(ol + s * S + j), xl[j * P], wl);
            wr = fmaf(__ldg(orr + s * S + j), xr[j * P], wr);
          }
          const float x = wl * wr;
          o[s * P] = x;
          m = fmaxf(m, x);
        }
      }
    }
    m = fmaxf(m, kTiny);
    for (int ks = 0; ks < K * S; ++ks) out[ks * P] = out[ks * P] / m;
    lsum += logf(m);
  }
  const float* last = scr + (long long)(n_int - 1) * KSP;
  float* rt = root + (long long)c * KSP + p;
  for (int ks = 0; ks < K * S; ++ks) rt[ks * P] = last[ks * P];
  ls[(long long)c * P + p] = lsum;
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
