// Level-batched (wavefront) Felsenstein down-pass for every chain: the CUDA
// counterpart of the Pallas kernel mrbayes_tpu/ops/pruning_pallas.py:
// _kernel_wavefront (launched by _pallas_batched_wavefront, wired by
// PruningPallasWavefront).
//
// The schedule (ops/wavefront_cuda.py: wavefront_schedule) groups the
// internal nodes of each chain's tree by root distance into rows of up to W
// nodes; every node of a row depends only on nodes of earlier rows.  For
// chain c, each row r < nrows[c], each row slot w < W and each pattern p,
// with entry e = r * W + w:
//     (l, r') = row_lr[c, e],  b = bidx[c, e],  o = row_out[c, e]
//     x[k,s]  = (B[b,0,k] . CL[l][k,:,p])[s] * (B[b,1,k] . CL[r'][k,:,p])[s]
//     m       = max(max_{k,s} x[k,s], 1e-30)
//     CL[o][k,s,p] = x[k,s] / m
//     ls[c,p] += log(m)   only where wmask[c, e] is set
// Slots below n_tips are the tips (shared by all chains, the same for every
// rate category); the root is slot n_tips + n_int - 1.
//
// Design (a simple one that is right; making it fast is later work):
//   * grid (ceil(P / 32), C), block (32, W): one thread per (row slot w,
//     pattern); a warp is 32 patterns of one row slot, so its loads and
//     stores of the partials coalesce and its reads of the row's indices
//     and operators are broadcasts.
//   * the TPU kernel's [2W*KSp]^2 block-diagonal MXU operand is the TPU's
//     layout; here each entry applies its own per-category S x S operators
//     (mb::combine_step, shared with pruning.cu), so there is no K-fold or
//     W-fold zero work.
//   * rows are separated by __syncthreads(): a row reads partials that other
//     threads of the block (other w, the same patterns) wrote in earlier
//     rows.  The partials live in a global scratch [C, n_int, K, S, P] (L2),
//     as in pruning.cu, whatever the tree's size.
//   * the row count nrows[c] is read by the kernel from device memory, so
//     the schedule never makes the host wait.
//   * padded entries (wmask 0) are skipped: the TPU kernel computes them
//     from a trash slot and selects their log-scale away (:526-529); not
//     computing them gives the same root partials and log-scales, and the
//     trash slot is never read here.
//   * each thread keeps its row slot's log-scale in a register; the W sums
//     are added through shared memory at the end.
//
// What bounds it on an H100: latency, as for pruning.cu.  The dependent
// chain is the row count (about the tree's height, plus rows split at W)
// instead of n_int steps, but each row costs a block-wide barrier and the
// scratch round trip through L2.  At cynmix's largest division (C = 8,
// n_tips 32, K 4, S 4, P 537) the work is about 8.7 MFLOP and 1.0 MB of
// compulsory traffic, each far under a microsecond.

#include <cuda_runtime.h>

#include "down_pass.cuh"

namespace {

constexpr int kTile = 32;    // patterns per block
constexpr int kMaxW = 16;    // row slots per block (blockDim.y)

template <int S_T>
__global__ void __launch_bounds__(kTile * kMaxW)
wavefront_down_kernel(const int* __restrict__ nrows,     // [C]
                      const int* __restrict__ row_lr,    // [C, R*W, 2]
                      const int* __restrict__ row_out,   // [C, R*W]
                      const int* __restrict__ bidx,      // [C, R*W]
                      const float* __restrict__ wmask,   // [C, R*W]
                      const float* __restrict__ pstep,   // [C, n_int+1, 2, K, S, S]
                      const float* __restrict__ tips,    // [n_tips, S, P]
                      float* scratch,                    // [C, n_int, K, S, P]
                      float* __restrict__ root,          // [C, K, S, P]
                      float* __restrict__ ls,            // [C, P]
                      int n_tips, int n_int, int R, int W, int K, int S_rt,
                      int P) {
  __shared__ float part[kMaxW][kTile];
  const int S = S_T > 0 ? S_T : S_rt;
  const int c = blockIdx.y;
  const int w = threadIdx.y;
  const int t = threadIdx.x;
  const int p = blockIdx.x * kTile + t;
  const bool active = p < P;
  const long long SP = (long long)S * P;
  const long long KSP = (long long)K * SP;
  const int KSS = K * S * S;
  const long long RW = (long long)R * W;
  const int* lr_c = row_lr + c * RW * 2;
  const int* out_c = row_out + c * RW;
  const int* b_c = bidx + c * RW;
  const float* mask_c = wmask + c * RW;
  const float* op_c = pstep + (long long)c * (n_int + 1) * 2 * KSS;
  const float* tp = tips + p;
  float* scr = scratch + (long long)c * n_int * KSP + p;
  const int nr = __ldg(nrows + c);
  float lsum = 0.f;
  for (int r = 0; r < nr; ++r) {
    const long long e = (long long)r * W + w;
    if (active && __ldg(mask_c + e) > 0.f) {
      const int sl = __ldg(lr_c + 2 * e);
      const int sr = __ldg(lr_c + 2 * e + 1);
      const float* bl = sl < n_tips ? tp + sl * SP
                                    : scr + (long long)(sl - n_tips) * KSP;
      const float* br = sr < n_tips ? tp + sr * SP
                                    : scr + (long long)(sr - n_tips) * KSP;
      const float* opl = op_c + (long long)__ldg(b_c + e) * 2 * KSS;
      float* out = scr + (long long)(__ldg(out_c + e) - n_tips) * KSP;
      const float m = mb::combine_step<S_T>(
          bl, sl < n_tips ? 0 : SP, br, sr < n_tips ? 0 : SP, opl,
          opl + KSS, out, K, S, P);
      for (int ks = 0; ks < K * S; ++ks) out[ks * P] = out[ks * P] / m;
      lsum += logf(m);
    }
    __syncthreads();
  }
  part[w][t] = lsum;
  __syncthreads();
  if (!active) return;
  if (w == 0) {
    float s = 0.f;
    for (int v = 0; v < W; ++v) s += part[v][t];
    ls[(long long)c * P + p] = s;
  }
  const float* last = scr + (long long)(n_int - 1) * KSP;
  float* rt = root + (long long)c * KSP + p;
  for (int ks = w; ks < K * S; ks += W) rt[ks * P] = last[ks * P];
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device`.
// Returns the cudaGetLastError() code after the launch (0 = success); the
// kernel itself runs asynchronously.  W must be in [1, 16].
int mb_wavefront_down(const void* nrows, const void* row_lr,
                      const void* row_out, const void* bidx,
                      const void* wmask, const void* pstep, const void* tips,
                      void* scratch, void* root, void* ls, int C, int n_tips,
                      int n_int, int R, int W, int K, int S, int P,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kTile - 1) / kTile, C);
  const dim3 block(kTile, W);
  cudaStream_t st = (cudaStream_t)stream;
  const int* nr = (const int*)nrows;
  const int* lr = (const int*)row_lr;
  const int* ro = (const int*)row_out;
  const int* bi = (const int*)bidx;
  const float* wm = (const float*)wmask;
  const float* b = (const float*)pstep;
  const float* t = (const float*)tips;
  float* sc = (float*)scratch;
  float* r = (float*)root;
  float* l = (float*)ls;
#define MB_WAVEFRONT_LAUNCH(S_T)                                          \
  wavefront_down_kernel<S_T><<<grid, block, 0, st>>>(                     \
      nr, lr, ro, bi, wm, b, t, sc, r, l, n_tips, n_int, R, W, K, S, P)
  switch (S) {
    case 2: MB_WAVEFRONT_LAUNCH(2); break;
    case 3: MB_WAVEFRONT_LAUNCH(3); break;
    case 4: MB_WAVEFRONT_LAUNCH(4); break;
    case 8: MB_WAVEFRONT_LAUNCH(8); break;
    default: MB_WAVEFRONT_LAUNCH(0); break;
  }
#undef MB_WAVEFRONT_LAUNCH
  return (int)cudaGetLastError();
}

const char* mb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
