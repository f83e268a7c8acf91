// One thread's Felsenstein down-pass over a whole postorder, with the
// partials in global memory: the global-scratch walk, the last of
// pruning.cu's four walks (whole, staged, tiled, global).  stacked.cu and
// multiwalk.cu run it for a member whose slots do not fit the on-chip
// walk (the size rule of onchip_walk.cuh), pruning.cu only for a shape
// that fits neither the on-chip nor the tiled walk (tiled_walk.cuh), and
// multiwalk.cu for the old walk's time; every other launch takes one of
// those walks, which compute the same arithmetic in the same order.
//
// For one walk (one chain of one division) and one pattern p, for each
// postorder step i with child slots (l, r) = lr[i]:
//     w_l[k,s] = sum_j op[i,0,k,s,j] * CL[l][k,j,p]   (likewise w_r)
//     x[k,s]   = w_l[k,s] * w_r[k,s]
//     m        = max(max_{k,s} x[k,s], 1e-30)
//     CL[n_tips+i][k,s,p] = x[k,s] / m,   ls[p] += log(m)
// Slots below n_tips are the tips (tips[slot,s,p], the same for every
// rate category k); internal slots live in the walk's scratch
// [n_int, K, S, P], patterns contiguous so a warp's accesses coalesce.
// The last slot is the root, copied to root[K, S, P].  A thread reads
// back only the column it wrote itself, so no barrier is needed.
//
// What bounds it on an H100: latency through L2.  Each step writes its
// partial to global scratch, reads it back to normalise it and writes it
// again, and the parent step reads it once more: about 3.8 us a step,
// whatever P is.  S in {2, 4, 20} is a template parameter (child columns in registers); S_T = 0 takes S
// from S_rt at run time and keeps no per-S arrays, so any S the wrappers
// admit fits.

#pragma once

#include <cuda_runtime.h>

namespace mb {

constexpr int kThreads = 128;
constexpr float kTiny = 1e-30f;

// One postorder step for one pattern: the children's columns bl and br
// (category strides kl and kr: 0 for a tip, S * P for an internal slot)
// through the per-category operators opl and opr [K, S, S]; writes the
// unnormalised x[k, s] to out[k * S * P + s * P] and returns
// max(max_{k,s} x, 1e-30).
template <int S_T>
__device__ __forceinline__ float combine_step(
    const float* bl, long long kl, const float* br, long long kr,
    const float* __restrict__ opl, const float* __restrict__ opr,
    float* out, int K, int S_rt, int P) {
  const int S = S_T > 0 ? S_T : S_rt;
  const long long SP = (long long)S * P;
  const int SS = S * S;
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
  return fmaxf(m, kTiny);
}

template <int S_T>
__device__ __forceinline__ void down_pass(
    const int* __restrict__ lr,       // [n_int, 2] child slots
    const float* __restrict__ op,     // [n_int, 2, K, S, S] operators
    const float* __restrict__ tips,   // &tips[0, 0, p] of [n_tips, S, P]
    float* __restrict__ scr,          // &scratch[0, 0, 0, p] of [n_int, K, S, P]
    float* __restrict__ root,         // &root[0, 0, p] of [K, S, P]
    float* __restrict__ ls,           // &ls[p]
    int n_tips, int n_int, int K, int S_rt, int P) {
  const int S = S_T > 0 ? S_T : S_rt;
  const long long SP = (long long)S * P;
  const long long KSP = (long long)K * SP;
  const int SS = S * S;
  float lsum = 0.f;
  for (int i = 0; i < n_int; ++i) {
    const int sl = __ldg(lr + 2 * i);
    const int sr = __ldg(lr + 2 * i + 1);
    // child column bases; a tip's column is the same for every category
    const float* bl = sl < n_tips ? tips + sl * SP
                                  : scr + (long long)(sl - n_tips) * KSP;
    const float* br = sr < n_tips ? tips + sr * SP
                                  : scr + (long long)(sr - n_tips) * KSP;
    const float* opl = op + (long long)(2 * i) * K * SS;
    float* out = scr + (long long)i * KSP;
    const float m = combine_step<S_T>(bl, sl < n_tips ? 0 : SP, br,
                                      sr < n_tips ? 0 : SP, opl,
                                      opl + K * SS, out, K, S, P);
    for (int ks = 0; ks < K * S; ++ks) out[ks * P] = out[ks * P] / m;
    lsum += logf(m);
  }
  const float* last = scr + (long long)(n_int - 1) * KSP;
  for (int ks = 0; ks < K * S; ++ks) root[ks * P] = last[ks * P];
  *ls = lsum;
}

}  // namespace mb
