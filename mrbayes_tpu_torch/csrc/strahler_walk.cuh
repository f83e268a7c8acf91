// pruning.cu's Strahler walk: the on-chip down-pass of onchip_walk.cuh
// with its steps in a Strahler (Sethi-Ullman) postorder and its tips
// packed as bit masks, so that a block of many patterns fits beside the
// partials of a large tree.  Each step computes what onchip_walk does,
// with the same products in the same order, so the root partials agree
// with it bit for bit; only ls, a sum of the steps' log(m), is summed in
// the new order.
//
// Step order.  A pre-pass (strahler_schedule_kernel, one warp a chain,
// launched before the walk) reads the chain's child slots lr [n_int, 2],
// given in a postorder whose last step is the root, and writes the
// chain's schedule [n_int] of int4 (step, left code, right code, slot):
// the steps in a postorder that at every internal node walks first the
// child whose subtree needs more slots (its Strahler number, tips 0; the
// left child on a tie), the root still last.  The partials alive at once
// are then a stack, and a step's slot is its depth in that stack: a step
// at depth d writes slot d, which is its first child's (read before the
// write, as onchip_walk's steps read a child they overwrite), and its
// second child sits at d + 1 while the first waits.  A tree of n tips
// needs at most floor(log2 n) slots that way (7 at 169 tips, where the
// walk of onchip_walk.cuh reserves n / 2 = 84); a child code is a tip's
// index (>= 0) or -(slot + 1).  The twin is
// ops/pruning_cuda.py:strahler_schedule.
//
// Tips.  Where every tip entry is exactly 0 or 1, a tip's column at a
// pattern is a mask of S bits (uint8 for S <= 8, 32 bits up to S 32;
// ops/pruning_cuda.py:pack_tips builds them once a division).  A block
// copies its tile's masks (1 or 4 bytes a tip and pattern, against 4*S)
// and a lane expands a tip child's bits into 0.0f / 1.0f as it multiplies:
// the same operands as the float tips.
//
// Operators.  The whole chain's [n_int, 2, K, S, S] copied once at the
// start ("strahler"), or one step's copied a step ahead into one of two
// buffers with two block barriers a step ("strahler_staged"); a step reads
// them by its original index.
//
// The size rule (strahler_plan).  With these two cuts a pattern costs
// about (floor(log2 n) * K*S + n * mask bytes / 4) words: at 169 tips,
// K 4, S 4 a block of 128 threads holds 64 patterns in 43,648 B, where
// onchip_walk's held 16 in 222,704 B, one block an SM.  pruning.cu takes
// the Strahler walk where its block keeps more than twice as many threads
// busy on an SM as onchip_plan's block does (the walk pays a pre-pass
// launch and, staged, block barriers): the blocks an SM holds by shared
// memory (and at most 32), times the block's threads, at most
// kThreadsPerSM (the kernel's launch bounds keep that many threads within
// the registers) and at most the launch's own lanes over the SMs
// (C * P * G / SMs).  Among its blocks it takes the first that keeps the
// most threads busy: whole operators before staged ones, 128 threads
// before 64 and 32.  A shape where onchip_plan's block already keeps
// half as many busy (small trees, or launches with few patterns) keeps
// onchip_plan's choice.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "onchip_walk.cuh"

namespace mb {

constexpr int kWalkStrahler = 4;        // Strahler walk, operators whole
constexpr int kWalkStrahlerStaged = 5;  // Strahler walk, operators staged
// the largest block: a barrier over 8 warps cost more than the warps
// gained in every shape measured (PERF.md)
constexpr int kStrahlerThreads = 128;
// the pre-pass keeps 4 words a step in shared memory, and a position and
// a depth share one word
constexpr int kStrahlerMaxTips = 2048;

// Slots of the walk: floor(log2 n_tips), at least 1.
__host__ __device__ inline int strahler_slots(int n_tips) {
  int L = 0;
  while ((2 << L) <= n_tips) ++L;
  return L > 0 ? L : 1;
}

// Bytes of one tip's mask at one pattern.
__host__ __device__ inline int strahler_mask_bytes(int S) {
  return S <= 8 ? 1 : 4;
}

// The row pitch of a division's masks [n_tips, pitch]: P rounded up to a
// whole word for byte masks.
__host__ __device__ inline int strahler_mask_pitch(int S, int P) {
  return S <= 8 ? (P + 3) / 4 * 4 : P;
}

// Shared-memory bytes of one block of BT threads, G lanes a pattern: the
// schedule (4 words a step), the operators, floor(log2 n_tips) slots of
// K*S rows of T | 1 words, and the tile's masks.
__host__ __device__ inline long long strahler_smem_bytes(int n_tips, int K,
                                                         int S, int G,
                                                         int BT,
                                                         bool staged) {
  const long long n_int = n_tips - 1;
  const long long T = BT / G;
  const long long step = 2LL * K * S * S;
  const long long words =
      4 * n_int + (staged ? 2 * step : n_int * step) +
      (long long)strahler_slots(n_tips) * K * S * (T | 1) +
      (n_tips * T * strahler_mask_bytes(S) + 3) / 4;
  return (4 * words + 15) / 16 * 16;
}

// ---------------------------------------------------------------- device

// The schedule of chain blockIdx.x (the header): thread 0 walks the steps
// twice on a shared-memory copy of lr, bottom up in the given order for
// each subtree's slots, internal nodes and first child, then top down for
// each step's position and depth.
__global__ void __launch_bounds__(32)
strahler_schedule_kernel(const int* __restrict__ lr,   // [C, n_int, 2]
                         int4* __restrict__ sched,     // [C, n_int]
                         int n_tips, int n_int) {
  extern __shared__ int sched_sh[];
  int* kids = sched_sh;          // [n_int, 2]
  int* up = kids + 2 * n_int;    // slots | right first << 6 | size << 7
  int* dn = up + n_int;          // position | depth << 16
  const long long c = blockIdx.x;
  lr += c * n_int * 2;
  sched += c * n_int;
  for (int e = threadIdx.x; e < 2 * n_int; e += blockDim.x) kids[e] = lr[e];
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int i = 0; i < n_int; ++i) {
    int need[2], size[2];
    for (int h = 0; h < 2; ++h) {
      const int ch = kids[2 * i + h];
      const int u = ch >= n_tips ? up[ch - n_tips] : 0;
      need[h] = u & 63;
      size[h] = u >> 7;
    }
    const int nd = need[0] == need[1] ? need[0] + 1
                                      : (need[0] > need[1] ? need[0] : need[1]);
    up[i] = nd | (need[1] > need[0]) << 6 | (size[0] + size[1] + 1) << 7;
  }
  dn[n_int - 1] = n_int - 1;
  for (int i = n_int - 1; i >= 0; --i) {
    const int e = dn[i] & 0xffff;
    const int d = dn[i] >> 16;
    const int u = up[i];
    const int f = (u >> 6) & 1;
    const int a = kids[2 * i + f];
    const int b = kids[2 * i + 1 - f];
    // the first child's subtree runs from the subtree's start, the second
    // ends just before this step, one deeper while the first child waits
    int db = d;
    if (a >= n_tips) {
      const int j = a - n_tips;
      dn[j] = (e - (u >> 7) + (up[j] >> 7)) | d << 16;
      db = d + 1;
    }
    if (b >= n_tips) dn[b - n_tips] = (e - 1) | db << 16;
    int code[2];
    for (int h = 0; h < 2; ++h) {
      const int ch = kids[2 * i + h];
      code[h] = ch < n_tips ? ch : -(dn[ch - n_tips] >> 16) - 1;
    }
    sched[e] = make_int4(i, code[0], code[1], d);
  }
}

// The tile's masks: rows [n_tips] of its T patterns (the ragged edge
// repeats the last pattern, or reads the row's last word).  Byte masks
// whose tile is whole words go as asynchronous 4-byte copies.
template <typename M>
__device__ __forceinline__ void copy_masks_async(M* dst, const M* masks,
                                                 int n_tips, int P, int pitch,
                                                 int p0, int T) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(M) == 1) {
    if (T % 4 == 0) {
      const int W = T / 4;
      for (int e = threadIdx.x; e < n_tips * W; e += blockDim.x) {
        const int r = e / W;
        const int w = e - r * W;
        const int b = p0 + 4 * w < pitch ? p0 + 4 * w : pitch - 4;
        cp_async4(base + 4u * e, reinterpret_cast<const float*>(
                                     masks + (long long)r * pitch + b));
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < n_tips * T; e += blockDim.x) {
    const int r = e / T;
    const int c = e - r * T;
    const int p = p0 + c < P ? p0 + c : P - 1;
    if constexpr (sizeof(M) == 4)
      cp_async4(base + 4u * e, reinterpret_cast<const float*>(
                                   masks + (long long)r * pitch + p));
    else
      dst[e] = masks[(long long)r * pitch + p];
  }
}

// A child's value at row (k, j): bit j of a tip's mask as 0.0f or 1.0f,
// or row (k, j) of an internal child's slot column.
template <bool TIP>
__device__ __forceinline__ float child_at(const float* col, uint32_t mask,
                                          int k, int j, int S, int RS) {
  if constexpr (TIP)
    return (mask >> j) & 1u ? 1.0f : 0.0f;
  else
    return col[(k * S + j) * RS];
}

// The read half of one step for this lane's entries ks = g + G*q, as
// onchip_walk.cuh:step_products (the same fmaf chain on the same values),
// with a tip child's column from its mask: x in registers and the max m
// over the pattern's K*S entries (floored at kTiny).
template <int S_T, bool LT, bool RT>
__device__ __forceinline__ float strahler_products(
    const float* cl, uint32_t ml, const float* cr, uint32_t mr,
    const float* opl, const float* opr, float (&x)[kMaxItems], int K,
    int S_rt, int G, int g, int RS) {
  const int S = S_T > 0 ? S_T : S_rt;
  const int KS = K * S;
  float m = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxItems; ++q) {
    const int ks = g + G * q;
    if (ks < KS) {
      const int k = ks / S;
      float wl = 0.f, wr = 0.f;
      if constexpr (S_T > 0) {
        float a[S_T], b[S_T];
        load_row<S_T>(a, opl + ks * S_T);
        load_row<S_T>(b, opr + ks * S_T);
#pragma unroll
        for (int j = 0; j < S_T; ++j) {
          wl = fmaf(a[j], child_at<LT>(cl, ml, k, j, S_T, RS), wl);
          wr = fmaf(b[j], child_at<RT>(cr, mr, k, j, S_T, RS), wr);
        }
      } else {
        const float* ol = opl + ks * S;
        const float* orr = opr + ks * S;
        for (int j = 0; j < S; ++j) {
          wl = fmaf(ol[j], child_at<LT>(cl, ml, k, j, S, RS), wl);
          wr = fmaf(orr[j], child_at<RT>(cr, mr, k, j, S, RS), wr);
        }
      }
      x[q] = wl * wr;
      m = fmaxf(m, x[q]);
    }
  }
  return fmaxf(group_max(m, G), kTiny);
}

// The walk of one block of BT threads: the chain's schedule sched [n_int]
// (strahler_schedule_kernel), operators op [n_int, 2, K, S, S], root
// [K, S, P] and ls [P]; the division's masks [n_tips, pitch]; the tile's
// first pattern p0 and the lanes G of a pattern.  Thread t is lane
// g = t % G of pattern p0 + t / G.  Requires K*S <= G * kMaxItems; smem
// holds strahler_smem_bytes(n_tips, K, S, G, BT, staged) bytes.
template <int S_T, typename M>
__device__ void strahler_walk(const int4* __restrict__ sched,
                              const float* __restrict__ op,
                              const M* __restrict__ masks,
                              float* __restrict__ root,
                              float* __restrict__ ls, int n_tips, int n_int,
                              int K, int S_rt, int P, int p0, int G,
                              bool staged, float* smem) {
  const int S = S_T > 0 ? S_T : S_rt;
  const int BT = blockDim.x;
  const int t = threadIdx.x;
  const int T = BT / G;
  const int RS = T | 1;
  const int pl = t / G;
  const int g = t - pl * G;
  const int KS = K * S;
  const int step = 2 * K * S * S;
  int4* sch = reinterpret_cast<int4*>(smem);
  float* ops = smem + 4 * n_int;
  float* part = ops + (long long)(staged ? 2 : n_int) * step;
  M* msk = reinterpret_cast<M*>(part + (long long)strahler_slots(n_tips) *
                                           KS * RS);

  copy_async(smem, reinterpret_cast<const float*>(sched), 4 * n_int);
  if (staged)
    copy_async(ops, op + (long long)__ldg(&sched[0].x) * step, step);
  else
    copy_async(ops, op, n_int * step);
  copy_masks_async(msk, masks, n_tips, P, strahler_mask_pitch(S, P), p0, T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int p = p0 + pl;
  const bool valid = p < P;
  const M* msk_p = msk + pl;            // tip r at r * T
  float* part_p = part + pl;            // slot v, row r at (v*KS + r) * RS
  // step q's entry is read a step ahead, and log(m) of step q is added
  // during step q + 1, so neither waits in line
  int4 cur = sch[0];
  float lsum = 0.f, m = 1.f;
  for (int q = 0; q < n_int; ++q) {
    const int4 e = cur;
    const float* opi = ops + (long long)e.x * step;
    if (staged) {
      if (q + 1 < n_int)
        copy_async(ops + ((q + 1) & 1) * step,
                   op + (long long)sch[q + 1].x * step, step);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      opi = ops + (q & 1) * step;
    }
    if (q + 1 < n_int) cur = sch[q + 1];
    lsum += logf(m);
    const bool lt = e.y >= 0, rt = e.z >= 0;
    const float* cl = part_p + (long long)(lt ? 0 : -e.y - 1) * KS * RS;
    const float* cr = part_p + (long long)(rt ? 0 : -e.z - 1) * KS * RS;
    const uint32_t ml = lt ? (uint32_t)msk_p[(long long)e.y * T] : 0u;
    const uint32_t mr = rt ? (uint32_t)msk_p[(long long)e.z * T] : 0u;
    const float* opr = opi + step / 2;
    float x[kMaxItems];
    if (lt && rt)
      m = strahler_products<S_T, true, true>(cl, ml, cr, mr, opi, opr, x, K,
                                             S, G, g, RS);
    else if (lt)
      m = strahler_products<S_T, true, false>(cl, ml, cr, mr, opi, opr, x, K,
                                              S, G, g, RS);
    else if (rt)
      m = strahler_products<S_T, false, true>(cl, ml, cr, mr, opi, opr, x, K,
                                              S, G, g, RS);
    else
      m = strahler_products<S_T, false, false>(cl, ml, cr, mr, opi, opr, x,
                                               K, S, G, g, RS);
    float* dst;
    long long drs;
    if (q == n_int - 1) {
      dst = valid ? root + p : nullptr;
      drs = P;
    } else {
      dst = part_p + (long long)e.w * KS * RS;
      drs = RS;
    }
    __syncwarp();     // every child read before dst (maybe a child) is written
    step_store(x, m, dst, drs, KS, G, g);
    __syncwarp();     // dst written before the next step reads it
    if (staged) __syncthreads();
  }
  lsum += logf(m);
  if (valid && g == 0) ls[p] = lsum;
}

// ------------------------------------------------------------------ host

struct SmLimits {
  int smem;       // shared memory of one SM, bytes
  int reserved;   // shared memory the system keeps a block, bytes
};

// The device's per-SM limits, read once per device and process.
inline cudaError_t sm_limits(int device, SmLimits* out) {
  constexpr int kMaxDevices = 64;
  static SmLimits cache[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && cache[device].smem > 0) {
    *out = cache[device];
    return cudaSuccess;
  }
  SmLimits sm;
  cudaError_t err = cudaDeviceGetAttribute(
      &sm.smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sm.reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices) cache[device] = sm;
  *out = sm;
  return cudaSuccess;
}

// Threads a block of BT threads and `bytes` of shared memory keeps busy
// on an SM (the header), times the SMs: at most kThreadsPerSM an SM, and
// at most `lanes` (C * P * G) over all of them.
inline long long busy_threads(long long bytes, int BT, long long lanes,
                              const SmLimits& sm, int sms) {
  long long blocks = sm.smem / (bytes + sm.reserved);
  if (blocks > 32) blocks = 32;
  long long per_sm = blocks * BT;
  if (per_sm > kThreadsPerSM) per_sm = kThreadsPerSM;
  return per_sm * sms < lanes ? per_sm * sms : lanes;
}

// The Strahler walk's plan for one pruning.cu launch whose tips are
// packed, given onchip_plan's block (threads `BT0`, `bytes0`, lanes G0):
// true, with the walk, threads, bytes, patterns and lanes of its block,
// where that block keeps more than twice as many threads busy as
// onchip_plan's.
inline bool strahler_plan(int C, int n_tips, int K, int S, int P,
                          const DeviceLimits& lim, const SmLimits& sm,
                          int BT0, int bytes0, int G0, int* walk, int* BT,
                          int* bytes, int* T, int* G) {
  if (n_tips < 3 || n_tips > kStrahlerMaxTips || S > 32) return false;
  const long long lanes = (long long)C * P * G0;
  // more than twice onchip_plan's: the walk adds its pre-pass (a launch
  // and a serial pass over the steps) and, staged, two barriers a step
  long long best = 2 * busy_threads(bytes0, BT0, lanes, sm, lim.sms);
  bool found = false;
  for (int staged = 0; staged < 2; ++staged) {
    for (int cand : {128, 64, 32}) {
      if (cand < G0) continue;
      const long long b =
          strahler_smem_bytes(n_tips, K, S, G0, cand, staged != 0);
      if (b > lim.smem) continue;
      const long long busy = busy_threads(b, cand, lanes, sm, lim.sms);
      if (busy > best) {
        best = busy;
        found = true;
        *walk = staged ? kWalkStrahlerStaged : kWalkStrahler;
        *BT = cand;
        *bytes = (int)b;
        *T = cand / G0;
        *G = G0;
      }
    }
  }
  return found;
}

}  // namespace mb
