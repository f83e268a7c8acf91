// One block's Felsenstein down-pass with the partials in shared memory: the
// walk that the single-division kernel (pruning.cu) and the group kernels
// (stacked.cu, multiwalk.cu, through group_walk.cuh) launch; the wavefront
// kernel (wavefront.cu) runs its step (step_products, step_store) row by
// row.  It computes what mb::down_pass (down_pass.cuh)
// computes, with the same arithmetic in the same order, so the two agree
// bit for bit:
//     w_l[k,s] = sum_j op[i,0,k,s,j] * CL[l][k,j,p]   (likewise w_r)
//     x[k,s]   = w_l[k,s] * w_r[k,s]
//     m        = max(max_{k,s} x[k,s], 1e-30)
//     CL[n_tips+i][k,s,p] = x[k,s] / m,   ls[p] += log(m)
//
// A block is one chain and a tile of T patterns.  Each pattern has G
// lanes, neighbours in one warp; lane g computes the entries
// ks = k*S + s = g, g + G, ... (at most kMaxItems of them) and keeps them
// in registers, and the step's max is a shuffle over the G lanes.  G is a
// power of two up to 32 and up to K*S, as large as it takes to give every
// SM kThreadsPerSM threads over the launch's chains and patterns: a
// launch with little work spreads each pattern's step over many lanes, a
// launch with much work keeps more entries a lane and fewer shuffles.  A
// step is then a few dot products of length S per lane: one thread
// walking all K*S^2 products of a pattern alone (as down_pass.cuh does)
// leaves one warp per scheduler waiting on its own dependent
// instructions.  Every partial stays in shared memory; only the root
// column and ls reach global memory.
//
// Block start.  The block copies the chain's child slots lr [n_int, 2]
// into shared memory and starts asynchronous copies (cp.async) of the
// chain's operators [n_int, 2, K, S, S] (contiguous per chain) and of its
// tile's tips.  While they run, thread 0 builds the live-slot map:
// walking the steps in order, it frees the slot of each internal child
// and then takes the lowest free slot for the step.  The internal
// partials alive at once are completed subtrees whose parent has not run,
// disjoint and each of at least 2 tips, so the walk needs at most
// L = n_tips / 2 slots (ops/pruning_cuda.py:live_slot_map is its Python
// twin).
//
// Each step.  A lane reads the child columns of its categories from a
// slot of shared memory (rows (k, j), row stride T rounded up to an odd
// number, so a warp's rows fall in different banks) or from the tile's
// tips, and its operator rows (k, s) from shared memory (float4/float2
// loads where S allows).  S in {2, 3, 4, 8, 20} is a template parameter
// (unrolled dot products); any other S runs the same code with loops.
// It writes x/m once to the step's slot, which may be a child's.  Two
// __syncwarp() a step order the lanes' shared-memory accesses (a shuffle
// converges the lanes but orders no memory): one after the shuffle that
// gives m, so every lane of the pattern has read its children before any
// lane overwrites one, and one after the stores, so the next step reads
// what this one wrote.  The last step is the root: x/m goes to
// root[K, S, P].
//
// Operators.  When the whole chain's operators fit beside the partials
// they are copied once at the start, and the steps run with no block
// barrier, only the warp's ("whole" walk).  Otherwise a step's operators
// are copied a step ahead into one of two buffers ("staged" walk: two
// barriers a step).
//
// The size rule (plan below).  Shared memory a block of BT threads needs,
// in 4-byte words: the operators (n_int * 2*K*S^2 whole, 2 * 2*K*S^2
// staged), the partials L * K*S * RS (RS = T | 1, T = BT / G patterns),
// the tips n_tips * S * T, the slot map 3 * n_int and the free-slot
// bitmask ceil(L / 32).  A division takes the whole walk if that fits the
// device's per-block opt-in shared memory (227 KB on an H100), else the
// staged walk if that fits, else, and wherever K*S needs more than
// kMaxItems entries on each of 32 lanes, the global-scratch walk of
// down_pass.cuh; pruning.cu then takes the tiled walk of tiled_walk.cuh
// where its slots fit (mb_pruning_plan), and the group kernels keep the
// global-scratch walk for such a member.  The block is the largest of 256, 128 and 64 threads at
// which no division's walk is worse than at 32 and the grid (tiles x
// chains) still covers every SM; otherwise 32 threads.  Nothing is caught
// and retried: the launch takes what the rule says.
//
// What bounds it on an H100: latency, an on-chip one.  A step is a chain
// of shared-memory loads, S-long dot products, log2(G) shuffles, a
// division and a store, with no global round trip (the old walk wrote
// each partial to global scratch, read it back to normalise it and read
// it again in the parent step: about 3.8 us a step through L2; this walk
// about 0.8 us, PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "down_pass.cuh"

namespace mb {

constexpr int kWalkWhole = 0;    // operators of the whole chain on chip
constexpr int kWalkStaged = 1;   // operators staged a step ahead
constexpr int kWalkGlobal = 2;   // down_pass.cuh's global-scratch walk
constexpr int kWalkTiled = 3;    // tiled_walk.cuh (pruning.cu only)
constexpr int kMaxItems = 8;     // entries (k, s) a lane keeps
constexpr unsigned kFullWarp = 0xffffffffu;

// Threads a launch aims to keep on each SM: enough warps to hide one
// another's latency.
constexpr int kThreadsPerSM = 512;

__host__ __device__ inline int pow2_at_least(int n) {
  int v = 1;
  while (v < n) v <<= 1;
  return v;
}

// Lanes G of one pattern (a power of two, at most 32 and at most K*S
// rounded up): as many as it takes to give the SMs kThreadsPerSM threads
// each over `work` (chains x patterns of the launch), and at least as many
// as keep a lane's entries within kMaxItems (more than 32: no on-chip
// walk).
__host__ __device__ inline int ks_lanes(int K, int S, long long work,
                                        int sms) {
  const int most = pow2_at_least(K * S) < 32 ? pow2_at_least(K * S) : 32;
  const long long want = ((long long)sms * kThreadsPerSM + work - 1) / work;
  int G = pow2_at_least(want < most ? (int)want : most);
  const int least = pow2_at_least((K * S + kMaxItems - 1) / kMaxItems);
  return G > least ? G : least;
}

// True where the on-chip walk has a template for S.
__host__ __device__ inline bool onchip_templated(int S) {
  return S == 2 || S == 3 || S == 4 || S == 8 || S == 20;
}

// Shared-memory bytes of one block of BT threads, G lanes a pattern (the
// size rule in the header).
__host__ __device__ inline long long onchip_smem_bytes(int n_tips, int K,
                                                       int S, int G, int BT,
                                                       bool staged) {
  const long long n_int = n_tips - 1;
  const long long L = n_tips / 2;
  const long long T = BT / G;
  const long long step = 2LL * K * S * S;
  const long long words = (staged ? 2 * step : n_int * step) +
                          L * K * S * (T | 1) + n_tips * S * T + 3 * n_int +
                          (L + 31) / 32;
  return (4 * words + 15) / 16 * 16;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Every thread of the block issues its share of an asynchronous copy of n
// contiguous floats; 16-byte copies where both ends are 16-byte aligned.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  int e0 = 0;
  if (((base | (uint32_t)(uintptr_t)src) & 15u) == 0) {
    const int n4 = n >> 2;
    for (int e = threadIdx.x; e < n4; e += blockDim.x)
      cp_async16(base + 16u * e, src + 4 * e);
    e0 = 4 * n4;
  }
  for (int e = e0 + threadIdx.x; e < n; e += blockDim.x)
    cp_async4(base + 4u * e, src + e);
}

// The tile's tips: rows [n_tips * S] of its T patterns (the ragged edge
// repeats the last pattern).
__device__ __forceinline__ void copy_tips_async(float* dst, const float* tips,
                                                int rows, int P, int p0,
                                                int T) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  for (int e = threadIdx.x; e < rows * T; e += blockDim.x) {
    const int r = e / T;
    const int c = e - r * T;
    const int p = p0 + c < P ? p0 + c : P - 1;
    cp_async4(base + 4u * e, tips + (long long)r * P + p);
  }
}

// Thread 0's live-slot map over L slots.  codes [n_int, 2] holds the
// chain's child slots on entry and child codes on return (c >= 0: tip c;
// c < 0: the internal partial in shared slot -c - 1); oslot[i] is step
// i's slot.  With `spare` a step takes its slot before its children's are
// freed, so it never writes a slot it reads (L = n_tips / 2 + 1 then).
__device__ inline void build_slot_map(int* codes, int* oslot, unsigned* busy,
                                      int n_tips, int n_int, int L,
                                      bool spare = false) {
  const int W = (L + 31) / 32;
  for (int w = 0; w < W; ++w) busy[w] = 0u;
  auto take = [&](int i) {
    int w = 0;
    while (busy[w] == 0xffffffffu) ++w;
    const int s = 32 * w + __ffs(~busy[w]) - 1;
    busy[w] |= 1u << (s & 31);
    oslot[i] = s;
  };
  for (int i = 0; i < n_int; ++i) {
    if (spare) take(i);
    for (int h = 0; h < 2; ++h) {
      const int c = codes[2 * i + h];
      if (c >= n_tips) {
        const int s = oslot[c - n_tips];
        busy[s >> 5] &= ~(1u << (s & 31));
        codes[2 * i + h] = -s - 1;
      }
    }
    if (!spare) take(i);
  }
}

// S floats of an operator row from shared memory (16- or 8-byte loads
// where S allows: every row then starts on such a boundary).
template <int S>
__device__ __forceinline__ void load_row(float (&w)[S], const float* src) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else if constexpr (S % 2 == 0) {
#pragma unroll
    for (int q = 0; q < S / 2; ++q) {
      const float2 v = reinterpret_cast<const float2*>(src)[q];
      w[2 * q] = v.x;
      w[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) w[j] = src[j];
  }
}

// A child's column: row (k, j) at base + k * ks + j * js (ks = 0 for a
// tip, whose column is the same for every category).
struct Child {
  const float* base;
  int ks, js;
};

// The max over the G lanes of a pattern (neighbours in one warp, G a power
// of two).
__device__ __forceinline__ float group_max(float m, int G) {
  for (int off = 1; off < G; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(kFullWarp, m, off));
  return m;
}

// The read half of one step for this lane's entries ks = g + G*q: x in
// registers and the max m over the pattern's K*S entries (floored at
// kTiny), reading the children l, r and the step's operators opl, opr
// [K, S, S] (row ks at ks * S).  Every lane of the warp calls it (the
// shuffle takes the full warp; a block is a whole number of warps).
template <int S_T>
__device__ __forceinline__ float step_products(Child l, Child r,
                                               const float* opl,
                                               const float* opr,
                                               float (&x)[kMaxItems], int K,
                                               int S_rt, int G, int g) {
  const int S = S_T > 0 ? S_T : S_rt;
  const int KS = K * S;
  float m = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxItems; ++q) {
    const int ks = g + G * q;
    if (ks < KS) {
      const int k = ks / S;
      const float* cl = l.base + k * l.ks;
      const float* cr = r.base + k * r.ks;
      float wl = 0.f, wr = 0.f;
      if constexpr (S_T > 0) {
        float a[S_T], b[S_T];
        load_row<S_T>(a, opl + ks * S_T);
        load_row<S_T>(b, opr + ks * S_T);
#pragma unroll
        for (int j = 0; j < S_T; ++j) {
          wl = fmaf(a[j], cl[j * l.js], wl);
          wr = fmaf(b[j], cr[j * r.js], wr);
        }
      } else {
        const float* ol = opl + ks * S;
        const float* orr = opr + ks * S;
        for (int j = 0; j < S; ++j) {
          wl = fmaf(ol[j], cl[j * l.js], wl);
          wr = fmaf(orr[j], cr[j * r.js], wr);
        }
      }
      x[q] = wl * wr;
      m = fmaxf(m, x[q]);
    }
  }
  return fmaxf(group_max(m, G), kTiny);
}

// The write half: x/m to dst[ks * drs] (nullptr: no write).
__device__ __forceinline__ void step_store(const float (&x)[kMaxItems],
                                           float m, float* dst,
                                           long long drs, int KS, int G,
                                           int g) {
  if (dst == nullptr) return;
#pragma unroll
  for (int q = 0; q < kMaxItems; ++q) {
    const int ks = g + G * q;
    if (ks < KS) dst[ks * drs] = x[q] / m;
  }
}

// One step of a pattern's G lanes: the read half, then the write half to
// dst, which may be a child's slot.  Two __syncwarp() order the lanes'
// shared-memory accesses (a shuffle converges the lanes but orders no
// memory): one after the shuffle that gives m, so every lane of the
// pattern has read its children before any lane overwrites one, and one
// after the stores, so the next step reads what this one wrote.
template <int S_T>
__device__ __forceinline__ float onchip_step(Child l, Child r,
                                             const float* opl,
                                             const float* opr, float* dst,
                                             long long drs, int K, int S_rt,
                                             int G, int g) {
  float x[kMaxItems];
  const float m = step_products<S_T>(l, r, opl, opr, x, K, S_rt, G, g);
  __syncwarp();     // every child read before dst (maybe a child) is written
  step_store(x, m, dst, drs, K * (S_T > 0 ? S_T : S_rt), G, g);
  __syncwarp();     // dst written before the next step reads it
  return m;
}

// The walk of one block of BT threads: chain pointers (lr [n_int, 2], op
// [n_int, 2, K, S, S], root [K, S, P], ls [P]), the division's tips
// [n_tips, S, P], the tile's first pattern p0 and the lanes G of a
// pattern.  Thread t is lane g = t % G of pattern p0 + t / G.  S_T = 0
// takes S from S_rt.  Requires K*S <= G * kMaxItems; smem holds
// onchip_smem_bytes(n_tips, K, S, G, BT, staged) bytes.
template <int S_T>
__device__ void onchip_walk(const int* __restrict__ lr,
                            const float* __restrict__ op,
                            const float* __restrict__ tips,
                            float* __restrict__ root, float* __restrict__ ls,
                            int n_tips, int n_int, int K, int S_rt, int P,
                            int p0, int G, bool staged, float* smem) {
  const int S = S_T > 0 ? S_T : S_rt;
  const int BT = blockDim.x;
  const int t = threadIdx.x;
  const int T = BT / G;
  const int RS = T | 1;
  const int pl = t / G;
  const int g = t - pl * G;
  const int KS = K * S;
  const int step = 2 * K * S * S;
  const int L = n_tips / 2;
  float* ops = smem;
  float* part = ops + (long long)(staged ? 2 : n_int) * step;
  float* tip_s = part + (long long)L * KS * RS;
  int* codes = reinterpret_cast<int*>(tip_s + (long long)n_tips * S * T);
  int* oslot = codes + 2 * n_int;
  unsigned* busy = reinterpret_cast<unsigned*>(oslot + n_int);

  for (int e = t; e < 2 * n_int; e += BT) codes[e] = lr[e];
  copy_async(ops, op, (staged ? 1 : n_int) * step);
  copy_tips_async(tip_s, tips, n_tips * S, P, p0, T);
  cp_async_commit();
  __syncthreads();
  if (t == 0) build_slot_map(codes, oslot, busy, n_tips, n_int, L);
  cp_async_wait<0>();
  __syncthreads();

  const int p = p0 + pl;
  const bool valid = p < P;
  const float* tip_p = tip_s + pl;      // row r at r * T
  float* part_p = part + pl;            // slot v, row r at (v*KS + r) * RS
  // step i's codes and slot are read a step ahead, and log(m) of step i
  // is added during step i + 1, so neither waits in line
  int lc = codes[0], rc = codes[1], os = oslot[0];
  float lsum = 0.f, m = 1.f;
  for (int i = 0; i < n_int; ++i) {
    const float* opi = ops + (long long)i * step;
    if (staged) {
      if (i + 1 < n_int)
        copy_async(ops + ((i + 1) & 1) * step, op + (long long)(i + 1) * step,
                   step);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      opi = ops + (i & 1) * step;
    }
    const int cs[2] = {lc, rc};
    const int oi = os;
    if (i + 1 < n_int) {
      lc = codes[2 * i + 2];
      rc = codes[2 * i + 3];
      os = oslot[i + 1];
    }
    lsum += logf(m);
    Child ch[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ch[h] = cs[h] >= 0
                  ? Child{tip_p + (long long)cs[h] * S * T, 0, T}
                  : Child{part_p + (long long)(-cs[h] - 1) * KS * RS, S * RS,
                          RS};
    float* dst;
    long long drs;
    if (i == n_int - 1) {
      dst = valid ? root + p : nullptr;
      drs = P;
    } else {
      dst = part_p + (long long)oi * KS * RS;
      drs = RS;
    }
    m = onchip_step<S_T>(ch[0], ch[1], opi, opi + step / 2, dst, drs, K, S,
                         G, g);
    if (staged) __syncthreads();
  }
  lsum += logf(m);
  if (valid && g == 0) ls[p] = lsum;
}

// ------------------------------------------------------------------ host

struct DeviceLimits {
  int smem;   // opt-in shared memory a block may use, bytes
  int sms;    // streaming multiprocessors
};

// The device's limits, read once per device and process.
inline cudaError_t device_limits(int device, DeviceLimits* out) {
  constexpr int kMaxDevices = 64;
  static DeviceLimits cache[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && cache[device].sms > 0) {
    *out = cache[device];
    return cudaSuccess;
  }
  DeviceLimits lim;
  cudaError_t err = cudaDeviceGetAttribute(
      &lim.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&lim.sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices) cache[device] = lim;
  *out = lim;
  return cudaSuccess;
}

inline int walk_at(int n_tips, int K, int S, int G, int BT, int budget) {
  if (G > 32 || K * S > G * kMaxItems) return kWalkGlobal;
  if (onchip_smem_bytes(n_tips, K, S, G, BT, false) <= budget)
    return kWalkWhole;
  if (onchip_smem_bytes(n_tips, K, S, G, BT, true) <= budget)
    return kWalkStaged;
  return kWalkGlobal;
}

// The size rule for D divisions of one tree launched together (D = 1 for
// pruning.cu), for C chains: each division's lanes a pattern G[d] (1 on
// the global-scratch walk, one thread a pattern), walk walk[d] and
// patterns a block T[d] = BT / G[d]; the threads of a block *BT and its
// dynamic shared memory *bytes (the largest on-chip division's).
inline void onchip_plan(int D, const int* K, const int* S, const int* P,
                        int C, int n_tips, const DeviceLimits& lim, int* G,
                        int* walk, int* T, int* BT, int* bytes) {
  long long work = 0;
  for (int d = 0; d < D; ++d) work += (long long)C * P[d];
  for (int d = 0; d < D; ++d) G[d] = ks_lanes(K[d], S[d], work, lim.sms);
  *BT = 32;
  for (int cand : {256, 128, 64}) {
    long long tiles = 0;
    bool same = true;
    for (int d = 0; d < D; ++d) {
      same = same && walk_at(n_tips, K[d], S[d], G[d], cand, lim.smem) ==
                         walk_at(n_tips, K[d], S[d], G[d], 32, lim.smem);
      // a division past 32 lanes (G > cand) takes the global-scratch
      // walk: count it one pattern a tile
      const int Td = cand / G[d] > 0 ? cand / G[d] : 1;
      tiles += (P[d] + Td - 1) / Td;
    }
    if (same && tiles * C >= lim.sms) {
      *BT = cand;
      break;
    }
  }
  long long most = 0;
  for (int d = 0; d < D; ++d) {
    walk[d] = walk_at(n_tips, K[d], S[d], G[d], *BT, lim.smem);
    // the global-scratch walk runs one thread per pattern
    if (walk[d] == kWalkGlobal) G[d] = 1;
    T[d] = *BT / G[d];
    if (walk[d] != kWalkGlobal) {
      const long long b = onchip_smem_bytes(n_tips, K[d], S[d], G[d], *BT,
                                            walk[d] == kWalkStaged);
      most = b > most ? b : most;
    }
  }
  *bytes = (int)most;
}

// Let `kernel` take up to the device's opt-in shared memory (once per
// kernel and device; `done` is the kernel's own per-device flag array).
template <typename F>
inline cudaError_t allow_smem(F* kernel, int device, int bytes, bool* done,
                              const DeviceLimits& lim) {
  constexpr int kMaxDevices = 64;
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (device >= 0 && device < kMaxDevices && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lim.smem);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    done[device] = true;
  return err;
}

}  // namespace mb
