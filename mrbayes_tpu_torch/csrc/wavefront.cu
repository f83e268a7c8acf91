// Level-batched (wavefront) Felsenstein down-pass for every chain: the CUDA
// counterpart of the Pallas kernel mrbayes_tpu/ops/pruning_pallas.py:
// _kernel_wavefront (:478, launched by _pallas_batched_wavefront :552,
// wired by PruningPallasWavefront :623, its schedule built in __call__
// :635-689).
//
// It computes what pruning.cu computes, from the same operands (lr
// [C, n_int, 2] child slots, pstep [C, n_int, 2, K, S, S], tips
// [n_tips, S, P]), but the internal nodes of each chain's tree run in
// rows: the nodes of one root distance, up to W of them a row, deepest
// first.  Every node of a row depends only on earlier rows, so the
// dependent chain is the row count (about the tree's height, plus the rows
// split at W) instead of n_int steps.
//
// What bounds it on an H100: latency.  The work is tiny (cynmix's largest
// gene at C = 8, n_tips 32, K 4, S 4, P 537: 8.7 MFLOP and 1.0 MB of
// compulsory traffic, each far under a microsecond); the time is the
// block start (the copies and the schedule), then the chain of rows, each
// a step of the on-chip walk and a block barrier, and the launch.  The
// first design ran one thread per (row slot, pattern) with the partials in
// a global scratch (an L2 round trip a row) and its schedule as a chain of
// PyTorch ops on the host (about 1 ms a call): slower than pruning.cu.
//
// Design:
//   * the schedule is built in the kernel, by each block at its start
//     from its chain's lr alone, while cp.async brings the chain's
//     operators and the tile's tips into shared memory: each step's
//     parent step, scattered from lr; each step's depth by pointer jumping
//     (log2 n_int rounds, the root, the last step, at 0); the count of
//     each depth by shared-memory atomics; the rows, runs of one depth
//     split at W, deepest first, placed by warp scans; and a stable
//     counting sort by decreasing depth.  On postorder_internal's order
//     (sorted by decreasing depth already) these are exactly the JAX rows
//     (pruning_pallas.py:642-660); any children-before-parents order gives
//     valid rows.  ops/wavefront_cuda.py:row_schedule is the twin.
//   * the partials live in shared-memory slots, one a cherry (a step whose
//     children are both tips, at most n_tips / 2 of them, numbered by a
//     warp scan in step order); every other step writes the slot of its
//     first internal child, which only that step reads: the same pointer
//     jumping finds each step's cherry down its first-child chain.  So
//     the map is parallel (the live-slot map of onchip_walk.cuh, taken row
//     by row, is a serial chain of dependent shared-memory updates at
//     every block's start), two steps of a row never share a slot,
//     a step's reads and its overwrite of its child are ordered by its own
//     warp barrier, and a row needs one block barrier, after its writes
//     (ops/wavefront_cuda.py:chain_slot_map is the twin).  Each position
//     of the row order gets one instruction word (the child codes, the
//     output slot, the step), read a row ahead.
//   * a block is one chain and a tile of T patterns: NG <= W row-slot
//     groups of T patterns x G lanes (whole warps), a pattern's K*S
//     entries spread over its G lanes; group w runs the row's steps w,
//     w + NG, ... one after another.  Each step is onchip_walk.cuh's
//     arithmetic (step_products, step_store), and ls adds each step's
//     log(m) in step order, so root partials and log-scales equal
//     pruning.cu's bit for bit.
//   * the operators: the chain's whole [n_int, 2, K, S, S] when they fit
//     beside the partials; else each row's copied a row ahead into one of
//     two buffers.  S in {2, 3, 4, 8, 20} is a template parameter (any
//     other S runs with loops); a launch instantiates one.
//   * the plan (mb_wavefront_plan) tries every G, NG and group width: the
//     fewest waves of the blocks the device holds at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), then the most lanes
//     on a row's steps (G * NG), then at most 4 entries a lane, then the
//     most groups.  A block of W groups, the whole row width, would leave
//     most warps idle (a 32-tip tree's rows average 2-3 steps) and cost
//     resident blocks.  A shape whose slots fit in no block raises in the
//     wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onchip_walk.cuh"

namespace {

using mb::Child;
using mb::kFullWarp;
using mb::kMaxItems;

constexpr int kMaxW = 16;          // row width
constexpr int kMaxThreads = 512;   // threads a block

// Partial slots a block holds: one a cherry (a step whose children are
// both tips), at most n_tips / 2.
__host__ __device__ inline int wavefront_slots(int n_tips) {
  return n_tips / 2;
}

// Shared-memory bytes of one block (layout in wavefront_kernel): the
// whole chain's operators or two rows of them, the partials, the tips,
// log(m) [n_int, T], then the schedule (17 n_int + 1 words).
inline long long wavefront_smem_bytes(int n_tips, int K, int S, int W,
                                      int T, bool staged) {
  const long long n_int = n_tips - 1;
  const long long LS = wavefront_slots(n_tips);
  const long long step = 2LL * K * S * S;
  const long long floats = (staged ? 2LL * W * step : n_int * step) +
                           LS * K * S * (T | 1) +
                           (long long)n_tips * S * T + n_int * T;
  return 4 * ((floats + 3) / 4 * 4 + 17 * n_int + 1);
}

// An inclusive scan of v over warp 0's lanes.
__device__ __forceinline__ int warp_scan(int v) {
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFullWarp, v, off);
    if ((int)threadIdx.x >= off) v += u;
  }
  return v;
}

// The block's schedule and slot map from its chain's child slots (codes
// [n_int, 2] = lr).  On return rows[r] = (first position, steps) of row
// r, misc[0] the row count, and inst[q] = (left code, right code, output
// slot or -1 at the root, step) for the step at position q (codes c >= 0:
// tip c; c < 0: the partial in slot -c - 1).  Every thread calls it; it
// ends with a barrier.
__device__ void build_rows(const int* codes, int4* inst, int* d0, int* d1,
                           int* a0, int* a1, int* k0, int* k1, int* cnt,
                           int* start, int* rank, int2* rows,
                           int* misc, int n_tips, int n_int, int W) {
  const int t = threadIdx.x;
  const int BT = blockDim.x;
  // each step's parent step (the root, the last step, its own), a
  // distance of 1 to it, and its first internal child (a cherry: its own)
  for (int i = t; i < n_int; i += BT) {
    cnt[i] = 0;
    d0[i] = i == n_int - 1 ? 0 : 1;
    if (i == n_int - 1) a0[i] = i;
    const int c0 = codes[2 * i], c1 = codes[2 * i + 1];
    if (c0 >= n_tips) a0[c0 - n_tips] = i;
    if (c1 >= n_tips) a0[c1 - n_tips] = i;
    k0[i] = c0 >= n_tips ? c0 - n_tips : c1 >= n_tips ? c1 - n_tips : i;
  }
  __syncthreads();
  // pointer jumping: after k rounds A holds the 2^k-th ancestor (D the
  // distance to it) and K the 2^k-th step down the first-child chain;
  // then D is the depth and K the chain's cherry
  int *D = d0, *A = a0, *Kc = k0, *D2 = d1, *A2 = a1, *K2 = k1;
  for (int span = 1; span < n_int; span <<= 1) {
    for (int i = t; i < n_int; i += BT) {
      const int a = A[i];
      D2[i] = D[i] + D[a];
      A2[i] = A[a];
      K2[i] = Kc[Kc[i]];
    }
    __syncthreads();
    int* x = D;
    D = D2;
    D2 = x;
    x = A;
    A = A2;
    A2 = x;
    x = Kc;
    Kc = K2;
    K2 = x;
  }
  for (int i = t; i < n_int; i += BT) atomicAdd(&cnt[D[i]], 1);
  if (t < 32) {
    // the cherries' slots: their ranks in step order
    int base = 0;
    for (int i0 = 0; i0 < n_int; i0 += 32) {
      const int i = i0 + t;
      const int f = i < n_int && Kc[i] == i;
      const int inc = warp_scan(f);
      if (f) rank[i] = base + inc - 1;
      base += __shfl_sync(kFullWarp, inc, 31);
    }
  }
  __syncthreads();
  if (t < 32) {
    // rows: the runs of one depth, deepest first, split at W; lane l
    // takes depth maxd - base - l, and warp scans place its runs
    int maxd = 0;
    for (int i = t; i < n_int; i += 32) maxd = D[i] > maxd ? D[i] : maxd;
    for (int off = 16; off > 0; off >>= 1) {
      const int o = __shfl_xor_sync(kFullWarp, maxd, off);
      maxd = o > maxd ? o : maxd;
    }
    int q = 0, r = 0;
    for (int base = 0; base <= maxd; base += 32) {
      const int d = maxd - base - t;
      const int c = d >= 0 ? cnt[d] : 0;
      const int nr = (c + W - 1) / W;
      const int cq = warp_scan(c), cr = warp_scan(nr);
      if (d >= 0) {
        const int q0 = q + cq - c;
        start[d] = q0;
        for (int k = 0; k < nr; ++k)
          rows[r + cr - nr + k] =
              make_int2(q0 + k * W, c - k * W < W ? c - k * W : W);
      }
      q += __shfl_sync(kFullWarp, cq, 31);
      r += __shfl_sync(kFullWarp, cr, 31);
    }
    if (t == 0) misc[0] = r;
  }
  __syncthreads();
  // a stable counting sort: step i after the earlier steps of its depth,
  // and its instruction word; a step writes its chain's slot, which holds
  // its first internal child until the step has read it
  for (int i = t; i < n_int; i += BT) {
    const int d = D[i];
    int within = 0;
    for (int j = 0; j < i; ++j) within += D[j] == d;
    int cd[2];
    for (int h = 0; h < 2; ++h) {
      const int c = codes[2 * i + h];
      cd[h] = c >= n_tips ? -rank[Kc[c - n_tips]] - 1 : c;
    }
    inst[start[d] + within] =
        make_int4(cd[0], cd[1], i == n_int - 1 ? -1 : rank[Kc[i]], i);
  }
  __syncthreads();
}

// Block (x, c): chain c, patterns x*T .. x*T + T - 1, NG row-slot groups
// of T*G threads (whole warps).  Thread t is lane g = t % G of pattern
// t / G % T of group t / (T*G); group w runs the row's steps w, w + NG, ...
// one after another.
template <int S_T>
__global__ void __launch_bounds__(kMaxThreads)
wavefront_kernel(const int* __restrict__ lr,        // [C, n_int, 2]
                 const float* __restrict__ pstep,   // [C, n_int, 2, K, S, S]
                 const float* __restrict__ tips,    // [n_tips, S, P]
                 float* __restrict__ root,          // [C, K, S, P]
                 float* __restrict__ ls,            // [C, P]
                 int n_tips, int n_int, int K, int S_rt, int P, int W,
                 int NG, int T, int G, int staged) {
  extern __shared__ float4 smem4[];
  const int S = S_T > 0 ? S_T : S_rt;
  const int c = blockIdx.y;
  const int p0 = blockIdx.x * T;
  const int BT = blockDim.x;
  const int t = threadIdx.x;
  const int RT = T * G;
  const int w = t / RT;
  const int pl = (t - w * RT) / G;
  const int g = t - w * RT - pl * G;
  const int KS = K * S;
  const int step = 2 * K * S * S;
  const int LS = wavefront_slots(n_tips);
  const int RS = T | 1;
  const int* lr_c = lr + (long long)c * n_int * 2;
  const float* op = pstep + (long long)c * n_int * step;
  float* ops = reinterpret_cast<float*>(smem4);
  float* part = ops + (long long)(staged ? 2 * W : n_int) * step;
  float* tip_s = part + (long long)LS * KS * RS;
  float* lm = tip_s + (long long)n_tips * S * T;
  const long long floats = (lm + (long long)n_int * T) - ops;
  int4* inst = reinterpret_cast<int4*>(ops + (floats + 3) / 4 * 4);
  int2* rows = reinterpret_cast<int2*>(inst + n_int);
  int* codes = reinterpret_cast<int*>(rows + n_int);
  int* d0 = codes + 2 * n_int;
  int* d1 = d0 + n_int;
  int* a0 = d1 + n_int;
  int* a1 = a0 + n_int;
  int* k0 = a1 + n_int;
  int* k1 = k0 + n_int;
  int* cnt = k1 + n_int;
  int* start = cnt + n_int;
  int* rank = start + n_int;
  int* misc = rank + n_int;

  for (int e = t; e < 2 * n_int; e += BT) codes[e] = lr_c[e];
  if (!staged) mb::copy_async(ops, op, n_int * step);
  mb::copy_tips_async(tip_s, tips, n_tips * S, P, p0, T);
  mb::cp_async_commit();
  __syncthreads();
  build_rows(codes, inst, d0, d1, a0, a1, k0, k1, cnt, start, rank, rows,
             misc, n_tips, n_int, W);
  const int nrows = misc[0];
  if (staged) {
    const int2 r0 = rows[0];
    for (int k = 0; k < r0.y; ++k)
      mb::copy_async(ops + (long long)k * step,
                     op + (long long)inst[r0.x + k].w * step, step);
    mb::cp_async_commit();
  }
  mb::cp_async_wait<0>();
  __syncthreads();

  const int p = p0 + pl;
  const bool valid = p < P;
  const float* tip_p = tip_s + pl;      // row r at r * T
  float* part_p = part + pl;            // slot v, row r at (v*KS + r) * RS
  float* root_p = root + (long long)c * KS * P + p;
  // the group's first step of this row and of the next, read a row ahead
  int2 rw = rows[0];
  int4 cur = w < rw.y ? inst[rw.x + w] : make_int4(0, 0, 0, 0);
  for (int r = 0; r < nrows; ++r) {
    const int2 rn = r + 1 < nrows ? rows[r + 1] : make_int2(0, 0);
    const int4 nxt = w < rn.y ? inst[rn.x + w] : make_int4(0, 0, 0, 0);
    const float* buf = ops;
    if (staged) {
      float* nb = ops + (long long)((r + 1) & 1) * W * step;
      for (int k = 0; k < rn.y; ++k)
        mb::copy_async(nb + (long long)k * step,
                       op + (long long)inst[rn.x + k].w * step, step);
      mb::cp_async_commit();
      mb::cp_async_wait<1>();
      __syncthreads();
      buf = ops + (long long)(r & 1) * W * step;
    }
    // a group is whole warps, so the loop is uniform in each warp; a
    // step's output slot is read in its row by that step alone
    for (int e = w; e < rw.y; e += NG) {
      const int4 in = e == w ? cur : inst[rw.x + e];
      const float* opi = buf + (long long)(staged ? e : in.w) * step;
      const int cd[2] = {in.x, in.y};
      Child ch[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ch[h] = cd[h] >= 0 ? Child{tip_p + (long long)cd[h] * S * T, 0, T}
                           : Child{part_p + (long long)(-cd[h] - 1) * KS * RS,
                                   S * RS, RS};
      float x[kMaxItems];
      const float m = mb::step_products<S_T>(ch[0], ch[1], opi,
                                             opi + step / 2, x, K, S, G, g);
      __syncwarp();   // the step's reads before it overwrites its child
      float* dst;
      long long drs;
      if (in.z < 0) {
        dst = valid ? root_p : nullptr;
        drs = P;
      } else {
        dst = part_p + (long long)in.z * KS * RS;
        drs = RS;
      }
      mb::step_store(x, m, dst, drs, KS, G, g);
      if (g == 0) lm[(long long)in.w * T + pl] = logf(m);
    }
    __syncthreads();   // the row's writes before the next row's reads
    rw = rn;
    cur = nxt;
  }
  // ls in step order, as pruning.cu sums it
  if (t < T && p0 + t < P) {
    float s = 0.f;
    for (int i = 0; i < n_int; ++i) s += lm[(long long)i * T + t];
    ls[(long long)c * P + p0 + t] = s;
  }
}

// Resident blocks of wavefront_kernel<S_T> an SM holds.
template <int S_T>
cudaError_t per_sm(int threads, long long bytes, int* n) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, wavefront_kernel<S_T>, threads, (size_t)bytes);
}

// The plan for S_T (see the header): out[0] the walk (0 whole, 1 staged),
// out[1] the threads of a block, out[2] its shared-memory bytes, out[3]
// its patterns T, out[4] the lanes of a pattern G, out[5] its row-slot
// groups NG.
template <int S_T>
cudaError_t plan_for(int C, int n_tips, int K, int S, int P, int W,
                     int device, const mb::DeviceLimits& lim, int* out) {
  static bool done[64] = {};
  cudaError_t err = mb::allow_smem(wavefront_kernel<S_T>, device,
                                   lim.smem, done, lim);
  if (err != cudaSuccess) return err;
  const int KS = K * S;
  const int most = mb::pow2_at_least(KS) < 32 ? mb::pow2_at_least(KS) : 32;
  const int least = mb::pow2_at_least((KS + kMaxItems - 1) / kMaxItems);
  // the score: fewest waves, then most lanes for a row's steps (G * NG),
  // then at most 4 entries a lane, then most groups, then fewest threads
  bool found = false;
  long long best[5] = {};
  for (int G = most; G >= least; G >>= 1) {
    for (int NG = W; NG >= 1; --NG) {
      for (int RT = 32; NG * RT <= kMaxThreads; RT *= 2) {
        const int T = RT / G;
        bool staged = false;
        long long bytes = wavefront_smem_bytes(n_tips, K, S, W, T, false);
        if (bytes > lim.smem) {
          staged = true;
          bytes = wavefront_smem_bytes(n_tips, K, S, W, T, true);
        }
        if (bytes > lim.smem) continue;
        int n = 0;
        err = per_sm<S_T>(NG * RT, bytes, &n);
        if (err != cudaSuccess) return err;
        if (n < 1) continue;
        const long long blocks = (long long)C * ((P + T - 1) / T);
        const long long slots = (long long)n * lim.sms;
        const long long score[5] = {-(blocks + slots - 1) / slots,
                                    (long long)G * NG,
                                    (KS + G - 1) / G <= 4, NG, -RT};
        bool better = !found;
        for (int k = 0; k < 5 && found; ++k) {
          if (score[k] != best[k]) {
            better = score[k] > best[k];
            break;
          }
        }
        if (better) {
          found = true;
          for (int k = 0; k < 5; ++k) best[k] = score[k];
          out[0] = staged ? mb::kWalkStaged : mb::kWalkWhole;
          out[1] = NG * RT;
          out[2] = (int)bytes;
          out[3] = T;
          out[4] = G;
          out[5] = NG;
        }
      }
    }
  }
  return found ? cudaSuccess : cudaErrorInvalidValue;
}

template <int S_T>
cudaError_t launch(const int* a, const float* b, const float* tp, float* r,
                   float* l, int C, int n_tips, int n_int, int K, int S,
                   int P, int W, int walk, int threads, int bytes, int T,
                   int G, int NG, int device, cudaStream_t st) {
  static bool done[64] = {};
  mb::DeviceLimits lim;
  cudaError_t err = mb::device_limits(device, &lim);
  if (err != cudaSuccess) return err;
  err = mb::allow_smem(wavefront_kernel<S_T>, device, bytes, done, lim);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + T - 1) / T, C);
  wavefront_kernel<S_T><<<grid, threads, bytes, st>>>(
      a, b, tp, r, l, n_tips, n_int, K, S, P, W, NG, T, G,
      walk == mb::kWalkStaged);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan for one launch (see the header): out[0] the walk (0 whole, 1
// staged), out[1] the threads of a block, out[2] its dynamic shared memory
// in bytes, out[3] its patterns, out[4] the lanes of a pattern, out[5]
// its row-slot groups.  Returns a
// CUDA error code (cudaErrorInvalidValue: no block holds the shape's
// slots, or W is not in [1, 16]).
int mb_wavefront_plan(int C, int n_tips, int K, int S, int P, int W,
                      int device, int* out) {
  if (W < 1 || W > kMaxW || n_tips < 2) return (int)cudaErrorInvalidValue;
  mb::DeviceLimits lim;
  cudaError_t err = mb::device_limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  switch (mb::onchip_templated(S) ? S : 0) {
    case 2: err = plan_for<2>(C, n_tips, K, S, P, W, device, lim, out); break;
    case 3: err = plan_for<3>(C, n_tips, K, S, P, W, device, lim, out); break;
    case 4: err = plan_for<4>(C, n_tips, K, S, P, W, device, lim, out); break;
    case 8: err = plan_for<8>(C, n_tips, K, S, P, W, device, lim, out); break;
    case 20:
      err = plan_for<20>(C, n_tips, K, S, P, W, device, lim, out);
      break;
    default:
      err = plan_for<0>(C, n_tips, K, S, P, W, device, lim, out);
      break;
  }
  return (int)err;
}

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device` as
// mb_wavefront_plan chose: its walk, threads, shared-memory bytes,
// patterns a block T, lanes a pattern G and row-slot groups NG.  Returns the
// cudaGetLastError() code after the launch (0 = success); the kernel
// itself runs asynchronously.
int mb_wavefront_down(const void* lr, const void* pstep, const void* tips,
                      void* root, void* ls, int C, int n_tips, int n_int,
                      int K, int S, int P, int W, int walk, int threads,
                      int bytes, int T, int G, int NG, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  const int* a = (const int*)lr;
  const float* b = (const float*)pstep;
  const float* tp = (const float*)tips;
  float* r = (float*)root;
  float* l = (float*)ls;
  cudaStream_t st = (cudaStream_t)stream;
#define MB_WAVEFRONT_LAUNCH(S_T)                                            \
  launch<S_T>(a, b, tp, r, l, C, n_tips, n_int, K, S, P, W, walk, threads, \
              bytes, T, G, NG, device, st)
  switch (mb::onchip_templated(S) ? S : 0) {
    case 2: err = MB_WAVEFRONT_LAUNCH(2); break;
    case 3: err = MB_WAVEFRONT_LAUNCH(3); break;
    case 4: err = MB_WAVEFRONT_LAUNCH(4); break;
    case 8: err = MB_WAVEFRONT_LAUNCH(8); break;
    case 20: err = MB_WAVEFRONT_LAUNCH(20); break;
    default: err = MB_WAVEFRONT_LAUNCH(0); break;
  }
#undef MB_WAVEFRONT_LAUNCH
  return (int)err;
}

const char* mb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
