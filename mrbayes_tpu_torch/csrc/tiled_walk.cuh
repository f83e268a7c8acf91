// The tiled walk: pruning.cu's down-pass for a shape whose slots do not
// fit the on-chip walk (K*S beyond 32 lanes x kMaxItems, or a step's
// operators and the live slots beyond a block's shared memory), with the
// partials on chip all the same.  It computes what mb::down_pass
// (down_pass.cuh) computes, with the same arithmetic in the same order,
// so the two agree bit for bit:
//     w_l[k,s] = sum_j op[i,0,k,s,j] * CL[l][k,j,p]   (likewise w_r)
//     x[k,s]   = w_l[k,s] * w_r[k,s]
//     m        = max(max_{k,s} x[k,s], 1e-30)
//     CL[n_tips+i][k,s,p] = x[k,s] / m,   ls[p] += log(m)
//
// Grid and cluster.  One thread-block cluster of Q blocks is one chain and
// a tile of T patterns; block rank r of the cluster holds the categories
// k in [r*kq, min(K, (r+1)*kq)), kq = ceil(K/Q), with Q = ceil(K/kq) and
// kq = ceil(K/8) (the portable cluster size 8; K 8 is one category a
// block, K 16 two).  The grid is (Q, ceil(P/T), C).
//
// A block is NW consumer warps and one producer warp.  Each (step,
// category) chunk is a small matrix product: the two S x S operators
// times the children's S x T pattern columns.  A consumer thread owns a
// register tile of kTiledRows rows s = ls + LS*q and B neighbouring
// patterns: the LS = tiled_lanes(S) lanes of a warp that share a pattern
// run over s, the 32/LS others over patterns, the consumer warps over
// patterns (T = 32/LS * B * NW, B as large as leaves four consumer warps
// an SM: two a block where two blocks fit an SM, else four).  A term j
// reads kTiledRows floats of each operator (lanes on rows S floats apart:
// no bank conflict for odd S) and one B-wide vector of each child column
// (a row of T patterns, shared by the lanes of a pattern) for 2 *
// kTiledRows * B fused multiply-adds, each output's sum over j in order
// from j = 0, as down_pass.cuh runs it.
//
// The producer warp streams the chunks through a ring of two stages in
// shared memory, 16-byte cp.async copies that arrive on the stage's
// "full" mbarrier when they land; the consumers arrive on its "empty"
// mbarrier when they have read it, and the producer refills it with the
// chunk after next.  An operator [S, S] starts anywhere in pstep (S^2 is
// odd at S 61), so each is copied from the 16-byte boundary below it and
// read at that offset; a child that is a tip has the tile's columns
// [S, T] copied beside (16-byte copies where P is a multiple of 4 and
// the tile lies inside P, 4-byte ones otherwise).  Copies issued by the
// consumers themselves held up every step: 4-byte ones moved about a
// float a clock an SM, and even 16-byte ones stalled the issuing warps
// for a large part of the step.  The live partials stay in the
// block's shared memory: (n_tips/2 + 1) slots of kq * S * T floats,
// found through a live-slot map that takes a step's slot before freeing
// its children's (build_slot_map with spare), so a step never writes a
// slot it reads and stores x unnormalised as it goes.
//
// The rescale.  Each block takes its categories' max of x per pattern (a
// shuffle over the LS lanes of a pattern) into maxima[i & 1][T]; after
// one cluster barrier every block reads the Q blocks' maxima through
// distributed shared memory, so every block finds the same m (a max is
// exact in any order), divides its own entries by it (each thread the
// ones it wrote), and rank 0 adds log(m) to ls.  The maxima are
// double-buffered, so one cluster barrier a step suffices: a block
// writes step i+1's maxima only after the barrier of step i, which every
// block reaches only after reading step i-1's.  The producer warp takes
// part in those barriers too, arriving early (below).  The
// last step writes x/m to root[K, S, P]; a last cluster barrier keeps
// every block's shared memory alive until the others have read it.
//
// The size rule (tiled_plan).  Shared memory of a block, in 4-byte words,
// with R = 4 * ceil((S^2 + 3) / 4) (an operator and its offset):
//     2 * (2*R + 2*S*T)                the ring
//   + (floor(n_tips/2) + 1) * kq*S*T   the live slots
//   + 2*T + 8 + 3*(n_tips - 1) + ceil((floor(n_tips/2) + 1) / 32)
// (maxima, mbarriers, slot map) for T in {32, 16, 8, 4} (T >= 32/LS):
// the largest T at which two blocks fit an SM's opt-in shared memory
// and the grid gives at least kTiledBlocksPerSM blocks an SM, else the
// largest T that fits.  A shape that takes no on-chip walk and fits no T
// takes the global-scratch walk of down_pass.cuh: that is, where even
// T = 4 (or T = 32/LS where LS < 8) needs more than 227 KB, e.g. beyond
// 335 tips at S 61 and K <= 8.
//
// What bounds it on an H100: shared-memory loads (kTiledRows + 1 load
// wavefronts a warp a term against 2 * kTiledRows * B multiply-adds a
// thread), and the latency of a step (a cluster barrier, a round of
// distributed shared-memory reads and the divisions of the rescale).  At
// replicase under M10 (9 tips, P 239, K 8, S 61) the work is
// 2*C*n_int*2*K*S^2*P = 1.8 GFLOP at C 8 (27 us at 67 TFLOP/s fp32).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "onchip_walk.cuh"

namespace mb {

constexpr int kTiledRows = 4;          // rows s a consumer thread
constexpr int kTiledMaxWarps = 5;      // warps a block at most (4 + 1)
constexpr int kTiledMaxCluster = 8;    // the portable cluster size
constexpr int kTiledBlocksPerSM = 2;   // blocks an SM the rule aims for
constexpr int kTiledWarpsPerSM = 4;    // consumer warps an SM
constexpr int kTiledTiles[4] = {32, 16, 8, 4};
constexpr int kTiledConsumerBarrier = 1;   // named barrier of the consumers

// Lanes of a warp that share a pattern (power of two, at most 16): enough
// that kTiledRows rows each cover S.
__host__ __device__ inline int tiled_lanes(int S) {
  const int v = pow2_at_least((S + kTiledRows - 1) / kTiledRows);
  return v < 16 ? v : 16;
}

// Floats of shared memory an operator takes: S^2 and up to 3 before it
// (its offset from a 16-byte boundary), rounded up to 16 bytes.
__host__ __device__ inline int tiled_op_words(int S) {
  return (S * S + 3 + 3) / 4 * 4;
}

// Blocks of a cluster for K categories.
__host__ __device__ inline int tiled_cluster(int K) {
  const int per = (K + kTiledMaxCluster - 1) / kTiledMaxCluster;
  return (K + per - 1) / per;
}

// Patterns a consumer thread (B) for T patterns a block of which an SM
// holds per_sm: as many as leave kTiledWarpsPerSM consumer warps an SM,
// at least 1 and at most 4 (the operator loads of a term are shared by B
// patterns, the latency of a term hidden by the SM's other warps).
__host__ __device__ inline int tiled_width(int S, int T, int per_sm) {
  const int lp = 32 / tiled_lanes(S);
  const int nw = kTiledWarpsPerSM / per_sm > 0 ? kTiledWarpsPerSM / per_sm
                                               : 1;
  const int b = T / (lp * nw);
  return b < 1 ? 1 : (b > 4 ? 4 : b);
}

// A block's threads: its consumer warps and one producer warp.
__host__ __device__ inline int tiled_threads(int S, int T, int per_sm) {
  return 32 * (T / ((32 / tiled_lanes(S)) * tiled_width(S, T, per_sm)) + 1);
}

// Shared-memory bytes of one block (the size rule in the header).
__host__ __device__ inline long long tiled_smem_bytes(int n_tips, int K,
                                                      int S, int T, int Q) {
  const long long n_int = n_tips - 1;
  const long long L1 = n_tips / 2 + 1;
  const long long kq = (K + Q - 1) / Q;
  const long long stage = 2LL * tiled_op_words(S) + 2LL * S * T;
  const long long words = 2 * stage + L1 * kq * S * T + 2LL * T + 8 +
                          3 * n_int + (L1 + 31) / 32;
  return (4 * words + 15) / 16 * 16;
}

// ---------------------------------------------------------------- device

template <int B>
__device__ __forceinline__ void load_cols(float (&v)[B], const float* src) {
  if constexpr (B == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else if constexpr (B == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    v[0] = *src;
  }
}

template <int B>
__device__ __forceinline__ void store_cols(float* dst, const float (&v)[B]) {
  if constexpr (B == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (B == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    *dst = v[0];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void tiled_mbar_init(uint64_t* bar,
                                                unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrive (release: this thread's earlier shared-memory reads are done
// before whoever completes a wait on the phase)
__device__ __forceinline__ void tiled_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive once this thread's cp.async copies issued so far have landed
// (the barrier's count includes it: .noinc)
__device__ __forceinline__ void tiled_mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait (acquire) until the phase of parity `parity` has completed; a
// wait that never ends (a fault in the schedule) traps, so the launch
// fails instead of holding the device
__device__ __forceinline__ void tiled_mbar_wait(uint64_t* bar,
                                                unsigned parity) {
  unsigned done, spins = 0;
  do {
    if (++spins == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the two halves of a cluster barrier (cluster.sync() is both), for a
// whole warp
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void consumer_sync(int consumers) {
  asm volatile("bar.sync %0, %1;" ::"n"(kTiledConsumerBarrier),
               "r"(consumers)
               : "memory");
}

// The offset in floats of `src` from the 16-byte boundary below it.
__device__ __forceinline__ int op_offset(const float* src) {
  return (int)(((uintptr_t)src >> 2) & 3);
}

// The producer warp's copies of one chunk into `stage` (lane of 32): each
// operator opl, opr [S, S] (contiguous) with 16-byte copies of the blocks
// that hold it, from the boundary below it, into R = tiled_op_words(S)
// floats (the operator then starts op_offset(src) floats in), and the
// tile's columns [S, T] of each child (code cl, cr: a tip where >= 0)
// that is a tip (the ragged edge repeats the last pattern).
__device__ __forceinline__ void tiled_issue(float* stage,
                                            const float* __restrict__ opl,
                                            const float* __restrict__ opr,
                                            const float* __restrict__ tips,
                                            int cl, int cr, int S, int T,
                                            int P, int p0, int lane) {
  const int R = tiled_op_words(S);
  const uint32_t base = smem_u32(stage);
  const float* al = opl - op_offset(opl);
  const float* ar = opr - op_offset(opr);
  const int nl = (op_offset(opl) + S * S + 3) / 4;
  const int nr = (op_offset(opr) + S * S + 3) / 4;
  for (int e = lane; e < nl + nr; e += 32) {
    const int h = e >= nl;
    const int f = e - h * nl;
    cp_async16(base + 16u * (h * (R / 4) + f), (h ? ar : al) + 4 * f);
  }
  const bool wide = (P & 3) == 0 && p0 + T <= P &&
                    ((uintptr_t)tips & 15) == 0;
  const int child[2] = {cl, cr};
  for (int h = 0; h < 2; ++h) {
    if (child[h] < 0) continue;
    const float* src = tips + (long long)child[h] * S * P;
    const uint32_t d = smem_u32(stage + 2 * R + h * S * T);
    if (wide) {
      const int T4 = T / 4;
      for (int e = lane; e < S * T4; e += 32) {
        const int r = e / T4;
        cp_async16(d + 16u * e,
                   src + (long long)r * P + p0 + 4 * (e - r * T4));
      }
    } else {
      for (int e = lane; e < S * T; e += 32) {
        const int r = e / T;
        const int p = p0 + e - r * T;
        cp_async4(d + 4u * e, src + (long long)r * P + (p < P ? p : P - 1));
      }
    }
  }
}

// One chunk's products for this thread's tile: x[q][r] = w_l * w_r at
// row s = ls + LS*q (clamped to S - 1 past the edge; the caller drops
// those) and pattern column r of cl, cr (the child columns [S, T] at the
// thread's first pattern); the operators' rows s at opl + s*S, opr + s*S.
// (Two register sets taking turns, term j + 1 loading while term j's
// multiply-adds ran, was slower on the H100, and TMA bulk copies of the
// operators by the producer came within a few percent of its cp.async.)
template <int S_T, int B>
__device__ __forceinline__ void tiled_products(
    const float* __restrict__ opl, const float* __restrict__ opr,
    const float* cl, const float* cr, int T, int S_rt, int ls, int LS,
    float (&x)[kTiledRows][B]) {
  const int S = S_T > 0 ? S_T : S_rt;
  const float* rl[kTiledRows];
  const float* rr[kTiledRows];
#pragma unroll
  for (int q = 0; q < kTiledRows; ++q) {
    const int s = ls + LS * q;
    rl[q] = opl + (s < S ? s : S - 1) * S;
    rr[q] = opr + (s < S ? s : S - 1) * S;
  }
  float wl[kTiledRows][B], wr[kTiledRows][B];
#pragma unroll
  for (int q = 0; q < kTiledRows; ++q)
#pragma unroll
    for (int r = 0; r < B; ++r) wl[q][r] = wr[q][r] = 0.f;
  constexpr int kUnroll = S_T > 0 ? S_T : 4;
#pragma unroll(kUnroll)
  for (int j = 0; j < S; ++j) {
    float vl[B], vr[B];
    load_cols<B>(vl, cl + j * T);
    load_cols<B>(vr, cr + j * T);
#pragma unroll
    for (int q = 0; q < kTiledRows; ++q) {
      const float a = rl[q][j];
      const float b = rr[q][j];
#pragma unroll
      for (int r = 0; r < B; ++r) {
        wl[q][r] = fmaf(a, vl[r], wl[q][r]);
        wr[q][r] = fmaf(b, vr[r], wr[q][r]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kTiledRows; ++q)
#pragma unroll
    for (int r = 0; r < B; ++r) x[q][r] = wl[q][r] * wr[q][r];
}

// The walk of block `rank` of a cluster of Q: chain pointers (lr
// [n_int, 2], op [n_int, 2, K, S, S], root [K, S, P], ls [P]), the tips
// [n_tips, S, P] and the tile's first pattern p0 of T.  The block has
// tiled_threads(S, T, per_sm) threads, the last warp the producer, and
// tiled_smem_bytes(n_tips, K, S, T, Q) bytes of shared memory at smem.
// S_T = 0 takes S from S_rt.
template <int S_T, int B>
__device__ __forceinline__ void tiled_walk(
    const int* __restrict__ lr, const float* __restrict__ op,
    const float* __restrict__ tips, float* __restrict__ root,
    float* __restrict__ ls, int n_tips, int n_int, int K, int S_rt, int P,
    int p0, int T, int Q, float* smem) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int S = S_T > 0 ? S_T : S_rt;
  const int R = tiled_op_words(S);
  const int LS = tiled_lanes(S);
  const int LP = 32 / LS;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int NC = blockDim.x - 32;                  // consumer threads
  const int kq = (K + Q - 1) / Q;
  const int k0 = rank * kq;
  const int nk = K - k0 < kq ? K - k0 : kq;        // this block's categories
  const int L1 = n_tips / 2 + 1;
  const int ST = S * T;
  const int stage_words = 2 * R + 2 * ST;
  const long long SS = (long long)S * S;
  float* ring = smem;
  float* slots = ring + 2 * stage_words;           // [L1, kq, S, T]
  float* maxima = slots + (long long)L1 * kq * ST; // [2, T]
  uint64_t* full = reinterpret_cast<uint64_t*>(maxima + 2 * T);
  uint64_t* empty = full + 2;
  int* codes = reinterpret_cast<int*>(empty + 2);
  int* oslot = codes + 2 * n_int;
  unsigned* busy = reinterpret_cast<unsigned*>(oslot + n_int);

  for (int e = t; e < 2 * n_int; e += blockDim.x) codes[e] = lr[e];
  if (t == 0) {
    for (int s = 0; s < 2; ++s) {
      tiled_mbar_init(full + s, 32);
      tiled_mbar_init(empty + s, NC);
    }
  }
  __syncthreads();
  if (t == 0) build_slot_map(codes, oslot, busy, n_tips, n_int, L1, true);
  // from here a child code c >= 0 is tip c, c < 0 the internal slot -c - 1
  __syncthreads();

  if (t >= NC) {
    // the producer: chunk c = (step c / nk, category k0 + c % nk) into
    // stage c & 1 once the consumers have released chunk c - 2.  It
    // takes part in the consumers' cluster barriers (one a step, one at
    // the end) with a split arrive and wait: before it waits for a chunk
    // of step j it has arrived at the barriers of steps 0 .. j, so the
    // consumers never wait at a barrier for its copies, and it waits on
    // barrier k - 1 only to arrive at barrier k.
    int arrived = 0;
    auto arrive_through = [&](int k) {   // arrive at barriers 0 .. k
      for (; arrived <= k; ++arrived) {
        if (arrived > 0) cluster_wait();
        cluster_arrive();
      }
    };
    for (int c = 0; c < n_int * nk; ++c) {
      if (c >= 2) {
        arrive_through((c - 2) / nk);
        tiled_mbar_wait(empty + (c & 1), ((c >> 1) - 1) & 1);
      }
      const int i = c / nk;
      const float* o = op + (long long)i * 2 * K * SS + (k0 + c % nk) * SS;
      tiled_issue(ring + (c & 1) * stage_words, o, o + K * SS, tips,
                  codes[2 * i], codes[2 * i + 1], S, T, P, p0, lane);
      tiled_mbar_arrive_copies(full + (c & 1));
    }
    arrive_through(n_int);   // the steps' barriers and the end's
    cluster_wait();
    return;
  }

  const int lsn = lane & (LS - 1);                 // lane along s
  const int pc = ((t >> 5) * LP + lane / LS) * B;  // first column
  float lsum[B];
#pragma unroll
  for (int r = 0; r < B; ++r) lsum[r] = 0.f;
  for (int i = 0; i < n_int; ++i) {
    // every consumer's normalised slot of the last step is written
    if (i > 0) consumer_sync(NC);
    float mr[B];
#pragma unroll
    for (int r = 0; r < B; ++r) mr[r] = 0.f;
    for (int u = 0; u < nk; ++u) {
      const int c = i * nk + u;
      tiled_mbar_wait(full + (c & 1), (c >> 1) & 1);
      const float* stage = ring + (c & 1) * stage_words;
      const float* ch[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int code = codes[2 * i + h];
        ch[h] = code >= 0 ? stage + 2 * R + h * ST
                          : slots + ((long long)(-code - 1) * kq + u) * ST;
      }
      // the chunk's operators, each at its offset from a 16-byte boundary
      const float* o = op + (long long)i * 2 * K * SS + (k0 + u) * SS;
      float x[kTiledRows][B];
      tiled_products<S_T, B>(stage + op_offset(o),
                             stage + R + op_offset(o + K * SS), ch[0] + pc,
                             ch[1] + pc, T, S, lsn, LS, x);
      tiled_mbar_arrive(empty + (c & 1));
      float* dst = slots + ((long long)oslot[i] * kq + u) * ST + pc;
#pragma unroll
      for (int q = 0; q < kTiledRows; ++q) {
        const int s = lsn + LS * q;
        if (s < S) {
          store_cols<B>(dst + s * T, x[q]);
#pragma unroll
          for (int r = 0; r < B; ++r) mr[r] = fmaxf(mr[r], x[q][r]);
        }
      }
    }
    // the block's max a pattern, then the cluster's
    float* mx = maxima + (i & 1) * T;
#pragma unroll
    for (int r = 0; r < B; ++r) mr[r] = group_max(mr[r], LS);
    if (lsn == 0) store_cols<B>(mx + pc, mr);
    cluster.sync();
    float m[B];
#pragma unroll
    for (int r = 0; r < B; ++r) m[r] = 0.f;
    for (int k = lsn; k < Q; k += LS) {
      float v[B];
      load_cols<B>(v, cluster.map_shared_rank(mx, k) + pc);
#pragma unroll
      for (int r = 0; r < B; ++r) m[r] = fmaxf(m[r], v[r]);
    }
#pragma unroll
    for (int r = 0; r < B; ++r) m[r] = fmaxf(group_max(m[r], LS), kTiny);
    // each thread divides the entries it wrote
    const bool last = i == n_int - 1;
    for (int u = 0; u < nk; ++u) {
      float* d = slots + ((long long)oslot[i] * kq + u) * ST + pc;
#pragma unroll
      for (int q = 0; q < kTiledRows; ++q) {
        const int s = lsn + LS * q;
        if (s >= S) continue;
        float v[B];
        load_cols<B>(v, d + s * T);
#pragma unroll
        for (int r = 0; r < B; ++r) v[r] = v[r] / m[r];
        if (!last) {
          store_cols<B>(d + s * T, v);
        } else {
          float* o = root + ((long long)(k0 + u) * S + s) * P;
#pragma unroll
          for (int r = 0; r < B; ++r)
            if (p0 + pc + r < P) o[p0 + pc + r] = v[r];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < B; ++r) lsum[r] += logf(m[r]);
  }
  if (rank == 0 && lsn == 0) {
#pragma unroll
    for (int r = 0; r < B; ++r)
      if (p0 + pc + r < P) ls[p0 + pc + r] = lsum[r];
  }
  // no block leaves while another may still read its maxima
  cluster.sync();
}

// ------------------------------------------------------------------ host

// The size rule for the tiled walk (the header): Q blocks a cluster
// (`cluster` > 0 forces it) and T patterns a block (`T_force` > 0 forces
// it).  Returns false where no T fits; else sets *T, *threads, *bytes,
// *lanes (LS) and *Q.
inline bool tiled_plan(int C, int n_tips, int K, int S, int P,
                       const DeviceLimits& lim, int cluster, int T_force,
                       int* T, int* threads, int* bytes, int* lanes,
                       int* Q) {
  const int q = cluster > 0 ? cluster : tiled_cluster(K);
  if (q > K || q > kTiledMaxCluster) return false;
  const int lp = 32 / tiled_lanes(S);
  int pick = 0, fits = 0;
  for (int cand : kTiledTiles) {
    if (cand < lp || (T_force > 0 && cand != T_force)) continue;
    const long long b = tiled_smem_bytes(n_tips, K, S, cand, q);
    if (b > lim.smem) continue;
    if (fits == 0) fits = cand;   // the largest that fits
    const long long blocks = (long long)q * C * ((P + cand - 1) / cand);
    if (2 * b <= lim.smem &&
        blocks >= (long long)kTiledBlocksPerSM * lim.sms) {
      pick = cand;
      break;
    }
  }
  if (pick == 0) pick = fits;
  if (pick == 0) return false;
  *T = pick;
  *bytes = (int)tiled_smem_bytes(n_tips, K, S, pick, q);
  *threads = tiled_threads(S, pick, lim.smem / *bytes);
  *lanes = tiled_lanes(S);
  *Q = q;
  return true;
}

}  // namespace mb
