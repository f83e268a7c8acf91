// Batched symmetric eigensolver for 9 <= S <= 64: the port's counterpart of
// jnp.linalg.eigh as mrbayes_tpu/ops/tiprobs.py:33 calls it for the protein
// (S = 20) and codon (S = 61) generators.  It is not a port of a Pallas
// kernel: torch.linalg.eigh on a CUDA tensor checks its info output on the
// host, and a host synchronisation in every Q move would stall the
// generation loop (ops/eigh_cuda.py).
//
// What it computes, per matrix b of a batch A [B, S, S] (float64,
// symmetric; the lower triangle is read, as torch.linalg.eigh reads it):
// w [b, S] and V [b, S, S] in float64 with A[b] = V diag(w) V^T, the
// columns of V the eigenvectors, eigenvalues unsorted; and the sweeps it
// took.  The input is float64 so that fixed generators (the empirical
// amino-acid models, computed once in float64 by the engine) reach the
// solver unrounded, and the outputs stay float64: at S = 20 an
// eigensystem rounded to float32 moves transition probabilities below
// float32's resolution relative to |U| |U^-1|, up to 0.08 in a protein lnL
// (PERF.md).
//
// The algorithm: cyclic Jacobi in float64.  An odd S is padded with a zero
// row and column to an even n (every rotation of the pad index meets a
// zero and is the identity, so the pad never mixes in).  A sweep is the
// n - 1 rounds of the circle (round-robin) schedule (round_pair;
// ops/eigh_cuda.py:round_pairs is its twin), each round n / 2 disjoint
// rotations (p, q) from Golub and Van Loan's symmetric 2x2 Schur
// decomposition (t the smaller root, so |angle| <= pi / 4; schur),
// applied together as A <- J^T A J, V <- V J, with a_pq set to exactly 0.
// Before each sweep the off-diagonal and whole Frobenius norms are
// reduced; the loop stops when off <= kTol * whole (the float64 rounding
// floor is about S * 2.2e-16), or after kMaxSweeps.
// ops/eigh_cuda.py:jacobi_twin is the algorithm in numpy, in the kernel's
// order of operations (the kernel's fused multiply-adds and rsqrt round
// differently).
//
// What bounds it on an H100: latency and shared-memory issue.  A matrix is
// 5-8 sweeps of n - 1 dependent rounds (quadratic convergence; one sweep
// for Poisson's, whose equal rates and frequencies meet the tolerance at
// once), and a round's arithmetic is small: at S = 61, 465 2x2 tiles of A
// (24 FLOPs each) and 61 x 31 row pairs of V (6 each), about 23 kFLOP,
// under 200 cycles of an SM's 64 float64 FMAs a clock.  The 9 S^3
// operations of an eigendecomposition and the 8 (2 S^2 + S) bytes a
// matrix moves are far below that chain (chip_smoke.py's bound).  What is
// left a round is the rotation's dependent chain (two rsqrt), two
// barriers of the producer warps, and the shared-memory and shuffle
// instructions of A's tiles and V's rows, which share the SM's one
// shared-memory pipe.  The first design (eigh_jacobi_before_kernel, kept
// below for chip_smoke.py's before_ms) spent about 2.7 us a round at
// S = 61; timing a table-driven version of this design attributed most of
// a round to shared-memory bank conflicts and the rotation's chain, little
// to barriers (PERF.md).  What this design does about each cause:
//   1. Compile-time S: eigh_jacobi_kernel is a template on S, with
//      instantiations for S = 20 and 61 (the main path's) and one runtime-S
//      instantiation (kS = 0) for every other S up to 64.  No division by a
//      runtime value is left in the round loop or the norm loop: every
//      address there is fixed before the sweep loop.
//   2. Static thread maps and the moving layout: A and V are kept in the
//      order of positions, not labels.  Slot k of every round rotates
//      positions 2k and 2k + 1, and after a round each label moves to
//      next_pos of its position, the same permutation every round, which
//      puts the next round's pairs at (2k, 2k + 1) again (round 0's layout
//      and next_pos realise the circle schedule exactly; n - 1 moves bring
//      it back, so every sweep starts in round 0's layout).  Producer
//      thread t owns tile t (the t-th (k, l), k < l: rows 2k, 2k + 1,
//      columns 2l, 2l + 1; producer_tiles in ops/eigh_cuda.py): it reads
//      two pairs of neighbours (16-byte loads, consecutive across a warp)
//      and writes four entries of the next layout, at addresses fixed
//      before the loop; A is double-buffered for that.  Lane k of warp 0
//      owns slot k's rotation and diagonal block.  No schedule table is
//      read in the loop; the norm loop reads round 0's tiles.
//   3. Symmetric update: A lives in the upper triangle only (positions
//      i > j kept at [j][i]); a round rotates the n/2 (n/2 - 1) / 2 tiles
//      k < l (465 at S = 61, 45 at S = 20, against 961 and 100 block
//      updates of both triangles) and the n / 2 diagonal blocks.
//   4. V off A's critical path: producer warps run A's rounds and the
//      convergence test; consumer warps apply each round to V.  Warp 0
//      computes a round's rotations from its diagonal blocks, writes their
//      new diagonals and a_pq = 0, publishes (c, s) to a ring of kRing slots
//      in shared memory and arrives on the slot's full mbarrier; the other
//      producers wait only at a named barrier of the producer warps (two a
//      round: after the rotations, after the tiles).  One producer thread
//      outside warp 0 waits on the next slot's empty mbarrier before the
//      round's last barrier, so no wait sits on the rotations' chain.  A
//      consumer warp waits on full, reads the round's (c, s), arrives on the
//      slot's empty mbarrier (one arrival a warp after __syncwarp) and then
//      applies the round.  Consumer warp w holds rows [w R, w R + R) of V (R
//      = ceil(S / consumer warps); consumer_rows) in registers, lane k
//      positions 2k and 2k + 1: a round is one rotation a row and lane, then
//      next_pos as two shuffles (even positions one lane down, odd ones one
//      lane up, the ends fixed by selects), with no shared memory.  No
//      rotation reads V, so consumer warps run up to kRing rounds behind;
//      their rows are disjoint, so they never wait for each other.  The end
//      of the loop travels through the ring as a round of kDone.
//   5. Warps: Split<S> below, chosen by measurement (python -m
//      mrbayes_tpu_torch.eigh_bench, PERF.md): at S = 61 512 producer threads
//      (one tile each) and 8 consumer warps (8 V rows each), 768 threads; at
//      S = 20 64 producers (45 tiles) and 5 consumer warps (4 rows each), 224
//      threads; at runtime S 256 producers (up to 2 tiles each at S = 64) and
//      8 consumer warps.  Matrices of a batch run one a block, a batch up to
//      the 132 SMs in one wave.
//
// Shared memory of one block (layout(); mb_eigh_plan reports it): two
// n x n buffers of A, the ring's (c, s) (kRing x n / 2 double2), the
// producers' norm partials (2 doubles a warp), 2 kRing mbarriers and the
// ring's rounds (kRing ints): 7,872 bytes at S = 20, 65,888 at S = 61 and
// 69,920 at S = 64 (the runtime-S instantiation's most), under the 227 KB
// a block may use; the launch checks it against the device.  Registers
// (ptxas, sm_90a, CUDA 12.8): 54 at S = 20, 62 at S = 61, 80 at runtime S
// (768 threads cap a thread at 80, 512 at 128), no spills; the first
// design 61 (chip_smoke.py's build log, PERF.md §6).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 64;
constexpr int kMaxDevices = 64;
constexpr int kMaxSweeps = 20;
constexpr double kTol = 1e-12;
// rounds in flight between the producer and the consumer warps
constexpr int kRing = 8;
constexpr int kRingLog = 3;
static_assert(kRing == 1 << kRingLog, "slots and phases by shifts");
// the ring's round of the end of the loop
constexpr int kDone = -1;
// named barrier of the producer warps (0 is __syncthreads)
constexpr int kProducerBarrier = 1;

// thread split of each instantiation (kS = 0: runtime S): producer threads
// and consumer warps
template <int kS> struct Split {
  static constexpr int producers = 256, consumer_warps = 8;
};
template <> struct Split<20> {
  static constexpr int producers = 64, consumer_warps = 5;
};
template <> struct Split<61> {
  static constexpr int producers = 512, consumer_warps = 8;
};

// pair k (0 <= k < n/2) of round r (0 <= r < n - 1) of the circle schedule
// of n indices, with p < q: index n - 1 fixed, the others turning
__device__ inline void round_pair(int r, int k, int n, int* p, int* q) {
  int a, b;
  if (k == 0) {
    a = r;
    b = n - 1;
  } else {
    a = (r + k) % (n - 1);
    b = (r - k + n - 1) % (n - 1);
  }
  *p = a < b ? a : b;
  *q = a < b ? b : a;
}

__host__ __device__ inline int padded(int S) { return S + (S & 1); }

// The moving layout.  Slot k of every round rotates the labels (indices of
// A) at positions 2k and 2k + 1; after a round the label at position x
// moves to position next_pos(x), so that round r + 1's pairs sit at
// (2k, 2k + 1) again.  With round 0's layout (label_of), positions 2k and
// 2k + 1 of round r hold (r + k, r - k) mod (n - 1) for k >= 1 and (r,
// n - 1) for k = 0: the circle schedule (round_pair, with that order in
// each pair).  next_pos is the same for every round, so n - 1 steps bring
// every label back: each sweep starts and ends in round 0's layout.
// ops/eigh_cuda.py:label_of and next_pos are the twins.
__host__ __device__ inline int next_pos(int x, int n) {
  if (x == 0) return 3;
  if (x == 1) return 1;
  if (x == 2) return 0;
  if (x == n - 1) return n - 2;
  return (x & 1) ? x + 2 : x - 2;
}

__host__ __device__ inline int label_of(int x, int n) {
  if (x == 0) return 0;
  if (x == 1) return n - 1;
  return (x & 1) ? n - 1 - (x >> 1) : x >> 1;
}

__host__ __device__ inline int pos_of(int label, int n) {
  if (label == 0) return 0;
  if (label == n - 1) return 1;
  return label < n / 2 ? 2 * label : 2 * (n - 1 - label) + 1;
}

// byte offsets of the shared-memory arrays of one block for S states and
// `producers` producer threads
struct Layout {
  int A0, A1, ring, red, bars, rounds, bytes;
};

__host__ __device__ inline Layout layout(int S, int producers) {
  const int n = padded(S), half = n / 2;
  Layout L;
  L.A0 = 0;
  L.A1 = L.A0 + 8 * n * n;
  L.ring = L.A1 + 8 * n * n;
  L.red = L.ring + 16 * kRing * half;
  L.bars = L.red + 8 * 2 * (producers / 32);
  L.rounds = L.bars + 8 * 2 * kRing;
  L.bytes = L.rounds + 4 * kRing;
  return L;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// arrive (release: this thread's earlier shared-memory accesses are seen
// by whoever completes a wait on the phase)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// wait (acquire) until the phase of parity `parity` has completed; the
// phase before a barrier's first counts as completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// parity to wait on for message msg's ring slot to be free: the phase
// its consumers completed when they released message msg - kRing
__device__ __forceinline__ unsigned free_parity(unsigned msg) {
  return ((msg >> kRingLog) & 1) ^ 1;
}

__device__ __forceinline__ void producer_sync(int producers) {
  asm volatile("bar.sync %0, %1;" :: "n"(kProducerBarrier), "r"(producers)
               : "memory");
}

// The symmetric 2x2 Schur rotation of (a_pp, a_pq; a_pq, a_qq) (Golub and
// Van Loan 8.5.2: t = sign(tau) / (|tau| + sqrt(1 + tau^2)), tau = (a_qq -
// a_pp) / (2 a_pq), the smaller root, |angle| <= pi / 4; c = 1 /
// sqrt(1 + t^2), s = t c) in a form with two rsqrt and no division:
// with d = a_qq - a_pp, e = 2 a_pq and h = sqrt(d^2 + e^2), cos 2 theta =
// |d| / h, so c^2 = (1 + |d| / h) / 2, s = sign(tau) |e| / (2 h c) and
// t = s / c.  d and e are first scaled, exactly, by the power of two that
// brings the larger into [1, 2) (built from its exponent bits), so that
// d^2 + e^2 neither under- nor overflows.  The identity where a_pq = 0.
__device__ __forceinline__ void schur(double app, double aqq, double apq,
                                      double* c, double* s, double* t) {
  if (apq == 0.0) {
    *c = 1.0;
    *s = 0.0;
    *t = 0.0;
    return;
  }
  const double d = aqq - app, e = 2.0 * apq;
  const long long top = __double_as_longlong(fmax(fabs(d), fabs(e))) &
                        0x7ff0000000000000LL;
  const double scale = __longlong_as_double(0x7fe0000000000000LL - top);
  const double ds = d * scale, es = e * scale;
  const double rh = rsqrt(ds * ds + es * es);          // 1 / h
  const double c2 = 0.5 + 0.5 * (fabs(ds) * rh);       // c^2
  const double rc = rsqrt(c2);                         // 1 / c
  const double sg = (d == 0.0 || (d > 0.0) == (e > 0.0)) ? 1.0 : -1.0;
  *c = c2 * rc;
  *s = sg * (0.5 * (fabs(es) * rh)) * rc;
  *t = *s * rc;
}

// index of position (i, j) in the upper-triangle storage of row stride n
__device__ __forceinline__ int up(int i, int j, int n) {
  return i < j ? i * n + j : j * n + i;
}

template <int kS, int kProducers, int kConsumerWarps>
__global__ void __launch_bounds__(kProducers + 32 * kConsumerWarps, 1)
eigh_jacobi_kernel(const double* __restrict__ A_in,  // [B, S, S]
                   double* __restrict__ w_out,       // [B, S]
                   double* __restrict__ V_out,       // [B, S, S]
                   int* __restrict__ sweeps_out,     // [B] or null
                   int S_arg) {
  constexpr int kThreads = kProducers + 32 * kConsumerWarps;
  constexpr int kMaxN = kS ? kS + (kS & 1) : kMaxS;
  constexpr int kMaxHalf = kMaxN / 2;
  constexpr int kMaxTiles = kMaxHalf * (kMaxHalf - 1) / 2;
  constexpr int kTilesPerThread = (kMaxTiles + kProducers - 1) / kProducers;
  constexpr int kMaxRows = ((kS ? kS : kMaxS) + kConsumerWarps - 1) /
                           kConsumerWarps;
  static_assert(kMaxHalf <= 32, "a lane a slot: warp 0's rotations, V");
  static_assert(kProducers % 32 == 0, "producers are whole warps");
  const int S = kS ? kS : S_arg;
  const int n = padded(S);
  const int half = n / 2;
  const Layout L = layout(S, kProducers);
  extern __shared__ __align__(16) unsigned char smem[];
  double* A0 = reinterpret_cast<double*>(smem + L.A0);   // [n, n] upper,
  double* A1 = reinterpret_cast<double*>(smem + L.A1);   // two rounds
  double2* ring = reinterpret_cast<double2*>(smem + L.ring);  // [kRing, half]
  double* red = reinterpret_cast<double*>(smem + L.red);      // 2 a warp
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);  // [kRing]
  uint64_t* empty = full + kRing;                                // [kRing]
  int* rounds = reinterpret_cast<int*>(smem + L.rounds);      // [kRing]
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * S * S;

  // the input's lower triangle into A's upper one in round 0's layout; the
  // pad label's row and column 0
  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, j = e - (e / n) * n;
    if (j <= i)
      A0[up(pos_of(i, n), pos_of(j, n), n)] =
          i < S ? A_in[base + i * S + j] : 0.0;
  }
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
  }
  __syncthreads();

  if (tid < kProducers) {
    // ---- producers: A's rounds and the convergence test ----
    const int lane = tid & 31, warp = tid >> 5;
    const bool rotates = tid < half;       // warp 0: slot tid's rotation
    const int ntiles = half * (half - 1) / 2;
    // the static map: tile (k, l), k < l, is rows 2k, 2k + 1 and columns
    // 2l, 2l + 1; it reads two pairs of neighbours and writes four entries
    // of the next layout
    int src[kTilesPerThread], dst[kTilesPerThread][4], bk[kTilesPerThread],
        bl[kTilesPerThread];
#pragma unroll
    for (int j = 0; j < kTilesPerThread; ++j) {
      int rem = tid + j * kProducers, k = 0;
      bk[j] = bl[j] = -1;
      if (rem < ntiles) {
        while (rem >= half - 1 - k) {
          rem -= half - 1 - k;
          ++k;
        }
        const int l = k + 1 + rem;
        bk[j] = k;
        bl[j] = l;
        src[j] = 2 * k * n + 2 * l;
        const int r0 = next_pos(2 * k, n), r1 = next_pos(2 * k + 1, n);
        const int c0 = next_pos(2 * l, n), c1 = next_pos(2 * l + 1, n);
        dst[j][0] = up(r0, c0, n);
        dst[j][1] = up(r0, c1, n);
        dst[j][2] = up(r1, c0, n);
        dst[j][3] = up(r1, c1, n);
      }
    }
    // warp 0's diagonal blocks: read at (2k, 2k + 1), written to the next
    // layout
    int dpp = 0, dqq = 0, dpq = 0;
    if (rotates) {
      const int p1 = next_pos(2 * tid, n), q1 = next_pos(2 * tid + 1, n);
      dpp = p1 * n + p1;
      dqq = q1 * n + q1;
      dpq = up(p1, q1, n);
    }
    const int m = n - 1;   // rounds a sweep
    unsigned msg = 0;      // rounds published so far
    // one thread outside warp 0 waits for the next message's slot to be
    // free before the barrier that precedes warp 0's write to it, so the
    // wait is not on the rotations' chain
    const bool waiter = tid == (kProducers > 32 ? 32 : 0);
    bool odd = false;      // the current round's A is A1
    int sweep = 0;
    for (; sweep < kMaxSweeps; ++sweep) {
      // norms, in round 0's layout: each upper entry once
      const double* A = odd ? A1 : A0;
      double off = 0.0, diag = 0.0;
#pragma unroll
      for (int j = 0; j < kTilesPerThread; ++j) {
        if (bk[j] >= 0) {
          const double2 x = *reinterpret_cast<const double2*>(A + src[j]);
          const double2 y = *reinterpret_cast<const double2*>(A + src[j] + n);
          off += x.x * x.x + x.y * x.y + y.x * y.x + y.y * y.y;
        }
      }
      if (rotates) {
        const double2 x = *reinterpret_cast<const double2*>(
            A + 2 * tid * n + 2 * tid);
        const double aqq = A[(2 * tid + 1) * n + 2 * tid + 1];
        off += x.y * x.y;
        diag += x.x * x.x + aqq * aqq;
      }
      for (int o = 16; o > 0; o >>= 1) {
        off += __shfl_xor_sync(0xffffffffu, off, o);
        diag += __shfl_xor_sync(0xffffffffu, diag, o);
      }
      if (lane == 0) {
        red[2 * warp] = off;
        red[2 * warp + 1] = diag;
      }
      if (waiter) mbar_wait(&empty[msg & (kRing - 1)], free_parity(msg));
      producer_sync(kProducers);
      double o2 = 0.0, d2 = 0.0;
#pragma unroll
      for (int w = 0; w < kProducers / 32; ++w) {
        o2 += red[2 * w];
        d2 += red[2 * w + 1];
      }
      // off-diagonal: both triangles, 2 o2; whole: 2 o2 + d2
      if (2.0 * o2 <= kTol * kTol * (2.0 * o2 + d2)) break;

#pragma unroll 1
      for (int r = 0; r < m; ++r, ++msg) {
        const double* A = odd ? A1 : A0;
        double* An = odd ? A0 : A1;
        const int slot = msg & (kRing - 1);
        double2* cs = ring + slot * half;
        // the tiles: their entries are final since the last round's end
        double2 x[kTilesPerThread], y[kTilesPerThread];
#pragma unroll
        for (int j = 0; j < kTilesPerThread; ++j) {
          if (bk[j] >= 0) {
            x[j] = *reinterpret_cast<const double2*>(A + src[j]);
            y[j] = *reinterpret_cast<const double2*>(A + src[j] + n);
          }
        }
        if (warp == 0) {
          if (rotates) {
            double c, s, t;
            const double2 pq = *reinterpret_cast<const double2*>(
                A + 2 * tid * n + 2 * tid);
            const double aqq = A[(2 * tid + 1) * n + 2 * tid + 1];
            schur(pq.x, aqq, pq.y, &c, &s, &t);
            An[dpp] = pq.x - t * pq.y;
            An[dqq] = aqq + t * pq.y;
            An[dpq] = 0.0;
            cs[tid] = make_double2(c, s);
          }
          if (lane == 0) rounds[slot] = r;
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[slot]);
        }
        producer_sync(kProducers);
#pragma unroll
        for (int j = 0; j < kTilesPerThread; ++j) {
          if (bk[j] >= 0) {
            const double2 rk = cs[bk[j]], rl = cs[bl[j]];
            const double ck = rk.x, sk = rk.y, cl = rl.x, sl = rl.y;
            const double apu = x[j].x, apv = x[j].y;
            const double aqu = y[j].x, aqv = y[j].y;
            // rows (J_k^T A): p <- c a_p - s a_q, q <- s a_p + c a_q
            const double bpu = ck * apu - sk * aqu, bpv = ck * apv - sk * aqv;
            const double bqu = sk * apu + ck * aqu, bqv = sk * apv + ck * aqv;
            // columns (B J_l): u <- c b_u - s b_v, v <- s b_u + c b_v
            An[dst[j][0]] = cl * bpu - sl * bpv;
            An[dst[j][1]] = sl * bpu + cl * bpv;
            An[dst[j][2]] = cl * bqu - sl * bqv;
            An[dst[j][3]] = sl * bqu + cl * bqv;
          }
        }
        if (waiter)
          mbar_wait(&empty[(msg + 1) & (kRing - 1)], free_parity(msg + 1));
        producer_sync(kProducers);
        odd = !odd;
      }
    }
    if (warp == 0) {       // the waiter has seen the slot free
      const int slot = msg & (kRing - 1);
      if (lane == 0) rounds[slot] = kDone;
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[slot]);
    }
    // the eigenvalues, from round 0's layout
    for (int x = tid; x < n; x += kProducers) {
      const int label = label_of(x, n);
      if (label < S)
        w_out[(long long)blockIdx.x * S + label] = (odd ? A1 : A0)[x * n + x];
    }
    if (tid == 0 && sweeps_out != nullptr) sweeps_out[blockIdx.x] = sweep;
  } else {
    // ---- consumers: V <- V J, round by round ----
    // Warp w holds rows [w R, w R + R) of V in registers, in the moving
    // layout: lane k positions 2k (ve) and 2k + 1 (vo).  A round rotates
    // each lane's pair, then moves every entry to next_pos: the even
    // positions one lane down, the odd ones one lane up (shuffles), with
    // the ends of next_pos fixed by selects.
    const int ct = tid - kProducers;
    const int lane = ct & 31, cw = ct >> 5;
    const int per_warp = (S + kConsumerWarps - 1) / kConsumerWarps;
    const int row0 = cw * per_warp;
    const int rows = min(per_warp, S - row0);
    const bool live = lane < half;
    const int le = live ? label_of(2 * lane, n) : -1;
    const int lo = live ? label_of(2 * lane + 1, n) : -1;
    double ve[kMaxRows], vo[kMaxRows];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      ve[j] = (j < rows && le == row0 + j) ? 1.0 : 0.0;
      vo[j] = (j < rows && lo == row0 + j) ? 1.0 : 0.0;
    }
    for (unsigned msg = 0;; ++msg) {
      const int slot = msg & (kRing - 1);
      mbar_wait(&full[slot], (msg >> kRingLog) & 1);
      if (rounds[slot] == kDone) break;
      const double2 cs = live ? ring[slot * half + lane] : make_double2(1, 0);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j) {
        if (j < rows) {
          const double e = cs.x * ve[j] - cs.y * vo[j];
          const double o = cs.y * ve[j] + cs.x * vo[j];
          const double down = __shfl_down_sync(0xffffffffu, e, 1);
          const double upv = __shfl_up_sync(0xffffffffu, lane == 0 ? e : o,
                                            1);
          ve[j] = lane == half - 1 ? o : down;
          vo[j] = lane == 0 ? o : upv;
        }
      }
    }
    // round 0's layout again: each lane's two positions to their labels
    if (live && rows > 0) {
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j) {
        if (j < rows) {
          double* out = V_out + base + (long long)(row0 + j) * S;
          out[le] = ve[j];
          if (lo < S) out[lo] = vo[j];
        }
      }
    }
  }
}

// ---- the first design, kept for chip_smoke.py's before_ms ----
// One block of 256 threads per matrix, runtime S, both triangles of A
// rotated, V updated by the same threads between the rotations and the
// round's second block-wide barrier.

constexpr int kBeforeThreads = 256;
constexpr int kBeforeWarps = kBeforeThreads / 32;

__host__ __device__ inline int before_smem_bytes(int S) {
  const int n = padded(S);
  const int half = n / 2;
  return 8 * (2 * n * (n + 1) + 3 * half + 2 * kBeforeWarps) +
         4 * (2 * half + 1);
}

__global__ void __launch_bounds__(kBeforeThreads)
eigh_jacobi_before_kernel(const double* __restrict__ A_in,  // [B, S, S]
                          double* __restrict__ w_out,       // [B, S]
                          double* __restrict__ V_out,       // [B, S, S]
                          int* __restrict__ sweeps_out,     // [B] or null
                          int S) {
  extern __shared__ double smem_before[];
  const int n = padded(S);
  const int ld = n + 1;
  const int half = n / 2;
  double* A = smem_before;                // [n, ld]
  double* V = A + n * ld;                 // [n, ld]
  double* rc = V + n * ld;                // [half] cos
  double* rs = rc + half;                 // [half] sin
  double* rt = rs + half;                 // [half] tan
  double* red = rt + half;                // [2 * kBeforeWarps] partial norms
  int* rp = reinterpret_cast<int*>(red + 2 * kBeforeWarps);   // [half]
  int* rq = rp + half;                                        // [half]
  int* done = rq + half;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * S * S;
  for (int e = tid; e < n * n; e += kBeforeThreads) {
    const int i = e / n, j = e - (e / n) * n;
    A[i * ld + j] = (i < S && j < S) ? A_in[base + i * S + j] : 0.0;
    V[i * ld + j] = i == j ? 1.0 : 0.0;
  }
  __syncthreads();
  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0, all = 0.0;
    for (int e = tid; e < S * S; e += kBeforeThreads) {
      const int i = e / S, j = e - (e / S) * S;
      const double v = A[i * ld + j];
      all += v * v;
      if (i != j) off += v * v;
    }
    for (int o = 16; o > 0; o >>= 1) {
      off += __shfl_down_sync(0xffffffffu, off, o);
      all += __shfl_down_sync(0xffffffffu, all, o);
    }
    if ((tid & 31) == 0) {
      red[2 * (tid >> 5)] = off;
      red[2 * (tid >> 5) + 1] = all;
    }
    __syncthreads();
    if (tid == 0) {
      double o2 = 0.0, a2 = 0.0;
      for (int w = 0; w < kBeforeWarps; ++w) {
        o2 += red[2 * w];
        a2 += red[2 * w + 1];
      }
      *done = o2 <= kTol * kTol * a2;
    }
    __syncthreads();
    if (*done) break;
    for (int r = 0; r < n - 1; ++r) {
      if (tid < half) {
        int p, q;
        round_pair(r, tid, n, &p, &q);
        const double apq = A[p * ld + q];
        double c = 1.0, s = 0.0, t = 0.0;
        if (apq != 0.0) {
          const double tau = (A[q * ld + q] - A[p * ld + p]) / (2.0 * apq);
          t = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + sqrt(1.0 + tau * tau));
          c = 1.0 / sqrt(1.0 + t * t);
          s = t * c;
        }
        rp[tid] = p;
        rq[tid] = q;
        rc[tid] = c;
        rs[tid] = s;
        rt[tid] = t;
      }
      __syncthreads();
      for (int e = tid; e < half * half; e += kBeforeThreads) {
        const int k = e / half, l = e - (e / half) * half;
        const int p = rp[k], q = rq[k];
        if (k == l) {
          const double apq = A[p * ld + q], t = rt[k];
          A[p * ld + p] -= t * apq;
          A[q * ld + q] += t * apq;
          A[p * ld + q] = 0.0;
          A[q * ld + p] = 0.0;
          continue;
        }
        const int u = rp[l], v = rq[l];
        const double ck = rc[k], sk = rs[k], cl = rc[l], sl = rs[l];
        const double apu = A[p * ld + u], apv = A[p * ld + v];
        const double aqu = A[q * ld + u], aqv = A[q * ld + v];
        // rows (J_k^T A): p <- c a_p - s a_q, q <- s a_p + c a_q
        const double bpu = ck * apu - sk * aqu, bpv = ck * apv - sk * aqv;
        const double bqu = sk * apu + ck * aqu, bqv = sk * apv + ck * aqv;
        // columns (B J_l): u <- c b_u - s b_v, v <- s b_u + c b_v
        A[p * ld + u] = cl * bpu - sl * bpv;
        A[p * ld + v] = sl * bpu + cl * bpv;
        A[q * ld + u] = cl * bqu - sl * bqv;
        A[q * ld + v] = sl * bqu + cl * bqv;
      }
      for (int e = tid; e < n * half; e += kBeforeThreads) {
        const int i = e / half, l = e - (e / half) * half;
        const int u = rp[l], v = rq[l];
        const double cl = rc[l], sl = rs[l];
        const double viu = V[i * ld + u], viv = V[i * ld + v];
        V[i * ld + u] = cl * viu - sl * viv;
        V[i * ld + v] = sl * viu + cl * viv;
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < S * S; e += kBeforeThreads) {
    const int i = e / S, j = e - (e / S) * S;
    V_out[base + e] = V[i * ld + j];
  }
  for (int i = tid; i < S; i += kBeforeThreads)
    w_out[(long long)blockIdx.x * S + i] = A[i * ld + i];
  if (tid == 0 && sweeps_out != nullptr) sweeps_out[blockIdx.x] = sweep;
}

// the instantiation's launch: shared memory opted in once per device up to
// the instantiation's most, and checked against what the device allows
template <int kS>
cudaError_t launch(const double* A, double* w, double* V, int* sweeps,
                   int batch, int S, int device, cudaStream_t stream) {
  using Sp = Split<kS>;
  auto kernel = eigh_jacobi_kernel<kS, Sp::producers, Sp::consumer_warps>;
  static bool allowed[kMaxDevices] = {};
  if (!allowed[device]) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    const int most = layout(kS ? kS : kMaxS, Sp::producers).bytes;
    if (most > optin) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  kernel<<<batch, Sp::producers + 32 * Sp::consumer_warps,
           layout(S, Sp::producers).bytes, stream>>>(A, w, V, sweeps, S);
  return cudaGetLastError();
}

template <int kS>
void plan(int S, int* out) {
  using Sp = Split<kS>;
  out[0] = kS;
  out[1] = Sp::producers;
  out[2] = Sp::consumer_warps;
  out[3] = Sp::producers + 32 * Sp::consumer_warps;
  out[4] = layout(S, Sp::producers).bytes;
}

}  // namespace

extern "C" {

// The instantiation a launch at S states takes: out[0] its S (0 for the
// runtime-S kernel), out[1] producer threads, out[2] consumer warps, out[3]
// threads of a block, out[4] dynamic shared memory in bytes.  Returns a
// CUDA error code (0 = success).
int mb_eigh_plan(int S, int* out) {
  if (S < 4 || S > kMaxS) return (int)cudaErrorInvalidValue;
  if (S == 20)
    plan<20>(S, out);
  else if (S == 61)
    plan<61>(S, out);
  else
    plan<0>(S, out);
  return 0;
}

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device`: one
// block per matrix of A [batch, S, S] (float64, symmetric, the lower
// triangle read), outputs w [batch, S], V [batch, S, S] (float64) and,
// unless null, sweeps [batch] (int32); the instantiation mb_eigh_plan
// names.  Returns the cudaGetLastError() code after the launch (0 =
// success); the kernel itself runs asynchronously.
int mb_eigh_jacobi(const void* A, void* w, void* V, void* sweeps, int batch,
                   int S, int device, void* stream) {
  if (S < 4 || S > kMaxS || batch < 1 || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const double* a = (const double*)A;
  double* wo = (double*)w;
  double* vo = (double*)V;
  int* sw = (int*)sweeps;
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 20) return (int)launch<20>(a, wo, vo, sw, batch, S, device, st);
  if (S == 61) return (int)launch<61>(a, wo, vo, sw, batch, S, device, st);
  return (int)launch<0>(a, wo, vo, sw, batch, S, device, st);
}

// The first design's launch (eigh_jacobi_before_kernel), the same
// arguments; reached only from chip_smoke.py and the gpu tests.
int mb_eigh_jacobi_before(const void* A, void* w, void* V, void* sweeps,
                          int batch, int S, int device, void* stream) {
  if (S < 2 || S > kMaxS || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bytes = before_smem_bytes(S);
  static bool allowed[kMaxDevices] = {};
  if (bytes > 48 * 1024 &&
      !(device >= 0 && device < kMaxDevices && allowed[device])) {
    err = cudaFuncSetAttribute(eigh_jacobi_before_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               before_smem_bytes(kMaxS));
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < kMaxDevices) allowed[device] = true;
  }
  eigh_jacobi_before_kernel<<<batch, kBeforeThreads, bytes,
                              (cudaStream_t)stream>>>(
      (const double*)A, (double*)w, (double*)V, (int*)sweeps, S);
  return (int)cudaGetLastError();
}

const char* mb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
