// Batched symmetric eigensolver for 9 <= S <= 64: the port's counterpart of
// jnp.linalg.eigh as mrbayes_tpu/ops/tiprobs.py:34 calls it for the protein
// (S = 20) and codon (S = 61) generators.  It is not a port of a Pallas
// kernel: torch.linalg.eigh on a CUDA tensor checks its info output on the
// host, and a host synchronisation in every Q move would stall the
// generation loop (ops/eigh_cuda.py).
//
// What it computes, per matrix b of a batch A [B, S, S] (float64,
// symmetric): w [b, S] and V [b, S, S] in float64 with A[b] = V diag(w)
// V^T, the columns of V the eigenvectors, eigenvalues unsorted; and the
// sweeps it took.  The input is float64 so that fixed generators (the
// empirical amino-acid models, computed once in float64 by the engine)
// reach the solver unrounded.
//
// Design: one block per matrix, cyclic Jacobi in float64 with A and V in
// shared memory (2 * n * (n + 1) doubles, n = S rounded up to even: 66,560
// bytes at S = 64; the odd row stride n + 1 spreads a column's doubles
// over the banks).  An odd S is padded with a zero row and column: every
// rotation of the pad index meets a zero and is the identity, so the pad
// never mixes in.  A sweep is the n - 1 rounds of the circle (round-robin)
// schedule (round_pair; ops/eigh_cuda.py:round_pairs is its Python twin),
// each round n / 2 disjoint rotations, so a round is two block-wide steps:
//   1. n / 2 threads compute the rounds' rotations (c, s, t) from the
//      current A (Golub and Van Loan's symmetric Schur 2x2: t the smaller
//      root, so |angle| <= pi / 4);
//   2. every thread takes 2x2 blocks (pair k's rows, pair l's columns) and
//      writes J_k^T A_kl J_l in place (no two blocks share an entry), the
//      diagonal blocks with their exact result (a_pp - t a_pq,
//      a_qq + t a_pq, 0 off the diagonal), and V's columns of pair l.
// Before each sweep the block reduces the off-diagonal and the whole
// Frobenius norms; it stops when off <= kTol * whole (the float64 rounding
// floor is about S * 2.2e-16), or after kMaxSweeps.
// The loop lives in the kernel: no host synchronisation.  Float64 costs
// little here (the H100 runs float64 at half its float32 rate outside the
// tensor cores), and the outputs stay float64: at S = 20 an eigensystem
// rounded to float32 moves transition probabilities below float32's
// resolution relative to |U| |U^-1|, up to 0.08 in a protein lnL
// (PERF.md), so the port keeps S > 8 eigensystems in float64.
// ops/eigh_cuda.py:jacobi_twin is the whole algorithm in numpy.
//
// What bounds it on an H100: latency.  Each round is a dependent pair of
// block-wide steps with two barriers, (n - 1) rounds a sweep and 6-8
// sweeps for a random generator (quadratic convergence; one for Poisson's,
// whose equal rates and frequencies meet the tolerance after a sweep, in
// jacobi_twin and on the card).  At S = 61 a sweep is 61 rounds of 31^2
// 2x2 updates of A (24 FLOPs each) and 62 x 31 of V (6 each), about
// 1.8 MFLOP of float64, several times the 9 S^3 (2.0 MFLOP) an
// eigendecomposition with eigenvectors needs; that work and the bytes
// (8 S^2 in, 8 (S^2 + S) out per matrix) are each far below what the
// barriers cost.  Matrices of a batch run
// on separate SMs, so a batch up to the SM count takes about one
// matrix's time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 64;
constexpr int kMaxDevices = 64;
constexpr int kMaxSweeps = 20;
constexpr double kTol = 1e-12;

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

// dynamic shared memory of one block for S states
__host__ __device__ inline int smem_bytes(int S) {
  const int n = padded(S);
  const int half = n / 2;
  return 8 * (2 * n * (n + 1) + 3 * half + 2 * kWarps) + 4 * (2 * half + 1);
}

__global__ void __launch_bounds__(kThreads)
eigh_jacobi_kernel(const double* __restrict__ A_in,  // [B, S, S]
                   double* __restrict__ w_out,       // [B, S]
                   double* __restrict__ V_out,       // [B, S, S]
                   int* __restrict__ sweeps_out,     // [B] or null
                   int S) {
  extern __shared__ double smem[];
  const int n = padded(S);
  const int ld = n + 1;
  const int half = n / 2;
  double* A = smem;                       // [n, ld]
  double* V = A + n * ld;                 // [n, ld]
  double* rc = V + n * ld;                // [half] cos
  double* rs = rc + half;                 // [half] sin
  double* rt = rs + half;                 // [half] tan
  double* red = rt + half;                // [2 * kWarps] partial norms
  int* rp = reinterpret_cast<int*>(red + 2 * kWarps);   // [half]
  int* rq = rp + half;                                  // [half]
  int* done = rq + half;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * S * S;
  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, j = e - (e / n) * n;
    A[i * ld + j] = (i < S && j < S) ? A_in[base + i * S + j] : 0.0;
    V[i * ld + j] = i == j ? 1.0 : 0.0;
  }
  __syncthreads();
  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0, all = 0.0;
    for (int e = tid; e < S * S; e += kThreads) {
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
      for (int w = 0; w < kWarps; ++w) {
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
      for (int e = tid; e < half * half; e += kThreads) {
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
      for (int e = tid; e < n * half; e += kThreads) {
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
  for (int e = tid; e < S * S; e += kThreads) {
    const int i = e / S, j = e - (e / S) * S;
    V_out[base + e] = V[i * ld + j];
  }
  for (int i = tid; i < S; i += kThreads)
    w_out[(long long)blockIdx.x * S + i] = A[i * ld + i];
  if (tid == 0 && sweeps_out != nullptr) sweeps_out[blockIdx.x] = sweep;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from PyTorch) on device `device`: one
// block per matrix of A [batch, S, S] (float64, symmetric), outputs w
// [batch, S], V [batch, S, S] (float64) and, unless null, sweeps [batch]
// (int32).
// Returns the cudaGetLastError() code after the launch (0 = success); the
// kernel itself runs asynchronously.
int mb_eigh_jacobi(const void* A, void* w, void* V, void* sweeps, int batch,
                   int S, int device, void* stream) {
  if (S < 2 || S > kMaxS || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bytes = smem_bytes(S);
  static bool allowed[kMaxDevices] = {};
  if (bytes > 48 * 1024 &&
      !(device >= 0 && device < kMaxDevices && allowed[device])) {
    err = cudaFuncSetAttribute(eigh_jacobi_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(kMaxS));
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < kMaxDevices) allowed[device] = true;
  }
  eigh_jacobi_kernel<<<batch, kThreads, bytes, (cudaStream_t)stream>>>(
      (const double*)A, (double*)w, (double*)V, (int*)sweeps, S);
  return (int)cudaGetLastError();
}

const char* mb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
