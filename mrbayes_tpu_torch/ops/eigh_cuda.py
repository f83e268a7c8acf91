"""Batched symmetric eigensolver for 9 <= S <= 64 states as a hand-written
CUDA kernel.

Counterpart of ``jnp.linalg.eigh`` in ``mrbayes_tpu/ops/tiprobs.py:33``,
which the JAX package calls for the protein (S = 20) and codon (S = 61)
eigensystems; it is not a port of a Pallas kernel.  The port needs its
own because ``torch.linalg.eigh`` on a CUDA tensor checks its ``info``
output on the host: every Q move would synchronise the generation loop.
The fixed-sweep Jacobi of ``ops/jacobi.py`` (S <= 8) runs one Givens
rotation per pair as separate PyTorch ops, about 15,000 launches a
refresh at S = 20.

The kernel source is ``csrc/eigh.cu``; its header records what bounds it
on an H100 and what its design does about that: templates for S = 20
and 61 plus one for runtime S, producer warps that run A's rounds on its
upper triangle and consumer warps that apply each published round to V
(held in their registers) through a ring of shared-memory slots and
mbarriers.  The numpy twins here mirror its pieces for the CPU tests:
``next_pos``, ``label_of`` and ``round_layout`` (the moving layout that
puts each round's pairs at positions (2k, 2k + 1)), ``producer_tiles``
and ``consumer_rows`` (its static thread maps), ``eigh_plan`` (its
instantiation, thread split and shared memory), ``schur`` (its
rotation), ``jacobi_twin`` (the algorithm) and ``ring_replay`` (the
consumers' view of the ring).  It is built with the other
``csrc/*.cu`` sources by ``ops/pruning_cuda.build`` (one ``nvcc`` each,
at first use, into ``_build/``) and loaded with ``ctypes``.

``eigh_cuda`` launches the kernel, takes CUDA tensors only and counts its
launches in ``EIGH.launches``; ``eigh_plain`` is its plain version,
``torch.linalg.eigh`` in float64 on any device.  Both return float64,
and the kernel also reads float64:
the port keeps S > 8 eigensystems in float64 (an eigensystem rounded to
float32 moves a protein lnL by up to 0.08, ``ops/tiprobs.py``).
``symmetric_eigh`` sends a CUDA tensor to the kernel and a CPU tensor to
the plain version; there is no fallback from one to the other.  ``jacobi_twin`` is the kernel's
algorithm in numpy (the same round-robin schedule, rotations, exact
annihilation, upper-triangle update and stopping rule), which the CPU
tests hold against LAPACK.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .pruning_cuda import (check_cuda_operands, device_index, launch_error,
                           library)

MIN_S, MAX_S = 9, 64
# csrc/eigh.cu's kMaxSweeps and kTol: sweeps stop when the off-diagonal
# Frobenius norm is at most TOL times the whole matrix's, or after
# MAX_SWEEPS
MAX_SWEEPS = 20
TOL = 1e-12
# csrc/eigh.cu's Split<S>: the instantiation (0: runtime S) -> (producer
# threads, consumer warps); and kRing, the rounds in flight between them
SPLITS = {20: (64, 5), 61: (512, 8), 0: (256, 8)}
RING = 8


class _Launches:
    """The kernel's launch count (a plain integer, reset by callers that
    read one run's launches)."""

    def __init__(self):
        self.launches = 0


EIGH = _Launches()


def round_pairs(n: int, r: int) -> list[tuple[int, int]]:
    """Round r (0 <= r < n - 1) of the circle (round-robin) schedule of an
    even number n of indices: n / 2 disjoint pairs (p < q), index n - 1
    fixed and the others turning; every pair occurs once in the n - 1
    rounds of a sweep (the Python twin of ``csrc/eigh.cu:round_pair``)."""
    out = []
    for k in range(n // 2):
        if k == 0:
            a, b = r, n - 1
        else:
            a, b = (r + k) % (n - 1), (r - k + n - 1) % (n - 1)
        out.append((min(a, b), max(a, b)))
    return out


def next_pos(n: int) -> np.ndarray:
    """The moving layout's step (``csrc/eigh.cu:next_pos``), int [n]: after
    a round the label at position x moves to position next_pos[x], so
    that the next round's pairs sit at positions (2k, 2k + 1) again."""
    x = np.arange(n)
    out = np.where(x & 1, x + 2, x - 2)
    out[[0, 1, 2, n - 1]] = [3, 1, 0, n - 2]
    return out


def label_of(n: int) -> np.ndarray:
    """Round 0's layout (``csrc/eigh.cu:label_of``), int [n]: the label
    (index of A) at each position."""
    x = np.arange(n)
    out = np.where(x & 1, n - 1 - (x >> 1), x >> 1)
    out[[0, 1]] = [0, n - 1]
    return out


def round_layout(n: int, r: int) -> np.ndarray:
    """The labels at each position in round r: round 0's layout moved r
    times by ``next_pos``; slot k rotates (layout[2k], layout[2k + 1])."""
    lay, step = label_of(n), next_pos(n)
    for _ in range(r):
        moved = np.empty_like(lay)
        moved[step] = lay
        lay = moved
    return lay


def instantiation(S: int) -> int:
    """The kernel instantiation that takes S states (0: runtime S)."""
    return S if S in SPLITS else 0


def eigh_plan(S: int) -> dict:
    """What ``csrc/eigh.cu:mb_eigh_plan`` reports for S states: the
    instantiation, producer threads, consumer warps, threads of a block
    and dynamic shared memory in bytes (``layout``: two n x n buffers of
    A, the ring's (c, s), the norm partials, the mbarriers and the ring's
    rounds)."""
    inst = instantiation(S)
    producers, warps = SPLITS[inst]
    n = S + (S & 1)
    smem = (8 * 2 * n * n + 16 * RING * (n // 2) + 8 * 2 * (producers // 32)
            + 8 * 2 * RING + 4 * RING)
    return {"instantiation": inst, "producers": producers,
            "consumer_warps": warps, "threads": producers + 32 * warps,
            "smem_bytes": smem}


def producer_tiles(S: int, producers: int) -> list[list[tuple[int, int]]]:
    """The producers' static map: thread t's tiles (k, l), k < l (rows 2k,
    2k + 1 and columns 2l, 2l + 1 of the moving layout), in the kernel's
    enumeration (k-major), the t-th, (t + producers)-th, ... of them."""
    half = (S + (S & 1)) // 2
    tiles = [(k, l) for k in range(half) for l in range(k + 1, half)]
    return [tiles[t::producers] for t in range(producers)]


def consumer_rows(S: int, warps: int) -> list[range]:
    """The consumers' static map: the rows of V each consumer warp holds
    in registers (its lane k positions 2k and 2k + 1 of each)."""
    per = -(-S // warps)
    return [range(w * per, min(S, (w + 1) * per)) for w in range(warps)]


def schur(app, aqq, apq):
    """(c, s, t) of the symmetric 2x2 Schur rotations of (app, apq; apq,
    aqq), elementwise, in ``csrc/eigh.cu:schur``'s form (two reciprocal
    square roots after an exact power-of-two scaling; the identity where
    apq = 0): t = sign(tau) / (|tau| + sqrt(1 + tau^2)), tau = (aqq -
    app) / (2 apq), c = 1 / sqrt(1 + t^2), s = t c."""
    rot = apq != 0.0
    d, e = aqq - app, 2.0 * apq
    k = np.frexp(np.maximum(np.abs(d), np.abs(e)))[1] - 1
    ds, es = np.ldexp(d, -k), np.ldexp(e, -k)
    with np.errstate(all="ignore"):          # where apq = 0, discarded
        rh = 1.0 / np.sqrt(ds * ds + es * es)
        c2 = 0.5 + 0.5 * (np.abs(ds) * rh)
        rc = 1.0 / np.sqrt(c2)
        sg = np.where((d == 0.0) | ((d > 0.0) == (e > 0.0)), 1.0, -1.0)
        c = c2 * rc
        s = sg * (0.5 * (np.abs(es) * rh)) * rc
        t = s * rc
    return (np.where(rot, c, 1.0), np.where(rot, s, 0.0),
            np.where(rot, t, 0.0))


def jacobi_twin(A: np.ndarray, log: list | None = None):
    """The kernel's algorithm on one symmetric matrix [S, S], in float64
    and in its order of operations: A's lower triangle, padded to an even
    n with a zero row and column, kept as its upper triangle; swept in
    the circle schedule, slot k of round r rotating the pair
    (``round_layout(n, r)[2k]``, ``[2k + 1]``) in that order; each
    round's rotations (``schur``) computed from their diagonal blocks,
    whose new diagonals and a_pq = 0 they write, then the tiles k < l
    rotated (rows by J_k, then columns by J_l), then V's columns; the
    norms over the upper triangle before each sweep, until the
    off-diagonal norm is at most TOL times the whole, or for MAX_SWEEPS
    sweeps.  Each round's (c, s) by slot, as the kernel publishes them to
    its consumer warps, is appended to ``log``.  Returns (w [S], V [S, S],
    sweeps).  The kernel keeps A and V in the moving layout, which moves
    values and not the operations on them; its fused multiply-adds and
    rsqrt round differently, so the two agree to rounding, not bits."""
    S = A.shape[0]
    n = S + (S & 1)
    half = n // 2
    a = np.zeros((n, n))
    a[:S, :S] = np.triu(np.asarray(A, np.float64).T)
    v = np.eye(n)
    tiles = np.array([(k, l) for k in range(half)
                      for l in range(k + 1, half)]).reshape(-1, 2)
    K, L = tiles[:, 0], tiles[:, 1]
    iu = np.triu_indices(n, 1)
    layouts = [round_layout(n, r) for r in range(n - 1)]

    def up(i, j):
        return np.minimum(i, j), np.maximum(i, j)

    sweeps = 0
    while sweeps < MAX_SWEEPS:
        o2 = np.sum(a[iu] ** 2)
        if 2.0 * o2 <= TOL * TOL * (2.0 * o2 + np.sum(np.diag(a) ** 2)):
            break
        for lay in layouts:
            p, q = lay[0::2], lay[1::2]
            app, aqq, apq = a[p, p], a[q, q], a[up(p, q)]
            c, s, t = schur(app, aqq, apq)
            a[p, p] = app - t * apq
            a[q, q] = aqq + t * apq
            a[up(p, q)] = 0.0
            P, Q, U, W = p[K], q[K], p[L], q[L]
            ck, sk, cl, sl = c[K], s[K], c[L], s[L]
            ipu, ipv, iqu, iqv = up(P, U), up(P, W), up(Q, U), up(Q, W)
            apu, apv, aqu, aqv = a[ipu], a[ipv], a[iqu], a[iqv]
            bpu, bpv = ck * apu - sk * aqu, ck * apv - sk * aqv
            bqu, bqv = sk * apu + ck * aqu, sk * apv + ck * aqv
            a[ipu] = cl * bpu - sl * bpv
            a[ipv] = sl * bpu + cl * bpv
            a[iqu] = cl * bqu - sl * bqv
            a[iqv] = sl * bqu + cl * bqv
            vu, vv = v[:S, p], v[:S, q]
            v[:S, p], v[:S, q] = c * vu - s * vv, s * vu + c * vv
            if log is not None:
                log.append((c, s))
        sweeps += 1
    return np.diag(a)[:S].copy(), v[:S, :S].copy(), sweeps


def ring_replay(S: int, log: list, warps: int, rng: np.random.Generator,
                ring: int = RING, wait_release: bool = True) -> np.ndarray:
    """V [S, S] as the consumer warps build it from the rounds the
    producers publish (``log``, then the end): the producer fills a ring
    of ``ring`` slots, reusing a slot only after every warp has released
    it (a warp releases a slot once it has read the round's (c, s)), and
    each warp, at random moments, applies its next round to the rows it
    holds in the moving layout (lane k: positions 2k and 2k + 1), in the
    kernel's arithmetic, then moves them by ``next_pos`` (its shuffles).
    At the end the rows go back to labels through round 0's layout.
    Raises if a warp reads a slot that was overwritten before it released
    it (``wait_release=False`` lets the producer reuse slots without
    waiting, as a kernel without its empty barriers would)."""
    n = S + (S & 1)
    lab, step = label_of(n), next_pos(n)
    rows = consumer_rows(S, warps)
    held = [np.array([lab == i for i in rr], float).reshape(len(rr), n)
            for rr in rows]              # [rows of the warp, positions]
    msgs = list(log) + [None]            # None: the end of the loop
    slots = [None] * ring                # (message index, payload)
    released = [set(range(warps)) for _ in range(ring)]
    nxt = [0] * warps                    # each warp's next message
    pub = 0
    while min(nxt) < len(msgs):
        free = pub < len(msgs) and (len(released[pub % ring]) == warps
                                    or not wait_release)
        ready = [w for w in range(warps) if nxt[w] < pub]
        if not free and not ready:
            raise AssertionError(f"the ring stalls at message {pub}")
        if free and (not ready or rng.random() < 0.5):
            slots[pub % ring], released[pub % ring] = (pub, msgs[pub]), set()
            pub += 1
            continue
        w = int(rng.choice(ready))
        m = nxt[w]
        idx, msg = slots[m % ring]
        if idx != m:
            raise AssertionError(f"warp {w} reads message {idx} for {m}")
        released[m % ring].add(w)
        nxt[w] += 1
        if msg is not None:
            c, s = msg
            ve, vo = held[w][:, 0::2], held[w][:, 1::2]
            moved = np.empty_like(held[w])
            moved[:, step[0::2]] = c * ve - s * vo
            moved[:, step[1::2]] = s * ve + c * vo
            held[w] = moved
    v = np.zeros((S, n))
    for rr, h in zip(rows, held):
        v[list(rr)] = h[:, np.argsort(lab)]
    return v[:, :S].copy()


def check_eigh_operand(A: torch.Tensor) -> tuple[int, int]:
    """Raise unless A is float64 [B, S, S] with MIN_S <= S <= MAX_S;
    returns (B, S)."""
    if A.dtype != torch.float64:
        raise TypeError(f"eigh_cuda takes float64, got {A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"eigh_cuda takes [B, S, S], got {tuple(A.shape)}")
    B, S = A.shape[0], A.shape[1]
    if not MIN_S <= S <= MAX_S:
        raise ValueError(f"eigh_cuda takes {MIN_S} <= S <= {MAX_S}, got {S}")
    if B < 1 or B > 2 ** 31 - 1:
        raise ValueError(f"eigh_cuda takes 1 <= B < 2**31, got {B}")
    return B, S


def eigh_launch(A, w, V, sweeps, before: bool = False) -> int:
    """One raw launch of ``csrc/eigh.cu`` on preallocated outputs (w
    [B, S] and V [B, S, S] float64, sweeps int32 [B] or None) on the
    current stream of A's device; ``before`` launches the kept first
    design (``mb_eigh_jacobi_before``), which only ``chip_smoke.py`` and
    the ``gpu`` tests time and compare.  Returns the CUDA error code (0 =
    success)."""
    B, S = A.shape[0], A.shape[1]
    dev = A.device
    lib = library("eigh").lib
    fn = lib.mb_eigh_jacobi_before if before else lib.mb_eigh_jacobi
    return fn(A.data_ptr(), w.data_ptr(), V.data_ptr(),
              None if sweeps is None else sweeps.data_ptr(), B, S,
              device_index(dev), torch.cuda.current_stream(dev).cuda_stream)


def device_plan(S: int) -> dict:
    """``eigh_plan``'s numbers as the built kernel library reports them
    (``mb_eigh_plan``); needs the library, so a GPU machine."""
    out = (ctypes.c_int * 5)()
    err = library("eigh").lib.mb_eigh_plan(S, out)
    if err != 0:
        raise launch_error(library("eigh").lib, err, "mb_eigh_plan")
    return dict(zip(("instantiation", "producers", "consumer_warps",
                     "threads", "smem_bytes"), list(out)))


def eigh_cuda(A: torch.Tensor, with_sweeps: bool = False):
    """Launch the CUDA eigensolver on symmetric float64 A [B, S, S]
    (contiguous, on a CUDA device).  Returns float64 (w [B, S], V [B, S,
    S]) with A = V diag(w) V^T, eigenvalues unsorted, plus the sweeps
    each matrix took (int32 [B]) with ``with_sweeps``.  Raises on
    anything the kernel does not take, and when the launch is refused."""
    B, S = check_eigh_operand(A)
    check_cuda_operands("eigh_cuda", A=A)
    w = torch.empty((B, S), dtype=torch.float64, device=A.device)
    V = torch.empty((B, S, S), dtype=torch.float64, device=A.device)
    sweeps = torch.empty(B, dtype=torch.int32, device=A.device) \
        if with_sweeps else None
    err = eigh_launch(A, w, V, sweeps)
    if err != 0:
        raise launch_error(library("eigh").lib, err, "eigh_cuda")
    EIGH.launches += 1
    return (w, V, sweeps) if with_sweeps else (w, V)


def eigh_plain(A: torch.Tensor):
    """The plain version of ``eigh_cuda``: ``torch.linalg.eigh`` in
    float64 on any device (eigenvalues ascending, an order the kernel does
    not keep)."""
    return torch.linalg.eigh(A.double())


def symmetric_eigh(A: torch.Tensor):
    """Float64 (w [..., S], V [..., S, S]) of symmetric A [..., S, S]: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    S = A.shape[-1]
    if not A.is_cuda:
        return eigh_plain(A)
    flat = A.reshape(-1, S, S).double().contiguous()
    w, V = eigh_cuda(flat)
    return w.reshape(A.shape[:-1]), V.reshape(A.shape)
