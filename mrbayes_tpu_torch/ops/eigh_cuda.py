"""Batched symmetric eigensolver for 9 <= S <= 64 states as a hand-written
CUDA kernel.

Counterpart of ``jnp.linalg.eigh`` in ``mrbayes_tpu/ops/tiprobs.py:34``,
which the JAX package calls for the protein (S = 20) and codon (S = 61)
eigensystems; it is not a port of a Pallas kernel.  The port needs its
own because ``torch.linalg.eigh`` on a CUDA tensor checks its ``info``
output on the host: every Q move would synchronise the generation loop.
The fixed-sweep Jacobi of ``ops/jacobi.py`` (S <= 8) runs one Givens
rotation per pair as separate PyTorch ops, about 15,000 launches a
refresh at S = 20.

The kernel source is ``csrc/eigh.cu``; its header records what bounds it
on an H100 and what its design does about that.  It is built with the
other ``csrc/*.cu`` sources by ``ops/pruning_cuda.build`` (one ``nvcc``
each, at first use, into ``_build/``) and loaded with ``ctypes``.

``eigh_cuda`` launches the kernel, takes CUDA tensors only and counts its
launches in ``EIGH.launches``; ``eigh_plain`` is its plain version,
``torch.linalg.eigh`` in float64 on any device.  Both return float64,
and the kernel also reads float64:
the port keeps S > 8 eigensystems in float64 (an eigensystem rounded to
float32 moves a protein lnL by up to 0.08, ``ops/tiprobs.py``).  ``symmetric_eigh`` sends
a CUDA tensor to the kernel and a CPU tensor to the plain version; there
is no fallback from one to the other.  ``jacobi_twin`` is the kernel's
algorithm in numpy (the same round-robin schedule, rotations, exact
annihilation and stopping rule), which the CPU tests hold against LAPACK.
"""
from __future__ import annotations

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


def jacobi_twin(A: np.ndarray):
    """The kernel's algorithm on one symmetric matrix [S, S], in float64:
    padded to an even n with a zero row and column, swept in the circle
    schedule, each round's n / 2 rotations applied together as
    A <- J^T A J and V <- V J with the rotated pairs' off-diagonal entries
    set to 0, until the off-diagonal norm is at most TOL times the
    whole, or for MAX_SWEEPS sweeps.  Returns (w [S], V [S, S], sweeps)."""
    S = A.shape[0]
    n = S + (S & 1)
    a = np.zeros((n, n))
    a[:S, :S] = A
    v = np.eye(n)
    sweeps = 0
    while sweeps < MAX_SWEEPS:
        sq = a[:S, :S] ** 2
        off = sq[~np.eye(S, dtype=bool)].sum()
        if off <= TOL * TOL * sq.sum():
            break
        for r in range(n - 1):
            pairs = round_pairs(n, r)
            J = np.eye(n)
            diag = []
            for p, q in pairs:
                apq = a[p, q]
                c, s, t = 1.0, 0.0, 0.0
                if apq != 0.0:
                    tau = (a[q, q] - a[p, p]) / (2.0 * apq)
                    t = (1.0 if tau >= 0.0 else -1.0) / (
                        abs(tau) + np.sqrt(1.0 + tau * tau))
                    c = 1.0 / np.sqrt(1.0 + t * t)
                    s = t * c
                J[p, p] = J[q, q] = c
                J[p, q], J[q, p] = s, -s
                diag.append((p, q, a[p, p] - t * apq, a[q, q] + t * apq))
            a = J.T @ a @ J
            for p, q, app, aqq in diag:
                a[p, p], a[q, q] = app, aqq
                a[p, q] = a[q, p] = 0.0
            v = v @ J
        sweeps += 1
    return np.diag(a)[:S].copy(), v[:S, :S].copy(), sweeps


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


def eigh_launch(A, w, V, sweeps) -> int:
    """One raw launch of ``csrc/eigh.cu`` on preallocated outputs (w
    [B, S] and V [B, S, S] float64, sweeps int32 [B] or None) on the
    current stream of A's device.  Returns the CUDA error code (0 =
    success)."""
    B, S = A.shape[0], A.shape[1]
    dev = A.device
    return library("eigh").lib.mb_eigh_jacobi(
        A.data_ptr(), w.data_ptr(), V.data_ptr(),
        None if sweeps is None else sweeps.data_ptr(), B, S,
        device_index(dev), torch.cuda.current_stream(dev).cuda_stream)


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
