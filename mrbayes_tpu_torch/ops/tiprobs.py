"""Transition-probability matrices P(t) = exp(Qt).

Reversible Q is similar to a symmetric matrix: with D = diag(pi),
B = D^{1/2} Q D^{-1/2} is symmetric, so a symmetric eigensolver gives a
real spectrum and P(t) = D^{-1/2} V exp(Λt) Vᵀ D^{1/2} (replacing the
reference's EISPACK path, src/utils.c:11201 GetEigens, :14064
TiProbsUsingEigens); ``expm_pade`` is the scaling-and-squaring
exponential of any generator.
"""
from __future__ import annotations

import torch

from .eigh_cuda import MAX_S, symmetric_eigh
from .jacobi import jacobi_eigh


def eigh_reversible(Q: torch.Tensor, pi: torch.Tensor):
    """Decompose a (batched) reversible generator.

    Returns (lam, U, Uinv) with Q = U diag(lam) Uinv, all real.  Up to 8
    states (nucleotide, binary, standard) use the fixed-sweep Jacobi
    solver, in Q's dtype; 9 to 64 states (protein 20, codon 61) the
    batched Jacobi eigensolver of ``ops/eigh_cuda.py`` (its CUDA kernel on
    the card, its plain version on the CPU), and the eigensystem stays in
    float64: rounded to float32, U and Uinv carry absolute errors of about
    6e-8 |U| |Uinv| into every P(t) entry, which at S = 20 swamps the
    transition probabilities below about 1e-6 and moved an avian
    (89-taxon protein) lnL by up to 0.08 from an exact evaluation, against
    6e-4 kept in float64 (``tests/test_torch_protein.py``).  Neither
    solver synchronises with the host on the card.  Larger state spaces
    raise.
    """
    s = Q.shape[-1]
    if s > MAX_S:
        raise NotImplementedError(
            f"{s}-state eigensystems: the port's eigensolvers take at most "
            f"{MAX_S} states")
    sq = torch.sqrt(pi.clamp_min(1e-30))
    B = Q * (sq[..., :, None] / sq[..., None, :])
    B = 0.5 * (B + B.transpose(-1, -2))  # symmetrize numerical noise
    if s <= 8:
        lam, V = jacobi_eigh(B)
    else:
        lam, V = symmetric_eigh(B)
        sq = sq.double()
    U = V / sq[..., :, None]
    Uinv = V.transpose(-1, -2) * sq[..., None, :]
    return lam, U, Uinv


def transition_probs(lam: torch.Tensor, U: torch.Tensor, Uinv: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """P(t) for a batch of effective branch lengths.

    lam/U/Uinv: [..., s] / [..., s, s]; t: [...] broadcastable against the
    batch.  Returns [..., s, s], clipped to [0, 1], in the eigensystem's
    dtype.
    """
    elt = torch.exp(lam * t[..., None])               # [..., s]
    P = (U * elt[..., None, :]) @ Uinv
    return P.clamp(0.0, 1.0)


def expm_pade(A: torch.Tensor, squarings: int = 8) -> torch.Tensor:
    """Scaling-and-squaring matrix exponential of a (batched) generator
    times a branch length, with a sixth-order Taylor core
    (mrbayes_tpu/ops/tiprobs.py:55; reference fallback src/utils.c:10332
    ComputeMatrixExponential): adequate for normalised generators times
    moderate branch lengths, and a check on ``transition_probs`` for
    generators that are not reversible."""
    X = A / 2.0 ** squarings
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    term = eye.expand_as(A)
    out = term
    for k in range(1, 7):
        term = term @ X / k
        out = out + term
    for _ in range(squarings):
        out = out @ out
    return out
