"""Transition-probability matrices P(t) = exp(Qt).

Reversible Q is similar to a symmetric matrix: with D = diag(pi),
B = D^{1/2} Q D^{-1/2} is symmetric, so a symmetric eigensolver gives a
real spectrum and P(t) = D^{-1/2} V exp(Λt) Vᵀ D^{1/2} (replacing the
reference's EISPACK path, src/utils.c:11201 GetEigens, :14064
TiProbsUsingEigens).
"""
from __future__ import annotations

import torch

from .jacobi import jacobi_eigh


def eigh_reversible(Q: torch.Tensor, pi: torch.Tensor):
    """Decompose a (batched) reversible generator.

    Returns (lam, U, Uinv) with Q = U diag(lam) Uinv, all real.  Up to 8
    states (nucleotide, binary, standard) use the fixed-sweep Jacobi
    solver, which never synchronises with the host; larger spaces raise
    (protein and codon models come with a later slice of the port).
    """
    s = Q.shape[-1]
    if s > 8:
        raise NotImplementedError(
            f"{s}-state eigensystems (protein/codon models) are not ported "
            "yet (ROADMAP Queue 1 item 12)")
    sq = torch.sqrt(pi.clamp_min(1e-30))
    B = Q * (sq[..., :, None] / sq[..., None, :])
    B = 0.5 * (B + B.transpose(-1, -2))  # symmetrize numerical noise
    lam, V = jacobi_eigh(B)
    U = V / sq[..., :, None]
    Uinv = V.transpose(-1, -2) * sq[..., None, :]
    return lam, U, Uinv


def transition_probs(lam: torch.Tensor, U: torch.Tensor, Uinv: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """P(t) for a batch of effective branch lengths.

    lam/U/Uinv: [..., s] / [..., s, s]; t: [...] broadcastable against the
    batch.  Returns [..., s, s], clipped to [0, 1].
    """
    elt = torch.exp(lam * t[..., None])               # [..., s]
    P = (U * elt[..., None, :]) @ Uinv
    return P.clamp(0.0, 1.0)
