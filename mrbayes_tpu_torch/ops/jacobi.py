"""Batched fixed-sweep Jacobi eigensolver for small symmetric matrices.

The MCMC loop eigendecomposes one s×s (s=2..8) symmetrized generator per
chain whenever a move changes Q.  ``torch.linalg.eigh`` on CUDA checks its
``info`` output on the host, which would synchronise the generation loop.
Cyclic Jacobi with a fixed sweep count is a short straight-line sequence
of batched s×s products: per sweep, one Givens rotation per off-diagonal
pair.  4-8 sweeps reach float32 round-off for s<=8 (quadratic
convergence).
"""
from __future__ import annotations

import torch


def jacobi_eigh(A: torch.Tensor, sweeps: int | None = None):
    """Eigendecomposition of a batch of small symmetric matrices.

    A: [..., s, s] symmetric.  Returns (eigvals [..., s], V [..., s, s])
    with A = V diag(w) V^T (columns of V are eigenvectors).
    """
    s = A.shape[-1]
    if sweeps is None:
        sweeps = 4 if s <= 4 else (6 if s <= 6 else 8)
    eye = torch.eye(s, dtype=A.dtype, device=A.device)
    V = eye.expand(A.shape)
    pairs = [(p, q) for p in range(s) for q in range(p + 1, s)]
    # per pair: G = I + (c-1)(e_p e_p^T + e_q e_q^T) + sn(e_p e_q^T - e_q e_p^T)
    diag_pq = {pq: torch.outer(eye[pq[0]], eye[pq[0]])
               + torch.outer(eye[pq[1]], eye[pq[1]]) for pq in pairs}
    skew_pq = {pq: torch.outer(eye[pq[0]], eye[pq[1]])
               - torch.outer(eye[pq[1]], eye[pq[0]]) for pq in pairs}
    for _ in range(sweeps):
        for (p, q) in pairs:
            app = A[..., p, p]
            aqq = A[..., q, q]
            apq = A[..., p, q]
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c = torch.cos(theta)
            sn = torch.sin(theta)
            G = (eye + (c - 1.0)[..., None, None] * diag_pq[(p, q)]
                 + sn[..., None, None] * skew_pq[(p, q)])
            A = G.transpose(-1, -2) @ A @ G
            V = V @ G
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    return w, V
