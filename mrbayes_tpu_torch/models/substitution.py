"""Substitution-model Q matrices (batched torch).

Reversible Q construction for nucleotide models (nst=1/2/6), binary
(restriction) data and any reversible exchangeability vector, and the
Tuffley-Steel covarion generator over a doubled state space.  All Q
matrices are normalized to one expected substitution per unit branch
length: ``-sum_i pi_i Q_ii = 1`` (reference: src/likelihood.c:8166
SetNucQMatrix behavior).  Every function
takes leading batch dims (the chain axis) on its tensor arguments.
"""
from __future__ import annotations

import numpy as np
import torch


def reversible_q(exchange: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """Normalized reversible Q from exchangeabilities r_ij [..., n(n-1)/2]
    (upper-triangle order: for DNA AC, AG, AT, CG, CT, GT, the reference
    revmat order) and stationary frequencies pi [..., n]:
    Q_ij = r_ij * pi_j (i != j), rows sum to 0, mean rate 1.  The pair
    index is built on the device, so a call makes no host transfer."""
    n = pi.shape[-1]
    iu = torch.triu_indices(n, n, 1, device=pi.device)
    R = exchange.new_zeros(exchange.shape[:-1] + (n, n))
    R[..., iu[0], iu[1]] = exchange
    R = R + R.transpose(-1, -2)
    Q = R * pi[..., None, :]
    diag = -Q.sum(-1)
    Q = Q + torch.diag_embed(diag)
    mu = -(pi * diag).sum(-1)
    return Q / mu[..., None, None]


def nuc_q_nst1(pi: torch.Tensor) -> torch.Tensor:
    """JC-style (F81): all exchangeabilities equal."""
    return reversible_q(pi.new_ones(pi.shape[:-1] + (6,)), pi)


def nuc_q_nst2(kappa: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """HKY85: transitions (AG, CT) get rate kappa (tratio)."""
    one = torch.ones_like(kappa)
    # order AC, AG, AT, CG, CT, GT; transitions at 1 (AG) and 4 (CT)
    ex = torch.stack([one, kappa, one, one, kappa, one], -1)
    return reversible_q(ex, pi)


def nuc_q_gtr(revmat: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """GTR: 6 exchangeabilities (scale is irrelevant after
    normalization)."""
    return reversible_q(revmat, pi)


def binary_q(pi: torch.Tensor) -> torch.Tensor:
    """2-state (restriction/binary) model: the one exchangeability of the
    pair, normalised to mean rate 1 under ``pi`` [..., 2]."""
    return reversible_q(pi.new_ones(pi.shape[:-1] + (1,)), pi)


def covarion_q(qnorm: torch.Tensor, pi: torch.Tensor, s01, s10,
               rate=1.0):
    """Tuffley-Steel covarion generators over a doubled state space
    [on-states, off-states] (mrbayes_tpu/models/substitution.py:136;
    reference src/likelihood.c:8269-8420 for the 8 x 8 nucleotide case,
    :8941 for the 40 x 40 protein case).

    ``qnorm`` [..., S, S] is the base reversible generator normalised to
    mean rate 1 under its stationary ``pi`` [..., S].  The substitution
    block is scaled by ``rate / probOn`` (probOn = s01 / (s01 + s10)), so
    the covarion process has mean rate 1 at a unit ``rate``; a rate
    category scales the substitution block only, the switch rates are the
    same in every category (the reason for one eigensystem a category,
    TiProbs_GenCov src/likelihood.c:9568).  ``s01``, ``s10`` and ``rate``
    broadcast against the batch dims (tensors [...] or floats).

    Returns (Q_cov [..., 2S, 2S], pi_cov [..., 2S]); the process is
    reversible under pi_cov, so ``eigh_reversible`` applies."""
    s = qnorm.shape[-1]
    s01 = torch.as_tensor(s01, dtype=qnorm.dtype, device=qnorm.device)
    s10 = torch.as_tensor(s10, dtype=qnorm.dtype, device=qnorm.device)
    rate = torch.as_tensor(rate, dtype=qnorm.dtype, device=qnorm.device)
    prob_on = s01 / (s01 + s10)
    eye = torch.eye(s, dtype=qnorm.dtype, device=qnorm.device)
    off = qnorm * (1.0 - eye) * (rate / prob_on)[..., None, None]
    top_left = off - eye * (off.sum(-1) + s10[..., None])[..., None]
    top = torch.cat([top_left, (eye * s10[..., None, None]).expand_as(off)],
                    -1)
    bot = torch.cat([(eye * s01[..., None, None]).expand_as(off),
                     (-eye * s01[..., None, None]).expand_as(off)], -1)
    Q = torch.cat([top, bot], -2)
    pi_cov = torch.cat([pi * prob_on[..., None],
                        pi * (1.0 - prob_on)[..., None]], -1)
    return Q, pi_cov


def mk_q(n_states: int, pi: torch.Tensor | None = None, device=None,
         dtype=torch.float32) -> torch.Tensor:
    """Lewis Mk model for standard (morphology) data: equal rates between
    every pair of states; ``pi`` [..., n_states] defaults to equal
    frequencies."""
    if pi is None:
        pi = torch.full((n_states,), 1.0 / n_states, dtype=dtype,
                        device=device)
    return reversible_q(pi.new_ones(pi.shape[:-1]
                                    + (n_states * (n_states - 1) // 2,)), pi)


def ordered_mk_q(n_states: int, pi: torch.Tensor | None = None,
                 device=None, dtype=torch.float32) -> torch.Tensor:
    """Ordered Mk model (``ctype ordered``): only adjacent states exchange,
    q_ij = pi_j for |i - j| = 1, rescaled to mean rate 1 (reference
    SetStdQMatrix ordered branch, src/likelihood.c:9257-9272).  A
    reversible generator whose exchangeabilities are 1 on the adjacent
    pairs and 0 elsewhere."""
    if pi is None:
        pi = torch.full((n_states,), 1.0 / n_states, dtype=dtype,
                        device=device)
    iu = torch.triu_indices(n_states, n_states, 1)
    adjacent = (iu[1] - iu[0] == 1).to(pi.dtype).to(pi.device)
    return reversible_q(adjacent.expand(pi.shape[:-1] + adjacent.shape),
                        pi)


def protein_q(exchange: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """Protein model from a 190-vector of exchangeabilities (an empirical
    model's or the sampled protein GTR's) and 20 frequencies."""
    return reversible_q(exchange, pi)


def codon_q(omega: torch.Tensor, kappa, pi: torch.Tensor,
            single: torch.Tensor, transition: torch.Tensor,
            nonsyn: torch.Tensor,
            cat_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Goldman-Yang / NY98 codon generators, one per omega class.

    q_ij = kappa^[transition] * omega^[nonsynonymous] * pi_j for codon
    pairs differing at one position, else 0 (reference
    src/likelihood.c SetNucQMatrix 61-state branch).  omega [..., K]
    (K = 1 for M0, 3 for NY98), kappa [...] or a float, pi [..., S];
    single/transition/nonsyn [S, S] boolean masks from
    ``CodonCode.pair_classes()``.  Returns [..., K, S, S].

    Normalisation: with ``cat_weights`` [..., K] every class is rescaled
    by the SAME factor, so that the class-weighted mean rate is 1 and the
    classes keep their relative speeds (reference: per-class dN + dS in
    SetNucQMatrix, one posScaler in UpDateCijk,
    src/likelihood.c:10688-10714); without weights each class has mean
    rate 1."""
    if torch.is_tensor(kappa):
        kappa = kappa[..., None, None, None]
    # a float kappa stays a Python scalar: a tensor made from it would be
    # a host-to-device copy in every Q move
    factor = (torch.where(transition, kappa, 1.0)
              * torch.where(nonsyn, omega[..., None, None], 1.0)
              * single)                                   # [..., K, S, S]
    pik = pi[..., None, :]                                # [..., 1, S]
    Q = factor * pik[..., None, :]
    diag = -Q.sum(-1)                                     # [..., K, S]
    Q = Q + torch.diag_embed(diag)
    mu = -(pik * diag).sum(-1)                            # [..., K]
    if cat_weights is not None:
        mu = (cat_weights * mu).sum(-1, keepdim=True)
    return Q / mu[..., None, None]


def _doublet_class_table() -> np.ndarray:
    """[16, 16] class of each doublet pair (mrbayes_tpu/models/
    substitution.py:168-190): 0-5 the GTR rate index of the one changing
    position (AC, AG, AT, CG, CT, GT), 6 where both positions change (rate
    0).  State order AA, AC, AG, AT, CA, ..., TT, first position major
    (reference doublet[] table, src/bayes.c:651-666)."""
    pair_idx = {frozenset((0, 1)): 0, frozenset((0, 2)): 1,
                frozenset((0, 3)): 2, frozenset((1, 2)): 3,
                frozenset((1, 3)): 4, frozenset((2, 3)): 5}
    cls = np.full((16, 16), 6, np.int64)
    for i in range(16):
        f1, s1 = divmod(i, 4)
        for j in range(16):
            f2, s2 = divmod(j, 4)
            if i != j and (f1 == f2 or s1 == s2):
                cls[i, j] = pair_idx[frozenset((f1, f2) if f1 != f2
                                               else (s1, s2))]
    return cls


DOUBLET_CLS = _doublet_class_table()


def doublet_q(rates6: torch.Tensor, pi16: torch.Tensor,
              classes: torch.Tensor) -> torch.Tensor:
    """16-state doublet (RNA stem) generators [..., 16, 16] (mrbayes_tpu/
    models/substitution.py:193-204): q_ij = r[class(i, j)] * pi_j for
    doublets that differ at one position, 0 where both differ, normalised
    to mean rate 1.  rates6 [..., 6] is the GTR vector: (1, k, 1, 1, k, 1)
    under nst=2 and ones under nst=1.  ``classes`` is ``DOUBLET_CLS`` on
    the operands' device (a copy from the host inside the generation loop
    would synchronise)."""
    r = torch.cat([rates6, rates6.new_zeros(rates6.shape[:-1] + (1,))], -1)
    Q = r[..., classes] * pi16[..., None, :]
    Q = Q - torch.diag_embed(Q.sum(-1))
    mu = -(pi16 * torch.diagonal(Q, dim1=-2, dim2=-1)).sum(-1)
    return Q / mu[..., None, None]
