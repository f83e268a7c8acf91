"""Prior log-densities on tensors (batched over any leading axes).

The engine recomputes the prior component a move can change, so moves
never need analytic prior ratios — the acceptance ratio uses lnPrior
differences directly (replacing the reference's paired LnPriorProb*/
LnProbRatio* functions, src/utils.c:12701-13204).  Distribution
parameters are Python numbers (settings) unless stated otherwise.
"""
from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def _support(cond, val):
    return torch.where(cond, val, _NEG_INF)


def exponential_lpdf(x, rate):
    return _support(x > 0, math.log(rate) - rate * x)


def uniform_lpdf(x, lo, hi):
    return _support((x >= lo) & (x <= hi),
                    torch.full_like(x, -math.log(hi - lo)))


def gamma_lpdf(x, shape, rate):
    return _support(
        x > 0,
        shape * math.log(rate) - math.lgamma(shape)
        + (shape - 1.0) * torch.log(x.clamp_min(1e-35)) - rate * x)


def lognormal_lpdf(x, mu, sigma):
    lx = torch.log(x.clamp_min(1e-35))
    return _support(
        x > 0,
        -lx - math.log(sigma) - 0.5 * math.log(2 * math.pi)
        - 0.5 * ((lx - mu) / sigma) ** 2)


def normal_lpdf(x, mu, sigma):
    return (-math.log(sigma) - 0.5 * math.log(2 * math.pi)
            - 0.5 * ((x - mu) / sigma) ** 2)


def beta_lpdf(x, a, b):
    return _support(
        (x > 0) & (x < 1),
        math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
        + (a - 1) * torch.log(x.clamp_min(1e-35))
        + (b - 1) * torch.log((1 - x).clamp_min(1e-35)))


def dirichlet_lpdf(x, alpha):
    """x [..., K] on the simplex; alpha a tensor broadcastable to x."""
    lx = torch.log(x.clamp_min(1e-35))
    return (torch.lgamma(alpha.sum(-1)) - torch.lgamma(alpha).sum(-1)
            + ((alpha - 1.0) * lx).sum(-1))


def brlens_gammadir_lpdf(blens, mask, a_t, b_t, a_frac, c_int,
                         interior_mask=None):
    """Compound Dirichlet branch-length prior (Rannala, Zhu & Yang 2012),
    the reference default ``unconstrained:gammadir(1,0.1,1,1)``
    (src/bayes.c:806-820, src/utils.c LnPriorProbGammaDir).

    blens [..., n_nodes]; mask [n_nodes] bool (on blens' device) selects
    the free branches.
    p(b) = Gamma(T; a_t, b_t) * Dirichlet(b/T; alpha) / T^(n-1)
    with alpha = a_frac for external, a_frac*c_int for internal branches.
    """
    b = torch.where(mask, blens, 0.0)
    n = mask.sum()
    T = b.sum(-1)
    lT = torch.log(T.clamp_min(1e-35))
    lp_T = gamma_lpdf(T, a_t, b_t)
    if interior_mask is None:
        alpha = torch.where(mask, a_frac, 0.0)
    else:
        alpha = torch.where(
            mask, torch.where(interior_mask, a_frac * c_int, a_frac), 0.0)
    lfrac = torch.where(mask, torch.log(b.clamp_min(1e-35)) - lT[..., None],
                        0.0)
    lp_dir = (torch.lgamma(alpha.sum()) - torch.where(
        mask, torch.lgamma(alpha.clamp_min(1e-35)), 0.0).sum()
        + ((alpha - 1.0) * lfrac * mask).sum(-1))
    ok = torch.where(mask, blens > 0, True).all(-1)
    return _support(ok, lp_T + lp_dir - (n - 1.0) * lT)


def brlens_exponential_lpdf(blens, mask, rate):
    ok = torch.where(mask, blens > 0, True).all(-1)
    n = mask.sum()
    return _support(ok, n * math.log(rate)
                    - rate * torch.where(mask, blens, 0.0).sum(-1))


def brlens_uniform_lpdf(blens, mask, lo, hi):
    ok = torch.where(mask, (blens >= lo) & (blens <= hi), True).all(-1)
    n = mask.sum()
    return _support(ok, (-n * math.log(hi - lo)).to(blens.dtype))
