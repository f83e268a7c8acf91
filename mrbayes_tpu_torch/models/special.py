"""The symmetric beta's quantiles for symdirihyperpr (reference
BetaQuantile, src/utils.c:9651, and BetaBreaks, src/utils.c:9579;
mrbayes_tpu/models/special.py:99-133).

A binary standard character under a symmetric Dirichlet(beta) prior on its
state frequencies integrates over ``nbetacat`` discretized frequency
categories: the quantiles of Beta(beta, beta) at the categories'
midpoints.  beta is sampled per chain on the device, so the quantile is a
fixed number of Newton steps on the logit of the port's torch ``betainc``
(``models/rates.py``), in float64, with no data-dependent branch and no
host synchronisation.
"""
from __future__ import annotations

import torch

from .rates import betainc

# Newton steps of beta_quantile, as the JAX package takes
NEWTON_STEPS = 40
# continued-fraction terms of betainc: 256 hold it within 3e-9 of scipy
# over the symbeta move's whole range (beta in [1e-2, 1e4]; 64, M10's,
# lose 2e-3 at 1e4)
QUANTILE_TERMS = 256


def beta_quantile(p, a) -> torch.Tensor:
    """Quantile of the symmetric Beta(a, a) at probabilities ``p``, over
    broadcast p and a, in float64: Newton on the logit y of x = sigmoid(y)
    from the normal approximation's start (mean 1/2, variance
    1 / (4 (2a + 1))), each step (I_x(a, a) - p) / (pdf(x) x (1 - x))
    clipped to [-4, 4]."""
    p, a = torch.broadcast_tensors(torch.as_tensor(p).double(),
                                   torch.as_tensor(a).double())
    p = p.clamp(1e-6, 1.0 - 1e-6)
    x0 = (0.5 + torch.special.ndtri(p)
          * torch.sqrt(1.0 / (4.0 * (2.0 * a + 1.0)))).clamp(1e-4, 1 - 1e-4)
    y = torch.log(x0) - torch.log1p(-x0)
    lbeta = 2.0 * torch.lgamma(a) - torch.lgamma(2.0 * a)
    for _ in range(NEWTON_STEPS):
        x = torch.sigmoid(y)
        logdf = a * torch.log(x) + a * torch.log1p(-x) - lbeta
        step = (betainc(a, a, x, QUANTILE_TERMS) - p) * torch.exp(-logdf)
        y = y - step.clamp(-4.0, 4.0)
    return torch.sigmoid(y)


def beta_category_freqs(a, k: int) -> torch.Tensor:
    """[..., k] the symmetric Beta(a, a) quantiles at the midpoints
    (i + 1/2) / k of k equal-probability categories, float64: the state-0
    frequencies of a symdirihyperpr binary character's k categories."""
    a = torch.as_tensor(a).double()
    mid = (torch.arange(k, dtype=torch.float64, device=a.device) + 0.5) / k
    return beta_quantile(mid, a[..., None])
