"""Among-site rate variation: the discrete-gamma rate table, and the
discretized beta of codon model M10.

The MCMC loop needs category rates for a *sampled* shape parameter every
generation.  scipy builds a table of mean-of-category gamma rates on the
host once (reference DiscreteGamma, src/utils.c:10500); a torch gather
plus linear interpolation in log(alpha) reads it on the device.  M10's
beta classes need the quantiles of Beta(a, b) for sampled a and b:
``beta_quantile_breaks`` bisects on ``betainc``, the regularized
incomplete beta function in torch ops (torch has none), with no host
synchronisation.
"""
from __future__ import annotations

import numpy as np
import torch


class GammaRateTable:
    """Precomputed mean-of-category gamma rates, log-interpolated in alpha.

    Rates vary smoothly in log(alpha), so a 1024-point table with linear
    interpolation reproduces them to ~1e-5 with one gather per call.
    """

    def __init__(self, k: int, n: int = 1024, lo: float = 5e-4,
                 hi: float = 300.0, device=None):
        from scipy.stats import gamma as gdist
        self.k, self.lo, self.hi = k, lo, hi
        alphas = np.logspace(np.log10(lo), np.log10(hi), n)
        table = np.zeros((n, k))
        for i, a in enumerate(alphas):
            cuts = gdist.ppf(np.arange(1, k) / k, a, scale=1.0 / a)
            cdf = gdist.cdf(np.r_[0, cuts * a, np.inf], a + 1)
            r = k * np.diff(cdf)
            table[i] = r * (k / r.sum())
        self.log_lo = float(np.log(lo))
        self.step = float((np.log(hi) - np.log(lo)) / (n - 1))
        self.table = torch.as_tensor(table, dtype=torch.float32,
                                     device=device)
        self.n = n

    def __call__(self, alpha: torch.Tensor) -> torch.Tensor:
        """alpha [...] -> category rates [..., k]."""
        x = (torch.log(alpha.clamp(self.lo, self.hi)) - self.log_lo) \
            / self.step
        i0 = torch.floor(x).long().clamp(0, self.n - 2)
        f = (x - i0)[..., None]
        return self.table[i0] * (1.0 - f) + self.table[i0 + 1] * f


# terms of betainc's continued fraction: a power of 2 (the product of the
# terms' 2x2 matrices is taken pairwise); 64 keep |betainc - scipy| below
# 1e-13 for a, b in [0.05, 20] (32 give 1.5e-10)
BETAINC_TERMS = 64
# bisection steps of beta_quantile_breaks, as the JAX package takes
BISECT_STEPS = 40


def betainc(a, b, x):
    """The regularized incomplete beta function I_x(a, b), elementwise over
    broadcast a, b, x, in float64 (Numerical Recipes 6.4: the continued
    fraction of I_x(a, b) where x < (a + 1) / (a + b + 2), else
    1 - I_{1-x}(b, a)).  The fraction's first ``BETAINC_TERMS`` convergents come
    from the product of the recurrence's 2x2 matrices, taken pairwise in
    log2(BETAINC_TERMS) batched matmuls, each level rescaled to its largest
    entry (the value is a ratio of the product's entries): a fixed number
    of launches and no data-dependent branch."""
    a, b, x = torch.broadcast_tensors(torch.as_tensor(a).double(),
                                      torch.as_tensor(b).double(),
                                      torch.as_tensor(x).double())
    swap = x > (a + 1.0) / (a + b + 2.0)
    p = torch.where(swap, b, a)
    q = torch.where(swap, a, b)
    y = torch.where(swap, 1.0 - x, x)
    j = torch.arange(1, BETAINC_TERMS, dtype=torch.float64, device=x.device)
    m = torch.floor(j / 2)
    p_, q_ = p[..., None], q[..., None]
    # the partial numerators d_j: j = 2m, m(q - m) y / ((p + 2m - 1)(p + 2m));
    # j = 2m + 1, -(p + m)(p + q + m) y / ((p + 2m)(p + 2m + 1))
    even = m * (q_ - m) / ((p_ + 2 * m - 1) * (p_ + 2 * m))
    odd = -(p_ + m) * (p_ + q_ + m) / ((p_ + 2 * m) * (p_ + 2 * m + 1))
    d = torch.where(j % 2 == 0, even, odd) * y[..., None]
    num = torch.cat([torch.ones_like(y)[..., None], d], -1)
    one = torch.ones_like(num)
    # [A_k, A_k-1] = [A_k-1, A_k-2] [[1, 1], [num_k, 0]], A_0 = 0, B_0 = 1
    mats = torch.stack([one, one, num, torch.zeros_like(num)], -1).reshape(
        num.shape + (2, 2))
    while mats.shape[-3] > 1:
        mats = mats[..., 0::2, :, :] @ mats[..., 1::2, :, :]
        mats = mats / mats.abs().amax((-1, -2), keepdim=True)
    frac = mats[..., 0, 1, 0] / mats[..., 0, 0, 0]
    lbeta = torch.lgamma(p) + torch.lgamma(q) - torch.lgamma(p + q)
    front = torch.exp(p * torch.log(y) + q * torch.log1p(-y) - lbeta) / p
    i_x = front * frac
    return torch.where(swap, 1.0 - i_x, i_x)


def beta_quantile_breaks(a, b, K: int):
    """Median-of-class quantiles of Beta(a, b): the quantile at the
    midpoint of each of K equal-probability classes (reference BetaBreaks,
    src/utils.c, r = (i + 1/2) / K; mrbayes_tpu/models/rates.py:119-138).
    a, b [C] -> [C, K] float64, by the JAX package's ``BISECT_STEPS``-step
    bisection on ``betainc``."""
    a = torch.as_tensor(a).double()[..., None]
    b = torch.as_tensor(b).double()[..., None]
    r = (torch.arange(K, dtype=torch.float64, device=a.device) + 0.5) / K
    lo = torch.zeros(a.shape[:-1] + (K,), dtype=torch.float64,
                     device=a.device)
    hi = torch.ones_like(lo)
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        below = betainc(a, b, mid) < r
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)
