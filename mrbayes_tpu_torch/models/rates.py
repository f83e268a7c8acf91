"""Among-site rate variation: the discrete-gamma rate table, the
discrete lognormal rates, the autocorrelated-gamma transition matrix, and
the discretized beta of codon model M10.

The MCMC loop needs category rates for a *sampled* shape parameter every
generation.  scipy builds a table of mean-of-category gamma rates on the
host once (reference DiscreteGamma, src/utils.c:10500); a torch gather
plus linear interpolation in log(alpha) reads it on the device.
``LognormalRates`` and ``AdgammaTransition`` likewise keep their normal
quantiles (and the copula's quadrature) as device constants built once on
the host, and take the sampled sigma or rho per chain.  M10's beta
classes need the quantiles of Beta(a, b) for sampled a and b:
``beta_quantile_breaks`` bisects on ``betainc``, the regularized
incomplete beta function in torch ops (torch has none), with no host
synchronisation.
"""
from __future__ import annotations

import math

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


class LognormalRates:
    """K equal-probability mean-one lognormal category rates (reference
    DiscreteLogNormal, src/utils.c:10549; mrbayes_tpu/models/rates.py:74):
    the category medians of LN(-sigma^2 / 2, sigma), renormalised to mean
    one.  The normal quantiles at the categories' midpoints are computed
    once on the host."""

    def __init__(self, k: int, device=None):
        from scipy.special import ndtri
        self.k = k
        p = (2.0 * np.arange(1, k + 1) - 1.0) / (2.0 * k)
        self.z = torch.as_tensor(ndtri(p), dtype=torch.float32,
                                 device=device)

    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        """sigma [...] -> category rates [..., k]."""
        s = sigma[..., None]
        r = torch.exp(s * self.z - 0.5 * s * s)
        return r * (self.k / r.sum(-1, keepdim=True))


# Gauss-Legendre nodes of AdgammaTransition's copula, as the JAX package takes
ADGAMMA_QUAD = 32


class AdgammaTransition:
    """The autocorrelated-gamma model's transition matrix between adjacent
    sites' K rate categories (reference AutodGamma, src/utils.c:8989;
    mrbayes_tpu/models/rates.py:84): a bivariate standard normal copula
    over the K equal-probability buckets, its CDF differenced at the
    normal quantiles, scaled by K and row-normalised.  The binormal CDF is
    Phi(x) Phi(y) plus the integral of its density over [0, rho] (the
    identity dPhi2/drho = phi2(x, y; rho)) by fixed ``ADGAMMA_QUAD``-point
    Gauss-Legendre quadrature: the bucket cuts, the nodes and weights and
    Phi(x) Phi(y) are device constants built once on the host, and a call
    is a fixed sequence of elementwise ops on each chain's rho."""

    def __init__(self, k: int, device=None):
        from numpy.polynomial.legendre import leggauss
        from scipy.stats import norm
        self.k = k
        z = np.r_[norm.ppf(np.arange(1, k) / k), 20.0]   # bucket upper cuts
        zz = np.array(np.meshgrid(z, z, indexing="ij"))  # [2, K, K]
        nodes, wts = leggauss(ADGAMMA_QUAD)

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        self.x, self.y = dev(zz[0])[..., None], dev(zz[1])[..., None]
        self.nodes, self.wts = dev(nodes), dev(wts)
        phi = norm.cdf(zz).astype(np.float32)
        self.phi2 = dev(phi[0] * phi[1])

    def __call__(self, rho: torch.Tensor) -> torch.Tensor:
        """rho [C] -> row-stochastic [C, K, K]."""
        rho = rho.clamp(-0.999, 0.999)[:, None, None, None]
        r = 0.5 * rho * (self.nodes + 1.0)              # [C, 1, 1, Q]
        w = 0.5 * rho * self.wts
        om = 1.0 - r * r
        x, y = self.x, self.y
        dens = torch.exp(-(x * x - 2.0 * r * x * y + y * y) / (2.0 * om)) \
            / (2.0 * math.pi * torch.sqrt(om))          # [C, K, K, Q]
        cdf = self.phi2 + (dens * w).sum(-1)            # Phi2 grid [C, K, K]
        cp = torch.nn.functional.pad(cdf, (1, 0, 1, 0))
        cell = cp[:, 1:, 1:] - cp[:, :-1, 1:] - cp[:, 1:, :-1] \
            + cp[:, :-1, :-1]
        M = torch.clamp_min(cell * self.k, 0.0)
        return M / M.sum(-1, keepdim=True)


# terms of betainc's continued fraction: a power of 2 (the product of the
# terms' 2x2 matrices is taken pairwise); 64 keep |betainc - scipy| below
# 1e-13 for a, b in [0.05, 20] (32 give 1.5e-10)
BETAINC_TERMS = 64
# bisection steps of beta_quantile_breaks, as the JAX package takes
BISECT_STEPS = 40


def betainc(a, b, x, terms: int = BETAINC_TERMS):
    """The regularized incomplete beta function I_x(a, b), elementwise over
    broadcast a, b, x, in float64 (Numerical Recipes 6.4: the continued
    fraction of I_x(a, b) where x < (a + 1) / (a + b + 2), else
    1 - I_{1-x}(b, a)).  The fraction's first ``terms`` convergents (a power
    of 2; 256 keep it within 3e-9 of scipy up to a = b = 1e4) come
    from the product of the recurrence's 2x2 matrices, taken pairwise in
    log2(terms) batched matmuls, each level rescaled to its largest
    entry (the value is a ratio of the product's entries): a fixed number
    of launches and no data-dependent branch."""
    a, b, x = torch.broadcast_tensors(torch.as_tensor(a).double(),
                                      torch.as_tensor(b).double(),
                                      torch.as_tensor(x).double())
    swap = x > (a + 1.0) / (a + b + 2.0)
    p = torch.where(swap, b, a)
    q = torch.where(swap, a, b)
    y = torch.where(swap, 1.0 - x, x)
    j = torch.arange(1, terms, dtype=torch.float64, device=x.device)
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
