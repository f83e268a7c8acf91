"""Among-site rate variation: the discrete-gamma rate table.

The MCMC loop needs category rates for a *sampled* shape parameter every
generation.  scipy builds a table of mean-of-category gamma rates on the
host once (reference DiscreteGamma, src/utils.c:10500); a torch gather
plus linear interpolation in log(alpha) reads it on the device.
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
