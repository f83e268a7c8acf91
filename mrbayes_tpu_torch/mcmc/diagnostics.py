"""Convergence diagnostics (host-side numpy on sampled output).

- ASDSF: average standard deviation of split frequencies across runs
  (reference: CalcPartFreqStats src/mcmc.c:1750, printed :17053-17110)
- PSRF: Gelman–Rubin potential scale reduction (src/utils.c:1373)
- ESS: autocorrelation-based effective sample size (src/utils.c:1423)
"""
from __future__ import annotations

import numpy as np

from ..trees import Tree


def splits_of_tree(t: Tree) -> set[frozenset[int]]:
    """Nontrivial splits (as the tip-set not containing tip 0)."""
    n = t.n_tips
    below = [set() for _ in range(t.n_nodes)]
    for v in range(n):
        below[v] = {v}
    for v in t.postorder():
        below[v] = below[t.left[v]] | below[t.right[v]]
    out = set()
    for v in range(n, t.n_nodes - 1):
        s = below[v]
        if 0 in s:
            s = set(range(n)) - s
        if 1 < len(s) < n - 1 or (1 <= len(s) <= n - 1 and t.rooted):
            out.add(frozenset(s))
    return out


class SplitCounter:
    """Running split-frequency table per run (reference: the shared
    partition-counter trie, AddTreeToPartitionCounters src/mcmc.c:555).

    Per-sample split sets are also recorded so the live ASDSF can apply
    relative burn-in over the retained window, matching the reference's
    windowed convergence diagnostic (CalcPartFreqStats src/mcmc.c:1750
    discards the burn-in fraction before comparing runs)."""

    def __init__(self, n_runs: int, record: bool = True):
        self.n_runs = n_runs
        self.counts: dict[frozenset, np.ndarray] = {}
        self.n_trees = np.zeros(n_runs, dtype=np.int64)
        self.samples: list[list[set]] | None = \
            [[] for _ in range(n_runs)] if record else None

    def add(self, run: int, tree: Tree) -> None:
        self.n_trees[run] += 1
        splits = splits_of_tree(tree)
        if self.samples is not None:
            self.samples[run].append(splits)
        for s in splits:
            if s not in self.counts:
                self.counts[s] = np.zeros(self.n_runs, dtype=np.int64)
            self.counts[s][run] += 1

    def _burned_table(self, burn_frac: float):
        """(counts dict, n_trees array) over the post-burn-in window."""
        counts: dict[frozenset, np.ndarray] = {}
        n_trees = np.zeros(self.n_runs, dtype=np.int64)
        for r, samp in enumerate(self.samples):
            burn = int(len(samp) * burn_frac)
            kept = samp[burn:]
            n_trees[r] = len(kept)
            for splits in kept:
                for s in splits:
                    if s not in counts:
                        counts[s] = np.zeros(self.n_runs, dtype=np.int64)
                    counts[s][r] += 1
        return counts, n_trees

    def asdsf(self, min_freq: float = 0.10, burn_frac: float = 0.0) -> float:
        """Average (across qualifying splits) of the std-dev of split
        frequency across runs, after discarding ``burn_frac`` of each
        run's samples."""
        if burn_frac > 0.0 and self.samples is not None:
            counts, n_trees = self._burned_table(burn_frac)
        else:
            counts, n_trees = self.counts, self.n_trees
        if np.any(n_trees == 0) or not counts:
            return np.nan
        sds = []
        for s, c in counts.items():
            f = c / n_trees
            if np.max(f) >= min_freq:
                sds.append(np.std(f, ddof=1))
        return float(np.mean(sds)) if sds else 0.0

    def max_sdsf(self, min_freq: float = 0.10) -> float:
        if np.any(self.n_trees == 0) or not self.counts:
            return np.nan
        sds = [np.std(c / self.n_trees, ddof=1)
               for c in self.counts.values()
               if np.max(c / self.n_trees) >= min_freq]
        return float(np.max(sds)) if sds else 0.0


def psrf(chains: np.ndarray) -> float:
    """Gelman–Rubin PSRF. chains: [n_runs, n_samples]."""
    m, n = chains.shape
    if m < 2 or n < 2:
        return np.nan
    means = chains.mean(axis=1)
    W = chains.var(axis=1, ddof=1).mean()
    B = n * means.var(ddof=1)
    if W <= 0:
        return np.nan
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / W))


def ess(x: np.ndarray) -> float:
    """Effective sample size via initial-positive-sequence autocorrelation."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 4 or np.var(x) == 0:
        return float(n)
    x = x - x.mean()
    acf = np.correlate(x, x, "full")[n - 1:] / (np.arange(n, 0, -1))
    acf = acf / acf[0]
    s = 0.0
    for k in range(1, n // 2):
        if acf[k] < 0:
            break
        s += acf[k]
    return float(n / (1.0 + 2.0 * s))


def hpd_interval(x: np.ndarray, cred: float = 0.95):
    """Shortest credible interval (reference LowerUpperMedianHPD
    src/utils.c:994)."""
    xs = np.sort(np.asarray(x))
    n = len(xs)
    k = max(1, int(np.ceil(cred * n)))
    widths = xs[k - 1:] - xs[:n - k + 1]
    i = int(np.argmin(widths))
    return float(xs[i]), float(xs[i + k - 1])


def summarize_param(samples_per_run: list[np.ndarray],
                    hpd: bool = True) -> dict:
    """Mean/variance/median/HPD/ESS/PSRF table row (reference GetSummary
    src/utils.c:648).  ``hpd=False`` reports the equal-tail 95%
    percentile interval instead (reference sump Hpd=No)."""
    allx = np.concatenate(samples_per_run)
    if hpd:
        lo, hi = hpd_interval(allx)
    else:
        lo, hi = (float(np.percentile(allx, 2.5)),
                  float(np.percentile(allx, 97.5)))
    min_len = min(len(s) for s in samples_per_run)
    chains = np.stack([s[:min_len] for s in samples_per_run])
    return {
        "mean": float(allx.mean()),
        "var": float(allx.var(ddof=1)) if len(allx) > 1 else 0.0,
        "median": float(np.median(allx)),
        "hpd_lower": lo, "hpd_upper": hi,
        "min_ess": float(min(ess(s) for s in samples_per_run)),
        "avg_ess": float(np.mean([ess(s) for s in samples_per_run])),
        "psrf": psrf(chains) if len(samples_per_run) > 1 else np.nan,
    }
