"""The fossilized birth-death prior of small trees, integrated in float64
over the state space the port's clock moves reach, and the prior-only
sampler it checks: the oracle of ``tests/test_torch_sampled_ancestors.py``
and of ``chip_smoke.py``'s three-tip phase (which imports it by path).

A problem (``PROBLEMS``) is two extant tips A (0) and B (1) at age 0 and
one or two fossils at fixed ages (F, or F1 and F2); the FBD prior (random
sampling, extant sampling probability ``RHO``) with the (d, r, s) rates
held at the engine's starting values (their moves' probability 0); the
tree age under ``TREEAGE``.

The state space: every labelled rooted binary topology (3 on three tips,
15 on four), and in each every set of fossils that may be sampled
ancestors: a fossil F on a zero-length branch, its parent q pinned to F's
age, where q is not the root (delete-branch refuses it), q pins no other
fossil, and every tip under F's sibling is younger than F.  The free ages
are the root's, above every tip, and every other internal node's that is
not pinned, between the oldest tip below it and its parent's age.  The
density of a state is ``exp(clock.ln_fbd)`` (the tree-age density
included); the (d, r, s) priors are constants.

``integral`` integrates it with ``scipy.integrate``: the root age by
Gauss-Legendre over a span that holds all but 1e-12 of the tree-age
prior, the other free ages by Gauss-Legendre inside, nested from the
root down.  ``sampler`` runs the
port's engine on the same problem: ``mcmc data=no`` with each chain
drawing its own move every generation (``per_chain_moves``, the
reference's PickProposal), so that runs are independent batches.  A move
sequence shared by all runs would not do: the add/delete-branch pair
keeps the prior only as a mixture, so every run that sees the same adds
and deletes leans the same way.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from mrbayes_tpu_torch.mcmc import clock as CL

# the fossils' ages of each problem
PROBLEMS = {"three_tips": (2.0,), "four_tips": (1.0, 2.0)}
RHO = 0.5
TREEAGE = ("gamma", (16.0, 4.0))
# the engine's starting (net diversification, turnover, fossil fraction)
RATES = (0.1, 0.5, 0.1)
FROZEN = ("speciation_mult", "extinction_slider", "fossilization_slider")
# drawn more often than by default (3, 2, 2): the stretch's count of
# scaled ages and the add/delete pair's ratio are what a sampled ancestor
# changes most, and this way a fault in them moves the marginals by
# several standard errors
BOOSTED = {"tree_stretch": 15.0, "add_branch": 6.0, "del_branch": 6.0}
# the sampler's and the integral's statistics: the share of states with
# a sampled ancestor, their mean count, the mean root age and the share
# of states where A and B are sister tips
STATS = ("sampled_ancestor_share", "sampled_ancestors", "root_age",
         "ab_share")
# the quadrature: Gauss-Legendre points of each free non-root age, and
# of the root age over ROOT_SPAN above the oldest tip
GAUSS_POINTS = 24
ROOT_SPAN, ROOT_POINTS = 30.0, 160


def _taxa(fossil_ages):
    return ["A", "B"] + (["F"] if len(fossil_ages) == 1 else
                         [f"F{i + 1}" for i in range(len(fossil_ages))])


def _tip_ages(fossil_ages):
    return np.array([0.0, 0.0, *fossil_ages])


def _rooted_trees(tips):
    """Every rooted binary tree on ``tips`` as nested pairs, once each."""
    if len(tips) == 1:
        yield tips[0]
        return
    first, rest = tips[0], tips[1:]
    for k in range(len(rest)):
        for other in itertools.combinations(rest, k):
            left = (first,) + other
            right = tuple(t for t in rest if t not in other)
            for a in _rooted_trees(left):
                for b in _rooted_trees(right):
                    yield (a, b)


def _parents(tree, n_tips):
    """The parent array [2 n_tips - 1] of ``tree``, its internal nodes
    numbered in post-order from n_tips (so the root is the last)."""
    parent = [-1] * (2 * n_tips - 1)
    nxt = [n_tips]

    def walk(t):
        if isinstance(t, int):
            return t
        kids = [walk(c) for c in t]
        v = nxt[0]
        nxt[0] += 1
        for c in kids:
            parent[c] = v
        return v
    walk(tree)
    return parent


def _configurations(fossil_ages):
    """(parent list, sampled-ancestor flags [n_tips]) of every state class
    of the problem: each topology with each valid set of ancestral
    fossils."""
    tip_age = _tip_ages(fossil_ages)
    n = tip_age.size
    root = 2 * n - 2
    out = []
    for tree in _rooted_trees(tuple(range(n))):
        parent = _parents(tree, n)
        children = {v: [c for c in range(2 * n - 1) if parent[c] == v]
                    for v in range(n, 2 * n - 1)}
        oldest = _oldest_below(parent, tip_age)
        fossils = range(2, n)
        for k in range(len(fossils) + 1):
            for anc in itertools.combinations(fossils, k):
                qs = [parent[f] for f in anc]
                if root in qs or len(set(qs)) < len(qs):
                    continue
                sibs = [next(c for c in children[parent[f]] if c != f)
                        for f in anc]
                if all(oldest[s] < tip_age[f] for f, s in zip(anc, sibs)):
                    sa = np.zeros(n, np.int64)
                    sa[list(anc)] = 1
                    out.append((parent, sa))
    return out


def _oldest_below(parent, tip_age):
    """The oldest tip age at or below every node."""
    n = tip_age.size
    oldest = np.zeros(2 * n - 1)
    oldest[:n] = tip_age
    for v in range(n):
        p = parent[v]
        while p >= 0:
            oldest[p] = max(oldest[p], tip_age[v])
            p = parent[p]
    return oldest


def _depth(parent, v):
    d = 0
    while parent[v] >= 0:
        v, d = parent[v], d + 1
    return d


def _treeage_lpdf(t):
    from mrbayes_tpu_torch.mcmc.engine import _scalar_prior_lpdf
    from mrbayes_tpu_torch.mcmc.settings import Prior
    return _scalar_prior_lpdf(Prior(*TREEAGE), t)


def density(fossil_ages, parent, sa, age):
    """exp(ln_fbd) [N] in float64 at the node ages ``age`` [N, 2 n - 1]
    of the state class (``parent``, ``sa``)."""
    age = torch.as_tensor(age, dtype=torch.float64)
    N, n = age.shape[0], len(fossil_ages) + 2
    rates = [torch.full((N,), x, dtype=torch.float64) for x in RATES]
    fossil = np.arange(n) >= 2
    return torch.exp(CL.ln_fbd(
        age, n, *rates, RHO, fossil, _treeage_lpdf,
        sa=torch.as_tensor(sa).expand(N, n),
        parent=torch.tensor([parent]).expand(N, 2 * n - 1))).numpy()


def _marginal(fossil_ages, parent, sa, t):
    """The density of the class integrated over its free ages below roots
    at the ages ``t`` [T]: each free non-root node, from the root down,
    by Gauss-Legendre between the oldest tip below it and its parent's
    age (a pinned node at its fossil's age).  Returns [T]."""
    tip_age = _tip_ages(fossil_ages)
    n = tip_age.size
    root = 2 * n - 2
    oldest = _oldest_below(parent, tip_age)
    pinned = {parent[f]: tip_age[f] for f in np.flatnonzero(sa)}
    x, w = np.polynomial.legendre.leggauss(GAUSS_POINTS)
    T = t.size
    age = np.zeros((T, 2 * n - 1))
    age[:, :n] = tip_age
    age[:, root] = t
    weight = np.ones(T)
    for v in sorted(range(n, root), key=lambda v: _depth(parent, v)):
        if v in pinned:
            age[:, v] = pinned[v]
            continue
        lo, hi = oldest[v], age[:, parent[v]]
        half = (hi - lo)[:, None] / 2.0
        grid = lo + half * (x[None, :] + 1.0)              # [N, G]
        age = np.repeat(age, GAUSS_POINTS, 0)
        age[:, v] = grid.reshape(-1)
        weight = (weight[:, None] * half * w[None, :]).reshape(-1)
    f = weight * density(fossil_ages, parent, sa, age)
    return f.reshape(T, -1).sum(1)


def integral(fossil_ages) -> dict:
    """``STATS`` of the prior, from its integral over every state class:
    the root age by ``scipy.integrate.fixed_quad`` over ``ROOT_SPAN``
    above the oldest tip (the tree-age prior's mass beyond it is below
    1e-12), the other free ages inside it (``_marginal``)."""
    from scipy import integrate
    lo = max(fossil_ages)
    mass = first = 0.0
    sums = dict.fromkeys(STATS, 0.0)
    for parent, sa in _configurations(fossil_ages):
        m, m1 = integrate.fixed_quad(
            lambda t: np.stack([np.ones_like(t), t])
            * _marginal(fossil_ages, parent, sa, t),
            lo, lo + ROOT_SPAN, n=ROOT_POINTS)[0]
        mass += m
        first += m1
        sums["sampled_ancestor_share"] += m * (sa.sum() > 0)
        sums["sampled_ancestors"] += m * sa.sum()
        sums["ab_share"] += m * (parent[0] == parent[1])
    sums["root_age"] = first
    return {k: float(v / mass) for k, v in sums.items()}


def engine(fossil_ages, device, nruns: int, seed: int):
    """The problem's engine: ``nruns`` runs x 1 chain, no data, a move
    drawn per chain, the (d, r, s) moves off and ``BOOSTED``'s weights."""
    from mrbayes_tpu_torch.data import DataSet, make_divisions
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings, Prior,
                                                 TreeSettings)
    from mrbayes_tpu_torch.nexus.datatypes import DataType, FormatInfo
    from mrbayes_tpu_torch.nexus.parser import CharacterMatrix
    taxa = _taxa(fossil_ages)
    rng = np.random.default_rng(5)
    codes = (1 << rng.integers(0, 4, size=(len(taxa), 30))).astype(
        np.uint32)
    m = CharacterMatrix(taxa=taxa, nchar=30,
                        fmt=FormatInfo(datatype=DataType.DNA), codes=codes,
                        col_datatype=[DataType.DNA] * 30)
    ds = DataSet(taxa=taxa, nchar=30, divisions=make_divisions(m))
    ts = TreeSettings(clock=True, clockpr="fossilization",
                      samplestrat="random", sampleprob=RHO,
                      treeagepr=Prior(*TREEAGE),
                      tip_calibrations={2 + i: Prior("fixed", (a,))
                                        for i, a in enumerate(fossil_ages)})
    return Engine(ds, [DivisionSettings(nst="1")], tree_settings=ts,
                  mcmc=McmcSettings(nruns=nruns, nchains=1, seed=seed,
                                    use_data=False, per_chain_moves=True),
                  device=device,
                  move_overrides={
                      **{k: {"prob": 0.0} for k in FROZEN},
                      **{k: {"prob": w} for k, w in BOOSTED.items()}})


def sampler(eng, gens: int, burn: int, seed: int):
    """Run ``eng`` (``engine``) for ``gens`` generations from starting
    trees whose root age is drawn from the tree-age prior (every other
    internal age uniform between the oldest tip below it and its
    parent's age), and return each run's means of ``STATS`` over the
    generations after ``burn``, read every 10: [runs, len(STATS)]."""
    from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
    states, bk = eng.init_chains()
    st = {k: v for k, v in states.items() if k not in SCORE_KEYS}
    n = eng.n_tips
    root = 2 * n - 2
    C = st["age"].shape[0]
    rng = np.random.default_rng(seed)
    shape, rate = TREEAGE[1]
    tip_age = st["age"][0, :n].cpu().numpy().astype(np.float64)
    parent = st["parent"].cpu().numpy()
    age = st["age"].cpu().numpy().astype(np.float64)
    age[:, root] = np.maximum(rng.gamma(shape, 1.0 / rate, C),
                              tip_age.max() + 0.1)
    for c in range(C):
        par = list(parent[c])
        oldest = _oldest_below(par, tip_age)
        for v in sorted(range(n, root), key=lambda v: _depth(par, v)):
            age[c, v] = oldest[v] + rng.uniform(0.05, 0.95) * (
                age[c, par[v]] - oldest[v])
    st["age"] = torch.as_tensor(age, dtype=st["age"].dtype,
                                device=st["age"].device)
    states = eng.score(st)
    rec = []
    for g in range(0, gens, 10):
        states, bk = eng.run_block(states, bk, 10)
        if g + 10 > burn:
            k = states["sa"].sum(1).to(states["age"].dtype)
            rec.append(torch.stack([
                (k > 0).to(k.dtype), k, states["age"][:, root],
                (states["parent"][:, 0] == states["parent"][:, 1]).to(
                    k.dtype)], 1))
    return torch.stack(rec).mean(0).cpu().numpy().astype(np.float64)
