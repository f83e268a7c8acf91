"""The alignment a cell runs on, made from the seed.

A configuration's ``simulation`` block fixes everything but the seed: the
number of taxa and sites, the generating tree (drawn once from its own
``tree_seed``: a Yule topology, ultrametric ages scaled to
``root_height``, each branch then multiplied by a lognormal rate of
log-sd ``rate_sd``), and the GTR+I+G parameters.  ``--seed`` draws only
the states: the root's, each site's rate (invariant with probability
``pinvar``, else a continuous gamma of shape ``alpha`` and mean
1 / (1 - pinvar)), and every substitution down the tree.  So every seed
has the same shapes, the same tree and the same model, and the pattern
count moves only by the draw (about 0.2%).

NumPy, in bulk: one [sites, 4] transition row per branch from the
eigensystem of Q, so a 169 x 32,000 alignment takes about a second.
"""
from __future__ import annotations

import numpy as np

BASES = "ACGT"


def gtr_q(revmat, pi) -> np.ndarray:
    """GTR rate matrix with exchangeabilities (AC, AG, AT, CG, CT, GT) and
    frequencies ``pi``, scaled to one substitution per unit time."""
    pi = np.asarray(pi, float)
    q = np.zeros((4, 4))
    k = 0
    for i in range(4):
        for j in range(i + 1, 4):
            q[i, j] = revmat[k] * pi[j]
            q[j, i] = revmat[k] * pi[i]
            k += 1
    np.fill_diagonal(q, -q.sum(1))
    return q / -(pi * np.diag(q)).sum()


def yule_tree(n_tips: int, rng: np.random.Generator):
    """(parent [2n-1], branch length [2n-1]) of a Yule tree with ages in
    units of its root age; the root is node 2n-2 and has parent -1."""
    n_nodes = 2 * n_tips - 1
    parent = np.full(n_nodes, -1, np.int64)
    age = np.zeros(n_nodes)
    lineages = list(range(n_tips))
    t, nxt = 0.0, n_tips
    while len(lineages) > 1:
        t += rng.exponential(1.0 / len(lineages))
        a, b = rng.choice(len(lineages), 2, replace=False)
        x, y = lineages[a], lineages[b]
        parent[x] = parent[y] = nxt
        age[nxt] = t
        lineages = [v for i, v in enumerate(lineages) if i not in (a, b)]
        lineages.append(nxt)
        nxt += 1
    age /= age[-1]
    blen = np.where(parent >= 0, age[parent] - age, 0.0)
    return parent, blen


def generating_tree(sim: dict):
    """The configuration's fixed tree: (parent, branch lengths in
    substitutions per site)."""
    rng = np.random.default_rng(sim["tree_seed"])
    parent, blen = yule_tree(sim["taxa"], rng)
    rate = np.exp(rng.normal(0.0, sim["rate_sd"], blen.shape))
    return parent, blen * rate * sim["root_height"]


def simulate(sim: dict, seed: int) -> np.ndarray:
    """Codes [taxa, sites] in 0..3 (A, C, G, T) drawn from ``seed``."""
    parent, blen = generating_tree(sim)
    n_nodes, n_sites = parent.shape[0], sim["sites"]
    pi = np.asarray(sim["pi"], float)
    q = gtr_q(sim["revmat"], pi)
    # symmetric form: D^1/2 Q D^-1/2 = V diag(lam) V^T
    d = np.sqrt(pi)
    lam, v = np.linalg.eigh(d[:, None] * q / d[None, :])
    u = v / d[:, None]                # Q = u diag(lam) u^-1
    uinv = v.T * d[None, :]
    rng = np.random.default_rng(seed)
    pinv, alpha = sim["pinvar"], sim["alpha"]
    rate = rng.gamma(alpha, 1.0 / alpha, n_sites) / (1.0 - pinv)
    rate[rng.random(n_sites) < pinv] = 0.0
    states = np.zeros((n_nodes, n_sites), np.int8)
    states[-1] = rng.choice(4, n_sites, p=pi)
    # parents before children: nodes in decreasing index (the root last
    # made, every parent above its children)
    for v_ in range(n_nodes - 2, -1, -1):
        ps = states[parent[v_]]
        e = np.exp(np.outer(rate * blen[v_], lam))       # [sites, 4]
        rows = (u[ps] * e) @ uinv                         # P[ps, :]
        cum = np.cumsum(np.clip(rows, 0.0, None), 1)
        r = rng.random(n_sites) * cum[:, -1]
        states[v_] = (r[:, None] > cum).sum(1)
    return states[:sim["taxa"]]


def taxon_names(n: int) -> list[str]:
    return [f"t{i + 1:03d}" for i in range(n)]


def nexus_text(codes: np.ndarray) -> str:
    """A NEXUS data block of DNA for ``codes`` [taxa, sites]."""
    ntax, nchar = codes.shape
    letters = np.frombuffer(BASES.encode(), np.uint8)[codes]
    names = taxon_names(ntax)
    rows = [f"   {nm}  {row.tobytes().decode()}"
            for nm, row in zip(names, letters)]
    return ("#NEXUS\nbegin data;\n"
            f"   dimensions ntax={ntax} nchar={nchar};\n"
            "   format datatype=dna missing=? gap=-;\n   matrix\n"
            + "\n".join(rows) + "\n   ;\nend;\n")


def locus_ranges(sites: int, loci: int) -> list[tuple[int, int]]:
    """1-based inclusive (first, last) of ``loci`` loci as equal as
    ``sites`` allows, the longer ones first."""
    base, extra = divmod(sites, loci)
    out, lo = [], 1
    for i in range(loci):
        n = base + (1 if i < extra else 0)
        out.append((lo, lo + n - 1))
        lo += n
    return out
