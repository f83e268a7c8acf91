"""The GTR family on DNA (MrBayes' ``lset nst=6`` with ``rates=gamma``
or ``invgamma``): what the harness needs of a model family, found by the
name a configuration's ``model.module`` gives.

* ``STATES``: the states a site takes (a code of ``STATES`` is missing);
* ``FIELDS``: the fields of the program's chain state this family reads;
* ``simulate(sim, seed)`` and ``nexus_text(codes)``: the alignment from
  a configuration's ``simulation`` block and the seed, and its NEXUS;
* ``division_params(st, c, n_div)``: each division's parameters of chain
  ``c`` of the program's state ``st``, with the site-rate model's
  ``alpha`` and ``pinvar`` (0 without an invariant class), and ``q``, Q
  worked out anew from them;
* ``lnprior(prm, spec)``: the prior of one division's parameters;
* ``columns(st, c, sfx)``: the ``.p`` columns of chain ``c``'s
  parameters, by MrBayes' names, ``sfx(g, n_groups)`` a group's
  suffix.

It imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np

from phylobench import simulate as _sim

STATES = 4
FIELDS = ("revmat", "pi", "shape", "pinvar")
REV_NAMES = ("A<->C", "A<->G", "A<->T", "C<->G", "C<->T", "G<->T")


def simulate(sim: dict, seed: int) -> np.ndarray:
    return _sim.simulate(sim, seed)


def nexus_text(codes: np.ndarray) -> str:
    return _sim.nexus_text(codes)


def q_matrix(revmat, pi) -> np.ndarray:
    """GTR Q from exchangeabilities (AC, AG, AT, CG, CT, GT) and
    frequencies, scaled to one substitution per unit time (float64)."""
    return _sim.gtr_q(np.asarray(revmat, np.float64),
                      np.asarray(pi, np.float64))


def division_params(st: dict, c: int, n_div: int) -> list[dict]:
    """Each division's (revmat, pi, alpha, pinvar, q) of chain ``c``: its
    own group's where every parameter is unlinked, else the one
    group's."""
    out = []
    for d in range(n_div):
        def grp(field):
            x = st[field][c]
            return x[d] if x.shape[0] == n_div else x[0]
        prm = {"revmat": grp("revmat").astype(np.float64),
               "pi": grp("pi").astype(np.float64),
               "alpha": float(grp("shape")),
               "pinvar": float(grp("pinvar")) if "pinvar" in st else 0.0}
        prm["q"] = q_matrix(prm["revmat"], prm["pi"])
        out.append(prm)
    return out


def _dirichlet_lpdf(x, alpha: float) -> float:
    x = np.asarray(x, np.float64)
    k = x.shape[0]
    return (math.lgamma(alpha * k) - k * math.lgamma(alpha)
            + (alpha - 1.0) * float(np.log(x).sum()))


def _scalar_lpdf(spec, x: float) -> float:
    kind, *p = spec
    if kind == "exponential":
        return math.log(p[0]) - p[0] * x if x > 0 else -math.inf
    if kind == "uniform":
        return -math.log(p[1] - p[0]) if p[0] <= x <= p[1] else -math.inf
    raise ValueError(f"prior {kind}")


def lnprior(prm: dict, spec: dict) -> float:
    """revmatpr and statefreqpr Dirichlet, shapepr, pinvarpr."""
    lp = _dirichlet_lpdf(prm["revmat"], spec["revmat_dirichlet"])
    lp += _dirichlet_lpdf(prm["pi"], spec["statefreq_dirichlet"])
    lp += _scalar_lpdf(spec["shape"], prm["alpha"])
    if "pinvar" in spec:
        lp += _scalar_lpdf(spec["pinvar"], prm["pinvar"])
    return lp


def columns(st: dict, c: int, sfx) -> dict:
    cols = {}
    n_grp = st["revmat"].shape[1]
    for g in range(n_grp):
        s = sfx(g, n_grp)
        for k, nm in enumerate(REV_NAMES):
            cols[f"r({nm}){s}"] = float(st["revmat"][c, g, k])
        for k, b in enumerate("ACGT"):
            cols[f"pi({b}){s}"] = float(st["pi"][c, g, k])
        cols[f"alpha{s}"] = float(st["shape"][c, g])
        if "pinvar" in st:
            cols[f"pinvar{s}"] = float(st["pinvar"][c, g])
    return cols
