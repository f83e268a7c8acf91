"""Whether the timed run is correct: what it produced, held against the
plain reference.

Every number compared, with its limit (from the configuration's
``limits``):

* ``patterns_differ``: the sum over divisions of the difference between
  the program's count of site patterns and the reference's own
  compression of the simulated matrix (exact: limit 0);
* ``lnpost_rel_gap_q3``: the upper quartile (the 75th percentile,
  taken at a chain, not between two) over every chain's final state of
  the gap between the lnL + lnPrior the program carries and the
  reference's, recomputed from that state's tree and parameters on the
  reference's patterns (Q, gamma and invariant classes, rate
  multipliers, P(t), the down-pass and the root reduction of every
  division, and the prior), as a share of the reference's; a chain whose
  gap is not finite or passes its whole score reads 1.  A share, since
  float32 sums of some 10^6 err by units; the upper quartile, so that a
  fault in any quarter of the chains (one run of four) reads in full,
  while the float32 P(t) of a clock tree's shortest branches, which
  sends the worst chain or two of a run anywhere from 1e-5 to 4e-3 (the
  largest is kept in the result's ``run_info``), does not;
* ``not_climbed``: the chains whose final state the reference does not
  score above their starting state (from random trees, every chain of a
  sound run climbs: a step that leaves its state unchanged reads every
  chain here; exact: limit 0);
* ``sample_gap``: the largest relative gap between the last ``.p`` row
  and ``.t`` tree of each run and its cold chain's final state, every
  column and every branch (a tree of other splits reads 1); its limit is
  the ``.p`` format's, seven significant digits.
"""
from __future__ import annotations


import numpy as np

from . import reference as R

# the fields of a chain's state every family has; a model family's
# module names its own (``FIELDS``)
STATE_FIELDS = ("parent", "blen", "age", "ratemult", "lnL", "lnP")


def tree_of(st: dict, c: int):
    """(parent, branch lengths, ages or None) of chain ``c``: a clock
    tree's lengths are its age differences."""
    if "age" in st:
        age = st["age"][c].astype(np.float64)
        return st["parent"][c], R.clock_blens(st["parent"][c], age), age
    return st["parent"][c], st["blen"][c].astype(np.float64), None


def chain_ratemult(st: dict, c: int):
    r = st.get("ratemult")
    return None if r is None else r[c].astype(np.float64)


def score_chains(st: dict, data: R.Data, cfg: dict, model) -> np.ndarray:
    """[C, 2] the reference's (lnL, lnPrior) of every chain of ``st``
    under the model family's module ``model``."""
    n_div = len(data.npat)
    out = []
    for c in range(st["parent"].shape[0]):
        out.append(R.state_scores(
            *tree_of(st, c), model.division_params(st, c, n_div),
            chain_ratemult(st, c), data, cfg["model"]["ngammacat"],
            cfg["prior"], model.lnprior))
    return np.array(out)


def expected_columns(st: dict, c: int, sites: np.ndarray, model) -> dict:
    """The ``.p`` columns a chain's state gives, by MrBayes' names."""
    n_div = sites.shape[0]
    cols = {"lnLike": float(st["lnL"][c]), "lnPrior": float(st["lnP"][c])}
    parent, blen, age = tree_of(st, c)
    every = "{all}" if n_div > 1 else ""
    cols["TL" + every] = sum(R.splits(parent, blen, _n_tips(st)).values())
    if age is not None:
        cols["TH" + every] = float(age[parent < 0][0])

    def sfx(g, n_grp):
        if n_div == 1:
            return ""
        return "{all}" if n_grp == 1 else "{" + str(g + 1) + "}"

    cols.update(model.columns(st, c, sfx))
    rm = chain_ratemult(st, c)
    if rm is not None:
        frac = sites / sites.sum()
        for d in range(n_div):
            cols[f"m{{{d + 1}}}"] = float(rm[d] / frac[d])
    return cols


def _n_tips(st: dict) -> int:
    return (st["parent"].shape[1] + 1) // 2


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def sample_gap(prog: dict, sites: np.ndarray, model) -> float:
    """The largest relative gap between each run's last written sample and
    its cold chain's final state."""
    st, nc = prog["final"], prog["nchains"]
    n_tips = _n_tips(st)
    worst = 0.0
    for r, (header, row, tree) in enumerate(prog["samples"]):
        tid = prog["temp_id"][r * nc:(r + 1) * nc]
        c = r * nc + int(np.argmin(tid))
        if int(float(row[0])) != prog["gens"]:
            return 1.0
        written = dict(zip(header[1:], (float(x) for x in row[1:])))
        want = expected_columns(st, c, sites, model)
        if set(written) != set(want):
            return 1.0
        worst = max([worst] + [_rel(written[k], v) for k, v in want.items()])
        got = R.newick_splits(tree, n_tips)
        edges = R.splits(*tree_of(st, c)[:2], n_tips)
        if set(got) != set(edges):
            return 1.0
        worst = max([worst] + [_rel(got[s], v) for s, v in edges.items()
                               if v > 0])
    return worst


def chain_gaps(carried: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each chain's gap of ``carried`` to ``want`` over ``want``; one
    that is not finite, or passes the whole score, reads 1."""
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        gap = np.abs(carried - want) / np.abs(want)
    return np.where(np.isfinite(gap), np.minimum(gap, 1.0), 1.0)


def upper_quartile(x: np.ndarray) -> float:
    return float(np.quantile(x, 0.75, method="higher"))


def in_place_of_program(prog: dict, scores: np.ndarray) -> dict:
    """``prog`` with ``scores`` [C, 2] (lnL, lnPrior) carried in place of
    the program's, in every chain's final state and in each run's last
    ``.p`` row: what a control put in the program's place would have
    produced from the same states."""
    final = dict(prog["final"], lnL=scores[:, 0].copy(),
                 lnP=scores[:, 1].copy())
    nc, samples = prog["nchains"], []
    for r, (header, row, tree) in enumerate(prog["samples"]):
        c = r * nc + int(np.argmin(prog["temp_id"][r * nc:(r + 1) * nc]))
        row = list(row)
        for k, v in (("lnLike", scores[c, 0]), ("lnPrior", scores[c, 1])):
            if k in header:
                row[header.index(k)] = repr(float(v))
        samples.append((header, row, tree))
    return dict(prog, final=final, samples=samples)


def compare(prog: dict, data: R.Data, cfg: dict, model, scores=None):
    """(correct, {name: (value, limit)}, extra) of one run's outputs;
    ``scores``, the reference's (final, start) from an earlier call on
    the same states, spares working them out again."""
    limits = cfg["limits"]
    if scores is None:
        scores = (score_chains(prog["final"], data, cfg, model),
                  score_chains(prog["init"], data, cfg, model))
    final, start = scores
    carried = (prog["final"]["lnL"].astype(np.float64)
               + prog["final"]["lnP"].astype(np.float64))
    gap = chain_gaps(carried, final.sum(1))
    numbers = {
        "patterns_differ": (float(sum(abs(a - b) for a, b in zip(
            prog["npat"], data.npat)) + abs(len(prog["npat"])
                                            - len(data.npat))),
            limits["patterns_differ"]),
        "lnpost_rel_gap_q3": (upper_quartile(gap),
                              limits["lnpost_rel_gap_q3"]),
        "not_climbed": (float((final[:, 0] <= start[:, 0]).sum()),
                        limits["not_climbed"]),
        "sample_gap": (sample_gap(prog, data.sites, model),
                       limits["sample_gap"]),
    }
    correct = all(v <= lim for v, lim in numbers.values())
    return correct, numbers, {
        "final": final, "start": start,
        "gap_quartiles": [float(x) for x in np.quantile(gap, [0, 0.25, 0.5,
                                                             0.75, 1])]}
