"""hymfossil.nex's total-evidence dating analysis in the port, against the
JAX package and reference MrBayes, on the CPU: the configuration of the
hymfossil_fbd_totev rows of tests/golden_extra.json (114 taxa, 45 fossils
with fixed ages, the fossilized birth-death prior, 15 divisions: nine
standard buckets of 2-7 states, three of them ordered, and six GTR+G
genes).

* the batch's model commands are the rows' own, and both CLIs build the
  same divisions, groups, moves, tip dates and columns;
* the three golden rows within the row's tol (3.0) of the reference;
* at identical states on the reference's own trees (the rows' trees and
  ages with seeded substitution and FBD parameters) with JAX's
  eigensystems carried over, each division's lnL within 2e-2 of JAX's
  (measured up to 0.015: the float32 P(t) products of the two packages
  round differently, which an ordered bucket's near-zero entries and a
  gene's 400-700 patterns at 114 tips amplify; cynmix's 32 tips held
  5e-3); with each side's own eigensystems the totals within 0.5;
  lnPrior within 1e-4 relative (two of the three trees hold a fossil on
  a zero-length branch that the rows' states do not flag in ``sa``, so
  both engines make their prior 0);
* a sampled ancestor is a zero-length tip branch of the extracted rooted
  tree and of its Newick.

An ordered bucket's P(t) at short branches is ill-conditioned in float32
(a 0 -> 3 change needs t^3/6 where the eigen-products carry 1e-7 of
rounding), so the identical states use the reference's trees, not random
ones with branches of 1e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.mcmc import clock as JC
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.envelope import BATCHES, HYMFOSSIL_MODEL
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.trees import parse_newick, to_newick

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS = [r for r in json.load(open(os.path.join(HERE, "golden_extra.json")))
        if r["name"] == "hymfossil_fbd_totev"]


def _lines():
    data, model = BATCHES["hymfossil"]
    return [f"execute {data}", *model, "mcmcp nruns=1 nchains=3 seed=5"]


def _row_state(rec, taxa):
    """A golden row's state as numpy arrays (one chain)."""
    t = parse_newick(rec["newick"], taxa, rooted=True)
    st = {k: getattr(t, k).astype(np.int32) for k in ("left", "right",
                                                      "parent")}
    for k, v in rec["state"].items():
        if not k.startswith("_"):
            st[k] = np.asarray(v, np.int32 if k == "sa" else np.float32)
    return st


@pytest.fixture(scope="module")
def port_engine():
    it = Interpreter(log=lambda m: None, device="cpu")
    for ln in _lines():
        it.run_line(ln)
    return it.build_engine()


@pytest.fixture(scope="module")
def jax_side():
    """JAX's engine, the three rows' trees and ages with seeded gamma
    shapes, exchangeabilities, frequencies and FBD parameters, and at
    those states JAX's eigensystems, each division's lnL and the lnPrior
    (one jit)."""
    it = JInterpreter(log=lambda m: None)
    for ln in _lines():
        it.run_line(ln)
    eng = it.build_engine()
    rows = [_row_state(r, eng.data.taxa) for r in ROWS]
    st = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    rng = np.random.default_rng(5)
    g, C = eng.n_groups, len(rows)
    st["pi"] = rng.dirichlet(np.ones(4) * 5, (C, g["pi"])).astype(np.float32)
    st["revmat"] = rng.dirichlet(np.ones(6) * 2, (C, g["revmat"])).astype(
        np.float32)
    st["shape"] = rng.uniform(0.5, 2.0, (C, g["shape"])).astype(np.float32)
    for k, lo, hi in (("speciation", 0.01, 0.5), ("extinction", 0.1, 0.9),
                      ("fossilization", 0.05, 0.9)):
        st[k] = rng.uniform(lo, hi, (C, 1)).astype(np.float32)

    @jax.jit
    def scores(s):
        def one(s):
            s = eng.refresh_eigs(s)
            blen = JC.clock_blens(JC.pin_sa_ages(s, eng.n_tips),
                                  eng.n_tips, eng.tree_settings.clockvarpr)
            return s, jnp.stack([eng._division_lnL(s, i, blen)
                                 for i in range(eng.n_div)]), \
                eng.log_prior(s)
        return jax.vmap(one)(s)

    jst, divs, lnp = scores({k: jnp.asarray(v) for k, v in st.items()})
    return ({k: np.asarray(v) for k, v in jst.items()}, np.asarray(divs),
            np.asarray(lnp), eng)


def test_batch_is_the_golden_rows():
    assert len(ROWS) == 3
    assert tuple(ROWS[0]["commands"][1:]) == HYMFOSSIL_MODEL
    assert all(r["commands"] == ROWS[0]["commands"] for r in ROWS)


@pytest.mark.parametrize("row", range(3))
def test_golden_rows(port_engine, row):
    """The reference's sampled states (gen 0, 30 and 60) within the row's
    tol of its lnL."""
    rec = ROWS[row]
    st = state_from_numpy({k: v[None] for k, v in _row_state(
        rec, port_engine.data.taxa).items()}, "cpu")
    lnl = float(port_engine.log_likelihood(port_engine.refresh_eigs(st))[0])
    assert abs(lnl - rec["lnL"]) < rec["tol"], (rec["gen"], lnl, rec["lnL"])


def test_engines_agree_on_structure(port_engine, jax_side):
    eng, jeng = port_engine, jax_side[3]
    assert [(c.div.name, c.div.n_states, c.div.npat, c.div.ctype)
            for c in eng.div_cfg] == \
        [(c.div.name, c.div.n_states, c.div.npat, c.div.ctype)
         for c in jeng.div_cfg]
    assert [c.div.ctype for c in eng.div_cfg].count("ordered") == 3
    assert [c.div.n_states for c in eng.div_cfg] == \
        [2, 3, 3, 4, 4, 5, 5, 6, 7] + [4] * 6
    assert eng.n_groups == jeng.n_groups
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    assert {"add_branch", "del_branch", "fossilization_slider"} <= \
        {m.name for m in eng.moves}
    np.testing.assert_array_equal(eng.tip_dates, jeng.tip_dates)
    assert eng.fossil_tips.sum() == 45
    for i in range(eng.n_div):
        np.testing.assert_array_equal(eng.weights[i].numpy(),
                                      np.asarray(jeng.weights[i]))
    # each pruner's patterns carry the coding dummies
    assert [p.P for p in eng._pruners] == [
        c.div.npat + (c.div.n_states if c.coding != "all" else 0)
        for c in eng.div_cfg]
    names = [n for n, _ in param_columns(eng)]
    assert names == [n for n, _ in j_param_columns(jeng)]
    assert names[:7] == ["TL{all}", "TH{all}", "clockrate", "net_speciation",
                         "relative_extinction", "relative_fossilization",
                         "nSampledAncestors"]


def test_scores_match_jax_at_identical_states(port_engine, jax_side):
    jst, divs, lnp, _ = jax_side
    st = state_from_numpy(jst, "cpu")
    np.testing.assert_allclose(port_engine.division_lnls(st).numpy(), divs,
                               atol=2e-2, rtol=0)
    # the port's own eigensystems: the genes' refreshed in float32, the
    # standard buckets' (ordered ones included) built once in float64
    own = port_engine.refresh_eigs({k: v for k, v in st.items()
                                    if not k.startswith("eig")})
    np.testing.assert_allclose(port_engine.log_likelihood(own).numpy(),
                               divs.sum(1), atol=0.5, rtol=0)
    np.testing.assert_allclose(port_engine.log_prior(st).numpy(), lnp,
                               rtol=1e-4, atol=0)
    assert np.isfinite(lnp[0]) and lnp[0] > -1e20
    # the trees of gens 30 and 60 hold a fossil on a zero-length branch,
    # unflagged in the rows' states
    assert (lnp[1:] < -1e20).all()


def test_sampled_ancestor_is_a_zero_length_branch(port_engine):
    """A state with sampled ancestors: each one's tip branch has length 0
    in the extracted rooted tree and in its Newick, and no other tip's."""
    eng = port_engine
    st = eng.init_state(np.random.default_rng(8))
    n, root = eng.n_tips, 2 * eng.n_tips - 2
    for v in np.flatnonzero(eng.fossil_tips):
        q = st["parent"][v]
        sib = st["right"][q] if st["left"][q] == v else st["left"][q]
        if q != root and st["age"][sib] < st["age"][v] \
                and not (sib < n and st["sa"][sib]):
            st["sa"][v] = 1
    t = eng.extract_tree({k: np.asarray(v)[None] for k, v in st.items()}, 0)
    t.check()
    zero = np.flatnonzero(t.blen[:n] == 0)
    np.testing.assert_array_equal(zero, np.flatnonzero(st["sa"]))
    assert zero.size > 0 and t.rooted
    nwk = to_newick(t, numbers=True)
    assert all(f"{v + 1}:0," in nwk or f"{v + 1}:0)" in nwk for v in zero)
