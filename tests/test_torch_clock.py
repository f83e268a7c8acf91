"""Clock trees in the port (``mcmc/clock.py``, the engine's clock branch,
the rooted outputs and the CLI's clock settings) against the JAX package,
on the CPU, at small size.

* the prior and branch-length functions at 1e-5 relative on random clock
  trees of 6-16 tips: ``clock_blens`` (strict, igr, iln, wn, tk02),
  ``ln_uniform_clock``, ``ln_birthdeath_strat`` (random, diversity,
  cluster), ``ln_coalescence`` (growth 0 and not) and
  ``ln_branch_rates_prior`` (igr, iln, wn, tk02);
* ``random_clock_tree`` draws the JAX package's tree and ages;
* engines at identical states (``convert.state_from_numpy``, the JAX
  eigensystem cache carried): test2's model (lnL within 5e-3, lnPrior
  within 1e-4) and four (clockpr, clockvarpr) pairs (lnPrior 1e-4);
* the ``clock_uniform_gtr_g`` golden rows: lnL within 0.2 and lnPrior
  within 0.01 of the reference binary (tests/test_clock.py:37-53), and
  5e-3 / 1e-4 of JAX;
* the moves keep a valid clock tree (tests/test_clock.py:81-200), short
  runs of every (clockpr, clockvarpr) pair of tests/test_clock.py:56-60,
  test2's .p header against JAX's, a clock engine over 2 site shards,
  test2 through the CLI (complete files, [&R] trees, the checkpoint, sumt
  against JAX's), and the settings of ROADMAP Queue 1 item 10b, once
  refused, now taken as the JAX package takes them.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.data import DataSet as JDataSet
from mrbayes_tpu.data import make_divisions as j_make_divisions
from mrbayes_tpu.mcmc import clock as JC
from mrbayes_tpu.mcmc.engine import Engine as JEngine
from mrbayes_tpu.mcmc.engine import _scalar_prior_lpdf as j_lpdf
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.mcmc.settings import DivisionSettings as JDiv
from mrbayes_tpu.mcmc.settings import McmcSettings as JMcmc
from mrbayes_tpu.mcmc.settings import Prior as JPrior
from mrbayes_tpu.mcmc.settings import TreeSettings as JTree
from mrbayes_tpu.nexus.parser import read_nexus_file as j_read
from mrbayes_tpu.summarize.sumt import sumt as j_sumt
from mrbayes_tpu.trees import parse_newick as j_parse_newick
from mrbayes_tpu.trees import random_clock_tree as j_random_clock_tree
from mrbayes_tpu_torch.cli import CommandError, Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.envelope import BATCHES
from mrbayes_tpu_torch.mcmc import clock as CL
from mrbayes_tpu_torch.mcmc.engine import Engine, _scalar_prior_lpdf
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings, McmcSettings,
                                             Prior, TreeSettings)
from mrbayes_tpu_torch.nexus.parser import read_nexus_file
from mrbayes_tpu_torch.summarize.sumt import sumt
from mrbayes_tpu_torch.trees import parse_newick, random_clock_tree
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = [r for r in json.load(open(os.path.join(HERE, "golden_primates.json")))
        if r["model"] == "clock_uniform_gtr_g"]
C = 4
REL = 1e-5
TREEAGE = (1.0, 1.0)        # treeagepr's default, gamma(1, 1)


def _close(a, b, rtol=REL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol, atol=0)


def _clock_arrays(n_tips, seed, var=1.0):
    """C random clock trees (numpy, the port's ``random_clock_tree``) with
    ages spread over two orders of magnitude, a clock rate, IGR-like
    lognormal branch rates of variance ``var`` and a rate variance."""
    rng = np.random.default_rng(seed)
    trees = [random_clock_tree(n_tips, rng, mean_age=rng.uniform(0.05, 5.0))
             for _ in range(C)]
    s2 = np.log1p(var)
    st = {k: np.stack([getattr(t, k) for t, _ in trees]).astype(np.int32)
          for k in ("left", "right", "parent")}
    st["age"] = np.stack([a for _, a in trees]).astype(np.float32)
    st["clockrate"] = rng.uniform(0.3, 3.0, (C, 1)).astype(np.float32)
    st["brate"] = rng.lognormal(-0.5 * s2, np.sqrt(s2),
                                (C, 2 * n_tips - 1)).astype(np.float32)
    st["clockvar"] = rng.uniform(0.1, 2.0, (C, 1)).astype(np.float32)
    return st, rng


def _jax(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def _port_lpdf(t):
    return _scalar_prior_lpdf(Prior("gamma", TREEAGE), t)


def _jax_lpdf(t):
    return j_lpdf(JPrior("gamma", TREEAGE), t)


@pytest.mark.parametrize("n_tips", [6, 12, 16])
def test_random_clock_tree_equals_jax(n_tips):
    t, ages = random_clock_tree(n_tips, np.random.default_rng(n_tips))
    jt, jages = j_random_clock_tree(n_tips, np.random.default_rng(n_tips))
    for k in ("parent", "left", "right", "blen"):
        np.testing.assert_array_equal(getattr(t, k), getattr(jt, k))
    np.testing.assert_array_equal(ages, jages)
    t.check()
    assert t.rooted and ages[t.root] == ages.max()


@pytest.mark.parametrize("clockvar", ["strict", "igr", "iln", "wn", "tk02"])
@pytest.mark.parametrize("n_tips", [6, 16])
def test_clock_blens_match_jax(clockvar, n_tips):
    st, _ = _clock_arrays(n_tips, 10 + n_tips, var=5.0)
    want = jax.vmap(lambda s: JC.clock_blens(s, n_tips, clockvar))(_jax(st))
    got = CL.clock_blens(state_from_numpy(st, "cpu"), n_tips, clockvar)
    _close(got.numpy(), want)
    assert (got[:, 2 * n_tips - 2] == 0).all() and (got >= 0).all()


def test_ln_uniform_clock_matches_jax():
    for n_tips in (6, 11, 16):
        st, _ = _clock_arrays(n_tips, n_tips)
        want = jax.vmap(lambda a: JC.ln_uniform_clock(a, n_tips, _jax_lpdf))(
            jnp.asarray(st["age"]))
        got = CL.ln_uniform_clock(torch.as_tensor(st["age"]), n_tips,
                                  _port_lpdf)
        _close(got.numpy(), want)


@pytest.mark.parametrize("strategy,samp", [("random", 1.0), ("random", 0.5),
                                           ("diversity", 0.5),
                                           ("cluster", 0.4)])
def test_ln_birthdeath_matches_jax(strategy, samp):
    for n_tips in (6, 16):
        st, rng = _clock_arrays(n_tips, 30 + n_tips)
        net = rng.uniform(0.2, 3.0, C).astype(np.float32)
        turn = rng.uniform(0.05, 0.9, C).astype(np.float32)
        want = jax.vmap(lambda a, d, r: JC.ln_birthdeath_strat(
            a, n_tips, d, r, samp, _jax_lpdf, strategy=strategy))(
                jnp.asarray(st["age"]), jnp.asarray(net), jnp.asarray(turn))
        got = CL.ln_birthdeath_strat(
            torch.as_tensor(st["age"]), n_tips, torch.as_tensor(net),
            torch.as_tensor(turn), samp, _port_lpdf, strategy=strategy)
        _close(got.numpy(), want)


@pytest.mark.parametrize("growth", [0.0, 0.8])
def test_ln_coalescence_matches_jax(growth):
    for n_tips in (6, 16):
        st, rng = _clock_arrays(n_tips, 50 + n_tips)
        theta = rng.uniform(0.05, 2.0, C).astype(np.float32)
        g = np.full(C, growth, np.float32)
        cr = st["clockrate"][:, 0]
        want = jax.vmap(lambda a, t, gr, c: JC.ln_coalescence(
            a, n_tips, t, gr, c))(jnp.asarray(st["age"]), jnp.asarray(theta),
                                  jnp.asarray(g), jnp.asarray(cr))
        got = CL.ln_coalescence(torch.as_tensor(st["age"]), n_tips,
                                torch.as_tensor(theta), torch.as_tensor(g),
                                torch.as_tensor(cr))
        _close(got.numpy(), want)


@pytest.mark.parametrize("clockvar", ["igr", "iln", "wn", "tk02"])
def test_ln_branch_rates_prior_matches_jax(clockvar):
    for n_tips in (6, 16):
        st, _ = _clock_arrays(n_tips, 70 + n_tips, var=2.0)
        want = jax.vmap(lambda s: JC.ln_branch_rates_prior(
            s, n_tips, clockvar, s["clockvar"][0]))(_jax(st))
        tst = state_from_numpy(st, "cpu")
        got = CL.ln_branch_rates_prior(tst, n_tips, clockvar,
                                       tst["clockvar"][:, 0])
        _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# engines at identical states


def _test2_lines(nruns=1, nchains=C):
    data, model = BATCHES["test2"]
    return [f"execute {data}", *model,
            f"mcmcp nruns={nruns} nchains={nchains} seed=5"]


def _random_submodel(rng):
    z = np.zeros(6, np.int32)
    for i in range(1, 6):
        z[i] = rng.integers(0, z[:i].max() + 2)
    k = z.max() + 1
    props = rng.dirichlet(np.ones(k) * 4.0)
    return z, (props / np.bincount(z, minlength=k))[z].astype(np.float32)


def _jax_scores(eng, st):
    @jax.jit
    def scores(s):
        s = jax.vmap(eng.refresh_eigs)(s)
        return (s, jax.vmap(eng.log_likelihood)(s),
                jax.vmap(eng.log_prior)(s))

    jst, lnL, lnP = scores(_jax(st))
    return {k: np.asarray(v) for k, v in jst.items()}, np.asarray(lnL), \
        np.asarray(lnP)


def _spread_clock(st, rng, n_nodes):
    """Ages stretched by up to 20x, IGR-like rates of variance 1-5."""
    st["age"] = (st["age"] * rng.uniform(1.0, 20.0, (C, 1))).astype(
        np.float32)
    for k, shape, lo, hi in (("clockrate", (C, 1), 0.2, 3.0),
                             ("clockvar", (C, 1), 0.05, 2.0)):
        if k in st:
            st[k] = rng.uniform(lo, hi, shape).astype(np.float32)
    if "brate" in st:
        s2 = np.log1p(rng.uniform(1.0, 5.0, (C, 1)))
        st["brate"] = np.exp(rng.normal(-0.5 * s2, np.sqrt(s2),
                                        (C, n_nodes))).astype(np.float32)
    return st


def _tk02_rates(st, rng):
    """Branch rates drawn from the TK02 process itself: each node's rate
    lognormal about its parent's, log-variance clockvar x its branch
    length (the root's rate 1)."""
    rates = np.ones_like(st["age"])
    for c in range(C):
        age, par = st["age"][c], st["parent"][c]
        for v in np.argsort(-age, kind="stable"):
            if par[v] < 0:
                continue
            s2 = st["clockvar"][c, 0] * (age[par[v]] - age[v]) \
                * st["clockrate"][c, 0]
            rates[c, v] = rates[c, par[v]] * np.exp(
                rng.normal(-0.5 * s2, np.sqrt(s2)))
    return rates.astype(np.float32)


@pytest.fixture(scope="module")
def test2_jax():
    """JAX's test2 engine, identical random states and their scores."""
    it = JInterpreter(log=lambda m: None)
    for c in _test2_lines():
        it.run_line(c)
    eng = it.build_engine()
    rng = np.random.default_rng(5)
    per = [eng.init_state(rng) for _ in range(C)]
    st = {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]
          if not k.startswith("eig")}
    zs = [[_random_submodel(rng) for _ in range(2)] for _ in range(C)]
    st["gtr_class"] = np.array([[z for z, _ in row] for row in zs], np.int32)
    st["revmat"] = np.array([[v for _, v in row] for row in zs], np.float32)
    st["pi"] = rng.dirichlet(np.ones(4) * 5, size=(C, 2)).astype(np.float32)
    st["shape"] = rng.uniform(0.2, 2.0, (C, 2)).astype(np.float32)
    st["pinvar"] = rng.uniform(0.05, 0.5, (C, 2)).astype(np.float32)
    st = _spread_clock(st, rng, eng.n_nodes)
    return (*_jax_scores(eng, st), eng)


@pytest.fixture(scope="module")
def test2_port():
    it = Interpreter(log=lambda m: None, device="cpu")
    for c in _test2_lines():
        it.run_line(c)
    return it


def test_test2_engine_matches_jax_at_identical_states(test2_jax, test2_port):
    jst, lnL, lnP, jeng = test2_jax
    eng = test2_port.build_engine()
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    assert [m.prior_scope for m in eng.moves] == \
        [m.prior_scope for m in jeng.moves]
    assert [m.tuning0 for m in eng.moves] == [m.tuning0 for m in jeng.moves]
    st = state_from_numpy(jst, "cpu")
    assert "blen" not in st
    np.testing.assert_allclose(eng.log_likelihood(st).numpy(), lnL,
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(eng.log_prior(st).numpy(), lnP, atol=1e-4,
                               rtol=0)
    for slot in range(C):
        np.testing.assert_allclose(
            eng.effective_blens(st, slot),
            jeng.effective_blens({k: jnp.asarray(v) for k, v in jst.items()},
                                 slot), rtol=REL, atol=0)


def test_multiwalk_lnl_equals_per_division(test2_jax, test2_port):
    """Clock trees through the multiwalk group (test2's two divisions in
    one launch) give each division's own lnL."""
    st = state_from_numpy(test2_jax[0], "cpu")
    on = test2_port.build_engine(multiwalk=True)
    off = test2_port.build_engine(multiwalk=False)
    assert [g for g, _ in on._multiwalk_pruners] == [[0, 1]]
    np.testing.assert_allclose(on.division_lnls(st).numpy(),
                               off.division_lnls(st).numpy(), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("clockpr,clockvar", [
    ("uniform", "strict"), ("uniform", "tk02"), ("birthdeath", "strict"),
    ("coalescence", "strict")])
def test_clock_priors_match_jax(clockpr, clockvar):
    nf = j_read(example("primates.nex"))
    jeng = JEngine(JDataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                            divisions=j_make_divisions(nf.matrix)),
                   [JDiv(nst="2", rates="equal")],
                   tree_settings=JTree(clock=True, clockpr=clockpr,
                                       clockvarpr=clockvar,
                                       clockratepr=JPrior("exponential",
                                                          (1.0,))),
                   mcmc=JMcmc(nruns=1, nchains=C))
    rng = np.random.default_rng(17)
    per = [jeng.init_state(rng) for _ in range(C)]
    st = {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]
          if not k.startswith("eig")}
    st = _spread_clock(st, rng, jeng.n_nodes)
    if clockvar == "tk02":
        st["brate"] = _tk02_rates(st, rng)
    for k, lo, hi in (("speciation", 0.1, 3.0), ("extinction", 0.05, 0.9),
                      ("popsize", 0.05, 3.0), ("tratio", 0.5, 5.0)):
        if k in st:
            st[k] = rng.uniform(lo, hi, st[k].shape).astype(np.float32)
    jst, _, lnP = _jax_scores(jeng, st)
    pds = DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                  divisions=make_divisions(read_nexus_file(
                      example("primates.nex")).matrix))
    eng = Engine(pds, [DivisionSettings(nst="2", rates="equal")],
                 tree_settings=TreeSettings(
                     clock=True, clockpr=clockpr, clockvarpr=clockvar,
                     clockratepr=Prior("exponential", (1.0,))),
                 mcmc=McmcSettings(nruns=1, nchains=C), device="cpu")
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    np.testing.assert_allclose(eng.log_prior(state_from_numpy(jst, "cpu"))
                               .numpy(), lnP, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def primates():
    nf = read_nexus_file(example("primates.nex"))
    return DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                   divisions=make_divisions(nf.matrix))


def _ages_from_tree(t):
    ages = np.zeros(t.n_nodes)
    for v in t.postorder():
        ages[v] = max(ages[t.left[v]] + t.blen[t.left[v]],
                      ages[t.right[v]] + t.blen[t.right[v]])
    return ages


@pytest.fixture(scope="module")
def golden_engines(primates):
    nf = j_read(example("primates.nex"))
    jds = JDataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                   divisions=j_make_divisions(nf.matrix))
    jeng = JEngine(jds, [JDiv(nst="6", rates="gamma")],
                   tree_settings=JTree(clock=True, clockpr="uniform"),
                   mcmc=JMcmc(nruns=1, nchains=1))
    eng = Engine(primates, [DivisionSettings(nst="6", rates="gamma")],
                 tree_settings=TreeSettings(clock=True, clockpr="uniform"),
                 mcmc=McmcSettings(nruns=1, nchains=1), device="cpu")
    return jeng, eng


@pytest.mark.parametrize("i", range(len(GOLD)))
def test_golden_clock_rows(golden_engines, primates, i):
    rec = GOLD[i]
    jeng, eng = golden_engines
    jt = j_parse_newick(rec["newick"], primates.taxa, rooted=True)
    t = parse_newick(rec["newick"], primates.taxa, rooted=True)
    for k in ("parent", "left", "right"):
        np.testing.assert_array_equal(getattr(t, k), getattr(jt, k))
    assert t.parent[t.root] == -1 and t.blen[t.root] == 0
    jst = jeng.refresh_eigs({
        "left": jnp.asarray(jt.left), "right": jnp.asarray(jt.right),
        "parent": jnp.asarray(jt.parent),
        "age": jnp.asarray(_ages_from_tree(jt), jnp.float32),
        "pi": jnp.asarray([rec["pi"]], jnp.float32),
        "revmat": jnp.asarray([rec["revmat"]], jnp.float32),
        "shape": jnp.asarray([rec["alpha"]], jnp.float32)})
    j_lnl = float(jeng.log_likelihood(jst))
    j_lnp = float(jeng.log_prior(jst))
    st = state_from_numpy({k: np.asarray(v)[None] for k, v in jst.items()},
                          "cpu")
    own = eng.refresh_eigs({k: v for k, v in st.items()
                            if not k.startswith("eig")})
    lnl = float(eng.log_likelihood(own)[0])
    lnp = float(eng.log_prior(own)[0])
    assert abs(lnl - rec["lnL"]) < 0.2, (lnl, rec["lnL"])
    assert abs(lnp - rec["lnPrior"]) < 0.01, (lnp, rec["lnPrior"])
    assert abs(float(eng.log_likelihood(st)[0]) - j_lnl) < 5e-3
    assert abs(lnp - j_lnp) < 1e-4


# ---------------------------------------------------------------------------
# moves and runs


def _check_clock_tree(st, n_tips, what):
    P, L, R, A = (st[k].numpy() for k in ("parent", "left", "right", "age"))
    for c in range(P.shape[0]):
        assert P[c, 2 * n_tips - 2] == -1, what
        for v in range(2 * n_tips - 2):
            assert L[c, P[c, v]] == v or R[c, P[c, v]] == v, (what, c, v)
            assert A[c, P[c, v]] > A[c, v] - 1e-7, (what, c, v)


def _iterate_move(fn, n_tips, rounds, tuning=0.0, seed=0):
    """Apply one move to 8 chains ``rounds`` times, keeping each chain's
    proposal where its Hastings ratio is finite; the count of chain
    steps that changed the topology."""
    rng = np.random.default_rng(seed)
    trees = [random_clock_tree(n_tips, rng) for _ in range(8)]
    st = {k: torch.as_tensor(np.stack([getattr(t, k) for t, _ in trees]))
          .long() for k in ("left", "right", "parent")}
    st["age"] = torch.as_tensor(np.stack([a for _, a in trees]),
                                dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    tune = torch.full((8,), tuning)
    changed = 0
    for i in range(rounds):
        new, lnh = fn(gen, st, tune, n_tips)
        ok = lnh > -1e29
        assert torch.isfinite(lnh[ok]).all()
        step = {k: torch.where(ok.reshape(-1, *[1] * (v.ndim - 1)), new[k],
                               v) for k, v in st.items()}
        _check_clock_tree(step, n_tips, f"{fn} round {i}")
        changed += int((step["parent"] != st["parent"]).any(1).sum())
        st = step
    return changed


def test_subtree_swap_clock_invariants():
    assert _iterate_move(CL.move_subtree_swap_clock, 8, 40) > 40


def test_local_clock_invariants():
    assert _iterate_move(CL.move_local_clock, 8, 40, seed=1) > 80


def test_pars_spr_clock_invariants(primates):
    eng = Engine(primates, [DivisionSettings(nst="1")],
                 tree_settings=TreeSettings(clock=True),
                 mcmc=McmcSettings(nruns=1, nchains=1), device="cpu")
    fn = CL.make_pars_spr_clock_move(eng._pars_masks, eng._pars_factors)
    assert _iterate_move(fn, eng.n_tips, 30, tuning=0.2, seed=2) > 50


@pytest.mark.parametrize("move", ["spr_clock", "pars_spr_clock"])
def test_spr_without_a_target_keeps_a_tree(primates, move):
    """All internal ages equal: a pruned internal node has no target edge
    (no parent is older than it), so its chain must keep a well-formed
    tree, where surgery on a placeholder target could make a cycle."""
    n_tips = primates.ntax
    if move == "spr_clock":
        fn = CL.move_spr_clock
    else:
        eng = Engine(primates, [DivisionSettings(nst="1")],
                     tree_settings=TreeSettings(clock=True),
                     mcmc=McmcSettings(nruns=1, nchains=1), device="cpu")
        fn = CL.make_pars_spr_clock_move(eng._pars_masks, eng._pars_factors)
    rng = np.random.default_rng(4)
    trees = [random_clock_tree(n_tips, rng)[0] for _ in range(32)]
    st = {k: torch.as_tensor(np.stack([getattr(t, k) for t in trees]))
          .long() for k in ("left", "right", "parent")}
    age = np.zeros((32, 2 * n_tips - 1), np.float32)
    age[:, n_tips:] = 1.0
    st["age"] = torch.as_tensor(age)
    new, lnh = fn(torch.Generator().manual_seed(4), st,
                  torch.full((32,), 0.2), n_tips)
    assert (lnh < -1e29).any()
    _check_clock_tree(new, n_tips, move)
    P = new["parent"].numpy()
    for c in range(32):
        for v in range(2 * n_tips - 1):
            u, steps = v, 0
            while P[c, u] >= 0:
                u, steps = P[c, u], steps + 1
                assert steps < 2 * n_tips, (move, c, v)


@pytest.mark.parametrize("move", ["nni_clock", "spr_clock", "age_slider",
                                  "node_slider_clock", "tree_stretch",
                                  "root_age"])
def test_other_clock_moves_keep_a_clock_tree(move):
    fn = getattr(CL, "move_" + move)
    _iterate_move(fn, 8, 20, tuning=0.3, seed=3)


def test_run_keeps_a_valid_clock_tree(primates):
    eng = Engine(primates, [DivisionSettings()],
                 tree_settings=TreeSettings(clock=True, clockvarpr="igr"),
                 mcmc=McmcSettings(nruns=1, nchains=2, seed=3), device="cpu")
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 300)
    _check_clock_tree(states, eng.n_tips, "after 300 generations")
    assert CL.ages_ordered(states).all()
    for slot in range(2):
        t = eng.extract_tree(states, slot)
        t.check()
        b = eng.effective_blens(states, slot)
        assert t.rooted and b[t.root] == 0.0 and np.all(b >= 0)
    fresh = eng.score(states)
    for k in ("lnL", "lnP_tree", "lnP_par"):
        np.testing.assert_allclose(states[k].numpy(), fresh[k].numpy(),
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("clockpr,clockvar", [
    ("uniform", "strict"), ("uniform", "igr"), ("uniform", "iln"),
    ("uniform", "tk02"), ("uniform", "wn"), ("birthdeath", "strict"),
    ("coalescence", "strict")])
def test_clock_short_run(primates, clockpr, clockvar):
    eng = Engine(primates, [DivisionSettings(nst="2", rates="equal")],
                 tree_settings=TreeSettings(clock=True, clockpr=clockpr,
                                            clockvarpr=clockvar),
                 mcmc=McmcSettings(nruns=1, nchains=2, seed=13),
                 device="cpu")
    states, bk = eng.init_chains()
    l0 = states["lnL"].numpy().copy()
    states, bk = eng.run_block(states, bk, 150)
    l1 = states["lnL"].numpy()
    assert np.all(np.isfinite(l1)) and np.all(l1 > l0 - 50.0)
    assert CL.ages_ordered(states).all()


def test_p_header_equals_jax_param_columns(test2_jax, test2_port):
    jnames = [n for n, _ in j_param_columns(test2_jax[3])]
    names = [n for n, _ in param_columns(test2_port.build_engine())]
    # JAX prints both divisions' pinvar columns as pinvar{} (ROADMAP
    # Queue 3); the port prints pinvar{1} and pinvar{2}
    assert names == [n if n != "pinvar{}" else names[i]
                     for i, n in enumerate(jnames)]
    assert names[:4] == ["TL{all}", "TH{all}", "clockrate", "igrvar{all}"]
    assert "pinvar{1}" in names and "pinvar{2}" in names


def test_sharded_clock_engine_equals_unsharded(test2_jax, test2_port):
    from mrbayes_tpu_torch.parallel.mesh import make_mesh, shard_engine_data
    st = state_from_numpy(test2_jax[0], "cpu")
    whole = test2_port.build_engine().log_likelihood(st)
    eng = test2_port.build_engine()
    shard_engine_data(eng, make_mesh(1, 2, ["cpu"] * 2))
    np.testing.assert_allclose(eng.log_likelihood(st).numpy(),
                               whole.numpy(), atol=5e-3, rtol=0)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """test2 through the port's CLI on the CPU (1 run x 2 chains, 40
    generations), with the in-loop tree and score checks on."""
    d = tmp_path_factory.mktemp("test2")
    prefix = str(d / "test2")
    data, model = BATCHES["test2"]
    body = "".join(f"    {c};\n" for c in model)
    nex = d / "test2.nex"
    nex.write_text(f"#NEXUS\nbegin mrbayes;\n    execute {data};\n{body}"
                   f"    mcmc ngen=40 nruns=1 nchains=2 samplefreq=10 "
                   f"printfreq=20 diagnfreq=20 file={prefix};\n"
                   f"    sump;\n    sumt;\nend;\n")
    lines = []
    saved = {k: os.environ.get(k) for k in ("MB_DEBUG", "MB_DEBUG_LNL")}
    os.environ.update(MB_DEBUG="1", MB_DEBUG_LNL="1")
    try:
        it = Interpreter(log=lambda m: lines.append(str(m)), device="cpu",
                         multiwalk=True)
        it.execute_file(str(nex))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return it, prefix, lines


def test_cli_run_writes_rooted_files(cli_run):
    it, prefix, lines = cli_run
    runner = it._last_runner
    assert [g for g, _ in runner.eng._multiwalk_pruners] == [[0, 1]]
    with open(prefix + ".run1.p") as f:
        f.readline()
        header = f.readline().rstrip("\n").split("\t")
        rows = [ln.split("\t") for ln in f if ln.strip()]
    assert header[:5] == ["Gen", "lnLike", "lnPrior", "TL{all}", "TH{all}"]
    assert [int(r[0]) for r in rows] == [0, 10, 20, 30, 40]
    assert all(len(r) == len(header) for r in rows)
    with open(prefix + ".run1.t") as f:
        text = f.read()
    trees = [ln for ln in text.splitlines() if "tree gen." in ln]
    assert len(trees) == 5 and all("= [&R] (" in ln for ln in trees)
    assert text.rstrip().endswith("end;")
    with open(prefix + ".ckp") as f:
        ckp = f.read()
    assert ckp.count("= [&R] (") == 2 and "states.age" in ckp \
        and "states.brate" in ckp and "states.blen" not in ckp
    assert any("Credible splits" in ln for ln in lines)


def test_checkpoint_round_trip(cli_run):
    runner = cli_run[0]._last_runner
    states, bk, gen = runner.read_checkpoint()
    assert gen == 40
    for k in ("age", "brate", "clockrate", "clockvar", "parent", "left",
              "right", "pi", "revmat"):
        np.testing.assert_array_equal(states[k].numpy(),
                                      runner.final_states[k].numpy())
    for k in ("lnL", "lnP"):
        np.testing.assert_allclose(states[k].numpy(),
                                   runner.final_states[k].numpy(),
                                   atol=1e-3, rtol=0)


def test_sumt_on_rooted_trees_prints_what_jax_prints(cli_run, tmp_path):
    prefix = cli_run[1]
    ours, theirs = [], []
    sumt(prefix, log=ours.append, outputname=str(tmp_path / "port"))
    j_sumt(prefix, log=theirs.append, outputname=str(tmp_path / "jax"))
    assert ours == [ln.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                    for ln in theirs]
    with open(tmp_path / "port.parts") as f:
        parts = f.read().splitlines()[1:]
    # rooted clades: every tip appears on the counted side of some clade
    assert parts and all(ln.split("\t")[1].count("*") >= 1 for ln in parts)


# ---------------------------------------------------------------------------
# item 10b, once refused, is carried (tests/test_torch_dating.py,
# tests/test_torch_cpp.py and tests/test_torch_hymfossil.py hold it)


@pytest.mark.parametrize("field,value", [
    ("clockvarpr", "cpp"), ("clockvarpr", "mixed"),
    ("clockpr", "fossilization"), ("tip_calibrations", {0: Prior("fixed",
                                                                 (1.0,))}),
    ("constraints", [("c", np.ones(12, bool), None)]),
    ("treeage_calibrated", True)])
def test_engine_refuses_item_10b(primates, field, value):
    """The settings the engine refused naming item 10b now build an engine
    whose starting states have a finite prior, with their moves."""
    ts = TreeSettings(clock=True)
    setattr(ts, field, value)
    eng = Engine(primates, [DivisionSettings()], tree_settings=ts,
                 mcmc=McmcSettings(nruns=1, nchains=1), device="cpu")
    states, _ = eng.init_chains()
    assert (states["lnP"] > -1e20).all()
    assert torch.isfinite(states["lnL"]).all()
    names = {m.name for m in eng.moves}
    want = {"cpp": {"cpp_adddelete", "cpp_position", "cpp_multiplier",
                    "cpprate_mult"},
            "mixed": {"brate_mult", "clockvar_mult", "rcl_jump"},
            "fossilization": {"fossilization_slider"}}.get(
                value if isinstance(value, str) else "", set())
    assert want <= names
    if field == "tip_calibrations":
        assert eng.has_dated_tips and float(states["age"][0, 0]) == 1.0


@pytest.mark.parametrize("line", [
    "prset clockvarpr=cpp", "prset clockvarpr=mixed",
    "prset brlenspr=clock:fossilization", "prset cppratepr=exp(1)",
    "prset cppmultdevpr=fixed(0.4)", "prset mixedvarpr=exp(1)",
    "prset fossilizationpr=beta(1,1)", "prset nodeagepr=calibrated",
    "prset topologypr=uniform", "constraint c = 1 2",
    "calibrate Tarsius = fixed(1)"])
def test_cli_refuses_item_10b(line):
    """The commands the CLI refused naming item 10b are now taken, with
    the JAX package's meaning."""
    it = Interpreter(log=lambda m: None, device="cpu")
    it.execute_file(example("primates.nex"))
    jit = JInterpreter(log=lambda m: None)
    jit.execute_file(example("primates.nex"))
    it.run_line(line)
    jit.run_line(line)
    ts, jts = it.env.tree_settings, jit.env.tree_settings
    for k in ("clock", "clockpr", "clockvarpr", "nodeagepr"):
        assert getattr(ts, k) == getattr(jts, k)
    for k in ("cppratepr", "cppmultdevpr", "mixedvarpr", "fossilizationpr",
              "topologypr"):
        a, b = getattr(ts, k), getattr(jts, k)
        assert (a.kind, a.params) == (b.kind, b.params)
    assert {k: v[0] for k, v in it.env.constraints.items()} == \
        {k: v[0] for k, v in jit.env.constraints.items()}
    assert {k: (v.kind, v.params) for k, v in it.env.calibrations.items()} \
        == {k: (v.kind, v.params) for k, v in jit.env.calibrations.items()}
