"""Dating in the port (ROADMAP Queue 1 item 10b: ``mcmc/clock.py``'s
fossilized birth-death prior, sampled ancestors, dated tips and the
tip-date slider; the engine's constraints and calibrations; the CLI's
taxset, exclude/include, ctype, constraint and calibrate; ordered Mk)
against the JAX package, on the CPU (tests/test_fbd.py restated).

* ``random_clock_tree`` with dated tips and the constrained builders draw
  the JAX package's trees;
* ``ln_fbd`` (random, fossiltip, diversity), the sampled-ancestor prior,
  ``pin_sa_ages`` and ``ln_uniform_clock_dated`` within 1e-4 relative of
  JAX's on seeded dated trees (and the reference formulas of
  tests/reference_impl.py);
* the add/delete-branch and tip-date moves and the clock moves of item
  10a on trees whose tips have ages keep a valid dated tree;
* hard, negative and partial constraints: the constraint terms equal
  JAX's, and short runs stay inside them; the calibrated-node density;
* the dating commands through both CLIs give equal engine settings;
* ``ordered_mk_q`` equals JAX's;
* a prior-only FBD run of 8 tips and 3 fossils against JAX's with the
  add/delete-branch pair off on both: the mean root age within 4
  batch-means standard errors (the port accepts sampled ancestors where
  JAX cannot, ROADMAP Queue 3; tests/test_torch_sampled_ancestors.py
  holds them).

hymfossil.nex's analysis is held in tests/test_torch_hymfossil.py.
"""
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
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.mcmc.settings import DivisionSettings as JDiv
from mrbayes_tpu.mcmc.settings import McmcSettings as JMcmc
from mrbayes_tpu.mcmc.settings import Prior as JPrior
from mrbayes_tpu.mcmc.settings import TreeSettings as JTree
from mrbayes_tpu.models.substitution import ordered_mk_q as j_ordered_mk_q
from mrbayes_tpu.nexus.datatypes import DataType as JDataType
from mrbayes_tpu.nexus.datatypes import FormatInfo as JFormatInfo
from mrbayes_tpu.nexus.parser import CharacterMatrix as JMatrix
from mrbayes_tpu.trees import random_clock_tree as j_random_clock_tree
from mrbayes_tpu.trees import \
    random_clock_tree_constrained as j_random_clock_tree_constrained
from mrbayes_tpu.trees import \
    random_unrooted_constrained as j_random_unrooted_constrained
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.mcmc import clock as CL
from mrbayes_tpu_torch.mcmc.engine import Engine, _scalar_prior_lpdf
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings, McmcSettings,
                                             Prior, TreeSettings)
from mrbayes_tpu_torch.models.substitution import ordered_mk_q
from mrbayes_tpu_torch.nexus.datatypes import DataType, FormatInfo
from mrbayes_tpu_torch.nexus.parser import CharacterMatrix
from mrbayes_tpu_torch.ops.traversal import ancestor_matrix
from mrbayes_tpu_torch.trees import (parse_newick, random_clock_tree,
                                     random_clock_tree_constrained,
                                     random_unrooted_constrained)
from conftest import example
from reference_impl import (fbd_prior_fossiltip, fbd_prior_random,
                            uniform_dated_prior)

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

C = 4
REL = 1e-4


def _close(a, b, rtol=REL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol, atol=0)


def _zero_lpdf(t):
    return t * 0.0


def _dated(n_tips=8, n_fossils=3, seed=0):
    """C seeded dated clock trees (each chain's fossils, the first
    n_fossils tips, aged 0.2-1) as numpy arrays, and the fossil mask."""
    rng = np.random.default_rng(seed)
    fossil = np.arange(n_tips) < n_fossils
    trees = []
    for _ in range(C):
        tip_ages = np.where(fossil, rng.uniform(0.2, 1.0, n_tips), 0.0)
        trees.append(random_clock_tree(n_tips, rng, mean_age=1.5,
                                       tip_ages=tip_ages))
    st = {k: np.stack([getattr(t, k) for t, _ in trees]).astype(np.int32)
          for k in ("left", "right", "parent")}
    st["age"] = np.stack([a for _, a in trees]).astype(np.float32)
    return st, fossil, rng


def _with_sa(st, fossil):
    """Every fossil whose sibling is younger (and whose parent is not the
    root) made a sampled ancestor, its parent's age pinned to its own."""
    st = {k: v.copy() for k, v in st.items()}
    n_tips = fossil.size
    st["sa"] = np.zeros((C, n_tips), np.int32)
    for c in range(C):
        P, L, R, A = (st[k][c] for k in ("parent", "left", "right", "age"))
        for v in np.flatnonzero(fossil):
            q = P[v]
            sib = R[q] if L[q] == v else L[q]
            if q != 2 * n_tips - 2 and A[sib] < A[v] \
                    and not (sib < n_tips and st["sa"][c, sib]):
                st["sa"][c, v] = 1
                A[q] = A[v]
    assert st["sa"].sum() > 0
    return st


def _rates(rng):
    return [rng.uniform(lo, hi, C).astype(np.float32)
            for lo, hi in ((0.1, 2.0), (0.05, 0.9), (0.05, 0.8))]


@pytest.mark.parametrize("n_tips", [8, 13])
def test_dated_and_constrained_trees_equal_jax(n_tips):
    tip_ages = np.zeros(n_tips)
    tip_ages[:3] = [0.4, 0.9, 0.2]
    a = random_clock_tree(n_tips, np.random.default_rng(1), 1.5, tip_ages)
    b = j_random_clock_tree(n_tips, np.random.default_rng(1), 1.5, tip_ages)
    masks = [np.arange(n_tips) < 4, (np.arange(n_tips) >= 2)
             & (np.arange(n_tips) < 4)]
    c = random_clock_tree_constrained(n_tips, np.random.default_rng(2),
                                      masks, 1.0, tip_ages)
    d = j_random_clock_tree_constrained(n_tips, np.random.default_rng(2),
                                        masks, 1.0, tip_ages)
    e = random_unrooted_constrained(n_tips, np.random.default_rng(3), masks)
    f = j_random_unrooted_constrained(n_tips, np.random.default_rng(3), masks)
    for (t, ages), (jt, jages) in ((a, b), (c, d), ((e, None), (f, None))):
        for k in ("parent", "left", "right", "blen"):
            np.testing.assert_array_equal(getattr(t, k), getattr(jt, k))
        if ages is not None:
            np.testing.assert_array_equal(ages, jages)
            assert (ages[:n_tips] == tip_ages).all()
        t.check()


@pytest.mark.parametrize("strategy", ["random", "fossiltip", "diversity"])
def test_ln_fbd_matches_jax(strategy):
    st, fossil, rng = _dated(seed=1)
    d, r, s = _rates(rng)
    rho = 0.25 if strategy == "diversity" else 0.8
    want = jax.vmap(lambda a, d_, r_, s_: JC.ln_fbd(
        a, 8, d_, r_, s_, rho, jnp.asarray(fossil), _zero_lpdf,
        strategy=strategy))(jnp.asarray(st["age"]), *map(jnp.asarray,
                                                         (d, r, s)))
    got = CL.ln_fbd(torch.as_tensor(st["age"]), 8, *map(torch.as_tensor,
                                                        (d, r, s)),
                    rho, fossil, _zero_lpdf, strategy=strategy)
    assert np.all(np.isfinite(want))
    _close(got.numpy(), want)
    oracle = {"random": fbd_prior_random,
              "fossiltip": fbd_prior_fossiltip}.get(strategy)
    if oracle is not None:
        for c in range(C):
            lam, mu, psi = (float(x[c]) for x in CL.fbd_rates(
                *map(torch.as_tensor, (d, r, s)), strategy))
            ref = oracle(st["age"][c].astype(np.float64), 8, lam, mu, psi,
                         rho, fossil)
            assert abs(float(got[c]) - ref) < 5e-3 * max(1.0, abs(ref))


@pytest.mark.parametrize("strategy", ["random", "diversity"])
def test_sampled_ancestor_prior_matches_jax(strategy):
    """An ancestral fossil's parent contributes psi instead of lambda q,
    its tip term drops and the labeled-tree factor loses it (reference
    src/mcmc.c:9073-9085): the port's prior equals JAX's and the
    oracle's, and differs from the same ages without the flags."""
    base, fossil, rng = _dated(seed=2)
    st = _with_sa(base, fossil)
    d, r, s = _rates(rng)
    rho = 0.25 if strategy == "diversity" else 0.8
    want = jax.vmap(lambda a, sa, p, d_, r_, s_: JC.ln_fbd(
        a, 8, d_, r_, s_, rho, jnp.asarray(fossil), _zero_lpdf,
        strategy=strategy, sa=sa, parent=p))(
            *map(jnp.asarray, (st["age"], st["sa"], st["parent"], d, r, s)))
    tst = state_from_numpy(st, "cpu")
    rates = [torch.as_tensor(x) for x in (d, r, s)]
    got = CL.ln_fbd(tst["age"], 8, *rates, rho, fossil, _zero_lpdf,
                    strategy=strategy, sa=tst["sa"], parent=tst["parent"])
    _close(got.numpy(), want)
    without = CL.ln_fbd(tst["age"], 8, *rates, rho, fossil, _zero_lpdf,
                        strategy=strategy, sa=torch.zeros_like(tst["sa"]),
                        parent=tst["parent"])
    has = st["sa"].sum(1) > 0
    assert np.all(np.abs(got.numpy() - without.numpy())[has] > 1e-3)
    if strategy == "random":
        for c in range(C):
            lam, mu, psi = (float(x[c]) for x in CL.fbd_rates(*rates,
                                                              strategy))
            ref = fbd_prior_random(st["age"][c].astype(np.float64), 8, lam,
                                   mu, psi, rho, fossil,
                                   sa=st["sa"][c] > 0,
                                   parent=st["parent"][c])
            assert abs(float(got[c]) - ref) < 5e-3 * max(1.0, abs(ref))


def test_pin_sa_ages_matches_jax():
    base, fossil, _ = _dated(seed=3)
    st = _with_sa(base, fossil)
    # unpin the raw ages: the pin must restore them
    raw = st["age"].copy()
    for c in range(C):
        for v in np.flatnonzero(st["sa"][c]):
            raw[c, st["parent"][c, v]] += 0.37
    st["age"] = raw
    want = jax.vmap(lambda s: JC.pin_sa_ages(s, 8)["age"])(
        {k: jnp.asarray(v) for k, v in st.items()})
    got = CL.pin_sa_ages(state_from_numpy(st, "cpu"), 8)["age"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert CL.pin_sa_ages({"age": 1}, 8) == {"age": 1}


@pytest.mark.parametrize("n_tips,n_fossils", [(9, 4), (7, 0)])
def test_ln_uniform_clock_dated_matches_jax(n_tips, n_fossils):
    st, fossil, _ = _dated(n_tips, n_fossils, seed=4)
    lpdf = (lambda t: _scalar_prior_lpdf(Prior("gamma", (2.0, 2.0)), t))
    jl = (lambda t: JC.jnp.log(t) * 1.0 - 2.0 * t + 2.0 * np.log(2.0))
    got = CL.ln_uniform_clock_dated(torch.as_tensor(st["age"]), n_tips,
                                    fossil, lpdf, root_dated=False)
    want = jax.vmap(lambda a: JC.ln_uniform_clock_dated(
        a, n_tips, jnp.asarray(fossil), jl, root_dated=False))(
            jnp.asarray(st["age"]))
    _close(got.numpy(), want)
    root = 2 * n_tips - 2
    for c in range(C):
        ages = st["age"][c].astype(np.float64)
        ref = uniform_dated_prior(ages, n_tips) if n_fossils else float(
            CL.ln_uniform_clock(torch.as_tensor(ages[None]), n_tips,
                                _zero_lpdf)[0])
        ref += float(lpdf(torch.tensor(ages[root])))
        assert abs(float(got[c]) - ref) < 5e-3 * max(1.0, abs(ref))


# ---------------------------------------------------------------------------
# moves on dated trees


def _check(st, n_tips, fossil_ages, what):
    P, L, R = (st[k].numpy() for k in ("parent", "left", "right"))
    A = CL.pin_sa_ages(st, n_tips)["age"].numpy()
    for c in range(P.shape[0]):
        assert P[c, 2 * n_tips - 2] == -1, what
        for v in range(2 * n_tips - 2):
            assert L[c, P[c, v]] == v or R[c, P[c, v]] == v, (what, c, v)
            assert A[c, P[c, v]] >= A[c, v], (what, c, v)
    np.testing.assert_array_equal(st["age"][:, :n_tips].numpy(),
                                  fossil_ages)


def _iterate(fn, st, n_tips, rounds, tuning=0.3, seed=0):
    """Apply one move ``rounds`` times, keeping each chain's proposal where
    its Hastings ratio is finite and its pinned ages stay ordered (what
    the engine's prior would accept); the count of kept proposals that
    changed the state."""
    gen = torch.Generator().manual_seed(seed)
    tip_ages = st["age"][:, :n_tips].numpy().copy()
    tune = torch.full((st["age"].shape[0],), tuning)
    changed = 0
    for i in range(rounds):
        new, lnh = fn(gen, st, tune, n_tips)
        ok = (lnh > -1e29) & CL.ages_ordered(CL.pin_sa_ages(new, n_tips))
        assert torch.isfinite(lnh[ok]).all()
        step = {k: torch.where(ok.reshape(-1, *[1] * (v.ndim - 1)), new[k],
                               v) for k, v in st.items()}
        if "tip" not in getattr(fn, "__name__", ""):
            _check(step, n_tips, tip_ages, f"{fn} round {i}")
        changed += int(sum((step[k] != st[k]).reshape(C, -1).any(1).sum()
                           for k in st))
        st = step
    return st, changed


@pytest.mark.parametrize("move", [
    "nni_clock", "spr_clock", "subtree_swap_clock", "local_clock",
    "age_slider", "node_slider_clock", "tree_stretch", "root_age"])
def test_clock_moves_keep_a_dated_tree(move):
    """The clock moves of item 10a read the tips' ages as well: on trees
    with 3 dated fossils of 10 tips they never move a tip and keep every
    accepted tree ordered."""
    st, _, _ = _dated(10, 3, seed=5)
    st = {k: torch.as_tensor(v).long() if k != "age" else torch.as_tensor(v)
          for k, v in st.items()}
    _, changed = _iterate(getattr(CL, "move_" + move), st, 10, 30)
    assert changed > 0


def test_add_del_branch_and_tip_date_moves():
    """Delete-branch makes a fossil tip a sampled ancestor (its parent's
    age pinned: a zero-length branch) with the Hastings ratio log m -
    log(k+1) - log(window); add-branch undoes it, drawing the parent's age
    in (fossil age, grandparent age); the tip-date slider keeps a
    calibrated tip inside its bounds and below its parent."""
    base, fossil, _ = _dated(10, 4, seed=6)
    st = {k: torch.as_tensor(v).long() if k != "age" else torch.as_tensor(v)
          for k, v in base.items()}
    st["sa"] = torch.zeros((C, 10), dtype=torch.long)
    fos = torch.as_tensor(fossil)
    dele, add = (CL.make_add_del_branch(fos, a) for a in (False, True))
    gen = torch.Generator().manual_seed(6)
    tune = torch.zeros(C)
    made = 0
    for _ in range(12):
        new, lnh = dele(gen, st, tune, 10)
        ok = lnh > -1e29
        for c in np.flatnonzero(ok.numpy()):
            v = int(np.flatnonzero((new["sa"][c] != st["sa"][c]).numpy())[0])
            q = int(st["parent"][c, v])
            g = int(st["parent"][c, q])
            assert fossil[v] and new["sa"][c, v] == 1
            assert new["age"][c, q] == st["age"][c, v]
            m, k = int((fos & (st["sa"][c] == 0)).sum()), \
                int((fos & (st["sa"][c] > 0)).sum())
            win = float(st["age"][c, g] - st["age"][c, v])
            assert float(lnh[c]) == pytest.approx(
                np.log(m) - np.log(k + 1) - np.log(win), rel=1e-4)
        st = {k: torch.where(ok.reshape(-1, *[1] * (v.ndim - 1)), new[k], v)
              for k, v in st.items()}
        made += int(ok.sum())
    assert made > 0
    b = CL.clock_blens(CL.pin_sa_ages(st, 10), 10, "strict")
    assert ((b[:, :10] == 0) == (st["sa"] > 0)).all()
    new, lnh = add(gen, st, tune, 10)
    for c in np.flatnonzero((lnh > -1e29).numpy()):
        v = int(np.flatnonzero((new["sa"][c] != st["sa"][c]).numpy())[0])
        q, lo = int(st["parent"][c, v]), float(st["age"][c, v])
        g = int(st["parent"][c, q])
        assert new["sa"][c, v] == 0 and lo < float(new["age"][c, q]) \
            < float(st["age"][c, g])
    # the tip-date slider on tips 0 and 1, calibrated uniform(0.1, 0.6)
    # and uniform(0.3, 2.0)
    tips = torch.tensor([0, 1])
    slide = CL.make_tip_date_move(tips, torch.tensor([0.1, 0.3]),
                                  torch.tensor([0.6, 2.0]))
    st = {k: v for k, v in st.items() if k != "sa"}
    for _ in range(20):
        new, lnh = slide(gen, st, tune, 10)
        ok = lnh > -1e29
        age, par = new["age"], new["parent"]
        for c in np.flatnonzero(ok.numpy()):
            for v, (lo, hi) in ((0, (0.1, 0.6)), (1, (0.3, 2.0))):
                if age[c, v] != st["age"][c, v]:
                    assert lo <= age[c, v] <= min(hi, age[c, par[c, v]])
        st = {k: torch.where(ok.reshape(-1, *[1] * (v.ndim - 1)), new[k], v)
              for k, v in st.items()}


# ---------------------------------------------------------------------------
# constraints and calibrations


def _mini(ntax=8, nchar=60, seed=5, jax_side=False):
    """tests/test_fbd.py's random DNA matrix, as a DataSet of either
    package."""
    rng = np.random.default_rng(seed)
    codes = (1 << rng.integers(0, 4, size=(ntax, nchar))).astype(np.uint32)
    taxa = [f"t{i}" for i in range(ntax)]
    if jax_side:
        m = JMatrix(taxa=taxa, nchar=nchar,
                    fmt=JFormatInfo(datatype=JDataType.DNA), codes=codes,
                    col_datatype=[JDataType.DNA] * nchar)
        return JDataSet(taxa=taxa, nchar=nchar,
                        divisions=j_make_divisions(m))
    m = CharacterMatrix(taxa=taxa, nchar=nchar,
                        fmt=FormatInfo(datatype=DataType.DNA), codes=codes,
                        col_datatype=[DataType.DNA] * nchar)
    return DataSet(taxa=taxa, nchar=nchar, divisions=make_divisions(m))


def _pair(ts_kwargs, ntax=6, seed=4, **mc):
    """The port's and JAX's engines on tests/test_fbd.py's matrix."""
    jts = {k: (JPrior(v.kind, v.params) if isinstance(v, Prior) else v)
           for k, v in ts_kwargs.items()}
    eng = Engine(_mini(ntax, 30, seed), [DivisionSettings(nst="1")],
                 tree_settings=TreeSettings(**ts_kwargs),
                 mcmc=McmcSettings(nruns=1, nchains=1, seed=3, **mc),
                 device="cpu")
    jeng = JEngine(_mini(ntax, 30, seed, True), [JDiv(nst="1")],
                   tree_settings=JTree(**jts),
                   mcmc=JMcmc(nruns=1, nchains=1, seed=3, **mc))
    return eng, jeng


TAXA6 = ["a", "b", "c", "d", "e", "f"]
TREES6 = ["(a,(b,((c,d),(e,f))));", "(a,(b,((c,e),(d,f))));",
          "(a,((b,(e,f)),(c,d)));", "(a,((b,(c,d)),(e,f)));",
          "(a,(d,((b,(c,e)),f)));"]


def _masks(*sets):
    out = []
    for s in sets:
        m = np.zeros(6, bool)
        m[list(s)] = True
        out.append(m)
    return out


@pytest.mark.parametrize("kind", ["hard", "negative", "partial", "clock"])
def test_constraint_terms_match_jax(kind):
    """Hard, negative and partial constraints on unrooted trees (and a
    calibrated hard one on rooted clock trees): the terms of every tree
    equal JAX's, 0 where satisfied and -inf where broken."""
    m1, m2, m3, m4 = _masks((2, 3), (1, 2), (4, 5), (0, 1))
    cons = {"hard": [("cd", m1, None)],
            "negative": [("no_cd", "negative", m1, None, None)],
            "partial": [("bb", "partial", m2, m3, None)],
            "clock": [("cd", m1, Prior("uniform", (0.0, 3.0))),
                      ("no_ab", "negative", m4, None, None)]}[kind]
    clock = kind == "clock"
    eng, jeng = _pair(dict(constraints=cons, clock=clock))
    states, jstates = [], []
    for i, nwk in enumerate(TREES6):
        t = parse_newick(nwk, TAXA6, rooted=clock)
        st = {k: getattr(t, k)[None].astype(np.int32)
              for k in ("left", "right", "parent")}
        if clock:
            ages = np.zeros(t.n_nodes)
            for v in t.postorder():
                ages[v] = (max(ages[t.left[v]], ages[t.right[v]]) + 0.3
                           + 0.1 * i)
            st["age"] = ages[None].astype(np.float32)
        else:
            st["blen"] = np.full((1, t.n_nodes), 0.1, np.float32)
        states.append(state_from_numpy(st, "cpu"))
        jstates.append({k: jnp.asarray(v[0]) for k, v in st.items()})
    got = np.array([float(eng._constraint_terms(s)[0]) for s in states])
    want = np.array([float(jeng._constraint_terms(s)) for s in jstates])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got < -1e20).any() and (got > -1e20).any()


@pytest.mark.parametrize("clock", [False, True])
def test_constrained_runs_stay_inside(clock):
    """A hard and a partial constraint (and on a clock tree a negative one
    and a dated fossil): the starting trees hold them, and every chain
    after 150 generations still does, with a finite prior."""
    hard, part1, part2, neg = (np.arange(7) < 3, (np.arange(7) >= 3)
                               & (np.arange(7) < 5), np.arange(7) >= 5,
                               (np.arange(7) == 0) | (np.arange(7) == 6))
    cons = [("h", hard, None), ("p", "partial", part1, part2, None)]
    kw = {}
    if clock:
        cons.append(("n", "negative", neg, None, None))
        kw = dict(clock=True, clockpr="fossilization",
                  tip_calibrations={3: Prior("fixed", (0.4,))})
    eng = Engine(_mini(7, 40, 11), [DivisionSettings(nst="1")],
                 tree_settings=TreeSettings(constraints=cons, **kw),
                 mcmc=McmcSettings(nruns=1, nchains=4, seed=3),
                 device="cpu")
    states, bk = eng.init_chains()
    assert (eng._constraint_terms(states) == 0).all()
    states, bk = eng.run_block(states, bk, 150)
    assert (eng._constraint_terms(states) == 0).all()
    assert (states["lnP"] > -1e20).all()
    A = ancestor_matrix(states["parent"])[:, :7]
    sizes = A.sum(1)
    counts = torch.as_tensor(hard, dtype=torch.float32) @ A
    split = (counts == 3) & (sizes == 3)
    if not clock:
        split |= (counts == 0) & (sizes == 4)
    assert split.any(1).all()


def test_calibrated_node_density():
    """A calibrated constraint adds the MRCA age's density to the prior:
    offsetexp(0, 1) on clade {0, 1}, on the same starting states; both
    engines' priors equal JAX's."""
    mask = np.zeros(6, bool)
    mask[[0, 1]] = True
    base = dict(clock=True, clockpr="uniform",
                treeagepr=Prior("gamma", (2.0, 2.0)))
    e0, j0 = _pair(dict(base, constraints=[("c", mask, None)]), seed=2)
    e1, j1 = _pair(dict(base, constraints=[
        ("c", mask, Prior("offsetexp", (0.0, 1.0)))]), seed=2)
    s0, _ = e0.init_chains(9)
    s1, _ = e1.init_chains(9)
    A = ancestor_matrix(s0["parent"])[0, :6]
    mrca = int(((torch.as_tensor(mask, dtype=torch.float32) @ A == 2)
                & (A.sum(0) == 2)).long().argmax())
    want = -float(s0["age"][0, mrca])
    assert float(s1["lnP"][0] - s0["lnP"][0]) == pytest.approx(want,
                                                               abs=1e-4)
    for eng, jeng, s in ((e0, j0, s0), (e1, j1, s1)):
        js = {k: jnp.asarray(v[0].numpy()) for k, v in s.items()
              if k not in ("lnL", "lnP", "lnP_tree", "lnP_par")}
        assert float(eng.log_prior(s)[0]) == pytest.approx(
            float(jeng.log_prior(jeng.refresh_eigs(js))), rel=1e-5)


DATING_NEX = """#NEXUS
begin data;
  dimensions ntax=6 nchar=12;
  format datatype=dna;
  matrix
    A ACGTACGTACGT
    B ACGTACGTACGA
    C ACGAACGTACGT
    FossilX ACGTACGAACGT
    E ACGTACGTAAGT
    F ACGTACGTACTT
  ;
end;
begin mrbayes;
  taxset crownset = A B C;
  constraint crown = crownset;
  constraint noEF negative = E F;
  constraint back partial = A B : E F;
  calibrate FossilX=fixed(0.5) E=uniform(0.1,0.3) crown=offsetexp(0.5,1.5)
            root=offsetexp(1.0,2.0);
  prset brlenspr=clock:fossilization;
  prset fossilizationpr=beta(1,1);
  prset sampleprob=0.5;
  prset samplestrat=random;
  prset nodeagepr=calibrated;
  prset topologypr=constraints(crown, noEF, back);
  prset clockratepr=exp(10);
  exclude 11-12;
  include 12;
end;
"""


def test_cli_dating_commands_equal_jax(tmp_path):
    """taxset, constraint (hard, negative, partial), calibrate (tips, a
    constraint, the root), the dating prset keys and exclude/include
    through both CLIs give the same engine settings and moves."""
    nex = tmp_path / "fbd.nex"
    nex.write_text(DATING_NEX)
    it = Interpreter(log=lambda m: None, device="cpu")
    it.execute_file(str(nex))
    jit = JInterpreter(log=lambda m: None)
    jit.execute_file(str(nex))
    eng, jeng = it.build_engine(), jit.build_engine()
    np.testing.assert_array_equal(eng.tip_dates, jeng.tip_dates)
    assert eng.tip_dates[3] == 0.5 and eng.tip_dates[4] == 0.2
    assert [(t, p.kind, p.params) for t, p in eng.sampled_tip_ages] == \
        [(t, p.kind, p.params) for t, p in jeng.sampled_tip_ages]
    for a, b in ((eng.constraint_masks, jeng.constraint_masks),
                 (eng.negative_masks, jeng.negative_masks),
                 *zip(eng.partial_masks, jeng.partial_masks)):
        np.testing.assert_array_equal(a, b)
    assert eng.constraint_masks[0].tolist() == [True] * 3 + [False] * 3
    assert (eng._root_calib.kind, eng._root_calib.params) == \
        (jeng._root_calib.kind, jeng._root_calib.params) == \
        ("offsetexp", (1.0, 2.0))
    assert [(p.kind, p.params) for p in eng.constraint_priors] == \
        [(p.kind, p.params) for p in jeng.constraint_priors]
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    assert [n for n, _ in param_columns(eng)] == \
        [n for n, _ in j_param_columns(jeng)]
    assert eng.data.divisions[0].npat == jeng.data.divisions[0].npat
    assert it.env.excluded == {10} == jit.env.excluded
    states, _ = eng.init_chains()
    assert torch.isfinite(states["lnP"]).all()
    assert (states["age"][:, 3] == 0.5).all()
    # calibrations count only under nodeagepr=calibrated
    it.run_line("prset nodeagepr=unconstrained")
    assert not it.build_engine().has_dated_tips


def test_ctype_and_irreversible():
    it = Interpreter(log=lambda m: None, device="cpu")
    it.execute_file(example("cynmix.nex"))
    it.run_line("ctype ordered: 1-40")
    it.run_line("ctype unordered: 31-40")
    assert sorted(it.env.ctypes) == list(range(30))
    from mrbayes_tpu_torch.cli import CommandError
    with pytest.raises(CommandError, match="irreversible"):
        it.run_line("ctype irreversible: 1")


@pytest.mark.parametrize("S", [2, 3, 5, 7])
def test_ordered_mk_q_matches_jax(S):
    rng = np.random.default_rng(S)
    pi = rng.dirichlet(np.ones(S) * 3).astype(np.float32)
    np.testing.assert_allclose(ordered_mk_q(S, torch.as_tensor(pi)).numpy(),
                               np.asarray(j_ordered_mk_q(S, jnp.asarray(pi))),
                               rtol=1e-5, atol=1e-6)
    q = ordered_mk_q(S).numpy()
    np.testing.assert_allclose(q, np.asarray(j_ordered_mk_q(S)), atol=1e-6)
    i, j = np.nonzero(np.abs(q) > 0)
    assert (np.abs(i - j) <= 1).all()
    assert -(np.diag(q) / S).sum() == pytest.approx(1.0, rel=1e-6)


def test_prior_only_fbd_matches_jax():
    """mcmc data=no, the FBD prior on 8 tips with 3 dated fossils (two
    fixed, one uniform), 16 runs x 1 chain, 1,500 generations on each
    engine, add_branch and del_branch at probability 0 on both (propset's
    overrides): the mean root age over the second half within 4
    batch-means standard errors (one batch a run) of JAX's, and no
    sampled ancestor on either side.  With the pair on, the port samples
    ancestors and JAX cannot (its ordering check rejects a fossil at its
    parent's age, ROADMAP Queue 3), so the two agree only without them;
    tests/test_torch_sampled_ancestors.py holds the port's sampled
    ancestors against a numerical integral instead."""
    tips = {0: ("fixed", (0.5,)), 1: ("fixed", (0.3,)),
            2: ("uniform", (0.2, 0.8))}
    kw = dict(clock=True, clockpr="fossilization", samplestrat="random",
              sampleprob=0.7)
    runs, gens = 16, 1500
    off = {k: {"prob": 0.0} for k in ("add_branch", "del_branch")}
    jeng = JEngine(_mini(jax_side=True), [JDiv(nst="1")],
                   tree_settings=JTree(
                       clockratepr=JPrior("exponential", (10.0,)),
                       treeagepr=JPrior("gamma", (2.0, 2.0)),
                       tip_calibrations={t: JPrior(*p)
                                         for t, p in tips.items()}, **kw),
                   mcmc=JMcmc(nruns=runs, nchains=1, seed=21, use_data=False),
                   move_overrides=off)
    eng = Engine(_mini(), [DivisionSettings(nst="1")],
                 tree_settings=TreeSettings(
                     clockratepr=Prior("exponential", (10.0,)),
                     treeagepr=Prior("gamma", (2.0, 2.0)),
                     tip_calibrations={t: Prior(*p) for t, p in tips.items()},
                     **kw),
                 mcmc=McmcSettings(nruns=runs, nchains=1, seed=21,
                                   use_data=False), device="cpu",
                 move_overrides=off)
    assert not {"add_branch", "del_branch"} & {m.name for m in eng.moves}
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    out = {}
    for name, e in (("jax", jeng), ("port", eng)):
        states, bk = e.init_chains()
        ages, sa = [], []
        for _ in range(gens // 10):
            states, bk = e.run_block(states, bk, 10)
            ages.append(np.asarray(states["age"])[:, -1])
            sa.append(np.asarray(states["sa"]).sum(1))
        half = len(ages) // 2
        out[name] = (np.mean(ages[half:], 0), np.asarray(sa))
    (a, s_j), (b, s_p) = out["jax"], out["port"]
    se = np.hypot(a.std(ddof=1), b.std(ddof=1)) / np.sqrt(runs)
    assert abs(a.mean() - b.mean()) < 4.0 * se, (a.mean(), b.mean(), se)
    assert s_j.max() == 0 and s_p.max() == 0
