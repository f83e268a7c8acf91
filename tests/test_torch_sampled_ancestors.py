"""Sampled ancestors in the port, on the CPU.  The port accepts them on
purpose where the JAX package cannot (its ordering check rejects a
fossil at its parent's age: ROADMAP Queue 3), so the reference here is
not JAX:

* the prior-only sampler on three tips (two extant, one fossil) and on
  four (two extant, two fossils at different ages) against a float64
  numerical integration of ``clock.ln_fbd`` over the state space the
  moves reach (``fbd_small_trees.py`` defines both): the share of
  states with a sampled ancestor (> 0), their mean count, the mean root
  age and the share of states where the extant tips are sisters within
  4 batch-means standard errors, one batch a run;
* every clock move on states with sampled ancestors (the reference's
  hymfossil trees, and an 8-tip problem whose uniformly dated fossil
  exercises the tip-date slider), called as ``clock.py`` defines it,
  without the engine's pinning: each proposal it does not refuse is
  already pinned, and each kept state has every pinned parent at its
  fossil's age bit for bit, ``sa`` exactly on the fossil tips with a
  zero-length branch, every other parent older than its child and every
  fixed fossil age held;
* no sampled ancestor under the wn and tk02 clocks, whose branch-rate
  prior depends on the branch length;
* ``ages_ordered`` admits a parent's age only for an ancestral fossil
  and wants its sibling strictly younger;
* without ``sa`` every clock move and ``ages_ordered`` return what they
  returned before the port accepted sampled ancestors (digests of their
  outputs then, on seeded states).
"""
import hashlib
import json
import os
from functools import lru_cache, partial

import numpy as np
import pytest
import torch

from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.envelope import BATCHES
from mrbayes_tpu_torch.mcmc import clock as CL
from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS, Engine
from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings, McmcSettings,
                                             Prior, TreeSettings)
from mrbayes_tpu_torch.nexus.datatypes import DataType, FormatInfo
from mrbayes_tpu_torch.nexus.parser import CharacterMatrix
from mrbayes_tpu_torch.trees import parse_newick
import fbd_small_trees as FS

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def _mini(ntax=8, nchar=60, seed=5):
    rng = np.random.default_rng(seed)
    codes = (1 << rng.integers(0, 4, size=(ntax, nchar))).astype(np.uint32)
    taxa = [f"t{i}" for i in range(ntax)]
    m = CharacterMatrix(taxa=taxa, nchar=nchar,
                        fmt=FormatInfo(datatype=DataType.DNA), codes=codes,
                        col_datatype=[DataType.DNA] * nchar)
    return DataSet(taxa=taxa, nchar=nchar, divisions=make_divisions(m))


def _against_the_integral(problem):
    """128 runs x 1 chain, 800 generations of which the last 600 are
    read (the starting root ages drawn from the tree-age prior): each of
    ``fbd_small_trees.STATS`` of the port's sampler within 4 batch-means
    standard errors of the integral, and sampled ancestors present."""
    fossil_ages = FS.PROBLEMS[problem]
    want = FS.integral(fossil_ages)
    runs = 128
    x = FS.sampler(FS.engine(fossil_ages, "cpu", runs, seed=1), gens=800,
                   burn=200, seed=1)
    mean = x.mean(0)
    se = x.std(0, ddof=1) / np.sqrt(runs)
    ref = np.array([want[k] for k in FS.STATS])
    assert mean[0] > 0.1
    assert (np.abs(mean - ref) < 4.0 * se).all(), (mean, ref, se)


def test_prior_only_three_tips_matches_the_integral():
    """Two extant tips and a fossil at age 2.  The state space is
    ``fbd_small_trees``': three labelled topologies, the fossil a sampled
    ancestor in the two where it is not the root's child (the root is
    never a sampled ancestor's parent), the free ages above their
    children.  Each chain draws its own move, as the reference does: a
    shared move sequence keeps the prior only on average over sequences
    (the add/delete pair is reversible as a mixture), so runs that share
    one are not independent batches."""
    _against_the_integral("three_tips")


def test_prior_only_four_tips_matches_the_integral():
    """Two extant tips and fossils at ages 1 and 2: fifteen labelled
    topologies, 38 classes with their sampled ancestors (none, either
    fossil or both, each on a parent that is not the root and pins no
    other fossil, its sibling's tips younger than it).  With a sampled
    ancestor an internal node stays free, so the sliders, LOCAL, NNI,
    the swap and the SPRs act on states with a pinned parent here."""
    _against_the_integral("four_tips")


# ---------------------------------------------------------------------------
# the moves on states with sampled ancestors


def _hymfossil_states(C):
    """The hymfossil engine on the CPU and C chain states on the
    reference's own trees (the three hymfossil_fbd_totev rows' trees and
    ages in turn), the fossils on zero-length branches flagged in ``sa``
    (as chip_smoke.py's hymfossil_kernel_states makes them), seeded FBD
    parameters."""
    data, model = BATCHES["hymfossil"]
    it = Interpreter(log=lambda m: None, device="cpu")
    for ln in (f"execute {data}", *model, f"mcmcp nruns=1 nchains={C}"):
        it.run_line(ln)
    eng = it.build_engine()
    rows = [r for r in json.load(open(os.path.join(HERE,
                                                   "golden_extra.json")))
            if r["name"] == "hymfossil_fbd_totev"]
    chains = []
    for c in range(C):
        rec = rows[c % len(rows)]
        t = parse_newick(rec["newick"], eng.data.taxa, rooted=True)
        st = {k: getattr(t, k).astype(np.int64) for k in ("left", "right",
                                                          "parent")}
        st["age"] = np.asarray(rec["state"]["age"], np.float32)
        st["clockrate"] = np.asarray(rec["state"]["clockrate"], np.float32)
        chains.append(st)
    st = state_from_numpy({k: np.stack([s[k] for s in chains])
                           for k in chains[0]}, "cpu")
    n = eng.n_tips
    fossil = torch.as_tensor(eng.fossil_tips)
    st["sa"] = ((eng.branch_lengths(st)[:, :n] == 0) & fossil).long()
    rng = np.random.default_rng(6)
    for k, lo, hi in (("speciation", 0.01, 0.5), ("extinction", 0.1, 0.9),
                      ("fossilization", 0.05, 0.9)):
        st[k] = torch.as_tensor(rng.uniform(lo, hi, (C, 1)),
                                dtype=torch.float32)
    return eng, st


def _dated_states(C):
    """The 8-tip FBD problem of chip_smoke.py's dating phases (fossils 0
    and 1 at fixed ages, fossil 2 dated uniformly in (0.2, 0.8)) and its
    C starting states."""
    tips = {0: Prior("fixed", (0.5,)), 1: Prior("fixed", (0.3,)),
            2: Prior("uniform", (0.2, 0.8))}
    eng = Engine(_mini(), [DivisionSettings(nst="1")],
                 tree_settings=TreeSettings(
                     clock=True, clockpr="fossilization",
                     samplestrat="random", sampleprob=0.7,
                     clockratepr=Prior("exponential", (10.0,)),
                     treeagepr=Prior("gamma", (2.0, 2.0)),
                     tip_calibrations=tips),
                 mcmc=McmcSettings(nruns=1, nchains=C, seed=4),
                 device="cpu")
    states, _ = eng.init_chains()
    return eng, {k: v for k, v in states.items() if k not in SCORE_KEYS}


def _assert_invariants(eng, st, fixed, what):
    n = eng.n_tips
    age, parent = st["age"], st["parent"]
    sa = st["sa"] > 0
    # every pinned parent at its fossil's age, bit for bit
    assert torch.equal(age.gather(1, parent[:, :n])[sa], age[:, :n][sa]), \
        what
    # the flags exactly on the fossil tips with a zero-length branch
    fossil = torch.as_tensor(eng.fossil_tips)
    zero = eng.branch_lengths(st)[:, :n] == 0
    assert torch.equal(sa, zero & fossil) and not (zero & ~fossil).any(), \
        what
    # every other parent strictly older than its child
    other = parent >= 0
    other[:, :n] &= ~sa
    pa = age.gather(1, parent.clamp_min(0))
    assert (pa[other] > age[other]).all(), what
    # every fixed fossil age held
    assert torch.equal(age[:, fixed], st["age0"][:, fixed]), what
    # a pinned state is pin_sa_ages' fixed point (its plain set equals
    # the scatter-min of the JAX package here)
    assert torch.equal(CL.pin_sa_ages(st, n)["age"], age), what


@pytest.mark.parametrize("problem", ["hymfossil", "dated8"])
def test_moves_keep_sampled_ancestors_pinned(problem):
    """Every clock move of the engine as ``clock.py`` defines it (the
    engine's list built without its pinning wrapper), in turn for several
    rounds: each proposal whose Hastings ratio is finite is already
    pinned (``pin_sa_ages`` changes nothing in it) and equals the
    engine's pinned move's; it is kept where the engine's tree prior is
    finite too (so add- and delete-branch go both ways); after every move
    the invariants hold on every chain, sampled ancestors were present
    and each move changed some state."""
    C = 6
    eng, st = (_hymfossil_states if problem == "hymfossil"
               else _dated_states)(C)
    n = eng.n_tips
    fixed = [t for t in np.flatnonzero(eng.fossil_tips)
             if t not in {ti for ti, _ in eng.sampled_tip_ages}]
    st["age0"] = st["age"].clone()
    moves = eng._clock_moves(lambda base: partial(base, n_tips=n))
    pinned = {m.name: m for m in eng.moves}
    assert {"add_branch", "del_branch"} <= set(m.name for m in moves)
    if problem == "dated8":
        assert "tip_date_slider" in {m.name for m in moves}
    gen = torch.Generator().manual_seed(7)
    changed = dict.fromkeys((m.name for m in moves), 0)
    most_sa = 0
    for r in range(4 if problem == "hymfossil" else 12):
        for spec in moves:
            what = f"{spec.name} round {r}"
            cur = {k: v for k, v in st.items() if k != "age0"}
            tuning = torch.full((C,), spec.tuning0)
            seed = gen.get_state()
            new, lnH = spec.fn(gen, cur, tuning)
            prop = lnH > -1e29
            assert torch.equal(CL.pin_sa_ages(new, n)["age"][prop],
                               new["age"][prop]), what
            same, _ = pinned[spec.name].fn(torch.Generator().set_state(seed),
                                           cur, tuning)
            for k in new:
                assert torch.equal(same[k][prop], new[k][prop]), (what, k)
            keep = prop & (eng.log_prior_tree(new) > -1e29)
            st = {k: (torch.where(keep.reshape(-1, *[1] * (v.ndim - 1)),
                                  new[k], v) if k in new else v)
                  for k, v in st.items()}
            _assert_invariants(eng, st, fixed, what)
            changed[spec.name] += int(keep.sum())
            most_sa = max(most_sa, int(st["sa"].sum(1).max()))
    assert most_sa > 0
    assert all(changed.values()), changed


@pytest.mark.parametrize("clockvar,samples", [
    ("igr", True), ("wn", False), ("tk02", False)])
def test_no_sampled_ancestors_under_length_dependent_rates(clockvar,
                                                           samples):
    """Under wn and tk02 a branch rate's prior depends on the branch's
    length, which a sampled ancestor's zero-length branch does not give:
    the engine registers no add/delete-branch there (a propset naming
    them is refused) and a run keeps every fossil a tip.  Under igr the
    rate's prior does not depend on the length and the pair is there."""
    def engine(**kw):
        return Engine(_mini(), [DivisionSettings(nst="1")],
                      tree_settings=TreeSettings(
                          clock=True, clockpr="fossilization",
                          samplestrat="random", sampleprob=0.7,
                          clockvarpr=clockvar,
                          treeagepr=Prior("gamma", (2.0, 2.0)),
                          tip_calibrations=_TIPS),
                      mcmc=McmcSettings(nruns=1, nchains=4, seed=4,
                                        use_data=False),
                      device="cpu", **kw)
    eng = engine()
    pair = {"add_branch", "del_branch"}
    assert pair & {m.name for m in eng.moves} == (pair if samples else set())
    if samples:
        return
    with pytest.raises(ValueError, match="add_branch"):
        engine(move_overrides={"add_branch": {"prob": 1.0}})
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 200)
    assert int(states["sa"].sum()) == 0
    assert torch.isfinite(states["lnP_tree"]).all()


def test_ages_ordered_admits_only_ancestral_fossils():
    """On ((A,F)3,B)4 with F at 2: F at its parent's age passes with its
    flag and fails without it; an extant child at its parent's age fails
    either way; F's sibling as old as the pinned parent fails."""
    def state(ages, sa, parent=(3, 4, 3, 4, -1)):
        return {"age": torch.tensor([ages]), "parent": torch.tensor([parent]),
                "sa": torch.tensor([sa])}
    assert CL.ages_ordered(state([0, 0, 2.0, 2.0, 5.0], [0, 0, 1]))
    assert not CL.ages_ordered(state([0, 0, 2.0, 2.0, 5.0], [0, 0, 0]))
    assert CL.ages_ordered(state([0, 0, 2.0, 3.0, 5.0], [0, 0, 0]))
    # node 3 at the age of its extant child A, flagged or not
    assert not CL.ages_ordered(state([1.0, 0, 2.0, 1.0, 5.0], [0, 0, 0],
                                     (3, 4, 4, 4, -1)))
    # F's sibling A as old as the pinned parent
    assert not CL.ages_ordered(state([2.0, 0, 2.0, 2.0, 5.0], [0, 0, 1]))
    no_sa = {"age": torch.tensor([[0, 0, 2.0, 2.0, 5.0]]),
             "parent": torch.tensor([[3, 4, 3, 4, -1]])}
    assert not CL.ages_ordered(no_sa)


# ---------------------------------------------------------------------------
# without sa: what the moves returned before sampled ancestors were accepted

_TIPS = {0: Prior("fixed", (0.5,)), 1: Prior("fixed", (0.3,)),
         2: Prior("uniform", (0.2, 0.8))}
_MASK = np.arange(8) >= 4
_MASK[7] = False
SETTINGS = {
    "strict": dict(clockpr="uniform"),
    "cpp": dict(clockpr="uniform", clockvarpr="cpp",
                cppratepr=Prior("exponential", (1.0,)),
                tip_calibrations=_TIPS,
                constraints=[("c", _MASK, Prior("uniform", (0.0, 5.0)))]),
    "igr_bd": dict(clockpr="birthdeath", clockvarpr="igr")}
# sha256 (first 16 hex digits) of three chained proposals of each tree
# move on the engine's seeded starting states: every output tensor, the
# Hastings ratios, ages_ordered and pin_sa_ages of each proposal, as the
# code computed them before sampled ancestors were accepted
DIGESTS = {
    "strict:nni_clock": "7b5267334911a14d",
    "strict:subtree_swap_clock": "801f6307ef5afccf",
    "strict:node_slider_clock": "09215ad2dc5f5165",
    "strict:local_clock": "f1d51684ae8e1225",
    "strict:pars_spr_clock": "c1fe6fe44dbd8324",
    "strict:spr_clock": "0ced3bc0ab3151a6",
    "strict:age_slider": "20b5cb4822537844",
    "strict:tree_stretch": "ac6ccdab9756d801",
    "strict:root_age": "a517179dc1b7f693",
    "cpp:nni_clock": "922889545415b057",
    "cpp:subtree_swap_clock": "3b7d330eb1b489de",
    "cpp:node_slider_clock": "bbcb58c67a0ed2ee",
    "cpp:local_clock": "0497e1459b92dac4",
    "cpp:pars_spr_clock": "25e4f809261a8896",
    "cpp:spr_clock": "dab6f66304cdb90e",
    "cpp:age_slider": "ad6f9439bbce7536",
    "cpp:tree_stretch": "5892b09943cfc31a",
    "cpp:root_age": "fa873a801d5b869a",
    "cpp:cpp_adddelete": "ecb5aa7837b27db0",
    "cpp:cpp_position": "c04a4e91d649b3bc",
    "cpp:cpp_multiplier": "ff8dbd42c4f3b975",
    "cpp:cpprate_mult": "3ccc6ad14784ba15",
    "cpp:tip_date_slider": "5362a89f8544b77e",
    "igr_bd:nni_clock": "6687573a46e5eb64",
    "igr_bd:subtree_swap_clock": "b6577e22abdb40b7",
    "igr_bd:node_slider_clock": "276c78135537e669",
    "igr_bd:local_clock": "b0983b0399298e00",
    "igr_bd:pars_spr_clock": "8ee6f57e2da93224",
    "igr_bd:spr_clock": "12fac889f85988ad",
    "igr_bd:age_slider": "02032a97fcbc4416",
    "igr_bd:tree_stretch": "6ba69cc2269f1eaf",
    "igr_bd:root_age": "64f9d7c8823751cd",
    "igr_bd:brate_mult": "dd9ee549f64be07b",
    "igr_bd:clockvar_mult": "eb763664ce583d28",
    "igr_bd:speciation_mult": "7dff6a265d758b32",
    "igr_bd:extinction_slider": "d9e2568ebfd4c70b",
}


@lru_cache(maxsize=None)
def _digests(setting):
    """Each tree move's digest on the ``setting`` engine (2 runs x 2
    chains, seed 3): three proposals in a row, each from the last."""
    eng = Engine(_mini(), [DivisionSettings(nst="1")],
                 tree_settings=TreeSettings(
                     clock=True, treeagepr=Prior("gamma", (2.0, 2.0)),
                     **SETTINGS[setting]),
                 mcmc=McmcSettings(nruns=2, nchains=2, seed=3), device="cpu")
    states, bk = eng.init_chains()
    assert "sa" not in states
    cur = {k: v for k, v in states.items() if k not in SCORE_KEYS}
    out = {}
    for i, spec in enumerate(eng.moves):
        if spec.prior_scope != "tree":
            continue
        h = hashlib.sha256()
        st = cur
        for r in range(3):
            gen = torch.Generator().manual_seed(100 * i + r)
            new, lnH = spec.fn(gen, st, bk["tuning"][:, i])
            for k in sorted(new):
                h.update(k.encode())
                h.update(new[k].contiguous().numpy().tobytes())
            h.update(lnH.numpy().tobytes())
            h.update(CL.ages_ordered(new).numpy().tobytes())
            h.update(CL.pin_sa_ages(new, eng.n_tips)["age"].numpy().tobytes())
            st = new
        out[spec.name] = h.hexdigest()[:16]
    return out


@pytest.mark.parametrize("key", sorted(DIGESTS))
def test_moves_without_sa_are_unchanged(key):
    setting, move = key.split(":")
    assert _digests(setting)[move] == DIGESTS[key]
