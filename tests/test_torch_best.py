"""BEST, the multispecies coalescent, in the port against the JAX package
(restating ``tests/test_best.py``, ``tests/test_examples.py::
test_finch_best_wiring`` and ``tests/test_prior_components.py::
test_best_prior_components``; the JAX files stay as they are).

* ``msc_gene_log_prior`` on the hand case of the JAX tests, on an
  inconsistent gene tree, and on 64 seeded (gene trees, species tree,
  theta) cases, valid and invalid, against JAX within 1e-4 relative
  (float32 sums of a few dozen terms), NEG_INF on the same cases;
* ``min_depth_matrix`` and ``_ln_proposal_prob`` against JAX within 1e-5;
  the species move's clustering, given the same uniforms, against a numpy
  single linkage; ``init_compatible_trees`` equal to JAX's for one numpy
  seed;
* finch (30 loci) at identical states, JAX's carried through
  ``convert.state_from_numpy``: each gene's lnL within 1e-2 and MSC
  density within 1e-3 of JAX's, the totals within 1e-2 (lnL) and 1e-3
  (lnPrior); the gene-stack route against each gene's own pruner within
  1e-5 relative; the stacked pass with a tree a member against each
  member's own plain pass, exactly;
* the engine smoke runs, the species move accepting, generatepr's g_m
  columns, the finch CLI wiring and files, the carried prior components,
  a ``.ckp`` round trip, and a prior-only run whose species-tree height
  and theta means lie within 4 standard errors of JAX's prior-only run
  (16 independent runs a side: the standard error of the mean of the 16
  run means, the two sides' in quadrature)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.data import DataSet as JDataSet
from mrbayes_tpu.data import make_divisions as j_make_divisions
from mrbayes_tpu.mcmc import best as JB
from mrbayes_tpu.mcmc.engine import Engine as JEngine
from mrbayes_tpu.mcmc.settings import DivisionSettings as JDiv
from mrbayes_tpu.mcmc.settings import McmcSettings as JMcmc
from mrbayes_tpu.mcmc.settings import Prior as JPrior
from mrbayes_tpu.mcmc.settings import TreeSettings as JTree
from mrbayes_tpu.nexus.datatypes import DataType as JDataType
from mrbayes_tpu.nexus.datatypes import FormatInfo as JFormat
from mrbayes_tpu.nexus.parser import CharacterMatrix as JMatrix
from mrbayes_tpu.trees import random_clock_tree
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.data import DataSet, make_divisions, parse_char_range
from mrbayes_tpu_torch.mcmc import best as B
from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS, Engine
from mrbayes_tpu_torch.mcmc.run import McmcRunner
from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings, McmcSettings,
                                             Prior, TreeSettings)
from mrbayes_tpu_torch.nexus.datatypes import DataType, FormatInfo
from mrbayes_tpu_torch.nexus.parser import CharacterMatrix, read_nexus_file
from mrbayes_tpu_torch.ops.pruning_cuda import pruning_down_plain
from mrbayes_tpu_torch.ops.stacked_cuda import (GeneStackLayout,
                                                stacked_down_plain)
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers
torch.set_num_threads(1)

FINCH = example("finch.nex")


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


# ---------------------------------------------------------------------
# the MSC density (tests/test_best.py's first three tests)

HAND = {"s_parent": [2, 2, -1], "s_age": [0.0, 0.0, 1.0],
        "tip_species": [0, 0, 1], "theta": [0.7] * 3}


def _port_msc(g_parent, g_age, tip_species, s_parent, s_age, theta, n, S):
    """The port's density of one gene tree, as [1, 1] batches."""
    return float(B.msc_gene_log_prior(
        _t(g_parent, torch.long)[None, None],
        _t(g_age, torch.float32)[None, None], _t(tip_species, torch.long),
        _t(s_parent, torch.long)[None], _t(s_age, torch.float32)[None],
        _t(theta, torch.float32)[None], n, S)[0, 0])


# jitted once per (n, S): eager JAX dispatch made the seeded cases slow
_jax_msc_jit = jax.jit(JB.msc_gene_log_prior, static_argnums=(6, 7))
_jax_depth_jit = jax.jit(JB.min_depth_matrix, static_argnums=(2, 3, 4))


def _jax_msc(g_parent, g_age, tip_species, s_parent, s_age, theta, n, S):
    return float(_jax_msc_jit(
        jnp.asarray(g_parent), jnp.asarray(g_age, jnp.float32),
        jnp.asarray(tip_species), jnp.asarray(s_parent),
        jnp.asarray(s_age, jnp.float32), jnp.asarray(theta, jnp.float32),
        n, S))


def test_msc_density_hand_case():
    # species tree (A, B) at 1.0; gene tree ((a1, a2)@0.5, b1)@2.0
    args = ([3, 3, 4, 4, -1], [0.0, 0.0, 0.0, 0.5, 2.0], HAND["tip_species"],
            HAND["s_parent"], HAND["s_age"], HAND["theta"], 3, 2)
    lp = _port_msc(*args)
    # pop A: one coalescence, k=2 over [0, 0.5] -> ln(2/t) - 1.0/t;
    # root pop: one coalescence, k=2 over [1, 2] -> ln(2/t) - 2.0/t
    expect = 2 * np.log(2.0 / 0.7) - 3.0 / 0.7
    np.testing.assert_allclose(lp, expect, rtol=1e-5)
    np.testing.assert_allclose(lp, _jax_msc(*args), rtol=1e-6)


def test_msc_rejects_inconsistent_gene_tree():
    # the cross-species coalescence (a1, b1) at 0.5, below the species
    # divergence at 1.0: invalid under the MSC
    args = ([3, 4, 3, 4, -1], [0.0, 0.0, 0.0, 0.5, 2.0], HAND["tip_species"],
            HAND["s_parent"], HAND["s_age"], HAND["theta"], 3, 2)
    assert _port_msc(*args) < -1e29
    assert _jax_msc(*args) < -1e29


def test_ploidy_factors():
    assert B.ploidy_factor("diploid") == 4.0
    assert B.ploidy_factor("Haploid".lower()) == 2.0
    assert B.ploidy_factor("zlinked") == 3.0


def _msc_case(rng, valid: bool):
    """A seeded (gene trees, species tree, theta, tip species) case: 4-6
    tips over 2-4 species, 3 genes; a valid case lifts every gene
    coalescence above the species root, an invalid one may not."""
    S = int(rng.integers(2, 5))
    n = int(rng.integers(max(S, 4), 7))
    tip_sp = np.concatenate([np.arange(S), rng.integers(0, S, n - S)])
    rng.shuffle(tip_sp)
    st, s_age = random_clock_tree(S, rng, mean_age=0.3)
    genes = []
    for _ in range(3):
        gt, g_age = random_clock_tree(n, rng, mean_age=0.5)
        if valid:
            g_age = np.where(np.arange(2 * n - 1) >= n,
                             g_age + s_age.max() * 1.01, g_age)
        genes.append((gt.parent, g_age))
    theta = rng.uniform(0.05, 2.0, 2 * S - 1)
    return (np.stack([p for p, _ in genes]), np.stack([a for _, a in genes]),
            tip_sp, st.parent, s_age, theta, n, S)


def test_msc_density_matches_jax_on_seeded_cases():
    rng = np.random.default_rng(2024)
    n_valid = n_invalid = 0
    for case in range(64):
        gp, ga, tip_sp, sp, sa, theta, n, S = _msc_case(rng, case % 2 == 0)
        port = B.msc_gene_log_prior(
            _t(gp, torch.long)[None], _t(ga, torch.float32)[None],
            _t(tip_sp, torch.long), _t(sp, torch.long)[None],
            _t(sa, torch.float32)[None], _t(theta, torch.float32)[None], n,
            S)[0].numpy()
        for g in range(3):
            ref = _jax_msc(gp[g], ga[g], tip_sp, sp, sa, theta, n, S)
            if ref <= -1e29:
                n_invalid += 1
                assert port[g] <= -1e29, (case, g, port[g])
            else:
                n_valid += 1
                np.testing.assert_allclose(port[g], ref, rtol=1e-4,
                                           err_msg=f"case {case} gene {g}")
    assert n_valid >= 50 and n_invalid >= 20, (n_valid, n_invalid)


# ---------------------------------------------------------------------
# the species-tree move (tests/test_best.py's distmatrix test)

def _distmatrix_state():
    """2 genes, 4 species of one tip each (tests/test_best.py)."""
    return {
        "parent": [[4, 4, 5, 5, 6, 6, -1], [4, 5, 4, 5, 6, 6, -1]],
        "left": [[0] * 7, [0] * 7], "right": [[0] * 7, [0] * 7],
        "age": [[0., 0., 0., 0., 1.0, 1.5, 3.0],
                [0., 0., 0., 0., 2.0, 2.5, 4.0]],
        "s_left": [0, 0, 0, 0, 0, 2, 4], "s_right": [0, 0, 0, 0, 1, 3, 5],
        "s_parent": [4, 4, 5, 5, 6, 6, -1],
        "s_age": [0., 0., 0., 0., 0.5, 0.7, 0.9]}


def _port_state(st, C=1):
    out = {}
    for k, v in st.items():
        a = np.asarray(v)
        x = _t(a, torch.float32 if a.dtype.kind == "f" else torch.long)
        out[k] = x[None].expand(C, *x.shape).contiguous()
    return out


def _below(sl, sr, S):
    below = [{v} if v < S else None for v in range(2 * S - 1)]
    for m in range(S, 2 * S - 1):
        below[m] = below[sl[m]] | below[sr[m]]
    return below


def test_species_tree_move_distmatrix():
    """The min-depth matrix is right, the proposal is a valid clock tree
    whose node ages never exceed the gene trees' minimum depths, and the
    Hastings ratio is finite (reference src/best.c:1715)."""
    st = _port_state(_distmatrix_state(), C=5)
    tip_sp = torch.arange(4)
    depth = B.min_depth_matrix(st["parent"], st["age"], tip_sp, 4, 4)
    dm = depth[0].numpy()
    assert abs(dm[0, 1] - 1.0) < 1e-6     # gene 0 at 1.0, gene 1 at 4.0
    assert abs(dm[0, 2] - 2.0) < 1e-6     # gene 0 at 3.0, gene 1 at 2.0
    assert abs(dm[2, 3] - 1.5) < 1e-6
    mv = B.make_species_tree_move(4, tip_sp, 4)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        out, lnh = mv(gen, st, torch.full((5,), 1.2))
        assert torch.isfinite(lnh).all()
        for c in range(5):
            sl, sr, sp, sa = (out[k][c].numpy() for k in (
                "s_left", "s_right", "s_parent", "s_age"))
            assert sp[6] == -1
            for v in range(6):
                assert sp[v] in (4, 5, 6)
                assert sl[sp[v]] == v or sr[sp[v]] == v
                assert sa[sp[v]] >= sa[v] - 1e-7
            assert np.all(sa[:4] == 0.0)
            below = _below(sl, sr, 4)
            for m in (4, 5, 6):
                for i in below[sl[m]]:
                    for j in below[sr[m]]:
                        assert sa[m] <= dm[i, j] + 1e-6


def test_min_depth_and_proposal_density_match_jax():
    rng = np.random.default_rng(5)
    for case in range(8):
        gp, ga, tip_sp, sp, sa, _, n, S = _msc_case(rng, True)
        st_sp, s_age = random_clock_tree(S, rng, mean_age=0.3)
        jstate = {"parent": jnp.asarray(gp), "age": jnp.asarray(ga,
                                                               jnp.float32)}
        jd = np.asarray(_jax_depth_jit(jstate, jnp.asarray(tip_sp), 3, n,
                                       S))
        pd = B.min_depth_matrix(_t(gp, torch.long)[None],
                                _t(ga, torch.float32)[None],
                                _t(tip_sp, torch.long), n, S)[0].numpy()
        np.testing.assert_allclose(pd, jd, rtol=1e-5)
        lam = float(rng.uniform(0.5, 5.0))
        jl = float(JB._ln_proposal_prob(
            jnp.asarray(st_sp.left), jnp.asarray(st_sp.right),
            jnp.asarray(st_sp.parent), jnp.asarray(s_age, jnp.float32),
            jnp.asarray(jd), jnp.float32(lam), S))
        pl = float(B._ln_proposal_prob(
            _t(st_sp.left, torch.long)[None],
            _t(st_sp.right, torch.long)[None],
            _t(st_sp.parent, torch.long)[None],
            _t(s_age, torch.float32)[None], _t(pd)[None],
            torch.tensor([lam]), S)[0])
        np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)


def _numpy_single_linkage(d, S):
    """Clusters joined in increasing pairwise depth (a numpy twin of the
    move's masked merges): (parent, age) of the clock tree."""
    ii, jj = np.triu_indices(S, 1)
    root = list(range(S))
    parent = np.full(2 * S - 1, -1)
    age = np.zeros(2 * S - 1)
    k = S
    for p in np.argsort(d, kind="stable"):
        a, b = root[ii[p]], root[jj[p]]
        if a == b:
            continue
        parent[a] = parent[b] = k
        age[k] = d[p]
        root = [k if r in (a, b) else r for r in root]
        k += 1
    return parent, age


def test_species_move_clustering_matches_numpy_single_linkage():
    rng = np.random.default_rng(17)
    for S in (3, 4, 5):
        P = S * (S - 1) // 2
        d = rng.uniform(0.1, 2.0, (6, P))
        sl, sr, sp, sa = B.cluster_depths(_t(d, torch.float32), S)
        for c in range(6):
            parent, age = _numpy_single_linkage(
                d[c].astype(np.float32), S)
            np.testing.assert_array_equal(sp[c].numpy(), parent)
            np.testing.assert_allclose(sa[c].numpy(), age, rtol=1e-6)
            for m in range(S, 2 * S - 1):
                assert sp[c, sl[c, m]] == m and sp[c, sr[c, m]] == m


def test_init_compatible_trees_match_jax():
    tip_sp = np.array([0, 0, 1, 2, 2])
    for seed in (1, 2, 3):
        (ps, pa), pg = B.init_compatible_trees(
            5, 3, tip_sp, np.random.default_rng(seed), 4)
        (js, ja), jg = JB.init_compatible_trees(
            5, 3, tip_sp, np.random.default_rng(seed), 4)
        np.testing.assert_array_equal(ps.parent, js.parent)
        np.testing.assert_array_equal(pa, ja)
        for (pt, pga), (jt, jga) in zip(pg, jg):
            np.testing.assert_array_equal(pt.left, jt.left)
            np.testing.assert_array_equal(pt.parent, jt.parent)
            np.testing.assert_array_equal(pga, jga)


# ---------------------------------------------------------------------
# finch at identical states

@pytest.fixture(scope="module")
def finch():
    """The port's and the JAX package's finch engines (the file's model,
    1 run x 2 chains), and JAX's starting states."""
    it = Interpreter(log=lambda m: None, device="cpu")
    it.execute_file(FINCH)
    it.run_line("mcmcp nruns=1 nchains=2 seed=5")
    jit = JInterpreter(log=lambda m: None)
    jit.execute_file(FINCH)
    jit.run_line("mcmcp nruns=1 nchains=2 seed=5")
    jeng = jit.build_engine()
    jst, _ = jeng.init_chains()
    return it.build_engine(), jeng, jst


def _carry(jst):
    return state_from_numpy({k: np.asarray(v) for k, v in jst.items()
                             if k not in SCORE_KEYS}, "cpu")


def test_finch_scores_match_jax_at_identical_states(finch):
    eng, jeng, jst = finch
    st = _carry(jst)
    assert st["left"].dtype == torch.int64 and st["age"].dtype == \
        torch.float32 and st["s_parent"].dtype == torch.int64
    assert st["parent"].shape == (2, 30, 7) and st["s_age"].shape == (2, 7)
    scored = eng.score(eng.refresh_eigs(st))
    np.testing.assert_allclose(scored["lnL"].numpy(), np.asarray(jst["lnL"]),
                               atol=1e-2, rtol=0)
    np.testing.assert_allclose(scored["lnP"].numpy(), np.asarray(jst["lnP"]),
                               atol=1e-3, rtol=0)
    # per gene: the JAX engine's batched gene pass with every other gene's
    # weights zeroed, and JAX's density of each gene tree
    tips, wts, cmasks = jeng._best_batched

    def gene_lnl(state, w):
        jeng._best_batched = (tips, w, cmasks)
        try:
            return jeng._best_lnl_batched(state)
        finally:
            jeng._best_batched = (tips, wts, cmasks)

    masks = jnp.eye(30)[:, :, None] * wts[None]             # [G, G, P]
    one = {k: v for k, v in jst.items() if k not in SCORE_KEYS}
    ref = np.asarray(jax.jit(jax.vmap(jax.vmap(
        gene_lnl, (None, 0)), (0, None)))(one, masks))      # [C, G]
    np.testing.assert_allclose(eng.division_lnls(scored).numpy(), ref,
                               atol=1e-2, rtol=0)
    theta = JB.ploidy_factor(jeng.tree_settings.ploidy) * one["popsize"]
    jm = jax.vmap(jax.vmap(JB.msc_gene_log_prior,
                           (0, 0, None, None, None, None, None, None)),
                  (0, 0, None, 0, 0, 0, None, None))(
        one["parent"], one["age"], jeng.tip_species, one["s_parent"],
        one["s_age"], theta, 4, 4)
    msc = B.msc_gene_log_prior(st["parent"], st["age"], eng.tip_species,
                               st["s_parent"], st["s_age"],
                               4.0 * st["popsize"], 4, 4)
    np.testing.assert_allclose(msc.numpy(), np.asarray(jm), atol=1e-3,
                               rtol=0)


def test_gene_stack_route_matches_each_genes_own_pruner(finch):
    eng, _, jst = finch
    assert eng._gene_stack is not None
    assert any("one stacked.cu launch" in n for n in eng.notes)
    st = eng.refresh_eigs(_carry(jst))
    stacked = eng.division_lnls(st)
    stack, eng._gene_stack = eng._gene_stack, None
    try:
        own = eng.division_lnls(st)
    finally:
        eng._gene_stack = stack
    np.testing.assert_allclose(stacked.numpy(), own.numpy(), rtol=1e-5)


def test_stacked_plain_with_a_tree_per_member_is_each_members_pass():
    rng = np.random.default_rng(3)
    n_tips, C, K, S = 5, 3, 2, 4
    ps = [7, 3, 11]
    lay = GeneStackLayout(n_tips, [K] * 3, [S] * 3, ps)
    lrs, psteps, tips = [], [], []
    for P in ps:
        lr = np.stack([np.stack([rng.permutation(n_tips + i)[:2]
                                 for i in range(n_tips - 1)])
                       for _ in range(C)]).astype(np.int32)
        lrs.append(torch.as_tensor(lr))
        psteps.append(torch.as_tensor(rng.uniform(
            0, 1, (C, n_tips - 1, 2, K, S, S)).astype(np.float32)))
        tips.append(torch.as_tensor(rng.uniform(
            0, 1, (n_tips, S, P)).astype(np.float32)))
    root, ls = stacked_down_plain(
        torch.stack(lrs), torch.cat([p.reshape(-1) for p in psteps]),
        torch.cat([t.reshape(-1) for t in tips]), lay)
    for d in range(3):
        r_ref, l_ref = pruning_down_plain(lrs[d], psteps[d], tips[d])
        r, l_ = lay.div_view(root, ls, d)
        assert torch.equal(r, r_ref) and torch.equal(l_, l_ref)
    with pytest.raises(ValueError, match=r"lr must be \[3, C"):
        lay.check(lrs[0], psteps[0].reshape(-1), tips[0].reshape(-1))


# ---------------------------------------------------------------------
# engine runs (tests/test_best.py's engine tests)

def test_best_engine_smoke():
    """2-gene BEST on primates (6 species of 2 taxa): chains start
    consistent, a short block stays finite, the species tree comes out
    with species labels and the gene trees with the taxa."""
    primates = read_nexus_file(FINCH.replace("finch", "primates"))
    part = [parse_char_range(["1-400"], 898), parse_char_range(["401-."],
                                                               898)]
    ds = DataSet(taxa=primates.taxa, nchar=primates.matrix.nchar,
                 divisions=make_divisions(primates.matrix, part))
    spp = [(f"sp{k}", [2 * k, 2 * k + 1]) for k in range(6)]
    eng = Engine(ds, [DivisionSettings(nst="2", rates="equal")] * 2,
                 tree_settings=TreeSettings(speciestree=True,
                                            species_partition=spp),
                 mcmc=McmcSettings(nruns=1, nchains=2, seed=11, ngen=100),
                 device="cpu")
    states, bk = eng.init_chains()
    assert (states["lnP"] > -1e29).all()
    states, bk = eng.run_block(states, bk, 60)
    assert torch.isfinite(states["lnL"]).all()
    assert (states["lnP"] > -1e29).all()
    t = eng.extract_tree(states, 0)
    assert t.n_tips == 6 and t.rooted
    assert eng.tree_taxa_labels == [f"sp{k}" for k in range(6)]
    gt = eng.extract_gene_tree(states, 0, 1)
    assert gt.n_tips == 12 and np.all(gt.blen[:-1] >= -1e-6)


def _six_taxa(seed=11):
    rng = np.random.default_rng(seed)
    ntax, nchar = 6, 120
    codes = (1 << rng.integers(0, 4, size=(ntax, nchar))).astype(np.uint32)
    parts = [list(range(0, 60)), list(range(60, 120))]
    out = []
    for dt, fmt, mat, mk, ds in (
            (DataType, FormatInfo, CharacterMatrix, make_divisions, DataSet),
            (JDataType, JFormat, JMatrix, j_make_divisions, JDataSet)):
        m = mat(taxa=[f"t{i}" for i in range(ntax)], nchar=nchar,
                fmt=fmt(datatype=dt.DNA), codes=codes,
                col_datatype=[dt.DNA] * nchar)
        out.append(ds(taxa=m.taxa, nchar=nchar,
                      divisions=mk(m, parts)))
    return out


def test_species_tree_move_in_engine_accepts():
    ds, _ = _six_taxa()
    ts = TreeSettings(speciestree=True, clock=True,
                      species_partition=[("A", [0, 1]), ("B", [2, 3]),
                                         ("C", [4, 5])])
    eng = Engine(ds, [DivisionSettings(nst="1")] * 2, ts,
                 McmcSettings(nruns=1, nchains=2, seed=3), device="cpu")
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 300)
    idx = [mv.name for mv in eng.moves].index("sp_distmatrix")
    assert int(bk["tries_total"].sum(0)[idx]) > 0
    assert int(bk["accepts_total"].sum(0)[idx]) > 0, "never accepted"
    assert torch.isfinite(states["lnL"]).all()


def test_moves_match_jax():
    ds, jds = _six_taxa()
    spp = [("A", [0, 1]), ("B", [2, 3]), ("C", [4, 5])]
    eng = Engine(ds, [DivisionSettings(nst="1")] * 2,
                 TreeSettings(speciestree=True, clock=True,
                              clockpr="birthdeath", species_partition=spp),
                 device="cpu")
    jeng = JEngine(jds, [JDiv(nst="1")] * 2,
                   JTree(speciestree=True, clock=True, clockpr="birthdeath",
                         species_partition=spp))
    assert [(m.name, m.weight, m.tuning0, m.tmin, m.tmax, m.prior_scope)
            for m in eng.moves] == \
        [(m.name, m.weight, m.tuning0, m.tmin, m.tmax, m.prior_scope)
         for m in jeng.moves]


def test_generatepr_variable_gene_rates(tmp_path):
    """generatepr=variable samples per-gene rate multipliers to .p as
    g_m{i} with a site-weighted mean of 1 (reference P_GENETREERATE and
    Move_GeneRate_Dir, src/model.c:20016-20060, src/proposal.c:5537)."""
    it = Interpreter(log=lambda m: None, device="cpu")
    it.run_line(f"execute {FINCH}")
    it.run_line("prset generatepr=variable")
    pfx = str(tmp_path / "gout")
    it.run_line(f"mcmc ngen=400 nruns=1 nchains=1 samplefreq=50 "
                f"printfreq=1000 seed=21 swapseed=22 file={pfx}")
    hdr = open(pfx + ".run1.p").readlines()[1].rstrip("\n").split("\t")
    gcols = [h for h in hdr if h.startswith("g_m{")]
    eng = it._last_runner.eng
    assert len(gcols) == eng.n_div, hdr
    rows = np.array([[float(x) for x in ln.split("\t")]
                     for ln in open(pfx + ".run1.p").readlines()[2:]])
    gm = rows[:, [hdr.index(c) for c in gcols]]
    assert np.std(gm) > 0.0
    np.testing.assert_allclose(gm @ np.asarray(eng.div_char_frac),
                               np.ones(len(gm)), atol=1e-4)


def test_finch_best_wiring(tmp_path, monkeypatch):
    """finch.nex turns BEST on from NEXUS (species partition, speciestree
    topology prior, variable theta), and the run samples a species tree
    and the gene trees, with the JAX package's .p columns."""
    monkeypatch.chdir(tmp_path)
    logs = []
    it = Interpreter(log=logs.append, device="cpu")
    it.execute_file(FINCH)
    ts = it.env.tree_settings
    assert ts.speciestree and ts.popvarpr == "variable"
    assert it.env.current_speciespartition == "test"
    prefix = str(tmp_path / "finch")
    it.run_line(f"mcmcp ngen=40 nruns=1 nchains=2 samplefreq=20 "
                f"printfreq=40 checkfreq=0 filename={prefix}")
    it.run_line("mcmc")
    eng = it._last_runner.eng
    assert eng.best and eng.n_species == 4 and eng.n_div == 30
    with open(f"{prefix}.run1.t") as f:
        txt = f.read()
    assert txt.count("tree gen.") >= 2
    assert all(f" {sp}" in txt for sp in ("SpQ", "SpW", "SpB", "SpO"))
    for g in (1, 30):
        with open(f"{prefix}.run1.gene{g}.t") as f:
            gtxt = f.read()
        assert gtxt.count("tree gen.") >= 2 and gtxt.rstrip().endswith(
            "end;")
    hdr = open(f"{prefix}.run1.p").readlines()[1].split()
    jit = JInterpreter(log=lambda m: None)
    jit.execute_file(FINCH)
    from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
    from mrbayes_tpu_torch.mcmc.run import param_columns
    assert [n for n, _ in param_columns(eng)] == \
        [n for n, _ in j_param_columns(jit.build_engine())]
    assert "speciesTreeHeight" in hdr and "theta[7]" in hdr
    assert "TH{all}" not in hdr


def test_best_prior_components(tmp_path, monkeypatch):
    """Every BEST move is tree-scoped (popsize feeds the MSC density, not
    the parameter groups), generatepr's simplex is params-scoped, and the
    carried components equal a recompute after a block (MB_DEBUG_LNL=1
    checks them at every sample of the CLI run too)."""
    monkeypatch.setenv("MB_DEBUG_LNL", "1")
    it = Interpreter(log=lambda m: None, device="cpu")
    it.run_line(f"execute {FINCH}")
    it.run_line("prset generatepr=variable")
    it.run_line(f"mcmc ngen=60 nruns=1 nchains=1 samplefreq=30 "
                f"printfreq=10000 diagnfreq=10000 seed=31 swapseed=32 "
                f"file={tmp_path / 'out'}")
    eng = it._last_runner.eng
    scopes = {m.name: m.prior_scope for m in eng.moves}
    assert scopes["popsize_mult"] == scopes["sp_distmatrix"] == "tree"
    assert scopes["gene_nni"] == "tree" and scopes["ratemult_dir"] == \
        "params"
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 120)
    view = {k: v for k, v in states.items() if k not in SCORE_KEYS}
    lnpt, lnpp = eng.log_prior_tree(view), eng.log_prior_params(view)
    assert torch.isfinite(lnpt).all() and torch.isfinite(lnpp).all()
    np.testing.assert_allclose(states["lnP_tree"].numpy(), lnpt.numpy(),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(states["lnP_par"].numpy(), lnpp.numpy(),
                               rtol=0, atol=1e-3)


def test_checkpoint_round_trip_of_a_best_state(tmp_path):
    ds, _ = _six_taxa()
    ts = TreeSettings(speciestree=True, clock=True, popvarpr="variable",
                      species_partition=[("A", [0, 1]), ("B", [2, 3]),
                                         ("C", [4, 5])])
    eng = Engine(ds, [DivisionSettings(nst="1")] * 2, ts,
                 McmcSettings(nruns=1, nchains=2, seed=4), device="cpu")
    runner = McmcRunner(eng, file_prefix=str(tmp_path / "ck"),
                        log=lambda m: None)
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 40)
    runner.write_checkpoint(states, bk, 40)
    text = open(tmp_path / "ck.ckp").read()
    assert "array states.age float32 [2,2,11]" in text
    assert "array states.s_parent int64 [2,5]" in text
    back, bk2, gen = runner.read_checkpoint()
    assert gen == 40
    for k in ("left", "right", "parent", "age", "s_left", "s_right",
              "s_parent", "s_age", "popsize", "lnL", "lnP"):
        assert torch.equal(back[k], states[k]) or torch.allclose(
            back[k], states[k], atol=1e-4), k
    a, _ = eng.run_block(states, bk, 20)
    b, _ = eng.run_block(back, bk2, 20)
    assert torch.equal(a["s_age"], b["s_age"])


# ---------------------------------------------------------------------
# prior-only against JAX

PRIOR_RUNS, PRIOR_GENS, PRIOR_BURN, PRIOR_EVERY = 16, 3000, 1000, 20


def _prior_stats(states_iter):
    """Per run, the means over the samples of the species-tree height
    and theta's mean over the populations: [runs, 2]."""
    rows = []
    for st in states_iter:
        s_age = np.asarray(st["s_age"])
        rows.append(np.stack([s_age[:, -1], np.asarray(
            st["popsize"]).mean(1)], 1))
    return np.mean(rows, 0)


def test_prior_only_matches_jax():
    ds, jds = _six_taxa()
    spp = [("A", [0, 1]), ("B", [2, 3]), ("C", [4, 5])]
    eq = ("fixed", ("equal",))
    eng = Engine(ds, [DivisionSettings(statefreqpr=Prior(*eq))] * 2,
                 TreeSettings(speciestree=True, clock=True,
                              popvarpr="variable", species_partition=spp),
                 McmcSettings(nruns=PRIOR_RUNS, nchains=1, seed=7,
                              use_data=False), device="cpu")
    jeng = JEngine(jds, [JDiv(statefreqpr=JPrior(*eq))] * 2,
                   JTree(speciestree=True, clock=True, popvarpr="variable",
                         species_partition=spp),
                   JMcmc(nruns=PRIOR_RUNS, nchains=1, seed=7, use_data=False))

    def samples(e, block):
        # one block size throughout: JAX compiles a block once a size
        st, bk = e.init_chains()
        out = []
        for b in range(PRIOR_GENS // PRIOR_EVERY):
            st, bk = block(e, st, bk, PRIOR_EVERY)
            if (b + 1) * PRIOR_EVERY > PRIOR_BURN:
                out.append({k: np.asarray(st[k])
                            for k in ("s_age", "popsize")})
        return _prior_stats(out)

    port = samples(eng, lambda e, s, b, n: e.run_block(s, b, n))
    ref = samples(jeng, lambda e, s, b, n: jax.block_until_ready(
        e.run_block(s, b, n)))
    se = np.sqrt(port.var(0, ddof=1) / PRIOR_RUNS
                 + ref.var(0, ddof=1) / PRIOR_RUNS)
    diff = np.abs(port.mean(0) - ref.mean(0))
    assert np.all(diff < 4.0 * se), (port.mean(0), ref.mean(0), se)
