"""The port's lognormal, kmixture and autocorrelated-gamma rates and the
Tuffley-Steel parsimony model against the JAX package, restating the
kmixture and parsmodel cases of tests/test_models_extra.py and
tests/test_likelihood.py's adgamma tests (:323, :387).

* ``LognormalRates`` and ``AdgammaTransition`` within 1e-6 of JAX's
  ``discrete_lognormal`` and ``adgamma_transition``;
* the adgamma HMM (``adgamma_loglik_from_cats``, the site operators
  reduced pairwise in site order) within 1e-4 relative of JAX's
  associative scan on the same inputs and 1e-3 of a float64 sequential
  forward, in a number of PyTorch ops that grows with log2 of the sites;
* the adgamma engine against a float64 oracle of per-category matrix
  exponentials (test_likelihood.py's tolerance);
* the engine at identical states on primates.nex under lnorm, kmixture,
  adgamma and parsmodel (the JAX state, its eigensystem cache included,
  carried over by ``convert.state_from_numpy``): lnL within 5e-3, lnPrior
  within 1e-4, the same moves and ``.p`` columns;
* the parsimony lnL equal to -(T + n) log k of a numpy Fitch count and to
  JAX's within 1e-3;
* lnorm and kmixture divisions share a multiwalk group (the generic
  family), adgamma and parsimony-model ones never group, and a sites mesh
  takes both (lnL equal to the unsharded engine's);
* prior-only runs (mcmc data=no, 8 tips, 32 runs): the correlation and
  the mixture rates within 4 batch-means standard errors of their prior
  means."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.models import rates as JR
from mrbayes_tpu.ops import pruning as JP
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy, state_to_numpy
from mrbayes_tpu_torch.data import (DataSet, Division, compress_columns,
                                    make_divisions)
from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS, Engine
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.mcmc.settings import DivisionSettings, McmcSettings
from mrbayes_tpu_torch.models import rates as TR
from mrbayes_tpu_torch.nexus.datatypes import DataType, FormatInfo
from mrbayes_tpu_torch.nexus.parser import CharacterMatrix
from mrbayes_tpu_torch.ops import pruning as TP
from mrbayes_tpu_torch.trees import Tree
from conftest import example
import reference_impl as ref

# the tensors here are small: intra-op threads would only contend with
# the other test workers
torch.set_num_threads(1)

C = 3
FAMILIES = {"lnorm": "lset nst=6 rates=lnorm",
            "kmixture": "lset nst=6 rates=kmixture nmixtcat=4",
            "adgamma": "lset nst=6 rates=adgamma",
            "parsmodel": "lset parsmodel=yes"}


def _interpreters(path, lines, nchains=C, **switches):
    it = Interpreter(log=lambda m: None, device="cpu", **switches)
    jit = JInterpreter(log=lambda m: None)
    for ln in [f"execute {path}", *lines,
               f"mcmcp nruns=1 nchains={nchains} seed=3"]:
        it.run_line(ln)
        jit.run_line(ln)
    return it, jit


def _dna_dataset(ntax=7, nchar=60, seed=3):
    rng = np.random.default_rng(seed)
    codes = (1 << rng.integers(0, 4, size=(ntax, nchar))).astype(np.uint32)
    m = CharacterMatrix(taxa=[f"t{i}" for i in range(ntax)], nchar=nchar,
                        fmt=FormatInfo(datatype=DataType.DNA), codes=codes,
                        col_datatype=[DataType.DNA] * nchar)
    return DataSet(taxa=m.taxa, nchar=nchar, divisions=make_divisions(m))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_discrete_lognormal_matches_jax(k):
    sigma = np.array([1e-3, 0.3, 1.0, 2.5, 5.0], np.float32)
    want = np.asarray(jax.jit(JR.discrete_lognormal, static_argnums=1)(
        sigma, k))
    got = TR.LognormalRates(k)(torch.as_tensor(sigma)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.mean(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("k", [2, 4, 6])
def test_adgamma_transition_matches_jax(k):
    rho = np.array([-0.9995, -0.6, -0.1, 0.0, 0.35, 0.8, 0.9995], np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda r: JR.adgamma_transition(r, k)))(rho))
    got = TR.AdgammaTransition(k)(torch.as_tensor(rho)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def _hmm_inputs(n, K=4, seed=0):
    """Per-site category likelihoods of two chains, their scalers, the
    chains' transition matrices' powers for site distances 1, 2 and 5, and
    each site's distance index."""
    rng = np.random.default_rng(seed + n)
    rP = rng.uniform(0.01, 1.0, (2, n, K)).astype(np.float32)
    ls = rng.normal(-3.0, 1.0, (2, n)).astype(np.float32)
    M = TR.AdgammaTransition(K)(torch.tensor([0.7, -0.4]))
    pows = torch.stack([torch.linalg.matrix_power(M, j) for j in (1, 2, 5)],
                       1)
    jump_idx = rng.integers(0, 3, n)
    jump_idx[0] = 0
    return rP, ls, pows.numpy(), jump_idx


def _forward64(rP, ls, pows, jump_idx):
    """The float64 sequential forward algorithm of one chain."""
    F = rP[0].astype(np.float64)
    logs = 0.0
    for c in range(1, len(rP)):
        F = rP[c] * (pows[jump_idx[c]].astype(np.float64) @ F)
        m = F.max()
        F /= m
        logs += np.log(m)
    return logs + np.log(F.mean()) + ls.astype(np.float64).sum()


@pytest.mark.parametrize("n", [1, 7, 64, 898])
def test_adgamma_hmm_matches_jax_and_forward(n):
    rP, ls, pows, jump_idx = _hmm_inputs(n)
    got = TP.adgamma_loglik_from_cats(
        torch.as_tensor(rP), torch.as_tensor(ls), torch.as_tensor(pows),
        torch.as_tensor(jump_idx)).numpy()
    want = np.asarray(jax.jit(jax.vmap(JP.adgamma_loglik_from_cats,
                                       in_axes=(0, 0, 0, None)))(
        rP, ls, pows, jump_idx))
    for c in range(2):
        assert abs(got[c] - want[c]) <= 1e-4 * abs(want[c]), (n, c, got[c],
                                                              want[c])
        exact = _forward64(rP[c], ls[c], pows[c], jump_idx)
        assert abs(got[c] - exact) < 1e-3, (n, c, got[c], exact)


def _op_count(n):
    rP, ls, pows, jump_idx = _hmm_inputs(n)
    args = (torch.as_tensor(rP), torch.as_tensor(ls), torch.as_tensor(pows),
            torch.as_tensor(jump_idx))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        TP.adgamma_loglik_from_cats(*args)
    return sum(e.count for e in prof.key_averages()
               if e.key in ("aten::matmul", "aten::bmm", "aten::mul",
                            "aten::div", "aten::cat", "aten::amax"))


def test_adgamma_hmm_ops_grow_with_log_sites():
    """No per-site loop: 898 sites (10 rounds) take a few ops more than
    449 (9 rounds), not hundreds."""
    small, large = _op_count(449), _op_count(898)
    assert large < 120, large
    assert 0 < large - small <= 12, (small, large)


def test_adgamma_vs_oracle():
    """rates=adgamma through the engine against a float64 oracle: per-
    category matrix exponentials pruned, the sequential forward algorithm
    over the sites (restating tests/test_likelihood.py:323 and its
    tolerance)."""
    rng = np.random.default_rng(7)
    n_tips, nchar, K = 6, 40, 4
    masks = (1 << rng.integers(0, 4, size=(n_tips, nchar))).astype(np.uint32)
    pats, w, inv = compress_columns(masks)
    div = Division(index=0, dtype=DataType.DNA, n_states=4, patterns=pats,
                   weights=w, char_ids=np.arange(nchar),
                   pattern_of_char=inv)
    ds = DataSet(taxa=[f"t{i}" for i in range(n_tips)], nchar=nchar,
                 divisions=[div])
    eng = Engine(ds, [DivisionSettings(nst="6", rates="adgamma",
                                       ngammacat=K)],
                 mcmc=McmcSettings(nruns=1, nchains=1, seed=3), device="cpu")
    st = eng.init_state(np.random.default_rng(0))
    st = {k: torch.as_tensor(v[None]) for k, v in st.items()}
    st["ratecorr"] = torch.tensor([[0.6]])
    st["shape"] = torch.tensor([[0.8]])
    got = float(eng.log_likelihood(eng.refresh_eigs(st))[0])
    t = Tree(parent=st["parent"][0].numpy(), left=st["left"][0].numpy(),
             right=st["right"][0].numpy(),
             blen=st["blen"][0].numpy().astype(np.float64), n_tips=n_tips)
    pi = st["pi"][0, 0].double().numpy()
    Q = ref.gtr_q(st["revmat"][0, 0].double().numpy(), pi)
    rates = eng._gamma_tables[K](st["shape"][:, 0])[0].double().numpy()
    P = np.array([[expm(Q * t.blen[v] * r) for r in rates]
                  for v in range(t.n_nodes)])
    cl = np.zeros((t.n_nodes, pats.shape[1], K, 4))
    cl[:n_tips] = ((pats[..., None] >> np.arange(4)) & 1)[:, :, None, :]
    for v in t.postorder():
        lc, rc = t.left[v], t.right[v]
        cl[v] = (np.einsum("ksj,pkj->pks", P[lc], cl[lc])
                 * np.einsum("ksj,pkj->pks", P[rc], cl[rc]))
    rP = np.einsum("pks,s->pk", cl[t.root], pi)
    M = eng._adg_trans[K](st["ratecorr"][:, 0])[0].double().numpy()
    want = _forward64(rP[inv], np.zeros(nchar), M[None],
                      np.zeros(nchar, int))
    assert abs(got - want) < 0.05 + 2e-5 * abs(want), (got, want)


def _jax_state(eng, jeng, rng):
    """Starting chains (the port's ``init_chains`` draws the JAX package's
    trees, and JAX's would compile its whole score) with random
    substitution parameters and the JAX engine's eigensystems (numpy
    leaves, JAX's dtypes)."""
    st, _ = eng.init_chains()
    st = {k: v for k, v in state_to_numpy(st).items()
          if k not in SCORE_KEYS and not k.startswith("eig")}
    draws = {"shape": lambda sh: rng.uniform(0.3, 2.0, sh),
             "ratecorr": lambda sh: rng.uniform(-0.9, 0.9, sh),
             "pi": lambda sh: rng.dirichlet(np.ones(sh[-1]) * 5, sh[:-1]),
             "revmat": lambda sh: rng.dirichlet(np.ones(sh[-1]) * 2, sh[:-1]),
             "mixtrates": lambda sh: rng.dirichlet(np.ones(sh[-1]), sh[:-1])}
    for k, draw in draws.items():
        if k in st:
            st[k] = draw(st[k].shape).astype(np.float32)
    jst = jax.jit(jax.vmap(jeng.refresh_eigs))(st)
    return {k: np.asarray(v) for k, v in jst.items()}


@pytest.fixture(scope="module", params=list(FAMILIES))
def primates_family(request):
    it, jit = _interpreters(example("primates.nex"), [FAMILIES[request.param]])
    return request.param, it, jit


def test_engine_matches_jax_at_identical_states(primates_family):
    name, it, jit = primates_family
    eng, jeng = it.build_engine(), jit.build_engine()
    jst = _jax_state(eng, jeng, np.random.default_rng(11))
    want = np.asarray(jax.jit(jax.vmap(jeng.log_likelihood))(jst))
    lnP = np.asarray(jax.jit(jax.vmap(jeng.log_prior))(jst))
    st = state_from_numpy(jst, "cpu")
    np.testing.assert_allclose(eng.log_likelihood(st).numpy(), want,
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(eng.log_prior(st).numpy(), lnP, atol=1e-4,
                               rtol=0)
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    assert [n for n, _ in param_columns(eng)] == \
        [n for n, _ in j_param_columns(jeng)]
    cfg = eng.div_cfg[0]
    assert (eng._pruners[0] is None) == (name == "parsmodel")
    assert cfg.n_cats == {"parsmodel": 1}.get(name, 4)


def test_family_runs_carry_exact_scores(primates_family):
    """A block of every move type; the carried lnL and prior equal a
    recompute from fresh eigensystems, and each family's parameter moved
    and stayed in its support."""
    name, it, _ = primates_family
    eng = it.build_engine()
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 60)
    st = {k: v for k, v in states.items()
          if k not in SCORE_KEYS and not k.startswith("eig")}
    fresh = eng.score(eng.refresh_eigs(st))
    for k in ("lnL", "lnP"):
        np.testing.assert_allclose(states[k].numpy(), fresh[k].numpy(),
                                   atol=1e-3, rtol=0)
    if name == "adgamma":
        assert (states["ratecorr"].abs() <= 1.0).all()
    if name == "kmixture":
        np.testing.assert_allclose(states["mixtrates"].sum(-1).numpy(), 1.0,
                                   atol=1e-5)


def test_kmixture_uniform_equals_equal_rates():
    """With every mixture rate equal the kmixture likelihood equals the
    rates=equal one (every category rate is 1)."""
    ds = _dna_dataset()
    mc = McmcSettings(nruns=1, nchains=1, seed=5)
    ek = Engine(ds, [DivisionSettings(nst="1", rates="kmixture",
                                      nmixtcat=4)], mcmc=mc, device="cpu")
    ee = Engine(ds, [DivisionSettings(nst="1", rates="equal")], mcmc=mc,
                device="cpu")
    sk, _ = ek.init_chains()
    se, _ = ee.init_chains()
    assert sk["mixtrates"].shape == (1, 1, 4)
    assert abs(float(sk["lnL"][0]) - float(se["lnL"][0])) < 1e-2


def test_kmixture_runs_and_moves():
    ds = _dna_dataset()
    eng = Engine(ds, [DivisionSettings(nst="1", rates="kmixture",
                                       nmixtcat=3)],
                 mcmc=McmcSettings(nruns=1, nchains=2, seed=5), device="cpu")
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 300)
    assert np.isfinite(states["lnL"].numpy()).all()
    r = states["mixtrates"][0, 0].numpy()
    assert abs(r.sum() - 1.0) < 1e-5
    assert r.std() > 1e-6          # the rates moved off uniform


def _fitch_length(t, masks, weights):
    """An independent host Fitch count: weighted changes, the root's
    (basal node, tip 0) comparison included."""
    F = np.zeros((t.n_nodes, masks.shape[1]), np.uint32)
    F[:t.n_tips] = masks
    T = 0.0
    for v in t.postorder():
        a, b = F[t.left[v]], F[t.right[v]]
        inter = a & b
        T += weights[inter == 0].sum()
        F[v] = np.where(inter > 0, inter, a | b)
    return T


def test_parsmodel_tuffley_steel():
    ds = _dna_dataset(ntax=6, nchar=40, seed=9)
    eng = Engine(ds, [DivisionSettings(parsmodel=True)],
                 mcmc=McmcSettings(nruns=1, nchains=2, seed=2), device="cpu")
    states, bk = eng.init_chains()
    div = ds.divisions[0]
    for c in range(2):
        t = eng.extract_tree(states, c)
        T = _fitch_length(t, div.patterns.astype(np.uint32), div.weights)
        want = -(T + div.weights.sum()) * np.log(4.0)
        assert abs(float(states["lnL"][c]) - want) < 1e-3
    assert eng._pruners == [None] and not eng.moves[-1].updates_q
    states, bk = eng.run_block(states, bk, 200)
    assert np.isfinite(states["lnL"].numpy()).all()


def test_parsmodel_on_cynmix_morphology():
    """The parsimony model on cynmix's four standard buckets (one Fitch
    pass over their patterns side by side) beside the GTR genes: each
    bucket's lnL equal to its own numpy Fitch count's within 1e-3."""
    from mrbayes_tpu_torch.envelope import CYNMIX_MODEL
    it = Interpreter(log=lambda m: None, device="cpu")
    for ln in [f"execute {example('cynmix.nex')}", *CYNMIX_MODEL,
               "lset applyto=(1) parsmodel=yes",
               "mcmcp nruns=1 nchains=2 seed=3"]:
        it.run_line(ln)
    eng = it.build_engine()
    pars = [i for i, c in enumerate(eng.div_cfg) if c.parsimony]
    assert pars == [0, 1, 2, 3] and len(eng._pars_lnl) == 1
    states, _ = eng.init_chains()
    got = eng.division_lnls(states).numpy()
    for c in range(2):
        t = eng.extract_tree(states, c)
        for i in pars:
            d = eng.div_cfg[i].div
            T = _fitch_length(t, d.patterns.astype(np.uint32), d.weights)
            want = -(T + d.weights.sum()) * np.log(max(2, d.n_states))
            assert abs(got[c, i] - want) < 1e-3, (c, i, got[c, i], want)


def test_cli_parsmodel_kmixture_parse(tmp_path):
    nex = tmp_path / "p.nex"
    nex.write_text("""#NEXUS
begin data;
  dimensions ntax=4 nchar=8;
  format datatype=dna;
  matrix
    a ACGTACGT
    b ACGTACGA
    c ACGAACGT
    d ACGTACAT
  ;
end;
begin mrbayes;
  lset rates=kmixture nmixtcat=3;
  lset parsmodel=yes;
  prset ratecorrpr=uniform(-0.5,0.5);
end;
""")
    it = Interpreter(log=lambda m: None, device="cpu")
    it.execute_file(str(nex))
    s = it.env.div_settings[0]
    assert s.rates == "kmixture" and s.nmixtcat == 3 and s.parsmodel
    assert (s.adgammacorpr.kind, s.adgammacorpr.params) == ("uniform",
                                                           (-0.5, 0.5))


def test_lnorm_kmixture_share_a_multiwalk_group():
    """primates by codon position under lnorm and kmixture (the generic
    family): one multiwalk group whose lnL equals each division's own
    pass; with adgamma or parsmodel on division 1 no group forms."""
    base = ["charset first_second = 1-898\\3 2-898\\3",
            "charset third = 3-898\\3",
            "partition bycodon = 2: first_second, third",
            "set partition = bycodon",
            "lset applyto=(1) nst=6 rates=lnorm",
            "lset applyto=(2) nst=6 rates=kmixture nmixtcat=4",
            "unlink statefreq=(all) revmat=(all) shape=(all)",
            "prset applyto=(all) ratepr=variable",
            "mcmcp nruns=1 nchains=2 seed=3"]
    it = Interpreter(log=lambda m: None, device="cpu", multiwalk=True,
                     stacked=True)
    it.run_line(f"execute {example('primates.nex')}")
    for ln in base:
        it.run_line(ln)
    eng = it.build_engine()
    assert [g for g, _ in eng._multiwalk_pruners] == [[0, 1]]
    states, _ = eng.init_chains()
    grouped = eng.division_lnls(states)
    eng._multiwalk_pruners, eng._stacked_pruners = [], []
    np.testing.assert_allclose(grouped.numpy(),
                               eng.division_lnls(states).numpy(),
                               atol=1e-3, rtol=0)
    for other in ("rates=adgamma", "parsmodel=yes"):
        it.run_line(f"lset applyto=(1) {other}")
        eng = it.build_engine()
        assert not eng._multiwalk_pruners and not eng._stacked_pruners


def prior_only_means(settings, field, gens=800, runs=32, seed=5):
    """Each run's mean of ``field`` (flattened over its non-chain axes)
    over the second half of a prior-only run (mcmc data=no, one chain a
    run, 8 random DNA taxa): [runs, width]."""
    ds = _dna_dataset(ntax=8, nchar=30)
    eng = Engine(ds, [settings], mcmc=McmcSettings(
        nruns=runs, nchains=1, seed=seed, use_data=False), device="cpu")
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, gens // 2)
    samples = []
    for _ in range(10):
        states, bk = eng.run_block(states, bk, gens // 20)
        samples.append(states[field].reshape(runs, -1).double())
    return torch.stack(samples).mean(0).numpy()


def assert_prior_mean(batch, mean):
    """The runs' means (batches) within 4 standard errors of ``mean``."""
    got = batch.mean(0)
    se = batch.std(0, ddof=1) / np.sqrt(batch.shape[0])
    assert np.all(np.abs(got - mean) < 4.0 * se + 1e-9), (got, mean, se)


def test_prior_only_ratecorr():
    batch = prior_only_means(DivisionSettings(nst="1", rates="adgamma"),
                             "ratecorr")
    assert_prior_mean(batch, 0.0)             # uniform(-1, 1)


def test_prior_only_mixtrates():
    batch = prior_only_means(DivisionSettings(nst="1", rates="kmixture",
                                              nmixtcat=4), "mixtrates")
    assert_prior_mean(batch, 0.25)            # Dirichlet(1, 1, 1, 1)


@pytest.mark.parametrize("family", ["adgamma", "parsmodel"])
def test_site_shards_take_the_families(family):
    """A sites mesh takes these divisions as JAX's does: an adgamma
    division gathers its shards' root partials for the HMM, a
    parsimony-model division keeps its data whole; lnL equals the
    unsharded engine's."""
    from mrbayes_tpu_torch.parallel.mesh import make_mesh, shard_engine_data
    it = Interpreter(log=lambda m: None, device="cpu")
    for ln in [f"execute {example('primates.nex')}", FAMILIES[family],
               "mcmcp nruns=1 nchains=2 seed=3"]:
        it.run_line(ln)
    eng = it.build_engine()
    states, _ = eng.init_chains()
    whole = eng.division_lnls(states)
    shard_engine_data(eng, make_mesh(1, 3, ["cpu"] * 3))
    assert (eng._pruners[0] is None) == (family == "parsmodel")
    np.testing.assert_allclose(eng.division_lnls(states).numpy(),
                               whole.numpy(), atol=1e-3, rtol=0)
