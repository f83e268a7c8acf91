"""The port's symdirihyperpr (symmetric-Dirichlet state frequencies of
standard data) and continuous characters under Brownian motion against
the JAX package, restating tests/test_symdiri.py and
tests/test_continuous.py.

* ``beta_category_freqs`` (Newton on the port's torch ``betainc``) within
  1e-5 of JAX's over beta in [0.05, 100], and within 1e-4 relative of
  scipy's inverse at the symbeta move's bounds (1e-2 and 1e4);
* the symdiri engine on test_symdiri.py's matrix: off by default, one
  beta category equal to Mk, the binary mixture equal to the average of
  per-category site likelihoods, beta and the multistate frequencies
  sampled;
* cynmix's morphology under symdirihyperpr at identical states: each
  division's lnL within 5e-3 of JAX's (the genes' JAX eigensystems
  carried over, the symdiri ones built by the port), lnPrior within
  1e-4, the same moves, and JAX's stacked groups; a sites mesh takes
  symdiri divisions (lnL equal to the unsharded engine's);
* ``pic_logpdf`` within 1e-4 of JAX's and of the dense multivariate-normal
  REML oracle, the continuous engine at identical states, the CLI end to
  end with its brownScale column;
* prior-only runs (mcmc data=no, 32 runs): symbeta, the multistate
  frequencies under it and brownscale within 4 batch-means standard
  errors of their prior means;
* ``convert`` carries every new state field both ways."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import betaincinv

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.models import special as JS
from mrbayes_tpu.ops import brownian as JB
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy, state_to_numpy
from mrbayes_tpu_torch.envelope import CYNMIX_MODEL
from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.models import special as TS
from mrbayes_tpu_torch.models.substitution import binary_q
from mrbayes_tpu_torch.ops import brownian as TB
from mrbayes_tpu_torch.ops.pruning import division_site_loglik
from mrbayes_tpu_torch.ops.tiprobs import eigh_reversible
from mrbayes_tpu_torch.trees import parse_newick
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers
torch.set_num_threads(1)

SYM_NEX = """
#NEXUS
begin data;
  dimensions ntax=6 nchar=30;
  format datatype=standard symbols="012";
  matrix
    a 010010110100101101001011010010
    b 110011010010110100101101001100
    c 010110100101101001011010010110
    d 011010010112101001211010020110
    e 010010110100101101021011010010
    f 112011010210110100101101001100
  ;
end;
"""
CONT_NEX = """#NEXUS
begin data;
  dimensions ntax=5 nchar=4;
  format datatype=continuous missing=?;
  matrix
  a  0.12  1.4  -0.3  2.2
  b  0.18  1.1  -0.2  2.0
  c  0.50  0.9   0.4  1.1
  d  0.55  0.8   0.6  1.0
  e  0.60  0.7   0.5  0.9
  ;
end;
"""
TAXA = ["a", "b", "c", "d", "e"]
NWK = "((a:0.3,b:0.2):0.15,(c:0.25,(d:0.1,e:0.4):0.3):0.2);"
SYMDIRI = "prset applyto=(1) symdirihyperpr=exponential(1.0)"


def _interpreters(path, lines, nchains=3, **switches):
    it = Interpreter(log=lambda m: None, device="cpu", **switches)
    jit = JInterpreter(log=lambda m: None)
    for ln in [f"execute {path}", *lines,
               f"mcmcp nruns=1 nchains={nchains} seed=3"]:
        it.run_line(ln)
        jit.run_line(ln)
    return it, jit


def _port_engine(tmp_path, text, cmds, **mcmcp):
    path = tmp_path / "m.nex"
    path.write_text(text)
    it = Interpreter(log=lambda m: None, device="cpu")
    for ln in [f"execute {path}", *cmds, "mcmcp " + " ".join(
            f"{k}={v}" for k, v in {"nruns": 1, "nchains": 2, "seed": 3,
                                    **mcmcp}.items())]:
        it.run_line(ln)
    return it.build_engine()


@pytest.mark.parametrize("k", [1, 3, 5])
def test_beta_category_freqs_matches_jax(k):
    betas = np.geomspace(0.05, 100.0, 12).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda b: JS.beta_category_freqs(b, k)))(betas))
    got = TS.beta_category_freqs(torch.as_tensor(betas), k).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("beta", [1e-2, 1e4])
def test_beta_quantile_at_the_move_bounds(beta):
    """symbeta_mult moves beta within [1e-2, 1e4]: the quantiles stay
    finite, ordered and within 1e-4 relative of scipy's inverse there."""
    got = TS.beta_category_freqs(torch.tensor([beta]), 5)[0].numpy()
    mid = (np.arange(5) + 0.5) / 5
    want = betaincinv(beta, beta, mid)
    assert np.all(np.isfinite(got)) and np.all(np.diff(got) >= 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-12)


def test_symdiri_off_by_default(tmp_path):
    eng = _port_engine(tmp_path, SYM_NEX, ["lset coding=variable"])
    assert not any(c.symdiri for c in eng.div_cfg)
    assert not any(m.name.startswith(("symbeta", "sympi"))
                   for m in eng.moves)


def test_symdiri_binary_one_cat_equals_mk(tmp_path):
    """One beta category sits at the Beta(b, b) median 1/2: the mixture
    is the uniform Mk model."""
    e1 = _port_engine(tmp_path, SYM_NEX, [
        "lset nbetacat=1", "prset symdirihyperpr=fixed(2.0)"])
    e0 = _port_engine(tmp_path, SYM_NEX, [])
    s1, _ = e1.init_chains()
    s0, _ = e0.init_chains()
    np.testing.assert_allclose(s1["lnL"].numpy(), s0["lnL"].numpy(),
                               atol=1e-2, rtol=0)


def test_symdiri_binary_mixture_and_multistate(tmp_path):
    eng = _port_engine(tmp_path, SYM_NEX, [
        "lset nbetacat=4", "prset symdirihyperpr=fixed(1.5)"])
    binary = [i for i, c in enumerate(eng.div_cfg)
              if c.fixed_symbeta > 0 and c.div.n_states == 2]
    multi = [i for i, c in enumerate(eng.div_cfg)
             if c.sympi_group >= 0 and c.div.n_states == 3]
    assert binary and multi
    # the fixed beta's categories are built once, no move refreshes them
    assert binary[0] in eng._const_eigs
    assert eng.div_cfg[binary[0]].n_cats == 4
    states, bk = eng.init_chains()
    assert "sympi3" in states and np.isfinite(states["lnL"].numpy()).all()
    states, bk = eng.run_block(states, bk, 300)
    assert np.isfinite(states["lnL"].numpy()).all()
    pi3 = states["sympi3"][0, 0].numpy()
    assert abs(pi3.sum() - 1.0) < 1e-5 and pi3.std() > 1e-6


def test_symdiri_sampled_beta(tmp_path):
    eng = _port_engine(tmp_path, SYM_NEX, [
        "prset symdirihyperpr=exponential(1.0)"])
    names = [m.name for m in eng.moves]
    assert "symbeta_mult" in names
    mv = eng.moves[names.index("symbeta_mult")]
    assert mv.updates_q and mv.eig_divs == tuple(
        i for i, c in enumerate(eng.div_cfg) if c.div.n_states == 2)
    states, bk = eng.init_chains()
    assert np.isfinite(states["lnP"].numpy()).all()
    states, bk = eng.run_block(states, bk, 300)
    assert np.isfinite(states["lnL"].numpy()).all()
    assert abs(float(states["symbeta"][0, 0]) - 1.0) > 1e-6
    st = {k: v for k, v in states.items()
          if k not in SCORE_KEYS and not k.startswith("eig")}
    fresh = eng.score(eng.refresh_eigs(st))
    np.testing.assert_allclose(states["lnL"].numpy(), fresh["lnL"].numpy(),
                               atol=1e-3, rtol=0)


def test_symdiri_binary_oracle(tmp_path):
    """The beta mixture's lnL equals the log of the average over the
    categories of each one's F81 site likelihoods (restating
    test_symdiri.py's oracle, coding=all)."""
    eng = _port_engine(tmp_path, SYM_NEX, [
        "lset nbetacat=3 coding=all", "prset symdirihyperpr=fixed(0.8)"])
    states, _ = eng.init_chains()
    i = next(k for k, c in enumerate(eng.div_cfg) if c.div.n_states == 2)
    got = eng.division_lnls(states)[:, i].numpy()
    q = TS.beta_category_freqs(torch.tensor(0.8), 3).float()
    site = []
    for qb in q:
        pi = torch.stack([qb, 1.0 - qb])[None]
        lam, U, V = eigh_reversible(binary_q(pi), pi)
        site.append(division_site_loglik(
            states["left"], states["right"], states["parent"],
            states["blen"], eng.tip_partials[i], lam.expand(2, -1),
            U.expand(2, -1, -1), V.expand(2, -1, -1), pi, torch.ones(1, 1),
            0.0, None, eng.n_tips).double().numpy())
    want = (eng.weights[i].double().numpy()
            * np.log(np.mean(np.exp(site), axis=0))).sum(-1)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def cynmix_pair():
    return _interpreters(example("cynmix.nex"), [*CYNMIX_MODEL, SYMDIRI],
                         stacked=True)


def test_cynmix_symdiri_matches_jax_at_identical_states(cynmix_pair):
    it, jit = cynmix_pair
    eng, jeng = it.build_engine(), jit.build_engine()
    assert [(c.div.n_states, c.n_cats, c.sympi_field)
            for c in eng.div_cfg[:4]] == [(2, 20, ""), (3, 4, "sympi3"),
                                          (4, 4, "sympi4"), (8, 4, "sympi8")]
    rng = np.random.default_rng(6)
    states, _ = eng.init_chains()
    st = {k: v for k, v in state_to_numpy(states).items()
          if k not in SCORE_KEYS and not k.startswith("eig")}
    st["shape"] = rng.uniform(0.3, 2.0, st["shape"].shape).astype(np.float32)
    st["symbeta"] = rng.uniform(0.2, 5.0, (3, 1)).astype(np.float32)
    for f in ("sympi3", "sympi4", "sympi8"):
        st[f] = rng.dirichlet(np.full(st[f].shape[-1], 3.0),
                              st[f].shape[:-1]).astype(np.float32)
    # the binary bucket (beta categories) and the 3-state one (sampled
    # frequencies; the 4- and 8-state ones take the same path, and JAX
    # compiles each for seconds); the genes' paths are held in
    # test_torch_standard.py.  A symdiri division has no eigensystem cache
    # in JAX (it builds them inline) and the port builds its own.
    buckets = [0, 1]
    want = np.asarray(jax.jit(jax.vmap(lambda s: jnp.stack(
        [jeng._division_lnL(s, i, s["blen"]) for i in buckets], -1)))(st))
    lnP = np.asarray(jax.jit(jax.vmap(jeng.log_prior))(st))
    tst = eng.refresh_eigs(state_from_numpy(st, "cpu"))
    np.testing.assert_allclose(eng.division_lnls(tst)[:, buckets].numpy(),
                               want, atol=5e-3, rtol=0)
    np.testing.assert_allclose(eng.log_prior(tst).numpy(), lnP, atol=1e-4,
                               rtol=0)
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    # JAX prints the genes' pinvar columns as pinvar{} (ROADMAP Queue 3)
    assert [n if not n.startswith("pinvar") else "pinvar{}"
            for n, _ in param_columns(eng)] == \
        [n for n, _ in j_param_columns(jeng)]


def test_cynmix_symdiri_stacked_groups_equal_jax(cynmix_pair, monkeypatch):
    """The symdiri morphology buckets leave the stacked group; the
    remaining small genes form JAX's groups."""
    it, jit = cynmix_pair
    monkeypatch.setenv("MB_TPU_STACKED", "1")
    jeng = jit.build_engine()
    eng = it.build_engine()
    assert [g for g, _ in eng._stacked_pruners] == \
        [g for g, _ in jeng._stacked_pruners]
    assert not any(i < 4 for g, _ in eng._stacked_pruners for i in g)


def test_site_shards_take_symdiri(tmp_path):
    """A sites mesh takes symdirihyperpr divisions as JAX's does: each
    binary category's own root frequencies reach every shard's reduction
    and the coding dummies' pass; lnL equals the unsharded engine's."""
    from mrbayes_tpu_torch.parallel.mesh import make_mesh, shard_engine_data
    eng = _port_engine(tmp_path, SYM_NEX, [
        "lset nbetacat=3", "prset symdirihyperpr=exponential(1.0)"])
    states, _ = eng.init_chains()
    states = eng.refresh_eigs({**states, "symbeta": torch.tensor(
        [[0.4], [3.0]])})
    whole = eng.division_lnls(states)
    shard_engine_data(eng, make_mesh(1, 2, ["cpu"] * 2))
    np.testing.assert_allclose(eng.division_lnls(states).numpy(),
                               whole.numpy(), atol=1e-3, rtol=0)


def _vcv(t, n):
    """The phylogenetic variance-covariance matrix: shared path lengths to
    the root of the rooted-at-tip-0 layout."""
    def ancestors(v):
        out = set()
        while v != t.root:
            out.add(v)
            v = t.parent[v]
        return out

    return np.array([[sum(t.blen[v] for v in ancestors(i) & ancestors(j))
                      for j in range(n)] for i in range(n)])


def _mvn_reml(x, V, sigma2):
    """The REML log-density: the contrasts x_i - x_0 under their MVN."""
    n = len(x)
    D = np.zeros((n - 1, n))
    D[:, 0] = -1.0
    D[np.arange(n - 1), np.arange(1, n)] = 1.0
    W = D @ V @ D.T * sigma2
    y = D @ x
    _, logdet = np.linalg.slogdet(W)
    return float(-0.5 * ((n - 1) * np.log(2 * np.pi) + logdet
                         + y @ np.linalg.solve(W, y)))


@pytest.mark.parametrize("sigma2", [1.0, 0.37, 4.2])
def test_pic_matches_jax_and_mvn_oracle(sigma2):
    t = parse_newick(NWK, TAXA)
    X = np.random.default_rng(5).normal(size=(5, 3)).astype(np.float32)
    got = TB.pic_logpdf(*(torch.as_tensor(getattr(t, f)[None]).long()
                          for f in ("left", "right", "parent")),
                        torch.as_tensor(t.blen[None], dtype=torch.float32),
                        torch.as_tensor(X), torch.tensor([sigma2]), 5)
    want = float(JB.pic_logpdf(
        jnp.asarray(t.left), jnp.asarray(t.right), jnp.asarray(t.parent),
        jnp.asarray(t.blen, jnp.float32), jnp.asarray(X),
        jnp.float32(sigma2), 5))
    oracle = sum(_mvn_reml(X[:, c].astype(np.float64), _vcv(t, 5), sigma2)
                 for c in range(3))
    assert abs(float(got[0]) - want) < 1e-4
    assert abs(float(got[0]) - oracle) < 1e-4


def test_continuous_engine_matches_jax(tmp_path):
    path = tmp_path / "cont.nex"
    path.write_text(CONT_NEX)
    it, jit = _interpreters(str(path), ["prset brownscalepr=gamma(1,10)"])
    eng, jeng = it.build_engine(), jit.build_engine()
    assert eng._pruners == [None] and not eng.div_cfg[0].prunes
    states, _ = eng.init_chains()
    st = {k: v for k, v in state_to_numpy(states).items()
          if k not in SCORE_KEYS}
    st["brownscale"] = np.array([[0.3], [1.0], [2.5]], np.float32)
    want = np.asarray(jax.jit(jax.vmap(jeng.log_likelihood))(st))
    lnP = np.asarray(jax.jit(jax.vmap(jeng.log_prior))(st))
    tst = state_from_numpy(st, "cpu")
    np.testing.assert_allclose(eng.log_likelihood(tst).numpy(), want,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(eng.log_prior(tst).numpy(), lnP, atol=1e-4,
                               rtol=0)
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    assert [n for n, _ in param_columns(eng)] == \
        [n for n, _ in j_param_columns(jeng)] == ["TL", "brownScale"]


def test_continuous_end_to_end(tmp_path):
    """A CLI run on the continuous matrix: sigma^2 sampled (the brownScale
    column), finite lnL, the similar pairs' splits sampled."""
    from mrbayes_tpu_torch.summarize.sumt import sumt
    (tmp_path / "cont.nex").write_text(CONT_NEX)
    prefix = str(tmp_path / "cont_out")
    it = Interpreter(log=lambda m: None, device="cpu")
    it.run_line(f"execute {tmp_path}/cont.nex")
    it.run_line("prset brownscalepr=gamma(1,10)")
    it.run_line(f"mcmc ngen=500 nruns=1 nchains=2 samplefreq=50 "
                f"printfreq=500 diagnfreq=500 file={prefix}")
    lines = open(prefix + ".run1.p").readlines()
    hdr = lines[1].rstrip("\n").split("\t")
    assert hdr == ["Gen", "lnLike", "lnPrior", "TL", "brownScale"]
    rows = [dict(zip(hdr, ln.split("\t"))) for ln in lines[2:]]
    sig = [float(r["brownScale"]) for r in rows]
    assert all(s > 0 for s in sig) and len({f"{s:.6f}" for s in sig}) > 1
    assert all(np.isfinite(float(r["lnLike"])) for r in rows)
    res = sumt(prefix, burninfrac=0.3, log=lambda m: None,
               write_files=False)
    assert frozenset({3, 4}) in res["split_freqs"] \
        or frozenset({1, 2}) in res["split_freqs"]


def test_continuous_refusals(tmp_path):
    (tmp_path / "bad.nex").write_text(CONT_NEX.replace("0.12", "?   "))
    it = Interpreter(log=lambda m: None, device="cpu")
    it.run_line(f"execute {tmp_path}/bad.nex")
    with pytest.raises(Exception, match="missing continuous"):
        it.run_line("mcmc ngen=10 nruns=1 nchains=1")
    (tmp_path / "cont.nex").write_text(CONT_NEX)
    it = Interpreter(log=lambda m: None, device="cpu")
    it.run_line(f"execute {tmp_path}/cont.nex")
    it.run_line("prset browncorrpr=fixed(0.5)")
    with pytest.raises(ValueError, match="browncorrpr: only fixed"):
        it.build_engine()
    # BEST's prset keys are ported (item 14e): this one now sets its value
    it.run_line("prset popvarpr=variable")
    assert it.env.tree_settings.popvarpr == "variable"


def prior_only_means(eng, fields, gens=1000):
    """Each run's mean of every ``fields`` entry (flattened over the
    non-chain axes) over the second half of a prior-only run: [runs,
    width]."""
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, gens // 2)
    runs = states["parent"].shape[0]
    samples = []
    for _ in range(10):
        states, bk = eng.run_block(states, bk, gens // 20)
        samples.append(torch.cat([states[f].reshape(runs, -1).double()
                                  for f in fields], -1))
    return torch.stack(samples).mean(0).numpy()


def assert_prior_mean(batch, mean):
    """The runs' means (batches) within 4 standard errors of ``mean``."""
    got = batch.mean(0)
    se = batch.std(0, ddof=1) / np.sqrt(batch.shape[0])
    assert np.all(np.abs(got - mean) < 4.0 * se + 1e-9), (got, mean, se)


def test_prior_only_symbeta_and_sympi(tmp_path):
    """symbeta ~ exponential(1) (mean 1; the move's bounds cut 1% of the
    mass below 1e-2) and the 3-state frequencies under Dirichlet(symbeta)
    (each 1/3)."""
    eng = _port_engine(tmp_path, SYM_NEX, [
        "prset symdirihyperpr=exponential(1.0)"], nruns=32, nchains=1,
        data="no")
    batch = prior_only_means(eng, ("symbeta", "sympi3"), gens=600)
    assert_prior_mean(batch, np.array([1.0, 1 / 3, 1 / 3, 1 / 3]))


def test_prior_only_brownscale(tmp_path):
    """brownscale ~ gamma(2, 2): mean 1, the start (gamma(1, 10)'s mean
    0.1 lies 10 multiplier moves from it, longer than this run's
    burn-in)."""
    nex = CONT_NEX.replace("ntax=5", "ntax=8").replace(
        "  ;", "  f  0.1 0.2 0.3 0.4\n  g  0.5 0.6 0.7 0.8\n"
        "  h  0.9 1.0 1.1 1.2\n  ;")
    eng = _port_engine(tmp_path, nex, ["prset brownscalepr=gamma(2,2)"],
                       nruns=32, nchains=1, data="no")
    assert eng.n_tips == 8
    assert_prior_mean(prior_only_means(eng, ("brownscale",)), 1.0)


def test_convert_carries_family_fields():
    """The new state fields cross ``convert`` by name, float32 here and
    back to JAX's dtypes and values."""
    rng = np.random.default_rng(2)
    jst = {"ratecorr": rng.uniform(-1, 1, (3, 1)).astype(np.float32),
           "mixtrates": rng.dirichlet(np.ones(4), (3, 1)).astype(np.float32),
           "symbeta": rng.uniform(0.1, 5, (3, 1)).astype(np.float32),
           "sympi3": rng.dirichlet(np.ones(3), (3, 1)).astype(np.float32),
           "brownscale": rng.uniform(0.1, 5, (3, 1)).astype(np.float32)}
    st = state_from_numpy(jst, "cpu")
    back = state_to_numpy(st)
    for k, v in jst.items():
        assert st[k].dtype == torch.float32 and st[k].shape == v.shape
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
