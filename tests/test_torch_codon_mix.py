"""Codon models M3 and M10 in the port against the JAX package, on
replicase.nex (9 taxa, 239 codon patterns, 61 sense codons).

* ``betainc`` (torch has no incomplete beta function) within 1e-12 of
  ``scipy.special.betainc`` and within 2e-5 of ``jax.scipy.special.
  betainc`` (float32: 1.14e-5 from scipy on the grid), and
  ``beta_quantile_breaks`` within 1e-5 of the JAX package's (float32) and
  within 1e-9 of ``scipy.special.betaincinv``, over a grid of a, b in
  [0.05, 20];
* ``_m10_omegas_weights`` within 1e-5 of JAX's and of the reference's
  printed class omegas (``_ref_omegas``, rtol 0.02), and the
  ``replicase_m10`` rows of ``tests/golden_extra.json`` within their
  ``tol`` (1.5) through the port's CLI;
* M3 and M10 at identical states: lnL within 5e-3 of the JAX package's
  function evaluated in float64 (``jax_exact_lnl``; at S 61 the JAX
  engine's float32 eigensystems are not the yardstick), lnPrior within
  1e-4 of the JAX engine's, M3's order-statistic prior -inf off order;
* the moves' names, weights, tunings and prior scopes equal JAX's, and
  every M3/M10 move refreshes the eigensystems;
* a prior-only run of the M3 and M10 parameter moves, 32 runs x 1,200
  generations on each package: each parameter's mean (of log omega for
  M3's heavy-tailed omegas) within 4 batch-means standard errors of
  JAX's."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import torch
from jax.scipy.special import betainc as j_betainc

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.models.rates import beta_quantile_breaks as j_breaks
from mrbayes_tpu.ops import pruning as JP
from mrbayes_tpu.ops import tiprobs as JTP
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.models.rates import beta_quantile_breaks, betainc
from mrbayes_tpu_torch.trees import parse_newick, random_unrooted
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = [r for r in json.load(open(os.path.join(HERE, "golden_extra.json")))
        if r["name"] == "replicase_m10"]
GRID = np.exp(np.linspace(np.log(0.05), np.log(20.0), 7))
C = 2


def test_betainc_matches_scipy_and_jax():
    a, b = np.meshgrid(GRID, GRID, indexing="ij")
    x = np.linspace(1e-4, 1.0 - 1e-4, 101)
    a, b = a[..., None], b[..., None]
    ours = betainc(torch.as_tensor(a), torch.as_tensor(b),
                   torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(ours, sps.betainc(a, b, x), atol=1e-12,
                               rtol=0)
    # JAX's float32 betainc lies up to 1.14e-5 from scipy on this grid
    theirs = np.asarray(j_betainc(jnp.asarray(a, jnp.float32),
                                  jnp.asarray(b, jnp.float32),
                                  jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=0)


@pytest.mark.parametrize("K", [4, 8])
def test_beta_quantile_breaks_match_jax_and_scipy(K):
    a, b = (v.reshape(-1) for v in np.meshgrid(GRID, GRID, indexing="ij"))
    ours = beta_quantile_breaks(torch.as_tensor(a), torch.as_tensor(b),
                                K).numpy()
    theirs = np.asarray(jax.jit(jax.vmap(lambda p, q: j_breaks(p, q, K)))(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    r = (np.arange(K) + 0.5) / K
    np.testing.assert_allclose(
        ours, sps.betaincinv(a[:, None], b[:, None], r), atol=1e-9, rtol=0)


def _interpreters(omegavar, nchains=C):
    lines = [f"execute {example('replicase.nex')}",
             f"lset nucmodel=codon omegavar={omegavar}",
             f"mcmcp nruns=1 nchains={nchains} seed=3"]
    it = Interpreter(log=lambda m: None, device="cpu")
    jit = JInterpreter(log=lambda m: None)
    for ln in lines:
        it.run_line(ln)
        jit.run_line(ln)
    return it, jit


@pytest.fixture(scope="module")
def engines():
    out = {}
    for name in ("m3", "m10"):
        it, jit = _interpreters(name)
        out[name] = (it.build_engine(), jit.build_engine())
    return out


def _params(name, rng):
    st = {"pi61": rng.dirichlet(np.ones(61) * 5, size=(C, 1))}
    if name == "m3":
        st["m3omega"] = np.sort(rng.uniform(0.02, 4.0, (C, 1, 3)), -1)
        st["m3probs"] = rng.dirichlet(np.ones(3) * 2, size=(C, 1))
    else:
        st["m10beta"] = rng.uniform(0.1, 5.0, (C, 1, 2))
        st["m10gamma"] = rng.uniform(0.2, 8.0, (C, 1, 2))
        st["m10catprobs"] = rng.dirichlet(np.ones(2) * 2, size=(C, 1))
    return {k: v.astype(np.float32) for k, v in st.items()}


def _state(eng, name, seed):
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(eng.n_tips, rng, mean_blen=0.1)
             for _ in range(C)]
    st = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int32)
          for f in ("left", "right", "parent")}
    st["blen"] = np.stack([t.blen for t in trees]).astype(np.float32)
    st.update(_params(name, rng))
    return st


def jax_exact_lnl(jeng, jst):
    """The JAX package's codon lnL [C] (``_codon_loglik``) by its own ops
    in float64 (``jax.enable_x64``) with a float64 ``eigh_reversible`` of
    each chain's class generators."""
    cfg = jeng.div_cfg[0]

    def f64(x):
        return jnp.asarray(x, jnp.float64)

    def one(s1):
        Q, pi = jeng._division_q_pi(s1, 0)
        lam, U, Uinv = JTP.eigh_reversible(f64(Q), f64(pi)[None])
        if cfg.m3_group >= 0:
            w = s1["m3probs"][cfg.m3_group]
        else:
            w = jeng._m10_omegas_weights(s1, cfg)[1]
        return JP.division_loglik(
            s1["left"], s1["right"], s1["parent"], f64(s1["blen"]),
            f64(jeng.tip_partials[0]), f64(jeng.weights[0]), lam, U, Uinv,
            f64(pi), jnp.ones((w.shape[0],), jnp.float64), 0.0, None,
            jeng.n_tips, rate_mult=3.0, cat_weights=f64(w))

    with jax.enable_x64(True):
        return np.asarray(jax.jit(jax.vmap(one))(jst))


@pytest.mark.parametrize("name", ["m3", "m10"])
def test_engine_matches_jax_at_identical_states(engines, name):
    eng, jeng = engines[name]
    st = _state(eng, name, 5)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    own = eng.refresh_eigs(state_from_numpy(st, "cpu"))
    K = 3 if name == "m3" else 8
    assert eng.div_cfg[0].n_cats == K and own["eigL0"].shape == (C, K, 61)
    np.testing.assert_allclose(eng.log_likelihood(own).numpy(),
                               jax_exact_lnl(jeng, jst), atol=5e-3, rtol=0)
    j_prior = jax.jit(jax.vmap(jeng.log_prior))
    np.testing.assert_allclose(eng.log_prior(own).numpy(),
                               np.asarray(j_prior(jst)), atol=1e-4, rtol=0)
    if name == "m3":
        # omegas out of order have prior probability 0 on both sides
        bad = {**st, "m3omega": st["m3omega"][..., ::-1].copy()}
        assert (eng.log_prior(state_from_numpy(bad, "cpu")) < -1e29).all()
        assert (np.asarray(j_prior({k: jnp.asarray(v) for k, v in
                                    bad.items()})) < -1e29).all()


def test_m10_omegas_weights_match_jax(engines):
    eng, jeng = engines["m10"]
    st = _params("m10", np.random.default_rng(7))
    om, w = eng._m10_omegas_weights(state_from_numpy(st, "cpu"),
                                    eng.div_cfg[0])
    jom, jw = jax.vmap(lambda s: jeng._m10_omegas_weights(
        s, jeng.div_cfg[0]))({k: jnp.asarray(v) for k, v in st.items()})
    np.testing.assert_allclose(om.numpy(), np.asarray(jom), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-7)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.fixture(scope="module")
def m10_row_engine():
    it = Interpreter(log=lambda m: None, device="cpu")
    for c in GOLD[0]["commands"]:
        if c.startswith("execute "):
            # the reference's example, vendored under tests/data
            c = "execute " + example(os.path.basename(c.split()[1]))
        it.run_line(c)
    return it.build_engine()


@pytest.mark.parametrize("i", range(len(GOLD)),
                         ids=[f"gen{r['gen']}" for r in GOLD])
def test_golden_replicase_m10_row(m10_row_engine, i):
    rec = GOLD[i]
    eng = m10_row_engine
    t = parse_newick(rec["newick"], eng.data.taxa)
    st = {f: torch.as_tensor(getattr(t, f)[None]).long()
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(t.blen[None], dtype=torch.float32)
    for k, v in rec["state"].items():
        if not k.startswith("_"):
            st[k] = torch.tensor([v], dtype=torch.float32)
    lnL = float(eng.log_likelihood(eng.refresh_eigs(st))[0])
    assert abs(lnL - rec["lnL"]) < rec["tol"], (rec["gen"], lnL, rec["lnL"])
    # the discretization against the reference's printed class omegas
    # (src/model.c:11637-11643)
    ours = eng._m10_omegas_weights(st, eng.div_cfg[0])[0][0].numpy()
    np.testing.assert_allclose(ours, rec["state"]["_ref_omegas"], rtol=0.02,
                               atol=5e-3)


@pytest.mark.parametrize("name", ["m3", "m10"])
def test_moves_and_columns_equal_jax(engines, name):
    eng, jeng = engines[name]

    def spec(m):
        return (m.name, m.weight, m.tuning0, m.target, m.direction, m.tmin,
                m.tmax, m.tunable, m.updates_q, m.prior_scope)

    assert [spec(m) for m in eng.moves] == [spec(m) for m in jeng.moves]
    own = [m for m in eng.moves if m.name.startswith(name)]
    assert len(own) == (2 if name == "m3" else 3)
    assert all(m.updates_q and m.prior_scope == "params" for m in own)
    assert [n for n, _ in param_columns(eng)] == \
        [n for n, _ in j_param_columns(jeng)]


RUNS, GENS = 32, 1200
FIELDS = {"m3": ("m3omega", "m3probs"),
          "m10": ("m10beta", "m10gamma", "m10catprobs")}


def _stat(name, field, x):
    """[R, ...] samples -> the statistics compared ([R, k]): log omega for
    M3's omegas (their order-statistic prior has no finite mean)."""
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
    return np.log(x) if field == "m3omega" else x


def _port_prior_run(eng, name):
    """The M3/M10 parameter moves alone at their starting tunings, each
    proposal accepted by its prior ratio and Hastings term."""
    moves = [m for m in eng.moves if m.name.startswith(name)]
    p = np.array([m.weight for m in moves]) / sum(m.weight for m in moves)
    states, _ = eng.init_chains()
    st = {k: v[:1].expand(RUNS, *v.shape[1:]).clone() for k, v in
          states.items() if k not in SCORE_KEYS and not k.startswith("eig")}
    gen = torch.Generator().manual_seed(11)
    pick = np.random.default_rng(11).choice(len(moves), GENS, p=p)
    lp = eng.log_prior_params(st)
    out = []
    for g in range(GENS):
        m = moves[pick[g]]
        new, lnH = m.fn(gen, st, torch.full((RUNS,), float(m.tuning0)))
        lp_new = eng.log_prior_params(new)
        acc = torch.log(torch.rand(RUNS, generator=gen)) < lp_new - lp + lnH
        st = {k: torch.where(acc.reshape((-1,) + (1,) * (v.ndim - 1)),
                             new[k], v) for k, v in st.items()}
        lp = torch.where(acc, lp_new, lp)
        if g >= GENS // 2:
            out.append({f: st[f].numpy().copy() for f in FIELDS[name]})
    return {f: np.mean([_stat(name, f, o[f]) for o in out], 0)
            for f in FIELDS[name]}


def _jax_prior_run(jeng, name):
    moves = [m for m in jeng.moves if m.name.startswith(name)]
    logits = jnp.log(jnp.asarray([m.weight for m in moves]))
    branches = [lambda k, s, m=m: m.fn(k, s, jnp.float32(m.tuning0))
                for m in moves]
    st0 = {k: v for k, v in jeng.init_state(np.random.default_rng(3)).items()
           if not k.startswith("eig")}

    def step(st, key):
        k1, k2, k3 = jax.random.split(key, 3)
        new, lnH = jax.lax.switch(jax.random.categorical(k1, logits),
                                  branches, k2, st)
        ln_r = (jeng.log_prior_params(new) - jeng.log_prior_params(st)
                + lnH)
        acc = jnp.log(jax.random.uniform(k3)) < ln_r
        st = jax.tree.map(lambda a, b: jnp.where(acc, a, b), new, st)
        return st, {f: st[f] for f in FIELDS[name]}

    def run(key):
        _, trace = jax.lax.scan(step, st0, jax.random.split(key, GENS))
        return trace

    trace = jax.jit(jax.vmap(run))(jax.random.split(jax.random.PRNGKey(11),
                                                     RUNS))
    return {f: np.mean([_stat(name, f, np.asarray(trace[f])[:, g])
                        for g in range(GENS // 2, GENS)], 0)
            for f in FIELDS[name]}


@pytest.mark.parametrize("name", ["m3", "m10"])
def test_prior_only_parameters_match_jax(engines, name):
    eng, jeng = engines[name]
    ours, theirs = _port_prior_run(eng, name), _jax_prior_run(jeng, name)
    for f in FIELDS[name]:
        a, b = ours[f], theirs[f]              # [RUNS, k] run means
        se = np.hypot(a.std(0, ddof=1), b.std(0, ddof=1)) / np.sqrt(RUNS)
        diff = np.abs(a.mean(0) - b.mean(0))
        assert (diff < 4.0 * se).all(), (f, a.mean(0), b.mean(0), se)
