"""The port's Tuffley-Steel covarion model against the JAX package, on
primates.nex (12 taxa, 413 patterns; S 4 doubled to 8) and a 10-taxon
slice of avian_ovomucoids.nex (S 20 doubled to 40).

* ``covarion_q`` (S 4 and 20, per rate category) within 1e-6 of JAX's
  (float32 arithmetic of the same formula), and ``expm_pade`` within
  1e-6 of JAX's in float64 and 1e-9 of scipy's ``expm``;
* the covarion pass (``covarion_q``, ``eigh_reversible`` on the
  per-category generators, ``division_loglik`` with unit category rates
  and the doubled frequencies at the root) against a float64 oracle of
  per-category matrix exponentials (restating
  ``tests/test_likelihood.py::test_covarion_vs_oracle``, its tolerance);
* the engine at identical states (the JAX state carried over by
  ``convert.state_from_numpy``), primates under HKY+G with covarion (K
  4): lnL within 5e-2 of the JAX engine's (two float32 Jacobi solves of
  the 8 x 8 generators), lnPrior within 1e-4;
* protein covarion (S 40, jones+G) on the avian slice: the port's lnL,
  its eigensystems in float64, within 5e-3 of the JAX package's
  ``_covarion_loglik`` evaluated in float64 (``jax.enable_x64``);
* the engine end to end with ``covswitch_mult`` moving the switch rates,
  and the lnL carried after a shape, a switch-rate and a kappa move equal
  to a recompute from fresh eigensystems (the covarion eigensystem
  depends on the gamma shape and the switch rates: a cache left stale by
  either would show here);
* the three ``primates_covarion_hky`` rows of ``tests/golden_extra.json``
  through the port's CLI within their ``tol`` (1.0);
* the ``s(off->on)``/``s(on->off)`` columns: the ``.p`` header equals the
  JAX package's ``param_columns`` and the written values are the chains'
  switch rates;
* covarion divisions never join a multiwalk or stacked group, as in JAX;
* covarion with propinv/invgamma raises as the JAX package does."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.models import substitution as JQ
from mrbayes_tpu.ops import tiprobs as JTP
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.models import substitution as TQ
from mrbayes_tpu_torch.ops import pruning as TP
from mrbayes_tpu_torch.ops import tiprobs as TTP
from mrbayes_tpu_torch.trees import parse_newick, random_unrooted
from conftest import example
import reference_impl as ref

# the tensors here are small: intra-op threads would only contend with
# the other test workers
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = [r for r in json.load(open(os.path.join(HERE, "golden_extra.json")))
        if r["name"] == "primates_covarion_hky"]
C = 4
HKY_G_COV = "lset nst=2 rates=gamma covarion=yes"


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _interpreters(path, lines, nchains=C):
    it = Interpreter(log=lambda m: None, device="cpu")
    jit = JInterpreter(log=lambda m: None)
    for ln in [f"execute {path}", *lines,
               f"mcmcp nruns=1 nchains={nchains} seed=3"]:
        it.run_line(ln)
        jit.run_line(ln)
    return it, jit


@pytest.mark.parametrize("S", [4, 20])
def test_covarion_q_matches_jax(S):
    rng = np.random.default_rng(S)
    pi = rng.dirichlet(np.ones(S) * 3).astype(np.float32)
    ex = rng.uniform(0.2, 3.0, S * (S - 1) // 2).astype(np.float32)
    rates = np.array([0.1, 0.6, 1.2, 2.1], np.float32)
    s01, s10 = np.float32(1.8), np.float32(0.6)
    q = JQ.reversible_q(jnp.asarray(ex), jnp.asarray(pi))
    a_q, a_pi = jax.vmap(lambda r: JQ.covarion_q(q, jnp.asarray(pi), s01,
                                                 s10, r))(jnp.asarray(rates))
    b_q, b_pi = TQ.covarion_q(TQ.reversible_q(_t(ex), _t(pi)), _t(pi),
                              torch.tensor(s01), torch.tensor(s10),
                              _t(rates))
    np.testing.assert_allclose(b_q.numpy(), np.asarray(a_q), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(b_pi.numpy(), np.asarray(a_pi)[0], atol=1e-6,
                               rtol=0)
    # rows sum to 0 and the process is reversible under pi_cov
    np.testing.assert_allclose(b_q.sum(-1).numpy(), 0.0, atol=1e-5)
    flux = b_pi[:, None] * b_q
    np.testing.assert_allclose(flux.numpy(), flux.transpose(-1, -2).numpy(),
                               atol=1e-6)


def test_expm_pade_matches_jax():
    rng = np.random.default_rng(3)
    pi = rng.dirichlet(np.ones(4) * 3).astype(np.float32)
    ex = rng.uniform(0.2, 3.0, 6).astype(np.float32)
    qc, _ = JQ.covarion_q(JQ.reversible_q(jnp.asarray(ex), jnp.asarray(pi)),
                          jnp.asarray(pi), 1.5, 0.7)
    A = np.stack([np.asarray(qc, np.float64) * t
                  for t in (0.01, 0.1, 0.5, 1.0)])
    # in float64 on both sides: in float32 the eight squarings of two
    # different product orders drift apart by a few 1e-6
    got = TTP.expm_pade(_t(A)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(JTP.expm_pade(jnp.asarray(A)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, np.stack([expm(a) for a in A]),
                               atol=1e-9, rtol=0)


def test_covarion_vs_oracle():
    """The restated float64 oracle of tests/test_likelihood.py: per-
    category 8 x 8 expm pruning, the gamma rate on the substitution block
    only."""
    rng = np.random.default_rng(42)
    n_tips, npat, K = 7, 30, 4
    patterns = rng.integers(1, 15, size=(n_tips, npat)).astype(np.uint32)
    weights = rng.integers(1, 5, size=npat).astype(np.float64)
    tp4 = ((patterns[..., None] >> np.arange(4)) & 1).astype(np.float64)
    t = random_unrooted(n_tips, rng)
    pi = np.array([0.35, 0.15, 0.2, 0.3])
    ex = np.array([1.0, 3.5, 0.8, 1.1, 4.2, 1.0])
    alpha, s01, s10 = 0.7, 1.8, 0.6
    rates = ref.discrete_gamma_rates(alpha, K)
    Q4 = ref.gtr_q(ex, pi)
    prob_on = s01 / (s01 + s10)
    pic = np.r_[pi * prob_on, pi * (1 - prob_on)]
    tp8 = np.concatenate([tp4, tp4], axis=-1)
    P = np.zeros((t.n_nodes, K, 8, 8))
    for c in range(K):
        off = (rates[c] / prob_on) * Q4 * (1 - np.eye(4))
        top = np.hstack([off - np.diag(off.sum(1) + s10), np.eye(4) * s10])
        bot = np.hstack([np.eye(4) * s01, -np.eye(4) * s01])
        Qc = np.vstack([top, bot])
        for v in range(t.n_nodes):
            P[v, c] = expm(Qc * t.blen[v])
    cl = np.zeros((t.n_nodes, npat, K, 8))
    cl[:n_tips] = tp8[:, :, None, :]
    for v in t.postorder():
        lc, rc = t.left[v], t.right[v]
        cl[v] = (np.einsum("ksj,pkj->pks", P[lc], cl[lc])
                 * np.einsum("ksj,pkj->pks", P[rc], cl[rc]))
    site = np.einsum("pks,s->p", cl[t.root], pic) / K
    want = float((weights * np.log(site)).sum())

    f32 = torch.float32
    Qc, pc = TQ.covarion_q(torch.tensor(Q4, dtype=f32)[None, None],
                           torch.tensor(pi, dtype=f32)[None, None],
                           torch.tensor([[s01]]), torch.tensor([[s10]]),
                           torch.tensor(rates, dtype=f32)[None])
    lam, U, Uinv = TTP.eigh_reversible(Qc, pc)
    got = TP.division_loglik(
        _t(t.left[None]).long(), _t(t.right[None]).long(),
        _t(t.parent[None]).long(), torch.tensor(t.blen[None], dtype=f32),
        torch.tensor(tp8, dtype=f32), torch.tensor(weights, dtype=f32),
        lam, U, Uinv, pc[:, 0], torch.ones((1, K)), 0.0, None, n_tips)
    assert abs(float(got[0]) - want) < 0.02 + 2e-5 * abs(want)


def _random_states(n_tips, rng, C=C):
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    st = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int32)
          for f in ("left", "right", "parent")}
    st["blen"] = np.stack([t.blen for t in trees]).astype(np.float32)
    st["shape"] = rng.uniform(0.3, 2.0, (C, 1)).astype(np.float32)
    st["covswitch"] = rng.uniform(0.2, 5.0, (C, 1, 2)).astype(np.float32)
    return st


@pytest.fixture(scope="module")
def primates_pair():
    it, jit = _interpreters(example("primates.nex"), [HKY_G_COV])
    return it.build_engine(), jit.build_engine()


def test_engine_matches_jax_at_identical_states(primates_pair):
    eng, jeng = primates_pair
    rng = np.random.default_rng(5)
    st = _random_states(eng.n_tips, rng)
    st["tratio"] = rng.uniform(0.5, 8.0, (C, 1)).astype(np.float32)
    st["pi"] = rng.dirichlet(np.ones(4) * 5, (C, 1)).astype(np.float32)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    want = np.asarray(jax.jit(jax.vmap(jeng.log_likelihood))(jst))
    lnP = np.asarray(jax.vmap(jeng.log_prior)(jst))
    # the JAX state carried over; its covarion division has no cached
    # eigensystem there, the port builds its own
    tst = eng.refresh_eigs(state_from_numpy(
        {k: np.asarray(v) for k, v in jst.items()}, "cpu"))
    assert tst["eigL0"].shape == (C, 4, 8)
    np.testing.assert_allclose(eng.log_likelihood(tst).numpy(), want,
                               atol=5e-2, rtol=0)
    np.testing.assert_allclose(eng.log_prior(tst).numpy(), lnP, atol=1e-4,
                               rtol=0)
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    assert eng._pruners[0].S == 8 and eng._pruners[0].K == 4


def _avian_slice(tmp_path, ntax=10):
    """avian_ovomucoids.nex cut to its first ``ntax`` taxa."""
    lines = open(example("avian_ovomucoids.nex")).read().splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.strip().lower() == "matrix")
    rows = [ln for ln in lines[start + 1:]
            if ln.strip() and not ln.strip().startswith("[")][:ntax]
    text = ("#NEXUS\nbegin data;\n"
            f"    dimensions ntax={ntax} nchar=88;\n"
            "    format datatype=protein missing=? gap=- matchchar=.;\n"
            "    matrix\n" + "\n".join(rows) + "\n    ;\nend;\n")
    path = tmp_path / "avian10.nex"
    path.write_text(text)
    return str(path)


def jax_exact_covarion_lnl(jeng, jst):
    """The JAX package's covarion lnL [C] (``_covarion_loglik``) with its
    eigensystems and sums in float64 (``jax.enable_x64``)."""
    cfg = jeng.div_cfg[0]

    def one(s1):
        s1 = {k: (v.astype(jnp.float64) if v.dtype == jnp.float32 else v)
              for k, v in s1.items()}
        return jeng._covarion_loglik(s1, 0, cfg, s1["blen"])

    with jax.enable_x64(True):
        jst64 = {k: jnp.asarray(np.asarray(v)) for k, v in jst.items()}
        return np.asarray(jax.jit(jax.vmap(one))(jst64))


def test_protein_covarion_matches_jax_in_float64(tmp_path):
    path = _avian_slice(tmp_path)
    it, jit = _interpreters(path, ["lset rates=gamma covarion=yes",
                                   "prset aamodelpr=fixed(jones)"])
    eng, jeng = it.build_engine(), jit.build_engine()
    rng = np.random.default_rng(9)
    st = _random_states(eng.n_tips, rng)
    tst = {k: torch.as_tensor(v).long() if v.dtype == np.int32
           else torch.as_tensor(v) for k, v in st.items()}
    tst = eng.refresh_eigs(tst)
    assert tst["eigL0"].shape == (C, 4, 40)
    assert tst["eigU0"].dtype == torch.float64
    assert 0 not in eng._const_eigs
    got = eng.log_likelihood(tst).numpy()
    want = jax_exact_covarion_lnl(jeng, st)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]


def _fresh(eng, states):
    """Scores recomputed from scratch: every cached eigensystem dropped and
    rebuilt from the state's parameters."""
    st = {k: v for k, v in states.items()
          if k not in SCORE_KEYS and not k.startswith("eig")}
    return eng.score(eng.refresh_eigs(st))


def test_engine_end_to_end_and_no_stale_eigensystem(primates_pair):
    eng, _ = primates_pair
    states, bk = eng.init_chains()
    assert "covswitch" in states and "eigL0" in states
    assert np.all(np.isfinite(states["lnL"].numpy()))
    names = [m.name for m in eng.moves]
    moved = {}
    gen = torch.Generator().manual_seed(11)
    heats = torch.ones(C)
    for name in ("shape_mult", "covswitch_mult", "tratio_mult"):
        m = names.index(name)
        assert eng.moves[m].updates_q
        field = {"shape_mult": "shape", "covswitch_mult": "covswitch",
                 "tratio_mult": "tratio"}[name]
        # a tiny uniform accepts every proposal with a finite ratio
        new, acc = eng._chain_step(gen, states, heats,
                                   torch.full((C,), 1.0), 1.0, m,
                                   torch.full((C,), 1e-30))
        assert acc.all()
        moved[name] = not torch.equal(new[field], states[field])
        fresh = _fresh(eng, new)
        np.testing.assert_allclose(new["lnL"].numpy(), fresh["lnL"].numpy(),
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(new["lnP"].numpy(), fresh["lnP"].numpy(),
                                   atol=1e-4, rtol=0)
        states = new
    assert all(moved.values()), moved
    # only the covarion division's eigensystem, only under its own moves
    shape = eng.moves[names.index("shape_mult")]
    assert shape.eig_divs == (0,)
    before = states["covswitch"].clone()
    states, bk = eng.run_block(states, bk, 60)
    assert not torch.equal(states["covswitch"], before)
    assert np.all(np.isfinite(states["lnL"].numpy()))
    fresh = _fresh(eng, states)
    np.testing.assert_allclose(states["lnL"].numpy(), fresh["lnL"].numpy(),
                               atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def golden_interpreter():
    it = Interpreter(log=lambda m: None, device="cpu")
    for c in GOLD[0]["commands"]:
        if c.startswith("execute "):
            # the reference's example, vendored under tests/data
            c = "execute " + example(os.path.basename(c.split()[1]))
        it.run_line(c)
    return it


@pytest.mark.parametrize("i", range(len(GOLD)),
                         ids=[f"gen{r['gen']}" for r in GOLD])
def test_golden_primates_covarion_row(golden_interpreter, i):
    rec = GOLD[i]
    eng = golden_interpreter.build_engine()
    t = parse_newick(rec["newick"], eng.data.taxa)
    st = {f: torch.as_tensor(getattr(t, f)[None]).long()
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(t.blen[None], dtype=torch.float32)
    for k, v in rec["state"].items():
        st[k] = torch.tensor([v], dtype=torch.float32)
    lnL = float(eng.log_likelihood(eng.refresh_eigs(st))[0])
    assert abs(lnL - rec["lnL"]) < rec["tol"], (rec["gen"], lnL, rec["lnL"])


def test_switch_rate_columns(tmp_path):
    it, jit = _interpreters(example("primates.nex"), [HKY_G_COV], nchains=2)
    names = [n for n, _ in param_columns(it.build_engine())]
    assert names == [n for n, _ in j_param_columns(jit.build_engine())]
    assert names[-2:] == ["s(off->on)", "s(on->off)"]
    prefix = str(tmp_path / "cov")
    it.run_line(f"mcmc ngen=20 samplefreq=10 printfreq=100 diagnfreq=100 "
                f"file={prefix}")
    with open(prefix + ".run1.p") as f:
        f.readline()
        header = f.readline().rstrip("\n").split("\t")
        rows = [[float(x) for x in ln.split("\t")] for ln in f]
    assert header[3:] == names and len(rows) == 3
    runner = it._last_runner
    cold = runner.eng.cold_indices(runner.final_bk)[0]
    last = runner.final_states["covswitch"][cold, 0].numpy()
    np.testing.assert_allclose(rows[-1][-2:], last, rtol=1e-6)
    assert rows[0][-2:] == [1.0, 1.0]


def test_covarion_divisions_never_group():
    """Two primates partitions, covarion on the first: with every group
    switch on, no multiwalk or stacked group takes the covarion division
    (the JAX engine's rule, mrbayes_tpu/mcmc/engine.py:1068, :2484)."""
    it = Interpreter(log=lambda m: None, device="cpu", multiwalk=True,
                     stacked=True)
    for ln in [f"execute {example('primates.nex')}",
               "partition p = 3: 1-300, 301-600, 601-.", "set partition=p",
               "lset applyto=(1) covarion=yes",
               "mcmcp nruns=1 nchains=2 seed=3"]:
        it.run_line(ln)
    eng = it.build_engine()
    assert [c.covarion for c in eng.div_cfg] == [True, False, False]
    grouped = [i for g, _ in eng._multiwalk_pruners + eng._stacked_pruners
               for i in g]
    assert 0 not in grouped and sorted(set(grouped)) == [1, 2]
    states, _ = eng.init_chains()
    assert np.all(np.isfinite(states["lnL"].numpy()))
    fresh = _fresh(eng, states)
    np.testing.assert_allclose(states["lnL"].numpy(), fresh["lnL"].numpy(),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("rates", ["propinv", "invgamma"])
def test_covarion_with_pinvar_raises_as_jax(rates):
    it, jit = _interpreters(example("primates.nex"),
                            [f"lset rates={rates} covarion=yes"])
    with pytest.raises(ValueError, match="covarion cannot combine") as a:
        jit.build_engine()
    with pytest.raises(ValueError, match="covarion cannot combine") as b:
        it.build_engine()
    assert str(a.value) == str(b.value)
