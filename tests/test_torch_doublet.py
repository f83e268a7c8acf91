"""The doublet model and kim.nex in the port against the JAX package.

kim.nex (Kim, Kjer and Duckett 2003: 27 taxa, 1,742 characters mixing
RNA, DNA, protein and morphology) opens its mrbayes block with ``pairs``,
the 110 stem pairs of its 18S RNA.

* ``doublet_q`` within 1e-6 relative of JAX's, with mean rate 1 and zero
  rates where both positions change;
* the ``pairs`` command's pairs, and ``_doublet_tensors`` on kim's stems
  (patterns, weights, constant-state mask), equal JAX's; a character in
  no pair, or no ``pairs`` at all, raises as in JAX;
* the ``kim_stems_doublet_gtr``, ``kim_protein_gtr`` and
  ``kim_hky_g_mixed4`` rows of ``tests/golden_extra.json`` through the
  port's CLI within their ``tol`` of reference MrBayes;
* kim's stem-doublet model at identical states: each of its 9 divisions
  within 5e-3 of the JAX package's function evaluated in float64
  (``jax_exact_lnl``; at S > 8 the JAX engine's float32 eigensystems are
  not the yardstick, ``tests/test_torch_protein.py``), and lnPrior within
  1e-4 of the JAX engine's;
* kim's default linkage (restating ``tests/test_golden_extra.py::
  test_kim_default_linkage``): every division's link groups equal JAX's."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.models import substitution as JQ
from mrbayes_tpu.ops import pruning as JP
from mrbayes_tpu.ops import tiprobs as JTP
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.models import substitution as TQ
from mrbayes_tpu_torch.trees import parse_newick, random_unrooted
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS = ("kim_stems_doublet_gtr", "kim_protein_gtr", "kim_hky_g_mixed4")
GOLD = [r for r in json.load(open(os.path.join(HERE, "golden_extra.json")))
        if r["name"] in ROWS]
C = 2


def _commands(name):
    rec = next(r for r in GOLD if r["name"] == name)
    # the reference's example, vendored under tests/data
    return [f"execute {example(os.path.basename(c.split()[1]))}"
            if c.startswith("execute ") else c for c in rec["commands"]]


def _interpreters(name):
    it = Interpreter(log=lambda m: None, device="cpu")
    jit = JInterpreter(log=lambda m: None)
    for ln in _commands(name) + [f"mcmcp nruns=1 nchains={C} seed=3"]:
        it.run_line(ln)
        jit.run_line(ln)
    return it, jit


@pytest.fixture(scope="module")
def stems():
    it, jit = _interpreters("kim_stems_doublet_gtr")
    return it, jit, it.build_engine(), jit.build_engine()


def test_doublet_q_matches_jax():
    rng = np.random.default_rng(0)
    r6 = rng.dirichlet(np.ones(6) * 2, size=4).astype(np.float32)
    pi = rng.dirichlet(np.ones(16) * 3, size=4).astype(np.float32)
    a = np.asarray(jax.vmap(JQ.doublet_q)(r6, pi))
    b = TQ.doublet_q(torch.as_tensor(r6), torch.as_tensor(pi),
                    torch.as_tensor(TQ.DOUBLET_CLS)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(TQ.DOUBLET_CLS, JQ._DOUBLET_CLS)
    # mean rate 1, rows sum to 0, no change at both positions at once
    np.testing.assert_allclose(-(np.diagonal(b, 0, 1, 2) * pi).sum(-1), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(b.sum(-1), 0.0, atol=1e-5)
    assert (b[:, (TQ.DOUBLET_CLS == 6) & ~np.eye(16, dtype=bool)] == 0).all()


def test_pairs_parse_as_jax(stems):
    it, jit, _, _ = stems
    assert len(it.env.pairs) == 110
    assert it.env.pairs == jit.env.pairs
    assert it.env.pairs[0] == (21, 496)
    it2 = Interpreter(log=lambda m: None, device="cpu")
    it2.run_line("pairs 1:20, 2 : 19,3:18")
    assert it2.env.pairs == ((0, 19), (1, 18), (2, 17))


def test_doublet_tensors_equal_jax(stems):
    _, _, eng, jeng = stems
    cfg = eng.div_cfg[0]
    assert cfg.doublet and jeng.div_cfg[0].doublet
    tp, w, cm = eng._doublet_tensors(cfg)
    jtp, jw, jcm = jeng._doublet_tensors(jeng.div_cfg[0])
    assert tp.shape == (27, 78, 16)
    np.testing.assert_array_equal(tp, np.asarray(jtp))
    np.testing.assert_array_equal(w, np.asarray(jw))
    np.testing.assert_array_equal(cm, np.asarray(jcm))
    assert float(w.sum()) == 110
    np.testing.assert_array_equal(eng.tip_partials[0].numpy(),
                                  np.asarray(jeng.tip_partials[0]))
    lone = type(cfg.settings)(**{**cfg.settings.__dict__,
                                 "pairs": cfg.settings.pairs[1:]})
    with pytest.raises(ValueError, match="exactly one pair"):
        eng._doublet_tensors(type(cfg)(**{**cfg.__dict__,
                                          "settings": lone}))


def test_doublet_without_pairs_raises_as_jax():
    for interp in (Interpreter(log=lambda m: None, device="cpu"),
                   JInterpreter(log=lambda m: None)):
        for ln in (f"execute {example('primates.nex')}",
                   "lset nucmodel=doublet"):
            interp.run_line(ln)
        with pytest.raises(ValueError, match="requires a pairs statement"):
            interp.build_engine()


@pytest.fixture(scope="module")
def row_engines():
    out = {}
    for name in ROWS:
        it = Interpreter(log=lambda m: None, device="cpu")
        for ln in _commands(name):
            it.run_line(ln)
        out[name] = it.build_engine()
    return out


@pytest.mark.parametrize("i", range(len(GOLD)),
                         ids=[f"{r['name']}@{r['gen']}" for r in GOLD])
def test_golden_kim_row(row_engines, i):
    rec = GOLD[i]
    eng = row_engines[rec["name"]]
    t = parse_newick(rec["newick"], eng.data.taxa)
    st = {f: torch.as_tensor(getattr(t, f)[None]).long()
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(t.blen[None], dtype=torch.float32)
    for k, v in rec["state"].items():
        st[k] = torch.tensor([v], dtype=torch.float32)
    lnL = float(eng.log_likelihood(eng.refresh_eigs(st))[0])
    assert abs(lnL - rec["lnL"]) < rec["tol"], (rec["gen"], lnL, rec["lnL"])


def _random_state(eng, rng):
    """Random trees and substitution parameters for every chain."""
    trees = [random_unrooted(eng.n_tips, rng, mean_blen=0.05)
             for _ in range(C)]
    st = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int32)
          for f in ("left", "right", "parent")}
    st["blen"] = np.stack([t.blen for t in trees]).astype(np.float32)
    for field, k in (("revmat", 6), ("pi16", 16), ("pi", 4), ("pi20", 20)):
        if eng.n_groups.get(field):
            st[field] = rng.dirichlet(np.ones(k) * 4,
                                      (C, eng.n_groups[field]))
    return {k: np.asarray(v, np.int32 if v.dtype.kind == "i"
                          else np.float32) for k, v in st.items()}


def jax_exact_lnl(jeng, jst, i):
    """Division i's lnL [C] by the JAX package's own ops in float64
    (``jax.enable_x64``), with a float64 ``eigh_reversible`` of JAX's Q:
    the function the JAX engine computes in float32, evaluated
    exactly."""
    def f64(x):
        return jnp.asarray(x, jnp.float64)

    def one(s1):
        pi, coding, _, _, _, rates, _, _, mult = \
            jeng._generic_div_params(s1, i)
        Q, pi_q = jeng._division_q_pi(s1, i)
        lam, U, Uinv = JTP.eigh_reversible(f64(Q), f64(pi_q))
        return JP.division_loglik(
            s1["left"], s1["right"], s1["parent"], f64(s1["blen"]),
            f64(jeng.tip_partials[i]), f64(jeng.weights[i]), lam, U, Uinv,
            f64(pi), f64(rates), 0.0, None, jeng.n_tips, rate_mult=mult,
            coding=coding)

    with jax.enable_x64(True):
        return np.asarray(jax.jit(jax.vmap(one))(jst))


def test_stems_match_jax_at_identical_states(stems):
    """Each division within 5e-3 of JAX's function in float64, through
    the port's own eigensystems (float64 at S 16 and 20, the float32
    Jacobi at S <= 8); lnPrior within 1e-4 of the JAX engine's."""
    _, _, eng, jeng = stems
    st = _random_state(eng, np.random.default_rng(4))
    own = eng.refresh_eigs(state_from_numpy(st, "cpu"))
    per_div = eng.division_lnls(own).numpy()
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    assert eng.n_div == jeng.n_div == 9
    for i in range(eng.n_div):
        np.testing.assert_allclose(per_div[:, i], jax_exact_lnl(jeng, jst, i),
                                   atol=5e-3, rtol=0, err_msg=f"division {i}")
    j_prior = jax.jit(jax.vmap(jeng.log_prior))
    np.testing.assert_allclose(eng.log_prior(own).numpy(),
                               np.asarray(j_prior(jst)), atol=1e-4, rtol=0)
    assert [(m.name, m.weight) for m in eng.moves] == \
        [(m.name, m.weight) for m in jeng.moves]


def test_kim_default_linkage():
    """The reference links parameters only within compatible datatypes
    (IsModelSame, src/model.c:13827): kim's two nucleotide divisions
    share kappa, pi and shape; protein and standard get their own shape
    groups, and the standard buckets of one user division share one.
    Every division's groups equal the JAX engine's."""
    it = Interpreter(log=lambda m: None, device="cpu")
    jit = JInterpreter(log=lambda m: None)
    for ln in _commands("kim_hky_g_mixed4"):
        it.run_line(ln)
        jit.run_line(ln)
    eng, jeng = it.build_engine(), jit.build_engine()
    fields = ("pi_field", "pi_group", "revmat_group", "tratio_group",
              "shape_group", "pinvar_group", "n_cats")
    assert [[getattr(c, f) for f in fields] for c in eng.div_cfg] == \
        [[getattr(c, f) for f in fields] for c in jeng.div_cfg]
    assert eng.n_groups == {k: v for k, v in jeng.n_groups.items() if v}
    nuc = [c for c in eng.div_cfg if c.div.dtype.value in ("dna", "rna")]
    assert len({c.tratio_group for c in nuc}) == 1
    assert len({c.pi_group for c in nuc}) == 1
    prot = [c for c in eng.div_cfg if c.div.dtype.value == "protein"]
    stdd = [c for c in eng.div_cfg if c.div.dtype.value == "standard"]
    assert prot[0].shape_group != nuc[0].shape_group
    assert stdd[0].shape_group not in (nuc[0].shape_group,
                                       prot[0].shape_group)
    assert len({c.shape_group for c in stdd}) == 1
