"""Standard (morphology) data under the plain Mk model in the port, held
against the JAX package on cynmix.nex (32 taxa, 166 standard characters
split into buckets of 2, 3, 4 and 8 states, and four genes).

* ``mk_q`` equals JAX's; the fixed-sweep Jacobi converges on Mk at S = 2,
  3, 4, 8 (one eigenvalue repeated S - 1 times) against float64
  ``torch.linalg.eigh``; the engine's standard eigensystem (built once, in
  float64) gives the exact P(t) and JAX's within 1e-6;
* the ``cynmix_mkv_f81`` golden rows (Mkv plus F81): lnL within 0.25 of
  reference MrBayes (tests/test_golden.py's limit), and within 5e-3 of the
  JAX ``Engine`` with its eigensystems carried over;
* the favored model of the MrBayes manual's partitioned tutorial
  (tests/test_examples.py's cynmix lines) at identical states, 2 runs x
  2 chains: lnL within 5e-3 with the JAX eigensystems carried over
  (float32 sums of about 3.6e4 over 8 divisions taken in another order),
  and lnPrior within 1e-4;
* the coding correction (``coding=variable``, S dummy patterns) is the
  same through a pruner as through the plain pass;
* each division's wavefront eligibility equals JAX's;
* the ``.p`` header equals JAX ``param_columns`` but for the ``pinvar``
  names (ROADMAP Queue 3);
* ordered characters and symdirihyperpr still raise, naming their items;
* a short CPU run of the cynmix lines through the CLI writes complete
  files.
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
from mrbayes_tpu.mcmc.engine import Engine as JEngine
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.mcmc.settings import DivisionSettings as JDiv
from mrbayes_tpu.mcmc.settings import McmcSettings as JMcmc
from mrbayes_tpu.models.substitution import mk_q as j_mk_q
from mrbayes_tpu.nexus.datatypes import DataType as JDataType
from mrbayes_tpu.nexus.parser import read_nexus_file as j_read
from mrbayes_tpu.ops.pruning_pallas import PruningPallasWavefront
from mrbayes_tpu.ops.tiprobs import eigh_reversible as j_eigh
from mrbayes_tpu.ops.tiprobs import transition_probs as j_tiprobs
from mrbayes_tpu.trees import parse_newick as j_parse_newick
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy, state_to_numpy
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.envelope import CYNMIX_MODEL
from mrbayes_tpu_torch.mcmc.engine import Engine
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings, McmcSettings,
                                             Prior)
from mrbayes_tpu_torch.models.substitution import mk_q
from mrbayes_tpu_torch.nexus.datatypes import DataType
from mrbayes_tpu_torch.nexus.parser import read_nexus_file
from mrbayes_tpu_torch.ops.jacobi import jacobi_eigh
from mrbayes_tpu_torch.ops.pruning import coding_tips, division_loglik
from mrbayes_tpu_torch.ops.tiprobs import transition_probs
from mrbayes_tpu_torch.ops.wavefront_cuda import PruningCudaWavefront
from mrbayes_tpu_torch.trees import parse_newick
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
GOLD = [r for r in json.load(open(os.path.join(HERE,
                                               "golden_primates.json")))
        if r["model"] == "cynmix_mkv_f81"]
R, NC = 2, 2
C = R * NC


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_mk_q_and_its_eigensystem(S):
    Q = mk_q(S)
    np.testing.assert_allclose(Q.numpy(), np.asarray(j_mk_q(S)), atol=1e-6)
    # the fixed-sweep Jacobi converges on Mk's repeated eigenvalue: in
    # float64 against torch.linalg.eigh, and in float32 to 1e-6
    w, V = jacobi_eigh(Q.double())
    w64, V64 = torch.linalg.eigh(Q.double())
    np.testing.assert_allclose(np.sort(w.numpy()), w64.numpy(), atol=1e-10)
    np.testing.assert_allclose((V * w) @ V.T, Q.double().numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(np.sort(jacobi_eigh(Q)[0].numpy()),
                               w64.numpy(), atol=1e-6)
    # the engine's eigensystem of a standard bucket (built once, in
    # float64) gives P(t) within 1e-6 of the exact one and of JAX's
    eng = _golden_engine(0)
    i = next(i for i, c in enumerate(eng.div_cfg) if c.div.n_states == S)
    lam, U, Uinv = eng._const_eigs[i]
    t = torch.tensor([0.0, 0.01, 0.1, 1.0, 5.0])
    P = transition_probs(lam, U, Uinv, t[:, None])[:, 0]
    exact = torch.stack([torch.matrix_exp(Q.double() * x)
                         for x in t.double()])
    np.testing.assert_allclose(P.double().numpy(), exact.numpy(), atol=1e-6)
    jl, jU, jV = j_eigh(j_mk_q(S), jnp.full((S,), 1.0 / S))
    np.testing.assert_allclose(
        P.numpy(), np.asarray(j_tiprobs(jl, jU, jV, jnp.asarray(t.numpy()))),
        atol=1e-6)


def _golden_engine(row):
    """The port's engine of a cynmix_mkv_f81 golden row: Mkv on every
    standard bucket plus F81 on the genes (tests/test_golden.py)."""
    nf = read_nexus_file(example(GOLD[row]["dataset"]))
    ds = DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                 divisions=make_divisions(nf.matrix))
    return Engine(ds, [DivisionSettings(coding="variable", rates="equal")
                       if d.dtype is DataType.STANDARD
                       else DivisionSettings(nst="1", rates="equal")
                       for d in ds.divisions],
                  mcmc=McmcSettings(nruns=1, nchains=1), device="cpu")


def _golden_states(taxa, rec):
    t = parse_newick(rec["newick"], taxa)
    st = {f: torch.as_tensor(np.asarray(getattr(t, f))[None]).long()
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(np.asarray(t.blen, np.float32)[None])
    st["pi"] = torch.tensor([[rec["pi"]]], dtype=torch.float32)
    return st


@pytest.mark.parametrize("row", range(len(GOLD)))
def test_golden_cynmix_rows(row):
    """Mkv on every standard bucket plus F81 on the genes
    (tests/test_golden.py:_golden_other), at the reference's sampled
    states."""
    rec = GOLD[row]
    eng = _golden_engine(row)
    st = _golden_states(eng.data.taxa, rec)
    lnl = float(eng.log_likelihood(eng.refresh_eigs(st))[0])
    assert abs(lnl - rec["lnL"]) < 0.25, (lnl, rec["lnL"])
    jnf = j_read(example(rec["dataset"]))
    jds = JDataSet(taxa=jnf.taxa, nchar=jnf.matrix.nchar,
                   divisions=j_make_divisions(jnf.matrix))
    jeng = JEngine(jds, [JDiv(coding="variable", rates="equal")
                         if d.dtype is JDataType.STANDARD
                         else JDiv(nst="1", rates="equal")
                         for d in jds.divisions],
                   mcmc=JMcmc(nruns=1, nchains=1))
    jt = j_parse_newick(rec["newick"], jnf.taxa)
    jst = {f: jnp.asarray(getattr(jt, f)) for f in ("left", "right",
                                                    "parent")}
    jst["blen"] = jnp.asarray(jt.blen, jnp.float32)
    jst["pi"] = jnp.asarray([rec["pi"]])
    jst = jeng.refresh_eigs(jst)
    # at identical eigensystems (JAX's, carried over) the two engines
    # agree to float32 summation order; each with its own they differ by
    # up to about 0.04 here (ROADMAP Queue 3)
    carried = {**st, **{k: torch.tensor(np.asarray(v))[None]
                        for k, v in jst.items() if k.startswith("eig")}}
    assert abs(float(eng.log_likelihood(carried)[0])
               - float(jeng.log_likelihood(jst))) < 5e-3


def _cynmix_commands(nruns=R, nchains=NC):
    return [f"execute {example('cynmix.nex')}", *CYNMIX_MODEL,
            f"mcmcp nruns={nruns} nchains={nchains} seed=5"]


@pytest.fixture(scope="module")
def jax_side():
    """JAX engine of the favored model, identical random states and their
    JAX scores."""
    it = JInterpreter(log=lambda m: None)
    for c in _cynmix_commands():
        it.run_line(c)
    eng = it.build_engine()
    rng = np.random.default_rng(5)
    per = [eng.init_state(rng) for _ in range(C)]
    st = {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]}
    g = eng.n_groups
    st["pi"] = rng.dirichlet(np.ones(4) * 5, size=(C, g["pi"])).astype(
        np.float32)
    st["revmat"] = rng.dirichlet(np.ones(6) * 2, size=(C, g["revmat"])
                                 ).astype(np.float32)
    st["shape"] = rng.uniform(0.2, 2.0, (C, g["shape"])).astype(np.float32)
    st["pinvar"] = rng.uniform(0.05, 0.5, (C, g["pinvar"])).astype(
        np.float32)
    st["ratemult"] = rng.dirichlet(np.ones(eng.n_div) * 5, size=C).astype(
        np.float32)

    @jax.jit
    def scores(s):
        s = jax.vmap(eng.refresh_eigs)(s)
        return (s, jax.vmap(eng.log_likelihood)(s),
                jax.vmap(eng.log_prior)(s))

    jst, lnL, lnP = scores({k: jnp.asarray(v) for k, v in st.items()})
    return ({k: np.asarray(v) for k, v in jst.items()}, np.asarray(lnL),
            np.asarray(lnP), eng)


@pytest.fixture(scope="module")
def port_interp():
    it = Interpreter(log=lambda m: None, device="cpu")
    for c in _cynmix_commands():
        it.run_line(c)
    return it


@pytest.fixture(scope="module")
def port_engine(port_interp):
    return port_interp.build_engine()


def test_engines_agree_on_structure(jax_side, port_engine):
    jeng, eng = jax_side[3], port_engine
    assert [(c.div.name, c.div.n_states, c.div.npat) for c in eng.div_cfg] \
        == [(c.div.name, c.div.n_states, c.div.npat) for c in jeng.div_cfg]
    assert [c.div.n_states for c in eng.div_cfg] == [2, 3, 4, 8, 4, 4, 4, 4]
    assert [c.coding for c in eng.div_cfg] == ["variable"] * 4 + ["all"] * 4
    assert [c.settings.coding for c in jeng.div_cfg] == \
        ["variable"] * 4 + ["all"] * 4
    assert eng.n_groups == jeng.n_groups == {"shape": 5, "pi": 4,
                                             "revmat": 4, "pinvar": 4}
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    for i in range(eng.n_div):
        np.testing.assert_array_equal(eng.weights[i].numpy(),
                                      np.asarray(jeng.weights[i]))
    np.testing.assert_allclose(eng.div_char_frac, jeng.div_char_frac)


def test_scores_match_jax_at_identical_states(jax_side, port_engine):
    jst, lnL, lnP, _ = jax_side
    st = state_from_numpy(jst, "cpu")
    np.testing.assert_allclose(port_engine.log_likelihood(st).numpy(), lnL,
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(port_engine.log_prior(st).numpy(), lnP,
                               atol=1e-4, rtol=0)
    # the port's own eigensystems: the four genes' refreshed, the four
    # standard buckets' computed once when the engine was built
    own = port_engine.refresh_eigs({k: v for k, v in st.items()
                                    if not k.startswith("eig")})
    assert "eigL0" not in own and "eigL4" in own
    np.testing.assert_allclose(port_engine.log_likelihood(own).numpy(), lnL,
                               atol=5e-2, rtol=0)
    back = state_to_numpy(st)
    for k, v in jst.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_coding_correction_through_a_pruner(jax_side, port_engine):
    """A standard division's lnL with its coding dummies is the same
    through its pruner (dummies in the pruner's tips) and the plain pass
    (dummies appended by division_loglik), and through the wavefront
    pruner.  A pruner without the dummies would have its last S real
    patterns taken for them."""
    eng = port_engine
    st = state_from_numpy(jax_side[0], "cpu")
    for i in range(4):
        pi, coding, lam, U, Uinv, rates, pinv, cmask, mult = \
            eng._generic_div_params(st, i)
        assert coding == "variable"
        tp = eng.tip_partials[i]
        pruners = [None, eng._pruners[i], PruningCudaWavefront(
            coding_tips(tp.numpy(), coding), eng.div_cfg[i].n_cats, "cpu")]
        out = [division_loglik(
            st["left"], st["right"], st["parent"], st["blen"], tp,
            eng.weights[i], lam, U, Uinv, pi, rates, pinv, cmask,
            eng.n_tips, rate_mult=mult, coding=coding, pruner=p).numpy()
            for p in pruners]
        np.testing.assert_allclose(out[1], out[0], atol=1e-3, rtol=0)
        np.testing.assert_allclose(out[2], out[0], atol=1e-3, rtol=0)


def test_wavefront_eligibility_equals_jax(port_interp, monkeypatch):
    monkeypatch.setenv("MB_TPU_WAVEFRONT", "1")
    it = JInterpreter(log=lambda m: None)
    for c in _cynmix_commands():
        it.run_line(c)
    jeng = it.build_engine()
    eng = port_interp.build_engine(wavefront=True)
    ours = [isinstance(p, PruningCudaWavefront) for p in eng._pruners]
    assert ours == [isinstance(p, PruningPallasWavefront)
                    for p in jeng._pruners]
    assert all(ours)                       # K·S from 8 to 32, 32 tips
    assert not any(isinstance(p, PruningCudaWavefront)
                   for p in port_interp.build_engine(
                       wavefront=False)._pruners)
    # the pruners carry the dummy patterns: P_d + S_d
    assert [p.P for p in eng._pruners] == [124, 34, 10, 9, 537, 125, 203,
                                           330]


def test_p_header_equals_jax_param_columns(jax_side, port_engine):
    ours = [n for n, _ in param_columns(port_engine)]
    theirs = [n for n, _ in j_param_columns(jax_side[3])]
    assert "alpha{1,2,3,4}" in ours          # one shape for the 4 buckets
    # JAX reads "pinvar" as a state-frequency field and prints pinvar{};
    # the port numbers it by division (ROADMAP Queue 3)
    assert theirs.count("pinvar{}") == 4
    assert [n for n in ours if n.startswith("pinvar")] == [
        "pinvar{5}", "pinvar{6}", "pinvar{7}", "pinvar{8}"]
    assert [n if not n.startswith("pinvar") else "pinvar{}"
            for n in ours] == theirs


def test_ordered_characters_and_symdiri_raise():
    """Ordered characters are carried since item 10b (the ordered Mk
    generator, tests/test_torch_dating.py and test_torch_hymfossil.py),
    and symdirihyperpr since item 13c: the engine takes it, and ordered
    characters keep uniform frequencies under it, as in the JAX package
    (mrbayes_tpu engine.py:612-614)."""
    nf = read_nexus_file(example("cynmix.nex"))
    ordered = make_divisions(nf.matrix, ctype={c: "ordered"
                                               for c in range(166)})
    ds = DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar, divisions=ordered)
    eng = Engine(ds, [DivisionSettings() for _ in ordered], device="cpu")
    # two-state ordered characters are unordered ones (reference
    # src/model.c:16525)
    assert {(c.div.n_states, c.div.ctype) for c in eng.div_cfg
            if c.div.dtype is DataType.STANDARD} == {
                (2, "unordered"), (3, "ordered"), (4, "ordered"),
                (8, "ordered")}
    states, _ = eng.init_chains()
    assert torch.isfinite(states["lnL"]).all()
    divs = make_divisions(nf.matrix)
    ds = DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar, divisions=divs)
    sym = [DivisionSettings(symdirihyperpr=Prior("fixed", (1.0,)))
           for _ in divs]
    eng = Engine(ds, sym, device="cpu")
    assert {(c.div.n_states, c.symdiri) for c in eng.div_cfg
            if c.div.dtype is DataType.STANDARD} == {
                (2, True), (3, True), (4, True), (8, True)}
    states, _ = eng.init_chains()
    assert torch.isfinite(states["lnL"]).all()
    eng = Engine(DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                         divisions=ordered),
                 [DivisionSettings(symdirihyperpr=Prior("fixed", (1.0,)))
                  for _ in ordered], device="cpu")
    assert {(c.div.n_states, c.symdiri) for c in eng.div_cfg
            if c.div.dtype is DataType.STANDARD} == {
                (2, True), (3, False), (4, False), (8, False)}


def test_cli_run_writes_complete_files(tmp_path):
    prefix = str(tmp_path / "cynmix")
    it = Interpreter(log=lambda m: None, device="cpu", wavefront=True,
                     stacked=True)
    for c in _cynmix_commands(nruns=1, nchains=2):
        it.run_line(c)
    it.run_line(f"mcmc ngen=30 samplefreq=10 printfreq=10 diagnfreq=30 "
                f"file={prefix}")
    eng = it._last_runner.eng
    assert [g for g, _ in eng._stacked_pruners] == [[0, 1, 2, 3, 5]]
    with open(f"{prefix}.run1.p") as f:
        lines = f.read().splitlines()
    header = lines[1].split("\t")
    assert header[:3] == ["Gen", "lnLike", "lnPrior"]
    rows = [ln.split("\t") for ln in lines[2:]]
    assert [int(r[0]) for r in rows] == [0, 10, 20, 30]
    assert all(len(r) == len(header) for r in rows)
    assert all(np.isfinite(float(r[1])) for r in rows)
    with open(f"{prefix}.run1.t") as f:
        text = f.read()
    assert text.rstrip().endswith("end;") and text.count("tree gen.") == 4
