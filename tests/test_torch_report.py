"""The port's posterior reporting (``mcmc/report.py`` and
``ops/pruning.final_partials``) against the JAX package's.

* ``final_partials`` on primates at the golden states, batched over the
  four rows as chains, against JAX's one row at a time, both in float64
  on the same eigensystem: D, F, flog and logscale within 1e-5
  relative;
* the ancestral-state probabilities of ``tests/golden_ancstates.json``
  (reference MrBayes, primates GTR+I+G with the apes constraint) within
  1e-3 max and 2e-4 mean, as ``tests/test_report.py`` holds JAX's;
* the site rates against the float64 oracle within 0.02;
* the ``Reporter``'s headers equal to JAX's and its values within 1e-4
  of JAX's at identical states (the eigensystem carried over);
* NY98 and M3 possel/siteomega within 1e-3 of JAX's ``final_partials``
  under ``jax.enable_x64`` with the port's float64 eigensystem carried
  over (JAX's float32 engine is off by up to 0.59 in lnL at S 20,
  ROADMAP Queue 3, so it is not the yardstick at S 61);
* the ineligible models skipped with JAX's notes;
* ``report`` through the CLI: the .p header equals JAX's columns and each
  site's probabilities sum to 1."""
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
from mrbayes_tpu.mcmc.report import Reporter as JReporter
from mrbayes_tpu.mcmc.settings import DivisionSettings as JDivisionSettings
from mrbayes_tpu.mcmc.settings import McmcSettings as JMcmcSettings
from mrbayes_tpu.mcmc.settings import TreeSettings as JTreeSettings
from mrbayes_tpu.nexus.parser import read_nexus_file as j_read_nexus_file
from mrbayes_tpu.ops import pruning as JP
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy, state_to_numpy
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.mcmc.engine import Engine
from mrbayes_tpu_torch.mcmc.report import Reporter
from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings, McmcSettings,
                                             TreeSettings)
from mrbayes_tpu_torch.nexus.parser import read_nexus_file
from mrbayes_tpu_torch.ops.pruning import final_partials
from mrbayes_tpu_torch.trees import parse_newick
from conftest import example

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
with open(os.path.join(HERE, "golden_ancstates.json")) as _f:
    GOLD = json.load(_f)
ROWS = GOLD["rows"]
OPTS = {"ancstates": ("yes", (0,)), "siterates": ("yes", (0,))}


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def anc():
    """The port's and JAX's primates GTR+I+G engines with the apes
    constraint, and the golden rows' states as four chains."""
    nf = read_nexus_file(example("primates.nex"))
    mask = np.zeros(12, bool)
    mask[[t - 1 for t in GOLD["constraint_taxa_1based"]]] = True
    ts = TreeSettings()
    ts.constraints = [("apes", mask, None)]
    eng = Engine(DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                         divisions=make_divisions(nf.matrix)),
                 [DivisionSettings(nst="6", rates="invgamma")], ts,
                 mcmc=McmcSettings(nruns=1, nchains=1), device="cpu")
    jts = JTreeSettings()
    jts.constraints = [("apes", mask, None)]
    jnf = j_read_nexus_file(example("primates.nex"))
    jeng = JEngine(JDataSet(taxa=jnf.taxa, nchar=jnf.matrix.nchar,
                            divisions=j_make_divisions(jnf.matrix)),
                   [JDivisionSettings(nst="6", rates="invgamma")], jts,
                   mcmc=JMcmcSettings(nruns=1, nchains=1))
    trees = [parse_newick(r["newick"], nf.taxa) for r in ROWS]
    st = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int32)
          for f in ("left", "right", "parent")}
    st["blen"] = np.stack([t.blen for t in trees]).astype(np.float32)
    st["pi"] = np.array([[r["pi"]] for r in ROWS], np.float32)
    st["revmat"] = np.array([[r["revmat"]] for r in ROWS], np.float32)
    st["shape"] = np.array([[r["alpha"]] for r in ROWS], np.float32)
    st["pinvar"] = np.array([[r["pinvar"]] for r in ROWS], np.float32)
    jst = jax.vmap(jeng.refresh_eigs)({k: jnp.asarray(v)
                                       for k, v in st.items()})
    carried = state_from_numpy({k: np.asarray(v) for k, v in jst.items()},
                               "cpu")
    return eng, jeng, jst, carried, trees


def _port_values(eng, states, opts=OPTS):
    rep = Reporter(eng, opts, log=_quiet)
    C = states["parent"].shape[0]
    vals = rep.compute(states, torch.arange(C)).numpy()
    return rep, [dict(zip(rep.headers, v)) for v in vals]


def test_final_partials_matches_jax(anc):
    """Both passes in float64 (JAX under ``jax.enable_x64``) on the same
    inputs.  In float32 each side lies up to 3.3e-5 from its own float64
    value on these rows (26 rescaled steps of products), so the float32
    outputs cannot agree to 1e-5; in float64 they agree to rounding."""
    eng, jeng, jst, carried, _ = anc
    d = {k: (v.double() if v.is_floating_point() else v)
         for k, v in carried.items()}
    rates = eng._category_rates(d, eng.div_cfg[0])
    D, F, flog, ls = final_partials(
        d["left"], d["right"], d["parent"], d["blen"],
        eng.tip_partials[0].double(), d["eigL0"], d["eigU0"], d["eigV0"],
        rates, d["pinvar"][:, 0], eng.n_tips)
    with jax.enable_x64(True):
        for c in range(len(ROWS)):
            def f64(k):
                return jnp.asarray(d[k][c].numpy(), jnp.float64)

            j = JP.final_partials(
                jst["left"][c], jst["right"][c], jst["parent"][c],
                f64("blen"), jnp.asarray(np.asarray(jeng.tip_partials[0]),
                                         jnp.float64),
                f64("eigL0"), f64("eigU0"), f64("eigV0"),
                jnp.asarray(rates[c].numpy()), f64("pinvar")[0],
                jeng.n_tips)
            for mine, theirs in zip((D, F, flog, ls), j):
                np.testing.assert_allclose(mine[c].numpy(),
                                           np.asarray(theirs), rtol=1e-5,
                                           atol=1e-12)


@pytest.mark.parametrize("gi", range(len(ROWS)))
def test_ancstates_golden(anc, gi):
    eng, _, _, carried, _ = anc
    vals = _port_values(eng, carried)[1][gi]
    rec = ROWS[gi]
    errs = []
    for c, probs in zip(rec["anc_chars"], rec["anc"]):
        for b, p_ref in zip("ACGT", probs):
            errs.append(abs(vals[f"p({b}){{{c}@apes}}"] - p_ref))
        s = sum(vals[f"p({b}){{{c}@apes}}"] for b in "ACGT")
        assert abs(s - 1.0) < 1e-4
    errs = np.array(errs)
    assert errs.max() < 1e-3, errs.max()
    assert errs.mean() < 2e-4, errs.mean()


def test_siterates_vs_float64(anc):
    from scipy.linalg import expm

    from reference_impl import discrete_gamma_rates, gtr_q
    eng, _, _, carried, trees = anc
    vals = _port_values(eng, carried)[1][0]
    rec, t = ROWS[0], trees[0]
    div = eng.data.divisions[0]
    Q = gtr_q(np.array(rec["revmat"]), np.array(rec["pi"]))
    rates = discrete_gamma_rates(rec["alpha"], 4)
    tp = div.tip_partials(np.float64)
    P = np.array([[expm(Q * t.blen[v] * r) for r in rates]
                  for v in range(t.n_nodes)])
    cl = np.zeros((t.n_nodes, tp.shape[1], 4, 4))
    cl[:t.n_tips] = tp[:, :, None, :]
    for v in t.postorder():
        l, r = t.left[v], t.right[v]
        cl[v] = np.einsum("ksj,pkj->pks", P[l], cl[l]) \
            * np.einsum("ksj,pkj->pks", P[r], cl[r])
    Lk = np.einsum("pks,s->pk", cl[t.root], np.array(rec["pi"]))
    rbar = (Lk * rates).sum(-1) / Lk.sum(-1)
    for c in (1, 2, 4, 10, 100, 500):
        p = div.pattern_of_char[c - 1]
        assert abs(vals[f"r({c})"] - rbar[p]) < 0.02, (c, vals[f"r({c})"],
                                                       rbar[p])


def test_reporter_matches_jax(anc):
    eng, jeng, jst, carried, _ = anc
    rep, vals = _port_values(eng, carried)
    jrep = JReporter(jeng, OPTS, log=_quiet)
    assert rep.headers == jrep.headers
    for c in range(len(ROWS)):
        jv = np.array(jrep.values(jst, c))
        np.testing.assert_allclose([vals[c][h] for h in rep.headers], jv,
                                   atol=1e-4, rtol=0)


def _codon_engines(omegavar):
    cmds = [f"execute {example('replicase.nex')}",
            f"lset nucmodel=codon omegavar={omegavar}",
            "mcmcp nruns=1 nchains=2 seed=5"]
    it = Interpreter(log=_quiet, device="cpu")
    jit = JInterpreter(log=_quiet)
    for c in cmds:
        it.run_line(c)
        jit.run_line(c)
    return it.build_engine(), jit.build_engine()


def _jax_x64_possel(jeng, st, omegavar):
    """possel and siteomega [C, sites] by JAX's ``final_partials`` in
    float64 (``jax.enable_x64``) on the port's state and its float64
    eigensystem, with JAX's Reporter formula (mrbayes_tpu/mcmc/report.py:
    259-268)."""
    cfg = jeng.div_cfg[0]
    out = []
    with jax.enable_x64(True):
        for c in range(st["parent"].shape[0]):
            if omegavar == "ny98":
                omegas = np.array([st["omega1"][c, 0], 1.0,
                                   st["omega3"][c, 0]])
                w = st["omegaprobs"][c, 0]
            else:
                omegas, w = st["m3omega"][c, 0], st["m3probs"][c, 0]
            K = omegas.shape[0]
            f64 = lambda x: jnp.asarray(np.asarray(x), jnp.float64)  # noqa
            D, _, _, _ = JP.final_partials(
                jnp.asarray(st["left"][c]), jnp.asarray(st["right"][c]),
                jnp.asarray(st["parent"][c]), f64(st["blen"][c]),
                f64(jeng.tip_partials[0]), f64(st["eigL0"][c]),
                f64(st["eigU0"][c]), f64(st["eigV0"][c]), jnp.ones(K),
                0.0, jeng.n_tips, 3.0)
            Lk = np.asarray(jnp.einsum("pks,s->pk", D[-1],
                                       f64(st["pi61"][c, 0])))
            q = Lk * np.asarray(w, np.float64)[None]
            q = q / q.sum(-1, keepdims=True)
            pat = np.asarray(cfg.codon_site_pattern)
            out.append(np.concatenate([(q @ (omegas > 1.0))[pat],
                                       (q @ omegas)[pat]]))
    return np.stack(out)


@pytest.mark.parametrize("omegavar", ["ny98", "m3"])
def test_possel_siteomega_match_jax_x64(omegavar):
    eng, jeng = _codon_engines(omegavar)
    opts = {"possel": ("yes", (0,)), "siteomega": ("yes", (0,))}
    rep = Reporter(eng, opts, log=_quiet)
    assert rep.headers == JReporter(jeng, opts, log=_quiet).headers
    n_sites = eng.data.nchar // 3
    assert len(rep.headers) == 2 * n_sites
    assert rep.headers[0] == "pr+(1,2,3)"
    states, _ = eng.init_chains()
    vals = rep.compute(states, torch.arange(2)).numpy()
    ref = _jax_x64_possel(jeng, state_to_numpy(states), omegavar)
    np.testing.assert_allclose(vals, ref, atol=1e-3, rtol=0)
    assert (vals[:, :n_sites] >= 0).all() and (vals[:, :n_sites] <= 1).all()


# (lset/prset commands, the divisions asked for): models the reporter
# skips, each with JAX's notes
INELIGIBLE = {"covarion": ["lset nst=2 covarion=yes"],
              "adgamma": ["lset rates=adgamma"],
              "no_constraint": ["lset rates=gamma"]}


@pytest.mark.parametrize("name", list(INELIGIBLE))
def test_ineligible_models_skipped_with_jax_notes(name):
    cmds = [f"execute {example('primates.nex')}", *INELIGIBLE[name]]
    if name != "no_constraint":
        cmds += ["constraint apes = 3-7",
                 "prset topologypr = constraints(apes)"]
    it = Interpreter(log=_quiet, device="cpu")
    jit = JInterpreter(log=_quiet)
    for c in cmds:
        it.run_line(c)
        jit.run_line(c)
    opts = {"ancstates": ("yes", (0,)), "siterates": ("yes", (0,))}
    notes, jnotes = [], []
    rep = Reporter(it.build_engine(), opts, log=notes.append)
    jrep = JReporter(jit.build_engine(), opts, log=jnotes.append)
    assert notes == jnotes and notes
    assert rep.headers == jrep.headers
    assert (name == "no_constraint") == bool(rep.headers)


def test_cli_p_columns(tmp_path):
    """report ancstates through the CLI: the .p header is JAX's, and each
    character's state probabilities sum to 1."""
    prefix = str(tmp_path / "rep")
    cmds = [f"execute {example('primates.nex')}", "lset nst=2 rates=gamma",
            "constraint apes = 3-7", "prset topologypr = constraints(apes)",
            "report ancstates=yes siterates=yes"]
    it = Interpreter(log=_quiet, device="cpu")
    jit = JInterpreter(log=_quiet)
    for c in cmds:
        it.run_line(c)
        jit.run_line(c)
    it.run_line(f"mcmc ngen=40 nruns=1 nchains=2 samplefreq=20 "
                f"printfreq=40 diagnfreq=40 file={prefix}")
    with open(prefix + ".run1.p") as f:
        lines = f.readlines()
    hdr = lines[1].rstrip("\n").split("\t")
    from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
    jeng = jit.build_engine()
    assert hdr == (["Gen", "lnLike", "lnPrior"]
                   + [n for n, _ in j_param_columns(jeng)]
                   + JReporter(jeng, jit.env.report, log=_quiet).headers)
    assert len(lines) == 2 + 3
    for line in lines[2:]:
        row = dict(zip(hdr, line.rstrip("\n").split("\t")))
        for c in (1, 500, 898):
            s = sum(float(row[f"p({b}){{{c}@apes}}"]) for b in "ACGT")
            assert abs(s - 1.0) < 1e-4
            assert float(row[f"r({c})"]) >= 0.0
