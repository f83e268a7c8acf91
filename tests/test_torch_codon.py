"""The port's codon models M0 and NY98 against the JAX package, on
replicase.nex (9 taxa, 720 nucleotides: 240 codon sites, 61 sense codons).

* the copied genetic codes (``models/codes.py``) equal the JAX package's
  exactly: every code's table, sense codons, bases and pair classes;
* ``codon_q`` for M0 and NY98 (with the class-weighted normalisation)
  within 1e-6 of JAX's (float32 arithmetic of the same formula), and
  NY98's class-weighted mean rate is 1;
* the codon-site patterns (``Engine._codon_tensors``) equal JAX's, and a
  stop codon or a length not a multiple of 3 raises;
* the engine at identical states, JAX's eigensystems carried over (as
  float64, the port's S > 8 precision), under M0 and NY98: lnL within
  5e-3 of the JAX package's function evaluated in float64 at the same
  state (``jax_exact_lnl``; see ``tests/test_torch_protein.py`` for why
  the JAX engine's float32 value is not the yardstick at S > 8) and
  lnPrior within 1e-4 of the JAX engine's; with each side's own
  eigensystem within 5e-3;
* the ``codon_m0`` golden rows within 0.6 of reference MrBayes
  (``tests/test_golden.py``) and the ``replicase_ny98`` rows of
  ``tests/golden_extra.json`` within their ``tol`` (1.0), through the
  port's CLI;
* the NY98 moves keep omega1 in [0, 1], omega3 >= 1 (or reject) and the
  class frequencies on the simplex;
* sharded over the ``sites`` axis (2 shards of the CPU), a codon engine's
  lnL is within 5e-3 of the unsharded one;
* replicase under NY98 through the CLI, 2 runs x 2 chains, 40
  generations: its ``.p`` header equals JAX ``param_columns``, the files
  are complete, sump and sumt print what JAX's print;
* the settings item 12b brought (doublets, M3, M10, ``pairs`` and the
  M3/M10 prset keys) build engines that hold against the JAX package."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.models import codes as JC
from mrbayes_tpu.models import substitution as JQ
from mrbayes_tpu.ops import pruning as JP
from mrbayes_tpu.ops import tiprobs as JTP
from mrbayes_tpu.summarize.sump import sump as j_sump
from mrbayes_tpu.summarize.sumt import sumt as j_sumt
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy, state_to_numpy
from mrbayes_tpu_torch.envelope import write_batch
from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS, Engine
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.mcmc.settings import DivisionSettings, McmcSettings
from mrbayes_tpu_torch.models import codes as TC
from mrbayes_tpu_torch.models import substitution as TQ
from mrbayes_tpu_torch.summarize.sump import sump
from mrbayes_tpu_torch.summarize.sumt import sumt
from mrbayes_tpu_torch.trees import parse_newick, random_unrooted
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD_M0 = [r for r in json.load(open(os.path.join(
    HERE, "golden_primates.json"))) if r["model"] == "codon_m0"]
GOLD_NY98 = [r for r in json.load(open(os.path.join(
    HERE, "golden_extra.json"))) if r["name"] == "replicase_ny98"]
C = 4
OMEGAVAR = {"m0": "equal", "ny98": "ny98"}


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("name", sorted(JC.GENETIC_CODES))
def test_codes_equal_jax(name):
    assert TC.GENETIC_CODES[name] == JC.GENETIC_CODES[name]
    a, b = JC.CodonCode(name), TC.CodonCode(name)
    for f in ("sense", "aa", "bases"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    for x, y in zip(a.pair_classes(), b.pair_classes()):
        np.testing.assert_array_equal(y, x)


def _classes():
    return [jnp.asarray(m) for m in JC.CodonCode().pair_classes()], \
        [_t(m) for m in TC.CodonCode().pair_classes()]


def test_codon_q_matches_jax():
    rng = np.random.default_rng(0)
    pi = rng.dirichlet(np.ones(61) * 3, size=C).astype(np.float32)
    om = rng.uniform(0.05, 3.0, size=(C, 3)).astype(np.float32)
    kappa = rng.uniform(0.5, 5.0, size=C).astype(np.float32)
    w = rng.dirichlet(np.ones(3), size=C).astype(np.float32)
    jm, tm = _classes()
    a = jax.vmap(lambda o, k, p, ww: JQ.codon_q(o, k, p, *jm,
                                                cat_weights=ww))(om, kappa,
                                                                 pi, w)
    b = TQ.codon_q(_t(om), _t(kappa), _t(pi), *tm, cat_weights=_t(w))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
    # the classes are normalised together: weighted mean rate 1
    rate = -(torch.diagonal(b, dim1=-2, dim2=-1) * _t(pi)[:, None]).sum(-1)
    np.testing.assert_allclose((rate * _t(w)).sum(-1).numpy(), 1.0,
                               atol=1e-5)
    a = jax.vmap(lambda o, p: JQ.codon_q(o[None], 1.0, p, *jm))(om[:, 0], pi)
    b = TQ.codon_q(_t(om[:, :1]), 1.0, _t(pi), *tm)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


def _interpreters(omegavar, nchains=1):
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
    for name, ov in OMEGAVAR.items():
        it, jit = _interpreters(ov, nchains=C)
        out[name] = (it.build_engine(), jit.build_engine())
    return out


def test_codon_patterns_equal_jax(engines):
    eng, jeng = engines["m0"]
    np.testing.assert_array_equal(eng.tip_partials[0].numpy(),
                                  np.asarray(jeng.tip_partials[0]))
    np.testing.assert_array_equal(eng.weights[0].numpy(),
                                  np.asarray(jeng.weights[0]))
    assert eng._model_tips[0].shape[1:] == (239, 61)
    assert float(eng.weights[0].sum()) == 240


def test_codon_data_errors(engines):
    eng = engines["m0"][0]
    cfg = eng.div_cfg[0]
    d = cfg.div
    short = type(d)(**{**d.__dict__,
                       "pattern_of_char": d.pattern_of_char[:-1]})
    with pytest.raises(ValueError, match="multiple of 3"):
        eng._codon_tensors(type(cfg)(**{**cfg.__dict__, "div": short}))
    # TAA in the first codon of every taxon: a stop codon
    pat = d.patterns.copy()
    pat[:, d.pattern_of_char[0]] = 8          # T
    pat[:, d.pattern_of_char[1]] = 1          # A
    pat[:, d.pattern_of_char[2]] = 1          # A
    stop = type(d)(**{**d.__dict__, "patterns": pat})
    with pytest.raises(ValueError, match="stop codon"):
        eng._codon_tensors(type(cfg)(**{**cfg.__dict__, "div": stop}))


def _params(name, rng):
    st = {"pi61": rng.dirichlet(np.ones(61) * 5, size=(C, 1)).astype(
        np.float32)}
    if name == "m0":
        st["omega"] = rng.uniform(0.1, 2.0, size=(C, 1)).astype(np.float32)
    else:
        st["omega1"] = rng.uniform(0.05, 0.95, size=(C, 1)).astype(
            np.float32)
        st["omega3"] = rng.uniform(1.0, 4.0, size=(C, 1)).astype(np.float32)
        st["omegaprobs"] = rng.dirichlet(np.ones(3) * 2, size=(C, 1)).astype(
            np.float32)
    return st


def jax_exact_lnl(jeng, jst, own=False):
    """Division 0's lnL [C] by the JAX package's own ops in float64
    (``jax.enable_x64``): a codon division's (``_codon_loglik``: the NY98,
    M3 or M10 class weights, none for M0) or a generic one's (doublets),
    with the eigensystem carried in ``jst`` or, with ``own``, a float64
    ``eigh_reversible`` of its Q."""
    cfg = jeng.div_cfg[0]

    def f64(x):
        return None if x is None else jnp.asarray(x, jnp.float64)

    def one(s1):
        Q, pi_q = jeng._division_q_pi(s1, 0)
        codon = cfg.codon is not None
        if own:
            lam, U, Uinv = JTP.eigh_reversible(
                f64(Q), f64(pi_q)[None] if codon else f64(pi_q))
        else:
            lam, U, Uinv = s1["eigL0"], s1["eigU0"], s1["eigV0"]
        if not codon:
            pi, coding, _, _, _, rates, _, _, mult = \
                jeng._generic_div_params(s1, 0)
            w = None
        else:
            pi, coding, mult = pi_q, "all", 3.0
            w = (s1["omegaprobs"][cfg.ny98_group] if cfg.ny98_group >= 0
                 else s1["m3probs"][cfg.m3_group] if cfg.m3_group >= 0
                 else jeng._m10_omegas_weights(s1, cfg)[1]
                 if cfg.m10_group >= 0 else None)
            rates = jnp.ones((1 if w is None else w.shape[0],))
        return JP.division_loglik(
            s1["left"], s1["right"], s1["parent"], f64(s1["blen"]),
            f64(jeng.tip_partials[0]), f64(jeng.weights[0]), f64(lam),
            f64(U), f64(Uinv), f64(pi), f64(rates), 0.0, None, jeng.n_tips,
            rate_mult=mult, coding=coding, cat_weights=f64(w))

    with jax.enable_x64(True):
        return np.asarray(jax.jit(jax.vmap(one))(jst))


@pytest.mark.parametrize("name", list(OMEGAVAR))
def test_engine_matches_jax_at_identical_states(engines, name):
    eng, jeng = engines[name]
    rng = np.random.default_rng(5)
    trees = [random_unrooted(eng.n_tips, rng, mean_blen=0.1)
             for _ in range(C)]
    st = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int32)
          for f in ("left", "right", "parent")}
    st["blen"] = np.stack([t.blen for t in trees]).astype(np.float32)
    st.update(_params(name, rng))
    jst = jax.vmap(jeng.refresh_eigs)({k: jnp.asarray(v)
                                       for k, v in st.items()})
    lnP = np.asarray(jax.vmap(jeng.log_prior)(jst))
    carried = state_from_numpy({k: np.asarray(v) for k, v in jst.items()},
                               "cpu")
    carried = {k: v.double() if k.startswith("eig") else v
               for k, v in carried.items()}
    np.testing.assert_allclose(eng.log_likelihood(carried).numpy(),
                               jax_exact_lnl(jeng, jst), atol=5e-3, rtol=0)
    np.testing.assert_allclose(eng.log_prior(carried).numpy(), lnP,
                               atol=1e-4, rtol=0)
    own = eng.refresh_eigs({k: v for k, v in carried.items()
                            if not k.startswith("eig")})
    assert own["eigL0"].shape == ((C, 3, 61) if name == "ny98"
                                  else (C, 1, 61))
    np.testing.assert_allclose(eng.log_likelihood(own).numpy(),
                               jax_exact_lnl(jeng, jst, own=True),
                               atol=5e-3, rtol=0)
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]


def test_sharded_codon_engine_equals_unsharded():
    """A codon division shards its codon-site patterns (NY98, 2 site
    shards of the CPU): lnL within 5e-3 of the unsharded engine
    (float32 sums of about 8e3 split in two)."""
    from mrbayes_tpu_torch.parallel.mesh import make_mesh, shard_engine_data
    it, _ = _interpreters("ny98", nchains=2)
    eng = it.build_engine()
    states, _ = eng.init_chains()
    whole = eng.log_likelihood(states)
    shard_engine_data(eng, make_mesh(1, 2, ["cpu"] * 2))
    np.testing.assert_allclose(eng.log_likelihood(states).numpy(),
                               whole.numpy(), atol=5e-3, rtol=0)


@pytest.mark.parametrize("i", range(len(GOLD_M0)))
def test_golden_codon_m0(engines, i):
    rec = GOLD_M0[i]
    it, _ = _interpreters("equal")
    eng = it.build_engine()
    t = parse_newick(rec["newick"], eng.data.taxa)
    st = {f: torch.as_tensor(getattr(t, f)[None]).long()
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(t.blen[None], dtype=torch.float32)
    st["pi61"] = torch.tensor([[rec["pi61"]]])
    st["omega"] = torch.tensor([[rec["omega"]]])
    lnL = float(eng.log_likelihood(eng.refresh_eigs(st))[0])
    assert abs(lnL - rec["lnL"]) < 0.6, (lnL, rec["lnL"])


@pytest.fixture(scope="module")
def ny98_interpreter():
    it = Interpreter(log=lambda m: None, device="cpu")
    for c in GOLD_NY98[0]["commands"]:
        if c.startswith("execute "):
            # the reference's example, vendored under tests/data
            c = "execute " + example(os.path.basename(c.split()[1]))
        it.run_line(c)
    return it


@pytest.mark.parametrize("i", range(len(GOLD_NY98)),
                         ids=[f"gen{r['gen']}" for r in GOLD_NY98])
def test_golden_replicase_ny98_row(ny98_interpreter, i):
    rec = GOLD_NY98[i]
    eng = ny98_interpreter.build_engine()
    t = parse_newick(rec["newick"], eng.data.taxa)
    st = {f: torch.as_tensor(getattr(t, f)[None]).long()
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(t.blen[None], dtype=torch.float32)
    for k, v in rec["state"].items():
        st[k] = torch.tensor([v], dtype=torch.float32)
    lnL = float(eng.log_likelihood(eng.refresh_eigs(st))[0])
    assert abs(lnL - rec["lnL"]) < rec["tol"], (rec["gen"], lnL, rec["lnL"])


def test_ny98_moves_keep_their_bounds(engines):
    eng = engines["ny98"][0]
    states, bk = eng.init_chains()
    gen = torch.Generator().manual_seed(1)
    moves = {m.name: m for m in eng.moves}
    st = {k: v for k, v in states.items()}
    for _ in range(30):
        for name, tuning in (("omega1_slider", 0.8), ("omega3_mult", 2.0),
                             ("omegaprobs_dir", 5.0)):
            new, lnH = moves[name].fn(gen, st, torch.full((C,), tuning))
            ok = lnH > -1e29
            st = {k: torch.where(ok.reshape((-1,) + (1,) * (v.ndim - 1)),
                                 new[k], v) if k in new else v
                  for k, v in st.items()}
    assert ((st["omega1"] >= 0) & (st["omega1"] <= 1)).all()
    assert (st["omega3"] >= 1).all()
    assert (st["omegaprobs"] > 0).all()
    np.testing.assert_allclose(st["omegaprobs"].sum(-1).numpy(), 1.0,
                               atol=1e-6)
    assert not torch.equal(st["omega1"], states["omega1"])


@pytest.fixture(scope="module")
def ny98_run(tmp_path_factory):
    """replicase under NY98, 2 runs x 2 chains, 40 generations, through
    the CLI (``envelope.write_batch``'s file with 2 chains), with the
    carried scores checked against recomputed ones at every sample."""
    d = str(tmp_path_factory.mktemp("ny98"))
    path = write_batch("replicase_ny98", d, 40, samplefreq=10, diagnfreq=20)
    with open(path) as f:
        text = f.read().replace("nchains=4", "nchains=2")
    with open(path, "w") as f:
        f.write(text)
    lines = []
    it = Interpreter(log=lines.append, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MB_DEBUG", "1")
        mp.setenv("MB_DEBUG_LNL", "1")
        it.execute_file(path)
    return it, os.path.join(d, "replicase_ny98"), lines


def test_ny98_p_header_equals_jax_param_columns(ny98_run):
    it, prefix, _ = ny98_run
    _, jit = _interpreters("ny98")
    jnames = [n for n, _ in j_param_columns(jit.build_engine())]
    names = [n for n, _ in param_columns(it._last_runner.eng)]
    assert names == jnames
    assert names[:6] == ["TL", "omega(1)", "omega(3)", "pi(-)", "pi(N)",
                         "pi(+)"] and len(names) == 6 + 61
    with open(prefix + ".run1.p") as f:
        f.readline()
        assert f.readline().rstrip("\n").split("\t") == \
            ["Gen", "lnLike", "lnPrior"] + names


def test_ny98_run_writes_complete_files(ny98_run, tmp_path):
    it, prefix, lines = ny98_run
    for r in (1, 2):
        with open(f"{prefix}.run{r}.p") as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()[2:]]
        assert [int(x[0]) for x in rows] == list(range(0, 41, 10))
        assert all(np.isfinite([float(v) for v in x]).all() for x in rows)
        with open(f"{prefix}.run{r}.t") as f:
            text = f.read()
        assert text.count("   tree gen.") == 5
        assert text.rstrip().endswith("end;")
    ours, ref = [], []
    sump(prefix, log=ours.append, outputname=str(tmp_path / "port"))
    j_sump(prefix, log=ref.append, outputname=str(tmp_path / "jax"))
    assert ours == ref
    ours, ref = [], []
    sumt(prefix, log=ours.append, outputname=str(tmp_path / "port"))
    j_sumt(prefix, log=ref.append, outputname=str(tmp_path / "jax"))
    assert ours == ref


# every replicase site in a pair of neighbours, for the doublet model
ALL_PAIRS = "pairs " + ", ".join(f"{i}:{i + 1}" for i in range(1, 720, 2))
# the model each item-12b line runs under
ITEM_12B_MODEL = {"pairs 1:2": [],
                  "prset m3omegapr=exponential(1)":
                      ["lset nucmodel=codon omegavar=m3"],
                  "prset m10betapr=uniform(0,20)":
                      ["lset nucmodel=codon omegavar=m10"],
                  "prset m10gammapr=uniform(0,20)":
                      ["lset nucmodel=codon omegavar=m10"]}


def _item_12b_engines(lines):
    """The port's and the JAX package's engines on replicase after
    ``lines``, 1 run x C chains."""
    it = Interpreter(log=lambda m: None, device="cpu")
    jit = JInterpreter(log=lambda m: None)
    for ln in [f"execute {example('replicase.nex')}", *lines,
               f"mcmcp nruns=1 nchains={C} seed=3"]:
        it.run_line(ln)
        jit.run_line(ln)
    return it, jit, it.build_engine(), jit.build_engine()


def _hold_against_jax(eng, jeng):
    """The port's lnL through its own eigensystems within 5e-3 of the JAX
    package's function in float64 (S > 8: ``tests/test_torch_protein.py``
    says why not JAX's float32 engine), lnPrior within 1e-4 of JAX's, at
    the port's starting states."""
    states, _ = eng.init_chains()
    st = {k: v for k, v in states.items()
          if k not in SCORE_KEYS and not k.startswith("eig")}
    jst = {k: jnp.asarray(v) for k, v in state_to_numpy(st).items()}
    np.testing.assert_allclose(states["lnL"].numpy(),
                               jax_exact_lnl(jeng, jst, own=True), atol=5e-3,
                               rtol=0)
    np.testing.assert_allclose(
        states["lnP"].numpy(),
        np.asarray(jax.jit(jax.vmap(jeng.log_prior))(jst)), atol=1e-4,
        rtol=0)
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]


@pytest.mark.parametrize("line", [
    "lset nucmodel=doublet", "lset nucmodel=codon omegavar=m3",
    "lset nucmodel=codon omegavar=m10"])
def test_engine_refuses_item_12b(line):
    """Item 12b's models, refused before the port carried them, now build:
    replicase under doublets (every site in a pair), M3 and M10, each held
    against the JAX package."""
    lines = [ALL_PAIRS, line] if "doublet" in line else [line]
    _, _, eng, jeng = _item_12b_engines(lines)
    K, S = {"lset nucmodel=doublet": (1, 16)}.get(
        line, (3 if "m3" in line else 8, 61))
    assert eng.div_cfg[0].n_cats == K
    assert eng._model_tips[0].shape[2] == S
    _hold_against_jax(eng, jeng)


@pytest.mark.parametrize("line", list(ITEM_12B_MODEL))
def test_cli_refuses_item_12b(line):
    """Item 12b's commands, refused before the port carried them, now set
    what the JAX package's CLI sets, and the engine they shape holds
    against the JAX package."""
    it, jit, eng, jeng = _item_12b_engines(ITEM_12B_MODEL[line] + [line])
    assert it.env.pairs == jit.env.pairs
    s, js = it.env.div_settings[0], jit.env.div_settings[0]
    for f in ("nucmodel", "omegavar", "m10betapr", "m10gammapr"):
        assert repr(getattr(s, f)) == repr(getattr(js, f))
    _hold_against_jax(eng, jeng)
