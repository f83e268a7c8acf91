"""The port's commands of ROADMAP Queue 1 items 14d and 15 against the JAX
package's: propset, startvals, comparetree, compareref, plot, sump
plot=yes, per-chain move selection, delete/restore, outgroup, usertree
and the informational commands.

* ``tests/test_commands.py``'s SCRIPT through the port's CLI (2 runs x 2
  chains, 400 generations on the CPU): propset's move probabilities,
  tunings and targets equal to JAX's, its error messages equal to JAX's,
  the startvals tree every chain's starting tree, the comparetree,
  compareref and plot output (log lines and files) equal to JAX's
  functions' on the same .t/.p files;
* per-chain moves (``McmcSettings(per_chain_moves=True)``): each chain's
  move counts fit the move probabilities (chi-square p > 1e-3), the
  carried lnL/lnP equal a recompute;
* after ``delete``: the port's lnL within 5e-3 (float32 sums near -7e3,
  as ``tests/test_torch_engine.py``) and lnPrior within 1e-4 of JAX's at
  identical states, a constraint's taxa remapped; ``restore`` brings the
  taxa back;
* the informational commands print what JAX's print, apart from the lines
  that name the framework or the device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.summarize import compare as JCMP
from mrbayes_tpu_torch.cli import CommandError, Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.mcmc.diagnostics import splits_of_tree
from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
from mrbayes_tpu_torch.mcmc.settings import McmcSettings
from mrbayes_tpu_torch.summarize import compare as CMP
from conftest import example

torch.set_num_threads(1)

SCRIPT = """#NEXUS
begin trees;
    tree mystart = ((1,2),((3,((4,5),6)),(7,((8,(9,10)),(11,12)))));
end;
begin mrbayes;
    set autoclose=yes nowarnings=yes seed=7 swapseed=9;
    execute "{primates}";
    lset nst=2 rates=equal;
    propset subtree_swap$prob=0 ext_spr$prob=20 ext_spr$tuning=0.7;
    startvals tau=mystart;
    mcmc ngen=400 nruns=2 nchains=2 samplefreq=100 printfreq=200
         diagnfreq=400 file={prefix};
    plot parameter=LnL;
    comparetree filename1={prefix}.run1.t filename2={prefix}.run2.t
                outputname={prefix}.cmp;
end;
"""
# the model commands of SCRIPT, for the JAX engine it is held against
MODEL = ("lset nst=2 rates=equal",
         "propset subtree_swap$prob=0 ext_spr$prob=20 ext_spr$tuning=0.7")


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("cmds")
    script = d / "cmds.nex"
    script.write_text(SCRIPT.format(prefix=str(d / "out"),
                                    primates=example("primates.nex")))
    lines = []
    it = Interpreter(log=lines.append, device="cpu")
    it.execute_file(str(script))
    return d, lines, it


def _jax_interpreter(lines=(), log=_quiet):
    jit = JInterpreter(log=log)
    jit.run_line(f"execute {example('primates.nex')}")
    for c in lines:
        jit.run_line(c)
    return jit


def _move_table(eng):
    return [(m.name, m.weight, m.tuning0, m.target, m.tunable)
            for m in eng.moves]


def test_propset_applied(run):
    _, _, it = run
    eng = it._last_runner.eng
    names = [m.name for m in eng.moves]
    assert "subtree_swap" not in names
    spec = {m.name: m for m in eng.moves}["ext_spr"]
    assert spec.weight == 20.0 and abs(spec.tuning0 - 0.7) < 1e-9
    assert _move_table(eng) == _move_table(
        _jax_interpreter(MODEL).build_engine())
    probs = eng._move_probs.numpy()
    w = np.array([m.weight for m in eng.moves])
    np.testing.assert_allclose(probs, w / w.sum())


@pytest.mark.parametrize("line", [
    "propset nosuchmove$prob=2",
    "propset extss$prob=1",
    "propset ext_spr$bogus=1",
])
def test_propset_errors_equal_jax(line):
    it = Interpreter(log=_quiet, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    it.run_line(line)
    jit = _jax_interpreter([line])
    with pytest.raises(ValueError) as mine:
        it.build_engine()
    with pytest.raises(ValueError) as theirs:
        jit.build_engine()
    assert str(mine.value) == str(theirs.value)


def test_propset_bad_syntax():
    it = Interpreter(log=_quiet, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    with pytest.raises(CommandError, match="bad syntax"):
        it.run_line("propset ext_spr=2")


def test_startvals_tree_used(run):
    _, _, it = run
    eng = it._last_runner.eng
    assert frozenset(set(range(12)) - {0, 1}) in splits_of_tree(
        eng.start_tree)
    want = splits_of_tree(eng.start_tree)
    rng = np.random.default_rng(7)
    for _ in range(eng.mcmc.n_chains_total):
        st = eng.init_state(rng)
        from mrbayes_tpu_torch.trees import Tree
        t = Tree(parent=st["parent"].astype(np.int32),
                 left=st["left"].astype(np.int32),
                 right=st["right"].astype(np.int32), blen=st["blen"],
                 n_tips=12)
        assert splits_of_tree(t) == want


def _logs(fn, *args, **kw):
    lines = []
    fn(*args, log=lines.append, **kw)
    return lines


def test_comparetree_equals_jax(run, tmp_path):
    d, lines, _ = run
    assert (d / "out.cmp.pairs").exists()
    assert any("Root-mean-square split frequency difference" in ln
               for ln in lines)
    f1, f2 = str(d / "out.run1.t"), str(d / "out.run2.t")
    mine = _logs(CMP.comparetree, f1, f2, str(tmp_path / "a"))
    theirs = _logs(JCMP.comparetree, f1, f2, str(tmp_path / "b"))
    assert mine[:-1] == theirs[:-1]       # the last names the output file
    assert (tmp_path / "a.pairs").read_text() == \
        (tmp_path / "b.pairs").read_text()


def test_compareref_equals_jax(run, tmp_path):
    d, _, _ = run
    f1, f2 = str(d / "out.run1.t"), str(d / "out")
    mine = _logs(CMP.compareref, f1, f2, str(tmp_path / "a"), nruns=2)
    theirs = _logs(JCMP.compareref, f1, f2, str(tmp_path / "b"), nruns=2)
    assert [ln for ln in mine if "Wrote" not in ln] == \
        [ln for ln in theirs if "Wrote" not in ln]
    assert (tmp_path / "a.sdsf").read_text() == \
        (tmp_path / "b.sdsf").read_text()


def test_plot_and_sump_plot_equal_jax(run):
    d, lines, it = run
    assert any("lnLike trace" in ln for ln in lines)
    prefix = str(d / "out")
    assert _logs(CMP.plot, prefix, "LnL") == _logs(JCMP.plot, prefix, "LnL")
    out = []
    it._log_fn = out.append
    try:
        it.run_line(f"sump filename={prefix} plot=yes")
    finally:
        it._log_fn = lines.append
    # the trace plot after sump's tables, as JAX's plot draws it
    jplot = _logs(JCMP.plot, prefix, "LnL", burninfrac=it._burnin_frac({}))
    assert out[-len(jplot):] == jplot


def test_per_chain_move_counts_fit_the_probabilities():
    it = Interpreter(log=_quiet, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    it.run_line("lset nst=2 rates=gamma")
    it.env.mcmc = McmcSettings(nruns=1, nchains=8, seed=5,
                               per_chain_moves=True)
    eng = it.build_engine()
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 40)
    tries = bk["tries_total"].numpy()
    # every chain tried one move a generation, its own
    assert (tries.sum(1) == 40).all()
    assert len({tuple(r) for r in tries}) > 1
    counts = tries.sum(0)
    expect = eng._move_probs.numpy() * counts.sum()
    assert chisquare(counts, expect).pvalue > 1e-3
    assert (bk["accepts_total"] <= bk["tries_total"]).all()
    fresh = eng.score({k: v for k, v in states.items()
                       if k not in SCORE_KEYS and not k.startswith("eig")}
                      | eng.refresh_eigs({k: v for k, v in states.items()
                                          if k not in SCORE_KEYS}))
    for k in ("lnL", "lnP_tree", "lnP_par"):
        np.testing.assert_allclose(states[k].numpy(), fresh[k].numpy(),
                                   atol=1e-3, rtol=1e-6)


def test_delete_restore_equal_jax():
    cmds = ["constraint apes = Homo_sapiens Pan Gorilla",
            "prset topologypr=constraints(apes)", "lset nst=1 rates=equal",
            "taxset two = 2 12", "delete two",
            "mcmcp nruns=1 nchains=3 seed=4"]
    it = Interpreter(log=_quiet, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    for c in cmds:
        it.run_line(c)
    jit = _jax_interpreter(cmds)
    eng, jeng = it.build_engine(), jit.build_engine()
    assert eng.n_tips == jeng.n_tips == 10
    assert eng.data.taxa == list(jeng.data.taxa)
    np.testing.assert_array_equal(eng.constraint_masks,
                                  jeng.constraint_masks)
    rng = np.random.default_rng(4)
    jst = jax.tree.map(lambda *x: jnp.stack(x),
                       *[jeng.init_state(rng) for _ in range(3)])
    st = state_from_numpy({k: np.asarray(v) for k, v in jst.items()},
                          "cpu")
    np.testing.assert_allclose(
        eng.log_likelihood(st).numpy(),
        np.asarray(jax.vmap(jeng.log_likelihood)(jst)), atol=5e-3, rtol=0)
    np.testing.assert_allclose(
        eng.log_prior(st).numpy(),
        np.asarray(jax.vmap(jeng.log_prior)(jst)), atol=1e-4, rtol=0)
    it.run_line("restore all")
    assert it.build_engine().n_tips == 12


# commands whose every line names no framework or device, and those with
# such a line (compared without it)
INFO_SAME = ("showmodel", "showmatrix", "showmoves", "showparams",
             "charstat", "taxastat", "showusertrees", "databreaks",
             "disclaimer", "showmcmctrees")
INFO_NAMING = ("citations", "acknowledgments")


@pytest.mark.parametrize("cmd", INFO_SAME + INFO_NAMING)
def test_informational_commands_equal_jax(cmd):
    pre = ["lset nst=6 rates=invgamma", "delete 3", "outgroup 2",
           "usertree"]
    mine, theirs = [], []
    it = Interpreter(log=mine.append, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    jit = _jax_interpreter(log=theirs.append)
    for c in pre:
        it.run_line(c)
        jit.run_line(c)
    del mine[:], theirs[:]
    it.run_line(cmd)
    jit.run_line(cmd)
    assert mine and len(mine) == len(theirs)
    if cmd in INFO_NAMING:
        mine, theirs = mine[:1], theirs[:1]
    assert mine == theirs


def test_remaining_commands_run(tmp_path):
    lines = []
    it = Interpreter(log=lines.append, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    for c in ("about", "version", "showbeagle", "help", "help sumt",
              f"manual {tmp_path}/ref.txt",
              f"log start filename={tmp_path}/log.txt", "showmatrix",
              "log stop", "outgroup Pan", "usertree"):
        n = len(lines)
        it.run_line(c)
        assert len(lines) > n or c.split()[0] in ("log", "outgroup",
                                                  "usertree"), c
    assert it.env.outgroup == 3
    assert "Matrix: 12 x 898" in (tmp_path / "log.txt").read_text()
    assert "sumt" in (tmp_path / "ref.txt").read_text()
    assert not any("JAX" in ln or "TPU" in ln for ln in lines)
