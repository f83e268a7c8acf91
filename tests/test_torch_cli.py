"""The port's driver and CLI (``cli.py``, ``mcmc/run.py``, ``summarize/``)
against the JAX package's, on test1.

* the port's ``.p`` header for test1 equals JAX ``param_columns``, apart
  from one fault of the JAX package the port does not copy: JAX's
  ``suffix`` treats ``pinvar`` as a state-frequency field (its name
  starts with "pi") and prints both divisions' columns as ``pinvar{}``
  (mrbayes_tpu/mcmc/run.py:33); the port prints ``pinvar{1}`` and
  ``pinvar{2}``, as the reference does (ROADMAP Queue 3);
* a 100-generation, 2 runs x 2 chains test1 run through
  ``Interpreter.execute_file`` on the CPU writes complete ``.p``, ``.t``,
  ``.mcmc`` and ``.ckp`` files, and the checkpoint restores the final
  states (scores within 1e-3 of the carried ones) and the generators;
* the port's sump and sumt print exactly the lines JAX's sump and sumt
  print on those files;
* the three ``primates_part2_unlinked_gtr_g`` rows of
  ``tests/golden_extra.json`` hold within the row's ``tol`` (0.6) through
  the port's CLI, with ``/root/reference/examples`` mapped to the
  vendored ``tests/data/ref/examples`` (``conftest.example``);
* entry points refuse to run without a CUDA device unless given the CPU,
  and commands the port does not carry name their ROADMAP item.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.summarize.sump import sump as j_sump
from mrbayes_tpu.summarize.sumt import sumt as j_sumt
from mrbayes_tpu_torch.cli import CommandError, Interpreter
from mrbayes_tpu_torch.mcmc.run import McmcRunner, param_columns
from mrbayes_tpu_torch.summarize.sump import sump
from mrbayes_tpu_torch.summarize.sumt import sumt
from mrbayes_tpu_torch.trees import parse_newick
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLD = [r for r in json.load(open(os.path.join(HERE, "golden_extra.json")))
        if r["name"] == "primates_part2_unlinked_gtr_g"]
TEST1 = """#NEXUS
begin mrbayes;
    set autoclose=yes nowarn=yes;
    execute {data};
    partition test = 2: 1-400, 401-.;
    set partition=test;
    lset applyto=(all) nst=mixed rates=invgamma;
    unlink statefreq=(all) revmat=(all) pinvar=(all) shape=(all);
    prset applyto=(all) ratepr=variable;
    mcmc ngen=100 nruns=2 nchains=2 samplefreq=10 printfreq=50
         diagnfreq=50 file={prefix};
end;
"""


def _setup_lines():
    return TEST1.split("begin mrbayes;")[1].split("mcmc ")[0] \
        .format(data=example("primates.nex")).strip().rstrip(";") \
        .split(";")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One test1 run through the port's CLI on the CPU, with the in-loop
    tree and carried-versus-recomputed score checks on."""
    d = tmp_path_factory.mktemp("test1")
    prefix = str(d / "test1")
    nex = d / "test1.nex"
    nex.write_text(TEST1.format(data=example("primates.nex"), prefix=prefix))
    lines = []
    it = Interpreter(log=lines.append, device="cpu", multiwalk=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MB_DEBUG", "1")
        mp.setenv("MB_DEBUG_LNL", "1")
        it.execute_file(str(nex))
    return it, prefix, lines


def test_debug_lnl_hook_catches_drift(run, monkeypatch):
    """MB_DEBUG_LNL recomputes the carried scores and raises when one has
    drifted (the run above passed it at every sample boundary)."""
    runner = run[0]._last_runner
    states = dict(runner.final_states)
    host = {k: v.numpy() for k, v in states.items()}
    monkeypatch.setenv("MB_DEBUG_LNL", "1")
    runner._debug_checks(100, host, states)
    host["lnL"] = host["lnL"] + 1.0
    with pytest.raises(AssertionError, match="DEBUG_LNL drift"):
        runner._debug_checks(100, host, states)


def test_p_header_equals_jax_param_columns(run):
    it, prefix, _ = run
    jit = JInterpreter(log=lambda m: None)
    for ln in _setup_lines():
        jit.run_line(ln)
    jnames = [n for n, _ in j_param_columns(jit.build_engine())]
    names = [n for n, _ in param_columns(it._last_runner.eng)]
    assert [jnames.index("pinvar{}"), len(jnames) - 1
            - jnames[::-1].index("pinvar{}")] == \
        [names.index("pinvar{1}"), names.index("pinvar{2}")]
    assert names == [n if n != "pinvar{}" else
                     names[i] for i, n in enumerate(jnames)]
    assert "gtrsubmodel{1}" in names and "m{2}" in names
    with open(prefix + ".run1.p") as f:
        f.readline()
        assert f.readline().rstrip("\n").split("\t") == \
            ["Gen", "lnLike", "lnPrior"] + names


def test_run_writes_complete_files(run):
    it, prefix, lines = run
    runner = it._last_runner
    assert [g for g, _ in runner.eng._multiwalk_pruners] == [[0, 1]]
    for r in (1, 2):
        with open(f"{prefix}.run{r}.p") as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()[2:]]
        assert [int(x[0]) for x in rows] == list(range(0, 101, 10))
        assert all(len(x) == len(runner.cols) + 3 for x in rows)
        assert all(np.isfinite([float(v) for v in x]).all() for x in rows)
        with open(f"{prefix}.run{r}.t") as f:
            text = f.read()
        assert text.count("   tree gen.") == 11
        assert text.rstrip().endswith("end;")
    with open(prefix + ".mcmc") as f:
        assert [ln.split("\t")[0] for ln in f.read().splitlines()[2:]] \
            == ["50", "100"]
    assert any("Likelihood of best state" in ln for ln in lines)
    # the checkpoint restores the final states and the generators
    states, bk = runner.final_states, runner.final_bk
    back, bk2, gen = McmcRunner(runner.eng, prefix).read_checkpoint()
    assert gen == 100
    for k in ("left", "right", "parent", "blen", "gtr_class", "revmat",
              "ratemult", "pi", "shape", "pinvar"):
        assert torch.equal(back[k], states[k]), k
    for k in ("lnL", "lnP"):
        np.testing.assert_allclose(back[k].numpy(), states[k].numpy(),
                                   atol=1e-3, rtol=0)
    for k in ("rng", "rng_host", "rng_swap"):
        assert torch.equal(bk2[k].get_state(), bk[k].get_state())
    assert torch.equal(bk2["tuning"], bk["tuning"])
    assert bk2["gen"] == 100


def _lines(fn, *a, **kw):
    out = []
    fn(*a, log=out.append, **kw)
    return out


def test_sump_prints_what_jax_sump_prints(run, tmp_path):
    _, prefix, _ = run
    ours = _lines(sump, prefix, outputname=str(tmp_path / "port"))
    ref = _lines(j_sump, prefix, outputname=str(tmp_path / "jax"))
    assert ours == ref
    assert any("Average PSRF" in ln for ln in ours)


def test_sumt_prints_what_jax_sumt_prints(run, tmp_path):
    _, prefix, _ = run
    ours = _lines(sumt, prefix, outputname=str(tmp_path / "port"))
    ref = _lines(j_sumt, prefix, outputname=str(tmp_path / "jax"))
    assert ours == ref
    assert any("Credible sets of trees" in ln for ln in ours)
    for ext in (".con.tre", ".parts", ".tstat", ".trprobs"):
        assert (tmp_path / "port").with_suffix(ext).read_text() == \
            (tmp_path / "jax").with_suffix(ext).read_text()


@pytest.fixture(scope="module")
def golden_interpreter():
    it = Interpreter(log=lambda m: None, device="cpu")
    for c in GOLD[0]["commands"]:
        it.run_line(c.replace("/root/reference/examples",
                              os.path.dirname(example("primates.nex"))))
    return it


@pytest.mark.parametrize("i", range(len(GOLD)),
                         ids=[f"gen{r['gen']}" for r in GOLD])
def test_golden_partitioned_row(golden_interpreter, i):
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


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Interpreter()
    nex = tmp_path / "t.nex"
    nex.write_text(TEST1.format(data=example("primates.nex"),
                                prefix=str(tmp_path / "t")))
    out = subprocess.run([sys.executable, "-m", "mrbayes_tpu_torch.cli",
                          str(nex)], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_commands_outside_the_port_name_their_item(tmp_path):
    it = Interpreter(log=lambda m: None, device="cpu")
    it.execute_file(example("primates.nex"))
    # items 14a-14e and 15 are ported: every command of the JAX package's
    # CLI runs (BEST's with them); only a command neither knows raises
    for line in ("speciespartition sp = A: 1, B: 2-12",
                 "set speciespartition=sp", "prset popvarpr=variable",
                 "prset ploidy=haploid generatepr=variable",
                 f"ss ngen=10 nsteps=2 samplefreq=5 nruns=1 nchains=1 "
                 f"filename={tmp_path}/ss", "delete 1", "restore 1",
                 "showmodel"):
        it.run_line(line)
    ts = it.env.tree_settings
    assert (ts.popvarpr, ts.ploidy) == ("variable", "haploid")
    assert it.env.current_speciespartition == "sp"
    with pytest.raises(CommandError, match="unknown command"):
        it.run_line("frobnicate")
