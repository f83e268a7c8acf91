"""The port's host spans and work counters (``mrbayes_tpu_torch/spans.py``)
through the run driver, the generation loop and the CLI, on the CPU.

* a CLI ``mcmc`` of 300 generations on primates cut into three loci, each
  its own GTR+G (unlinked statefreq, revmat, shape; rate multipliers) on
  a strict clock: ``phase_times`` keeps ``sample_io``, ``diagnostics``
  and ``checkpoint`` and gives ``device`` as the block's call plus the
  wait; the spans' self times add up to the runner's wall time; every
  move's ``gen.propose.*`` count is its ``tries_total`` over the chains;
* ``eig_rows_changed / eig_rows`` is 1/3 exactly on the three loci and 1
  on one division; on the per-chain path the changed rows are the chains
  that drew a Q move; where revmat rows are linked to unequal numbers of
  divisions the device tally counts the rows each proposal changed;
* under ``torch.profiler`` the span names are host events inside the
  block's interval; with the profiler off no ``record_function`` is
  entered;
* the recorder's self times, views and counters, on a stepped clock.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from mrbayes_tpu_torch import spans as S
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.mcmc.settings import McmcSettings
from mrbayes_tpu_torch.spans import SPANS
from conftest import example

torch.set_num_threads(1)

LOCI = ("charset a = 1-300", "charset b = 301-600", "charset c = 601-898",
        "partition loci = 3: a, b, c", "set partition=loci")
MODEL = ("lset applyto=(all) nst=6 rates=gamma",
         "unlink statefr=(all) revmat=(all) shape=(all)",
         "prset applyto=(all) ratepr=variable",
         "prset brlenspr=clock:uniform")


def _interpreter(tmp, loci=True, extra=()):
    it = Interpreter(log=lambda m: None, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    for cmd in (LOCI if loci else ()) + MODEL + tuple(extra):
        it.run_line(cmd)
    it.run_line("mcmcp nruns=2 nchains=2 samplefreq=50 printfreq=100 "
                f"diagnfreq=100 seed=7 swapseed=8 filename={tmp}/run")
    return it


def _run(tmp, loci=True, ngen=300):
    it = _interpreter(tmp, loci)
    it.run_line(f"mcmc ngen={ngen}")
    return it._last_runner


@pytest.fixture(scope="module")
def three_loci(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("spans3"))


def test_phase_times_keep_the_phases_and_the_spans_add_up(three_loci):
    r = three_loci
    pt = r.phase_times
    for phase in ("sample_io", "diagnostics", "checkpoint"):
        assert pt[phase] == pt[f"run.{phase}.incl_s"] > 0.0
    assert pt["device"] == pt["run.block.incl_s"] + pt["run.wait.incl_s"]
    assert pt["run.checkpoint.count"] == 300 // 50 + 1
    assert pt["mcmc.engine_build.count"] == 1
    assert pt["run.chain_start.count"] == pt["run.loop.count"] == 1
    # the loop is the wall time; inside it, every self time is counted
    # once: all self times less the two spans before the loop
    own = S.self_seconds(pt)
    inside = (sum(own.values()) - pt["mcmc.engine_build.incl_s"]
              - pt["run.chain_start.incl_s"])
    assert inside == pytest.approx(r.wall_seconds, rel=0.02)
    assert pt["run.loop.incl_s"] == pytest.approx(r.wall_seconds, rel=0.02)
    for name, v in own.items():
        assert 0.0 <= v <= pt[f"{name}.incl_s"] + 1e-12, name
    # one proposal span a generation, of the move it drew
    C = r.mc.n_chains_total
    tries = r.final_bk["tries_total"].numpy().sum(0)
    proposed = {}
    for i, mv in enumerate(r.eng.moves):
        n = pt.get(f"gen.propose.{mv.name}.count", 0)
        assert n * C == tries[i], mv.name
        proposed[mv.name] = n
    assert sum(proposed.values()) == r.generations == 300
    for name in ("gen.lnl", "gen.prior", "gen.accept", "gen.tally"):
        assert pt[f"{name}.count"] == 300, name
    # a pruner's pass a division (and the chains' start): its operands,
    # the kernel's call inside them
    assert pt["gen.lnl.launch.count"] == pt["gen.lnl.operands.count"] \
        == 3 * 301
    assert pt["gen.lnl.launch.incl_s"] <= pt["gen.lnl.operands.incl_s"]


@pytest.mark.parametrize("loci,share", [(True, Fraction(1, 3)),
                                        (False, Fraction(1))])
def test_changed_eigensystems_over_computed(three_loci, tmp_path, loci,
                                            share):
    r = three_loci if loci else _run(tmp_path, loci=False, ngen=200)
    pt = r.phase_times
    C = r.mc.n_chains_total
    n_div = r.eng.n_div
    q = [i for i, mv in enumerate(r.eng.moves) if mv.updates_q]
    q_gens = int(r.final_bk["tries_total"].numpy().sum(0)[q].sum()) // C
    assert q_gens > 0
    assert pt["eig_rows"] == q_gens * n_div * C
    assert Fraction(pt["eig_rows_changed"], pt["eig_rows"]) == share


def test_per_chain_moves_count_the_chains_that_drew_a_q_move(tmp_path):
    it = _interpreter(tmp_path)
    it.env.mcmc = McmcSettings(nruns=1, nchains=4, seed=5,
                               per_chain_moves=True)
    eng = it.build_engine()
    states, bk = eng.init_chains()
    mark = SPANS.mark()
    states, bk = eng.run_block(states, bk, 60)
    view = SPANS.since(mark)
    q = [i for i, mv in enumerate(eng.moves) if mv.updates_q]
    drew_q = int(bk["tries_total"][:, q].sum())
    assert drew_q > 0
    assert view["eig_rows_changed"] == drew_q
    assert view["eig_rows"] % (3 * 4) == 0
    assert view["eig_rows"] // 12 <= 60
    assert eng.take_eig_tally() == 0


def test_unequal_linked_rows_are_tallied_on_the_device(tmp_path):
    # revmat row 0 feeds divisions 1 and 2 (two eigensystems: their
    # frequencies are their own), row 1 division 3
    it = _interpreter(tmp_path, extra=("link revmat=(1,2)",))
    eng = it.build_engine()
    m = next(i for i, mv in enumerate(eng.moves) if mv.name == "revmat_dir")
    changed = eng._eig_rows_changed(m)
    assert torch.is_tensor(changed) and changed.tolist() == [2, 1]
    states, bk = eng.init_chains()
    C = eng.mcmc.n_chains_total
    heats = torch.ones(C)
    u = torch.rand(C, generator=bk["rng"])
    gen = bk["rng"]
    # the proposal _chain_step makes, from a copy of the generator
    twin = torch.Generator().manual_seed(0)
    twin.set_state(gen.get_state())
    cur = {k: v for k, v in states.items() if k not in ("lnL", "lnP",
                                                        "lnP_tree",
                                                        "lnP_par")}
    new, _ = eng.moves[m].fn(twin, cur, bk["tuning"][:, m])
    rows = (new["revmat"] != cur["revmat"]).any(-1).numpy()
    assert (rows.sum(1) == 1).all()
    want = int((rows * np.array([2, 1])).sum())
    mark = SPANS.mark()
    eng._chain_step(gen, states, heats, bk["tuning"][:, m], 1.0, m, u)
    view = SPANS.since(mark)
    assert view.get("eig_rows_changed", 0) == 0
    assert view["eig_rows"] == 3 * C
    assert eng.take_eig_tally() == want
    assert eng.take_eig_tally() == 0


def test_spans_are_profiler_ranges_only_while_it_records(three_loci,
                                                         monkeypatch):
    from torch.profiler import ProfilerActivity, profile, record_function
    r = three_loci
    eng = r.eng
    states, bk = r.final_states, r.final_bk
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.block"):
            states, bk = eng.run_block(states, bk, 4)
    SPANS.watch_profiler()
    events = prof.events()
    block = next(e for e in events if e.name == "test.block")
    lo, hi = block.time_range.start, block.time_range.end
    seen = {}
    for e in events:
        if e.name.startswith("gen."):
            assert lo <= e.time_range.start <= e.time_range.end <= hi
            seen[e.name] = seen.get(e.name, 0) + 1
    assert {"gen.draws", "gen.lnl", "gen.lnl.operands", "gen.lnl.launch",
            "gen.prior", "gen.accept", "gen.tally", "gen.swap"} <= set(seen)
    assert sum(n for k, n in seen.items()
               if k.startswith("gen.propose.")) == 4

    class Spy:
        entered = 0

        def __init__(self, name):
            pass

        def __enter__(self):
            Spy.entered += 1

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    states, bk = eng.run_block(states, bk, 4)
    assert not SPANS.profiling and Spy.entered == 0


def test_recorder_self_times_views_and_counters(monkeypatch):
    ticks = iter(range(0, 10 ** 6, 10))
    monkeypatch.setattr(S, "_clock", lambda: next(ticks))
    rec = S.Recorder()
    mark = rec.mark()
    with rec("outer"):              # 0 .. 50
        with rec("inner"):          # 10 .. 20
            pass
        with rec("inner"):          # 30 .. 40
            rec.add("work", 3)
    rec.add("work", 2)
    view = rec.since(mark)
    assert view == {"outer.count": 1, "outer.incl_s": 50e-9,
                    "outer.self_s": 30e-9, "inner.count": 2,
                    "inner.incl_s": 20e-9, "inner.self_s": 20e-9,
                    "work": 5}
    later = rec.mark()
    with rec("inner"):
        pass
    assert rec.since(later) == {"inner.count": 1, "inner.incl_s": 10e-9,
                                "inner.self_s": 10e-9, "work": 0}
    assert list(S.self_seconds(view)) == ["outer", "inner"]
    with pytest.raises(ValueError):
        with rec("failing"):
            raise ValueError
    assert rec.stats["failing"][0] == 1 and not rec._open
