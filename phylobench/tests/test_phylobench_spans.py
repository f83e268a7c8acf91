"""The readers of the program's spans and counters, on hand-made records:
each turns the timed window's ``phase_times`` into the value worked out
by hand, declares the entry's unit, layer and end-to-end metric, and
reads nothing (None) where the program keeps no such span."""
from __future__ import annotations

import pytest

from phylobench import registry

NEW = ("window_build_share", "window_build_share.host_paced",
       "propose_self_share.host_paced", "eigs_self_share.host_paced",
       "loglik_span_share.host_paced", "eigs_useful_share.host_paced")

# a timed window of 50 s whose runner ran 48 s
RECORD = {"timed": {"gens": 800, "wall_s": 50.0, "runner_wall_s": 48.0,
                    "phase_times": {
                        "device": 40.0, "sample_io": 0.1,
                        "diagnostics": 0.2, "checkpoint": 0.05,
                        "mcmc.engine_build.count": 1,
                        "mcmc.engine_build.incl_s": 1.5,
                        "mcmc.engine_build.self_s": 1.25,
                        "gen.propose.nni_clock.count": 300,
                        "gen.propose.nni_clock.incl_s": 2.0,
                        "gen.propose.nni_clock.self_s": 2.0,
                        "gen.propose.revmat_dir.count": 80,
                        "gen.propose.revmat_dir.incl_s": 0.4,
                        "gen.propose.revmat_dir.self_s": 0.4,
                        "gen.eigs.count": 160,
                        "gen.eigs.incl_s": 7.2,
                        "gen.eigs.self_s": 6.0,
                        "gen.lnl.count": 800,
                        "gen.lnl.incl_s": 19.2,
                        "gen.lnl.self_s": 3.0,
                        "eig_rows": 48640, "eig_rows_changed": 2560}}}

HAND = {"window_build_share": 100 * 1.25 / 50.0,
        "propose_self_share": 100 * 2.4 / 48.0,
        "eigs_self_share": 100 * 6.0 / 48.0,
        "loglik_span_share": 100 * 19.2 / 48.0,
        "eigs_useful_share": 100 / 19}


def _entry(name):
    return next(m for m in registry.benchmark()["per_layer"]
                if m["name"] == name)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_the_hand_worked_value(name):
    m = _entry(name)
    mod = registry.metric(name)
    base = name.split(".")[0]
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
        base, m["unit"], m["layer"], m["moves"].split(".")[0])
    assert m["source"] == "program_span"
    assert mod.read(RECORD) == pytest.approx(HAND[base], rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_without_the_spans(name):
    mod = registry.metric(name)
    assert mod.read({}) is None
    # a program without the spans keeps the four phases alone
    old = {"timed": {"gens": 800, "wall_s": 50.0, "runner_wall_s": 48.0,
                     "phase_times": {"device": 40.0, "sample_io": 0.1,
                                     "diagnostics": 0.2,
                                     "checkpoint": 0.05}}}
    assert mod.read(old) is None


def test_new_entries_are_appended_to_the_cells_they_name():
    bench = registry.benchmark()
    names = [m["name"] for m in bench["per_layer"]]
    assert tuple(names[-len(NEW):]) == NEW
    c32, c16 = (w["name"] for w in bench["workloads"])
    assert _entry("window_build_share")["workloads"] == [c32]
    for name in NEW[1:]:
        assert _entry(name)["workloads"] == [c16]
    assert _entry("eigs_useful_share.host_paced")["better"] == "higher"
