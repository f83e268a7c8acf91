"""A whole run on the CPU at a tiny size, past the harness's look for a
card: sound, it is correct; with the timed path broken underneath, it is
not.  The faults are those a run of this benchmark can have: a step that
returns its state unchanged, half of the chains left out with the mean of
the rest in their place, and every chain's likelihood altered where it
is produced.
(The exchange between cards is not one: every cell runs on one card.)
The control, the reference in TF32 in the program's place, comes out not
correct through the harness's own comparison, and is held against the
limit at the cells' own data size."""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from phylobench import cell, check, control, registry, simulate
from phylobench import reference as R

CELLS = ("hackett_gtrg_clock.c32", "hackett_part19_gtrg_clock.c16")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark's files at 12 taxa x 600 sites, 2 runs x 2
    chains, blocks of 10 generations."""
    here = str(tmp_path_factory.mktemp("tiny"))
    for sub in ("metrics", "configs", "traffic", "models"):
        shutil.copytree(os.path.join(registry.HERE, sub),
                        os.path.join(here, sub))
    bench = registry.benchmark()
    for w in bench["workloads"]:
        c = registry.config(w["config"], here)
        c["simulation"].update(taxa=12, sites=600, loci=3)
        if c["reference"]["divisions"] == "loci":
            names = [f"locus{i + 1}" for i in range(3)]
            cmds = [f"charset {n} = {a}-{b}" for n, (a, b) in
                    zip(names, simulate.locus_ranges(600, 3))]
            cmds.append("partition loci = 3: " + ", ".join(names))
            c["commands"] = cmds + [x for x in c["commands"]
                                    if not x.startswith(("charset",
                                                         "partition"))]
        with open(os.path.join(here, "configs", c["name"] + ".json"),
                  "w") as f:
            json.dump(c, f)
        m = registry.traffic(w["traffic"], here)
        m["mcmcp"].update(nruns=2, nchains=2, samplefreq=10, printfreq=10,
                          diagnfreq=20)
        m.update(warmup_gens=10, trace_gens=20)
        with open(os.path.join(here, "traffic", m["name"] + ".json"),
                  "w") as f:
            json.dump(m, f)
    return here, bench


def _run(tiny, workload, trace_on=False, seed=2 ** 33 + 17):
    here, bench = tiny
    return cell.execute(workload, seed, 0.5, trace_on, "cpu",
                        time.perf_counter(), bench=bench, here=here,
                        log=lambda m: None)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace_on", (False, True))
def test_a_sound_run_is_correct(tiny, workload, trace_on):
    out = _run(tiny, workload, trace_on)
    assert out["correct"], out["compared"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    names = set(out["metrics"])
    bench = tiny[1]
    if trace_on:
        want = {m["name"] for m in registry.per_layer(workload, bench)}
        assert {"driver_share", "driver_share.host_paced"} & names
        assert names <= want and not names & {"gens_per_s", "setup_s"}
        assert out["device"]["window_s"] > 0
    else:
        want = {m["name"] for m in registry.end_to_end(workload, bench)}
        assert names == want and "setup_s" in names and len(names) == 2


def _unchanged(orig):
    def step(self, gen, state, *args, **kwargs):
        out, accepted = orig(self, gen, state, *args, **kwargs)
        return state, torch.zeros_like(accepted)
    return step


def _half_left_out(orig):
    def lnl(self, state):
        out = orig(self, state)
        half = out.shape[0] // 2
        return torch.cat([out[:half],
                          out[:half].mean().expand(out.shape[0] - half)])
    return lnl


def _altered(orig):
    """One pattern's share left out of every chain's lnL: an off-by-one
    in the sum over patterns."""
    def lnl(self, state):
        n_pat = sum(int(w.shape[0]) for w in self.weights)
        return orig(self, state) * (1.0 - 1.0 / n_pat)
    return lnl


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault,attr,number", [
    (_unchanged, "_chain_step", "not_climbed"),
    (_half_left_out, "log_likelihood", "lnpost_rel_gap_q3"),
    (_altered, "log_likelihood", "lnpost_rel_gap_q3"),
])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, workload,
                                            fault, attr, number):
    from mrbayes_tpu_torch.mcmc.engine import Engine
    monkeypatch.setattr(Engine, attr, fault(getattr(Engine, attr)))
    out = _run(tiny, workload)
    assert not out["correct"]
    c = out["compared"][number]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_fails_at_the_cells_data_size(workload):
    """The reference in TF32 in the program's place, on two chains'
    states drawn as the program's are (random trees, default parameters)
    on the cell's whole simulated alignment: its gap to the float64
    reference passes the limit."""
    bench = registry.benchmark()
    w = registry.workload(workload, bench)
    cfg = registry.config(w["config"])
    model = registry.model(cfg["model"]["module"])
    codes = model.simulate(cfg["simulation"], 11)
    divs = R.divisions(codes, cell.division_ranges(cfg, codes.shape[1]))
    f64 = R.Data(divs, R.Precision("float64"), "cpu", model.STATES)
    tf32 = R.Data(divs, R.Precision("tf32"), "cpu", model.STATES)
    rng = np.random.default_rng(4)
    n_div, n = len(divs), codes.shape[0]
    gaps = []
    for _ in range(2):
        parent, blen = simulate.yule_tree(n, rng)
        blen = blen * 0.3
        params = []
        for _ in range(n_div):
            revmat, pi = rng.dirichlet(np.ones(6)), rng.dirichlet(
                np.ones(4) * 20)
            params.append({"q": model.q_matrix(revmat, pi), "pi": pi,
                           "alpha": 0.8, "pinvar": 0.0})
        rm = None if n_div == 1 else f64.sites / f64.sites.sum()
        a = R.tree_lnl(parent, blen, f64, params, rm, 4)
        b = R.tree_lnl(parent, blen, tf32, params, rm, 4)
        gaps.append(abs(a - b) / abs(a))
    assert min(gaps) > cfg["limits"]["lnpost_rel_gap_q3"], gaps


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(tiny, workload):
    """``control.readings`` on a whole tiny run: the program is correct;
    the TF32 reference, put in its place, is not, by the harness's own
    ``check.compare``; so is an answer altered by 16 patterns' share in
    one run's chains alone."""
    here, bench = tiny
    out = control.readings(workload, 2 ** 33 + 29, 0.5, "cpu", bench,
                           here, log=lambda m: None)
    assert out["program"]["correct"], out["program"]
    assert out["float32"]["correct"], out["float32"]
    assert not out["tf32"]["correct"]
    assert (out["tf32"]["numbers"]["lnpost_rel_gap_q3"]
            > out["program"]["numbers"]["lnpost_rel_gap_q3"])
    assert not out["altered_16_one_run"]["correct"]
    assert not out["altered_16"]["correct"]


def test_compare_reads_the_sample_files_columns():
    st = {"parent": np.array([[3, 3, 4, 4, -1]]),
          "age": np.array([[0.0, 0.0, 0.0, 0.2, 0.5]], np.float32),
          "revmat": np.full((1, 1, 6), 1 / 6, np.float32),
          "pi": np.full((1, 1, 4), 0.25, np.float32),
          "shape": np.array([[0.5]], np.float32),
          "pinvar": np.array([[0.1]], np.float32),
          "lnL": np.array([-10.0], np.float32),
          "lnP": np.array([-2.0], np.float32)}
    cols = check.expected_columns(st, 0, np.array([5.0]),
                                  registry.model("gtr"))
    assert cols["TL"] == pytest.approx(0.2 + 0.2 + 0.5 + 0.3)
    assert cols["TH"] == pytest.approx(0.5)
    assert {"r(A<->C)", "pi(T)", "alpha", "pinvar"} <= set(cols)
