"""The benchmark's own parts on the CPU: the work arithmetic, the
simulator, finding pieces by name, the reference and the import rule."""
from __future__ import annotations

import ast
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from phylobench import reference as R
from phylobench import registry, roofline, simulate

HERE = registry.HERE
GTR = registry.model("gtr")


def _read_codes(path: str) -> np.ndarray:
    """Codes [taxa, sites] of a non-interleaved NEXUS DNA matrix."""
    text = open(path).read()
    start = text.lower().index("matrix") + len("matrix")
    rows = [ln.split() for ln in text[start:text.index(";", start)]
            .strip().splitlines() if ln.strip()]
    table = np.full(256, 4, np.int8)
    for i, b in enumerate("ACGT"):
        table[ord(b)] = i
    return np.stack([table[np.frombuffer(r[1].encode(), np.uint8)]
                     for r in rows])


def test_down_pass_work_matches_a_hand_count():
    # 2 chains, 3 tips (2 internal nodes), 4 categories, 4 states, 10
    # patterns: 2 products a node of 2 * 4 * 4 operations, per chain,
    # category and pattern
    flops, nbytes = roofline.down_pass_work(2, 3, 4, 4, 10)
    assert flops == 2 * 2 * 4 * 10 * 2 * (2 * 4 * 4)
    assert nbytes == 4 * (2 * 2 * 2 + 2 * 2 * 2 * 4 * 16 + 3 * 4 * 10
                          + 2 * 4 * 4 * 10 + 2 * 10)


def test_likelihood_work_sums_divisions_and_picks_the_bound():
    one = roofline.likelihood_work(32, 169, 4, 4, [23000])
    two = roofline.likelihood_work(32, 169, 4, 4, [11500, 11500])
    assert one["flops"] == pytest.approx(two["flops"])
    assert one["bound_by"] == "operations"
    assert one["bound_s"] == pytest.approx(one["flops"] / 67e12)
    small = roofline.likelihood_work(1, 4, 1, 2, [1])
    assert small["bound_by"] == "bytes"


def _sim(**kw):
    sim = dict(taxa=10, sites=400, loci=3, tree_seed=7, root_height=0.3,
               rate_sd=0.3, revmat=[1, 4.5, 0.9, 1.1, 4.8, 1],
               pi=[0.29, 0.2, 0.21, 0.3], alpha=0.8, pinvar=0.15)
    sim.update(kw)
    return sim


def test_simulator_is_deterministic_by_seed_with_the_stated_shapes():
    a = simulate.simulate(_sim(), 2 ** 33 + 1)
    b = simulate.simulate(_sim(), 2 ** 33 + 1)
    c = simulate.simulate(_sim(), 5)
    assert a.shape == (10, 400) and a.dtype == np.int8
    assert a.min() >= 0 and a.max() <= 3
    assert (a == b).all() and not (a == c).all()
    # the tree and model are the configuration's, not the seed's
    p1, b1 = simulate.generating_tree(_sim())
    p2, b2 = simulate.generating_tree(_sim())
    assert (p1 == p2).all() and np.allclose(b1, b2)
    assert (p1 < 0).sum() == 1 and p1.shape == (19,)


def test_pattern_count_of_the_hackett_shape_is_recorded_and_steady():
    cfg = registry.config("hackett_gtrg_clock")
    sim = dict(cfg["simulation"], taxa=40, sites=4000)
    counts = [R.compress(simulate.simulate(sim, s))[0].shape[1]
              for s in (1, 2)]
    assert all(2000 < p < 4000 for p in counts)
    assert abs(counts[0] - counts[1]) < 0.05 * counts[0]


def test_locus_ranges_are_as_equal_as_the_sites_allow():
    r = simulate.locus_ranges(32000, 19)
    lengths = [b - a + 1 for a, b in r]
    assert sum(lengths) == 32000 and r[0][0] == 1 and r[-1][1] == 32000
    assert set(lengths) == {1684, 1685} and lengths.count(1685) == 4


def test_nexus_text_round_trips_through_the_reference_reader(tmp_path):
    codes = GTR.simulate(_sim(), 3)
    path = tmp_path / "d.nex"
    path.write_text(GTR.nexus_text(codes))
    assert (_read_codes(str(path)) == codes).all()


# ------------------------------------------------------------- registry
def test_every_entry_of_the_benchmark_is_found_by_name():
    bench = registry.benchmark()
    for c in bench["configs"]:
        assert c["file"] == f"phylobench/configs/{c['name']}.json"
        assert registry.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cfg = registry.config(w["config"])
        model = registry.model(cfg["model"]["module"])
        assert model.STATES == 4 and "revmat" in model.FIELDS
        registry.traffic(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in bench["per_layer"]:
        mod = registry.metric(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["unit"], m["layer"], m["moves"].split(".")[0])
        assert mod.NAME == m["name"].split(".")[0]
        assert mod.read({}) is None
    # every cell reports setup_s, one other end-to-end metric and the
    # per-layer metrics that move it
    for w in bench["workloads"]:
        e2e = [m["name"] for m in registry.end_to_end(w["name"], bench)]
        assert "setup_s" in e2e and len(e2e) == 2
        moved = {m["moves"] for m in registry.per_layer(w["name"], bench)}
        assert moved == set(e2e)


def test_a_new_file_is_picked_up_with_no_edit_elsewhere(tmp_path):
    here = str(tmp_path / "phylobench")
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "tests"))
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(here) for p in fs}
    cfg = registry.config("hackett_gtrg_clock", here)
    cfg["name"] = "new_config"
    with open(os.path.join(here, "configs", "new_config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "traffic", "new_mix.json"), "w") as f:
        json.dump(dict(registry.traffic("c32", here), name="new_mix"), f)
    with open(os.path.join(here, "metrics", "new_metric.py"), "w") as f:
        f.write('NAME = "new_metric"\nUNIT = "%"\nLAYER = "device"\n'
                'MOVES = "gens_per_s"\n\n\ndef read(record):\n'
                '    return record.get("x")\n')
    shutil.copy(os.path.join(here, "models", "gtr.py"),
                os.path.join(here, "models", "new_model.py"))
    assert registry.config("new_config", here)["name"] == "new_config"
    assert registry.traffic("new_mix", here)["name"] == "new_mix"
    assert registry.model("new_model", here).STATES == 4
    assert registry.metric("new_metric", here).read({"x": 3.0}) == 3.0
    # a suffix names the same reader under another end-to-end metric
    assert registry.metric("new_metric.host_paced", here).read(
        {"x": 4.0}) == 4.0
    bench = {"workloads": [{"name": "new_config.new_mix"}],
             "end_to_end": [{"name": "gens_per_s"}, {"name": "setup_s"},
                            {"name": "gens_per_s.host_paced",
                             "workloads": ["elsewhere"]}],
             "per_layer": [{"name": "new_metric", "moves": "gens_per_s"},
                           {"name": "new_metric.host_paced",
                            "moves": "gens_per_s.host_paced"},
                           {"name": "other", "moves": "gens_per_s",
                            "workloads": ["elsewhere"]}]}
    assert [m["name"] for m in registry.end_to_end("new_config.new_mix",
                                                   bench)] == [
        "gens_per_s", "setup_s"]
    assert [m["name"] for m in registry.per_layer("new_config.new_mix",
                                                  bench)] == ["new_metric"]
    for p, data in before.items():
        for dp, _, fs in os.walk(here):
            if p in fs:
                assert open(os.path.join(dp, p), "rb").read() == data


# ------------------------------------------------------------ reference
def _jc(t):
    same = 0.25 + 0.75 * math.exp(-4.0 * t / 3.0)
    diff = 0.25 - 0.25 * math.exp(-4.0 * t / 3.0)
    return np.where(np.eye(4, dtype=bool), same, diff)


def test_reference_matches_a_hand_worked_three_tip_likelihood():
    # ((0:0.1, 1:0.2)3:0.05, 2:0.3)4 under JC (equal rates and
    # frequencies), one rate category, no invariant sites
    parent = np.array([3, 3, 4, 4, -1])
    blen = np.array([0.1, 0.2, 0.3, 0.05, 0.0])
    pats = np.array([[0, 0], [0, 1], [0, 2]])      # AAA and ACG
    w = np.array([3.0, 2.0])
    pi = np.full(4, 0.25)
    P = {v: _jc(blen[v]) for v in range(4)}
    want = 0.0
    for p in range(2):
        a, b, c = pats[:, p]
        site = sum(pi[x] * P[2][x, c] * sum(P[3][x, y] * P[0][y, a]
                                             * P[1][y, b]
                                             for y in range(4))
                   for x in range(4))
        want += w[p] * math.log(site)
    data = R.Data([(pats, w, 5)], R.Precision("float64"), "cpu", 4)
    prm = [{"q": GTR.q_matrix(np.ones(6), pi), "pi": pi, "alpha": 0.5,
            "pinvar": 0.0}]
    got = R.tree_lnl(parent, blen, data, prm, None, 1)
    assert got == pytest.approx(want, abs=1e-12)


def test_reference_invariant_class_and_missing_states():
    parent = np.array([3, 3, 4, 4, -1])
    blen = np.array([0.1, 0.2, 0.3, 0.05, 0.0])
    pats = np.array([[0, 4], [0, 0], [0, 0]])      # AAA and ?AA
    data = R.Data([(pats, np.ones(2), 2)], R.Precision("float64"), "cpu",
                  4)
    pi = np.array([0.1, 0.2, 0.3, 0.4])
    base = {"q": GTR.q_matrix(np.ones(6), pi), "pi": pi, "alpha": 0.5}
    l0 = R.tree_lnl(parent, blen / 0.7, data, [dict(base, pinvar=0.0)],
                    None, 1)
    l1 = R.tree_lnl(parent, blen, data, [dict(base, pinvar=0.3)], None, 1)
    # per site: 0.7 L_var(rates / 0.7) + 0.3 pi_A, both sites constant in A
    data1 = R.Data([(pats[:, :1], np.ones(1), 1)], R.Precision("float64"),
                   "cpu", 4)
    data2 = R.Data([(pats[:, 1:], np.ones(1), 1)], R.Precision("float64"),
                   "cpu", 4)
    v1 = math.exp(R.tree_lnl(parent, blen / 0.7, data1,
                             [dict(base, pinvar=0.0)], None, 1))
    v2 = math.exp(R.tree_lnl(parent, blen / 0.7, data2,
                             [dict(base, pinvar=0.0)], None, 1))
    assert l1 == pytest.approx(math.log(0.7 * v1 + 0.3 * 0.1)
                               + math.log(0.7 * v2 + 0.3 * 0.1), abs=1e-12)
    assert l0 == pytest.approx(math.log(v1) + math.log(v2), abs=1e-12)


def test_splits_of_a_state_and_of_its_newick_agree():
    parent = np.array([5, 5, 6, 6, 7, 8, 7, 8, -1])
    blen = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.0, 9.9])
    e = R.splits(parent, blen, 5)
    # the root's two edges are one; its own length is no branch
    assert len(e) == 2 * 5 - 3
    assert sum(e.values()) == pytest.approx(blen[:8].sum())
    nw = "(1:0.6,(2:0.2,(4:0.4,3:0.3):0.7):0.0,5:0.5);"
    got = R.newick_splits(nw, 5)
    assert set(got) == {0b00010, 0b01100, 0b01110, 0b00100, 0b01000,
                        0b10000, 0b11110}


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12,
                      1.0 + 2 ** -12], dtype=torch.float32)
    y = R.to_tf32(x)
    assert y.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0]


def test_clock_prior_is_the_uniform_ages_and_the_root_age_prior():
    parent = np.array([3, 3, 4, 4, -1])
    age = np.array([0.0, 0.0, 0.0, 0.2, 0.5])
    spec = {"tree": "clock", "clock": ["uniform"],
            "treeage": ["gamma", 1.0, 1.0]}
    n = 3
    want = ((n - 1) * math.log(2) - math.lgamma(n + 1) - math.log(n - 1)
            - (n - 2) * math.log(0.5) - 0.5)
    got = R.tree_lnprior(parent, R.clock_blens(parent, age), age, spec)
    assert got == pytest.approx(want, abs=1e-12)
    bad = age.copy()
    bad[3] = 0.7
    assert R.tree_lnprior(parent, None, bad, spec) == -math.inf


# --------------------------------------------------------------- imports
def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for dp, _, fs in os.walk(HERE):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(dp, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "mrbayes_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    models = [os.path.join("models", f) for f in
              os.listdir(os.path.join(HERE, "models")) if f.endswith(".py")]
    assert models
    for name in ["reference.py", "simulate.py", "roofline.py"] + models:
        names = set(_imports(os.path.join(HERE, name)))
        assert "mrbayes_tpu_torch" not in names, name
