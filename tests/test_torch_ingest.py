"""The port's copies of the numpy ingest modules (nexus/, data.py,
trees.py, mcmc/settings.py) agree with the JAX package's: same taxa,
matrix and datatypes, same compressed patterns, weights and tip
partials, same trees and Newick strings."""
import dataclasses

import numpy as np
import pytest

from mrbayes_tpu import data as JD
from mrbayes_tpu import trees as JT
from mrbayes_tpu.mcmc import settings as JS
from mrbayes_tpu.nexus import parser as JP
from mrbayes_tpu_torch import data as TD
from mrbayes_tpu_torch import trees as TT
from mrbayes_tpu_torch.mcmc import settings as TS
from mrbayes_tpu_torch.nexus import parser as TP
from conftest import example

EXAMPLES = ["avian_ovomucoids.nex", "codon.nex", "cynmix.nex", "finch.nex",
            "hym.nex", "hymfossil.nex", "kim.nex", "primates.nex",
            "replicase.nex"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_nexus_and_patterns_match(name):
    a = JP.read_nexus_file(example(name))
    b = TP.read_nexus_file(example(name))
    assert a.taxa == b.taxa
    assert a.commands == b.commands
    assert [(t.name, t.newick) for t in a.trees] == \
        [(t.name, t.newick) for t in b.trees]
    if a.matrix is None:          # a batch file that executes another
        assert b.matrix is None and b.commands
        return
    np.testing.assert_array_equal(a.matrix.codes, b.matrix.codes)
    assert [d.value for d in a.matrix.col_datatype] == \
        [d.value for d in b.matrix.col_datatype]
    da, db = JD.make_divisions(a.matrix), TD.make_divisions(b.matrix)
    assert len(da) == len(db) > 0
    for x, y in zip(da, db):
        assert (x.dtype.value, x.n_states, x.name) == \
            (y.dtype.value, y.n_states, y.name)
        np.testing.assert_array_equal(x.patterns, y.patterns)
        np.testing.assert_array_equal(x.weights, y.weights)
        np.testing.assert_array_equal(x.pattern_of_char, y.pattern_of_char)
        if x.n_states:
            np.testing.assert_array_equal(x.tip_partials(),
                                          y.tip_partials())


def test_primates_compresses_to_413_patterns():
    nf = TP.read_nexus_file(example("primates.nex"))
    divs = TD.make_divisions(nf.matrix)
    assert len(divs) == 1
    assert (nf.matrix.ntax, nf.matrix.nchar) == (12, 898)
    assert divs[0].npat == 413 and divs[0].weights.sum() == 898


@pytest.mark.parametrize("n_tips", [4, 9, 12])
def test_random_trees_and_newick_round_trip(n_tips):
    taxa = [f"t{i}" for i in range(n_tips)]
    for seed in range(5):
        ta = JT.random_unrooted(n_tips, np.random.default_rng(seed))
        tb = TT.random_unrooted(n_tips, np.random.default_rng(seed))
        for f in ("parent", "left", "right", "blen"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
        nw = TT.to_newick(tb, taxa)
        assert nw == JT.to_newick(ta, taxa)
        ra, rb = JT.parse_newick(nw, taxa), TT.parse_newick(nw, taxa)
        for f in ("parent", "left", "right", "blen"):
            np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
        rb.check()
        assert TT.to_newick(rb, taxa) == nw


def test_settings_defaults_match():
    for a, b in ((JS.DivisionSettings(), TS.DivisionSettings()),
                 (JS.TreeSettings(), TS.TreeSettings()),
                 (JS.McmcSettings(), TS.McmcSettings())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert TS.McmcSettings(nruns=2, nchains=3).n_chains_total == 6
