"""The port's starting trees (``mcmc starttree=parsimony|nj``, ``nperts``,
``trees.py``'s builders and ``Engine._built_start_tree``) against the JAX
package's.

* ``perturb_nni``, ``neighbor_joining``, ``parsimony_stepwise`` and
  ``pdistance_matrix`` equal to JAX's on the same inputs and generator
  (topology exact, lengths within 1e-6);
* every chain's starting tree of the engine equal to JAX's from one seed,
  under parsimony, nj with nperts, random with nperts and the default
  (primates), and the parsimony builder over cynmix's five divisions;
* a constrained run keeps the constrained random builder (JAX's trees,
  each holding the clade)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mrbayes_tpu import trees as JT
from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.mcmc.engine import Engine as JEngine
from mrbayes_tpu_torch import trees as TT
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.envelope import CYNMIX_MODEL
from mrbayes_tpu_torch.mcmc.diagnostics import splits_of_tree
from conftest import example

torch.set_num_threads(1)

FIELDS = ("left", "right", "parent")


def _quiet(*_):
    pass


def _same_tree(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_allclose(a.blen, b.blen, atol=1e-6, rtol=0)


def _primates_masks():
    it = Interpreter(log=_quiet, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    d = it.build_engine().data.divisions[0]
    return d.patterns.astype(np.uint32), np.asarray(d.weights, np.float64)


def test_builders_equal_jax():
    masks, w = _primates_masks()
    D = TT.pdistance_matrix(masks, w)
    np.testing.assert_array_equal(D, JT.pdistance_matrix(masks, w))
    _same_tree(TT.neighbor_joining(D), JT.neighbor_joining(D))
    for seed in (1, 2, 3):
        _same_tree(TT.parsimony_stepwise(masks, w,
                                         np.random.default_rng(seed)),
                   JT.parsimony_stepwise(masks, w,
                                         np.random.default_rng(seed)))
        t = TT.random_unrooted(12, np.random.default_rng(seed))
        r1, r2 = np.random.default_rng(seed + 9), np.random.default_rng(
            seed + 9)
        a, b = TT.perturb_nni(t, 5, r1), JT.perturb_nni(t, 5, r2)
        _same_tree(a, b)
        a.check()
        assert splits_of_tree(a) != splits_of_tree(t)
        # both generators drew the same numbers
        assert r1.random() == r2.random()


# (data, model commands, mcmc settings): the engine's modes
MODES = {
    "parsimony": ("primates.nex", (), "starttree=parsimony"),
    "nj_nperts": ("primates.nex", (), "starttree=nj nperts=2"),
    "random_nperts": ("primates.nex", (), "starttree=random nperts=3"),
    "current": ("primates.nex", (), "starttree=current"),
    "constrained": ("primates.nex", ("constraint apes = 3-7",
                                     "prset topologypr=constraints(apes)"),
                    "starttree=parsimony nperts=2"),
}


def _both(name):
    data, model, mcmc = MODES[name]
    it = Interpreter(log=_quiet, device="cpu")
    jit = JInterpreter(log=_quiet)
    for c in (f"execute {example(data)}", *model,
              f"mcmcp nruns=2 nchains=2 seed=17 {mcmc}"):
        it.run_line(c)
        jit.run_line(c)
    return it.build_engine(), jit.build_engine()


def test_cynmix_parsimony_tree_equals_jax():
    """cynmix's five divisions (Mk morphology and four genes): the
    engine's parsimony builder over their concatenated patterns equals
    the JAX engine's method on the same divisions, draw by draw."""
    it = Interpreter(log=_quiet, device="cpu")
    for c in (f"execute {example('cynmix.nex')}", *CYNMIX_MODEL,
              "mcmcp starttree=parsimony"):
        it.run_line(c)
    eng = it.build_engine()
    rng, jrng = np.random.default_rng(17), np.random.default_rng(17)
    for _ in range(2):
        _same_tree(eng._built_start_tree("parsimony", rng),
                   JEngine._built_start_tree(SimpleNamespace(data=eng.data),
                                             "parsimony", jrng))


@pytest.mark.parametrize("name", list(MODES))
def test_engine_starting_trees_equal_jax(name):
    eng, jeng = _both(name)
    rng, jrng = np.random.default_rng(17), np.random.default_rng(17)
    for _ in range(eng.mcmc.n_chains_total):
        mine, theirs = eng.init_state(rng), jeng.init_state(jrng)
        for f in FIELDS:
            np.testing.assert_array_equal(mine[f], np.asarray(theirs[f]))
        np.testing.assert_allclose(mine["blen"], np.asarray(theirs["blen"]),
                                   atol=1e-6, rtol=0)
    assert rng.random() == jrng.random()
    if name == "constrained":
        states, _ = eng.init_chains()
        for slot in range(eng.mcmc.n_chains_total):
            t = eng.extract_tree(states, slot)
            assert frozenset({2, 3, 4, 5, 6}) in splits_of_tree(t)
    if name in ("parsimony", "nj_nperts"):
        # data-derived starting trees fit far better than random ones
        # (primates' random trees start near -9,000)
        states, _ = eng.init_chains()
        assert float(states["lnL"].max()) > -7500.0
