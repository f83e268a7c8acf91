"""The port's Engine against the JAX Engine on primates GTR+I+G, 4 chains.

* at identical states (JAX ``init_chains`` carried over with
  ``state_from_numpy``, then per-chain random substitution parameters):
  lnL within 5e-3 absolute (float32 sums of about 6e3 over 413 patterns
  taken in a different order) and lnPrior within 1e-4;
* after ``run_block``, the carried lnL, lnP_tree and lnP_par equal exact
  recomputes (the MB_DEBUG_LNL check of mrbayes_tpu/mcmc/run.py, with the
  tolerance scaled by |lnP|);
* swap-try totals equal generations x nswaps x runs
  (tests/test_observability.py);
* a 100-generation 1-chain run reaches lnL > -8500 (bench.py) and climbs
  from its start.

One engine per configuration is built per module (fixtures), so the file
stays cheap in the tier-1 run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.data import DataSet as JDataSet
from mrbayes_tpu.data import make_divisions as j_make_divisions
from mrbayes_tpu.mcmc.engine import Engine as JEngine
from mrbayes_tpu.mcmc.settings import DivisionSettings as JDiv
from mrbayes_tpu.mcmc.settings import McmcSettings as JMcmc
from mrbayes_tpu.nexus.parser import read_nexus_file as j_read
from mrbayes_tpu_torch.convert import (bookkeeping_from_numpy,
                                       state_from_numpy, state_to_numpy)
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.mcmc.engine import Engine
from mrbayes_tpu_torch.mcmc.settings import DivisionSettings, McmcSettings
from mrbayes_tpu_torch.nexus.parser import read_nexus_file
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset():
    nf = read_nexus_file(example("primates.nex"))
    return DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                   divisions=make_divisions(nf.matrix))


@pytest.fixture(scope="module")
def jax_chains():
    nf = j_read(example("primates.nex"))
    ds = JDataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                  divisions=j_make_divisions(nf.matrix))
    eng = JEngine(ds, [JDiv(nst="6", rates="invgamma")],
                  mcmc=JMcmc(nruns=1, nchains=4, seed=3))
    states, bk = eng.init_chains(seed=3)
    # per-chain random substitution parameters (numpy, from a seed)
    rng = np.random.default_rng(8)
    st = {k: np.asarray(v) for k, v in states.items()}
    st["pi"] = rng.dirichlet(np.ones(4) * 5, size=(4, 1)).astype(np.float32)
    st["revmat"] = rng.dirichlet(np.ones(6) * 2, size=(4, 1)).astype(
        np.float32)
    st["shape"] = rng.uniform(0.2, 2.0, size=(4, 1)).astype(np.float32)
    st["pinvar"] = rng.uniform(0.05, 0.5, size=(4, 1)).astype(np.float32)
    jst = jax.vmap(eng.refresh_eigs)({k: jnp.asarray(v)
                                      for k, v in st.items()})
    lnL = np.asarray(jax.vmap(eng.log_likelihood)(jst))
    lnP = np.asarray(jax.vmap(eng.log_prior)(jst))
    return ({k: np.asarray(v) for k, v in jst.items()}, lnL, lnP,
            {k: np.asarray(v) for k, v in bk.items()})


def _port_engine(dataset, nchains=4, nruns=1, **kw):
    return Engine(dataset, [DivisionSettings(nst="6", rates="invgamma")],
                  mcmc=McmcSettings(nruns=nruns, nchains=nchains, seed=3,
                                    **kw), device="cpu")


@pytest.fixture(scope="module")
def engine(dataset):
    """The 4-chain engine the tests share (engines hold no chain state)."""
    return _port_engine(dataset)


def test_scores_match_jax_at_identical_states(engine, jax_chains):
    jst, lnL, lnP, _ = jax_chains
    eng = engine
    st = state_from_numpy(jst, "cpu")
    assert st["left"].dtype == torch.int64 and st["blen"].dtype == \
        torch.float32
    # identical states: the JAX eigensystem cache (eigL0/eigU0/eigV0) is
    # part of the state and carried over
    np.testing.assert_allclose(eng.log_likelihood(st).numpy(), lnL,
                               atol=5e-3, rtol=0)
    # with the port's own float32 Jacobi eigensystems instead: the two
    # solvers round differently (about 5e-7 in P(t)), and a sum over 898
    # sites turns that into about 1e-2 of lnL; either solver's float32
    # eigensystem lies up to about 3e-2 from a float64 one on random GTR
    # states.  P(t) itself is held at 2e-6 in test_torch_models.py.
    own = eng.refresh_eigs({k: v for k, v in st.items()
                            if not k.startswith("eig")})
    np.testing.assert_allclose(eng.log_likelihood(own).numpy(), lnL,
                               atol=5e-2, rtol=0)
    np.testing.assert_allclose(eng.log_prior(st).numpy(), lnP, atol=1e-4,
                               rtol=0)
    back = state_to_numpy(st)
    for k, v in jst.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_same_starting_trees_as_jax(engine, jax_chains):
    """init_chains draws the JAX package's starting trees (same numpy
    generator sequence) and default parameters."""
    jst, _, _, _ = jax_chains
    states, _ = engine.init_chains(seed=3)
    for k in ("left", "right", "parent", "blen"):
        np.testing.assert_array_equal(states[k].numpy(), jst[k])
    assert (states["shape"] == 0.5).all() and (states["pinvar"] == 0.1).all()


def _assert_carried_equals_recomputed(eng, states):
    fresh = eng.score(states)
    for k in ("lnL", "lnP_tree", "lnP_par", "lnP"):
        a, b = states[k].numpy(), fresh[k].numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-3 + 1e-6 * np.abs(b).max())


def test_run_block_from_jax_bookkeeping(engine, jax_chains):
    """A run continues from the JAX engine's state and bookkeeping."""
    jst, lnL, lnP, jbk = jax_chains
    eng = engine
    states = eng.score(state_from_numpy(jst, "cpu"))
    bk = bookkeeping_from_numpy(jbk, "cpu")
    states, bk = eng.run_block(states, bk, 60)
    assert bk["gen"] == 60
    assert int(bk["tries_total"].sum()) == 4 * 60
    _assert_carried_equals_recomputed(eng, states)


def test_carried_scores_equal_recompute_after_run_block(engine):
    eng = engine
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 100)
    _assert_carried_equals_recomputed(eng, states)
    assert int(bk["accepts_total"].sum()) > 0
    # every move was tuned once at generation 100
    assert bk["batch"] == 1 and int(bk["tries"].sum()) == 0


def test_swap_try_totals(dataset):
    eng = _port_engine(dataset, nchains=3, nruns=2, nswaps=2)
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 30)
    assert int(bk["swap_tries"].sum()) == 30 * 2 * 2
    assert (bk["swap_accepts"] <= bk["swap_tries"]).all()
    tid = bk["temp_id"].reshape(2, 3).sort(1).values
    assert (tid == torch.arange(3)).all()          # still a permutation
    assert len(eng.cold_indices(bk)) == 2
    _assert_carried_equals_recomputed(eng, states)


def test_500_generations_reach_the_posterior(dataset):
    eng = _port_engine(dataset, nchains=1)
    states, bk = eng.init_chains()
    start = float(states["lnL"][0])
    states, bk = eng.run_block(states, bk, 100)
    assert float(states["lnL"].max()) > -8500.0
    assert float(states["lnL"][0]) > start + 100.0
    assert torch.isfinite(states["lnL"]).all()
    tree = eng.extract_tree(states, eng.cold_indices(bk)[0])
    tree.check()


def test_entry_point_defaults_to_cuda(dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(dataset, [DivisionSettings(nst="6", rates="invgamma")])


@pytest.mark.parametrize("kw", [dict(rates="kmixture"), dict(rates="lnorm"),
                                dict(parsmodel=True),
                                dict(rates="adgamma")])
def test_settings_outside_the_slice_raise(dataset, kw):
    """Settings the port refused until ROADMAP Queue 1 item 13c came: the
    engine now takes each, and its lnL (JAX's eigensystems carried over)
    and lnPrior equal the JAX engine's at identical states."""
    eng = Engine(dataset, [DivisionSettings(**kw)],
                 mcmc=McmcSettings(nruns=1, nchains=3, seed=3), device="cpu")
    nf = j_read(example("primates.nex"))
    jeng = JEngine(JDataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                            divisions=j_make_divisions(nf.matrix)),
                   [JDiv(**kw)], mcmc=JMcmc(nruns=1, nchains=3, seed=3))
    states, _ = eng.init_chains()
    st = {k: v for k, v in state_to_numpy(states).items()
          if k not in ("lnL", "lnP", "lnP_tree", "lnP_par")
          and not k.startswith("eig")}
    rng = np.random.default_rng(4)
    for k, hi in (("shape", 2.0), ("ratecorr", 0.9)):
        if k in st:
            st[k] = rng.uniform(-hi if k == "ratecorr" else 0.2, hi,
                                st[k].shape).astype(np.float32)
    jst = {k: np.asarray(v) for k, v in
           jax.jit(jax.vmap(jeng.refresh_eigs))(st).items()}
    lnL = np.asarray(jax.jit(jax.vmap(jeng.log_likelihood))(jst))
    lnP = np.asarray(jax.jit(jax.vmap(jeng.log_prior))(jst))
    tst = state_from_numpy(jst, "cpu")
    np.testing.assert_allclose(eng.log_likelihood(tst).numpy(), lnL,
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(eng.log_prior(tst).numpy(), lnP, atol=1e-4,
                               rtol=0)
