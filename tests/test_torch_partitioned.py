"""The port's partitioned engine against the JAX package's, on test1.

test1 (``tests/data/ref/testing/test1.nex``) is primates.nex in two
partitions under nst=mixed rates=invgamma with every substitution
parameter unlinked and ratepr=variable.  Both packages' CLIs build the
engine from the same commands (2 runs x 2 chains here).  At identical
states (JAX starting trees plus per-chain random submodels,
exchangeabilities, frequencies, shapes, pinvars and rate multipliers,
carried into the port by ``convert.py``):

* lnL within 5e-3 with the JAX eigensystem cache carried over, and within
  5e-2 with the port's own float32 eigensystems (the gap measured on primates,
  ROADMAP Queue 3); lnPrior within 1e-4;
* the port's grouped (multiwalk) lnL equals its per-division lnL within
  1e-3 (float32 sums of the same per-pattern terms);
* after a short ``run_block`` from those states, the carried lnL/lnP
  components equal exact recomputes and every submodel stays valid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy, state_to_numpy
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

C = 4


def _test1_commands():
    return [f"execute {example('primates.nex')}",
            "partition test = 2: 1-400, 401-.",
            "set partition=test",
            "lset applyto=(all) nst=mixed rates=invgamma",
            "unlink statefreq=(all) revmat=(all) pinvar=(all) shape=(all)",
            "prset applyto=(all) ratepr=variable",
            "mcmcp nruns=2 nchains=2 seed=5"]


def _random_submodel(rng):
    z = np.zeros(6, np.int32)
    for i in range(1, 6):
        z[i] = rng.integers(0, z[:i].max() + 2)
    k = z.max() + 1
    props = rng.dirichlet(np.ones(k) * 4.0)
    return z, (props / np.bincount(z, minlength=k))[z].astype(np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """JAX engine, identical random states and their JAX scores."""
    it = JInterpreter(log=lambda m: None)
    for c in _test1_commands():
        it.run_line(c)
    eng = it.build_engine()
    rng = np.random.default_rng(5)
    per = [eng.init_state(rng) for _ in range(C)]
    st = {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]}
    zs = [[_random_submodel(rng) for _ in range(2)] for _ in range(C)]
    st["gtr_class"] = np.array([[z for z, _ in row] for row in zs], np.int32)
    st["revmat"] = np.array([[v for _, v in row] for row in zs], np.float32)
    st["pi"] = rng.dirichlet(np.ones(4) * 5, size=(C, 2)).astype(np.float32)
    st["shape"] = rng.uniform(0.2, 2.0, (C, 2)).astype(np.float32)
    st["pinvar"] = rng.uniform(0.05, 0.5, (C, 2)).astype(np.float32)
    st["ratemult"] = rng.dirichlet(np.ones(2) * 5, size=C).astype(np.float32)

    @jax.jit
    def scores(s):
        s = jax.vmap(eng.refresh_eigs)(s)
        return (s, jax.vmap(eng.log_likelihood)(s),
                jax.vmap(eng.log_prior)(s))

    jst, lnL, lnP = scores({k: jnp.asarray(v) for k, v in st.items()})
    return ({k: np.asarray(v) for k, v in jst.items()}, np.asarray(lnL),
            np.asarray(lnP), eng)


@pytest.fixture(scope="module")
def port_engines():
    """The port's test1 engine with the multiwalk switch on and off."""
    it = Interpreter(log=lambda m: None, device="cpu")
    for c in _test1_commands():
        it.run_line(c)
    return {sw: it.build_engine(multiwalk=sw) for sw in (True, False)}


def test_engines_agree_on_structure(jax_side, port_engines):
    jeng = jax_side[3]
    for eng in port_engines.values():
        assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
        assert eng.n_groups == jeng.n_groups
        assert eng._mixed_rev == jeng._mixed_rev == {0, 1}
        np.testing.assert_allclose(eng.div_char_frac, jeng.div_char_frac)
        assert [m.updates_q for m in eng.moves] == \
            [m.updates_q for m in jeng.moves]
        assert [m.prior_scope for m in eng.moves] == \
            [m.prior_scope for m in jeng.moves]
    # the port groups test1's two divisions (199 and 258 patterns) into
    # one launch; JAX's padded-width buckets (256, 384) would not
    assert [g for g, _ in port_engines[True]._multiwalk_pruners] == [[0, 1]]
    assert port_engines[False]._multiwalk_pruners == []
    assert [c.div.npat for c in jeng.div_cfg] == [199, 258]


@pytest.mark.parametrize("multiwalk", [True, False],
                         ids=["multiwalk", "per_division"])
def test_scores_match_jax_at_identical_states(jax_side, port_engines,
                                              multiwalk):
    jst, lnL, lnP, _ = jax_side
    eng = port_engines[multiwalk]
    st = state_from_numpy(jst, "cpu")
    assert st["gtr_class"].dtype == torch.int64
    np.testing.assert_allclose(eng.log_likelihood(st).numpy(), lnL,
                               atol=5e-3, rtol=0)
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


def test_grouped_lnl_equals_per_division_lnl(jax_side, port_engines):
    st = port_engines[True].refresh_eigs(state_from_numpy(
        {k: v for k, v in jax_side[0].items() if not k.startswith("eig")},
        "cpu"))
    a = port_engines[True].log_likelihood(st).numpy()
    b = port_engines[False].log_likelihood(st).numpy()
    np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


def test_carried_equals_recomputed_after_run_block(jax_side, port_engines):
    eng = port_engines[True]
    states = eng.score(state_from_numpy(jax_side[0], "cpu"))
    states, bk = eng.run_block(states, eng.init_bookkeeping(5), 40)
    assert bk["gen"] == 40 and int(bk["tries_total"].sum()) == C * 40
    fresh = eng.score(states)
    for k in ("lnL", "lnP_tree", "lnP_par", "lnP"):
        a, b = states[k].numpy(), fresh[k].numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-3 + 1e-6 * np.abs(b).max())
    # every chain's submodel is still a restricted-growth string with
    # equal exchangeabilities within each class
    z, v = states["gtr_class"].numpy(), states["revmat"].numpy()
    for zc, vc in zip(z.reshape(-1, 6), v.reshape(-1, 6)):
        assert zc[0] == 0 and all(zc[i] <= zc[:i].max() + 1
                                  for i in range(1, 6))
        for cls in np.unique(zc):
            np.testing.assert_allclose(vc[zc == cls], vc[zc == cls][0],
                                       rtol=1e-5)


def test_switch_is_read_once_when_the_engine_is_built(monkeypatch):
    """MB_TPU_MULTIWALK keeps its JAX meaning and default (off), and is
    read when the engine is built, not when it runs."""
    it = Interpreter(log=lambda m: None, device="cpu")
    for c in _test1_commands():
        it.run_line(c)
    monkeypatch.delenv("MB_TPU_MULTIWALK", raising=False)
    assert it.build_engine()._multiwalk_pruners == []
    monkeypatch.setenv("MB_TPU_MULTIWALK", "1")
    eng = it.build_engine()
    monkeypatch.setenv("MB_TPU_MULTIWALK", "0")
    assert eng.multiwalk and len(eng._multiwalk_pruners) == 1
    assert it.build_engine(multiwalk=True)._multiwalk_pruners
