"""The port's steppingstone sampling (``mcmc/steppingstone.py``) against
the JAX package's.

* ``beta_ladder`` equal to JAX's;
* a run killed mid-ladder and resumed from its checkpoint gives the lnZ of
  an uninterrupted run within 2e-3, with every step's row in the .ss file
  (``tests/test_ss_resume.py`` restated for the port);
* each .ss contribution equals the one recomputed from the cold chain's
  sampled lnL within 1e-6;
* ``sumss`` of one .ss file prints and returns what JAX's does;
* a block at power 0 samples the prior: the cold chain's mean tree length
  within 4 batch-means standard errors of the prior mean."""
import numpy as np
import pytest
import torch

from mrbayes_tpu.mcmc.steppingstone import beta_ladder as j_beta_ladder
from mrbayes_tpu.mcmc.steppingstone import sumss as j_sumss
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.mcmc.steppingstone import (SsRunner, beta_ladder,
                                                  step_contribution, sumss)
from conftest import example

torch.set_num_threads(1)


class _Killed(Exception):
    pass


def _quiet(*_):
    pass


def _engine(append=False, extra=()):
    it = Interpreter(log=_quiet, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    it.run_line("lset nst=1 rates=equal")
    for c in extra:
        it.run_line(c)
    it.run_line(f"mcmcp ngen=160 nruns=1 nchains=1 samplefreq=10 "
                f"printfreq=1000 checkfreq=10 "
                f"append={'yes' if append else 'no'} seed=99 swapseed=98")
    return it.build_engine()


@pytest.mark.parametrize("nsteps,alpha", [(4, 0.4), (50, 0.4), (7, 0.3)])
def test_beta_ladder_equals_jax(nsteps, alpha):
    np.testing.assert_array_equal(beta_ladder(nsteps, alpha),
                                  j_beta_ladder(nsteps, alpha))


def test_ss_resume_matches_uninterrupted(tmp_path):
    a = SsRunner(_engine(), nsteps=4, burninss=-1, log=_quiet,
                 file_prefix=str(tmp_path / "full"))
    lnZ_full = a.run_ss()

    # the interrupted run dies after its 6th sample (mid-step)
    b = SsRunner(_engine(), nsteps=4, burninss=-1, log=_quiet,
                 file_prefix=str(tmp_path / "part"))
    orig = b._write_sample
    n = {"c": 0}

    def dying(gen, host):
        orig(gen, host)
        n["c"] += 1
        if n["c"] >= 6:
            raise _Killed()

    b._write_sample = dying
    with pytest.raises(_Killed):
        b.run_ss()

    logs = []
    c = SsRunner(_engine(append=True), nsteps=4, burninss=-1,
                 log=logs.append, file_prefix=str(tmp_path / "part"))
    lnZ_res = c.run_ss()
    assert any("Resuming steppingstone" in ln for ln in logs)
    np.testing.assert_allclose(lnZ_res, lnZ_full, atol=2e-3)
    with open(tmp_path / "full.ss") as f:
        rows_full = [ln for ln in f if ln[0].isdigit()]
    with open(tmp_path / "part.ss") as f:
        rows_res = [ln for ln in f if ln[0].isdigit()]
    assert len(rows_full) == len(rows_res) == 4


def test_ss_file_contributions_and_sumss_equal_jax(tmp_path):
    prefix = str(tmp_path / "ss")
    run = SsRunner(_engine(), nsteps=4, burninss=0, log=_quiet,
                   file_prefix=prefix)
    # the sampled lnL, 4 samples a step: the cold chain's, as each sample
    # is written (the .p rows round it to 7 digits)
    lnl = []
    orig = run._write_sample

    def record(gen, host):
        lnl.append(float(host["lnL"][run.eng.cold_indices(host)[0]]))
        orig(gen, host)

    run._write_sample = record
    lnZ = run.run_ss()
    lnl = np.array(lnl).reshape(4, 4)
    betas = beta_ladder(4)
    with open(prefix + ".ss") as f:
        rows = [ln.split() for ln in f if ln[:1].isdigit()]
    assert [int(r[0]) for r in rows] == [1, 2, 3, 4]
    for k, r in enumerate(rows):
        want = step_contribution(betas[k] - betas[k + 1], lnl[k])
        assert abs(float(r[3]) - want) < 1e-6
        assert abs(float(r[1]) - betas[k + 1]) < 1e-6
    assert np.isfinite(lnZ).all() and lnZ[0] < lnl.max()
    mine, theirs = [], []
    out = sumss(prefix, log=mine.append)
    j_out = j_sumss(prefix, log=theirs.append)
    assert mine == theirs
    assert out == j_out
    assert abs(out["lnZ"] - lnZ[0]) < 1e-5


def test_power_zero_block_samples_the_prior():
    """At power 0 the likelihood drops out of every acceptance ratio: the
    cold chain's tree length follows the branch-length prior, here
    exponential(10) on each of primates' 21 branches (mean 2.1)."""
    eng = _engine(extra=["prset brlenspr=unconstrained:exp(10)"])
    states, bk = eng.init_chains()
    bk = {**bk, "power": 0.0}
    states, bk = eng.run_block(states, bk, 200)
    tls = []
    for _ in range(300):
        states, bk = eng.run_block(states, bk, 5)
        tls.append(float(eng.branch_lengths(states)[0][
            eng._blen_mask].sum()))
    tls = np.array(tls)
    means = tls.reshape(20, -1).mean(1)
    se = means.std(ddof=1) / np.sqrt(len(means))
    assert abs(tls.mean() - 21 / 10.0) < 4 * se, (tls.mean(), se)
