"""Unlinked trees in the port against the JAX package (restating
``tests/test_unlinked.py``): ``unlink topology=(all) brlens=(all)`` gives
each link group its own tree (reference DoLink/DoUnlink src/model.c:2799;
one tree parameter an unlinked group, :19026; .t files named
<file>.tree<i>.run<r>.t, src/mcmc.c:10510).

* two partitions give two trees, ``div_tree`` [0, 1] and the
  [runs x chains, 2, 2n - 1] tree layout, with the JAX package's moves
  (names, weights, prior scopes);
* lnL is the sum of single-division engines on each division's tree
  within 1e-3, and within 5e-2 of the JAX engine's at identical states
  (float32 through each side's own eigensystem), lnPrior within 1e-4;
* a 200-generation block keeps every posterior finite, the carried scores
  equal a recompute and the two trees apart;
* the CLI end to end: ``.tree1``/``.tree2`` ``.t`` files, one ``.con.tre``
  a tree from sumt, and ``TL{1}``/``TL{2}`` in the JAX package's ``.p``
  header;
* a clock with unlinked trees raises as the JAX engine does."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.data import DataSet as JDataSet
from mrbayes_tpu.data import make_divisions as j_make_divisions
from mrbayes_tpu.mcmc.engine import Engine as JEngine
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.mcmc.settings import DivisionSettings as JDiv
from mrbayes_tpu.mcmc.settings import McmcSettings as JMcmc
from mrbayes_tpu.mcmc.settings import Prior as JPrior
from mrbayes_tpu.mcmc.settings import TreeSettings as JTree
from mrbayes_tpu.nexus.datatypes import DataType as JDataType
from mrbayes_tpu.nexus.datatypes import FormatInfo as JFormat
from mrbayes_tpu.nexus.parser import CharacterMatrix as JMatrix
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_to_numpy
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS, Engine
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings, McmcSettings,
                                             Prior, TreeSettings)
from mrbayes_tpu_torch.nexus.datatypes import DataType, FormatInfo
from mrbayes_tpu_torch.nexus.parser import CharacterMatrix

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

NTAX, NCHAR = 7, 60
LINKS = {"topology": [0, 1], "brlens": [0, 1]}


def _two_part_dataset(jax_side=False, seed=3):
    """Random DNA in two partitions of 30 sites (tests/test_unlinked.py)."""
    rng = np.random.default_rng(seed)
    codes = (1 << rng.integers(0, 4, size=(NTAX, NCHAR))).astype(np.uint32)
    dt, fmt, mat, mk, ds = (
        (JDataType, JFormat, JMatrix, j_make_divisions, JDataSet) if jax_side
        else (DataType, FormatInfo, CharacterMatrix, make_divisions, DataSet))
    m = mat(taxa=[f"t{i}" for i in range(NTAX)], nchar=NCHAR,
            fmt=fmt(datatype=dt.DNA), codes=codes,
            col_datatype=[dt.DNA] * NCHAR)
    half = NCHAR // 2
    divs = mk(m, [list(range(half)), list(range(half, NCHAR))])
    return ds(taxa=m.taxa, nchar=NCHAR, divisions=divs)


def _settings(cls, prior):
    return cls(nst="2", rates="gamma", statefreqpr=prior("fixed", ("equal",)))


@pytest.fixture(scope="module")
def engines():
    eng = Engine(_two_part_dataset(), [_settings(DivisionSettings, Prior)] * 2,
                 links=LINKS, mcmc=McmcSettings(nruns=2, nchains=2, seed=5,
                                                samplefreq=10),
                 device="cpu")
    jeng = JEngine(_two_part_dataset(True), [_settings(JDiv, JPrior)] * 2,
                   links=LINKS, mcmc=JMcmc(nruns=2, nchains=2, seed=5))
    return eng, jeng


def test_two_trees_and_their_layout(engines):
    eng, jeng = engines
    assert eng.n_trees == jeng.n_trees == 2
    assert eng.div_tree == jeng.div_tree == [0, 1]
    states, _ = eng.init_chains()
    for f in ("left", "right", "parent", "blen"):
        assert states[f].shape == (4, 2, 2 * NTAX - 1)
    assert torch.isfinite(states["lnL"]).all()
    assert [(m.name, m.weight, m.prior_scope) for m in eng.moves] == \
        [(m.name, m.weight, m.prior_scope) for m in jeng.moves]
    assert not eng._multiwalk_pruners and not eng._stacked_pruners


def test_lnl_is_the_sum_of_each_division_on_its_tree(engines):
    eng, _ = engines
    states, _ = eng.init_chains()
    parts = 0.0
    for d in range(2):
        ds = _two_part_dataset()
        one = Engine(DataSet(taxa=ds.taxa, nchar=ds.nchar,
                             divisions=[ds.divisions[d]]),
                     [_settings(DivisionSettings, Prior)],
                     mcmc=McmcSettings(nruns=2, nchains=2, seed=5),
                     device="cpu")
        view = {k: v for k, v in eng.tree_view(states, eng.div_tree[d])
                .items() if k not in SCORE_KEYS}
        parts = parts + one.log_likelihood(one.refresh_eigs(view))
    np.testing.assert_allclose(states["lnL"].numpy(), parts.numpy(),
                               atol=1e-3, rtol=0)


def test_scores_match_jax_at_identical_states(engines):
    eng, jeng = engines
    rng = np.random.default_rng(9)
    states, _ = eng.init_chains()
    st = {k: v for k, v in states.items()
          if k not in SCORE_KEYS and not k.startswith("eig")}
    st["tratio"] = torch.as_tensor(rng.uniform(0.5, 5.0, (4, 1)),
                                   dtype=torch.float32)
    st["shape"] = torch.as_tensor(rng.uniform(0.2, 2.0, (4, 1)),
                                  dtype=torch.float32)
    scored = eng.score(eng.refresh_eigs(st))
    jst = jax.vmap(jeng.refresh_eigs)(
        {k: jnp.asarray(v) for k, v in state_to_numpy(st).items()})
    np.testing.assert_allclose(
        scored["lnL"].numpy(),
        np.asarray(jax.vmap(jeng.log_likelihood)(jst)), atol=5e-2, rtol=0)
    np.testing.assert_allclose(
        scored["lnP"].numpy(), np.asarray(jax.vmap(jeng.log_prior)(jst)),
        atol=1e-4, rtol=0)


def test_block_keeps_posteriors_finite_and_trees_apart(engines):
    eng, _ = engines
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 200)
    assert torch.isfinite(states["lnL"]).all()
    assert torch.isfinite(states["lnP"]).all()
    fresh = eng.score({k: v for k, v in states.items()
                       if k not in SCORE_KEYS})
    for k in SCORE_KEYS:
        np.testing.assert_allclose(states[k].numpy(), fresh[k].numpy(),
                                   atol=1e-3, rtol=1e-5)
    for slot in range(4):
        for t in range(2):
            eng.extract_tree(states, slot, t).check()
    p, b = states["parent"][0], states["blen"][0]
    assert not torch.equal(p[0], p[1]) or not torch.equal(b[0], b[1])
    # one move a generation and chain
    assert int(bk["tries_total"].sum()) == 4 * 200


UNL = """#NEXUS
begin data;
  dimensions ntax=6 nchar=40;
  format datatype=dna;
  matrix
{mat}
  ;
end;
begin mrbayes;
  set autoclose=yes nowarn=yes;
  charset first = 1-20;
  charset second = 21-40;
  partition both = 2: first, second;
  set partition=both;
  unlink topology=(all) brlens=(all);
  mcmc ngen=200 nruns=1 nchains=1 samplefreq=50 printfreq=100
       diagnfreq=200 file={out};
  sumt;
end;
"""


def test_cli_end_to_end(tmp_path):
    taxa = ["a", "b", "c", "d", "e", "f"]
    rng = np.random.default_rng(0)
    rows = ["".join("ACGT"[rng.integers(4)] for _ in range(40))
            for _ in taxa]
    nex = tmp_path / "unl.nex"
    out = tmp_path / "out"
    nex.write_text(UNL.format(
        mat="\n".join(f"    {t} {r}" for t, r in zip(taxa, rows)), out=out))
    it = Interpreter(log=lambda m: None, device="cpu")
    it.execute_file(str(nex))
    for t in (1, 2):
        with open(f"{out}.tree{t}.run1.t") as f:
            text = f.read()
        assert text.count("   tree gen.") == 5
        assert text.rstrip().endswith("end;")
        assert os.path.exists(f"{out}.tree{t}.con.tre")
    assert not os.path.exists(f"{out}.run1.t")
    with open(f"{out}.run1.p") as f:
        header = f.readlines()[1].rstrip("\n").split("\t")
    assert "TL{1}" in header and "TL{2}" in header
    assert header[3:] == [n for n, _ in param_columns(it._last_runner.eng)]
    # the checkpoint carries both trees of the chain
    with open(f"{out}.ckp") as f:
        ckp = f.read()
    assert "$tree=1.run=1" in ckp and "$tree=2.run=1" in ckp
    assert "states.parent int64 [1,2,11]" in ckp


def test_p_header_equals_jax_param_columns(engines):
    eng, jeng = engines
    assert [n for n, _ in param_columns(eng)] == \
        [n for n, _ in j_param_columns(jeng)]
    assert [n for n, _ in param_columns(eng)][:2] == ["TL{1}", "TL{2}"]


def test_clock_with_unlinked_trees_raises():
    with pytest.raises(NotImplementedError, match="non-clock trees"):
        Engine(_two_part_dataset(), [_settings(DivisionSettings, Prior)] * 2,
               tree_settings=TreeSettings(clock=True), links=LINKS,
               device="cpu")
    with pytest.raises(NotImplementedError, match="non-clock trees"):
        JEngine(_two_part_dataset(True), [_settings(JDiv, JPrior)] * 2,
                tree_settings=JTree(clock=True), links=LINKS)
