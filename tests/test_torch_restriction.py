"""The port's restriction (binary) data and directional root frequencies
against the JAX package, on tests/data/restriction.nex (6 taxa, 40
characters).

* ``binary_q`` within 1e-6 of JAX's;
* restriction lnL at identical states (the JAX state carried over by
  ``convert.state_from_numpy``, with its eigensystems and with the
  port's own) under the codings all,
  noabsencesites and nopresencesites (gamma rates, sampled frequencies)
  within 1e-3 of the JAX engine's, lnPrior within 1e-4;
* directional and mixed lnL on rooted trees with root frequencies unlike
  the stationary ones (and, for mixed, chains in either state) within
  1e-3 of JAX's, lnPrior within 1e-4;
* the ``restriction_directional`` and ``restriction_mixedfreq`` rows of
  ``tests/golden_extra.json`` through the port's CLI within their ``tol``
  (0.3);
* the three tests of ``tests/test_directional.py``, restated for the
  port's ``Interpreter``: directional sampling (rootpi columns that move,
  ``[&R]`` trees, the rooted move set), the mixed model's RJ indicator and
  its -9999 sentinel, and statefrmod refused on other data;
* rooted NNI and rooted SPR keep a valid rooted tree (parent links, the
  root at node 2n-2, every non-root branch positive, tip 0's included),
  move the root, and SPR's Hastings term is finite;
* a prior-only mixed run on 4 tips (16 runs x 1 chain), port against
  JAX: the shares of rooted trees whose root splits the tips 2|2 and
  whose root has tip 0 alone on one side, the mean
  tree length, the mean root frequency of state 0 and the share of
  directional samples, each within 4 batch-means standard errors (a batch
  a run);
* a restriction division over 2 site shards of the CPU equals the
  unsharded engine (its coding dummies in a pass of their own)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.models import substitution as JQ
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.mcmc import moves as M
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.models import substitution as TQ
from mrbayes_tpu_torch.trees import parse_newick, random_unrooted
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REST = os.path.join(HERE, "data", "restriction.nex")
GOLD = [r for r in json.load(open(os.path.join(HERE, "golden_extra.json")))
        if r["name"] in ("restriction_directional", "restriction_mixedfreq")]
C = 4


def _interpreters(lines, path=REST, nchains=C):
    it = Interpreter(log=lambda m: None, device="cpu")
    jit = JInterpreter(log=lambda m: None)
    for ln in [f"execute {path}", *lines,
               f"mcmcp nruns=1 nchains={nchains} seed=3"]:
        it.run_line(ln)
        jit.run_line(ln)
    return it, jit


def test_binary_q_matches_jax():
    pi = np.random.default_rng(0).dirichlet([2.0, 2.0], C).astype(np.float32)
    a = jax.vmap(JQ.binary_q)(jnp.asarray(pi))
    b = TQ.binary_q(torch.as_tensor(pi))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
    np.testing.assert_allclose((-(torch.diagonal(b, dim1=-2, dim2=-1)
                                  * torch.as_tensor(pi)).sum(-1)).numpy(),
                               1.0, atol=1e-6)


def _states(n_tips, rng, rooted):
    """C random trees (rooted: the basal branch split between the root's
    children, as the engine's rooted start) and seeded pi2 and shape."""
    trees = [random_unrooted(n_tips, rng, mean_blen=0.2) for _ in range(C)]
    st = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int32)
          for f in ("left", "right", "parent")}
    blen = np.stack([t.blen for t in trees]).astype(np.float32)
    if rooted:
        basal = st["left"][:, 2 * n_tips - 2]
        rows = np.arange(C)
        blen[:, 0] = 0.3 * blen[rows, basal]
        blen[rows, basal] *= 0.7
    st["blen"] = blen
    st["pi2"] = rng.dirichlet([3.0, 3.0], (C, 1)).astype(np.float32)
    return st


def _compare(eng, jeng, st):
    jst = jax.vmap(jeng.refresh_eigs)({k: jnp.asarray(v)
                                       for k, v in st.items()})
    want = np.asarray(jax.jit(jax.vmap(jeng.log_likelihood))(jst))
    lnP = np.asarray(jax.vmap(jeng.log_prior)(jst))
    # the JAX state as it is (pi2, rootpi2, dirpi_on and its eigensystem
    # cache), and the port's own eigensystems from its parameters
    carried = state_from_numpy({k: np.asarray(v) for k, v in jst.items()},
                               "cpu")
    np.testing.assert_allclose(eng.log_likelihood(carried).numpy(), want,
                               atol=1e-3, rtol=0)
    tst = eng.refresh_eigs({k: v for k, v in carried.items()
                            if not k.startswith("eig")})
    np.testing.assert_allclose(eng.log_likelihood(tst).numpy(), want,
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(eng.log_prior(tst).numpy(), lnP, atol=1e-4,
                               rtol=0)
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    return want


@pytest.mark.parametrize("coding", ["all", "noabsencesites",
                                    "nopresencesites"])
def test_restriction_lnl_matches_jax(coding):
    it, jit = _interpreters([f"lset coding={coding} rates=gamma",
                             "prset statefreqpr=dirichlet(1,1)"])
    eng, jeng = it.build_engine(), jit.build_engine()
    assert eng.div_cfg[0].coding == {"all": "all",
                                     "noabsencesites": "noabsence",
                                     "nopresencesites": "nopresence"}[coding]
    np.testing.assert_array_equal(eng.weights[0].numpy(),
                                  np.asarray(jeng.weights[0]))
    rng = np.random.default_rng(7)
    st = _states(eng.n_tips, rng, rooted=False)
    st["shape"] = rng.uniform(0.3, 2.0, (C, 1)).astype(np.float32)
    _compare(eng, jeng, st)
    assert not eng.rooted_nonclock


@pytest.mark.parametrize("model", ["directional", "mixed"])
def test_directional_lnl_matches_jax(model):
    it, jit = _interpreters(["lset coding=noabsencesites",
                             f"lset statefrmod={model}",
                             "prset statefreqpr=dirichlet(1,1)"])
    eng, jeng = it.build_engine(), jit.build_engine()
    assert eng.rooted_nonclock and jeng.rooted_nonclock
    rng = np.random.default_rng(8)
    st = _states(eng.n_tips, rng, rooted=True)
    st["rootpi2"] = rng.dirichlet([1.0, 1.0], (C, 1)).astype(np.float32)
    if model == "mixed":
        st["dirpi_on"] = np.array([[1], [0], [1], [0]], np.int32)
    lnl = _compare(eng, jeng, st)
    # the root frequencies move the lnL (they are not the stationary ones)
    st["rootpi2"] = st["pi2"].copy()
    tst = eng.refresh_eigs({k: torch.as_tensor(v).long()
                            if v.dtype == np.int32 else torch.as_tensor(v)
                            for k, v in st.items()})
    moved = np.abs(eng.log_likelihood(tst).numpy() - lnl)
    on = np.ones(C, bool) if model == "directional" else \
        st["dirpi_on"][:, 0] > 0
    assert (moved[on] > 1e-3).all() and (moved[~on] < 1e-4).all()


@pytest.fixture(scope="module")
def golden_engines():
    out = {}
    for rec in GOLD:
        if rec["name"] in out:
            continue
        it = Interpreter(log=lambda m: None, device="cpu")
        for c in rec["commands"]:
            if c.startswith("execute "):
                c = f"execute {REST}"
            it.run_line(c)
        out[rec["name"]] = it.build_engine()
    return out


@pytest.mark.parametrize("i", range(len(GOLD)),
                         ids=[f"{r['name']}@{r['gen']}" for r in GOLD])
def test_golden_restriction_row(golden_engines, i):
    rec = GOLD[i]
    eng = golden_engines[rec["name"]]
    t = parse_newick(rec["newick"], eng.data.taxa, rooted=True)
    st = {f: torch.as_tensor(getattr(t, f)[None]).long()
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(t.blen[None], dtype=torch.float32)
    for k, v in rec["state"].items():
        st[k] = torch.tensor([v], dtype=torch.int64 if k == "dirpi_on"
                             else torch.float32)
    lnL = float(eng.log_likelihood(eng.refresh_eigs(st))[0])
    assert abs(lnL - rec["lnL"]) < rec["tol"], (rec["gen"], lnL, rec["lnL"])


def _run(tmp_path, model, ngen=600):
    """tests/test_directional.py's run through the port's CLI."""
    it = Interpreter(log=lambda m: None, device="cpu")
    it.run_line(f"execute {REST}")
    it.run_line("lset coding=noabsencesites")
    it.run_line(f"lset statefrmod={model}")
    it.run_line("prset statefreqpr=dirichlet(1,1)")
    pfx = str(tmp_path / model)
    it.run_line(f"mcmc ngen={ngen} nruns=1 nchains=1 samplefreq=50 "
                f"printfreq=10000 seed=61 swapseed=62 file={pfx}")
    with open(pfx + ".run1.p") as f:
        lines = f.readlines()
    hdr = lines[1].rstrip("\n").split("\t")
    rows = np.array([[float(x) for x in ln.split("\t")] for ln in lines[2:]])
    return it, hdr, rows, pfx


def test_directional_sampling(tmp_path):
    it, hdr, rows, pfx = _run(tmp_path, "directional")
    assert "rootpi(0)" in hdr and "rootpi(1)" in hdr
    r0 = rows[:, hdr.index("rootpi(0)")]
    assert np.all(np.isfinite(rows[:, hdr.index("lnLike")]))
    assert np.std(r0) > 0.0          # root frequencies actually move
    with open(pfx + ".run1.t") as f:
        assert "[&R]" in f.read()    # trees are rooted
    eng = it._last_runner.eng
    names = {m.name for m in eng.moves}
    assert {"rooted_nni", "rooted_spr", "rootpi_dir",
            "rootpi_slider"} <= names
    jit = JInterpreter(log=lambda m: None)
    for ln in (f"execute {REST}", "lset coding=noabsencesites",
               "lset statefrmod=directional",
               "prset statefreqpr=dirichlet(1,1)"):
        jit.run_line(ln)
    assert hdr[3:] == [n for n, _ in j_param_columns(jit.build_engine())]
    assert hdr[3:] == [n for n, _ in param_columns(eng)]


def test_mixed_rj_switch(tmp_path):
    it, hdr, rows, pfx = _run(tmp_path, "mixed", ngen=1500)
    ind = rows[:, hdr.index("statefrmod")]
    # the RJ indicator takes its values only
    assert set(np.unique(ind)) <= {0.0, 1.0}
    # sentinel: stationary samples print -9999 for rootpi
    r0 = rows[:, hdr.index("rootpi(0)")]
    off = ind == 0.0
    assert np.all(r0[off] == -9999.0)
    assert np.all(r0[~off] > -1.0)
    assert rows[0, hdr.index("statefrmod")] == 1.0


def test_directional_requires_restriction():
    it = Interpreter(log=lambda m: None, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    it.run_line("lset statefrmod=directional")
    with pytest.raises(ValueError, match="only available for restriction"):
        it.build_engine()


def test_directional_refusals_equal_jax():
    """A clock and a fixed root prior under mixed raise with the JAX
    package's messages."""
    for lines in (["lset statefrmod=directional",
                   "prset brlenspr=clock:uniform"],
                  ["lset statefrmod=mixed",
                   "prset rootfreqpr=fixed(0.3,0.7)"]):
        it, jit = _interpreters(lines)
        with pytest.raises(ValueError) as a:
            jit.build_engine()
        with pytest.raises(ValueError) as b:
            it.build_engine()
        assert str(a.value) == str(b.value)


def test_rooted_moves_keep_a_valid_rooted_tree():
    it, _ = _interpreters(["lset statefrmod=directional"], nchains=8)
    eng = it.build_engine()
    states, _ = eng.init_chains()
    n = eng.n_tips
    root = 2 * n - 2
    gen = torch.Generator().manual_seed(5)
    tuning = torch.zeros(8)
    st = {k: states[k] for k in ("left", "right", "parent", "blen")}
    start_clades = {(int(a), int(b)) for a, b in
                    zip(st["left"][:, root], st["right"][:, root])}
    roots = set(start_clades)
    finite = 0
    for k in range(60):
        fn = M.move_rooted_nni if k % 2 else M.move_rooted_spr
        new, lnH = fn(gen, st, tuning, n)
        ok = lnH > -1e29
        finite += int(ok.sum())
        st = {f: torch.where(ok[:, None], new[f], st[f]) for f in st}
        for c in range(8):
            t = eng.extract_tree({f: v.numpy() for f, v in st.items()}, c)
            assert t.rooted
            t.check()
            assert t.parent[root] == -1
            assert (t.blen[:root] > 0).all()
        roots |= {(int(a), int(b)) for a, b in
                  zip(st["left"][:, root], st["right"][:, root])}
    assert finite > 100
    # the root's children change: the root itself moves
    assert len(roots) > len(start_clades)
    # the root's branch lengths are summed consistently: tip 0's is real
    assert (st["blen"][:, 0] > 0).all()


def _tiny_restriction(tmp_path, ntax=4, nchar=10):
    rng = np.random.default_rng(1)
    rows = "\n".join(f"   t{i} " + "".join(
        str(x) for x in rng.integers(0, 2, nchar)) for i in range(ntax))
    path = tmp_path / "tiny.nex"
    path.write_text(f"#NEXUS\nbegin data;\n   dimensions ntax={ntax} "
                    f"nchar={nchar};\n   format datatype=restriction;\n"
                    f"   matrix\n{rows}\n   ;\nend;\n")
    return str(path)


def _prior_stats(eng, states, bk, n_blocks, block):
    """Per run (one chain each): the shares of rooted trees whose root
    splits the tips 2|2 and whose root has tip 0 alone on one side, the
    mean tree length, the mean rootpi(0) over directional samples and the
    share of directional samples, over the second half of the run."""
    n = eng.n_tips
    root = 2 * n - 2
    rec = []
    for _ in range(n_blocks):
        states, bk = eng.run_block(states, bk, block)
        left = np.asarray(states["left"])[:, root]
        right = np.asarray(states["right"])[:, root]
        even = (left >= n) & (right >= n)
        tip0 = (left == 0) | (right == 0)
        tl = np.asarray(states["blen"]).sum(1)
        on = np.asarray(states["dirpi_on"])[:, 0] > 0
        r0 = np.asarray(states["rootpi2"])[:, 0, 0]
        rec.append((even, tip0, tl, on, r0))
    half = rec[len(rec) // 2:]
    even, tip0, tl, on, r0 = (np.stack(x) for x in zip(*half))
    root0 = (r0 * on).sum(0) / np.maximum(on.sum(0), 1)
    return {"even_root": even.mean(0), "tip0_alone": tip0.mean(0),
            "tl": tl.mean(0), "rootpi0": root0, "on": on.mean(0)}


def test_prior_only_mixed_matches_jax(tmp_path):
    path = _tiny_restriction(tmp_path)
    runs = 16
    lines = ["lset statefrmod=mixed", "prset statefreqpr=dirichlet(1,1)"]
    it = Interpreter(log=lambda m: None, device="cpu")
    jit = JInterpreter(log=lambda m: None)
    for ln in [f"execute {path}", *lines,
               f"mcmcp nruns={runs} nchains=1 seed=21 data=no"]:
        it.run_line(ln)
        jit.run_line(ln)
    eng, jeng = it.build_engine(), jit.build_engine()
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]
    out = {}
    for name, e in (("jax", jeng), ("port", eng)):
        states, bk = e.init_chains()
        out[name] = _prior_stats(e, states, bk, 120, 10)
    for key in out["jax"]:
        a, b = out["jax"][key], out["port"][key]
        se = np.hypot(a.std(ddof=1), b.std(ddof=1)) / np.sqrt(runs)
        assert abs(a.mean() - b.mean()) < 4.0 * se + 1e-9, \
            (key, a.mean(), b.mean(), se)
    # both states of the RJ indicator are visited
    assert 0.05 < out["port"]["on"].mean() < 0.95


def test_sharded_restriction_equals_unsharded():
    from mrbayes_tpu_torch.parallel.mesh import make_mesh, shard_engine_data
    it, _ = _interpreters(["lset statefrmod=directional rates=gamma",
                           "prset statefreqpr=dirichlet(1,1)"], nchains=2)
    eng = it.build_engine()
    states, _ = eng.init_chains()
    states = {**states, "rootpi2": torch.tensor([[[0.3, 0.7]],
                                                 [[0.6, 0.4]]])}
    whole = eng.log_likelihood(states)
    shard_engine_data(eng, make_mesh(1, 2, ["cpu"] * 2))
    np.testing.assert_allclose(eng.log_likelihood(states).numpy(),
                               whole.numpy(), atol=1e-4, rtol=0)


def test_prset_keys_of_this_slice_parse():
    it = Interpreter(log=lambda m: None, device="cpu")
    it.run_line(f"execute {REST}")
    it.run_line("prset rootfreqpr=dirichlet(2,3) covswitchpr=exp(2)")
    s = it.env.div_settings[0]
    assert (s.rootfreqpr.kind, s.rootfreqpr.params) == ("dirichlet",
                                                       (2.0, 3.0))
    assert (s.covswitchpr.kind, s.covswitchpr.params) == ("exponential",
                                                         (2.0,))
    # BEST's prset keys are ported (item 14e): this one now sets its value
    it.run_line("prset popvarpr=variable")
    assert it.env.tree_settings.popvarpr == "variable"
