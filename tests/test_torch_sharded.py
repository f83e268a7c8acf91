"""Site-pattern sharding (the ``sites`` mesh axis) in the port, held against
the JAX package's ``shard_engine_data`` on its 8 virtual CPU devices (as
``tests/test_parallel.py`` runs it) and against the port's own unsharded
engine.  The port's meshes here are ``["cpu"] * k``: every shard takes the
plain version of the pruning kernel.

* mesh shapes, padding and the one-chain-shard-a-process rule (a mesh of
  more chain shards than processes raises, naming it); ``auto_mesh``'s
  shape equals JAX's for 1-8 devices wherever JAX's gives one chain shard,
  and is 1 x devices otherwise;
* ``PruningCudaSharded`` (plain per shard) against the slices of the
  unsharded root at 2e-5 on per-pattern lnL, for k = 1-4 (two of which
  pad), and its per-shard reduction against the unsharded weighted sum;
* primates GTR+I+G at identical states, 1 run x 2 chains, with JAX's
  eigensystems carried over: the port sharded over 4 shards against JAX
  sharded over 4 devices and against the port unsharded, within 5e-3
  (float32 sums of about 6e3 taken in another order);
* Mkv coding (test_parallel.py's 8-taxon binary matrix): the split
  correction, sharded against JAX sharded and the port unsharded;
* cynmix's favored model over 4 shards: each division's lnL (float64
  sums, ``division_lnls``) within 1e-3 of the unsharded engine, with
  every kernel-path group cleared and every pruner sharded;
* ``run_block`` over 20 generations: carried = recomputed, and lnL within
  rtol 2e-4 of the unsharded run from the same seeds;
* ``McmcRunner`` with a mesh logs the sharding line and writes its files;
  ``dryrun_sites(2, ["cpu"] * 2)`` passes; the CLI's ``MB_AUTOSHARD``
  mesh (one chain shard, every card on ``sites``);
* on a card (``gpu`` marker): the sharded launch against its plain
  version.
"""
import os

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
from mrbayes_tpu.nexus.datatypes import DataType as JDataType
from mrbayes_tpu.nexus.datatypes import FormatInfo as JFormatInfo
from mrbayes_tpu.nexus.parser import CharacterMatrix as JCharacterMatrix
from mrbayes_tpu.nexus.parser import read_nexus_file as j_read
from mrbayes_tpu.parallel.mesh import auto_mesh as j_auto_mesh
from mrbayes_tpu.parallel.mesh import make_mesh as j_make_mesh
from mrbayes_tpu.parallel.mesh import shard_engine_data as j_shard
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.envelope import CYNMIX_MODEL
from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS, Engine
from mrbayes_tpu_torch.mcmc.run import McmcRunner
from mrbayes_tpu_torch.mcmc.settings import DivisionSettings, McmcSettings
from mrbayes_tpu_torch.nexus.datatypes import DataType, FormatInfo
from mrbayes_tpu_torch.nexus.parser import CharacterMatrix, read_nexus_file
from mrbayes_tpu_torch.ops import pruning_cuda as PC
from mrbayes_tpu_torch.ops.sharded_cuda import PruningCudaSharded, Shards
from mrbayes_tpu_torch.ops.pruning import site_loglik_from_root
from mrbayes_tpu_torch.ops.traversal import postorder_internal
from mrbayes_tpu_torch.parallel.dryrun import dryrun_sites
from mrbayes_tpu_torch.parallel.mesh import (Mesh, _pad_to_multiple,
                                             auto_mesh, make_mesh,
                                             shard_chains, shard_engine_data)
from mrbayes_tpu_torch.trees import random_unrooted
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

CPU4 = ["cpu"] * 4


def test_mesh_shapes_padding_and_item_11b_errors():
    """The chains axis is ported (item 11b): in one process a mesh of
    more than one chain shard raises the one-chain-shard-a-process rule
    instead of NotImplementedError."""
    mesh = make_mesh(1, 4, CPU4)
    assert isinstance(mesh, Mesh)
    assert mesh.axis_names == ("chains", "sites")
    assert mesh.shape == {"chains": 1, "sites": 4}
    assert mesh.site_devices() == [torch.device("cpu")] * 4
    assert make_mesh(1, 2, ["cpu", "cpu", "cpu"]).shape["sites"] == 2
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh(1, 4, ["cpu"] * 3)
    with pytest.raises(ValueError, match="launch one process a chain shard"):
        make_mesh(2, 2, CPU4)
    states, bk = {"lnL": torch.zeros(2)}, {"gen": 0}
    assert shard_chains(None, mesh, states, bk) == (states, bk)
    x = np.arange(10.0).reshape(5, 2)
    padded, pad = _pad_to_multiple(x, 0, 4)
    assert pad == 3 and padded.shape == (8, 2) and not padded[5:].any()
    assert _pad_to_multiple(x, 1, 2) == (x, 0)


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_auto_mesh_factorisation_equals_jax(n_dev):
    """One process: JAX's shape wherever it gives one chain shard (a
    process), else one chain shard with every device on ``sites``."""
    for n_chains in (1, 2, 3, 4, 6, 8, 12):
        want = j_auto_mesh(n_chains, jax.devices()[:n_dev]).devices.shape
        got = auto_mesh(n_chains, ["cpu"] * n_dev).shape
        if want[0] == 1:
            assert got == {"chains": 1, "sites": want[1]}
        else:
            assert got == {"chains": 1, "sites": n_dev}


def _kernel_case(n_tips, P, S, K, C, seed):
    """A random tree per chain, 0/1 tips, row-stochastic operators, pi,
    pinv, a constant mask and integer pattern weights."""
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    left, right, parent = (torch.as_tensor(np.stack(
        [getattr(t, f) for t in trees])).long()
        for f in ("left", "right", "parent"))
    order = postorder_internal(parent, n_tips)
    tips = (rng.random((n_tips, P, S)) < 0.4).astype(np.float32)
    tips[..., 0] = 1.0
    Pm = rng.random((C, 2 * n_tips - 1, K, S, S)).astype(np.float32) + 0.05
    Pm /= Pm.sum(-1, keepdims=True)
    pi = rng.dirichlet(np.ones(S), size=C).astype(np.float32)
    pinv = rng.uniform(0.05, 0.4, C).astype(np.float32)
    cmask = (rng.random((P, S)) < 0.2).astype(np.float32)
    w = rng.integers(1, 5, P).astype(np.float32)
    return ((order, left, right, torch.as_tensor(Pm)), tips,
            torch.as_tensor(pi), torch.as_tensor(pinv), cmask, w)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sharded_pruner_matches_unsharded_root(k):
    walk, tips, pi, pinv, cmask, w = _kernel_case(8, 137, 4, 4, 3, seed=k)
    single = PC.PruningCuda(tips, 4, "cpu")
    root, ls = single(*walk)                         # [C, K, S, P], [C, P]
    tp, pad = _pad_to_multiple(tips, 1, k)
    assert pad == (-137) % k
    sharded = PruningCudaSharded(tp, 4, ["cpu"] * k, "cpu")
    outs = sharded(*walk)
    assert len(outs) == k and sharded.launches == 0    # plain on the CPU
    Pk = tp.shape[1] // k
    for j, (r, l) in enumerate(outs):
        lo, hi = j * Pk, min((j + 1) * Pk, 137)
        got = site_loglik_from_root(r, l, pi, 0.0, None)
        want = site_loglik_from_root(root, ls, pi, 0.0, None)[:, lo:hi]
        np.testing.assert_allclose(got[:, :hi - lo].numpy(), want.numpy(),
                                   rtol=2e-5, atol=2e-5)
        # padded patterns: finite, so weight 0 makes them add exactly 0
        assert torch.isfinite(got).all()
    # the per-shard reduction against the unsharded weighted sum
    w_sh = Shards.scatter(_pad_to_multiple(w, 0, k)[0], 0, ["cpu"] * k,
                          "cpu")
    cm_sh = Shards.scatter(_pad_to_multiple(cmask, 0, k)[0], 0,
                           ["cpu"] * k, "cpu")
    assert float(w_sh.sum()) == float(w.sum())
    total = sharded.loglik(*walk, pi, pinv, cm_sh, w_sh)
    want = (torch.as_tensor(w) * site_loglik_from_root(
        root, ls, pi, pinv, torch.as_tensor(cmask))).sum(-1)
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-6,
                               atol=2e-3)


def test_shard_devices_of_another_type_raise():
    tips = np.ones((4, 8, 4), np.float32)
    with pytest.raises(ValueError, match="device type"):
        PruningCudaSharded(tips, 1, ["cuda:0", "cuda:0"], "cpu")
    with pytest.raises(ValueError, match="multiple of 3"):
        PruningCudaSharded(tips, 1, ["cpu"] * 3, "cpu")


@pytest.fixture(scope="module")
def primates_jax():
    """JAX primates GTR+I+G, 1 run x 2 chains, random substitution
    parameters: the states (with JAX's eigensystems), JAX's unsharded and
    4-device sharded lnL."""
    nf = j_read(example("primates.nex"))
    ds = JDataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                  divisions=j_make_divisions(nf.matrix))
    eng = JEngine(ds, [JDiv(nst="6", rates="invgamma")],
                  mcmc=JMcmc(nruns=1, nchains=2, seed=3))
    rng = np.random.default_rng(11)
    per = [eng.init_state(rng) for _ in range(2)]
    st = {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]}
    st["pi"] = rng.dirichlet(np.ones(4) * 5, size=(2, 1)).astype(np.float32)
    st["revmat"] = rng.dirichlet(np.ones(6) * 2, size=(2, 1)).astype(
        np.float32)
    st["shape"] = rng.uniform(0.2, 2.0, size=(2, 1)).astype(np.float32)
    st["pinvar"] = rng.uniform(0.05, 0.5, size=(2, 1)).astype(np.float32)
    jst = jax.jit(jax.vmap(eng.refresh_eigs))({k: jnp.asarray(v)
                                               for k, v in st.items()})
    want = np.asarray(jax.jit(jax.vmap(eng.log_likelihood))(jst))
    mesh = j_make_mesh(1, 4)
    j_shard(eng, mesh)
    with mesh:
        sharded = np.asarray(jax.jit(jax.vmap(eng.log_likelihood))(jst))
    return {k: np.asarray(v) for k, v in jst.items()}, want, sharded


@pytest.fixture(scope="module")
def primates_ds():
    nf = read_nexus_file(example("primates.nex"))
    return DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                   divisions=make_divisions(nf.matrix))


def _primates_engine(ds, mesh=None, nchains=2):
    eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                 mcmc=McmcSettings(nruns=1, nchains=nchains, seed=3),
                 device="cpu")
    if mesh is not None:
        shard_engine_data(eng, mesh)
    return eng


def test_primates_sharded_matches_jax_sharded(primates_jax, primates_ds):
    jst, want, j_sharded = primates_jax
    eng = _primates_engine(primates_ds, make_mesh(1, 4, CPU4))
    assert all(isinstance(p, PruningCudaSharded) for p in eng._pruners)
    assert eng._pruners[0].dummy is None               # coding "all"
    assert eng.tip_partials == [None]        # the sharded pruner holds them
    # 413 patterns padded to 416: weight 0, zero mask rows
    assert [tuple(w.shape) for w in eng.weights[0].parts] == [(104,)] * 4
    assert not eng.weights[0].parts[3][-3:].any()
    assert not eng.const_masks[0].parts[3][-3:].any()
    st = state_from_numpy(jst, "cpu")
    got = eng.log_likelihood(st).numpy()
    np.testing.assert_allclose(got, j_sharded, atol=5e-3, rtol=0)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    unsharded = _primates_engine(primates_ds).log_likelihood(st).numpy()
    np.testing.assert_allclose(got, unsharded, atol=5e-3, rtol=0)


def _binary_matrices():
    """tests/test_parallel.py's 8-taxon, 40-character binary matrix (no
    constant column) for JAX and for the port."""
    rng = np.random.default_rng(9)
    ntax, nchar = 8, 40
    M = rng.integers(0, 2, size=(ntax, nchar))
    for j in range(nchar):
        if len(set(M[:, j].tolist())) == 1:
            M[0, j] = 1 - M[0, j]
    codes = (1 << M).astype(np.uint32)
    taxa = [f"t{i}" for i in range(ntax)]
    jm = JCharacterMatrix(taxa=taxa, nchar=nchar,
                          fmt=JFormatInfo(datatype=JDataType.STANDARD),
                          codes=codes,
                          col_datatype=[JDataType.STANDARD] * nchar)
    m = CharacterMatrix(taxa=taxa, nchar=nchar,
                        fmt=FormatInfo(datatype=DataType.STANDARD),
                        codes=codes, col_datatype=[DataType.STANDARD] * nchar)
    return (JDataSet(taxa=taxa, nchar=nchar, divisions=j_make_divisions(jm)),
            DataSet(taxa=taxa, nchar=nchar, divisions=make_divisions(m)))


def test_mkv_coding_sharded_matches_jax_sharded():
    jds, ds = _binary_matrices()
    jeng = JEngine(jds, [JDiv(rates="gamma")],
                   mcmc=JMcmc(nruns=1, nchains=2, seed=5))
    rng = np.random.default_rng(5)
    per = [jeng.init_state(rng) for _ in range(2)]
    jst = jax.jit(jax.vmap(jeng.refresh_eigs))(
        {k: jnp.stack([jnp.asarray(p[k]) for p in per]) for k in per[0]})
    mesh = j_make_mesh(1, 4)
    j_shard(jeng, mesh)
    assert jeng._site_sharded
    with mesh:
        want = np.asarray(jax.jit(jax.vmap(jeng.log_likelihood))(jst))

    def port(mesh=None):
        eng = Engine(ds, [DivisionSettings(rates="gamma")],
                     mcmc=McmcSettings(nruns=1, nchains=2, seed=5),
                     device="cpu")
        if mesh is not None:
            shard_engine_data(eng, mesh)
        return eng

    eng = port(make_mesh(1, 4, CPU4))
    assert eng.div_cfg[0].coding == "variable"
    pr = eng._pruners[0]
    assert isinstance(pr.dummy, PC.PruningCuda)
    assert pr.dummy.P == 2                             # the S dummies only
    # the real patterns only, padded to a multiple of the 4 shards
    assert pr.P == 4 * pr.tips[0].shape[2] >= eng.div_cfg[0].div.npat
    st = state_from_numpy({k: np.asarray(v) for k, v in jst.items()}, "cpu")
    got = eng.log_likelihood(st).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    np.testing.assert_allclose(got, port().log_likelihood(st).numpy(),
                               atol=1e-3, rtol=0)


def test_cynmix_division_lnls_over_4_shards():
    it = Interpreter(log=lambda m: None, device="cpu")
    for line in (f"execute {example('cynmix.nex')}", *CYNMIX_MODEL,
                 "mcmcp nruns=1 nchains=2 seed=7"):
        it.run_line(line)
    eng_u = it.build_engine()
    eng_s = it.build_engine(multiwalk=True, wavefront=True, stacked=True)
    assert eng_s._multiwalk_pruners and eng_s._stacked_pruners
    shard_engine_data(eng_s, make_mesh(1, 4, CPU4))
    assert eng_s._multiwalk_pruners == [] and eng_s._stacked_pruners == []
    assert all(isinstance(p, PruningCudaSharded) for p in eng_s._pruners)
    assert [p.dummy is not None for p in eng_s._pruners] == \
        [True] * 4 + [False] * 4
    states, _ = eng_u.init_chains()
    st = {k: v for k, v in states.items() if k not in SCORE_KEYS}
    got, want = eng_s.division_lnls(st), eng_u.division_lnls(st)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3, rtol=0)


def test_run_block_sharded_matches_unsharded(primates_ds):
    runs = {}
    for name, mesh in (("unsharded", None),
                       ("sharded", make_mesh(1, 4, CPU4))):
        eng = _primates_engine(primates_ds, mesh)
        states, bk = eng.init_chains()
        runs[name] = (eng, *eng.run_block(states, bk, 20))
    eng, states, bk = runs["sharded"]
    assert bk["gen"] == 20
    fresh = eng.score({k: v for k, v in states.items()
                       if k not in SCORE_KEYS})
    for k in ("lnL", "lnP_tree", "lnP_par"):
        np.testing.assert_allclose(states[k].numpy(), fresh[k].numpy(),
                                   rtol=0, atol=1e-3)
    np.testing.assert_allclose(states["lnL"].numpy(),
                               runs["unsharded"][1]["lnL"].numpy(),
                               rtol=2e-4)


def test_runner_with_a_mesh_logs_and_writes(primates_ds, tmp_path):
    mesh = make_mesh(1, 2, ["cpu"] * 2)
    eng = _primates_engine(primates_ds, mesh)
    eng.mcmc.ngen, eng.mcmc.samplefreq, eng.mcmc.printfreq = 20, 10, 20
    lines = []
    prefix = str(tmp_path / "sharded")
    McmcRunner(eng, file_prefix=prefix, log=lines.append, mesh=mesh).run()
    assert "   Sharding over mesh {'chains': 1, 'sites': 2} " \
        "(1 process(es))" in lines
    with open(prefix + ".run1.p") as f:
        assert sum(1 for ln in f if ln[:1].isdigit()) == 3
    assert os.path.exists(prefix + ".run1.t") and os.path.exists(
        prefix + ".ckp")


def test_dryrun_sites_on_the_cpu():
    out = dryrun_sites(2, ["cpu"] * 2)
    assert out["mesh"] == {"chains": 1, "sites": 2}
    assert out["max_abs_diff_unsharded"] < 2e-3 + 2e-4 * abs(
        out["final_cold_lnL"])


def test_cli_autoshard_mesh(monkeypatch):
    it = Interpreter(log=lambda m: None, device="cpu")
    it.run_line(f"execute {example('primates.nex')}")
    it.run_line("mcmcp nruns=2 nchains=4")
    assert it._analysis_mesh() is None               # not a CUDA run
    # a host with 4 CUDA devices, as _analysis_mesh sees it
    it.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("MB_AUTOSHARD", raising=False)
    assert it._analysis_mesh() is None               # not asked for
    monkeypatch.setenv("MB_AUTOSHARD", "1")
    # JAX would take 4 chain shards; one process holds one, every card on
    # sites
    mesh = it._analysis_mesh()
    assert mesh.shape == {"chains": 1, "sites": 4}
    it.run_line("mcmcp nruns=1 nchains=3")
    mesh = it._analysis_mesh()
    assert mesh.shape == {"chains": 1, "sites": 4}
    assert [str(d) for d in mesh.site_devices()] == [f"cuda:{i}"
                                                     for i in range(4)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert it._analysis_mesh() is None               # one card, no mesh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run chip_smoke.py or pytest -m gpu "
                    "on a machine with one)")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_kernel_matches_plain_on_gpu(cuda_device, k):
    walk, tips, pi, _, _, _ = _kernel_case(12, 413, 4, 4, 4, seed=k)
    walk = [t.to(cuda_device) for t in walk]
    tp, _ = _pad_to_multiple(tips, 1, k)
    sharded = PruningCudaSharded(tp, 4, [cuda_device] * k, cuda_device)
    lr, pstep = sharded.operands(*walk)
    outs = sharded(*walk)
    assert sharded.launches == k
    pi = pi.to(cuda_device)
    for (r, l), t in zip(outs, sharded.tips):
        rp, lp = PC.pruning_down_plain(lr, pstep, t)
        np.testing.assert_allclose(
            site_loglik_from_root(r, l, pi, 0.0, None).cpu().numpy(),
            site_loglik_from_root(rp, lp, pi, 0.0, None).cpu().numpy(),
            rtol=2e-5, atol=2e-5)
