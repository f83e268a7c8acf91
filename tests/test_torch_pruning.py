"""The port's pruning pass against the JAX package.

* the plain twin (``ops/pruning.root_partials``, batched over chains) and
  the ``PruningCuda`` wiring on CPU tensors (its plain version) against
  JAX ``root_partials`` per chain, on the ``tests/test_pallas.py`` cases;
* the (8,137,4,4) case at C = 4 against the JAX Pallas kernel in TPU
  interpret mode, run as ``tests/test_pallas.py`` runs it;
* the golden primates rows (reference MrBayes lnL and lnPrior).

Per-pattern lnL tolerance rtol/atol 2e-5 (float32 pruning of the same
products summed in a different order).  The CUDA kernel itself runs only
on a GPU: ``test_kernel_matches_plain_on_gpu`` carries the ``gpu`` marker
and skips here; ``chip_smoke.py`` holds it to the plain version on the
card at every listed shape."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mrbayes_tpu.models.substitution import nuc_q_gtr, reversible_q
from mrbayes_tpu.ops.pruning import root_clv as j_root_clv
from mrbayes_tpu.ops.pruning import root_partials as j_root_partials
from mrbayes_tpu.ops.pruning_pallas import PruningPallas
from mrbayes_tpu.ops.tiprobs import eigh_reversible
from mrbayes_tpu.trees import random_unrooted
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.mcmc.engine import Engine
from mrbayes_tpu_torch.mcmc.settings import DivisionSettings, McmcSettings
from mrbayes_tpu_torch.nexus.parser import read_nexus_file
from mrbayes_tpu_torch.ops import pruning as TP
from mrbayes_tpu_torch.ops import pruning_cuda as PC
from mrbayes_tpu_torch.trees import parse_newick
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
GOLD = json.load(open(os.path.join(HERE, "golden_primates.json")))
MODEL = {
    "jc": DivisionSettings(nst="1", rates="equal"),
    "gtr": DivisionSettings(nst="6", rates="equal"),
    "gtr_g": DivisionSettings(nst="6", rates="gamma"),
    "gtr_i": DivisionSettings(nst="6", rates="propinv"),
    "gtr_ig": DivisionSettings(nst="6", rates="invgamma"),
}
GOLD_ROWS = [i for i, r in enumerate(GOLD) if r["model"] in MODEL]
CASES = [(8, 137, 4, 4), (12, 434, 4, 1), (6, 40, 20, 2)]


def _case(n_tips, P, S, K, C, seed):
    """One random tree per chain, shared tips, one GTR-type eigensystem
    per chain and per-chain category rates: numpy, from a seed."""
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    tips = (rng.random((n_tips, P, S)) < 0.4).astype(np.float32)
    tips[..., 0] = 1.0
    eig, pis = [], []
    for _ in range(C):
        pi = rng.random(S) + 0.2
        pi = jnp.asarray(pi / pi.sum(), jnp.float32)
        if S == 4:
            r6 = jnp.asarray(rng.random(6), jnp.float32)
            Q = nuc_q_gtr(r6 / r6.sum(), pi)
        else:
            Q = reversible_q(jnp.asarray(rng.random(S * (S - 1) // 2),
                                         jnp.float32), pi)
        eig.append([np.asarray(x) for x in eigh_reversible(Q, pi)])
        pis.append(np.asarray(pi))
    cat = np.stack([np.linspace(0.3, 2.2, K) * (1 + 0.1 * c)
                    for c in range(C)]).astype(np.float32)
    tree = {f: np.stack([getattr(t, f) for t in trees])
            for f in ("left", "right", "parent")}
    tree["blen"] = np.stack([t.blen for t in trees]).astype(np.float32)
    lam, U, V = (np.stack([e[i] for e in eig]) for i in range(3))
    return tree, tips, lam, U, V, np.stack(pis), cat


def _site_lnl(root, ls, pi):
    """root [C, P, K, S], ls [C, P], pi [C, S] -> per-pattern lnL."""
    K = root.shape[2]
    return np.log(np.einsum("cpks,cs->cp", root, pi) / K) + ls


def _jax_reference(tree, tips, lam, U, V, cat, n_tips):
    roots, lss = [], []
    for c in range(tree["parent"].shape[0]):
        parts, ls = j_root_partials(
            jnp.asarray(tree["left"][c]), jnp.asarray(tree["right"][c]),
            jnp.asarray(tree["parent"][c]), jnp.asarray(tree["blen"][c]),
            jnp.asarray(tips), jnp.asarray(lam[c]), jnp.asarray(U[c]),
            jnp.asarray(V[c]), jnp.asarray(cat[c]), 0.0, n_tips)
        roots.append(np.asarray(parts[2 * n_tips - 2]))
        lss.append(np.asarray(ls))
    return np.stack(roots), np.stack(lss)


def _torch_args(tree, tips, lam, U, V, cat):
    t = {k: torch.as_tensor(v) for k, v in tree.items()}
    for k in ("left", "right", "parent"):
        t[k] = t[k].long()
    return (t["left"], t["right"], t["parent"], t["blen"],
            torch.as_tensor(tips), torch.as_tensor(lam), torch.as_tensor(U),
            torch.as_tensor(V), torch.as_tensor(cat))


@pytest.mark.parametrize("C", [1, 4, 8])
@pytest.mark.parametrize("n_tips,P,S,K", CASES)
def test_twin_and_wiring_match_jax(n_tips, P, S, K, C):
    tree, tips, lam, U, V, pi, cat = _case(n_tips, P, S, K, C, seed=n_tips)
    root_j, ls_j = _jax_reference(tree, tips, lam, U, V, cat, n_tips)
    ln_j = _site_lnl(root_j, ls_j, pi)
    args = _torch_args(tree, tips, lam, U, V, cat)
    parts, ls = TP.root_partials(*args, 0.0, n_tips)
    ln_twin = _site_lnl(parts[:, 2 * n_tips - 2].numpy(), ls.numpy(), pi)
    np.testing.assert_allclose(ln_twin, ln_j, rtol=2e-5, atol=2e-5)
    pruner = PC.PruningCuda(tips, K, "cpu")
    root, ls2 = TP.root_clv(*args, 0.0, n_tips, pruner=pruner)
    # root_clv gives the kernels' layout [C, K, S, P]
    ln_wired = _site_lnl(root.permute(0, 3, 1, 2).numpy(), ls2.numpy(), pi)
    np.testing.assert_allclose(ln_wired, ln_j, rtol=2e-5, atol=2e-5)
    assert pruner.launches == 0          # CPU tensors: the plain version


def test_wiring_matches_jax_pallas_interpret():
    n_tips, P, S, K, C = 8, 137, 4, 4, 4
    tree, tips, lam, U, V, pi, cat = _case(n_tips, P, S, K, C, seed=21)
    # one eigensystem and rate set for every chain: the Pallas path is
    # vmapped over branch lengths, as in tests/test_pallas.py
    lam[:], U[:], V[:], cat[:] = lam[0], U[0], V[0], cat[0]
    for f in ("left", "right", "parent"):
        tree[f][:] = tree[f][0]
    tree["blen"] = np.stack([tree["blen"][0] * (1 + 0.03 * c)
                             for c in range(C)]).astype(np.float32)
    left, right, parent = (jnp.asarray(tree[f][0])
                           for f in ("left", "right", "parent"))
    jtips = jnp.asarray(tips)
    pruner = PruningPallas(tips, K)
    os.environ["MB_TPU_FORCE_PALLAS"] = "1"
    try:
        with pltpu.force_tpu_interpret_mode():
            roots, lss = jax.jit(jax.vmap(
                lambda b: j_root_clv(left, right, parent, b, jtips,
                                     jnp.asarray(lam[0]), jnp.asarray(U[0]),
                                     jnp.asarray(V[0]), jnp.asarray(cat[0]),
                                     0.0, n_tips, pruner=pruner)
            ))(jnp.asarray(tree["blen"]))
            roots, lss = jax.block_until_ready((roots, lss))
    finally:
        del os.environ["MB_TPU_FORCE_PALLAS"]
    ln_pallas = _site_lnl(np.asarray(roots), np.asarray(lss), pi)
    args = _torch_args(tree, tips, lam, U, V, cat)
    root, ls = TP.root_clv(*args, 0.0, n_tips,
                           pruner=PC.PruningCuda(tips, K, "cpu"))
    np.testing.assert_allclose(
        _site_lnl(root.permute(0, 3, 1, 2).numpy(), ls.numpy(), pi),
        ln_pallas, rtol=2e-5, atol=2e-5)


def test_pruning_down_takes_cuda_tensors_only():
    tree, tips, lam, U, V, pi, cat = _case(6, 40, 4, 2, 2, seed=1)
    pruner = PC.PruningCuda(tips, 2, "cpu")
    args = _torch_args(tree, tips, lam, U, V, cat)
    P = TP.branch_tiprobs(args[3], args[5], args[6], args[7], args[8], 0.0)
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    order = postorder_internal(args[2], 6)
    lr, pstep = pruner.operands(order, args[0], args[1], P)
    assert lr.dtype == torch.int32 and lr.shape == (2, 5, 2)
    assert pstep.shape == (2, 5, 2, 2, 4, 4)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        PC.pruning_down(lr, pstep, pruner.tips)
    with pytest.raises(TypeError):
        PC.pruning_down_plain(lr.long(), pstep, pruner.tips)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run chip_smoke.py or pytest -m gpu "
                    "on a machine with one)")
    return torch.device("cuda")


# primates; the cynmix morphology buckets S = 3 and 8 (whole on-chip walk);
# S = 20 at 32 tips and S = 61 (operators staged a step ahead); S = 32
# with 16 categories, replicase under M10 (K 8 x S 61) and codon data on
# 114 taxa under M3 (the tiled walk; the first took the global-scratch
# walk before it), each at C = 4
GPU_CASES = CASES + [(12, 413, 4, 4), (32, 34, 3, 4), (32, 9, 8, 4),
                     (32, 100, 20, 4), (6, 40, 61, 3), (9, 70, 32, 16),
                     (9, 239, 61, 8), (114, 240, 61, 3)]
WALK = {(32, 100, 20, 4): "staged", (6, 40, 61, 3): "staged",
        (9, 70, 32, 16): "tiled", (9, 239, 61, 8): "tiled",
        (114, 240, 61, 3): "tiled"}


@pytest.mark.gpu
@pytest.mark.parametrize("n_tips,P,S,K", GPU_CASES)
def test_kernel_matches_plain_on_gpu(cuda_device, n_tips, P, S, K):
    tree, tips, lam, U, V, pi, cat = _case(n_tips, P, S, K, 4, seed=5)
    args = [a.to(cuda_device) for a in _torch_args(tree, tips, lam, U, V,
                                                   cat)]
    pruner = PC.PruningCuda(tips, K, cuda_device)
    P_ = TP.branch_tiprobs(args[3], args[5], args[6], args[7], args[8], 0.0)
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    lr, pstep = pruner.operands(postorder_internal(args[2], n_tips),
                                args[0], args[1], P_)
    root_k, ls_k = PC.pruning_down(lr, pstep, pruner.tips)
    root_p, ls_p = PC.pruning_down_plain(lr, pstep, pruner.tips)
    a = _site_lnl(root_k.permute(0, 3, 1, 2).cpu().numpy(), ls_k.cpu().numpy(),
                  pi)
    b = _site_lnl(root_p.permute(0, 3, 1, 2).cpu().numpy(), ls_p.cpu().numpy(),
                  pi)
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    plan = PC.pruning_plan(4, n_tips, K, S, P, cuda_device)
    assert plan["walk"] == WALK.get((n_tips, P, S, K), "whole"), plan
    assert plan == PC.size_rule(4, n_tips, K, S, P), plan


# the benchmark's 169 taxa at 16 and 32 chains and hymfossil's 114 at 32:
# the Strahler walk on the packed tips
STRAHLER_GPU_CASES = [(169, 600, 4, 4, 16), (169, 2048, 4, 4, 32),
                      (114, 300, 4, 4, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_tips,P,S,K,C", STRAHLER_GPU_CASES)
def test_strahler_walk_matches_plain_on_gpu(cuda_device, n_tips, P, S, K, C):
    """The walk against the plain version, its root partials against the
    walk of the float tips bit for bit, its plan against the twin and its
    device schedule against ``strahler_schedule``."""
    tree, tips, lam, U, V, pi, cat = _case(n_tips, P, S, K, C, seed=9)
    args = [a.to(cuda_device) for a in _torch_args(tree, tips, lam, U, V,
                                                   cat)]
    pruner = PC.PruningCuda(tips, K, cuda_device)
    assert pruner.masks is not None
    P_ = TP.branch_tiprobs(args[3], args[5], args[6], args[7], args[8], 0.0)
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    lr, pstep = pruner.operands(postorder_internal(args[2], n_tips),
                                args[0], args[1], P_)
    root_k, ls_k = PC.pruning_down(lr, pstep, pruner.tips, pruner.masks)
    root_o, _ = PC.pruning_down(lr, pstep, pruner.tips)
    root_p, ls_p = PC.pruning_down_plain(lr, pstep, pruner.tips)
    assert torch.equal(root_k, root_o)
    a = _site_lnl(root_k.permute(0, 3, 1, 2).cpu().numpy(), ls_k.cpu().numpy(),
                  pi)
    b = _site_lnl(root_p.permute(0, 3, 1, 2).cpu().numpy(), ls_p.cpu().numpy(),
                  pi)
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    plan = PC.pruning_plan(C, n_tips, K, S, P, cuda_device, True)
    assert plan["walk"] in PC.STRAHLER_WALKS, plan
    assert plan == PC.size_rule(C, n_tips, K, S, P, packed=True), plan
    sched = PC.strahler_schedule_cuda(lr).cpu().numpy()
    for c in range(C):
        assert (sched[c] == PC.strahler_schedule(lr[c].cpu().numpy(),
                                                  n_tips)).all()


@pytest.fixture(scope="module")
def dataset():
    nf = read_nexus_file(example("primates.nex"))
    return DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                   divisions=make_divisions(nf.matrix))


def _topo_const(n):
    return float(np.sum(np.log(np.arange(3, 2 * n - 4, 2))))


@pytest.mark.parametrize("i", GOLD_ROWS)
def test_golden_row(dataset, i):
    """The port's engine on the CPU reproduces the reference's recorded
    lnL (within 0.35) and lnPrior (within 0.01, after the uniform
    topology constant) at states it sampled (tests/test_golden.py)."""
    rec = GOLD[i]
    eng = Engine(dataset, [MODEL[rec["model"]]],
                 mcmc=McmcSettings(nruns=1, nchains=1), device="cpu")
    t = parse_newick(rec["newick"], dataset.taxa)
    st = {f: torch.as_tensor(getattr(t, f)[None]).long()
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(t.blen[None], dtype=torch.float32)
    if "pi" in rec:
        st["pi"] = torch.tensor([[rec["pi"]]])
    if "revmat" in rec:
        st["revmat"] = torch.tensor([[rec["revmat"]]])
    if rec["model"] in ("gtr_g", "gtr_ig"):
        st["shape"] = torch.tensor([[rec["alpha"]]])
    if rec["model"] in ("gtr_i", "gtr_ig"):
        st["pinvar"] = torch.tensor([[rec["pinvar"]]])
    st = eng.refresh_eigs(st)
    lnL = float(eng.log_likelihood(st)[0])
    assert abs(lnL - rec["lnL"]) < 0.35, (rec["model"], lnL, rec["lnL"])
    lnP = float(eng.log_prior(st)[0]) - _topo_const(12)
    assert abs(lnP - rec["lnPrior"]) < 0.01, (rec["model"], lnP,
                                              rec["lnPrior"])
