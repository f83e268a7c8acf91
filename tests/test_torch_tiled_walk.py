"""The tiled walk of ``csrc/tiled_walk.cuh`` (``pruning.cu``'s walk for a
shape whose slots do not fit the on-chip walk) through Python twins.

* A numpy twin of the walk's order: one cluster per (chain, tile of T
  patterns), the categories split across its ranks, the operators taken
  one (step, category) chunk at a time through the spare live-slot map
  (``live_slot_map(..., spare=True)``), each rank's max a pattern combined
  into the step's m.  On seeded M10-like operands (S 61, K 8 and 16, P 20,
  C 2) it equals ``pruning_down_plain`` and the JAX package's
  ``_pallas_batched`` in TPU interpret mode within rtol/atol 2e-5 on
  per-pattern lnL (float32 products summed in another order), the
  tolerance of the other S 61 cases.
* The spare map never writes a slot its step reads, never loses a live
  partial and needs at most n_tips // 2 + 1 slots.
* The producer warp's schedule (chunk waits, stage refills and the late
  cluster barriers) runs to its end against its consumers' in clusters of
  blocks with 1-16 chunks a step: no deadlock.
* The size rule's Python twin (``pruning_cuda.size_rule``, an H100's
  limits as constants): replicase under M10 (9, 239, 61, 8) and the
  114-tip codon shape (114, 240, 61, 3) take the tiled walk at C 8 and
  32, M3 (9, 239, 61, 3) stays staged, every other shape that
  ``chip_smoke.py`` and ``tests/test_torch_pruning.py`` list keeps its
  walk (those that took the global-scratch walk now take the tiled one),
  and the blocks the card chose in earlier runs are the twin's.

The kernel itself runs only on a GPU: the ``gpu``-marked cases of
``tests/test_torch_pruning.py`` and ``chip_smoke.py`` hold it to the plain
version, to the old walk and its plan to ``size_rule`` there."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mrbayes_tpu.ops.pruning_pallas import _pallas_batched
from mrbayes_tpu_torch.ops import pruning_cuda as PC
from mrbayes_tpu_torch.ops.traversal import postorder_internal
from mrbayes_tpu_torch.trees import random_unrooted

# the tensors here are small: intra-op threads would only contend with
# the other test workers
torch.set_num_threads(1)

TOL = 2e-5
HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """chip_smoke.py's shape lists (the module imports no torch at load)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, os.pardir, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(n_tips, P, S, K, C, seed):
    """lr [C, n_int, 2] of C random trees in the engine's postorder,
    row-stochastic operators [C, n_int, 2, K, S, S], codon-like tips
    [n_tips, S, P] (one state, a few ambiguous) and state frequencies."""
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    left, right, parent = (torch.as_tensor(np.stack(
        [getattr(t, f) for t in trees])).long()
        for f in ("left", "right", "parent"))
    order = postorder_internal(parent, n_tips)
    lr = PC.slot_operands(order, left, right, n_tips)[0].numpy()
    op = rng.random((C, n_tips - 1, 2, K, S, S)) ** 4
    op += 5.0 * np.eye(S)
    op = (op / op.sum(-1, keepdims=True)).astype(np.float32)
    tips = np.zeros((n_tips, S, P), np.float32)
    tips[np.arange(n_tips)[:, None], rng.integers(0, S, (n_tips, P)),
         np.arange(P)] = 1.0
    tips[rng.random((n_tips, S, P)) < 0.03] = 1.0
    pi = rng.random(S) + 0.2
    return lr, op, tips, (pi / pi.sum()).astype(np.float32)


def tiled_walk_twin(lr, op, tips, T=8, Q=None):
    """The tiled walk's order in numpy float32: per chain and tile of T
    patterns (the ragged edge repeats the last pattern), per step, each
    cluster rank r's categories k in [r*kq, min(K, (r+1)*kq)) one chunk
    at a time (both children through the step's operators, x = w_l * w_r
    stored unnormalised in the step's spare slot), each rank's max a
    pattern, then m = max over the ranks (floored at 1e-30) dividing the
    step's slot and log m added to ls.  Returns (root [C, K, S, P],
    ls [C, P])."""
    C, n_int, _, K, S, _ = op.shape
    n_tips, _, P = tips.shape
    Q = Q or PC.tiled_cluster(K)
    kq = -(-K // Q)
    root = np.zeros((C, K, S, P), np.float32)
    ls = np.zeros((C, P), np.float32)
    for c in range(C):
        slot = PC.live_slot_map(lr[c], n_tips, spare=True)
        for p0 in range(0, P, T):
            cols = np.minimum(np.arange(p0, p0 + T), P - 1)
            tip_t = tips[:, :, cols]
            slots = np.zeros((n_tips // 2 + 1, K, S, T), np.float32)
            lsum = np.zeros(T, np.float32)
            for i in range(n_int):
                children = lr[c, i]
                assert slot[i] not in [slot[h - n_tips] for h in children
                                       if h >= n_tips]
                rank_max = np.zeros((Q, T), np.float32)
                for r in range(Q):
                    for k in range(r * kq, min(K, r * kq + kq)):
                        w = [op[c, i, h, k] @ (
                            tip_t[ch] if ch < n_tips
                            else slots[slot[ch - n_tips], k])
                            for h, ch in enumerate(children)]
                        x = w[0] * w[1]
                        slots[slot[i], k] = x
                        rank_max[r] = np.maximum(rank_max[r], x.max(0))
                m = np.maximum(rank_max.max(0), np.float32(1e-30))
                slots[slot[i]] /= m
                lsum += np.log(m)
            keep = p0 + np.arange(T) < P
            root[c, :, :, p0:p0 + T] = slots[slot[-1]][..., keep]
            ls[c, p0:p0 + T] = lsum[keep]
    return root, ls


def _site_lnl(root, ls, pi):
    """root [C, K, S, P], ls [C, P], pi [S] -> per-pattern lnL [C, P]."""
    root = np.asarray(root, np.float64)
    return np.log(np.einsum("cksp,s->cp", root, pi) / root.shape[1]) \
        + np.asarray(ls, np.float64)


@pytest.mark.parametrize("n_tips,K,T", [(6, 8, 8), (9, 8, 32), (9, 16, 4),
                                        (6, 16, 16)])
def test_twin_matches_plain(n_tips, K, T):
    lr, op, tips, pi = _operands(n_tips, 20, 61, K, 2, seed=n_tips + K)
    root_t, ls_t = tiled_walk_twin(lr, op, tips, T=T)
    root_p, ls_p = PC.pruning_down_plain(
        torch.as_tensor(lr), torch.as_tensor(op), torch.as_tensor(tips))
    np.testing.assert_allclose(_site_lnl(root_t, ls_t, pi),
                               _site_lnl(root_p.numpy(), ls_p.numpy(), pi),
                               rtol=TOL, atol=TOL)


def test_twin_rank_split_is_exact():
    """Any split of the categories over the ranks gives the same result
    bit for bit (a max is exact in any order, and each category's products
    are the same)."""
    lr, op, tips, _ = _operands(9, 20, 61, 8, 2, seed=3)
    ref = tiled_walk_twin(lr, op, tips, T=8, Q=1)
    for Q in (2, 3, 8):
        out = tiled_walk_twin(lr, op, tips, T=8, Q=Q)
        assert all(np.array_equal(a, b) for a, b in zip(out, ref)), Q


@pytest.mark.parametrize("n_tips,K", [(9, 8), (6, 16)])
def test_twin_matches_jax_pallas_interpret(n_tips, K):
    """The JAX package's ``_pallas_batched`` on the same operators folded
    block-diagonally [KS, KS] and tiled tips, in TPU interpret mode as
    ``tests/test_pallas.py`` runs it."""
    P, S, C = 20, 61, 2
    lr, op, tips, pi = _operands(n_tips, P, S, K, C, seed=40 + n_tips)
    KS = K * S
    ksp, ppad = -(-KS // 8) * 8, 128
    bstep = np.zeros((C, n_tips - 1, 2, ksp, ksp), np.float32)
    for k in range(K):
        bstep[..., k * S:(k + 1) * S, k * S:(k + 1) * S] = op[:, :, :, k]
    jt = np.ones((n_tips, ksp, ppad), np.float32)
    jt[:, :KS, :P] = np.tile(tips, (1, K, 1))
    jt[:, KS:, :] = 0.0
    with pltpu.force_tpu_interpret_mode():
        root_j, ls_j = jax.block_until_ready(_pallas_batched(
            jnp.asarray(lr), jnp.asarray(bstep), jnp.asarray(jt), n_tips))
    root_j = np.asarray(root_j)[:, :KS, :P].reshape(C, K, S, P)
    root_t, ls_t = tiled_walk_twin(lr, op, tips, T=8)
    np.testing.assert_allclose(_site_lnl(root_t, ls_t, pi),
                               _site_lnl(root_j, np.asarray(ls_j)[:, :P], pi),
                               rtol=TOL, atol=TOL)


def _producer(n_int, nk):
    """The producer warp's actions (csrc/tiled_walk.cuh): before waiting
    for the release of a chunk of step j it has arrived at the cluster
    barriers of steps 0 .. j, each arrival after waiting on the barrier
    before; then the remaining barriers and the last one."""
    arrived = 0

    def arrive_through(k):
        nonlocal arrived
        while arrived <= k:
            if arrived:
                yield ("wait",)
            yield ("arrive",)
            arrived += 1
    for c in range(n_int * nk):
        if c >= 2:
            yield from arrive_through((c - 2) // nk)
            yield ("released", c - 2)
        yield ("issue", c)
    yield from arrive_through(n_int)
    yield ("wait",)


def _consumers(n_int, nk):
    """The consumer warps' actions: each chunk waited for and released,
    a cluster barrier (arrive and wait) a step, and the last one."""
    for i in range(n_int + 1):
        for u in range(nk if i < n_int else 0):
            yield ("issued", i * nk + u)
            yield ("release", i * nk + u)
        yield ("arrive",)
        yield ("wait",)


def _run_cluster(n_int, nks):
    """Step a cluster of blocks (each a producer and its consumers, nks[b]
    chunks a step) until all finish: a wait on barrier k goes on once
    every actor has arrived at it.  False on a deadlock."""
    actors, done = [], []
    for nk in nks:
        chunks = {"issue": set(), "release": set()}
        for gen in (_producer(n_int, nk), _consumers(n_int, nk)):
            actors.append({"gen": gen, "chunks": chunks, "arrived": 0,
                           "waited": 0, "next": next(gen)})
    while any(a["next"] is not None for a in actors):
        moved = False
        for a in actors:
            act = a["next"]
            if act is None:
                continue
            if act[0] in ("issue", "release"):
                a["chunks"][act[0]].add(act[1])
            elif act[0] in ("issued", "released"):
                key = "issue" if act[0] == "issued" else "release"
                if act[1] not in a["chunks"][key]:
                    continue
            elif act[0] == "arrive":
                a["arrived"] += 1
            elif all(b["arrived"] > a["waited"] for b in actors):
                a["waited"] += 1
            else:
                continue
            a["next"] = next(a["gen"], None)
            moved = True
        if not moved:
            return False
    return True


@pytest.mark.parametrize("nks", [[1] * 8, [2] * 8, [3, 3, 2], [8], [16],
                                 [2, 2, 2, 2, 1]])
@pytest.mark.parametrize("n_int", [3, 8, 113])
def test_producer_schedule_never_deadlocks(n_int, nks):
    """The producer's barrier schedule against its consumers' across a
    cluster whose blocks hold nks chunks a step (a block holding the whole
    step's K chunks included)."""
    assert _run_cluster(n_int, nks)


@pytest.mark.parametrize("n_tips", [4, 5, 9, 33, 114])
def test_spare_slot_map(n_tips):
    """The spare map: a step's slot is never one of its children's, no live
    partial is overwritten, at most n_tips // 2 + 1 slots."""
    rng = np.random.default_rng(n_tips)
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(4)]
    left, right, parent = (torch.as_tensor(np.stack(
        [getattr(t, f) for t in trees])).long()
        for f in ("left", "right", "parent"))
    lr = PC.slot_operands(postorder_internal(parent, n_tips), left, right,
                          n_tips)[0].numpy()
    for c in range(lr.shape[0]):
        slot = PC.live_slot_map(lr[c], n_tips, spare=True)
        live = {}
        for i, children in enumerate(lr[c]):
            assert slot[i] not in live, "a live slot was overwritten"
            for h in children:
                if h >= n_tips:
                    assert live.pop(slot[h - n_tips]) == h - n_tips
            live[slot[i]] = i
        assert slot.max() + 1 <= n_tips // 2 + 1


@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("shape,walk", [((9, 239, 61, 8), "tiled"),
                                        ((114, 240, 61, 3), "tiled"),
                                        ((114, 240, 61, 8), "tiled"),
                                        ((9, 239, 61, 3), "staged"),
                                        # 128 lanes a pattern on chip: the
                                        # rule divided by zero before
                                        ((9, 50, 61, 9), "tiled")])
def test_size_rule_codon_shapes(shape, walk, C):
    n_tips, P, S, K = shape
    plan = PC.size_rule(C, n_tips, K, S, P)
    assert plan["walk"] == walk, plan
    assert plan["smem_bytes"] <= PC.H100_SMEM_OPTIN
    if walk == "tiled":
        assert plan["cluster"] == PC.tiled_cluster(K) and plan["T"] in (
            4, 8, 16, 32) and plan["threads"] <= 160


def test_size_rule_keeps_every_listed_walk():
    """Every pruning.cu shape that chip_smoke.py and the gpu cases of
    tests/test_torch_pruning.py list keeps its walk, the global-scratch
    ones now tiled, with its 0/1 tips packed as chip_smoke.py packs them
    (the 169-taxon cases take the Strahler walk)."""
    sm = _smoke()
    cases = [(n, P, S, K, C) for n, P, S, K, C in sm.KERNEL_CASES]
    cases += [shape + (C,) for shape in sm.KIM_CODON_SHAPES
              for C in (8, 32)]
    expect = {**sm.KERNEL_WALKS, **sm.KIM_CODON_WALKS}
    gpu_cases = [(8, 137, 4, 4), (12, 434, 4, 1), (6, 40, 20, 2),
                 (12, 413, 4, 4), (32, 34, 3, 4), (32, 9, 8, 4),
                 (32, 100, 20, 4), (6, 40, 61, 3), (9, 70, 32, 16),
                 (9, 239, 61, 8), (114, 240, 61, 3)]
    cases += [shape + (4,) for shape in gpu_cases]
    was_global = {(9, 70, 32, 16), (9, 239, 61, 8)}
    for n, P, S, K, C in cases:
        walk = PC.size_rule(C, n, K, S, P, packed=True)["walk"]
        assert walk == expect.get((n, P, S, K), "whole"), (n, P, S, K, C)
        assert (walk == "tiled") == ((n, P, S, K) in was_global
                                     or n == 114), (n, P, S, K, C)


@pytest.mark.parametrize("shape,plan", [
    # the blocks the card chose for primates and for the kim and codon
    # shapes at C 8 (PERF.md §6)
    ((4, 12, 4, 4, 413), ("whole", 128, 8, 16, 10768)),
    ((32, 12, 4, 4, 413), ("whole", 256, 32, 8, 24592)),
    ((8, 27, 1, 16, 78), ("whole", 64, 4, 16, 64640)),
    ((8, 27, 4, 16, 78), ("whole", 64, 2, 32, 226752)),
    ((8, 27, 1, 20, 68), ("whole", 128, 4, 32, 97360)),
    ((8, 27, 1, 20, 32), ("whole", 32, 1, 32, 86720)),
    ((8, 9, 3, 61, 239), ("staged", 256, 8, 32, 222640))])
def test_size_rule_matches_recorded_blocks(shape, plan):
    out = PC.size_rule(*shape)
    assert (out["walk"], out["threads"], out["T"], out["lanes"],
            out["smem_bytes"]) == plan


def test_tiled_rule_limit():
    """The tiled walk takes S 61, K 8 up to 335 tips (T 4), and the
    global-scratch walk takes what is beyond (csrc/tiled_walk.cuh)."""
    assert PC.size_rule(8, 335, 8, 61, 240)["walk"] == "tiled"
    assert PC.size_rule(8, 335, 8, 61, 240)["T"] == 4
    assert PC.size_rule(8, 336, 8, 61, 240)["walk"] == "global"
