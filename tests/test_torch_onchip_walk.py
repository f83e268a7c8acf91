"""The on-chip walk's live-slot allocator (``csrc/onchip_walk.cuh``)
through its Python twin ``ops/pruning_cuda.py:live_slot_map``.

* On seeded random trees of 4-128 tips (the engine's postorder) and on
  caterpillar and balanced trees, the latter also in level order (the
  order in which the most partials are alive at once), the map uses at
  most n_tips // 2 slots and never overwrites a live slot, and the level
  order of a balanced tree of 2^k tips needs all n_tips // 2.
* A plain walk that keeps its partials in those slots equals
  ``pruning_down_plain`` exactly (the same products on the same inputs).
* The wavefront kernel's slot map (``csrc/wavefront.cu``, its twin
  ``ops/wavefront_cuda.py:chain_slot_map``: a slot a cherry, every other
  step writing its first internal child's) uses as many slots as the
  tree has cherries, at most n_tips // 2, on random, caterpillar and
  balanced trees of 4-128 tips; over the rows of ``row_schedule`` every
  read finds its child, no write overwrites a live partial, and no step
  writes a slot that another step of its row reads or writes, so the
  kernel needs no block barrier inside a row.

* The Strahler walk's schedule (``csrc/strahler_walk.cuh``, its twin
  ``ops/pruning_cuda.py:strahler_schedule``) on random engine trees,
  caterpillars and balanced trees of 4-335 tips: a postorder (each step
  once, children first, the root last) whose slots never overwrite a
  live partial and stay within floor(log2 n_tips), the bound tight on
  balanced trees of 2^k tips; a walk of ``pruning_down_plain``'s
  arithmetic in that order and those slots gives the same root partials
  bit for bit and ls within float32 rounding of the sum's new order.
* The packed tips (``pack_tips``) round-trip to the 0/1 tips, and tips
  with any other value, or S > 32, are not packed.
* The size rule's twin takes the Strahler walk at the benchmark cells'
  shapes with 8 or more busy warps an SM, and keeps its plan, packed tips
  or not, at every ``chip_smoke.py`` kernel case before them and at
  primates' shape.

The kernel's own allocator runs only on a GPU; ``chip_smoke.py`` and the
``gpu``-marked tests of ``test_torch_pruning.py`` hold its results to the
plain version there."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from mrbayes_tpu_torch.ops import pruning_cuda as PC
from mrbayes_tpu_torch.ops import wavefront_cuda as WF
from mrbayes_tpu_torch.ops.traversal import postorder_internal
from mrbayes_tpu_torch.trees import random_unrooted

# the tensors here are small: intra-op threads would only contend with
# the other test workers
torch.set_num_threads(1)


def _engine_lr(n_tips, C, seed):
    """lr [C, n_int, 2] of C random trees in the engine's postorder."""
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    left, right, parent = (torch.as_tensor(np.stack(
        [getattr(t, f) for t in trees])).long()
        for f in ("left", "right", "parent"))
    order = postorder_internal(parent, n_tips)
    return PC.slot_operands(order, left, right, n_tips)[0].numpy()


def _level_lr(n_tips, shape):
    """lr [n_int, 2] of a caterpillar or balanced tree whose internal nodes
    are computed level by level (node n_tips + i at step i)."""
    level, nxt, lr = list(range(n_tips)), n_tips, []
    while len(level) > 1:
        k = 1 if shape == "caterpillar" else len(level) // 2
        up = []
        for a, b in zip(level[0:2 * k:2], level[1:2 * k:2]):
            lr.append((a, b))
            up.append(nxt)
            nxt += 1
        level = up + level[2 * k:]
    return np.asarray(lr, np.int64)


def _check_map(lr, n_tips):
    """The map's slots against the live partials at every step; returns
    the number of slots used."""
    slot = PC.live_slot_map(lr, n_tips)
    live = {}                        # slot -> step whose partial it holds
    for i, children in enumerate(lr):
        for c in children:
            if c >= n_tips:
                j = int(c - n_tips)
                assert live.pop(slot[j]) == j, "a live partial was lost"
        assert slot[i] not in live, "a live slot was overwritten"
        live[slot[i]] = i
    used = int(slot.max()) + 1
    assert used <= n_tips // 2
    return used


@pytest.mark.parametrize("n_tips", [4, 5, 12, 32, 33, 64, 127, 128])
def test_slot_map_on_random_trees(n_tips):
    lr = _engine_lr(n_tips, C=6, seed=n_tips)
    for c in range(lr.shape[0]):
        _check_map(lr[c], n_tips)


@pytest.mark.parametrize("n_tips", [4, 7, 16, 32, 100, 128])
@pytest.mark.parametrize("shape", ["caterpillar", "balanced"])
def test_slot_map_on_level_order(n_tips, shape):
    used = _check_map(_level_lr(n_tips, shape), n_tips)
    if shape == "caterpillar":
        assert used == 1
    elif n_tips & (n_tips - 1) == 0:
        assert used == n_tips // 2          # the bound is tight


def _check_row_map(lr, n_tips, W):
    """The wavefront's slot map against the live partials, row by row,
    each step reading its children and then writing its slot.  Returns
    (slots used, rows in which a step writes a slot that another step of
    the row reads or writes)."""
    seq, rowbeg = WF.row_schedule(lr, n_tips, W)
    slot = WF.chain_slot_map(lr, n_tips)
    n_int = len(seq)
    assert slot[n_int - 1] == -1                 # the root's own output
    live, clashes = {}, 0
    for a, b in zip(rowbeg[:-1], rowbeg[1:]):
        row = seq[a:b]
        reads = {}
        for i in row:
            for c in lr[i]:
                if c >= n_tips:
                    j = int(c - n_tips)
                    assert live.get(slot[j]) == j, "a read found no child"
                    reads[slot[j]] = i
        writes = {}
        for i in row:
            if i != n_int - 1:
                clashes += slot[i] in writes or reads.get(slot[i], i) != i
                writes[slot[i]] = i
        for s in reads:
            del live[s]
        for s, i in writes.items():
            assert s not in live, "a live slot was overwritten"
            live[s] = i
    used = int(slot.max()) + 1
    cherries = sum(c0 < n_tips and c1 < n_tips for c0, c1 in lr)
    assert used == cherries <= n_tips // 2
    return used, clashes


@pytest.mark.parametrize("n_tips", [4, 5, 12, 32, 33, 64, 127, 128])
@pytest.mark.parametrize("W", [1, 8, 16])
def test_row_slot_map_on_random_trees(n_tips, W):
    lr = _engine_lr(n_tips, C=6, seed=n_tips + W)
    for c in range(lr.shape[0]):
        used, clashes = _check_row_map(lr[c], n_tips, W)
        assert clashes == 0


@pytest.mark.parametrize("n_tips", [4, 7, 16, 32, 100, 128])
@pytest.mark.parametrize("shape", ["caterpillar", "balanced"])
def test_row_slot_map_on_level_order(n_tips, shape):
    used, clashes = _check_row_map(_level_lr(n_tips, shape), n_tips, 8)
    # a step writes only the slot of its own first internal child, so no
    # row needs a barrier between its reads and its writes: the warp
    # barrier inside the step orders the step's own
    assert clashes == 0
    if shape == "caterpillar":
        assert used == 1
    elif n_tips & (n_tips - 1) == 0:
        assert used == n_tips // 2          # the bound is tight


def _plain_walk_through_map(lr, pstep, tips):
    """pruning_down_plain's arithmetic with the partials kept in the live
    slots of each chain's map: buffer rows n_tips + s are the slots."""
    C, n_int = lr.shape[:2]
    K, S = pstep.shape[3], pstep.shape[4]
    n_tips, _, P = tips.shape
    L = n_tips // 2
    slots = np.stack([PC.live_slot_map(lr[c].numpy(), n_tips)
                      for c in range(C)])
    code = lr.long().clone()
    internal = code >= n_tips
    step = (code - n_tips).clamp_min(0)
    code[internal] = n_tips + torch.as_tensor(slots).gather(
        1, step.flatten(1)).view_as(code)[internal]
    out_row = n_tips + torch.as_tensor(slots)
    rows = torch.arange(C)
    cl = tips.new_empty((C, n_tips + L, K, S, P))
    cl[:, :n_tips] = tips[None, :, None]
    ls = tips.new_zeros((C, P))
    for i in range(n_int):
        wl = torch.einsum("cksj,ckjp->cksp", pstep[:, i, 0],
                          cl[rows, code[:, i, 0]])
        wr = torch.einsum("cksj,ckjp->cksp", pstep[:, i, 1],
                          cl[rows, code[:, i, 1]])
        x = wl * wr
        m = torch.clamp_min(x.amax(dim=(1, 2)), 1e-30)
        if i == n_int - 1:
            root = x / m[:, None, None]
        else:
            cl[rows, out_row[:, i]] = x / m[:, None, None]
        ls = ls + torch.log(m)
    return root, ls


@pytest.mark.parametrize("n_tips,P,S,K,C", [(12, 41, 4, 4, 3),
                                            (32, 34, 3, 4, 2),
                                            (32, 9, 8, 4, 2),
                                            (9, 20, 20, 1, 2)])
def test_walk_through_the_map_equals_the_plain_version(n_tips, P, S, K, C):
    rng = np.random.default_rng(P)
    lr = torch.as_tensor(_engine_lr(n_tips, C, seed=S))
    tips = (rng.random((n_tips, S, P)) < 0.4).astype(np.float32)
    tips[:, 0] = 1.0
    pstep = rng.random((C, n_tips - 1, 2, K, S, S)).astype(np.float32) + 0.05
    pstep /= pstep.sum(-1, keepdims=True)
    tips, pstep = torch.as_tensor(tips), torch.as_tensor(pstep)
    root_m, ls_m = _plain_walk_through_map(lr, pstep, tips)
    root_p, ls_p = PC.pruning_down_plain(lr, pstep, tips)
    assert torch.equal(root_m, root_p) and torch.equal(ls_m, ls_p)


def test_check_kernel_shape_names_the_templated_states():
    for S in PC.TEMPLATED_S:
        PC.check_kernel_shape(S, 40, "pruning_down")
    with pytest.raises(ValueError, match=r"templated S in \(2, 3, 4, 8, 20\)"):
        PC.check_kernel_shape(61, 17, "pruning_down")


# ------------------------------------------------- the Strahler walk's order

STRAHLER_TIPS = [4, 12, 33, 114, 128, 169, 335]


def _tree_lr(n_tips, shape, k=0):
    """lr [n_int, 2] of the engine's k-th random tree, or of a caterpillar
    or balanced tree in level order."""
    if shape == "random":
        return _engine_lr(n_tips, C=k + 1, seed=n_tips)[k]
    return _level_lr(n_tips, shape)


def _check_schedule(lr, n_tips):
    """The schedule against a replay of the walk; returns the slots
    used."""
    sched = PC.strahler_schedule(lr, n_tips)
    n_int = len(lr)
    order, slot = PC.strahler_slot_map(lr, n_tips)
    assert sorted(order.tolist()) == list(range(n_int)), "a step twice"
    assert order[-1] == n_int - 1, "the root is not last"
    live, done = {}, set()
    for q, (i, lc, rc, s) in enumerate(sched):
        assert slot[i] == s
        for h, code in enumerate((lc, rc)):
            child = lr[i][h]
            if child < n_tips:
                assert code == child
            else:
                j = int(child - n_tips)
                assert j in done, "a parent before its child"
                assert code == -slot[j] - 1
                assert live.pop(slot[j]) == j, "a live partial was lost"
        if q < n_int - 1:
            assert s not in live, "a live slot was overwritten"
            live[s] = i
        done.add(int(i))
    used = int(sched[:-1, 3].max()) + 1 if n_int > 1 else 0
    assert used <= PC.strahler_slots(n_tips)
    return used


@pytest.mark.parametrize("shape", ["random", "caterpillar", "balanced"])
@pytest.mark.parametrize("n_tips", STRAHLER_TIPS)
def test_strahler_schedule_is_a_postorder_within_log2_slots(n_tips, shape):
    for k in range(3 if shape == "random" else 1):
        used = _check_schedule(_tree_lr(n_tips, shape, k), n_tips)
        if shape == "caterpillar":
            assert used == 1
        elif shape == "balanced" and n_tips & (n_tips - 1) == 0:
            # the bound is tight
            assert used == PC.strahler_slots(n_tips) == n_tips.bit_length() - 1


def _plain_walk_in_strahler_order(lr, pstep, tips):
    """pruning_down_plain's arithmetic, batched over chains as it is, with
    each chain's steps in its Strahler order and its partials in the
    schedule's slots: buffer rows n_tips + s are the slots."""
    C, n_int = lr.shape[:2]
    K, S = pstep.shape[3], pstep.shape[4]
    n_tips, _, P = tips.shape
    sched = torch.as_tensor(np.stack([
        PC.strahler_schedule(lr[c].numpy(), n_tips) for c in range(C)]))
    code = sched[:, :, 1:3]
    rowof = torch.where(code >= 0, code, n_tips - code - 1)
    rows = torch.arange(C)
    cl = tips.new_empty((C, n_tips + PC.strahler_slots(n_tips), K, S, P))
    cl[:, :n_tips] = tips[None, :, None]
    ls = tips.new_zeros((C, P))
    for q in range(n_int):
        step = sched[:, q, 0]
        wl = torch.einsum("cksj,ckjp->cksp", pstep[rows, step, 0],
                          cl[rows, rowof[:, q, 0]])
        wr = torch.einsum("cksj,ckjp->cksp", pstep[rows, step, 1],
                          cl[rows, rowof[:, q, 1]])
        x = wl * wr
        m = torch.clamp_min(x.amax(dim=(1, 2)), 1e-30)
        if q == n_int - 1:
            root = x / m[:, None, None]
        else:
            cl[rows, n_tips + sched[:, q, 3]] = x / m[:, None, None]
        ls = ls + torch.log(m)
    return root, ls


@pytest.mark.parametrize("n_tips,P,S,K,C", [(12, 41, 4, 4, 3),
                                            (33, 20, 3, 4, 2),
                                            (114, 12, 4, 4, 2),
                                            (169, 10, 4, 4, 2),
                                            (9, 20, 20, 1, 2)])
def test_walk_in_strahler_order_equals_the_plain_version(n_tips, P, S, K, C):
    rng = np.random.default_rng(P + n_tips)
    lr = torch.as_tensor(_engine_lr(n_tips, C, seed=S + n_tips))
    tips = (rng.random((n_tips, S, P)) < 0.4).astype(np.float32)
    tips[:, 0] = 1.0
    pstep = rng.random((C, n_tips - 1, 2, K, S, S)).astype(np.float32) + 0.05
    pstep /= pstep.sum(-1, keepdims=True)
    tips, pstep = torch.as_tensor(tips), torch.as_tensor(pstep)
    root_s, ls_s = _plain_walk_in_strahler_order(lr, pstep, tips)
    root_p, ls_p = PC.pruning_down_plain(lr, pstep, tips)
    assert torch.equal(root_s, root_p)
    # the same n_int float32 terms summed in another order
    tol = (n_tips - 1) * torch.finfo(torch.float32).eps * ls_p.abs().max()
    assert (ls_s - ls_p).abs().max() <= tol


# ----------------------------------------------------------- packed tips

def _unpack(masks, S, P):
    """The float tips [n_tips, S, P] of ``pack_tips``'s masks."""
    word = masks[:, :P].to(torch.int64) & (2 ** 32 - 1)
    bit = torch.arange(S, dtype=torch.int64)
    return ((word[:, None, :] >> bit[None, :, None]) & 1).to(torch.float32)


@pytest.mark.parametrize("S", [2, 3, 4, 8, 20, 32])
def test_pack_tips_round_trips(S):
    rng = np.random.default_rng(S)
    n_tips, P = 7, 37
    tips = torch.as_tensor((rng.random((n_tips, S, P)) < 0.5)
                           .astype(np.float32))
    tips[0, :, 0] = 1.0                     # every bit, bit 31 at S 32
    masks = PC.pack_tips(tips)
    assert masks.dtype == (torch.uint8 if S <= 8 else torch.int32)
    assert masks.shape == (n_tips, PC.mask_pitch(S, P))
    assert PC.mask_pitch(S, P) == (40 if S <= 8 else 37)
    assert torch.equal(_unpack(masks, S, P), tips)
    if S <= 8:
        assert not masks[:, P:].any()       # the pitch's padding


def test_tips_not_0_1_are_not_packed():
    rng = np.random.default_rng(3)
    tips = (rng.random((9, 50, 4)) < 0.5).astype(np.float32)   # [n, P, S]
    assert PC.PruningCuda(tips, 4, "cpu").masks is not None
    tips[3, 7, 2] = 0.5
    assert PC.PruningCuda(tips, 4, "cpu").masks is None
    assert PC.pack_tips(torch.ones((5, 61, 10))) is None       # S > 32


# ------------------------------------------------------------ size rule

def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.mark.parametrize("C,n_tips,K,S,P", [(32, 169, 4, 4, 23000),
                                            (16, 169, 4, 4, 1270)])
def test_size_rule_takes_the_strahler_walk_at_the_cells(C, n_tips, K, S, P):
    today = PC.size_rule(C, n_tips, K, S, P)
    plan = PC.size_rule(C, n_tips, K, S, P, packed=True)
    assert today["walk"] == "whole" and PC.busy_warps(today, C, P) <= 2
    assert plan["walk"] in PC.STRAHLER_WALKS
    assert PC.busy_warps(plan, C, P) >= 8
    assert plan["smem_bytes"] <= PC.H100_SMEM_OPTIN


KEPT = [c for c in CS.KERNEL_CASES if c not in CS.HACKETT_SHAPES] \
    + [(12, 413, 4, 4, C) for C in (4, 32)]


@pytest.mark.parametrize("n_tips,P,S,K,C", KEPT)
def test_size_rule_keeps_its_plan_at_the_kernel_cases(n_tips, P, S, K, C):
    today = PC.size_rule(C, n_tips, K, S, P)
    assert PC.size_rule(C, n_tips, K, S, P, packed=True) == today
    assert today["walk"] == CS.KERNEL_WALKS.get((n_tips, P, S, K), "whole")
