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

The kernel's own allocator runs only on a GPU; ``chip_smoke.py`` and the
``gpu``-marked tests of ``test_torch_pruning.py`` hold its results to the
plain version there."""
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
