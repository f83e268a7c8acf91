"""The port's wavefront pass (``ops/wavefront_cuda.py``) against the JAX
package.

Seeded numpy operands (one random tree per chain, random 0/1 tips, one
reversible eigensystem per chain and per-chain category rates) go through

* JAX ``PruningPallasWavefront`` under ``jax.vmap`` inside
  ``pltpu.force_tpu_interpret_mode()``, as ``tests/test_pallas.py`` runs
  it, and JAX ``root_partials`` per chain;
* ``PruningCudaWavefront`` on CPU tensors (its plain version).

Per-pattern lnL agrees within rtol/atol 2e-5 (float32 products summed in a
different order) on ``tests/test_pallas.py::test_wavefront_matches_scan``'s
three cases and a 24-tip S = 8, K = 1 case, at 1 and 4 chains.  The
schedule's invariants are checked on random, caterpillar and balanced
trees; the numpy twin of the kernel's in-block schedule (``row_schedule``)
gives ``wavefront_schedule``'s rows on the engine's postorder, and valid
rows on shuffled children-before-parents orders, where the plain version
still equals ``pruning_down_plain`` within 2e-5.  The CUDA kernel itself
runs only on a GPU: ``test_kernel_matches_plain_on_gpu`` carries the
``gpu`` marker and skips here; ``chip_smoke.py`` holds it to the plain
version on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mrbayes_tpu.models.substitution import nuc_q_gtr, reversible_q
from mrbayes_tpu.ops.pruning import root_partials as j_root_partials
from mrbayes_tpu.ops.pruning_pallas import PruningPallasWavefront
from mrbayes_tpu.ops.tiprobs import eigh_reversible
from mrbayes_tpu.ops.tiprobs import transition_probs as j_transition_probs
from mrbayes_tpu.ops.traversal import postorder_internal as j_postorder
from mrbayes_tpu_torch.ops import pruning_cuda as PC
from mrbayes_tpu_torch.ops import wavefront_cuda as WF
from mrbayes_tpu_torch.ops.traversal import postorder_internal
from mrbayes_tpu_torch.trees import Tree, random_unrooted

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
# (n_tips, P, S, K, W): tests/test_pallas.py's cases and S = 8, K = 1
CASES = [(24, 137, 4, 4, 8), (40, 300, 4, 1, 8), (24, 64, 2, 4, 4),
         (24, 50, 8, 1, 8)]


def _case(n_tips, P, S, K, C, seed):
    """One random tree per chain, shared tips, one reversible eigensystem
    and category-rate set per chain, and each chain's transition matrices
    P [C, n_nodes, K, S, S] from them (JAX transition_probs, the formula
    of JAX root_partials): numpy, from a seed."""
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    tips = (rng.random((n_tips, P, S)) < 0.4).astype(np.float32)
    tips[..., 0] = 1.0
    eigs, Ps, pis = [], [], []
    for c, t in enumerate(trees):
        pi = rng.random(S) + 0.2
        pi = jnp.asarray(pi / pi.sum(), jnp.float32)
        if S == 4:
            Q = nuc_q_gtr(jnp.asarray(rng.random(6), jnp.float32), pi)
        else:
            Q = reversible_q(jnp.asarray(rng.random(S * (S - 1) // 2),
                                         jnp.float32), pi)
        lam, U, V = eigh_reversible(Q, pi)
        cat = jnp.linspace(0.3, 2.2, K) * (1 + 0.1 * c)
        eff = jnp.asarray(t.blen, jnp.float32)[:, None] * cat[None, :]
        Ps.append(np.asarray(j_transition_probs(lam, U, V, eff)))
        eigs.append((lam, U, V, cat))
        pis.append(np.asarray(pi))
    tree = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int64)
            for f in ("left", "right", "parent")}
    tree["blen"] = np.stack([t.blen for t in trees]).astype(np.float32)
    return tree, tips, eigs, np.stack(Ps).astype(np.float32), np.stack(pis)


def _site_lnl(root, ls, pi):
    """root [C, K, S, P], ls [C, P], pi [C, S] -> per-pattern lnL."""
    K = root.shape[1]
    return np.log(np.einsum("cksp,cs->cp", root, pi) / K) + ls


def _jax_wavefront(tree, tips, Pm, K, W, n_tips):
    """(root [C, K, S, P], ls [C, P]) from the Pallas kernel in TPU
    interpret mode, vmapped over chains."""
    pruner = PruningPallasWavefront(tips, K, W=W)

    def one(parent, left, right, P):
        order = j_postorder(parent, n_tips)
        return pruner(order, left, right, P, parent=parent)

    with pltpu.force_tpu_interpret_mode():
        root, ls = jax.jit(jax.vmap(one))(
            *(jnp.asarray(tree[f], jnp.int32)
              for f in ("parent", "left", "right")), jnp.asarray(Pm))
        root, ls = jax.block_until_ready((root, ls))
    return np.asarray(root).transpose(0, 2, 3, 1), np.asarray(ls)


def _jax_scan(tree, tips, eigs, n_tips):
    """The same pass through JAX root_partials, one chain at a time."""
    roots, lss = [], []
    for c, (lam, U, V, cat) in enumerate(eigs):
        parts, ls = j_root_partials(
            *(jnp.asarray(tree[f][c]) for f in ("left", "right", "parent",
                                                "blen")),
            jnp.asarray(tips), lam, U, V, cat, 0.0, n_tips)
        roots.append(np.asarray(parts[2 * n_tips - 2]).transpose(1, 2, 0))
        lss.append(np.asarray(ls))
    return np.stack(roots), np.stack(lss)


def _port(tree, tips, Pm, K, W, n_tips):
    pruner = WF.PruningCudaWavefront(tips, K, "cpu", W=W)
    t = {f: torch.as_tensor(v) for f, v in tree.items()}
    order = postorder_internal(t["parent"], n_tips)
    root, ls = pruner(order, t["left"], t["right"], torch.as_tensor(Pm))
    assert pruner.launches == 0          # CPU tensors: the plain version
    return root.numpy(), ls.numpy()


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("n_tips,P,S,K,W", CASES)
def test_plain_matches_jax_pallas_interpret_and_scan(n_tips, P, S, K, W, C):
    tree, tips, eigs, Pm, pi = _case(n_tips, P, S, K, C, seed=n_tips + C)
    got = _site_lnl(*_port(tree, tips, Pm, K, W, n_tips), pi)
    ref = _site_lnl(*_jax_wavefront(tree, tips, Pm, K, W, n_tips), pi)
    np.testing.assert_allclose(got, ref, **TOL)
    scan = _site_lnl(*_jax_scan(tree, tips, eigs, n_tips), pi)
    np.testing.assert_allclose(got, scan, **TOL)


def _caterpillar(n_tips):
    """Unrooted caterpillar in the package's layout (root = last node)."""
    n = 2 * n_tips - 1
    parent = np.full(n, -1, np.int64)
    left = np.full(n, -1, np.int64)
    right = np.full(n, -1, np.int64)
    prev = 0
    for i, v in enumerate(range(n_tips, n)):
        left[v], right[v] = prev, i + 1
        parent[prev] = parent[i + 1] = v
        prev = v
    return Tree(parent=parent, left=left, right=right,
                blen=np.full(n, 0.1), n_tips=n_tips, rooted=False)


def _balanced(n_tips):
    """Balanced tree: pair nodes level by level, an odd one carried up
    (perfectly balanced where n_tips is a power of two)."""
    n = 2 * n_tips - 1
    parent = np.full(n, -1, np.int64)
    left = np.full(n, -1, np.int64)
    right = np.full(n, -1, np.int64)
    level, nxt = list(range(n_tips)), n_tips
    while len(level) > 1:
        up = []
        for a, b in zip(level[::2], level[1::2]):
            left[nxt], right[nxt] = a, b
            parent[a] = parent[b] = nxt
            up.append(nxt)
            nxt += 1
        level = up + level[len(level) - len(level) % 2:]
    return Tree(parent=parent, left=left, right=right,
                blen=np.full(n, 0.1), n_tips=n_tips, rooted=False)


def _shaped(shape, n_tips, rng):
    return {"random": lambda: random_unrooted(n_tips, rng, mean_blen=0.1),
            "caterpillar": lambda: _caterpillar(n_tips),
            "balanced": lambda: _balanced(n_tips)}[shape]()


def _tree_tensors(ts):
    return {f: torch.as_tensor(np.stack([getattr(x, f) for x in ts])).long()
            for f in ("left", "right", "parent")}


def _shuffled_order(t, c, n_tips, rng):
    """A random children-before-parents order of chain c's internal nodes
    (the root last): each next node drawn among those whose children have
    all run."""
    left, right = t["left"][c].numpy(), t["right"][c].numpy()
    n = left.shape[0]
    done = np.zeros(n, bool)
    done[:n_tips] = True
    order = []
    while len(order) < n - n_tips:
        ready = [v for v in range(n_tips, n) if not done[v]
                 and done[left[v]] and done[right[v]]]
        v = ready[rng.integers(len(ready))]
        done[v] = True
        order.append(v)
    return order


def _rows_of(bidx, wmask, W):
    """Each row's steps (the live entries' operator rows), in order."""
    rows = []
    for r in range(bidx.shape[0] // W):
        live = wmask[r * W:(r + 1) * W] > 0
        if live.any():
            rows.append(bidx[r * W:(r + 1) * W][live].tolist())
    return rows


@pytest.mark.parametrize("shape", ["random", "caterpillar", "balanced"])
@pytest.mark.parametrize("W", [4, 8])
def test_schedule_invariants(shape, W):
    n_tips = 32
    rng = np.random.default_rng(3)
    t = _tree_tensors([_shaped(shape, n_tips, rng) for _ in range(3)])
    order = postorder_internal(t["parent"], n_tips)
    lr = PC.slot_operands(order, t["left"], t["right"], n_tips)[0]
    nrows, row_lr, row_out, bidx, wmask = WF.wavefront_schedule(lr, n_tips,
                                                                W)
    n_int = n_tips - 1
    trash = n_tips + n_int
    assert nrows.dtype == torch.int32 and row_lr.shape == (3, n_int * W, 2)
    for c in range(3):
        nr = int(nrows[c])
        assert 1 <= nr <= n_int
        live = wmask[c] > 0
        # every internal node's output slot exactly once, in rows < nrows
        assert sorted(row_out[c][live].tolist()) == list(
            range(n_tips, n_tips + n_int))
        assert int(live.nonzero().max()) < nr * W
        # padded entries are masked and point at the trash slot with the
        # zero operator
        assert (row_out[c][~live] == trash).all()
        assert (row_lr[c][~live] == trash).all()
        assert (bidx[c][~live] == n_int).all()
        # bidx e names the step whose output slot is n_tips + e
        assert (bidx[c][live] + n_tips == row_out[c][live]).all()
        # children are tips or outputs of earlier rows
        row_of = {int(row_out[c, e]): e // W
                  for e in live.nonzero()[:, 0].tolist()}
        for e in live.nonzero()[:, 0].tolist():
            for child in row_lr[c, e].tolist():
                assert child < n_tips or row_of[child] < e // W
    if shape == "caterpillar":
        assert (nrows == n_int).all()          # every node its own depth
    if shape == "balanced":
        # each level (16, 8, 4, 2, 1 nodes) in rows of at most W
        assert (nrows == sum(-(-(n_tips >> k) // W)
                             for k in range(1, 6))).all()


@pytest.mark.parametrize("shape", ["random", "caterpillar", "balanced"])
@pytest.mark.parametrize("n_tips", [4, 24, 32, 64, 128])
@pytest.mark.parametrize("W", [1, 3, 8])
def test_row_schedule_is_the_schedule(shape, n_tips, W):
    """The kernel's in-block schedule (its twin ``row_schedule``) gives,
    on the engine's postorder, the rows of ``wavefront_schedule`` (the
    port of JAX's), row by row and in order."""
    rng = np.random.default_rng(n_tips + W)
    t = _tree_tensors([_shaped(shape, n_tips, rng) for _ in range(2)])
    order = postorder_internal(t["parent"], n_tips)
    lr = PC.slot_operands(order, t["left"], t["right"], n_tips)[0]
    _, _, _, bidx, wmask = WF.wavefront_schedule(lr, n_tips, W)
    for c in range(2):
        seq, rowbeg = WF.row_schedule(lr[c].numpy(), n_tips, W)
        rows = [seq[a:b].tolist() for a, b in zip(rowbeg[:-1], rowbeg[1:])]
        assert rows == _rows_of(bidx[c], wmask[c], W)


@pytest.mark.parametrize("shape", ["random", "caterpillar", "balanced"])
@pytest.mark.parametrize("n_tips", [5, 32, 64])
def test_row_schedule_on_shuffled_orders(shape, n_tips):
    """On a shuffled children-before-parents order the twin's rows stay
    valid: every step once, rows of one depth and at most W steps, every
    internal child in an earlier row; and they are still
    ``wavefront_schedule``'s."""
    W = 8
    rng = np.random.default_rng(7 * n_tips)
    ts = [_shaped(shape, n_tips, rng) for _ in range(3)]
    t = _tree_tensors(ts)
    order = torch.as_tensor(np.stack([_shuffled_order(t, c, n_tips, rng)
                                      for c in range(3)]))
    lr = PC.slot_operands(order, t["left"], t["right"], n_tips)[0]
    depth = WF.step_depths(lr, n_tips)
    _, _, _, bidx, wmask = WF.wavefront_schedule(lr, n_tips, W)
    for c in range(3):
        seq, rowbeg = WF.row_schedule(lr[c].numpy(), n_tips, W)
        assert sorted(seq.tolist()) == list(range(n_tips - 1))
        row_of = {}
        for r, (a, b) in enumerate(zip(rowbeg[:-1], rowbeg[1:])):
            assert 1 <= b - a <= W
            assert len({int(depth[c, i]) for i in seq[a:b]}) == 1
            for i in seq[a:b]:
                for child in lr[c, i].tolist():
                    if child >= n_tips:
                        assert row_of[child - n_tips] < r
            row_of.update((int(i), r) for i in seq[a:b])
        rows = [seq[a:b].tolist() for a, b in zip(rowbeg[:-1], rowbeg[1:])]
        assert rows == _rows_of(bidx[c], wmask[c], W)


@pytest.mark.parametrize("n_tips,P,S,K", [(24, 37, 4, 4), (33, 20, 3, 2)])
def test_plain_on_a_shuffled_order_equals_pruning_plain(n_tips, P, S, K):
    """The plain version on operands in a shuffled children-before-parents
    order equals the sequential pass on the same operands within 2e-5 (the
    same products; log-scales summed in another order)."""
    C = 3
    tree, tips, _, Pm, pi = _case(n_tips, P, S, K, C, seed=P)
    t = {f: torch.as_tensor(v) for f, v in tree.items()}
    rng = np.random.default_rng(1)
    order = torch.as_tensor(np.stack([_shuffled_order(t, c, n_tips, rng)
                                      for c in range(C)]))
    pruner = WF.PruningCudaWavefront(tips, K, "cpu")
    lr, pstep = pruner.operands(order, t["left"], t["right"],
                                torch.as_tensor(Pm))
    got = WF.wavefront_down_plain(lr, pstep, pruner.tips)
    ref = PC.pruning_down_plain(lr, pstep, pruner.tips)
    np.testing.assert_allclose(_site_lnl(*(x.numpy() for x in got), pi),
                               _site_lnl(*(x.numpy() for x in ref), pi),
                               **TOL)


def test_wavefront_down_takes_cuda_tensors_only():
    """The wiring's operands are ``PruningCuda.operands``' (the kernel
    builds its rows itself); the launch refuses CPU tensors and the plain
    version int64 slots."""
    tree, tips, _, Pm, _ = _case(24, 40, 4, 2, 2, seed=1)
    pruner = WF.PruningCudaWavefront(tips, 2, "cpu")
    t = {f: torch.as_tensor(v) for f, v in tree.items()}
    order = postorder_internal(t["parent"], 24)
    lr, pstep = pruner.operands(order, t["left"], t["right"],
                                torch.as_tensor(Pm))
    ref = PC.PruningCuda(tips, 2, "cpu").operands(
        order, t["left"], t["right"], torch.as_tensor(Pm))
    assert torch.equal(lr, ref[0]) and torch.equal(pstep, ref[1])
    assert lr.shape == (2, 23, 2) and pstep.shape == (2, 23, 2, 2, 4, 4)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        WF.wavefront_down(lr, pstep, pruner.tips)
    with pytest.raises(TypeError):
        WF.wavefront_down_plain(lr.long(), pstep, pruner.tips)
    with pytest.raises(ValueError, match="row width"):
        WF.wavefront_down_plain(lr, pstep, pruner.tips, W=17)


@pytest.mark.parametrize("shape", ["random", "caterpillar", "balanced"])
def test_parent_from_children(shape):
    """The wiring's parent array, scattered from left/right, is the
    tree's own (-1 at the root)."""
    n_tips = 32
    rng = np.random.default_rng(5)
    t = _tree_tensors([_shaped(shape, n_tips, rng) for _ in range(3)])
    got = WF.parent_from_children(t["left"], t["right"], n_tips)
    assert torch.equal(got, t["parent"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run chip_smoke.py or pytest -m gpu "
                    "on a machine with one)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("n_tips,P,S,K,W", CASES)
def test_kernel_matches_plain_on_gpu(cuda_device, n_tips, P, S, K, W, C):
    tree, tips, _, Pm, pi = _case(n_tips, P, S, K, C, seed=7)
    pruner = WF.PruningCudaWavefront(tips, K, cuda_device, W=W)
    t = {f: torch.as_tensor(v, device=cuda_device) for f, v in tree.items()}
    order = postorder_internal(t["parent"], n_tips)
    lr, pstep = pruner.operands(order, t["left"], t["right"],
                                torch.as_tensor(Pm, device=cuda_device))
    k = WF.wavefront_down(lr, pstep, pruner.tips, W)
    p = WF.wavefront_down_plain(lr, pstep, pruner.tips, W)
    a = _site_lnl(*(x.cpu().numpy() for x in k), pi)
    b = _site_lnl(*(x.cpu().numpy() for x in p), pi)
    np.testing.assert_allclose(a, b, **TOL)
    # the root partials are the sequential walk's, bit for bit
    root, _ = PC.pruning_down(lr, pstep, pruner.tips)
    assert torch.equal(k[0], root)
