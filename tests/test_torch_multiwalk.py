"""The port's multiwalk pass (``ops/multiwalk_cuda.py``) against the JAX
package's Pallas multiwalk kernel.

Seeded numpy operands (one random tree per chain, random tips per
division, row-stochastic per-branch operators) go through JAX
``PruningPallasMultiwalk``, built directly from the division specs (so
the JAX engine's padded-width bucketing does not apply), under
``jax.vmap`` inside ``pltpu.force_tpu_interpret_mode()`` as
``tests/test_pallas.py`` runs it, and through ``PruningCudaMultiwalk`` on
CPU tensors (its plain version).  Each division's per-pattern lnL from
``div_view`` agrees within rtol/atol 2e-5 (float32 products summed in a
different order), at test1's shapes cut to 2 chains and at a group that
mixes K = 1 and K = 4.  The launch's tile map
(``MultiwalkLayout.tile_map``, shared with the stacked path) covers every
(division, pattern) once, the on-chip tiles first.  The CUDA kernel
itself runs only on a GPU: ``test_kernel_matches_plain_on_gpu`` carries
the ``gpu`` marker and skips here; ``chip_smoke.py`` holds it to the plain
version on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mrbayes_tpu.ops.pruning_pallas import PruningPallasMultiwalk
from mrbayes_tpu.ops.traversal import postorder_internal as j_postorder
from mrbayes_tpu_torch.ops import multiwalk_cuda as MW
from mrbayes_tpu_torch.ops import pruning_cuda as PC
from mrbayes_tpu_torch.ops.traversal import postorder_internal
from mrbayes_tpu_torch.trees import random_unrooted

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
N_TIPS = 12
TEST1 = ((199, 258), (4, 4))          # test1's two divisions, K = 4
MIXED_K = ((199, 258), (1, 4))


def _group(Ps, Ks, C, seed, S=4, n_tips=N_TIPS):
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    tree = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int64)
            for f in ("left", "right", "parent")}
    specs, Pms, pis = [], [], []
    for P, K in zip(Ps, Ks):
        tips = (rng.random((n_tips, P, S)) < 0.4).astype(np.float32)
        tips[..., 0] = 1.0
        Pm = rng.random((C, 2 * n_tips - 1, K, S, S)).astype(np.float32)
        Pm += 0.05
        Pm /= Pm.sum(-1, keepdims=True)
        pi = rng.random(S).astype(np.float32) + 0.2
        specs.append((tips, K))
        Pms.append(Pm)
        pis.append(pi / pi.sum())
    return tree, specs, Pms, pis


def _site_lnl(root, ls, pi):
    """root [C, K, S, P], ls [C, P] -> per-pattern lnL [C, P]."""
    K = root.shape[1]
    return np.log(np.einsum("cksp,s->cp", root, pi) / K) + ls


def _jax_multiwalk(tree, specs, Pms, n_tips=N_TIPS):
    """Per-division (root [C, K, S, P], ls [C, P]) from the Pallas kernel
    in TPU interpret mode, vmapped over chains."""
    g = PruningPallasMultiwalk(specs)

    def one(parent, left, right, *Ps):
        order = j_postorder(parent, n_tips)
        return g(order, left, right, list(Ps))

    with pltpu.force_tpu_interpret_mode():
        root, ls = jax.jit(jax.vmap(one))(
            *(jnp.asarray(tree[f], jnp.int32)
              for f in ("parent", "left", "right")),
            *(jnp.asarray(Pm) for Pm in Pms))
        root, ls = jax.block_until_ready((root, ls))
    out = []
    for d in range(len(specs)):
        views = [g.div_view(root[c], ls[c], d) for c in range(root.shape[0])]
        out.append((np.stack([np.asarray(r) for r, _ in views]),
                    np.stack([np.asarray(l_) for _, l_ in views])))
    return out


def _port_multiwalk(tree, specs, Pms, n_tips=N_TIPS):
    g = MW.PruningCudaMultiwalk(specs, "cpu")
    t = {f: torch.as_tensor(v) for f, v in tree.items()}
    order = postorder_internal(t["parent"], n_tips)
    root, ls = g(order, t["left"], t["right"],
                 [torch.as_tensor(Pm) for Pm in Pms])
    assert g.launches == 0               # CPU tensors: the plain version
    return [tuple(x.numpy() for x in g.div_view(root, ls, d))
            for d in range(len(specs))], g


@pytest.mark.parametrize("shape", [TEST1, MIXED_K], ids=["test1", "mixed_k"])
def test_div_view_matches_jax_pallas_interpret(shape):
    tree, specs, Pms, pis = _group(*shape, C=2, seed=11)
    ref = _jax_multiwalk(tree, specs, Pms)
    got, _ = _port_multiwalk(tree, specs, Pms)
    for d, pi in enumerate(pis):
        assert got[d][0].shape == (2, specs[d][1], 4, specs[d][0].shape[1])
        np.testing.assert_allclose(_site_lnl(*got[d], pi),
                                   _site_lnl(*ref[d], pi), **TOL)


def test_group_equals_single_division_passes():
    """Each division's slice of the grouped pass equals its own
    single-division pass (``PruningCuda``) on the same operands, at three
    divisions of different pattern and category counts."""
    tree, specs, Pms, _ = _group((137, 40, 300), (4, 2, 1), C=3, seed=5)
    got, g = _port_multiwalk(tree, specs, Pms)
    t = {f: torch.as_tensor(v) for f, v in tree.items()}
    order = postorder_internal(t["parent"], N_TIPS)
    for d, (tips, K) in enumerate(specs):
        root, ls = PC.PruningCuda(tips, K, "cpu")(
            order, t["left"], t["right"], torch.as_tensor(Pms[d]))
        np.testing.assert_array_equal(got[d][0], root.numpy())
        np.testing.assert_array_equal(got[d][1], ls.numpy())
    offs = g.layout.offsets(3)
    # scratch holds sum_d C * n_int * K_d * S * P_d floats
    assert offs[-1, 4] == sum(3 * 11 * K * 4 * P
                              for P, K in ((137, 4), (40, 2), (300, 1)))


def test_multiwalk_takes_cuda_tensors_and_one_state_count():
    tree, specs, Pms, _ = _group(*TEST1, C=2, seed=3)
    g = MW.PruningCudaMultiwalk(specs, "cpu")
    t = {f: torch.as_tensor(v) for f, v in tree.items()}
    order = postorder_internal(t["parent"], N_TIPS)
    lr, pstep = g.operands(order, t["left"], t["right"],
                           [torch.as_tensor(Pm) for Pm in Pms])
    assert lr.dtype == torch.int32 and lr.shape == (2, 11, 2)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        MW.multiwalk_down(lr, pstep, g.tips, g.layout)
    with pytest.raises(ValueError, match="flat"):
        MW.multiwalk_down_plain(lr, pstep[:-1], g.tips, g.layout)
    _, specs2, _, _ = _group((40,), (1,), C=1, seed=4, S=2)
    with pytest.raises(ValueError, match="one state count"):
        MW.PruningCudaMultiwalk(specs[:1] + specs2, "cpu")


@pytest.mark.parametrize("walks,T", [
    (["whole"] * 3, [16, 16, 32]),
    (["global", "staged", "whole"], [128, 8, 16]),
    (["global"] * 3, [128] * 3)], ids=["whole", "mixed", "global"])
def test_tile_map_covers_every_pattern_once(walks, T):
    """Every (division, pattern) in exactly one tile of T_d patterns, the
    on-chip kernel's tiles first, the costliest divisions' (K_d, as the
    group shares S) leading, then the global-scratch kernel's."""
    _, specs, _, _ = _group((137, 40, 300), (4, 2, 1), C=1, seed=2)
    lay = MW.PruningCudaMultiwalk(specs, "cpu").layout
    tiles, n_onchip = lay.tile_map(walks, T)
    assert tiles.dtype == np.int32 and tiles.shape[1] == 2
    covered = {}
    for m, p0 in tiles.tolist():
        for p in range(p0, min(p0 + T[m], lay.ps[m])):
            covered[(m, p)] = covered.get((m, p), 0) + 1
    assert covered == {(d, p): 1 for d in range(3) for p in range(lay.ps[d])}
    assert n_onchip == sum(walks[m] != "global" for m in tiles[:, 0])
    assert all(walks[m] != "global" for m in tiles[:n_onchip, 0])
    assert all(walks[m] == "global" for m in tiles[n_onchip:, 0])
    ks = [lay.ks[m] for m in tiles[:n_onchip, 0]]
    assert ks == sorted(ks, reverse=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run chip_smoke.py or pytest -m gpu "
                    "on a machine with one)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,C", [(TEST1, 8), (TEST1, 32), (MIXED_K, 8)])
@pytest.mark.parametrize("walk", [None, "global"], ids=["plan", "global"])
def test_kernel_matches_plain_on_gpu(cuda_device, shape, C, walk):
    """The on-chip kernel as the plan gives it (every test1 division
    whole), and the global-scratch kernel where a plan forces it."""
    tree, specs, Pms, pis = _group(*shape, C=C, seed=7)
    g = MW.PruningCudaMultiwalk(specs, cuda_device)
    lay = g.layout
    t = {f: torch.as_tensor(v, device=cuda_device) for f, v in tree.items()}
    order = postorder_internal(t["parent"], N_TIPS)
    lr, pstep = g.operands(order, t["left"], t["right"],
                           [torch.as_tensor(Pm, device=cuda_device)
                            for Pm in Pms])
    plan = lay.plan(C, cuda_device, walk)
    assert plan["walks"] == [walk or "whole"] * lay.D
    total = lay.offsets(C)[-1]
    root = torch.empty(int(total[5]), device=cuda_device)
    ls = torch.empty(int(total[6]), device=cuda_device)
    scratch = torch.empty(plan["scratch"], device=cuda_device) \
        if plan["scratch"] else None
    assert lay.launch(lr, pstep, g.tips, plan, scratch, root, ls) == 0
    p = MW.multiwalk_down_plain(lr, pstep, g.tips, lay)
    for d, pi in enumerate(pis):
        a = [x.cpu().numpy() for x in g.div_view(root, ls, d)]
        b = [x.cpu().numpy() for x in g.div_view(*p, d)]
        np.testing.assert_allclose(_site_lnl(*a, pi), _site_lnl(*b, pi),
                                   **TOL)
