"""The port's stacked-division path (``ops/stacked_cuda.py`` and
``Engine._build_stacked_pruners``) against the JAX package.

* ``PruningCudaStacked.div_view`` on CPU tensors (the plain version of the
  launch) against JAX ``PruningPallasStacked`` under ``jax.vmap`` in TPU
  interpret mode, on a group mixing S = 2, 3, 4 and 8 with K = 4 and 1,
  at C = 1, 2 and 8: per-pattern lnL within rtol/atol 2e-5, and each
  division's slice equal to its own single-division pass;
* the flat operand buffer: Σ C·n_int·2·K_d·S_d² floats, with no
  [KS, KS] union operator built on the way;
* the port's stacked groups on cynmix's favored model equal the JAX
  engine's (``MB_TPU_STACKED=1``): one group, divisions [0, 1, 2, 3, 5];
* the engine's lnL with the stacked switch on (and with the wavefront and
  multiwalk switches) equals the switches-off lnL within 1e-3 (float32
  sums of the same per-pattern terms in another order), in total and
  division by division (``Engine.division_lnls``).

The launch itself is ``csrc/stacked.cu``; ``test_stacked_kernel_matches_
plain_on_gpu`` (``gpu`` marker, skipped here) and ``chip_smoke.py`` hold
it to the plain version and to per-division launches on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.utils._python_dispatch import TorchDispatchMode

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.ops.pruning_pallas import PruningPallasStacked
from mrbayes_tpu.ops.traversal import postorder_internal as j_postorder
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.envelope import CYNMIX_MODEL
from mrbayes_tpu_torch.ops import pruning_cuda as PC
from mrbayes_tpu_torch.ops.stacked_cuda import (PruningCudaStacked,
                                                stacked_down,
                                                stacked_down_plain)
from mrbayes_tpu_torch.ops.traversal import postorder_internal
from mrbayes_tpu_torch.trees import random_unrooted
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
N_TIPS = 12
# (P_d, S_d, K_d) of a mixed group (the TPU's union width 8+12+4+32 = 56)
GROUP = ((60, 2, 4), (34, 3, 4), (40, 4, 1), (9, 8, 4))


def _group(C, seed, group=GROUP, n_tips=N_TIPS):
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    tree = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int64)
            for f in ("left", "right", "parent")}
    specs, Pms, pis = [], [], []
    for P, S, K in group:
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


def _jax_stacked(tree, specs, Pms):
    g = PruningPallasStacked(specs)

    def one(parent, left, right, *Ps):
        order = j_postorder(parent, N_TIPS)
        root, ls = g(order, left, right, list(Ps))
        return [g.div_view(root, ls, d) for d in range(len(specs))]

    with pltpu.force_tpu_interpret_mode():
        views = jax.jit(jax.vmap(one))(
            *(jnp.asarray(tree[f], jnp.int32)
              for f in ("parent", "left", "right")),
            *(jnp.asarray(Pm) for Pm in Pms))
        views = jax.block_until_ready(views)
    return [(np.asarray(r), np.asarray(l_)) for r, l_ in views]


def _check_div_view(C, seed):
    tree, specs, Pms, pis = _group(C=C, seed=seed)
    ref = _jax_stacked(tree, specs, Pms)
    g = PruningCudaStacked(specs, "cpu")
    lay = g.layout
    assert (lay.ks, lay.ss, lay.ps) == ([4, 4, 1, 4], [2, 3, 4, 8],
                                        [60, 34, 40, 9])
    t = {f: torch.as_tensor(v) for f, v in tree.items()}
    order = postorder_internal(t["parent"], N_TIPS)
    P_list = [torch.as_tensor(Pm) for Pm in Pms]
    lr, pstep = g.operands(order, t["left"], t["right"], P_list)
    assert pstep.shape == (sum(C * (N_TIPS - 1) * 2 * K * S * S
                               for _, S, K in GROUP),)
    root, ls = g(order, t["left"], t["right"], P_list)
    assert g.launches == 0               # CPU tensors: the plain version
    for d, (tips, K) in enumerate(specs):
        r, l_ = (x.numpy() for x in g.div_view(root, ls, d))
        assert r.shape == (C, K, tips.shape[2], tips.shape[1])
        np.testing.assert_allclose(_site_lnl(r, l_, pis[d]),
                                   _site_lnl(*ref[d], pis[d]), **TOL)
        # ... and its own single-division pass on the same operators
        r1, l1 = PC.PruningCuda(tips, K, "cpu")(order, t["left"],
                                                t["right"], P_list[d])
        np.testing.assert_allclose(_site_lnl(r, l_, pis[d]),
                                   _site_lnl(r1.numpy(), l1.numpy(), pis[d]),
                                   **TOL)


def test_div_view_matches_jax_pallas_interpret():
    _check_div_view(C=2, seed=11)


@pytest.mark.parametrize("C", [1, 8])
def test_div_view_matches_jax_pallas_interpret_chains(C):
    _check_div_view(C=C, seed=12 + C)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(x, torch.Tensor):
                self.shapes.append(tuple(x.shape))
        return out


def test_operand_buffer_is_flat_with_no_union():
    C = 3
    tree, specs, Pms, _ = _group(C=C, seed=5)
    g = PruningCudaStacked(specs, "cpu")
    t = {f: torch.as_tensor(v) for f, v in tree.items()}
    order = postorder_internal(t["parent"], N_TIPS)
    P_list = [torch.as_tensor(Pm) for Pm in Pms]
    with _Shapes() as rec:
        lr, pstep = g.operands(order, t["left"], t["right"], P_list)
    n_int = N_TIPS - 1
    assert lr.shape == (C, n_int, 2) and lr.dtype == torch.int32
    assert pstep.ndim == 1 and pstep.numel() == sum(
        C * n_int * 2 * K * S * S for _, S, K in GROUP)
    KS = sum(K * S for _, S, K in GROUP)
    assert rec.shapes and not any(sh[-2:] == (KS, KS) for sh in rec.shapes)
    assert max(int(np.prod(sh)) for sh in rec.shapes) == pstep.numel()
    # each member's slice of the buffer is its own steps' operators
    rows = torch.arange(C)[:, None]
    _, lch, rch = PC.slot_operands(order, t["left"], t["right"], N_TIPS)
    for d, Pd in enumerate(P_list):
        pst, _ = g.layout.div_operands(pstep, g.tips, C, d)
        assert torch.equal(pst, torch.stack([Pd[rows, lch], Pd[rows, rch]],
                                            2))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        stacked_down(lr, pstep, g.tips, g.layout)


@pytest.mark.parametrize("walks,T", [
    (["whole"] * 4, [32, 16, 64, 8]),
    (["whole", "staged", "global", "whole"], [32, 16, 128, 8]),
    (["global"] * 4, [128] * 4)], ids=["whole", "mixed", "global"])
def test_tile_map_lists_onchip_tiles_first(walks, T):
    """The stacked kernel's tile map: every pattern of every member in
    exactly one tile of T_d patterns, the on-chip kernel's tiles first
    (the costliest members' leading), then the global-scratch kernel's."""
    _, specs, _, _ = _group(C=1, seed=7)
    lay = PruningCudaStacked(specs, "cpu").layout
    tiles, n_onchip = lay.tile_map(walks, T)
    assert tiles.dtype == np.int32 and tiles.shape[1] == 2
    assert n_onchip == sum(-(-P // T[d]) for d, (P, _, _) in enumerate(GROUP)
                           if walks[d] != "global")
    for d, (P, _, _) in enumerate(GROUP):
        starts = sorted(int(p0) for m, p0 in tiles if m == d)
        assert starts == list(range(0, P, T[d]))
    assert all(walks[m] != "global" for m in tiles[:n_onchip, 0])
    assert all(walks[m] == "global" for m in tiles[n_onchip:, 0])
    cost = [lay.ks[m] * lay.ss[m] ** 2 for m in tiles[:n_onchip, 0]]
    assert cost == sorted(cost, reverse=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run chip_smoke.py or pytest -m gpu "
                    "on a machine with one)")
    return torch.device("cuda")


# a group whose members take the three walks of the size rule
# (csrc/onchip_walk.cuh): K*S = 512 global, S = 61 staged, S = 4 whole
MIXED = ((70, 32, 16), (30, 61, 3), (40, 4, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("C,group,n_tips,walks", [
    (1, GROUP, N_TIPS, ["whole"] * 4), (8, GROUP, N_TIPS, ["whole"] * 4),
    (4, MIXED, 9, ["global", "staged", "whole"])],
    ids=["C1", "C8", "mixed_walks"])
def test_stacked_kernel_matches_plain_on_gpu(cuda_device, C, group, n_tips,
                                             walks):
    tree, specs, Pms, pis = _group(C=C, seed=31, group=group, n_tips=n_tips)
    g = PruningCudaStacked(specs, cuda_device)
    t = {f: torch.as_tensor(v, device=cuda_device) for f, v in tree.items()}
    order = postorder_internal(t["parent"], n_tips)
    P_list = [torch.as_tensor(Pm, device=cuda_device) for Pm in Pms]
    lr, pstep = g.operands(order, t["left"], t["right"], P_list)
    root_k, ls_k = g(order, t["left"], t["right"], P_list)
    assert g.launches == 1
    root_p, ls_p = stacked_down_plain(lr, pstep, g.tips, g.layout)
    for d, (tips, K) in enumerate(specs):
        a = _site_lnl(*(x.cpu().numpy() for x in g.div_view(root_k, ls_k, d)),
                      pis[d])
        b = _site_lnl(*(x.cpu().numpy() for x in g.div_view(root_p, ls_p, d)),
                      pis[d])
        np.testing.assert_allclose(a, b, **TOL)
        r1, l1 = PC.PruningCuda(tips, K, cuda_device)(
            order, t["left"], t["right"], P_list[d])
        np.testing.assert_allclose(
            a, _site_lnl(r1.cpu().numpy(), l1.cpu().numpy(), pis[d]), **TOL)
    assert g.layout.plan(C, cuda_device)["walks"] == walks


def _cynmix_commands():
    return [f"execute {example('cynmix.nex')}", *CYNMIX_MODEL,
            "mcmcp nruns=1 nchains=2 seed=4"]


@pytest.fixture(scope="module")
def port_interp():
    it = Interpreter(log=lambda m: None, device="cpu")
    for c in _cynmix_commands():
        it.run_line(c)
    return it


def test_cynmix_stacked_groups_equal_jax(port_interp, monkeypatch):
    monkeypatch.setenv("MB_TPU_STACKED", "1")
    it = JInterpreter(log=lambda m: None)
    for c in _cynmix_commands():
        it.run_line(c)
    jeng = it.build_engine()
    eng = port_interp.build_engine(stacked=True)
    groups = [g for g, _ in eng._stacked_pruners]
    assert groups == [g for g, _ in jeng._stacked_pruners] == [[0, 1, 2, 3,
                                                                5]]
    lay = eng._stacked_pruners[0][1].layout
    # (K_d, S_d, P_d) of the buckets S 2, 3, 4, 8 and EF1a, coding dummies
    # counted; the TPU's union would be 8+12+16+32+16 = 84 wide
    assert list(zip(lay.ks, lay.ss, lay.ps)) == [
        (4, 2, 124), (4, 3, 34), (4, 4, 10), (4, 8, 9), (4, 4, 125)]
    assert port_interp.build_engine(stacked=False)._stacked_pruners == []


@pytest.mark.parametrize("switches", [
    dict(stacked=True), dict(wavefront=True),
    dict(stacked=True, wavefront=True), dict(multiwalk=True, stacked=True)],
    ids=["stacked", "wavefront", "stacked_wavefront", "multiwalk_stacked"])
def test_switches_leave_the_lnl_unchanged(port_interp, switches):
    off = port_interp.build_engine(multiwalk=False)
    assert not (off.wavefront or off.stacked)
    on = port_interp.build_engine(**switches)
    st = off.init_chains(seed=4)[0]
    st = {k: v for k, v in st.items() if k not in ("lnL", "lnP", "lnP_tree",
                                                   "lnP_par")}
    np.testing.assert_allclose(on.log_likelihood(st).numpy(),
                               off.log_likelihood(st).numpy(), rtol=0,
                               atol=1e-3)
    # each division alone, through the path the engine takes for it
    per_div = on.division_lnls(st)
    assert per_div.shape == (2, on.n_div)
    np.testing.assert_allclose(per_div.numpy(),
                               off.division_lnls(st).numpy(), rtol=0,
                               atol=1e-3)
    assert per_div.dtype == torch.float64
    np.testing.assert_allclose(per_div.sum(-1).numpy(),
                               on.log_likelihood(st).numpy(), rtol=1e-6)
