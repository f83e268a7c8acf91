"""The port's stacked-division path (``ops/stacked_cuda.py`` and
``Engine._build_stacked_pruners``) against the JAX package.

* ``PruningCudaStacked.div_view`` on CPU tensors (the plain version of the
  launch) against JAX ``PruningPallasStacked`` under ``jax.vmap`` in TPU
  interpret mode, on a group mixing S = 2, 3 and 4 with K = 4 and 1:
  per-pattern lnL within rtol/atol 2e-5, and each division's slice equal
  to its own single-division pass;
* the port's stacked groups on cynmix's favored model equal the JAX
  engine's (``MB_TPU_STACKED=1``): one group, divisions [0, 1, 2, 3, 5];
* the engine's lnL with the stacked switch on (and with the wavefront and
  multiwalk switches) equals the switches-off lnL within 1e-3 (float32
  sums of the same per-pattern terms in another order), in total and
  division by division (``Engine.division_lnls``).

The launch itself is ``csrc/pruning.cu`` at K = 1; ``chip_smoke.py`` holds
it to the plain version and to per-division launches on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.ops.pruning_pallas import PruningPallasStacked
from mrbayes_tpu.ops.traversal import postorder_internal as j_postorder
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.envelope import CYNMIX_MODEL
from mrbayes_tpu_torch.ops import pruning_cuda as PC
from mrbayes_tpu_torch.ops.stacked_cuda import PruningCudaStacked
from mrbayes_tpu_torch.ops.traversal import postorder_internal
from mrbayes_tpu_torch.trees import random_unrooted
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
N_TIPS = 12
# (P_d, S_d, K_d) of a mixed group: union width 8 + 12 + 4 = 24
GROUP = ((60, 2, 4), (34, 3, 4), (40, 4, 1))


def _group(C, seed):
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(N_TIPS, rng, mean_blen=0.1) for _ in range(C)]
    tree = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int64)
            for f in ("left", "right", "parent")}
    specs, Pms, pis = [], [], []
    for P, S, K in GROUP:
        tips = (rng.random((N_TIPS, P, S)) < 0.4).astype(np.float32)
        tips[..., 0] = 1.0
        Pm = rng.random((C, 2 * N_TIPS - 1, K, S, S)).astype(np.float32)
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


def test_div_view_matches_jax_pallas_interpret():
    tree, specs, Pms, pis = _group(C=2, seed=11)
    ref = _jax_stacked(tree, specs, Pms)
    g = PruningCudaStacked(specs, "cpu")
    assert g.KS == 24 and g.P == 134
    t = {f: torch.as_tensor(v) for f, v in tree.items()}
    order = postorder_internal(t["parent"], N_TIPS)
    P_list = [torch.as_tensor(Pm) for Pm in Pms]
    lr, pstep = g.operands(order, t["left"], t["right"], P_list)
    assert pstep.shape == (2, N_TIPS - 1, 2, 1, 24, 24)
    root, ls = g(order, t["left"], t["right"], P_list)
    assert g.launches == 0               # CPU tensors: the plain version
    for d, (tips, K) in enumerate(specs):
        r, l_ = (x.numpy() for x in g.div_view(root, ls, d))
        assert r.shape == (2, K, tips.shape[2], tips.shape[1])
        np.testing.assert_allclose(_site_lnl(r, l_, pis[d]),
                                   _site_lnl(*ref[d], pis[d]), **TOL)
        # ... and its own single-division pass on the same operators
        r1, l1 = PC.PruningCuda(tips, K, "cpu")(order, t["left"],
                                                t["right"], P_list[d])
        np.testing.assert_allclose(_site_lnl(r, l_, pis[d]),
                                   _site_lnl(r1.numpy(), l1.numpy(), pis[d]),
                                   **TOL)


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
    stack = eng._stacked_pruners[0][1]
    assert (stack.KS, stack.P) == (84, 302)   # 8+12+16+32+16; 124+34+10+9+125
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
