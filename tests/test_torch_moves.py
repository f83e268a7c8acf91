"""The port's batched moves keep the tree invariants of tests/test_moves.py
(a consistent binary tree under the unrooted root-at-tip-0 convention,
finite or rejecting Hastings ratios) and their Hastings ratios leave the
uniform topology prior invariant: prior-only chains over 5 tips visit the
15 unrooted topologies uniformly.  Chains run side by side (one batched
call per step) instead of one long serial chain."""
import numpy as np
import pytest
import torch

from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.mcmc import moves as M
from mrbayes_tpu_torch.mcmc.engine import Engine
from mrbayes_tpu_torch.mcmc.settings import DivisionSettings, McmcSettings
from mrbayes_tpu_torch.nexus.parser import read_nexus_file
from mrbayes_tpu_torch.trees import Tree, random_unrooted
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

N_TIPS = 9


def _states(n_tips, n_chains, seed, same=False):
    rng = np.random.default_rng(seed)
    first = random_unrooted(n_tips, rng, mean_blen=0.1)
    trees = [first if same else random_unrooted(n_tips, rng, mean_blen=0.1)
             for _ in range(n_chains)]
    st = {f: torch.as_tensor(np.stack([getattr(t, f) for t in trees])).long()
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(np.stack([t.blen for t in trees]),
                                 dtype=torch.float32)
    return st


def _check(state, c, n_tips):
    t = Tree(parent=state["parent"][c].numpy(),
             left=state["left"][c].numpy(),
             right=state["right"][c].numpy(),
             blen=state["blen"][c].numpy().astype(np.float64),
             n_tips=n_tips, rooted=False)
    t.blen[0] = 0.0  # convention slot, never used by moves
    t.check()


def _accept(ok, new, old):
    return {k: torch.where(ok.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                           old[k]) for k, v in new.items()}


@pytest.fixture(scope="module")
def primates_pars():
    nf = read_nexus_file(example("primates.nex"))
    ds = DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                 divisions=make_divisions(nf.matrix))
    eng = Engine(ds, [DivisionSettings(nst="1", rates="equal")],
                 mcmc=McmcSettings(nruns=1, nchains=1, seed=2), device="cpu")
    return eng._pars_masks, eng._pars_factors


MOVES = [
    ("nni", M.move_nni, 0.0),
    ("spr", M.move_spr, 0.0),
    ("ext_spr", M.move_ext_spr, 0.8),
    ("ext_tbr", M.move_ext_tbr, 0.8),
    ("local", M.move_local, 1.0),
    ("subtree_swap", M.move_subtree_swap, 0.0),
    ("node_slider", M.move_node_slider, 0.0),
    ("blen_mult", M.move_blen_multiplier, 1.0),
    ("treelen_mult", M.move_treelen_multiplier, 1.0),
]


@pytest.mark.parametrize("name,fn,tuning", MOVES)
def test_move_preserves_tree_invariants(name, fn, tuning):
    C = 12
    state = _states(N_TIPS, C, 7)
    gen = torch.Generator().manual_seed(7)
    tun = torch.full((C,), tuning)
    changed = 0
    for _ in range(10):
        new, lnH = fn(gen, state, tun, n_tips=N_TIPS)
        assert lnH.shape == (C,)
        ok = lnH > M.NEG_INF / 2
        assert torch.isfinite(lnH[ok]).all()
        for c in torch.nonzero(ok)[:, 0].tolist():
            _check(new, c, N_TIPS)
        changed += int((ok & (new["parent"] != state["parent"]).any(1))
                       .sum())
        state = _accept(ok, new, state)
    assert changed > 10 or name in ("node_slider", "blen_mult",
                                    "treelen_mult")


def test_ext_spr_walk_reaches_far_edges():
    """With a high extension probability the walk must reach regraft edges
    several steps away, not just the SPR neighborhood of NNI."""
    C = 80
    state = _states(N_TIPS, C, 3, same=True)
    gen = torch.Generator().manual_seed(1000)
    new, lnH = M.move_ext_spr(gen, state, torch.full((C,), 0.9), N_TIPS)
    moved = (lnH > M.NEG_INF / 2) & (new["parent"] != state["parent"]).any(1)
    assert int(moved.sum()) > 20


def test_subtree_swap_hastings_finite():
    C = 60
    state = _states(N_TIPS, C, 11, same=True)
    gen = torch.Generator().manual_seed(11)
    new, lnH = M.move_subtree_swap(gen, state, torch.zeros(C), N_TIPS)
    ok = lnH > M.NEG_INF / 2
    assert int(ok.sum()) > 30 and torch.isfinite(lnH[ok]).all()
    for c in torch.nonzero(ok)[:, 0].tolist():
        _check(new, c, N_TIPS)


@pytest.mark.parametrize("maker", ["pars_spr", "pars_tbr"])
def test_pars_move_invariants(primates_pars, maker):
    """ParsSPR/ParsTBR keep the tree consistent, change the topology,
    keep Hastings finite, and conserve the total tree length."""
    masks, factors = primates_pars
    fn = (M.make_pars_spr_move if maker == "pars_spr"
          else M.make_pars_tbr_move)(masks, factors)
    n, C = 12, 12
    state = _states(n, C, 5)
    gen = torch.Generator().manual_seed(5)
    changed = 0
    for _ in range(5):
        total = state["blen"].sum(1)
        new, lnH = fn(gen, state, torch.full((C,), 0.2), n)
        ok = lnH > M.NEG_INF / 2
        assert torch.isfinite(lnH[ok]).all()
        for c in torch.nonzero(ok)[:, 0].tolist():
            _check(new, c, n)
        np.testing.assert_allclose(new["blen"].sum(1)[ok].numpy(),
                                   total[ok].numpy(), rtol=1e-5)
        changed += int((ok & (new["parent"] != state["parent"]).any(1))
                       .sum())
        state = _accept(ok, new, state)
    assert changed > 40


def test_parameter_moves():
    C = 64
    gen = torch.Generator().manual_seed(3)
    pi = torch.full((C, 1, 4), 0.25)
    st = {"pi": pi, "shape": torch.full((C, 1), 0.5),
          "pinvar": torch.full((C, 1), 0.1)}
    new, lnH = M.make_simplex_move("pi")(gen, st, torch.full((C,), 100.0), 0)
    np.testing.assert_allclose(new["pi"].sum(-1).numpy(), 1.0, atol=1e-5)
    assert (new["pi"] != pi).any(-1).all() and torch.isfinite(lnH).all()
    new, lnH = M.make_multiplier_move("shape", 1e-4, 200.0)(
        gen, st, torch.full((C,), 2.0), 0)
    np.testing.assert_allclose(torch.log(new["shape"][:, 0] / 0.5).numpy(),
                               lnH.numpy(), atol=1e-5)
    new, lnH = M.make_slider_move("pinvar", 0.0, 1.0)(
        gen, st, torch.full((C,), 3.0), 0)
    assert ((new["pinvar"] >= 0) & (new["pinvar"] <= 1)).all()
    assert (lnH == 0).all()


def _topology_ids(P, L, R, n_tips):
    """Canonical unrooted-topology signature per chain: frozenset of
    non-trivial split bitmasks."""
    full = (1 << n_tips) - 1
    out = []
    for par, left, right in zip(P, L, R):
        below = [1 << i for i in range(n_tips)] + [0] * (n_tips - 1)
        done = [i < n_tips for i in range(2 * n_tips - 1)]
        while not all(done):
            for v in range(n_tips, 2 * n_tips - 1):
                if not done[v] and done[left[v]] and done[right[v]]:
                    below[v] = below[left[v]] | below[right[v]]
                    done[v] = True
        splits = {min(m, full ^ m) for m in below[n_tips:]}
        out.append(frozenset(s for s in splits if bin(s).count("1") >= 2))
    return out


@pytest.mark.parametrize("name,fn,tuning", [
    ("ext_tbr", M.move_ext_tbr, 0.7),
    ("local", M.move_local, 1.5),
    ("ext_spr", M.move_ext_spr, 0.7),
])
def test_topology_marginal_uniform(name, fn, tuning):
    """Hastings-ratio validation: prior-only chains using one topology
    move must sample the 15 unrooted 5-tip topologies uniformly (a wrong
    lnH skews this distribution hard).  256 chains side by side instead
    of tests/test_moves.py's one chain of 30,000 steps: each chain starts
    from a draw of the target itself (random_unrooted's sequential
    addition is uniform over topologies, and its exp(mean 0.1) lengths
    are the exp(rate 10) prior below), so a correct move keeps the
    marginal uniform at every step and a wrong lnH drifts it away.  Each
    step is the topology move, then a branch-length multiplier (the
    extending moves conserve tree length; the multiplier leaves the
    target unchanged and lets the lengths mix).  Every 4th state after
    40 steps is counted."""
    n, C = 5, 256
    state = _states(n, C, 0)
    gen = torch.Generator().manual_seed(99)
    tun = torch.full((C,), tuning)
    tun_blen = torch.full((C,), 2.0 * np.log(1.6))
    mask = torch.ones(2 * n - 1, dtype=torch.bool)
    mask[0] = mask[2 * n - 2] = False

    def prior(st):
        return torch.where(mask, -10.0 * st["blen"], 0.0).sum(1)

    def mh(state, move, tuning):
        new, lnH = move(gen, state, tuning, n)
        ln_r = prior(new) - prior(state) + lnH
        ok_len = ((new["blen"][:, 1:] > 0)
                  & (new["blen"][:, 1:] < M.BRLEN_MAX)).all(1)
        acc = (torch.log(torch.rand(C, generator=gen)) < ln_r) & ok_len
        return _accept(acc, new, state)

    counts: dict = {}
    for step in range(200):
        state = mh(mh(state, fn, tun), M.move_blen_multiplier, tun_blen)
        if step >= 40 and step % 4 == 0:
            for tid in _topology_ids(state["parent"].tolist(),
                                     state["left"].tolist(),
                                     state["right"].tolist(), n):
                counts[tid] = counts.get(tid, 0) + 1
    assert len(counts) == 15, f"only {len(counts)} topologies visited"
    freqs = np.array(sorted(counts.values())) / sum(counts.values())
    # expect 1/15 = 0.0667 each; the envelope of tests/test_moves.py
    assert freqs.min() > 0.030, freqs
    assert freqs.max() < 0.125, freqs
