"""The CPP relaxed clock and clockvarpr=mixed in the port
(``mcmc/clock.py``) against the JAX package, on the CPU, at small size
(tests/test_cpp.py restated).

* CPP effective branch lengths against the reference recursion
  (UpdateCppEvolLength, src/model.c:25923, re-implemented in plain
  Python) and against JAX's on random event sets, at 1e-5 relative;
* the CPP prior density against its closed form (scipy) and JAX's, 1e-5;
* clockvarpr=mixed switches between the IGR and ILN densities (scipy, and
  JAX's at 1e-5);
* the CPP moves keep well-formed event slots;
* short CPP and mixed runs through the port's CLI write .p files whose
  header equals JAX's ``param_columns`` and whose nEvents/rclModel
  columns hold valid values;
* on a GPU only (``gpu`` marker, skipped here): ``csrc/pruning.cu`` on a
  dated tree with sampled ancestors, whose branches have length 0, and
  the hymfossil division shapes, against its plain version at 2e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.mcmc import clock as JC
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.mcmc import clock as CL
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.ops import pruning_cuda as PC
from mrbayes_tpu_torch.trees import random_clock_tree
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

REL = 1e-5
K = 4          # event slots a branch (the engines use 8)


def _manual_effective(parent, events, n_nodes):
    """The reference recursion in plain Python: events[v] = [(pos, mult),
    ...], positions from the tipward end (tests/test_cpp.py:17)."""
    logs = {v: sum(np.log(m) for _, m in evs) for v, evs in events.items()}

    def base(v):
        out, p = 0.0, parent[v]
        while p >= 0:
            out += logs.get(p, 0.0)
            p = parent[p]
        return np.exp(out)

    r = np.ones(n_nodes)
    for v in range(n_nodes):
        evs = sorted(events.get(v, []))
        L = 1.0
        if evs:
            L = evs[0][0] * evs[0][1]
            for i in range(1, len(evs)):
                L = (L + evs[i][0] - evs[i - 1][0]) * evs[i][1]
            L += 1.0 - evs[-1][0]
        r[v] = base(v) * L
    return r


def _cpp_states(n_tips, C, seed):
    """C random clock trees with up to K events on each branch but the
    root's: (numpy state, the events of each chain)."""
    rng = np.random.default_rng(seed)
    n = 2 * n_tips - 1
    trees = [random_clock_tree(n_tips, rng, mean_age=0.5) for _ in range(C)]
    st = {k: np.stack([getattr(t, k) for t, _ in trees]).astype(np.int32)
          for k in ("left", "right", "parent")}
    st["age"] = np.stack([a for _, a in trees]).astype(np.float32)
    st["clockrate"] = rng.uniform(0.5, 2.0, (C, 1)).astype(np.float32)
    st["cpp_n"] = rng.integers(0, K + 1, (C, n)).astype(np.int32)
    st["cpp_n"][:, n - 1] = 0
    st["cpp_pos"] = rng.uniform(0.0, 1.0, (C, n, K)).astype(np.float32)
    st["cpp_mult"] = np.exp(rng.normal(0.0, 0.4, (C, n, K))).astype(
        np.float32)
    events = [{v: [(float(st["cpp_pos"][c, v, j]),
                    float(st["cpp_mult"][c, v, j]))
                   for j in range(st["cpp_n"][c, v])]
               for v in range(n) if st["cpp_n"][c, v]} for c in range(C)]
    return st, events


def _jax(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


@pytest.mark.parametrize("n_tips", [4, 9])
def test_cpp_effective_lengths_match_reference_recursion(n_tips):
    st, events = _cpp_states(n_tips, 3, n_tips)
    tst = state_from_numpy(st, "cpu")
    r = CL.cpp_branch_multipliers(tst["parent"], tst["cpp_pos"],
                                  tst["cpp_mult"], tst["cpp_n"]).numpy()
    for c in range(3):
        want = _manual_effective(st["parent"][c], events[c],
                                 2 * n_tips - 1)
        np.testing.assert_allclose(r[c], want, rtol=REL)
    jr = jax.vmap(JC.cpp_branch_multipliers)(
        *(jnp.asarray(st[k]) for k in ("parent", "cpp_pos", "cpp_mult",
                                       "cpp_n")))
    np.testing.assert_allclose(r, jr, rtol=REL)
    # the derived lengths: dt x clockrate x r, 0 at the root
    blen = CL.clock_blens(tst, n_tips, "cpp").numpy()
    np.testing.assert_allclose(
        blen, jax.vmap(lambda s: JC.clock_blens(s, n_tips, "cpp"))(_jax(st)),
        rtol=REL)
    # no events anywhere: the strict clock
    tst["cpp_n"] = torch.zeros_like(tst["cpp_n"])
    np.testing.assert_allclose(CL.clock_blens(tst, n_tips, "cpp").numpy(),
                               CL.clock_blens(tst, n_tips, "strict").numpy(),
                               rtol=REL)


def test_cpp_prior_density_golden():
    """exp(-lam L) lam^k prod LN(m; 0, sigma) over the branches, the
    density whose add/delete ratio is lam f(m) (src/proposal.c:286-293)."""
    from scipy.stats import lognorm
    n_tips, C, sigma = 7, 4, 0.4
    st, events = _cpp_states(n_tips, C, 3)
    lam = np.array([0.3, 1.0, 1.7, 4.0], np.float32)
    got = CL.ln_cpp_prior(state_from_numpy(st, "cpu"), n_tips,
                          torch.as_tensor(lam), sigma).numpy()
    want = jax.vmap(lambda s, la: JC.ln_cpp_prior(s, n_tips, la, sigma))(
        _jax(st), jnp.asarray(lam))
    np.testing.assert_allclose(got, want, rtol=REL)
    for c in range(C):
        age, par = st["age"][c].astype(np.float64), st["parent"][c]
        L = (age[par[:-1]] - age[:-1]) * st["clockrate"][c, 0]
        k = sum(len(e) for e in events[c].values())
        ref = -lam[c] * L.sum() + k * np.log(lam[c]) + sum(
            lognorm.logpdf(m, s=sigma, scale=1.0)
            for evs in events[c].values() for _, m in evs)
        assert got[c] == pytest.approx(ref, rel=1e-4)


def test_mixed_prior_switches_between_igr_and_iln():
    from scipy.stats import gamma as sgamma
    n_tips, C = 6, 4
    st, _ = _cpp_states(n_tips, C, 5)
    rng = np.random.default_rng(0)
    n = 2 * n_tips - 1
    st["brate"] = rng.uniform(0.5, 2.0, (C, n)).astype(np.float32)
    st["rcl_model"] = np.array([[0], [1], [0], [1]], np.int32)
    var = np.array([0.3, 0.3, 1.2, 1.2], np.float32)
    got = CL.ln_branch_rates_prior(state_from_numpy(st, "cpu"), n_tips,
                                   "mixed", torch.as_tensor(var)).numpy()
    want = jax.vmap(lambda s, v: JC.ln_branch_rates_prior(
        s, n_tips, "mixed", v))(_jax(st), jnp.asarray(var))
    np.testing.assert_allclose(got, want, rtol=REL)
    for c in range(C):
        r, v = st["brate"][c, :-1].astype(np.float64), float(var[c])
        if st["rcl_model"][c, 0] == 0:
            a = 1.0 / v
            ref = sgamma.logpdf(r, a, scale=1.0 / a).sum()
        else:
            s2 = np.log1p(v)
            ref = (-np.log(r) - 0.5 * np.log(2 * np.pi * s2)
                   - (np.log(r) + 0.5 * s2) ** 2 / (2 * s2)).sum()
        assert got[c] == pytest.approx(ref, rel=1e-4)
    # the indicator flips the density
    st["rcl_model"] = 1 - st["rcl_model"]
    flipped = CL.ln_branch_rates_prior(state_from_numpy(st, "cpu"), n_tips,
                                       "mixed", torch.as_tensor(var)).numpy()
    assert np.all(np.abs(flipped - got) > 1e-3)


def test_cpp_moves_keep_valid_event_slots():
    """Add/delete, position and multiplier moves over 60 rounds of 8
    chains, keeping each chain's proposal where its Hastings ratio is
    finite: counts within [0, K], the root's 0, positions in [0, 1),
    multipliers in (1e-4, 1e4), the inactive slots never read (the
    effective lengths do not change with them)."""
    n_tips, C = 6, 8
    st, _ = _cpp_states(n_tips, C, 9)
    st["cpp_n"][:] = 0
    st = state_from_numpy(st, "cpu")
    gen = torch.Generator().manual_seed(9)
    moves = [CL.make_cpp_adddelete(0.4), CL.move_cpp_position,
             CL.move_cpp_multiplier]
    tune = torch.full((C,), 2.0 * np.log(1.5))
    kept = [0, 0, 0]
    for i in range(60):
        m = i % 3
        new, lnh = moves[m](gen, st, tune, n_tips)
        ok = lnh > -1e29
        assert torch.isfinite(lnh[ok]).all()
        kept[m] += int(ok.sum())
        st = {k: torch.where(ok.reshape(-1, *[1] * (v.ndim - 1)), new[k], v)
              for k, v in st.items()}
        n = st["cpp_n"]
        assert (n >= 0).all() and (n <= K).all() and (n[:, -1] == 0).all()
        act = torch.arange(K) < n[..., None]
        assert ((st["cpp_pos"][act] >= 0) & (st["cpp_pos"][act] < 1)).all()
        assert ((st["cpp_mult"][act] > 1e-4)
                & (st["cpp_mult"][act] < 1e4)).all()
    assert min(kept) > 0 and int(st["cpp_n"].sum()) > 0
    scrambled = {**st, "cpp_pos": torch.where(
        torch.arange(K) < st["cpp_n"][..., None], st["cpp_pos"], 0.123)}
    np.testing.assert_array_equal(
        CL.clock_blens(scrambled, n_tips, "cpp").numpy(),
        CL.clock_blens(st, n_tips, "cpp").numpy())


@pytest.mark.parametrize("clockvar", ["cpp", "mixed"])
def test_cpp_and_mixed_cli_run(clockvar, tmp_path):
    """A short primates clock run with the CPP or mixed clock through the
    port's CLI: the .p header equals JAX's param_columns, and the
    nEvents or rclModel column holds counts or 0/1 indicators."""
    prefix = str(tmp_path / f"pm_{clockvar}")
    lines = [f"execute {example('primates.nex')}",
             "prset brlenspr=clock:uniform", f"prset clockvarpr={clockvar}"]
    it = Interpreter(log=lambda m: None, device="cpu")
    jit = JInterpreter(log=lambda m: None)
    for ln in lines:
        it.run_line(ln)
        jit.run_line(ln)
    it.run_line(f"mcmc ngen=60 nruns=1 nchains=2 samplefreq=20 "
                f"printfreq=60 diagnfreq=60 file={prefix}")
    jnames = [n for n, _ in j_param_columns(jit.build_engine())]
    eng = it._last_runner.eng
    assert [n for n, _ in param_columns(eng)] == jnames
    assert [m.name for m in eng.moves] == \
        [m.name for m in jit.build_engine().moves]
    with open(f"{prefix}.run1.p") as f:
        rows = f.read().splitlines()
    header = rows[1].split("\t")
    assert header[1:3] == ["lnLike", "lnPrior"]
    col = header.index("nEvents" if clockvar == "cpp" else "rclModel")
    vals = [float(r.split("\t")[col]) for r in rows[2:]]
    assert len(vals) == 4 and all(np.isfinite(float(r.split("\t")[1]))
                                  for r in rows[2:])
    assert all(v >= 0 and v == int(v) for v in vals)
    if clockvar == "mixed":
        assert set(vals) <= {0.0, 1.0}
    assert os.path.exists(f"{prefix}.ckp")


# ---------------------------------------------------------------------------
# csrc/pruning.cu on dated trees (GPU only)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run chip_smoke.py or pytest -m gpu "
                    "on a machine with one)")
    return torch.device("cuda")


def _dated_operands(n_tips, P, S, K_, C, device, seed):
    """pruning.cu's operands on C dated trees with sampled ancestors: a
    third of the tips are fossils (ages 0.2-1), extant tips aged about
    1e-8, every fossil whose sibling is younger made a sampled ancestor
    (its parent's age pinned to it: a zero-length branch); a random
    reversible S-state model under K_ rate categories in 0.3-2.5."""
    from mrbayes_tpu_torch.ops.pruning import branch_tiprobs
    from mrbayes_tpu_torch.ops.tiprobs import eigh_reversible
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    from mrbayes_tpu_torch.models.substitution import reversible_q
    rng = np.random.default_rng(seed)
    n = 2 * n_tips - 1
    fossil = np.arange(n_tips) < n_tips // 3
    trees, sa = [], np.zeros((C, n_tips), np.int64)
    for c in range(C):
        tip_ages = np.where(fossil, rng.uniform(0.2, 1.0, n_tips),
                            rng.uniform(1e-8, 1e-7, n_tips))
        t, ages = random_clock_tree(n_tips, rng, mean_age=1.5,
                                    tip_ages=tip_ages)
        for v in np.flatnonzero(fossil):
            q = t.parent[v]
            sib = t.right[q] if t.left[q] == v else t.left[q]
            if q != n - 1 and ages[sib] < ages[v]:
                sa[c, v] = 1
        trees.append((t, ages))
    st = {k: torch.as_tensor(np.stack([getattr(t, k) for t, _ in trees]),
                             device=device).long()
          for k in ("left", "right", "parent")}
    st["age"] = torch.as_tensor(np.stack([a for _, a in trees]),
                                dtype=torch.float32, device=device)
    st["sa"] = torch.as_tensor(sa, device=device)
    blen = CL.clock_blens(CL.pin_sa_ages(st, n_tips), n_tips, "strict")
    assert int(((blen[:, :n_tips] == 0) & (st["sa"] > 0)).sum()) == sa.sum()
    pi = torch.as_tensor(rng.dirichlet(np.ones(S) * 3), dtype=torch.float32,
                         device=device)
    ex = torch.as_tensor(rng.uniform(0.2, 3.0, S * (S - 1) // 2),
                         dtype=torch.float32, device=device)
    lam, U, V = eigh_reversible(reversible_q(ex, pi)[None].double(),
                                pi[None].double())
    rates = torch.as_tensor(np.sort(rng.uniform(0.3, 2.5, K_)),
                            dtype=torch.float32, device=device)[None]
    Pm = branch_tiprobs(blen, lam.float(), U.float(), V.float(), rates, 0.0)
    tips = (rng.random((n_tips, P, S)) < 0.4).astype(np.float32)
    tips[..., 0] = 1.0
    pruner = PC.PruningCuda(tips, K_, device)
    lr, pstep = pruner.operands(postorder_internal(st["parent"], n_tips),
                                st["left"], st["right"], Pm)
    return lr, pstep, pruner.tips, pi


# hymfossil's division shapes (n_tips, P with the coding dummies, S, K):
# the nine morphology buckets and the six genes
HYMFOSSIL_SHAPES = [(114, 248, 2, 4), (114, 36, 3, 4), (114, 44, 3, 4),
                    (114, 13, 4, 4), (114, 11, 4, 4), (114, 6, 5, 4),
                    (114, 9, 5, 4), (114, 7, 6, 4), (114, 8, 7, 4),
                    (114, 318, 4, 4), (114, 717, 4, 4), (24, 60, 4, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_tips,P,S,K_", HYMFOSSIL_SHAPES)
def test_kernel_on_dated_tree_with_sampled_ancestors(cuda_device, n_tips, P,
                                                     S, K_):
    lr, pstep, tips, pi = _dated_operands(n_tips, P, S, K_, 8, cuda_device,
                                          seed=n_tips + P)
    root_k, ls_k = PC.pruning_down(lr, pstep, tips)
    root_p, ls_p = PC.pruning_down_plain(lr, pstep, tips)

    def site(root, ls):
        return torch.log(torch.einsum("cksp,s->cp", root, pi)
                         / root.shape[1]) + ls

    np.testing.assert_allclose(site(root_k, ls_k).cpu().numpy(),
                               site(root_p, ls_p).cpu().numpy(),
                               rtol=2e-5, atol=2e-5)
    assert PC.pruning_plan(8, n_tips, K_, S, P, cuda_device)["walk"] != \
        "global"
