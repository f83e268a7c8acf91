"""The port's amino-acid models and its S > 8 eigensolver against the JAX
package, on avian_ovomucoids.nex (89 taxa, 88 patterns, S = 20).

* the copied tables (``models/aa_models.py``) equal the JAX package's
  exactly, and ``protein_q`` is within 1e-6 of JAX's (float32 arithmetic
  of the same formula);
* ``eigh_reversible`` at S = 20 and 61 on seeded reversible generators:
  P(t) within 1e-5 of JAX's ``eigh_reversible`` + ``transition_probs``
  (the port's plain path solves in float64, JAX's ``eigh`` in float32,
  whose rounding is about 1e-6 in P(t));
* ``ops/eigh_cuda.jacobi_twin``, the CUDA kernel's algorithm in numpy,
  against LAPACK at S = 9, 20, 61, 64 (reconstruction and orthogonality
  within 1e-12, eigenvalues within 1e-12 relative, float64 rounding of a
  few dozen rotations a sweep), including Poisson's repeated eigenvalue
  and equal frequencies, and its round-robin schedule covers every pair
  once a sweep;
* the engine at identical states, JAX's eigensystems carried over, on
  jones+G, wag, mixed (four chains at aamodel_idx 0, 5, 10, 1),
  equalin and protein GTR: lnL within 5e-3 of the JAX package's function
  evaluated in float64 (``jax_exact_lnl``: the JAX engine's own float32
  lnL strays up to 0.59 from it at S = 20, see the test) and lnPrior
  within 1e-4 (plus two float32 spacings of |lnP|, 2.4e-7 |lnP|) of the
  JAX engine's; with each side's own eigensystem
  (the port's float64 solve, JAX's ``eigh`` in float64) lnL within 5e-3;
* the ``protein_jones_g`` golden rows through the port within 0.05 of
  reference MrBayes (``tests/test_golden.py``'s tolerance);
* ``aamodel_jump`` never proposes the current model and stays in range;
* avian under ``aamodelpr=mixed`` through the CLI, 2 runs x 2 chains, 40
  generations: its ``.p`` header equals JAX ``param_columns``, the files
  are complete and sump and sumt print what JAX's print.

The CUDA kernel runs only on a GPU: ``test_eigh_kernel_matches_plain_on_gpu``
carries the ``gpu`` marker and skips here; ``chip_smoke.py`` holds it on
the card."""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.cli import Interpreter as JInterpreter
from mrbayes_tpu.data import DataSet as JDataSet
from mrbayes_tpu.data import make_divisions as j_make_divisions
from mrbayes_tpu.mcmc.engine import Engine as JEngine
from mrbayes_tpu.mcmc.run import param_columns as j_param_columns
from mrbayes_tpu.mcmc.settings import DivisionSettings as JDiv
from mrbayes_tpu.mcmc.settings import McmcSettings as JMcmc
from mrbayes_tpu.mcmc.settings import Prior as JPrior
from mrbayes_tpu.models import aa_models as JAA
from mrbayes_tpu.models import substitution as JQ
from mrbayes_tpu.nexus.parser import read_nexus_file as j_read
from mrbayes_tpu.ops import pruning as JP
from mrbayes_tpu.ops import tiprobs as JTP
from mrbayes_tpu.summarize.sump import sump as j_sump
from mrbayes_tpu.summarize.sumt import sumt as j_sumt
from mrbayes_tpu_torch.convert import state_from_numpy
from mrbayes_tpu_torch.data import DataSet, make_divisions
from mrbayes_tpu_torch.cli import Interpreter
from mrbayes_tpu_torch.envelope import write_batch
from mrbayes_tpu_torch.mcmc import moves as M
from mrbayes_tpu_torch.mcmc.engine import Engine
from mrbayes_tpu_torch.mcmc.run import param_columns
from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings, McmcSettings,
                                             Prior)
from mrbayes_tpu_torch.models import aa_models as TAA
from mrbayes_tpu_torch.models import substitution as TQ
from mrbayes_tpu_torch.nexus.parser import read_nexus_file
from mrbayes_tpu_torch.ops import eigh_cuda as E
from mrbayes_tpu_torch.ops import tiprobs as TTP
from mrbayes_tpu_torch.summarize.sump import sump
from mrbayes_tpu_torch.summarize.sumt import sumt
from mrbayes_tpu_torch.trees import parse_newick, random_unrooted
from conftest import example

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = [r for r in json.load(open(os.path.join(HERE, "golden_primates.json")))
        if r["model"] == "protein_jones_g"]
C = 4
# name -> DivisionSettings keywords, the same for both packages
CONFIGS = {
    "jones_g": dict(rates="gamma", aamodel="jones"),
    "wag": dict(aamodel="wag"),
    "mixed": dict(aamodelpr=("mixed", ())),
    "equalin": dict(aamodel="equalin"),
    "gtr": dict(aamodel="gtr"),
}
MIXED_IDX = [0, 5, 10, 1]
# lnPrior beside 1e-4: two float32 spacings of |lnP| (protein GTR's 190-
# rate Dirichlet puts lnP near 1,086, where one spacing is 1.2e-4)
F32_SPACINGS = 2.0 ** -22


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _settings(cls, prior_cls, kw):
    kw = dict(kw)
    if "aamodelpr" in kw:
        kw["aamodelpr"] = prior_cls(*kw["aamodelpr"])
    return cls(**kw)


def test_aa_tables_equal_jax():
    assert list(TAA.AA_MODELS) == list(JAA.AA_MODELS)
    for name, (ex, pi) in JAA.AA_MODELS.items():
        np.testing.assert_array_equal(TAA.AA_MODELS[name][0], ex)
        np.testing.assert_array_equal(TAA.AA_MODELS[name][1], pi)
        assert len(ex) == 190 and len(pi) == 20


def test_protein_q_matches_jax():
    rng = np.random.default_rng(0)
    pi = rng.dirichlet(np.ones(20) * 2, size=6).astype(np.float32)
    ex = rng.gamma(1.0, 1.0, size=(6, 190)).astype(np.float32)
    a = np.asarray(jax.vmap(JQ.protein_q)(jnp.asarray(ex), jnp.asarray(pi)))
    b = TQ.protein_q(_t(ex), _t(pi)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def _reversible(rng, S, n):
    """n seeded reversible generators of S states (the first with equal
    frequencies and exchangeabilities: Poisson's) and their pi."""
    pis, qs = [], []
    for i in range(n):
        pi = np.full(S, 1.0 / S) if i == 0 else rng.dirichlet(np.ones(S) * 2)
        ex = (np.ones(S * (S - 1) // 2) if i == 0
              else rng.gamma(1.0, 1.0, S * (S - 1) // 2))
        qs.append(np.asarray(JQ.reversible_q(jnp.asarray(ex, jnp.float32),
                                             jnp.asarray(pi, jnp.float32))))
        pis.append(pi.astype(np.float32))
    return np.stack(qs), np.stack(pis)


@pytest.mark.parametrize("S", [20, 61])
def test_eigh_reversible_p_matches_jax(S):
    Q, pi = _reversible(np.random.default_rng(S), S, 5)
    lam_j, U_j, V_j = jax.vmap(JTP.eigh_reversible)(jnp.asarray(Q),
                                                    jnp.asarray(pi))
    lam, U, V = TTP.eigh_reversible(_t(Q), _t(pi))
    for t in (0.01, 0.1, 1.0, 10.0):
        tt = np.full(5, t, np.float32)
        a = np.asarray(JTP.transition_probs(lam_j, U_j, V_j,
                                            jnp.asarray(tt)))
        b = TTP.transition_probs(lam, U, V, _t(tt)).numpy()
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
        np.testing.assert_allclose(b.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose((U @ torch.diag_embed(lam) @ V).numpy(), Q,
                               atol=1e-5)


@pytest.mark.parametrize("n", [10, 20, 62, 64])
def test_round_robin_schedule_covers_every_pair_once(n):
    seen = []
    for r in range(n - 1):
        pairs = E.round_pairs(n, r)
        assert sorted(x for p in pairs for x in p) == list(range(n))
        seen += pairs
    assert sorted(seen) == [(p, q) for p in range(n)
                            for q in range(p + 1, n)]


def test_jacobi_twin_constants_are_the_kernels():
    """jacobi_twin's sweep cap and tolerance are csrc/eigh.cu's."""
    src = open(os.path.join(os.path.dirname(E.__file__), os.pardir, "csrc",
                            "eigh.cu")).read()
    assert f"constexpr int kMaxSweeps = {E.MAX_SWEEPS};" in src
    assert f"constexpr double kTol = {E.TOL!r};" in src


@pytest.mark.parametrize("S", [9, 20, 61, 64])
@pytest.mark.parametrize("kind", ["random", "poisson", "equal_pi"])
def test_jacobi_twin_matches_lapack(S, kind):
    rng = np.random.default_rng(S)
    if kind == "random":
        X = rng.standard_normal((S, S))
        A = X + X.T
    else:
        pi = (np.full(S, 1.0 / S) if kind == "poisson"
              else rng.dirichlet(np.ones(S)))
        ex = np.ones(S * (S - 1) // 2)
        Q = np.asarray(JQ.reversible_q(jnp.asarray(ex), jnp.asarray(pi)),
                       np.float64)
        sq = np.sqrt(pi)
        A = Q * (sq[:, None] / sq[None, :])
        A = 0.5 * (A + A.T)
    with warnings.catch_warnings():
        # a rotation of a pair already at 0 overflows tau to inf: t = 0
        warnings.simplefilter("ignore", RuntimeWarning)
        w, V, sweeps = E.jacobi_twin(A)
    scale = np.abs(A).max()
    assert sweeps < E.MAX_SWEEPS
    np.testing.assert_allclose(V @ np.diag(w) @ V.T, A, atol=1e-12 * scale,
                               rtol=0)
    np.testing.assert_allclose(V.T @ V, np.eye(S), atol=1e-12, rtol=0)
    np.testing.assert_allclose(np.sort(w), np.linalg.eigvalsh(A),
                               atol=1e-12 * scale, rtol=0)
    if kind == "poisson":
        assert sweeps == 1


@pytest.fixture(scope="module")
def avian():
    path = example("avian_ovomucoids.nex")
    nf, jnf = read_nexus_file(path), j_read(path)
    return (DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                    divisions=make_divisions(nf.matrix)),
            JDataSet(taxa=jnf.taxa, nchar=jnf.matrix.nchar,
                     divisions=j_make_divisions(jnf.matrix)))


def _trees(n_tips, seed):
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    st = {f: np.stack([getattr(t, f) for t in trees]).astype(np.int32)
          for f in ("left", "right", "parent")}
    st["blen"] = np.stack([t.blen for t in trees]).astype(np.float32)
    return st


def _params(name, rng):
    """Per-chain random parameters of a configuration (numpy)."""
    st = {}
    if name == "jones_g":
        st["shape"] = rng.uniform(0.2, 2.0, size=(C, 1)).astype(np.float32)
    if name in ("equalin", "gtr"):
        st["pi20"] = rng.dirichlet(np.ones(20) * 3, size=(C, 1)).astype(
            np.float32)
    if name == "gtr":
        st["aarevmat"] = rng.dirichlet(np.ones(190) * 2, size=(C, 1)).astype(
            np.float32)
    if name == "mixed":
        st["aamodel_idx"] = np.asarray(MIXED_IDX, np.int32)[:, None]
    return st


def jax_exact_lnl(jeng, jst, own=False):
    """lnL [C] of division 0 at the chain states ``jst`` by the JAX
    package's own ops in float64 (``jax.enable_x64``): the function the
    JAX engine computes in float32, evaluated exactly.  The eigensystem is
    the one carried in ``jst`` (float32, cast), or with ``own`` a float64
    ``eigh_reversible`` of the chain's Q."""
    out = []
    with jax.enable_x64(True):
        for c in range(C):
            s1 = {k: v[c] for k, v in jst.items()}
            pi, coding, lam, U, Uinv, rates, pinv, cmask, mult = \
                jeng._generic_div_params(s1, 0)
            if own:
                Q, pi_q = jeng._division_q_pi(s1, 0)
                lam, U, Uinv = JTP.eigh_reversible(
                    jnp.asarray(Q, jnp.float64), jnp.asarray(pi_q,
                                                             jnp.float64))

            def f64(x):
                return jnp.asarray(x, jnp.float64)

            out.append(float(JP.division_loglik(
                s1["left"], s1["right"], s1["parent"], f64(s1["blen"]),
                f64(jeng.tip_partials[0]), f64(jeng.weights[0]), f64(lam),
                f64(U), f64(Uinv), f64(pi), f64(rates), 0.0, None,
                jeng.n_tips, rate_mult=mult, coding=coding)))
    return np.asarray(out)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_matches_jax_at_identical_states(avian, name):
    """JAX's eigensystems carried over (cast to float64, the port's S > 8
    precision): lnL within 5e-3 of the JAX package's function evaluated
    in float64 at the same state (measured at most 6e-4: the port's
    float32 pruning) and lnPrior within 1e-4 + 2.4e-7 |lnP| of the JAX
    engine's.  The
    JAX engine's own float32 lnL lies up to 0.59 from that value on these
    states (its float32 eigh and P(t) lose the transition probabilities
    below float32's resolution), so it is not the yardstick of lnL here.
    With each side's own eigensystem: the port within 5e-3 of the JAX
    function in float64 with a float64 eigh (measured at most 6e-4)."""
    ds, jds = avian
    kw = CONFIGS[name]
    jeng = JEngine(jds, [_settings(JDiv, JPrior, kw)],
                   mcmc=JMcmc(nruns=1, nchains=C, seed=3))
    eng = Engine(ds, [_settings(DivisionSettings, Prior, kw)],
                 mcmc=McmcSettings(nruns=1, nchains=C, seed=3), device="cpu")
    st = {**_trees(ds.ntax, 11), **_params(name, np.random.default_rng(12))}
    jst = jax.vmap(jeng.refresh_eigs)({k: jnp.asarray(v)
                                       for k, v in st.items()})
    lnP = np.asarray(jax.vmap(jeng.log_prior)(jst))
    carried = state_from_numpy({k: np.asarray(v) for k, v in jst.items()},
                               "cpu")
    carried = {k: v.double() if k.startswith("eig") else v
               for k, v in carried.items()}
    np.testing.assert_allclose(eng.log_likelihood(carried).numpy(),
                               jax_exact_lnl(jeng, jst), atol=5e-3, rtol=0)
    np.testing.assert_allclose(eng.log_prior(carried).numpy(), lnP,
                               atol=1e-4, rtol=F32_SPACINGS)
    own = eng.refresh_eigs({k: v for k, v in carried.items()
                            if not k.startswith("eig")})
    np.testing.assert_allclose(eng.log_likelihood(own).numpy(),
                               jax_exact_lnl(jeng, jst, own=True),
                               atol=5e-3, rtol=0)
    assert [m.name for m in eng.moves] == [m.name for m in jeng.moves]


@pytest.mark.parametrize("i", range(len(GOLD)))
def test_golden_protein_jones_g(avian, i):
    rec = GOLD[i]
    ds = avian[0]
    eng = Engine(ds, [DivisionSettings(rates="gamma", aamodel="jones")],
                 mcmc=McmcSettings(nruns=1, nchains=1), device="cpu")
    t = parse_newick(rec["newick"], ds.taxa)
    st = {f: torch.as_tensor(getattr(t, f)[None]).long()
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(t.blen[None], dtype=torch.float32)
    st["shape"] = torch.tensor([[rec["alpha"]]])
    lnL = float(eng.log_likelihood(eng.refresh_eigs(st))[0])
    assert abs(lnL - rec["lnL"]) < 0.05, (lnL, rec["lnL"])


def test_aamodel_jump_proposes_another_model():
    jump = M.make_jump_move("aamodel_idx", 11)
    gen = torch.Generator().manual_seed(0)
    arr = torch.as_tensor(np.random.default_rng(0).integers(
        0, 11, size=(256, 2)))
    hits = torch.zeros(11)
    for _ in range(20):
        new, lnH = jump(gen, {"aamodel_idx": arr}, torch.zeros(256), 0)
        new = new["aamodel_idx"]
        changed = (new != arr)
        assert (changed.sum(1) == 1).all()          # one group a chain
        assert ((new >= 0) & (new < 11)).all()
        assert (lnH == 0).all()
        hits += torch.bincount(new[changed], minlength=11)
        arr = new
    assert (hits > 0).all()                         # every model reached


@pytest.fixture(scope="module")
def avian_run(tmp_path_factory):
    """avian under aamodelpr=mixed, 2 runs x 2 chains, 40 generations,
    through the CLI (``envelope.write_batch``'s file with 2 chains), with
    the carried scores checked against recomputed ones at every
    sample."""
    d = str(tmp_path_factory.mktemp("avian"))
    path = write_batch("avian", d, 40, samplefreq=10, diagnfreq=20)
    with open(path) as f:
        text = f.read().replace("nchains=4", "nchains=2")
    with open(path, "w") as f:
        f.write(text)
    lines = []
    it = Interpreter(log=lines.append, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MB_DEBUG", "1")
        mp.setenv("MB_DEBUG_LNL", "1")
        it.execute_file(path)
    return it, os.path.join(d, "avian"), lines


def test_avian_p_header_equals_jax_param_columns(avian_run):
    it, prefix, _ = avian_run
    jit = JInterpreter(log=lambda m: None)
    for ln in ("execute " + example("avian_ovomucoids.nex"),
               "prset aamodelpr=mixed"):
        jit.run_line(ln)
    jnames = [n for n, _ in j_param_columns(jit.build_engine())]
    names = [n for n, _ in param_columns(it._last_runner.eng)]
    assert names == jnames == ["TL", "aamodel"]
    with open(prefix + ".run1.p") as f:
        f.readline()
        assert f.readline().rstrip("\n").split("\t") == \
            ["Gen", "lnLike", "lnPrior"] + names


def test_avian_run_writes_complete_files(avian_run, tmp_path):
    it, prefix, lines = avian_run
    for r in (1, 2):
        with open(f"{prefix}.run{r}.p") as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()[2:]]
        assert [int(x[0]) for x in rows] == list(range(0, 41, 10))
        idx = [float(x[-1]) for x in rows]
        assert all(v == int(v) and 0 <= v < 11 for v in idx)
        with open(f"{prefix}.run{r}.t") as f:
            text = f.read()
        assert text.count("   tree gen.") == 5
        assert text.rstrip().endswith("end;")
    assert any("Model probabilities for aamodel" in ln for ln in lines)
    ours, ref = [], []
    sump(prefix, log=ours.append, outputname=str(tmp_path / "port"))
    j_sump(prefix, log=ref.append, outputname=str(tmp_path / "jax"))
    assert ours == ref
    ours, ref = [], []
    sumt(prefix, log=ours.append, outputname=str(tmp_path / "port"))
    j_sumt(prefix, log=ref.append, outputname=str(tmp_path / "jax"))
    assert ours == ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run chip_smoke.py or pytest -m gpu "
                    "on a machine with one)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(8, 20), (32, 20), (24, 61), (96, 61),
                                 (8, 9), (8, 60), (8, 64)])
def test_eigh_kernel_matches_plain_on_gpu(cuda_device, B, S):
    """eigh.cu against its plain version: reconstruction within 1e-10 of
    |A| and P(t) within 1e-10 at four branch lengths (both float64; a
    float32 solve misses this by about three orders), no host sync."""
    Q, pi = _reversible(np.random.default_rng(B), S, B)
    sq = np.sqrt(pi)
    A = Q * (sq[:, :, None] / sq[:, None, :])
    A = torch.as_tensor(0.5 * (A + A.transpose(0, 2, 1)),
                        dtype=torch.float64, device=cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, V = E.eigh_cuda(A)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    wp, Vp = E.eigh_plain(A)
    rec = V @ torch.diag_embed(w) @ V.transpose(-1, -2)
    assert ((rec - A).norm(dim=(1, 2)) / A.norm(dim=(1, 2))).max() < 1e-10
    for t in (0.01, 0.1, 1.0, 10.0):
        P = V @ torch.diag_embed(torch.exp(w * t)) @ V.transpose(-1, -2)
        Pp = Vp @ torch.diag_embed(torch.exp(wp * t)) @ Vp.transpose(-1, -2)
        assert (P - Pp).abs().max() < 1e-10
