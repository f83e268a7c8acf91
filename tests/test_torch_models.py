"""The port's rate table, Q matrices, traversal, Jacobi eigensolver and
P(t) against the JAX package at identical inputs (numpy, from a seed).

Tolerances: gamma rates and Q atol 1e-6 (float32 arithmetic of the same
formulas); P(t) atol 2e-6 (float32 Jacobi sweeps in both frameworks,
summed in a different order); postorders identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.mcmc import moves as JM
from mrbayes_tpu.models import rates as JR
from mrbayes_tpu.models import substitution as JQ
from mrbayes_tpu.ops import tiprobs as JTP
from mrbayes_tpu.ops import traversal as JTR
from mrbayes_tpu.trees import random_unrooted
from mrbayes_tpu_torch.models import rates as TR
from mrbayes_tpu_torch.models import substitution as TQ
from mrbayes_tpu_torch.ops import jacobi as TJ
from mrbayes_tpu_torch.ops import tiprobs as TTP
from mrbayes_tpu_torch.ops import traversal as TTR

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("k", [4, 8])
def test_gamma_rate_table_matches_jax(k):
    alphas = np.concatenate([np.logspace(-3.5, 2.6, 61), [5e-4, 300.0, 1e3]]
                            ).astype(np.float32)
    a = np.asarray(JR.GammaRateTable(k)(jnp.asarray(alphas)))
    b = TR.GammaRateTable(k)(_t(alphas)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    np.testing.assert_allclose(b.mean(-1), 1.0, atol=1e-5)


def test_q_matrices_match_jax():
    rng = np.random.default_rng(0)
    pi = rng.dirichlet(np.ones(4), size=6).astype(np.float32)
    r6 = rng.dirichlet(np.ones(6), size=6).astype(np.float32)
    kappa = rng.gamma(2.0, 1.0, size=6).astype(np.float32)
    pairs = [
        (JQ.nuc_q_nst1(jnp.asarray(pi)), TQ.nuc_q_nst1(_t(pi))),
        (JQ.nuc_q_nst2(jnp.asarray(kappa), jnp.asarray(pi)),
         TQ.nuc_q_nst2(_t(kappa), _t(pi))),
        (JQ.nuc_q_gtr(jnp.asarray(r6), jnp.asarray(pi)),
         TQ.nuc_q_gtr(_t(r6), _t(pi))),
    ]
    pi20 = rng.dirichlet(np.ones(20)).astype(np.float32)
    ex = rng.random(190).astype(np.float32)
    pairs.append((JQ.reversible_q(jnp.asarray(ex), jnp.asarray(pi20)),
                  TQ.reversible_q(_t(ex), _t(pi20))))
    for qa, qb in pairs:
        np.testing.assert_allclose(qb.numpy(), np.asarray(qa), atol=1e-6)
        np.testing.assert_allclose(qb.sum(-1).numpy(), 0.0, atol=1e-6)


def _random_parents(n_tips, n_trees, seed):
    rng = np.random.default_rng(seed)
    return np.stack([random_unrooted(n_tips, rng).parent
                     for _ in range(n_trees)]).astype(np.int64)


@pytest.mark.parametrize("n_tips", [5, 12, 40])
def test_traversal_matches_jax(n_tips):
    parents = _random_parents(n_tips, 16, n_tips)
    tp = _t(parents)
    order = TTR.postorder_internal(tp, n_tips).numpy()
    depth = TTR.node_depths(tp).numpy()
    desc = TTR.descendant_matrix(tp).numpy()
    rng = np.random.default_rng(1)
    v = rng.integers(0, 2 * n_tips - 1, size=16)
    sub = TTR.subtree_mask(tp, _t(v)).numpy()
    for c, par in enumerate(parents):
        jp = jnp.asarray(par.astype(np.int32))
        np.testing.assert_array_equal(
            order[c], np.asarray(JTR.postorder_internal(jp, n_tips)))
        np.testing.assert_array_equal(depth[c],
                                      np.asarray(JTR.node_depths(jp)))
        np.testing.assert_array_equal(desc[c],
                                      np.asarray(JM._desc_matrix(jp)))
        np.testing.assert_array_equal(
            sub[c], np.asarray(JTR.subtree_mask(jp, int(v[c]))))


@pytest.mark.parametrize("s", [2, 4, 6, 8])
def test_jacobi_reconstructs(s):
    rng = np.random.default_rng(s)
    M = rng.normal(size=(32, s, s)).astype(np.float32)
    A = _t(M + np.swapaxes(M, -1, -2))
    w, V = TJ.jacobi_eigh(A)
    rec = V @ torch.diag_embed(w) @ V.transpose(-1, -2)
    scale = A.abs().amax(dim=(-2, -1), keepdim=True)
    assert ((rec - A).abs() / scale).max() < 1e-5
    eye = torch.eye(s).expand_as(A)
    assert (V.transpose(-1, -2) @ V - eye).abs().max() < 1e-5


def test_transition_probs_match_jax_gtr_gamma():
    rng = np.random.default_rng(3)
    C, N, K = 8, 23, 4
    pi = rng.dirichlet(np.ones(4) * 3, size=C).astype(np.float32)
    r6 = rng.dirichlet(np.ones(6), size=C).astype(np.float32)
    alpha = rng.uniform(0.1, 3.0, size=C).astype(np.float32)
    blen = rng.exponential(0.1, size=(C, N)).astype(np.float32)
    Qj = JQ.nuc_q_gtr(jnp.asarray(r6), jnp.asarray(pi))
    lam_j, U_j, V_j = jax.vmap(JTP.eigh_reversible)(Qj, jnp.asarray(pi))
    rates_j = JR.GammaRateTable(K)(jnp.asarray(alpha))          # [C, K]
    eff = jnp.asarray(blen)[:, :, None] * rates_j[:, None, :]   # [C, N, K]
    P_j = JTP.transition_probs(lam_j[:, None, None], U_j[:, None, None],
                               V_j[:, None, None], eff)
    Qt = TQ.nuc_q_gtr(_t(r6), _t(pi))
    lam, U, V = TTP.eigh_reversible(Qt, _t(pi))
    rates = TR.GammaRateTable(K)(_t(alpha))
    P_t = TTP.transition_probs(lam[:, None, None], U[:, None, None],
                               V[:, None, None],
                               _t(blen)[:, :, None] * rates[:, None, :])
    np.testing.assert_allclose(P_t.numpy(), np.asarray(P_j), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(P_t.sum(-1).numpy(), 1.0, atol=1e-5)
    # the eigensystem reconstructs Q
    Qr = U @ torch.diag_embed(lam) @ V
    np.testing.assert_allclose(Qr.numpy(), Qt.numpy(), atol=1e-5)


def test_eigh_reversible_rejects_large_state_spaces():
    """20 and 61 states are taken since the protein and codon models came
    (tests/test_torch_protein.py); beyond the eigensolvers' 64 it
    raises."""
    pi = torch.full((65,), 1.0 / 65)
    with pytest.raises(NotImplementedError, match="64 states"):
        TTP.eigh_reversible(torch.zeros(65, 65), pi)
