"""The port's nst=mixed rjMCMC (``mcmc/mixed_gtr.py``) against the JAX
package's, on identical inputs and identical random draws.

For each chain the JAX function runs with its own PRNG key; the port's
``*_given`` forms receive the uniforms and gamma variates that JAX draws
from the same key splits.  Submodels are random restricted-growth strings
(including the 1-class and 6-class ends).  Proposed submodels must be
equal; values and log priors agree within 1e-5 (float32 arithmetic in a
different order).  A Hastings term is a difference of log-gamma terms of
up to about 1e3 at the engine's tunings, so float32 rounding alone moves
it by about 1e-4: it is held within 1e-5 of the magnitude of its largest
log-gamma term."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrbayes_tpu.mcmc import mixed_gtr as JMG
from mrbayes_tpu_torch.mcmc import mixed_gtr as TMG

# the tensors here are small: intra-op threads would only contend with
# the other test workers (an engine block ran 50x slower with them)
torch.set_num_threads(1)

C = 24
TOL = dict(rtol=1e-5, atol=1e-5)


def _states(seed):
    rng = np.random.default_rng(seed)
    z = np.zeros((C, 6), np.int64)
    for c in range(C):
        if c == 0:
            continue                      # k = 1
        if c == 1:
            z[c] = np.arange(6)           # k = 6
            continue
        for i in range(1, 6):
            z[c, i] = rng.integers(0, z[c, :i].max() + 2)
    vals = np.zeros((C, 6), np.float32)
    for c in range(C):
        k = z[c].max() + 1
        props = rng.dirichlet(np.ones(k) * 3.0)
        counts = np.bincount(z[c], minlength=k)
        vals[c] = (props / counts)[z[c]]
    alpha = rng.uniform(0.5, 20.0, C).astype(np.float32)
    return z, vals, alpha


def _lnh_tol(total_conc):
    """Absolute tolerance per chain: 1e-5 of the largest log-gamma term
    (the concentration summed over the simplex)."""
    return 1e-5 * (1.0 + np.array([abs(math.lgamma(float(a)))
                                   for a in total_conc]))


def _keys(seed):
    return [jax.random.split(jax.random.PRNGKey(seed + c), 6)
            for c in range(C)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_splitmerge_matches_jax(seed):
    z, vals, alpha = _states(seed)
    keys = _keys(1000 * seed)
    ref = [JMG.splitmerge(jax.random.PRNGKey(1000 * seed + c),
                          jnp.asarray(z[c], jnp.int32), jnp.asarray(vals[c]),
                          jnp.float32(alpha[c])) for c in range(C)]

    def uni(j):
        return torch.tensor([float(jax.random.uniform(keys[c][j]))
                             for c in range(C)])

    def gamma(a, which):
        return torch.tensor([float(jax.random.gamma(
            keys[c][3 + which], jnp.float32(a[c].item())))
            for c in range(C)])

    z2, v2, lnH = TMG.splitmerge_given(
        torch.as_tensor(z), torch.as_tensor(vals), torch.as_tensor(alpha),
        uni(0), uni(1), uni(2), gamma)
    np.testing.assert_array_equal(z2.numpy(),
                                  np.stack([np.asarray(r[0]) for r in ref]))
    np.testing.assert_allclose(v2.numpy(),
                               np.stack([np.asarray(r[1]) for r in ref]),
                               **TOL)
    err = np.abs(lnH.numpy() - np.array([float(r[2]) for r in ref]))
    assert (err <= _lnh_tol(alpha * 6.0)).all(), err
    # both split and merge proposals were exercised
    k0 = z.max(1) + 1
    k1 = z2.numpy().max(1) + 1
    assert (k1 > k0).any() and (k1 < k0).any()


@pytest.mark.parametrize("seed", [4, 5])
def test_dirichlet_mixed_matches_jax(seed):
    z, vals, alpha = _states(seed)
    conc = alpha * 10.0
    keys = [jax.random.PRNGKey(2000 * seed + c) for c in range(C)]
    ref = [JMG.dirichlet_mixed(keys[c], jnp.asarray(z[c], jnp.int32),
                               jnp.asarray(vals[c]), jnp.float32(conc[c]))
           for c in range(C)]

    def gamma(a, which):
        return torch.as_tensor(np.stack([np.asarray(jax.random.gamma(
            keys[c], jnp.asarray(a[c].numpy()))) for c in range(C)]))

    v2, lnH = TMG.dirichlet_mixed_given(
        torch.as_tensor(z), torch.as_tensor(vals), torch.as_tensor(conc),
        gamma)
    np.testing.assert_allclose(v2.numpy(),
                               np.stack([np.asarray(r[0]) for r in ref]),
                               **TOL)
    err = np.abs(lnH.numpy() - np.array([float(r[1]) for r in ref]))
    assert (err <= _lnh_tol(conc)).all(), err


@pytest.mark.parametrize("symdir", [1.0, 2.5])
def test_ln_prior_mixed_matches_jax(symdir):
    z, vals, _ = _states(7)
    ref = np.array([float(JMG.ln_prior_mixed(jnp.asarray(z[c], jnp.int32),
                                             jnp.asarray(vals[c]), symdir))
                    for c in range(C)])
    got = TMG.ln_prior_mixed(torch.as_tensor(z), torch.as_tensor(vals),
                             symdir)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_generator_forms_keep_the_class_structure():
    """The generator-driven forms give valid submodels whose values stay
    equal within each class and sum to one."""
    z, vals, alpha = _states(9)
    gen = torch.Generator().manual_seed(3)
    zt, vt = torch.as_tensor(z), torch.as_tensor(vals)
    for _ in range(5):
        z2, v2, lnH = TMG.splitmerge(gen, zt, vt, torch.as_tensor(alpha))
        ok = lnH > -1e29
        zt = torch.where(ok[:, None], z2, zt)
        vt = torch.where(ok[:, None], v2, vt)
        v3, lnH = TMG.dirichlet_mixed(gen, zt, vt,
                                      torch.as_tensor(alpha) * 10)
        vt = torch.where((lnH > -1e29)[:, None], v3, vt)
    np.testing.assert_allclose(vt.sum(1).numpy(), 1.0, atol=1e-5)
    for c in range(C):
        zc = zt[c].numpy()
        # restricted growth: each slot's class is at most max(prefix) + 1
        assert zc[0] == 0 and all(zc[i] <= zc[:i].max() + 1
                                  for i in range(1, 6))
        for cls in np.unique(zc):
            v = vt[c].numpy()[zc == cls]
            np.testing.assert_allclose(v, v[0], rtol=1e-6)
