"""Brownian-motion (continuous-trait) likelihood by phylogenetic
independent contrasts (counterpart of mrbayes_tpu/ops/brownian.py).

Felsenstein's REML formulation: a postorder pass gives n - 1 independent
contrasts x_l - x_r with variance sigma^2 (v_l' + v_r'), where v' is the
branch length plus the extra variance v_l' v_r' / (v_l' + v_r') that
pruning leaves on the reduced node.  The REML likelihood is the product
of the contrasts' densities, invariant to the root state.

The reference declares the data type (datatype=continuous, brownscalepr
and browncorrpr, src/command.c:14605), but its Likelihood_Cont is an empty
stub that returns lnL = 0 (src/likelihood.c:7554-7566), so the density is
held against a dense multivariate-normal oracle
(tests/test_torch_symdiri_continuous.py), not the reference.  Characters
are independent given the tree (browncorrpr fixed at 0, the reference
default, src/bayes.c:792-793).

Batched over chains: one step a postorder position, each a few gathers
and elementwise ops on [C, characters]; no kernel of its own.
"""
from __future__ import annotations

import math

import torch

from .traversal import postorder_internal

_EPS = 1e-12


def pic_logpdf(left, right, parent, blen, values, sigma2, n_tips: int):
    """REML log-density [C] of ``values`` [n_tips, M] (the tips' traits,
    shared by the chains) under Brownian motion with variance rate
    ``sigma2`` [C] on each chain's tree (left/right/parent/blen [C,
    n_nodes], the rooted-at-tip-0 layout: the root's zero-length branch
    adds no variance, so the root's contrast spans the basal split and
    there are exactly n_tips - 1 contrasts)."""
    C, n_nodes = parent.shape
    x = values.new_zeros((C, n_nodes, values.shape[1]))
    x[:, :n_tips] = values
    extra = blen.new_zeros((C, n_nodes))
    rows = torch.arange(C, device=parent.device)
    order = postorder_internal(parent, n_tips)
    s2 = sigma2.reshape(C, 1)
    ll = blen.new_zeros(C)
    for k in range(n_tips - 1):
        v = order[:, k]
        lc = left.gather(1, v[:, None])[:, 0]
        rc = right.gather(1, v[:, None])[:, 0]
        vl = (blen[rows, lc] + extra[rows, lc])[:, None]
        vr = (blen[rows, rc] + extra[rows, rc])[:, None]
        V = torch.clamp_min(vl + vr, _EPS)
        xl, xr = x[rows, lc], x[rows, rc]
        contrast = xl - xr
        ll = ll - 0.5 * (torch.log(2.0 * math.pi * s2 * V)
                         + contrast * contrast / (s2 * V)).sum(-1)
        x[rows, v] = (vr * xl + vl * xr) / V
        extra[rows, v] = (vl * vr / V)[:, 0]
    return ll
