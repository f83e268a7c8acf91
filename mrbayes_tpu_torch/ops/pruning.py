"""Felsenstein pruning on dense tensors, batched over chains.

One division's log-likelihood for every chain given each chain's topology.
The conditional-likelihood tensor is ``[C, n_nodes, patterns, rate_cats,
states]``; ``root_partials`` is a Python loop over the internal nodes in
each chain's postorder, each step two batched (pattern×cat, state)×(state,
state) contractions.  Per-node max-rescaling keeps float32 partials in
range (role of the reference's CondLikeScaler_*, src/likelihood.c:4939-
5612; here rescaling is unconditional).  This is the plain twin of the
CUDA kernel in ``pruning_cuda.py``: the kernel is held against it.

Root reduction: lnL = Σ_p w_p log( (1-pinv) Σ_k f_k Σ_s π_s CL[p,k,s]
+ pinv Σ_s π_s 1[pattern p constant at s] ), reference
src/likelihood.c:6238-6368 (Likelihood_NUC4 family).

Through a pruner, a pass is a host span (``spans.py``),
``gen.lnl.operands``: P(t), the traversal order and the pruner's slot
tables, with the kernel's call (or its plain twin's) in the pruner's
``gen.lnl.launch`` inside it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spans import SPANS
from .pruning_cuda import PruningCuda
from .tiprobs import transition_probs
from .traversal import postorder_internal
from .wavefront_cuda import W_DEFAULT, PruningCudaWavefront

_TINY = 1e-30


def coding_tips(tip_partials, coding: str = "all") -> np.ndarray:
    """Tip partials [n, P, S] with, under an ascertainment coding other
    than "all", the S dummy constant patterns appended (one-hot columns,
    one per state; reference AddDummyChars, src/model.c:176)."""
    tp = np.asarray(tip_partials, np.float32)
    if coding == "all":
        return tp
    n, _, s = tp.shape
    dummy = np.broadcast_to(np.eye(s, dtype=np.float32), (n, s, s))
    return np.concatenate([tp, dummy], axis=1)


def make_pruner(tip_partials, n_cats: int, device, coding: str = "all",
                wavefront: bool = False):
    """The per-division pruning wiring (mrbayes_tpu/ops/pruning.py:27-59):
    the level-batched ``PruningCudaWavefront`` when the wavefront switch is
    on and the tree has at least 24 tips with K·S <= 32 (the JAX package's
    rule, with its W = 8), else the fused ``PruningCuda``.  The rule picks
    a path; neither is a fallback for the other.  ``coding`` other than
    "all" gives the pruner the dummy patterns ``division_loglik``
    expects."""
    tp = coding_tips(tip_partials, coding)
    n_tips, _, S = tp.shape
    if wavefront and n_tips >= 24 and n_cats * S <= 32:
        return PruningCudaWavefront(tp, n_cats, device, W=W_DEFAULT)
    return PruningCuda(tp, n_cats, device)


def branch_tiprobs(blen, lam, U, Uinv, cat_rates, pinv, rate_mult=1.0):
    """Per-branch, per-category transition matrices [C, n_nodes, K, S, S].
    ``pinv > 0`` rescales the variable-class rate by 1/(1-pinv)
    (reference src/likelihood.c:9309-9310).  blen [C, n_nodes]; lam [C, S]
    with U/Uinv [C, S, S] (one eigensystem a chain), or lam [C, K, S] with
    U/Uinv [C, K, S, S] (one a category: the NY98 omega classes);
    cat_rates [C, K]; pinv and rate_mult [C] or floats.  A float64
    eigensystem (S > 8) gives float64 products, returned in blen's
    dtype."""
    if torch.is_tensor(pinv):
        base = rate_mult / torch.clamp_min(1.0 - pinv, 1e-6)
    else:
        base = rate_mult / max(1.0 - pinv, 1e-6)
    if torch.is_tensor(base):
        base = base.reshape(-1, 1)                        # [C|1, 1]
    tau = blen * base
    eff = tau[..., None] * cat_rates[:, None, :]          # [C, N, K]
    if lam.ndim == 3:
        P = transition_probs(lam[:, None], U[:, None], Uinv[:, None], eff)
    else:
        P = transition_probs(lam[:, None, None], U[:, None, None],
                             Uinv[:, None, None], eff)
    return P.to(blen.dtype)


def root_partials(left, right, parent, blen, tip_partials, lam, U, Uinv,
                  cat_rates, pinv, n_tips: int, rate_mult=1.0):
    """Run the pruning pass for every chain; return (partials [C, n_nodes,
    P, K, S] with every internal row populated, logscale [C, P]).

    left/right/parent/blen [C, n_nodes]; tip_partials [n_tips, P, S]
    (shared by all chains); lam [C, S]; U/Uinv [C, S, S]; cat_rates
    [C, K]; pinv [C] or a float."""
    P = branch_tiprobs(blen, lam, U, Uinv, cat_rates, pinv, rate_mult)
    return _down_partials(P, left, right, parent, tip_partials, n_tips)


def _down_partials(P, left, right, parent, tip_partials, n_tips: int):
    """``root_partials`` from the per-branch operators P [C, n_nodes, K,
    S, S]."""
    C, n_nodes = parent.shape
    npat, s = tip_partials.shape[1], tip_partials.shape[2]
    k = P.shape[2]
    partials = tip_partials.new_zeros((C, n_nodes, npat, k, s))
    partials[:, :n_tips] = tip_partials[None, :, :, None, :]
    order = postorder_internal(parent, n_tips)
    rows = torch.arange(C, device=parent.device)
    logscale = tip_partials.new_zeros((C, npat))
    for i in range(n_tips - 1):
        v = order[:, i]
        lch = left.gather(1, v[:, None])[:, 0]
        rch = right.gather(1, v[:, None])[:, 0]
        wl = torch.einsum("cksj,cpkj->cpks", P[rows, lch], partials[rows, lch])
        wr = torch.einsum("cksj,cpkj->cpks", P[rows, rch], partials[rows, rch])
        cl = wl * wr
        m = torch.clamp_min(cl.amax(dim=(2, 3)), _TINY)       # [C, P]
        partials[rows, v] = cl / m[:, :, None, None]
        logscale = logscale + torch.log(m)
    return partials, logscale


def final_partials(left, right, parent, blen, tip_partials, lam, U, Uinv,
                   cat_rates, pinv, n_tips: int, rate_mult=1.0):
    """Down-pass and up-pass ("final" conditional likelihoods at every
    node) for posterior reporting, batched over chains
    (mrbayes_tpu/ops/pruning.py:110; the reference's CondLikeUp_* family,
    src/likelihood.c:4574-4938: a node's final partial is its down-pass
    partial times the parent's final with the node's own message divided
    out).  Plain PyTorch ops; launched once per sample, not per
    generation.

    Inputs as ``root_partials``.  Returns (D [C, n_nodes, P, K, S], F [C,
    n_nodes, P, K, S], flog [C, n_nodes, P], logscale [C, P]): D_root's
    true value is D[:, root] exp(logscale), F_v's is F[:, v] exp(logscale
    + flog[:, v]), so per-pattern posteriors need only logscale + flog for
    absolute terms (the pinvar mixture)."""
    C, n_nodes = parent.shape
    # the per-branch operators [C, n_nodes, K, S, S] of both passes
    P = branch_tiprobs(blen, lam, U, Uinv, cat_rates, pinv, rate_mult)
    D, logscale = _down_partials(P, left, right, parent, tip_partials,
                                 n_tips)
    root = n_nodes - 1
    F = torch.zeros_like(D)
    F[:, root] = D[:, root]
    flog = logscale.new_zeros((C, n_nodes, D.shape[2]))
    rev = postorder_internal(parent, n_tips).flip(-1)   # root first
    rows = torch.arange(C, device=parent.device)
    for i in range(n_tips - 1):
        v = rev[:, i]
        F_v, flog_v = F[rows, v], flog[rows, v]
        for side in (left, right):
            c = side.gather(1, v[:, None])[:, 0]
            P_c, D_c = P[rows, c], D[rows, c]
            # c's message to its parent, contracted on P's last axis as in
            # the down-pass
            s_c = torch.einsum("cksj,cpkj->cpks", P_c, D_c)
            up = F_v / torch.clamp_min(s_c, _TINY)
            # the up-pass contracts the parent's state with P's LAST axis
            # too, i.e. P[k, node_state, anc_state] read on its first
            # state axis for the node (the reference's active
            # CondLikeUp_NUC4 contraction, src/likelihood.c:4574; the
            # transposed one is off by up to 0.036 on the golden rows,
            # mrbayes_tpu/ops/pruning.py:151-159)
            F_c = torch.einsum("cpks,ckjs->cpkj", up, P_c) * D_c
            m = torch.clamp_min(F_c.amax(dim=(2, 3)), _TINY)   # [C, P]
            F[rows, c] = F_c / m[:, :, None, None]
            flog[rows, c] = flog_v + torch.log(m)
    return D, F, flog, logscale


def root_clv(left, right, parent, blen, tip_partials, lam, U, Uinv,
             cat_rates, pinv, n_tips: int, rate_mult=1.0, pruner=None):
    """Root conditional likelihoods in the kernels' layout [C, K, S, P] and
    per-pattern log rescale sums [C, P].  With a pruning wiring
    (``make_pruner``) the pass goes through it (the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors); otherwise through
    ``root_partials``."""
    if pruner is not None:
        with SPANS("gen.lnl.operands"):
            P = branch_tiprobs(blen, lam, U, Uinv, cat_rates, pinv,
                               rate_mult)
            order = postorder_internal(parent, n_tips)
            return pruner(order, left, right, P)
    partials, logscale = root_partials(
        left, right, parent, blen, tip_partials, lam, U, Uinv,
        cat_rates, pinv, n_tips, rate_mult)
    return partials[:, 2 * n_tips - 2].permute(0, 2, 3, 1), logscale


def division_site_loglik(left, right, parent, blen, tip_partials,
                         lam, U, Uinv, pi, cat_rates, pinv, const_mask,
                         n_tips: int, rate_mult=1.0, cat_weights=None,
                         pruner=None) -> torch.Tensor:
    """Per-pattern log-likelihoods [C, P] for one division.

    Shapes: left/right/parent/blen [C, 2n-1]; tip_partials [n, P, S];
    lam [C, S] or [C, K, S]; U/Uinv [C, S, S] or [C, K, S, S] (see
    ``branch_tiprobs``); pi [C, S]; cat_rates [C, K]; cat_weights [K] or
    [C, K] (None = equal 1/K); const_mask [P, S] (None when pinv is fixed
    at 0); pinv [C] or a float.
    """
    root_cl, logscale = root_clv(
        left, right, parent, blen, tip_partials, lam, U, Uinv,
        cat_rates, pinv if const_mask is not None else 0.0, n_tips,
        rate_mult, pruner=pruner)
    return site_loglik_from_root(root_cl, logscale, pi, pinv, const_mask,
                                 cat_weights)


def site_loglik_from_root(root, logscale, pi, pinv, const_mask,
                          cat_weights=None) -> torch.Tensor:
    """The root reduction: per-pattern log-likelihoods [C, P] from root
    conditional likelihoods in the kernels' layout [C, K, S, P] and log
    rescale sums [C, P], with the proportion-of-invariable-sites mixture
    when ``const_mask`` is given.  Shared by every path (per division,
    grouped, per shard), so a division's lnL is the same function of its
    root partials on each.  The state and category sums are two batched
    products: a three-operand ``torch.einsum`` searches its contraction
    path on every call, about 0.2 ms of host time.  ``cat_weights`` [K]
    is shared by the chains, [C, K] is each chain's own (the NY98 omega
    class frequencies)."""
    k = root.shape[1]
    if cat_weights is None:
        cat_weights = root.new_full((k,), 1.0 / k)
    if pi.ndim == 3:
        pi4 = pi[:, :, None, :]                                # [C, K, 1, S]
    else:
        pi4 = pi.reshape(-1, 1, 1, pi.shape[-1])               # [C|1,1,1,S]
    per_cat = torch.matmul(pi4, root)[:, :, 0]                 # [C, K, P]
    if cat_weights.ndim == 2:
        site_l = torch.matmul(cat_weights[:, None], per_cat)[:, 0]
    else:
        site_l = torch.matmul(cat_weights, per_cat)
    ln_var = torch.log(torch.clamp_min(site_l, _TINY)) + logscale
    if const_mask is None:
        return ln_var
    if pi.ndim == 3:
        # per-category frequencies: the constant patterns' categories
        # weighted as the variable ones'
        const_l = (cat_weights[..., None] * torch.einsum(
            "ps,cks->ckp", const_mask, pi)).sum(-2)
    else:
        const_l = torch.einsum("ps,cs->cp", const_mask, pi)
    return pinvar_mix(ln_var, const_l, pinv)


def pinvar_mix(ln_var, const_l, pinv) -> torch.Tensor:
    """The proportion-of-invariable-sites mixture [C, P] of the variable
    sites' log-likelihoods ``ln_var`` [C, P] and the constant patterns'
    likelihoods ``const_l`` [C, P] (sum over s of pi_s 1[pattern p
    constant at s]) under ``pinv`` [C] or a float."""
    pinv = (pinv.reshape(-1, 1) if torch.is_tensor(pinv)
            else ln_var.new_full((1, 1), pinv))               # [C|1, 1]
    ln_inv = torch.log(torch.clamp_min(pinv, _TINY)) + \
        torch.log(torch.clamp_min(const_l, _TINY))
    mixed = torch.logaddexp(
        torch.log1p(-torch.clamp_max(pinv, 1 - 1e-7)) + ln_var, ln_inv)
    return torch.where(pinv > 0.0, mixed, ln_var)


def division_loglik(left, right, parent, blen, tip_partials, weights,
                    lam, U, Uinv, pi, cat_rates, pinv, const_mask,
                    n_tips: int, rate_mult=1.0, coding: str = "all",
                    cat_weights=None, pruner=None) -> torch.Tensor:
    """Weighted log-likelihood [C] of one division, with optional
    ascertainment-bias correction for datasets that by construction lack
    certain patterns (reference: AddDummyChars src/model.c:176).

    coding: "all" (none) | "variable" | "noabsence" | "nopresence".  With
    a correction, ``tip_partials`` (and the pruner's tips) carry the S
    dummy constant patterns appended after the real ones.

    A pattern-sharded pruner (``ops/sharded_cuda.py``, installed by
    ``parallel.mesh.shard_engine_data``) has a ``loglik`` of its own: it
    holds the real patterns only, ``weights`` and ``const_mask`` are its
    ``Shards``, it reduces each shard on the shard's device and applies
    the coding correction from a pass over the dummy patterns
    (mrbayes_tpu/ops/pruning.py:288-303); ``tip_partials`` is not read.
    """
    if hasattr(pruner, "loglik"):
        with SPANS("gen.lnl.operands"):
            P = branch_tiprobs(blen, lam, U, Uinv, cat_rates,
                               pinv if const_mask is not None else 0.0,
                               rate_mult)
            order = postorder_internal(parent, n_tips)
            return pruner.loglik(order, left, right, P, pi, pinv,
                                 const_mask, weights, cat_weights)
    s = tip_partials.shape[-1]
    if coding != "all" and pruner is None:
        dummy = torch.eye(s, dtype=tip_partials.dtype,
                          device=tip_partials.device)
        tip_partials = torch.cat(
            [tip_partials, dummy.expand(tip_partials.shape[0], s, s)], 1)
    if coding != "all" and const_mask is not None:
        const_mask = torch.cat([const_mask, torch.eye(
            s, dtype=const_mask.dtype, device=const_mask.device)], 0)
    ln_site = division_site_loglik(
        left, right, parent, blen, tip_partials, lam, U, Uinv, pi,
        cat_rates, pinv, const_mask, n_tips, rate_mult, cat_weights,
        pruner=pruner)
    if coding == "all":
        return (weights * ln_site).sum(-1)
    return coding_total(ln_site[:, :-s], ln_site[:, -s:], weights, coding)


def coding_correction(ln_dummy, weight_total, coding: str):
    """Σ_p w_p log(1 - P(unobservable)) per chain, from the dummy
    patterns' per-pattern lnL [C, S] and the pattern-weight total."""
    if coding == "variable":
        p_unobs = torch.exp(ln_dummy).sum(-1)
    elif coding == "noabsence":
        p_unobs = torch.exp(ln_dummy[:, 0])
    elif coding == "nopresence":
        p_unobs = torch.exp(ln_dummy[:, -1])
    else:
        raise ValueError(f"unknown coding {coding!r}")
    return weight_total * torch.log1p(-torch.clamp_max(p_unobs, 1.0 - 1e-7))


def coding_total(ln_real, ln_dummy, weights, coding: str):
    """Σ_p w_p ln L_p - Σ_p w_p log(1 - P(unobservable)), per chain."""
    return (weights * ln_real).sum(-1) - coding_correction(
        ln_dummy, weights.sum(), coding)


def adgamma_loglik_from_cats(rP, ln_scale, M_pows, jump_idx):
    """The autocorrelated-gamma HMM's log-likelihood [C] from per-site
    category likelihoods (mrbayes_tpu/ops/pruning.py:346; reference
    CalcLikeAdgamma, src/mcmc.c:1575: the forward algorithm with uniform
    category frequencies).

    rP [C, n, K]: rescaled per-site category likelihoods in site order;
    ln_scale [C, n] their log scalers; M_pows [C, U, K, K] each chain's
    powers of the category transition matrix; jump_idx [n] the static
    index into M_pows of the distance from site c - 1 to c (entry 0
    unused).  The forward recursion F_c = diag(rP_c) M^{j_c} F_{c-1} is the
    product of the site operators A_c = diag(rP_c) M^{j_c} (A_0 =
    diag(rP_0)) applied to the uniform start; only the whole product is
    needed (the JAX package's scan keeps its last element), so it is
    reduced pairwise in site order, A_{2i+1} A_{2i}, with an identity
    appended at an odd count: ceil(log2 n) rounds of batched [K, K]
    products, each rescaled by its max and the log carried."""
    C, n, K = rP.shape
    first = torch.diag_embed(rP[:, :1])                      # [C, 1, K, K]
    A = torch.cat([first, rP[:, 1:, :, None] * M_pows[:, jump_idx[1:]]], 1)
    m = torch.clamp_min(A.amax((-2, -1)), _TINY)
    A = A / m[..., None, None]
    logs = torch.log(m).sum(-1)
    eye = torch.eye(K, dtype=A.dtype, device=A.device).expand(C, 1, K, K)
    while A.shape[1] > 1:
        if A.shape[1] % 2:
            A = torch.cat([A, eye], 1)
        A = A[:, 1::2] @ A[:, 0::2]
        m = torch.clamp_min(A.amax((-2, -1)), _TINY)
        A = A / m[..., None, None]
        logs = logs + torch.log(m).sum(-1)
    return logs + ln_scale.sum(-1) + torch.log(A[:, 0].sum((-2, -1)) / K)


def constant_state_mask(patterns, n_states: int):
    """Host-side helper: [P, S] 1.0 where a pattern is compatible with all
    taxa having constant state s (bit s set in every taxon's mask)."""
    bits = (patterns[..., None] >> np.arange(n_states)) & 1  # [n,P,S]
    return np.all(bits, axis=0).astype(np.float32)
