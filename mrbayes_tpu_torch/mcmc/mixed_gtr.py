"""nst=mixed: rjMCMC over the 203 GTR substitution submodels, batched
over chains.

Counterpart of ``mrbayes_tpu/mcmc/mixed_gtr.py``.  A submodel is a
partition of the 6 exchangeability slots into rate classes, encoded as a
canonical restricted-growth vector ``z[6]`` (z[0] = 0, z[i] <= max(z[:i])
+ 1; reference FromIndexToGrowthFxn, src/model.c).  The state keeps the
full 6-vector of exchangeabilities, equal within a class, so the
likelihood path (``nuc_q_gtr``) is unchanged.

Prior (reference src/mcmc.c:7662 REVMAT_MIX): uniform 1/203 over
submodels times a Dirichlet on the collapsed class proportions with
concentration ``symdir * class_size``.  Split/merge follows reference
Move_Revmat_SplitMerge1 (src/proposal.c:15329); the value move is
Move_Revmat_DirMix.

Every function takes ``z [C, 6]`` (int64) and ``values [C, 6]`` and is
fixed-size masked arithmetic over the 6 slots, with no host
synchronisation.  The ``*_given`` forms take their random numbers as
arguments (uniforms, and a ``gamma(alpha, which)`` callable for the gamma
draws) so that tests can feed them the JAX package's draws; the plain
forms draw them from a ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch

from .moves import NEG_INF

SIX = 6
_LN_203 = math.log(203.0)


def class_stats(z, values):
    """Per-class (counts [C, 6], sums [C, 6], k [C]); classes are
    0..k-1."""
    onehot = (z[..., None] == torch.arange(SIX, device=z.device)).to(
        values.dtype)                                    # [C, slot, class]
    counts = onehot.sum(1)
    sums = torch.einsum("csk,cs->ck", onehot, values)
    k = z.amax(1) + 1
    return counts, sums, k


def _slots(z):
    return torch.arange(SIX, device=z.device)[None, :]


def ln_prior_mixed(z, values, symdir: float = 1.0):
    """Log prior [C] of (submodel, exchangeabilities)."""
    counts, sums, k = class_stats(z, values)
    used = _slots(z) < k[:, None]
    lp = math.lgamma(6.0 * symdir) - torch.where(
        used, torch.lgamma(counts.clamp_min(1.0) * symdir), 0.0).sum(1)
    lp = lp + torch.where(
        used, (counts * symdir - 1.0) * torch.log(sums.clamp_min(1e-30)),
        0.0).sum(1)
    return lp - _LN_203


def _uniform_int(u, n):
    """Uniform integer in [0, n) per chain from u [C] and n [C]."""
    return torch.minimum((u * n).long(), n - 1)


def _row(x, i):
    """x [C, 6] at a per-chain index i [C] (clamped into range: a branch
    that is not selected may compute an index of -1)."""
    return x.gather(1, i.clamp(0, SIX - 1)[:, None])[:, 0]


def splitmerge_given(z, values, alpha, u_merge, u_i, u_j, gamma):
    """One split-or-merge proposal per chain from the given draws.
    ``alpha [C]`` is the tuning concentration of the Beta reallocation;
    ``u_merge``, ``u_i``, ``u_j`` are uniforms [C]; ``gamma(a, which)``
    returns Gamma(a) draws [C] for ``which`` in (0, 1).  Returns
    (z', values', lnH)."""
    counts, sums, k = class_stats(z, values)
    slots = _slots(z)
    kf = k.to(values.dtype)
    do_merge = torch.where(k == 1, False,
                           torch.where(k == SIX, True, u_merge < 0.5))

    # ---------------- merge ----------------
    i0 = _uniform_int(u_i, k)
    j0 = _uniform_int(u_j, k - 1)
    j0 = torch.where(j0 == i0, k - 1, j0)
    ci = torch.minimum(i0, j0)
    cj = torch.maximum(i0, j0)
    n_i, n_j = _row(counts, ci), _row(counts, cj)
    R_i, R_j = _row(sums, ci), _row(sums, cj)
    R = R_i + R_j
    ci_, cj_ = ci[:, None], cj[:, None]
    zm = torch.where(z == cj_, ci_, torch.where(z > cj_, z - 1, z))
    vm = torch.where(zm == ci_, (R / (n_i + n_j))[:, None], values)
    c2, _, k2 = class_stats(zm, vm)
    ncomp = ((slots < k2[:, None]) & (c2 > 1.5)).sum(1).to(values.dtype)
    prob_split = torch.where(k - 1 == 1, 1.0, 0.5)
    prob_merge = torch.where(k == SIX, 1.0, 0.5)
    nm = n_i + n_j
    a_i, a_j = alpha * n_i, alpha * n_j
    hm = (torch.log(prob_split / prob_merge)
          + torch.log(kf * (kf - 1.0) / (2.0 * ncomp))
          - torch.log(2.0 ** (nm - 1.0) - 1.0))
    hm = hm + (torch.lgamma(a_i + a_j) - torch.lgamma(a_i)
               - torch.lgamma(a_j)
               + (a_i - 1.0) * torch.log((R_i / R).clamp_min(1e-30))
               + (a_j - 1.0) * torch.log((R_j / R).clamp_min(1e-30)))
    hm = hm - torch.log(R.clamp_min(1e-30))

    # ---------------- split ----------------
    used = slots < k[:, None]
    comp = used & (counts > 1.5)
    ncomp_s = comp.sum(1)
    r = _uniform_int(u_i, ncomp_s.clamp_min(1))
    cum = comp.long().cumsum(1) - 1
    cs = ((cum == r[:, None]) & comp).long().argmax(1)
    m = _row(counts, cs).long()
    nsub = 2.0 ** (m - 1.0) - 1.0
    rint = 1 + _uniform_int(u_j, nsub.clamp_min(1.0).long())
    in_class = z == cs[:, None]
    rank = in_class.long().cumsum(1) - 1
    move_bit = (rint[:, None] >> (rank - 1).clamp(0, 5)) & 1
    moves = in_class & (rank >= 1) & (move_bit == 1)
    first_moved = moves.long().argmax(1)
    before = slots < first_moved[:, None]
    cjs = torch.where(before, z, 0).amax(1) + 1
    cs_, cjs_ = cs[:, None], cjs[:, None]
    zs = torch.where(moves, cjs_,
                     torch.where((~moves) & (z >= cjs_), z + 1, z))
    n_js = moves.sum(1).to(values.dtype)
    n_is = _row(counts, cs) - n_js
    Rs = _row(sums, cs)
    a_is, a_js = alpha * n_is, alpha * n_js
    g1 = gamma(a_is.clamp_min(1e-4), 0)
    g2 = gamma(a_js.clamp_min(1e-4), 1)
    p_i = (g1 / (g1 + g2)).clamp(1e-6, 1.0 - 1e-6)
    vs = torch.where(
        zs == cs_, (p_i * Rs / n_is.clamp_min(1.0))[:, None],
        torch.where(zs == cjs_,
                    ((1.0 - p_i) * Rs / n_js.clamp_min(1.0))[:, None],
                    values))
    prob_merge_s = torch.where(k + 1 == SIX, 1.0, 0.5)
    prob_split_s = torch.where(k == 1, 1.0, 0.5)
    nms = n_is + n_js
    hs = (torch.log(prob_merge_s / prob_split_s)
          + torch.log(2.0 * ncomp_s.to(values.dtype) / ((kf + 1.0) * kf))
          + torch.log(2.0 ** (nms - 1.0) - 1.0))
    hs = hs - (torch.lgamma(a_is + a_js) - torch.lgamma(a_is)
               - torch.lgamma(a_js) + (a_is - 1.0) * torch.log(p_i)
               + (a_js - 1.0) * torch.log(1.0 - p_i))
    hs = hs + torch.log(Rs.clamp_min(1e-30))

    dm = do_merge[:, None]
    z2 = torch.where(dm, zm, zs)
    v2 = torch.where(dm, vm, vs)
    lnH = torch.where(do_merge, hm, hs)
    ok = (v2 > 1e-7).all(1) & (v2 < 1.0).all(1)
    return z2, v2, torch.where(ok, lnH, NEG_INF)


def _gamma_from(gen):
    def gamma(a, which):
        return torch._standard_gamma(a, generator=gen)
    return gamma


def splitmerge(gen, z, values, alpha):
    """``splitmerge_given`` with draws from the generator ``gen``."""
    u = torch.rand((z.shape[0], 3), generator=gen, device=z.device)
    return splitmerge_given(z, values, alpha, u[:, 0], u[:, 1], u[:, 2],
                            _gamma_from(gen))


def dirichlet_mixed_given(z, values, conc, gamma):
    """Value move that keeps the class structure: a Dirichlet proposal on
    the collapsed class proportions, shared equally within each class.
    ``conc [C]``; ``gamma(alpha [C, 6], 0)`` returns Gamma draws.
    Returns (values', lnH)."""
    counts, sums, k = class_stats(z, values)
    used = _slots(z) < k[:, None]
    c = conc[:, None]
    props = torch.where(used, sums, 1.0)       # 1.0 on unused slots
    alpha_f = torch.where(used, (c * props).clamp_min(1e-4), 1.0)
    g = torch.where(used, gamma(alpha_f, 0) + 1e-10, 0.0)
    newp = g / g.sum(1, keepdim=True)
    alpha_b = torch.where(used, (c * newp).clamp_min(1e-4), 1.0)

    def masked_dir_lpdf(x, a):
        lx = torch.log(x.clamp_min(1e-30))
        return (torch.lgamma(torch.where(used, a, 0.0).sum(1))
                - torch.where(used, torch.lgamma(a), 0.0).sum(1)
                + torch.where(used, (a - 1.0) * lx, 0.0).sum(1))

    lnH = masked_dir_lpdf(props, alpha_b) - masked_dir_lpdf(newp, alpha_f)
    vals2 = (newp / counts.clamp_min(1.0)).gather(1, z)
    ok = torch.where(used, newp > 1e-7, True).all(1)
    return vals2, torch.where(ok, lnH, NEG_INF)


def dirichlet_mixed(gen, z, values, conc):
    """``dirichlet_mixed_given`` with draws from the generator ``gen``."""
    return dirichlet_mixed_given(z, values, conc, _gamma_from(gen))


def growth_string(z) -> str:
    """'112123'-style submodel label (reference modelElementNames)."""
    return "".join(str(int(x) + 1) for x in z)
