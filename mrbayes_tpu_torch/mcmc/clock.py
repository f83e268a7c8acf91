"""Clock (rooted, dated) trees: priors, branch-rate models and moves,
batched over chains.

Counterpart of ``mrbayes_tpu/mcmc/clock.py`` for clock trees without
dating or constraints (ROADMAP Queue 1 item 10a).  State layout for a
clock model, every tensor with a leading chain axis: internal-node ages in
time units (``age [C, n_nodes]``, tips at 0, the root at node 2n-2), an
optional sampled clock rate (``clockrate [C, 1]``) and, for relaxed
clocks, per-branch rates (``brate [C, n_nodes]``) with their variance
(``clockvar [C, 1]``).  There is no ``blen``: substitution branch lengths
are derived, ``blen[v] = (age[parent v] - age[v]) * clockrate * r_v``
with ``r_v`` = 1 (strict), the branch's rate (IGR/ILN/WN) or the mean of
its endpoints' rates (TK02), and ``blen[root] = 0``.

Priors reproduce the reference formulas (as the JAX package does):
- uniform clock: src/mcmc.c:9460 LnUniformPriorPr (uncalibrated branch)
- birth-death with rho-sampling, strategies random/diversity/cluster:
  src/mcmc.c:8357-8556
- coalescence (+ growth): src/mcmc.c:9273 LnCoalescencePriorPr_Contemp
- relaxed-clock branch-rate priors: src/mcmc.c:8226-8321

Moves follow ``moves.py``: ``fn(gen, state, tuning, n_tips) -> (state,
ln_hastings)``, all chains make the same kind of move, each with its own
uniforms, and nothing synchronises with the host (data-dependent picks
are masked inverse-CDF or Gumbel-max choices on the device).

Dating (ROADMAP Queue 1 item 10b): tips may carry ages (dated fossils,
``age[:n_tips]`` nonzero); a sampled ancestor is a fossil tip on a
zero-length branch, flagged in ``sa [C, n_tips]``, whose parent's age
``pin_sa_ages`` pins to the fossil's.  The fossilized birth-death prior
(random, fossiltip and diversity sampling, src/mcmc.c:8693-9155), the
uniform prior with dated tips (src/mcmc.c:9460), the add/delete-branch
rjMCMC (src/proposal.c:1266, :1537) and the tip-date slider follow the
JAX package.  Unlike the JAX package, the moves treat a pinned parent as
no free coordinate, so sampled ancestors are accepted (see "sampled
ancestors" below).  The CPP relaxed
clock keeps its rate-multiplier events in fixed-capacity slots
(``cpp_pos``/``cpp_mult [C, n_nodes, K]``, counts ``cpp_n [C, n_nodes]``);
``clockvarpr=mixed`` switches each chain between the IGR and ILN
densities on ``rcl_model [C, 1]``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.traversal import ancestor_matrix, descendant_matrix, \
    subtree_mask
from .moves import (NEG_INF, _fitch, _masked_choice, _node_ids, _pars_pick,
                    _pars_scores, _put, _replace_child, _take, _uniforms)

RELAXED = ("igr", "iln", "wn", "tk02")
# every clockvarpr with per-branch rates ``brate``: the relaxed clocks and
# the IGR/ILN switch of clockvarpr=mixed
BRATE_CLOCKS = RELAXED + ("mixed",)
# the relaxed clocks whose branch-rate prior depends on the branch length
# (``ln_branch_rates_prior``): no sampled ancestor under them
LENGTH_RATE_CLOCKS = ("wn", "tk02")


# ---------------------------------------------------------------------------
# derived branch lengths


def _parent_values(x, parent, root):
    """x[c, parent[c, v]] [C, n_nodes], the root's own value at the root."""
    return torch.where(parent >= 0, x.gather(1, parent.clamp_min(0)),
                       x[:, root:root + 1])


def clock_blens(state: dict, n_tips: int, clockvar: str) -> torch.Tensor:
    """Substitution-unit branch lengths [C, n_nodes] from ages and rates
    (of a state whose sampled ancestors are already pinned,
    ``pin_sa_ages``)."""
    age, parent = state["age"], state["parent"]
    root = 2 * n_tips - 2
    dt = (_parent_values(age, parent, root) - age).clamp_min(0.0)
    if "clockrate" in state:
        dt = dt * state["clockrate"][:, :1]
    if clockvar == "tk02":
        br = state["brate"]
        dt = dt * (0.5 * (br + _parent_values(br, parent, root)))
    elif clockvar == "cpp":
        dt = dt * cpp_branch_multipliers(parent, state["cpp_pos"],
                                         state["cpp_mult"], state["cpp_n"])
    elif clockvar in BRATE_CLOCKS:
        dt = dt * state["brate"]
    elif clockvar != "strict":
        raise ValueError(f"unknown clockvarpr {clockvar}")
    return torch.where(_node_ids(state) == root, 0.0, dt)


# ---------------------------------------------------------------------------
# CPP (compound Poisson process) relaxed clock
#
# Rate-multiplier events on branches in fixed-capacity slots (the
# reference's realloc'd per-branch arrays, src/bayes.h:711-714).  The
# effective length follows UpdateCppEvolLength (src/model.c:25923):
# positions measured from the tipward end; the rate at a point is the
# inherited (rootward) rate times the multipliers of the events closer to
# the tipward end; children inherit rate x the product of the branch's
# multipliers.


def _cpp_active(cpp_n, K):
    """[C, n, K] bool: the occupied event slots."""
    return torch.arange(K, device=cpp_n.device) < cpp_n[..., None]


def cpp_branch_multipliers(parent, cpp_pos, cpp_mult, cpp_n):
    """Per-branch effective rate multiplier r_v [C, n_nodes]: the effective
    substitution length is ``dt * clockrate * r_v``, the inherited path rate
    times the within-branch integral of the piecewise rate (reference
    UpdateCppEvolLengths, src/model.c:25996)."""
    K = cpp_pos.shape[-1]
    active = _cpp_active(cpp_n, K)
    logm = torch.where(active, torch.log(cpp_mult.clamp_min(1e-30)), 0.0)
    s = logm.sum(-1)                                  # [C, n]
    A = ancestor_matrix(parent)                       # A[u, v]: v anc-or-self
    base = torch.exp((A @ s[..., None])[..., 0] - s)  # strict ancestors only
    # within-branch relative length over the positions sorted ascending
    # (empty slots pad at position 1 with multiplier 1 and drop out)
    pos_s, order = torch.sort(torch.where(active, cpp_pos, 1.0), dim=-1)
    m_s = torch.where(active, cpp_mult, 1.0).gather(-1, order)
    rel = pos_s[..., 0] * m_s[..., 0]
    for i in range(1, K):
        rel = (rel + pos_s[..., i] - pos_s[..., i - 1]) * m_s[..., i]
    rel = rel + 1.0 - pos_s[..., K - 1]
    return base * rel


def _ln_lognormal_mult(m, sigma):
    """log density of a LogNormal(0, sigma) rate multiplier."""
    return (-torch.log(m) - math.log(sigma) - 0.5 * math.log(2.0 * math.pi)
            - torch.log(m) ** 2 / (2.0 * sigma ** 2))


def ln_cpp_prior(state, n_tips: int, lam, sigma: float) -> torch.Tensor:
    """CPP event prior [C]: per branch of strict length L, events are a
    Poisson process of rate ``lam`` [C] per expected substitution with
    LogNormal(0, sigma) multipliers; positions integrate out, leaving
    exp(-lam L) lam^k prod f(m) (the add/delete prior ratio of
    Move_AddDeleteCPPEvent, src/proposal.c:286-293)."""
    nonroot = _node_ids(state) != 2 * n_tips - 2
    L = clock_blens(state, n_tips, "strict")
    k_b = state["cpp_n"].to(L.dtype)
    lp = torch.where(nonroot, -lam[:, None] * L
                     + k_b * torch.log(lam)[:, None], 0.0).sum(1)
    active = _cpp_active(state["cpp_n"], state["cpp_pos"].shape[-1])
    lnln = _ln_lognormal_mult(state["cpp_mult"].clamp_min(1e-30), sigma)
    return lp + torch.where(active & nonroot[:, None], lnln, 0.0).sum((1, 2))


def _take2(x, v, j):
    """x [C, n, K] -> x[c, v[c], j[c]]."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, v, j]


def _put2(x, v, j, val):
    """Out-of-place x[c, v[c], j[c]] = val[c]."""
    rows = torch.arange(x.shape[0], device=x.device)
    out = x.clone()
    out[rows, v, j] = val.to(x.dtype)
    return out


def _slot(u, count):
    """A uniform slot index in [0, count) from u [C] (0 when count is 0)."""
    return torch.minimum((u * count).long(), (count - 1).clamp_min(0))


def _cpp_branch(gen, state, n_tips, k):
    """k uniforms [C, k] and a uniform non-root branch v [C] with its
    event count."""
    u = _uniforms(gen, state["age"], k + 1)
    nonroot = (_node_ids(state) != 2 * n_tips - 2).expand_as(state["age"])
    v = _masked_choice(u[:, 0], nonroot)
    return u[:, 1:], v, _take(state["cpp_n"], v)


def make_cpp_adddelete(sigma: float):
    """rjMCMC add/delete of one CPP event (reference
    Move_AddDeleteCPPEvent, src/proposal.c:174).  The engine recomputes
    the prior, so only the proposal ratio is returned."""
    def move(gen, state, tuning, n_tips):
        u, v, k = _cpp_branch(gen, state, n_tips, 5)
        npos, nmult, nn = state["cpp_pos"], state["cpp_mult"], state["cpp_n"]
        K = npos.shape[-1]
        add = (k == 0) | (u[:, 0] < 0.5)
        # the strict-substitution length of the branch (the CPP unit)
        age = state["age"]
        L_v = _take(age, _take(state["parent"], v)) - _take(age, v)
        if "clockrate" in state:
            L_v = L_v * state["clockrate"][:, 0]
        L_v = L_v.clamp_min(1e-30)
        kf = k.to(L_v.dtype)
        # add: slot k (rejected at capacity); the multiplier lognormal by
        # Box-Muller, the position uniform
        z = torch.sqrt(-2.0 * torch.log(u[:, 2].clamp_min(1e-30))) \
            * torch.cos(2.0 * math.pi * u[:, 3])
        m_new = torch.exp(sigma * z)
        slot_a = k.clamp_max(K - 1)
        pos_a = _put2(npos, v, slot_a, u[:, 4])
        mult_a = _put2(nmult, v, slot_a, m_new)
        lnH_a = (torch.log(L_v) - torch.log(kf + 1.0)
                 - _ln_lognormal_mult(m_new, sigma)
                 + torch.where(k == 0, math.log(0.5), 0.0))
        lnH_a = torch.where(k >= K, NEG_INF, lnH_a)
        if "sa" in state:
            # no event on an ancestral fossil's zero-length branch
            lnH_a = torch.where(_take(_sa_tips(state, nn.shape[1]), v),
                                NEG_INF, lnH_a)
        # delete: a uniform event; the last active slot fills the hole
        kk = k.clamp_min(1)
        j = _slot(u[:, 1], kk)
        last = kk - 1
        m_del = _take2(nmult, v, j)
        pos_d = _put2(npos, v, j, _take2(npos, v, last))
        mult_d = _put2(nmult, v, j, _take2(nmult, v, last))
        lnH_d = (torch.log(kk.to(L_v.dtype)) - torch.log(L_v)
                 + _ln_lognormal_mult(m_del.clamp_min(1e-30), sigma)
                 + torch.where(k == 1, math.log(2.0), 0.0))
        a3 = add[:, None, None]
        n2 = _put(nn, v, torch.where(add, k + 1, k - 1)).clamp(0, K)
        return ({**state, "cpp_pos": torch.where(a3, pos_a, pos_d),
                 "cpp_mult": torch.where(a3, mult_a, mult_d),
                 "cpp_n": n2}, torch.where(add, lnH_a, lnH_d))

    move.__name__ = "move_cpp_adddelete"
    return move


def move_cpp_position(gen, state, tuning, n_tips):
    """Resample one event's position uniformly on its branch (role of
    reference Move_CPPEventPosition, src/proposal.c:932); symmetric."""
    u, v, k = _cpp_branch(gen, state, n_tips, 2)
    j = _slot(u[:, 0], k.clamp_min(1))
    return ({**state, "cpp_pos": _put2(state["cpp_pos"], v, j, u[:, 1])},
            torch.where(k > 0, 0.0, NEG_INF))


def move_cpp_multiplier(gen, state, tuning, n_tips):
    """Multiplier move on one event's rate multiplier (reference
    Move_CPPRateMultiplierMult, src/proposal.c:1159)."""
    u, v, k = _cpp_branch(gen, state, n_tips, 2)
    j = _slot(u[:, 0], k.clamp_min(1))
    f = torch.exp(tuning * (u[:, 1] - 0.5))
    new = _take2(state["cpp_mult"], v, j) * f
    ok = (k > 0) & (new > 1e-4) & (new < 1e4)
    return ({**state, "cpp_mult": _put2(state["cpp_mult"], v, j, new)},
            torch.where(ok, torch.log(f), NEG_INF))


def move_rcl_jump(gen, state, tuning, n_tips):
    """IGR<->ILN model jump of clockvarpr=mixed (reference
    Move_RelaxedClockModel, src/proposal.c:6189 with variance ratio 1:
    matched parameters, same dimension, Jacobian 1; the engine's prior
    recompute supplies the density ratio)."""
    return ({**state, "rcl_model": 1 - state["rcl_model"]},
            torch.zeros_like(tuning))


# ---------------------------------------------------------------------------
# tree priors on node ages


def ln_uniform_clock(age, n_tips: int, treeage_lpdf) -> torch.Tensor:
    """Uniform node-age prior conditioned on the tree age (reference
    src/mcmc.c:9494: (n-1)log2 - log n! - log(n-1) - (n-2)log t1)."""
    t1 = age[:, 2 * n_tips - 2].clamp_min(1e-20)
    n = float(n_tips)
    lp = ((n - 1.0) * math.log(2.0) - math.lgamma(n + 1.0)
          - math.log(n - 1.0) - (n - 2.0) * torch.log(t1))
    return lp + treeage_lpdf(t1)


def _ln_p0(t, b, d):
    e = torch.exp((d - b) * t)
    return torch.log(d * (1.0 - e) / (b - d * e))


def _ln_p1(t, b, d):
    return (2.0 * torch.log(b - d) - (b - d) * t
            - 2.0 * torch.log(b - d * torch.exp((d - b) * t)))


def _ln_p1_sub(t, b, d, f):
    p1 = (b - d) / (f * b + (b * (1.0 - f) - d) * torch.exp((d - b) * t))
    return 2.0 * torch.log(p1) + math.log(f) - (b - d) * t


def _bd_rates(net_div, turnover):
    eR = turnover.clamp(1e-6, 1.0 - 1e-6)
    lam = net_div / (1.0 - eR)
    return lam, eR * lam


def ln_birthdeath(age, n_tips: int, net_div, turnover, samp_frac: float,
                  treeage_lpdf) -> torch.Tensor:
    """Conditioned birth-death with rho-sampling, strategy 'random'
    (reference src/mcmc.c:8417 LnBirthDeathPriorPrRandom).  net_div and
    turnover are [C]."""
    root = 2 * n_tips - 2
    lam, mu = _bd_rates(net_div, turnover)
    n = float(n_tips)
    m = float(round(n_tips / samp_frac))
    t1 = age[:, root].clamp_min(1e-20)
    internal_ages = age[:, n_tips:root]
    ln_p0_t1 = _ln_p0(t1, lam, mu)
    lp = math.log(m - 1.0) - math.log(n - 1.0) \
        + (m - 2.0) * (ln_p0_t1 + torch.log(lam) - torch.log(mu))
    lp = lp + 2.0 * (_ln_p1(t1, lam, mu)
                     - torch.log(1.0 - torch.exp(ln_p0_t1)))
    sF = samp_frac
    e1 = torch.exp((mu - lam) * t1)
    lp = lp + (n - 2.0) * (torch.log(lam * sF + (lam - lam * sF - mu) * e1)
                           - torch.log(sF * (1.0 - e1)))
    lp = lp + _ln_p1_sub(internal_ages, lam[:, None], mu[:, None],
                         sF).sum(1)
    return lp + treeage_lpdf(t1)


def ln_birthdeath_strat(age, n_tips: int, net_div, turnover,
                        samp_frac: float, treeage_lpdf,
                        strategy: str = "random") -> torch.Tensor:
    """Birth-death prior under the reference's sampling strategies
    (LnBirthDeathPriorPr dispatch, src/mcmc.c:8357): 'random', 'diversity'
    (Eq. A1, :8484) and 'cluster' (Eq. A2, :8556)."""
    if strategy == "random":
        return ln_birthdeath(age, n_tips, net_div, turnover, samp_frac,
                             treeage_lpdf)
    if strategy not in ("diversity", "cluster"):
        raise ValueError(f"unknown BD sampling strategy {strategy}")
    root = 2 * n_tips - 2
    lam, mu = _bd_rates(net_div, turnover)
    n = float(n_tips)
    m = float(round(n_tips / samp_frac))
    t1 = age[:, root].clamp_min(1e-20)
    internal_ages = age[:, n_tips:root]
    ln_p0_t1 = _ln_p0(t1, lam, mu)
    lp = (m - 2.0) * (ln_p0_t1 + torch.log(lam)) + (n - m) * torch.log(mu)
    lp = lp + 2.0 * (_ln_p1(t1, lam, mu)
                     - torch.log(1.0 - torch.exp(ln_p0_t1)))
    if strategy == "diversity":
        nt_min = internal_ages.min(1).values
        lp = lp + (m - n) * (_ln_p0(nt_min, lam, mu) - ln_p0_t1)
    else:
        nt_2 = internal_ages.max(1).values
        lp = lp + (m - n) * torch.log(
            1.0 - torch.exp(_ln_p0(nt_2, lam, mu)) / torch.exp(ln_p0_t1))
    lp = lp + (_ln_p1(internal_ages, lam[:, None], mu[:, None])
               - ln_p0_t1[:, None]).sum(1)
    return lp + treeage_lpdf(t1)


def ln_coalescence(age, n_tips: int, theta, growth=0.0,
                   clockrate=1.0) -> torch.Tensor:
    """Kingman coalescent (+ exponential growth) on coalescence times in
    substitution units (reference src/mcmc.c:9273; theta absorbs the
    mutation rate).  theta is [C]; growth and clockrate [C] or numbers."""
    root = 2 * n_tips - 2
    if torch.is_tensor(clockrate):
        clockrate = clockrate[:, None]
    ct = torch.sort(age[:, n_tips:root + 1] * clockrate, dim=1).values
    ks = torch.arange(n_tips, 1, -1, dtype=age.dtype, device=age.device)
    prev = torch.cat([torch.zeros_like(ct[:, :1]), ct[:, :-1]], 1)
    if not torch.is_tensor(growth):
        growth = torch.full_like(theta, float(growth))
    growth = growth[:, None]
    th = theta[:, None]
    no_growth = (-(ks * (ks - 1.0) * (ct - prev)) / th).sum(1)
    small = growth.abs() < 1e-6
    g = torch.where(small, 1e-6, growth)
    with_growth = (growth * ct + (ks * (ks - 1.0) / (th * g))
                   * (torch.exp(g * prev) - torch.exp(g * ct))).sum(1)
    lp = torch.where(small[:, 0], no_growth, with_growth)
    return (n_tips - 1.0) * torch.log(2.0 / theta) + lp


# ---------------------------------------------------------------------------
# sampled ancestors (ancestral fossils)
#
# A sampled ancestor is a fossil lying ON a lineage: the reference
# represents it as a fossil tip with branch length 0 whose parent is the
# degree-2 sampling vertex (src/proposal.c:1266 Move_AddBranch diagram).
# The flags ``sa [C, n_tips]`` mark ancestral fossils.  A state's
# coordinates are its topology, its flags and its free ages: a pinned
# parent's age is the fossil's, never a coordinate of its own.  So every
# clock move proposes a pinned state (which the engine pins once more,
# ``pin_sa_ages``), leaves the pinned parents out of the ages it picks or
# scales (``_pick_internal``, ``move_tree_stretch``), never moves an
# ancestral fossil off its parent (``_spr_pick_v``, ``_prune_targets``,
# ``_swap_pairs``, ``move_local_clock``) and moves a fossil's date
# together with its pinned parent (``make_tip_date_move``).  The root is
# never a pinned parent: delete-branch refuses it and no move changes an
# ancestral fossil's parent.  CPP events are kept off the zero-length
# branch (add-event refuses it, delete-branch refuses a branch that has
# events).  A per-branch rate on it stays and is moved as on any branch:
# it multiplies a zero length, and under igr, iln and mixed its prior does
# not depend on the length, so only that prior counts.  Under wn and tk02
# the prior depends on the length, so the engine registers no
# add/delete-branch there and no fossil becomes a sampled ancestor
# (``LENGTH_RATE_CLOCKS``).  Without ``sa``
# (clock analyses without the FBD prior, BEST's trees) every function
# computes what it computed before sampled ancestors were accepted.


def _sa_tips(state, n_nodes):
    """Ancestral-fossil flags [C, n_nodes] bool (False past the tips)."""
    sa = state["sa"] > 0
    return torch.cat([sa, sa.new_zeros(sa.shape[0], n_nodes - sa.shape[1])],
                     1)


def _sa_parents(sa, parent, n_tips):
    """[C, n_nodes] bool: the pinned parents (an ancestral fossil's
    parent, the degree-2 sampling vertex) of flags ``sa`` [C, n_tips]."""
    hits = torch.zeros_like(parent).scatter_add(1, parent[:, :n_tips],
                                                (sa > 0).long())
    return hits > 0


def pin_sa_ages(state: dict, n_tips: int) -> dict:
    """``state`` with age[parent[v]] set to age[v] for every
    ancestral-fossil tip v.  A pinned parent has one ancestral fossil
    (its other child is strictly younger), so the scatter writes each
    pinned parent once; the other tips write into a spare column."""
    if "sa" not in state:
        return state
    age = state["age"]
    n = age.shape[1]
    idx = torch.where(state["sa"] > 0, state["parent"][:, :n_tips], n)
    pinned = torch.cat([age, age[:, :1]], 1).scatter(1, idx,
                                                     age[:, :n_tips])
    return {**state, "age": pinned[:, :n]}


def make_add_del_branch(fossil, add: bool):
    """rjMCMC between an ancestral fossil (branch length 0) and a fossil
    tip (branch length > 0): reference Move_AddBranch src/proposal.c:1266
    and Move_DelBranch :1537.  ``fossil`` [n_tips] bool marks the dated
    fossil tips.  Hastings: add = log k - log(m+1) + log(window); delete =
    log m - log(k+1) - log(window); window = grandparent age - fossil age
    (the engine recomputes the prior).  Delete-branch refuses a fossil
    whose parent is the root, whose sibling is not strictly younger, or
    whose branch carries CPP events."""
    def move(gen, state, tuning, n_tips):
        age, parent, left, right = (state["age"], state["parent"],
                                    state["left"], state["right"])
        u = _uniforms(gen, age, 2)
        sa = state["sa"] > 0
        anc, tip = sa & fossil, fossil & ~sa
        k_anc = anc.sum(1).to(age.dtype)
        m_tip = tip.sum(1).to(age.dtype)
        v = _masked_choice(u[:, 0], anc if add else tip)
        q = _take(parent, v)
        g = _take(parent, q)
        lq = _take(left, q)
        r = torch.where(lq == v, _take(right, q), lq)
        root = 2 * n_tips - 2
        hi = torch.where(q == root, 1e6, _take(age, g.clamp_min(0)))
        lo = _take(age, v)
        win = (hi - lo).clamp_min(1e-30)
        if add:
            sa2 = _put(state["sa"], v, torch.zeros_like(v))
            age2 = _put(age, q, lo + u[:, 1] * win)
            ok = (k_anc > 0) & (hi > lo)
            lnH = (torch.log(k_anc.clamp_min(1)) - torch.log(m_tip + 1.0)
                   + torch.log(win))
        else:
            sa2 = _put(state["sa"], v, torch.ones_like(v))
            age2 = _put(age, q, lo)
            # the sibling must be younger than the fossil (the reference
            # aborts, src/proposal.c:1638)
            ok = ((m_tip > 0) & (_take(age, r) < lo) & (hi > lo)
                  & (q != root))
            if "cpp_n" in state:
                # CPP events stay off a zero-length branch
                ok = ok & (_take(state["cpp_n"], v) == 0)
            lnH = (torch.log(m_tip.clamp_min(1)) - torch.log(k_anc + 1.0)
                   - torch.log(win))
        return ({**state, "sa": sa2, "age": age2},
                torch.where(ok, lnH, NEG_INF))

    move.__name__ = "move_add_branch" if add else "move_del_branch"
    return move


# ---------------------------------------------------------------------------
# fossilized birth-death (FBD) priors
#
# The reference's math without rate shifts (one slice): c1/c2/q/p0 closed
# forms src/mcmc.c:8693-8762, the random strategy src/mcmc.c:9013
# LnFossilizedBDPriorRandom, fossiltip :8886, diversity :9155.  Parameter
# map (src/mcmc.c:8820-8827): lambda = sR/(1-eR), mu = lambda eR,
# psi = mu fR/(1-fR), rho = sampleprob.  Rates are [C, 1] and ages
# [C, n] or [C, 1], so every term broadcasts over the chains.


def _fbd_c1c2(lam, mu, psi, rho):
    c1 = torch.sqrt((lam - mu - psi) ** 2 + 4.0 * lam * psi)
    c2 = ((2.0 * rho - 1.0) * lam + mu + psi) / c1
    return c1, c2


def _fbd_ln_q(t, c1, c2):
    """ln q(t): density of an edge from t to the present (reference
    LnQi_fossil with t_sl = 0, src/mcmc.c:8738)."""
    return (math.log(4.0) - c1 * t
            - 2.0 * torch.log(1.0 + c2 + (1.0 - c2) * torch.exp(-c1 * t)))


def _fbd_ln_p0(t, lam, mu, psi, c1, c2):
    """ln p0(t): no sampled descendant (reference LnPi_fossil /
    LnP0_fossil, src/mcmc.c:8693, :8752)."""
    e = torch.exp(-c1 * t)
    frac = (1.0 + c2 - (1.0 - c2) * e) / (1.0 + c2 + (1.0 - c2) * e)
    other = lam + mu + psi - c1 * frac
    return torch.log(other.clamp_min(1e-300)) - torch.log(2.0 * lam)


def _fbd_ln_p1(t, rho, c1, c2):
    """ln p1(t): exactly one sampled extant and no sampled extinct
    descendant (reference LnP1_fossil, src/mcmc.c:8707)."""
    e = torch.exp(-c1 * t)
    other = (2.0 * (1.0 - c2 * c2) * e + (1.0 - c2) ** 2 * e * e
             + (1.0 + c2) ** 2)
    return math.log(4.0) + math.log(rho) - c1 * t - torch.log(other)


def fbd_rates(net_div, turnover, fossil_frac, strategy: str):
    """(lambda, mu, psi) from the sampled (d, r, s) parameters."""
    eR = turnover.clamp(1e-6, 1.0 - 1e-6)
    fR = fossil_frac.clamp(1e-6, 1.0 - 1e-6)
    lam = net_div / (1.0 - eR)
    if strategy == "fossiltip":
        # reference FossilTip: sR = lam-mu-psi, eR = (mu+psi)/lam,
        # fR = psi/(mu+psi)
        return lam, lam * eR * (1.0 - fR), lam * eR * fR
    mu = lam * eR
    return lam, mu, mu * fR / (1.0 - fR)


def _sa_flags(sa, parent, fossil, n_tips):
    """The ancestral fossils [C, n_tips], their parents (degree-2 sampling
    vertices) [C, n_nodes] and their count [C]."""
    sa_t = (sa > 0) & fossil
    return sa_t, _sa_parents(sa_t, parent, n_tips), sa_t.sum(1)


def ln_fbd(age, n_tips: int, net_div, turnover, fossil_frac, rho: float,
           fossil_tip_mask, treeage_lpdf, strategy: str = "random",
           root_dated: bool = False, sa=None, parent=None,
           fossil=None) -> torch.Tensor:
    """Fossilized birth-death tree prior [C], no rate shifts, with sampled
    ancestors (mrbayes_tpu/mcmc/clock.py:478).

    ``fossil_tip_mask``: host bool [n_tips], True where a tip is a dated
    fossil; ``fossil`` its copy on the ages' device (made here when None:
    a caller inside the generation loop passes one, since a copy from the
    host synchronises).  ``rho``: the extant sampling probability
    (random) or the diversity fraction (diversity).  ``sa``/``parent``:
    the ancestral fossil flags and the parents; an ancestral fossil's
    parent is a degree-2 sampling vertex contributing psi instead of
    lambda q, the fossil contributes nothing itself, and ancestral fossils
    drop out of the oriented-to-labeled 2^(M+E-1) factor (reference
    LnFossilizedBDPriorRandom, src/mcmc.c:9060-9130).  The rates are [C].
    """
    host = np.asarray(fossil_tip_mask, bool)
    if fossil is None:
        fossil = torch.as_tensor(host, device=age.device)
    root = 2 * n_tips - 2
    tmrca = age[:, root:root + 1].clamp_min(1e-20)           # [C, 1]
    lam, mu, psi = (x[:, None] for x in fbd_rates(
        net_div, turnover, fossil_frac, strategy))
    m_fossil = int(host.sum())
    n_extant = n_tips - m_fossil
    int_ages = age[:, n_tips:root]
    tip_ages = age[:, :n_tips]
    if sa is not None:
        sa_t, sa_par, n_sa = _sa_flags(sa, parent, fossil, n_tips)
    else:
        sa_t = torch.zeros_like(tip_ages, dtype=torch.bool)
        sa_par = torch.zeros_like(age, dtype=torch.bool)
        n_sa = torch.zeros_like(age[:, 0], dtype=torch.long)
    n_sa = n_sa.to(age.dtype)
    tree_age = 0.0 if root_dated else treeage_lpdf(tmrca[:, 0])

    if strategy == "fossiltip":
        c1, c2 = _fbd_c1c2(lam, mu, psi, rho)
        lp = (torch.log(lam) + _fbd_ln_p1(int_ages, rho, c1, c2)).sum(1)
        lp = lp + torch.where(fossil, torch.log(psi)
                              - _fbd_ln_p1(tip_ages, rho, c1, c2), 0.0).sum(1)
        lp = lp + 2.0 * _fbd_ln_p1(tmrca, rho, c1, c2)[:, 0]
        lp = lp - 2.0 * torch.log1p(-torch.exp(
            _fbd_ln_p0(tmrca, lam, mu, psi, c1, c2)))[:, 0]
        # fossiltip sampling assumes every fossil ends its lineage
        return torch.where(n_sa > 0, NEG_INF, lp + tree_age)

    if strategy == "diversity":
        # Zhang et al. 2016: complete sampling below the cutoff x_cut
        # (0.95 x the youngest internal or fossil age)
        x_cut = 0.95 * torch.minimum(
            int_ages.min(1, keepdim=True).values,
            torch.where(fossil, tip_ages, math.inf).min(1, keepdim=True)
            .values)
        return _ln_fbd_diversity(age, n_tips, lam, mu, psi, rho, fossil,
                                 n_extant, x_cut, sa_t, sa_par,
                                 n_sa) + tree_age

    # strategy == "random"
    c1, c2 = _fbd_c1c2(lam, mu, psi, rho)
    p_t = torch.exp(_fbd_ln_p0(tmrca, lam, mu, psi, c1, c2))
    lp = torch.where(sa_par[:, n_tips:root], torch.log(psi),
                     torch.log(lam) + _fbd_ln_q(int_ages, c1, c2)).sum(1)
    lp = lp + torch.where(sa_par[:, root], torch.log(psi[:, 0]), 0.0)
    lp = lp + torch.where(
        fossil & ~sa_t,
        _fbd_ln_p0(tip_ages, lam, mu, psi, c1, c2)
        - _fbd_ln_q(tip_ages, c1, c2) + torch.log(psi), 0.0).sum(1)
    lp = lp + n_extant * math.log(rho)
    lp = lp + 2.0 * (_fbd_ln_q(tmrca, c1, c2) - torch.log1p(-p_t))[:, 0]
    lp = lp + (n_extant + (m_fossil - n_sa) - 1.0) * math.log(2.0)
    return lp + tree_age


def _ln_fbd_diversity(age, n_tips, lam, mu, psi, rho, fossil, n_extant,
                      x_cut, sa_t, sa_par, n_sa):
    """Two-slice FBD without the tree-age density: the boundary at x_cut
    [C, 1] (psi -> 0 below it, rho_cut = 0 there, complete sampling
    rho = 1 at the present), then the diversified-sampling correction for
    the M_x unsampled extant taxa (reference src/mcmc.c:9155)."""
    root = 2 * n_tips - 2
    tmrca = age[:, root:root + 1].clamp_min(1e-20)
    # slice 0: (x_cut, tmrca], fossil sampling on, rho_0 = 0 at x_cut;
    # slice 1: [0, x_cut), psi = 0, complete extant sampling rho_1 = 1
    c1_0, _ = _fbd_c1c2(lam, mu, psi, 0.0)
    c1_1, c2_1 = _fbd_c1c2(lam, mu, 0.0, 1.0)
    # slice 0's c2 uses p of slice 1 at the boundary (reference c2[i] =
    # ((1 - 2(1 - rho_i) p_{i+1}(t_i)) lam + mu + psi) / c1)
    p1_at_cut = torch.exp(_fbd_ln_p0(x_cut, lam, mu, 0.0, c1_1, c2_1))
    c2_0 = ((1.0 - 2.0 * p1_at_cut) * lam + mu + psi) / c1_0

    def ln_q(t):
        """q piecewise: slice 1 within [0, x_cut), slice 0 above."""
        below = _fbd_ln_q(t, c1_1, c2_1)
        above = _fbd_ln_q(t - x_cut, c1_0, c2_0)
        return torch.where(t < x_cut, below, above)

    def ln_p0(t):
        return _fbd_ln_p0(t - x_cut, lam, mu, psi, c1_0, c2_0)

    int_ages = age[:, n_tips:root]
    tip_ages = age[:, :n_tips]
    p_t = torch.exp(ln_p0(tmrca))
    lp = torch.where(sa_par[:, n_tips:root], torch.log(psi),
                     torch.log(lam) + ln_q(int_ages)).sum(1)
    lp = lp + torch.where(sa_par[:, root], torch.log(psi[:, 0]), 0.0)
    # the fossil tips all lie above x_cut by construction
    lp = lp + torch.where(fossil & ~sa_t, ln_p0(tip_ages) - ln_q(tip_ages)
                          + torch.log(psi), 0.0).sum(1)
    # every extant lineage crosses x_cut once, and nothing else does
    lp = lp + n_extant * _fbd_ln_q(x_cut, c1_1, c2_1)[:, 0]
    lp = lp + 2.0 * (ln_q(tmrca) - torch.log1p(-p_t))[:, 0]
    lp = lp + (n_tips - n_sa - 1.0) * math.log(2.0)
    # diversified-sampling correction for the unsampled extant taxa
    m_x = round(n_extant / rho) - n_extant
    d = lam - mu
    e = torch.exp(-d * x_cut)
    corr = torch.where(
        d.abs() * x_cut > 1e-6,
        torch.log(lam * (1.0 - e)) - torch.log(
            (lam - mu * e).clamp_min(1e-300)),
        torch.log(lam / (mu + 1.0 / x_cut.clamp_min(1e-20))))
    return lp + m_x * corr[:, 0]


# ---------------------------------------------------------------------------
# the uniform clock prior with dated tips


def ln_uniform_clock_dated(age, n_tips: int, fossil_tip_mask,
                           treeage_lpdf, root_dated: bool) -> torch.Tensor:
    """Uniform node-age prior with dated tips [C] (reference
    LnUniformPriorPr, src/mcmc.c:9460, single-subtree case: dated tips,
    no dated interior node; interior calibrations add their densities
    separately).  The sorted tip depths (extant tips dated at 0) and the
    root bound intervals in which each interior depth is uniform, with the
    reference's sorting and coalescent-history corrections."""
    root = 2 * n_tips - 2
    t0 = age[:, root].clamp_min(1e-20)
    m = int(np.asarray(fossil_tip_mask, bool).sum())
    lp = 0.0 if root_dated else treeage_lpdf(t0)
    n = float(n_tips)
    if m == 0:
        return lp + ((n - 1.0) * math.log(2.0) - math.lgamma(n + 1.0)
                     - math.log(n - 1.0) - (n - 2.0) * torch.log(t0))
    nt = n_tips
    dev = age.device
    depths = torch.sort(age[:, :n_tips], dim=1).values
    bounds = torch.cat([depths, t0[:, None]], 1)
    int_ages = age[:, n_tips:root]
    # nLineages[k] = (k + 1) - #interior nodes younger than bounds[k + 1]
    below = (int_ages[:, None, :] < bounds[:, 1:, None]).sum(-1)
    n_lin = torch.arange(1, nt + 1, device=dev) - below          # [C, nt]
    # the uniform node depths: skip the first and last dated tip (the
    # reference loops j = 1..nDatedTips-2 over every sorted dated depth,
    # extant zeros included, src/mcmc.c:9536-9538)
    j = torch.arange(1, nt - 1, device=dev)
    lp = lp - torch.log((t0[:, None] - depths[:, j]).clamp_min(1e-30)).sum(1)
    # sorting corrections
    n_in = n_lin[:, j - 1] + 1
    n_out = torch.where(j == nt - 2, 2, n_lin[:, j])
    use = (n_in > 1) & (n_in - n_out >= 1)
    lg = torch.lgamma
    lp = lp + torch.where(use, lg(n_in.to(age.dtype))
                          - lg(n_out.to(age.dtype)), 0.0).sum(1)
    # coalescent-history counts
    j2 = torch.arange(1, nt, device=dev)
    n_in2 = (n_lin[:, j2 - 1] + 1).to(age.dtype)
    n_out2 = n_lin[:, j2].to(age.dtype)
    return lp + torch.where(
        n_in2 != n_out2,
        math.log(2.0) * (n_in2 - n_out2) + lg(n_out2 + 1.0)
        + lg(n_out2.clamp_min(1.0)) - lg(n_in2 + 1.0)
        - lg(n_in2.clamp_min(1.0)), 0.0).sum(1)


# ---------------------------------------------------------------------------
# relaxed-clock branch-rate priors


def ln_branch_rates_prior(state, n_tips: int, clockvar: str,
                          var) -> torch.Tensor:
    """Sum of the per-branch rate log-priors [C]; ``var`` [C] is the
    model's variance parameter.  Branch set: every node but the root."""
    if clockvar not in BRATE_CLOCKS:
        return state["age"].new_zeros(state["age"].shape[0])
    root = 2 * n_tips - 2
    rates = state["brate"]
    r = rates.clamp_min(1e-30)
    lr = torch.log(r)
    v = var[:, None]

    def igr():
        a = 1.0 / v
        return a * torch.log(a) - torch.lgamma(a) + (a - 1.0) * lr - a * r

    def iln():
        # lognormal with mean 1 and variance var (natural scale)
        s2 = torch.log1p(v)
        return (-lr - 0.5 * torch.log(2 * math.pi * s2)
                - (lr + 0.5 * s2) ** 2 / (2.0 * s2))

    if clockvar == "mixed":
        # the IGR<->ILN indicator picks the density (reference LogPrior
        # mixed branch, src/mcmc.c:8287-8321; RCL_IGR 0, RCL_ILN 1)
        lp = torch.where(state["rcl_model"][:, :1] == 0, igr(), iln())
    elif clockvar == "igr":
        lp = igr()
    elif clockvar == "iln":
        lp = iln()
    else:
        # time x clockrate lengths
        blen = clock_blens(state, n_tips, "strict")
        if clockvar == "wn":
            a = blen.clamp_min(1e-10) / v
            lp = a * torch.log(a) - torch.lgamma(a) + (a - 1.0) * lr - a * r
        else:
            # tk02: the rate at a node is LogNormal(mean = its parent's
            # rate, log-variance = var * branch length)
            pr = torch.where(state["parent"] >= 0,
                             rates.gather(1, state["parent"].clamp_min(0)),
                             1.0).clamp_min(1e-30)
            s2 = (v * blen.clamp_min(1e-10)).clamp_min(1e-12)
            mu = torch.log(pr) - 0.5 * s2
            lp = (-lr - 0.5 * torch.log(2 * math.pi * s2)
                  - (lr - mu) ** 2 / (2.0 * s2))
    return torch.where(_node_ids(state) != root, lp, 0.0).sum(1)


def ages_ordered(state) -> torch.Tensor:
    """[C] bool: every parent older than its children (with the JAX
    package's 1e-12 slack).  With ``sa`` (of a pinned state), an
    ancestral fossil may have its parent's age exactly, and its sibling
    must be strictly younger than that pinned parent; every other pair is
    tested as without ``sa``.  (The JAX package admits no equality, so in
    float32, where age - 1e-12 rounds to age, it rejects every sampled
    ancestor.)"""
    age, parent = state["age"], state["parent"]
    par_age = age.gather(1, parent.clamp_min(0))
    ok = par_age > age - 1e-12
    if "sa" in state:
        fossil = _sa_tips(state, age.shape[1])
        below_pin = _sa_parents(state["sa"], parent, state["sa"].shape[1]
                                ).gather(1, parent.clamp_min(0)) & ~fossil
        ok = ((ok | (fossil & (par_age == age)))
              & ~(below_pin & ~(par_age > age)))
    return torch.where(parent >= 0, ok, True).all(1)


# ---------------------------------------------------------------------------
# clock moves


def _internal_nonroot(state, n_tips):
    idx = _node_ids(state)
    mask = (idx >= n_tips) & (idx != 2 * n_tips - 2)
    return mask.expand_as(state["parent"])


def _pick_internal(state, n_tips, u):
    """A uniform internal non-root node v [C] by ``u`` [C], and ok [C]
    (None without ``sa``).  With ``sa`` the pinned parents are left out;
    a chain with no other internal node picks among all of them and gets
    ok False.  The moves that pick this way keep every pinned parent, so
    the count of candidates is the same in both directions."""
    mask = _internal_nonroot(state, n_tips)
    if "sa" not in state:
        return _masked_choice(u, mask), None
    free = mask & ~_sa_parents(state["sa"], state["parent"], n_tips)
    ok = free.any(1)
    return _masked_choice(u, torch.where(ok[:, None], free, mask)), ok


def _refused(lnH, ok):
    """``lnH`` where ok [C] (None: everywhere), -inf elsewhere."""
    return lnH if ok is None else torch.where(ok, lnH, NEG_INF)


def _child_age_max(state, v):
    age = state["age"]
    return torch.maximum(_take(age, _take(state["left"], v)),
                         _take(age, _take(state["right"], v)))


def move_age_slider(gen, state, tuning, n_tips):
    """Uniform slide of one internal (non-root) node age within (max child
    age, parent age).  Hastings 0."""
    age = state["age"]
    u = _uniforms(gen, age, 2)
    v, ok = _pick_internal(state, n_tips, u[:, 0])
    lo = _child_age_max(state, v)
    hi = _take(age, _take(state["parent"], v))
    new = lo + (hi - lo) * u[:, 1]
    return ({**state, "age": _put(age, v, new)},
            _refused(torch.zeros_like(tuning), ok))


def move_local_clock(gen, state, tuning, n_tips):
    """LOCAL for clock trees (role of Move_LocalClock, src/proposal.c:6630,
    Larget & Simon 1999): pick an internal node u with parent v; among the
    three subtrees {u's two children, u's sibling} choose uniformly which
    one becomes v's direct child, hang the other two under u, and redraw
    u's age uniformly in (max child age, age[v]).  Hastings = log(W_fwd /
    W_bwd) for the two uniform age windows.  With ``sa``, u is no pinned
    parent, and where v is one, its ancestral fossil c must go outside."""
    parent, left, right = state["parent"], state["left"], state["right"]
    age = state["age"]
    r = _uniforms(gen, age, 3)
    u, ok = _pick_internal(state, n_tips, r[:, 0])
    v = _take(parent, u)
    a, b = _take(left, u), _take(right, u)
    lv = _take(left, v)
    c = torch.where(lv == u, _take(right, v), lv)
    # which of {a, b, c} goes outside (under v)?
    pick = (r[:, 1] * 3).long().clamp_max(2)
    out_n = torch.where(pick == 0, a, torch.where(pick == 1, b, c))
    in1 = torch.where(pick == 0, b, a)
    in2 = torch.where(pick == 2, b, c)
    age_v = _take(age, v)
    lo_old = torch.maximum(_take(age, a), _take(age, b))
    lo_new = torch.maximum(_take(age, in1), _take(age, in2))
    W_f = (age_v - lo_new).clamp_min(1e-12)
    W_b = (age_v - lo_old).clamp_min(1e-12)
    new_age = lo_new + W_f * r[:, 2]
    st = dict(state)
    st["left"] = _put(_put(left, u, in1), v, u)
    st["right"] = _put(_put(right, u, in2), v, out_n)
    st["parent"] = _put(_put(_put(parent, in1, u), in2, u), out_n, v)
    st["age"] = _put(age, u, new_age)
    if ok is not None:
        # an ancestral fossil c (v pinned) stays v's child
        fossil = _sa_tips(state, age.shape[1])
        ok = ok & ~(_take(fossil, c) & (pick != 2))
    return st, _refused(torch.log(W_f) - torch.log(W_b), ok)


def move_node_slider_clock(gen, state, tuning, n_tips):
    """Windowed node-age slide with reflection (reference
    Move_NodeSliderClock, src/proposal.c:8570): new = old + window(u-1/2),
    folded into (max child age, parent age); symmetric (Hastings 0).  The
    window is the tuned parameter."""
    age = state["age"]
    u = _uniforms(gen, age, 2)
    v, ok = _pick_internal(state, n_tips, u[:, 0])
    lo = _child_age_max(state, v)
    hi = _take(age, _take(state["parent"], v))
    width = (hi - lo).clamp_min(1e-12)
    new = _take(age, v) + tuning * (u[:, 1] - 0.5)
    # fold into (lo, hi) by repeated reflection (period 2 * width)
    x = torch.remainder(new - lo, 2.0 * width)
    new = lo + torch.where(x > width, 2.0 * width - x, x)
    return ({**state, "age": _put(age, v, new)},
            _refused(torch.zeros_like(tuning), ok))


def move_tree_stretch(gen, state, tuning, n_tips):
    """Multiply every internal age by exp(lambda(u-1/2)); Hastings =
    n_internal * log m (reference Move_TreeStretch src/proposal.c:17250).
    With ``sa`` the pinned parents keep their ages and drop out of the
    count: n_internal - n_pinned scaled ages."""
    age = state["age"]
    m = torch.exp(tuning * (_uniforms(gen, age, 1)[:, 0] - 0.5))
    mask = _node_ids(state) >= n_tips
    if "sa" not in state:
        new = torch.where(mask, age * m[:, None], age)
        return {**state, "age": new}, (n_tips - 1) * torch.log(m)
    pinned = _sa_parents(state["sa"], state["parent"], n_tips)
    new = torch.where(mask & ~pinned, age * m[:, None], age)
    scaled = (n_tips - 1 - pinned.sum(1)).to(m.dtype)
    return {**state, "age": new}, scaled * torch.log(m)


def move_root_age(gen, state, tuning, n_tips):
    """Multiplier on the root age alone, the other ages fixed."""
    root = 2 * n_tips - 2
    age = state["age"]
    m = torch.exp(tuning * (_uniforms(gen, age, 1)[:, 0] - 0.5))
    new = age[:, root] * m
    lo = torch.maximum(age.gather(1, state["left"][:, root:root + 1])[:, 0],
                       age.gather(1, state["right"][:, root:root + 1])[:, 0])
    new_age = torch.cat([age[:, :root], new[:, None]], 1)
    return ({**state, "age": new_age},
            torch.where(new > lo, torch.log(m), NEG_INF))


def _swap_pairs(parent, age, n_tips, fossil=None):
    """[C, n, n] bool, upper triangle: node pairs (a, b) that are not
    ancestor-related, neither the root, each one's parent older than the
    other node (a valid clock subtree swap), and neither an ancestral
    fossil (``fossil`` [C, n] bool, where given)."""
    n = parent.shape[1]
    root = 2 * n_tips - 2
    D = descendant_matrix(parent)
    rel = D | D.transpose(1, 2)                  # includes a == b
    pa = age.gather(1, parent.clamp_min(0))
    notroot = torch.arange(n, device=parent.device) != root
    ok = ((~rel) & notroot[:, None] & notroot[None, :]
          & (pa[:, :, None] > age[:, None, :] + 1e-12)
          & (pa[:, None, :] > age[:, :, None] + 1e-12))
    if fossil is not None:
        ok = ok & ~fossil[:, :, None] & ~fossil[:, None, :]
    return torch.triu(ok, 1)


def move_subtree_swap_clock(gen, state, tuning, n_tips):
    """Clock subtree swap (role of Move_ExtSSClock, src/proposal.c:4621):
    exchange the subtrees of two nodes a, b that are not ancestor-related
    and whose receiving parents are older than the arriving subtree roots.
    The pair is uniform among valid pairs, whose count changes with the
    topology, so lnH = log(n_valid_before) - log(n_valid_after).  An
    ancestral fossil is in no pair (its pinned parent moves with it)."""
    parent, age = state["parent"], state["age"]
    C, n = parent.shape
    u = _uniforms(gen, age, 1)[:, 0]
    fossil = _sa_tips(state, n) if "sa" in state else None
    ok_f = _swap_pairs(parent, age, n_tips, fossil).reshape(C, n * n)
    n_f = ok_f.sum(1)
    pick = _masked_choice(u, ok_f)
    a, b = pick // n, pick % n
    pa_, pb_ = _take(parent, a), _take(parent, b)
    st = _replace_child(state, pa_, a, b)
    st = _replace_child(st, pb_, b, a)
    n_b = _swap_pairs(st["parent"], age, n_tips, fossil).reshape(
        C, n * n).sum(1)
    lnH = (torch.log(n_f.clamp_min(1).float())
           - torch.log(n_b.clamp_min(1).float()))
    return st, torch.where(n_f > 0, lnH, NEG_INF)


def move_nni_clock(gen, state, tuning, n_tips):
    """Rooted NNI: swap a child of v with v's sibling; valid only if the
    sibling is younger than v (reference Move_NNIClock
    src/proposal.c:8127).  With ``sa``, v is no pinned parent; an
    ancestral-fossil sibling is never younger than v."""
    parent, left, right = state["parent"], state["left"], state["right"]
    age = state["age"]
    r = _uniforms(gen, age, 2)
    v, pick_ok = _pick_internal(state, n_tips, r[:, 0])
    u = _take(parent, v)
    lu = _take(left, u)
    s = torch.where(lu == v, _take(right, u), lu)
    c = torch.where(r[:, 1] < 0.5, _take(left, v), _take(right, v))
    ok = _take(age, v) > _take(age, s)
    if pick_ok is not None:
        ok = ok & pick_ok
    st = _replace_child(state, v, c, s)
    st = _replace_child(st, u, s, c)
    return st, torch.where(ok, 0.0, NEG_INF)


def _prune_targets(state, n_tips, v, p, s, sub):
    """Regraft targets w for the pruned node p carrying v: not the root,
    not in v's subtree, not p, not s, and whose parent is older than both
    w and v; with ``sa``, not an ancestral fossil (which stays on its
    pinned parent)."""
    parent, age = state["parent"], state["age"]
    idx = _node_ids(state)
    par_age = torch.where(parent >= 0, age.gather(1, parent.clamp_min(0)),
                          -1.0)
    win_lo = torch.maximum(age, _take(age, v)[:, None])
    mask = ((~sub) & (idx != 2 * n_tips - 2) & (idx != p[:, None])
            & (idx != s[:, None]) & (parent >= 0) & (par_age > win_lo))
    if "sa" in state:
        mask = mask & ~_sa_tips(state, parent.shape[1])
    return mask


def _spr_pick_v(state, n_tips, u):
    """The pruned node v (its parent p is not the root), p, g = parent of
    p, v's sibling s, v's subtree mask and ok [C] (None without ``sa``).
    With ``sa``, p is no pinned parent: neither an ancestral fossil nor
    its sibling is pruned, and a chain with no other candidate gets ok
    False.  The count of candidates is the same in both directions."""
    root = 2 * n_tips - 2
    parent, left, right = state["parent"], state["left"], state["right"]
    idx = _node_ids(state)
    vmask = (idx != root) & (parent != root) & (parent >= 0)
    ok = None
    if "sa" in state:
        free = vmask & ~_sa_parents(state["sa"], parent, n_tips).gather(
            1, parent.clamp_min(0))
        ok = free.any(1)
        vmask = torch.where(ok[:, None], free, vmask)
    v = _masked_choice(u, vmask)
    p = _take(parent, v)
    g = _take(parent, p)
    lp = _take(left, p)
    s = torch.where(lp == v, _take(right, p), lp)
    return v, p, g, s, subtree_mask(parent, v), ok


def _regraft_clock(st, state, n_tips, v, p, g, s, w, u_age):
    """Hang p (carrying v) on the edge above w at a uniform age in
    (max(age w, age v), age of w's parent); st is the detached state.
    Returns the new state, the forward and backward age windows and the
    reverse move's target mask."""
    age = state["age"]
    gw = _take(state["parent"], w)
    lo = torch.maximum(_take(age, w), _take(age, v))
    hi = _take(age, gw)
    st = _replace_child(st, gw, w, p)
    st = _replace_child(st, p, s, w)
    st = {**st, "age": _put(st["age"], p, lo + (hi - lo) * u_age)}
    w_fwd = hi - lo
    w_bwd = _take(age, g) - torch.maximum(_take(age, s), _take(age, v))
    rev = _prune_targets(st, n_tips, v, p, w,
                         subtree_mask(st["parent"], v))
    return st, w_fwd, w_bwd, rev


def _unless(ok, new, state):
    """``new`` where ok [C], else ``state``: a chain whose proposal has no
    valid target keeps a well-formed tree (its surgery on a placeholder
    target could make a cycle), and the NEG_INF ratio rejects it."""
    return {k: torch.where(ok.reshape(-1, *[1] * (v.ndim - 1)), v, state[k])
            if v is not state[k] else v for k, v in new.items()}


def move_spr_clock(gen, state, tuning, n_tips):
    """Subtree prune-and-regraft keeping node ages: the pruned parent node
    p reattaches on a target edge at a uniform age within the valid
    window; Hastings counts targets and window lengths (role of reference
    Move_ExtSPRClock src/proposal.c:3014)."""
    r = _uniforms(gen, state["age"], 3)
    v, p, g, s, sub, pick_ok = _spr_pick_v(state, n_tips, r[:, 0])
    wmask = _prune_targets(state, n_tips, v, p, s, sub)
    if pick_ok is not None:
        wmask = wmask & pick_ok[:, None]
    n_fwd = wmask.sum(1)
    w = _masked_choice(r[:, 1], wmask)
    st = _replace_child(state, g, p, s)
    st, w_fwd, w_bwd, rev = _regraft_clock(st, state, n_tips, v, p, g, s,
                                           w, r[:, 2])
    n_bwd = rev.sum(1)
    ok = (n_fwd > 0) & (w_fwd > 0) & (w_bwd > 0)
    lnH = (torch.log(n_fwd.clamp_min(1).float())
           - torch.log(n_bwd.clamp_min(1).float())
           + torch.log(w_fwd.clamp_min(1e-30))
           - torch.log(w_bwd.clamp_min(1e-30)))
    return _unless(n_fwd > 0, st, state), torch.where(ok, lnH, NEG_INF)


def make_pars_spr_clock_move(pars_masks, pars_factors):
    """Parsimony-biased SPR for clock trees (reference Move_ParsSPRClock,
    src/proposal.c:11896): the age-window surgery of ``move_spr_clock``,
    with the regraft edge drawn from a softmax over the Fitch parsimony
    scores of the detached tree (``moves._fitch``, the scoring of
    ``make_pars_spr_move``) under the clock validity mask.  The detached
    tree is the same in both directions, so one Fitch pass scores both
    softmaxes."""
    def move(gen, state, tuning, n_tips):
        parent = state["parent"]
        n = parent.shape[1]
        r = _uniforms(gen, state["age"], 2 + n)
        rows = torch.arange(parent.shape[0], device=parent.device)
        v, p, g, s, sub, pick_ok = _spr_pick_v(state, n_tips, r[:, 0])
        wmask = _prune_targets(state, n_tips, v, p, s, sub)
        if pick_ok is not None:
            wmask = wmask & pick_ok[:, None]
        st = _replace_child(state, g, p, s)
        F = _fitch(pars_masks, st["parent"], st["left"], st["right"],
                   n_tips)
        d = _pars_scores(F, F[rows, v], st["parent"], n_tips, pars_factors,
                         tuning)
        w, valid, lnq_fwd = _pars_pick(r[:, 2:], wmask, d, s)
        st, w_fwd, w_bwd, rev = _regraft_clock(st, state, n_tips, v, p, g,
                                               s, w, r[:, 1])
        rev_logits = torch.where(rev, -d, NEG_INF)
        lnq_rev = _take(rev_logits, s) - torch.logsumexp(rev_logits, 1)
        ok = valid & (w_fwd > 0) & (w_bwd > 0)
        lnH = (lnq_rev - lnq_fwd + torch.log(w_fwd.clamp_min(1e-30))
               - torch.log(w_bwd.clamp_min(1e-30)))
        return _unless(valid, st, state), torch.where(ok, lnH, NEG_INF)

    move.__name__ = "move_pars_spr_clock"
    return move


def make_brate_multiplier(n_tips: int):
    """Multiplier on one branch rate (any node but the root)."""
    root = 2 * n_tips - 2

    def move(gen, state, tuning, n_tips=n_tips):
        brate = state["brate"]
        u = _uniforms(gen, brate, 2)
        v = _masked_choice(u[:, 0],
                           (_node_ids(state) != root).expand_as(brate))
        m = torch.exp(tuning * (u[:, 1] - 0.5))
        new = _take(brate, v) * m
        ok = (new > 1e-6) & (new < 1e4)
        return ({**state, "brate": _put(brate, v, new)},
                torch.where(ok, torch.log(m), NEG_INF))

    move.__name__ = "move_brate_multiplier"
    return move


def make_tip_date_move(tips, los, his):
    """Uniform slide of one calibrated tip's age within its calibration
    bounds intersected with (0, parent age) (role of reference
    Move_NodeSliderClock on dated tips, src/proposal.c:8570).  ``tips``
    [T] long, ``los``/``his`` [T] float on the engine's device.  The window
    depends only on unchanged quantities, so the proposal is symmetric.
    An ancestral fossil moves with its pinned parent q, within its bounds
    intersected with (age of its sibling, age of q's parent)."""
    def move(gen, state, tuning, n_tips):
        age = state["age"]
        u = _uniforms(gen, age, 2)
        i = (u[:, 0] * tips.shape[0]).long().clamp_max(tips.shape[0] - 1)
        v = tips[i]
        q = _take(state["parent"], v)
        hi = torch.minimum(his[i], _take(age, q))
        lo = los[i]
        if "sa" not in state:
            return ({**state, "age": _put(age, v, lo + (hi - lo) * u[:, 1])},
                    torch.where(hi > lo, 0.0, NEG_INF))
        anc = _take(state["sa"], v) > 0
        lq = _take(state["left"], q)
        r = torch.where(lq == v, _take(state["right"], q), lq)
        g = _take(state["parent"], q).clamp_min(0)
        hi = torch.where(anc, torch.minimum(his[i], _take(age, g)), hi)
        lo = torch.where(anc, torch.maximum(lo, _take(age, r)), lo)
        new = lo + (hi - lo) * u[:, 1]
        age2 = _put(age, v, new)
        age2 = torch.where(anc[:, None], _put(age2, q, new), age2)
        return ({**state, "age": age2}, torch.where(hi > lo, 0.0, NEG_INF))

    move.__name__ = "move_tip_date"
    return move
