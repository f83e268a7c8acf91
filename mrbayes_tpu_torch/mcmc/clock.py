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

Not here (item 10b): CPP and mixed branch rates, the fossilized
birth-death prior with sampled ancestors, dated tips, calibrations and
constraints.
"""
from __future__ import annotations

import math

import torch

from ..ops.traversal import descendant_matrix, subtree_mask
from .moves import (NEG_INF, _fitch, _masked_choice, _node_ids, _pars_pick,
                    _pars_scores, _put, _replace_child, _take, _uniforms)

RELAXED = ("igr", "iln", "wn", "tk02")


# ---------------------------------------------------------------------------
# derived branch lengths


def _parent_values(x, parent, root):
    """x[c, parent[c, v]] [C, n_nodes], the root's own value at the root."""
    return torch.where(parent >= 0, x.gather(1, parent.clamp_min(0)),
                       x[:, root:root + 1])


def clock_blens(state: dict, n_tips: int, clockvar: str) -> torch.Tensor:
    """Substitution-unit branch lengths [C, n_nodes] from ages and rates."""
    if "sa" in state:
        raise NotImplementedError(
            "sampled ancestors are not ported to mrbayes_tpu_torch yet "
            "(ROADMAP Queue 1 item 10b)")
    age, parent = state["age"], state["parent"]
    root = 2 * n_tips - 2
    dt = (_parent_values(age, parent, root) - age).clamp_min(0.0)
    if "clockrate" in state:
        dt = dt * state["clockrate"][:, :1]
    if clockvar == "tk02":
        br = state["brate"]
        dt = dt * (0.5 * (br + _parent_values(br, parent, root)))
    elif clockvar in ("igr", "iln", "wn"):
        dt = dt * state["brate"]
    elif clockvar != "strict":
        raise NotImplementedError(
            f"clockvarpr={clockvar} is not ported to mrbayes_tpu_torch yet "
            f"(ROADMAP Queue 1 item 10b)")
    return torch.where(_node_ids(state) == root, 0.0, dt)


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
# relaxed-clock branch-rate priors


def ln_branch_rates_prior(state, n_tips: int, clockvar: str,
                          var) -> torch.Tensor:
    """Sum of the per-branch rate log-priors [C]; ``var`` [C] is the
    model's variance parameter.  Branch set: every node but the root."""
    if clockvar not in RELAXED:
        return state["age"].new_zeros(state["age"].shape[0])
    root = 2 * n_tips - 2
    rates = state["brate"]
    r = rates.clamp_min(1e-30)
    lr = torch.log(r)
    v = var[:, None]
    if clockvar == "igr":
        a = 1.0 / v
        lp = a * torch.log(a) - torch.lgamma(a) + (a - 1.0) * lr - a * r
    elif clockvar == "iln":
        # lognormal with mean 1 and variance var (natural scale)
        s2 = torch.log1p(v)
        lp = (-lr - 0.5 * torch.log(2 * math.pi * s2)
              - (lr + 0.5 * s2) ** 2 / (2.0 * s2))
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
    package's 1e-12 slack)."""
    age, parent = state["age"], state["parent"]
    par_age = age.gather(1, parent.clamp_min(0))
    return torch.where(parent >= 0, par_age > age - 1e-12, True).all(1)


# ---------------------------------------------------------------------------
# clock moves


def _internal_nonroot(state, n_tips):
    idx = _node_ids(state)
    mask = (idx >= n_tips) & (idx != 2 * n_tips - 2)
    return mask.expand_as(state["parent"])


def _child_age_max(state, v):
    age = state["age"]
    return torch.maximum(_take(age, _take(state["left"], v)),
                         _take(age, _take(state["right"], v)))


def move_age_slider(gen, state, tuning, n_tips):
    """Uniform slide of one internal (non-root) node age within (max child
    age, parent age).  Hastings 0."""
    age = state["age"]
    u = _uniforms(gen, age, 2)
    v = _masked_choice(u[:, 0], _internal_nonroot(state, n_tips))
    lo = _child_age_max(state, v)
    hi = _take(age, _take(state["parent"], v))
    new = lo + (hi - lo) * u[:, 1]
    return {**state, "age": _put(age, v, new)}, torch.zeros_like(tuning)


def move_local_clock(gen, state, tuning, n_tips):
    """LOCAL for clock trees (role of Move_LocalClock, src/proposal.c:6630,
    Larget & Simon 1999): pick an internal node u with parent v; among the
    three subtrees {u's two children, u's sibling} choose uniformly which
    one becomes v's direct child, hang the other two under u, and redraw
    u's age uniformly in (max child age, age[v]).  Hastings = log(W_fwd /
    W_bwd) for the two uniform age windows."""
    parent, left, right = state["parent"], state["left"], state["right"]
    age = state["age"]
    r = _uniforms(gen, age, 3)
    u = _masked_choice(r[:, 0], _internal_nonroot(state, n_tips))
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
    return st, torch.log(W_f) - torch.log(W_b)


def move_node_slider_clock(gen, state, tuning, n_tips):
    """Windowed node-age slide with reflection (reference
    Move_NodeSliderClock, src/proposal.c:8570): new = old + window(u-1/2),
    folded into (max child age, parent age); symmetric (Hastings 0).  The
    window is the tuned parameter."""
    age = state["age"]
    u = _uniforms(gen, age, 2)
    v = _masked_choice(u[:, 0], _internal_nonroot(state, n_tips))
    lo = _child_age_max(state, v)
    hi = _take(age, _take(state["parent"], v))
    width = (hi - lo).clamp_min(1e-12)
    new = _take(age, v) + tuning * (u[:, 1] - 0.5)
    # fold into (lo, hi) by repeated reflection (period 2 * width)
    x = torch.remainder(new - lo, 2.0 * width)
    new = lo + torch.where(x > width, 2.0 * width - x, x)
    return {**state, "age": _put(age, v, new)}, torch.zeros_like(tuning)


def move_tree_stretch(gen, state, tuning, n_tips):
    """Multiply every internal age by exp(lambda(u-1/2)); Hastings =
    n_internal * log m (reference Move_TreeStretch src/proposal.c:17250)."""
    age = state["age"]
    m = torch.exp(tuning * (_uniforms(gen, age, 1)[:, 0] - 0.5))
    mask = _node_ids(state) >= n_tips
    new = torch.where(mask, age * m[:, None], age)
    return {**state, "age": new}, (n_tips - 1) * torch.log(m)


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


def _swap_pairs(parent, age, n_tips):
    """[C, n, n] bool, upper triangle: node pairs (a, b) that are not
    ancestor-related, neither the root, each one's parent older than the
    other node (a valid clock subtree swap)."""
    n = parent.shape[1]
    root = 2 * n_tips - 2
    D = descendant_matrix(parent)
    rel = D | D.transpose(1, 2)                  # includes a == b
    pa = age.gather(1, parent.clamp_min(0))
    notroot = torch.arange(n, device=parent.device) != root
    ok = ((~rel) & notroot[:, None] & notroot[None, :]
          & (pa[:, :, None] > age[:, None, :] + 1e-12)
          & (pa[:, None, :] > age[:, :, None] + 1e-12))
    return torch.triu(ok, 1)


def move_subtree_swap_clock(gen, state, tuning, n_tips):
    """Clock subtree swap (role of Move_ExtSSClock, src/proposal.c:4621):
    exchange the subtrees of two nodes a, b that are not ancestor-related
    and whose receiving parents are older than the arriving subtree roots.
    The pair is uniform among valid pairs, whose count changes with the
    topology, so lnH = log(n_valid_before) - log(n_valid_after)."""
    parent, age = state["parent"], state["age"]
    C, n = parent.shape
    u = _uniforms(gen, age, 1)[:, 0]
    ok_f = _swap_pairs(parent, age, n_tips).reshape(C, n * n)
    n_f = ok_f.sum(1)
    pick = _masked_choice(u, ok_f)
    a, b = pick // n, pick % n
    pa_, pb_ = _take(parent, a), _take(parent, b)
    st = _replace_child(state, pa_, a, b)
    st = _replace_child(st, pb_, b, a)
    n_b = _swap_pairs(st["parent"], age, n_tips).reshape(C, n * n).sum(1)
    lnH = (torch.log(n_f.clamp_min(1).float())
           - torch.log(n_b.clamp_min(1).float()))
    return st, torch.where(n_f > 0, lnH, NEG_INF)


def move_nni_clock(gen, state, tuning, n_tips):
    """Rooted NNI: swap a child of v with v's sibling; valid only if the
    sibling is younger than v (reference Move_NNIClock
    src/proposal.c:8127)."""
    parent, left, right = state["parent"], state["left"], state["right"]
    age = state["age"]
    r = _uniforms(gen, age, 2)
    v = _masked_choice(r[:, 0], _internal_nonroot(state, n_tips))
    u = _take(parent, v)
    lu = _take(left, u)
    s = torch.where(lu == v, _take(right, u), lu)
    c = torch.where(r[:, 1] < 0.5, _take(left, v), _take(right, v))
    ok = _take(age, v) > _take(age, s)
    st = _replace_child(state, v, c, s)
    st = _replace_child(st, u, s, c)
    return st, torch.where(ok, 0.0, NEG_INF)


def _prune_targets(state, n_tips, v, p, s, sub):
    """Regraft targets w for the pruned node p carrying v: not the root,
    not in v's subtree, not p, not s, and whose parent is older than both
    w and v."""
    parent, age = state["parent"], state["age"]
    idx = _node_ids(state)
    par_age = torch.where(parent >= 0, age.gather(1, parent.clamp_min(0)),
                          -1.0)
    win_lo = torch.maximum(age, _take(age, v)[:, None])
    return ((~sub) & (idx != 2 * n_tips - 2) & (idx != p[:, None])
            & (idx != s[:, None]) & (parent >= 0) & (par_age > win_lo))


def _spr_pick_v(state, n_tips, u):
    """The pruned node v (its parent p is not the root), p, g = parent of
    p, v's sibling s and v's subtree mask."""
    root = 2 * n_tips - 2
    parent, left, right = state["parent"], state["left"], state["right"]
    idx = _node_ids(state)
    vmask = (idx != root) & (parent != root) & (parent >= 0)
    v = _masked_choice(u, vmask)
    p = _take(parent, v)
    g = _take(parent, p)
    lp = _take(left, p)
    s = torch.where(lp == v, _take(right, p), lp)
    return v, p, g, s, subtree_mask(parent, v)


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
    v, p, g, s, sub = _spr_pick_v(state, n_tips, r[:, 0])
    wmask = _prune_targets(state, n_tips, v, p, s, sub)
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
        v, p, g, s, sub = _spr_pick_v(state, n_tips, r[:, 0])
        wmask = _prune_targets(state, n_tips, v, p, s, sub)
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
