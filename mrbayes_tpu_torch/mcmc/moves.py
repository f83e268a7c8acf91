"""MCMC proposal moves, batched over chains.

Every move maps ``(gen, state, tuning, n_tips) -> (new_state, ln_hastings)``
where ``state`` is the chain-state dict of ``[C, ...]`` tensors (see
engine.py), ``tuning`` is ``[C]`` and ``gen`` is a ``torch.Generator`` on
the state's device.  All C chains make the same kind of move in one call;
each draws its own random numbers.  Prior ratios are NOT returned: the
engine recomputes the prior component the move can change.

Topology moves are array surgery on the (parent, left, right) node arrays
under the unrooted root-at-tip-0 convention (see trees.py).  Out-of-bounds
proposals return ``ln_hastings = NEG_INF`` so the Metropolis step rejects
(the reference's abortMove pattern, src/mcmc.c:16805).

Nothing here synchronises with the host: random choices are inverse-CDF
or Gumbel-max picks on uniforms drawn up front, and the walks of the
extending moves are fixed-trip loops of ``n_nodes`` iterations that stop
advancing a chain once its walk has ended (a no-backtracking walk on a
tree takes at most ``n_nodes - 1`` steps).

References for behavior: Move_NNI src/proposal.c:8064, Move_ExtSPR
src/proposal.c:2026, Move_ExtTBR :5047, Move_Local :6317, Move_ParsSPR
:10067, Move_TreeLen :17136, Dirichlet moves :390 ff.
"""
from __future__ import annotations

import torch

from ..ops.traversal import descendant_matrix, postorder_internal, \
    subtree_mask
from .priors import dirichlet_lpdf

NEG_INF = -1e30
BRLEN_MIN = 1e-6
BRLEN_MAX = 100.0


# ---------------------------------------------------------------------------
# helpers


def _uniforms(gen, like, k):
    """[C, k] uniforms in [0, 1) on ``like``'s device."""
    return torch.rand((like.shape[0], k), generator=gen, device=like.device)


def _take(x, i):
    """x [C, n], i [C] -> x[c, i[c]]."""
    return x.gather(1, i[:, None])[:, 0]


def _put(x, i, v):
    """Out-of-place x[c, i[c]] = v[c]."""
    return x.scatter(1, i[:, None], v.to(x.dtype)[:, None])


def _masked_choice(u, mask):
    """Uniform choice of an index where mask [C, n] is True, by inverse CDF
    on u [C] (index 0 when a row has no candidate)."""
    count = mask.sum(1)
    k = torch.minimum((u * count).long(), (count - 1).clamp_min(0))
    return (mask.long().cumsum(1) > k[:, None]).long().argmax(1)


def _gumbel_choice(u, logits):
    """Categorical draw per row from logits [C, n] (Gumbel-max on u)."""
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (logits + g).argmax(1)


def _replace_child(state, node, old, new):
    """Replace child ``old`` of ``node`` with ``new``; fix parent links."""
    left, right = state["left"], state["right"]
    ln = _take(left, node)
    is_l = ln == old
    left = _put(left, node, torch.where(is_l, new, ln))
    right = _put(right, node, torch.where(is_l, _take(right, node), new))
    parent = _put(state["parent"], new, node)
    return {**state, "left": left, "right": right, "parent": parent}


def _node_ids(state):
    return torch.arange(state["parent"].shape[1],
                        device=state["parent"].device)


def _free_branch_mask(n_tips, device, rooted=False):
    """Branches with a sampled length: every node except the root and, in
    the unrooted (tip-0-rooted) convention, tip 0 (its pendant edge rides
    on the basal node)."""
    idx = torch.arange(2 * n_tips - 1, device=device)
    mask = idx != 2 * n_tips - 2
    if not rooted:
        mask = mask & (idx != 0)
    return mask


def _regraft(st, p, s, w, u_split):
    """Attach the pruned node p (children: the moving subtree and s) onto
    the edge above w, splitting it at fraction u_split."""
    t_w = _take(st["blen"], w)
    gw = _take(st["parent"], w)
    st = _replace_child(st, gw, w, p)
    st = _replace_child(st, p, s, w)
    blen = _put(_put(st["blen"], p, u_split * t_w), w, (1.0 - u_split) * t_w)
    return {**st, "blen": blen}, t_w


def _detach(state, v):
    """Prune the subtree at v: p = parent(v) leaves the tree and v's
    sibling s hangs under g = parent(p) with the merged edge."""
    parent, left, right, blen = (state["parent"], state["left"],
                                 state["right"], state["blen"])
    p = _take(parent, v)
    g = _take(parent, p)
    lp = _take(left, p)
    s = torch.where(lp == v, _take(right, p), lp)
    merged = _take(blen, s) + _take(blen, p)
    st = _replace_child(state, g, p, s)
    st = {**st, "blen": _put(st["blen"], s, merged)}
    return st, p, s, merged


def _ln_len_ratio(t_new, t_old):
    return torch.log(t_new.clamp_min(1e-35)) - torch.log(t_old.clamp_min(1e-35))


# ---------------------------------------------------------------------------
# topology moves


def move_nni(gen, state, tuning, n_tips):
    """Nearest-neighbor interchange across a random internal edge."""
    root = 2 * n_tips - 2
    parent, left, right = state["parent"], state["left"], state["right"]
    u = _uniforms(gen, parent, 2)
    idx = _node_ids(state)
    # v internal, not root, parent not root => (u,v) is an internal edge
    mask = (idx >= n_tips) & (idx != root) & (parent != root)
    v = _masked_choice(u[:, 0], mask)
    up = _take(parent, v)
    lu = _take(left, up)
    s = torch.where(lu == v, _take(right, up), lu)          # sibling of v
    c = torch.where(u[:, 1] < 0.5, _take(left, v), _take(right, v))
    st = _replace_child(state, v, c, s)
    st = _replace_child(st, up, s, c)
    return st, torch.zeros_like(tuning)


def move_spr(gen, state, tuning, n_tips):
    """Random subtree prune-and-regraft with uniform edge-proportion
    reinsertion.  lnH = log(t_target / (t_sib + t_pruned_parent))."""
    root = 2 * n_tips - 2
    parent, left = state["parent"], state["left"]
    u = _uniforms(gen, parent, 3)
    idx = _node_ids(state)
    basal = left[:, root:root + 1]
    # prune candidates: any node except root, tip0, basal
    vmask = (idx != root) & (idx != 0) & (idx != basal)
    v = _masked_choice(u[:, 0], vmask)
    st, p, s, merged = _detach(state, v)
    # regraft candidates: not in subtree(v), not root, not tip0, not p, not s
    sub = subtree_mask(parent, v)
    wmask = ((~sub) & (idx != root) & (idx != 0) & (idx != p[:, None])
             & (idx != s[:, None]))
    w = _masked_choice(u[:, 1], wmask)
    st, t_w = _regraft(st, p, s, w, u[:, 2])
    lnH = _ln_len_ratio(t_w, merged)
    ok = wmask.any(1) & (w != v)
    return st, torch.where(ok, lnH, NEG_INF)


def _walk_out(L, R, P, n_tips, start, toward0, pext, u_stop, u_dir):
    """The extending-move edge walk (reference Move_ExtSPR, src/proposal.c:
    2026, re-expressed as a no-backtracking edge walk).  Start on the edge
    above ``start`` heading down (toward 0) or up (toward 1); at each step
    stop with probability 1 - pext (or when the far end is a tip, tip 0
    being the far end of an edge under the root), else move to one of the
    two edges beyond, chosen uniformly.  Returns (w, k, stopped_at_tip):
    the edge reached, the steps taken, and whether the walk ended at a
    tip.  u_stop/u_dir are [C, n_nodes] uniforms; one column per step."""
    root = 2 * n_tips - 2
    w = start
    toward = toward0
    k = torch.zeros_like(start)
    done = torch.zeros_like(start, dtype=torch.bool)
    at_tip_end = torch.zeros_like(done)
    for it in range(u_stop.shape[1]):
        pw = _take(P, w)
        at_tip = torch.where(toward == 0, w < n_tips, pw == root)
        pw = pw.clamp_min(0)
        stop = at_tip | (u_stop[:, it] > pext)
        lu = _take(L, pw)
        sib = torch.where(lu == w, _take(R, pw), lu)
        choice = u_dir[:, it] < 0.5
        nw = torch.where(toward == 0,
                         torch.where(choice, _take(L, w), _take(R, w)),
                         torch.where(choice, sib, pw))
        nt = torch.where(toward == 0, 0, torch.where(choice, 0, 1))
        step = ~done & ~stop
        at_tip_end = torch.where(~done & stop, at_tip, at_tip_end)
        w = torch.where(step, nw, w)
        toward = torch.where(step, nt, toward)
        k = k + step.long()
        done = done | stop
    return w, k, at_tip_end


def _tip_far(P, n_tips, w, toward):
    """Whether the far end of the edge above w, walking toward w (0) or
    its parent (1), is a tip (parent == root means tip 0)."""
    return torch.where(toward == 0, w < n_tips,
                       _take(P, w) == 2 * n_tips - 2)


def move_ext_spr(gen, state, tuning, n_tips):
    """Extending SPR (reference Move_ExtSPR, src/proposal.c:2026): prune a
    random subtree, walk outward from the attachment edge for a geometric
    number of steps (continue probability = tuning), regraft at the edge
    reached, splitting it at a uniform point.  The Hastings ratio is the
    endpoint correction — only the stop factors at the two path ends
    differ between the forward and reverse walks — plus the uniform-split
    edge-length ratio (Lakner et al. 2008)."""
    root = 2 * n_tips - 2
    n_nodes = 2 * n_tips - 1
    parent, left = state["parent"], state["left"]
    u = _uniforms(gen, parent, 3 + 2 * n_nodes)
    idx = _node_ids(state)
    basal = left[:, root:root + 1]
    vmask = (idx != root) & (idx != 0) & (idx != basal)
    v = _masked_choice(u[:, 0], vmask)
    st, p, s, merged = _detach(state, v)
    pext = tuning.clamp(0.05, 0.95)
    d0 = (u[:, 1] < 0.5).long()
    w, k, stopped_at_tip = _walk_out(
        st["left"], st["right"], st["parent"], n_tips, s, d0, pext,
        u[:, 3:3 + n_nodes], u[:, 3 + n_nodes:])
    # Hastings: endpoint stop factors (the reverse walk re-enters the
    # start edge heading the opposite direction)
    rev_tip = _tip_far(st["parent"], n_tips, s, 1 - d0)
    ln_stop = torch.log1p(-pext)
    ln_stop_fwd = torch.where(stopped_at_tip, 0.0, ln_stop)
    ln_stop_rev = torch.where(rev_tip, 0.0, ln_stop)
    lnH_walk = torch.where(k > 0, ln_stop_rev - ln_stop_fwd, 0.0)
    st, t_w = _regraft(st, p, s, w, u[:, 2])
    return st, lnH_walk + _ln_len_ratio(t_w, merged)


def move_local(gen, state, tuning, n_tips):
    """LOCAL move of Larget & Simon 1999 (reference Move_Local,
    src/proposal.c:6317): pick an internal edge (v,u); build the
    three-edge backbone a—u—v—c (a drawn from u's other neighbors, c from
    v's children); scale the backbone by exp(lambda(U-1/2)); slide one
    endpoint of v's edge uniformly along the new backbone, changing
    topology when it crosses the other endpoint.  Hastings ratio is
    3·log(m*/m) (src/proposal.c:6477)."""
    root = 2 * n_tips - 2
    parent, left, right, blen = (state["parent"], state["left"],
                                 state["right"], state["blen"])
    r = _uniforms(gen, parent, 6)
    idx = _node_ids(state)
    mask = (idx >= n_tips) & (idx != root) & (parent != root)
    v = _masked_choice(r[:, 0], mask)
    u = _take(parent, v)
    # crown: c the backbone child of v (the other child rides along)
    c = torch.where(r[:, 1] < 0.5, _take(left, v), _take(right, v))
    # root part: up = walk through u's sibling edge; down = through u's
    # parent edge (reference directionUp)
    lu = _take(left, u)
    s = torch.where(lu == v, _take(right, u), lu)
    g = _take(parent, u)
    direction_up = r[:, 2] < 0.5
    a = torch.where(direction_up, s, g)
    x = torch.where(direction_up, _take(blen, a), _take(blen, u))
    y = x + _take(blen, v)
    old_m = y + _take(blen, c)
    new_m = torch.exp(tuning * (r[:, 3] - 0.5)) * old_m
    move_x = r[:, 4] < 0.5
    scale = new_m / old_m
    new_x = torch.where(move_x, r[:, 5] * new_m, x * scale)
    new_y = torch.where(move_x, y * scale, r[:, 5] * new_m)
    topo = new_x > new_y
    lo = torch.minimum(new_x, new_y)
    hi = torch.maximum(new_x, new_y)
    seg = torch.stack([lo, hi - lo, new_m - hi], 1)
    ok = ((seg >= BRLEN_MIN) & (seg <= BRLEN_MAX)).all(1)
    lnH = 3.0 * torch.log(scale)

    # no topology change
    b_no = _put(_put(blen, c, new_m - new_y), v, new_y - new_x)
    b_no = _put(b_no, torch.where(direction_up, a, u), new_x)
    # topology change, up: u's v-slot <- c; v's c-slot <- a; u's a-slot <- v
    st_up = _replace_child(state, u, v, c)
    st_up = _replace_child(st_up, v, c, a)
    st_up = _replace_child(st_up, u, a, v)
    b_up = _put(_put(_put(blen, c, new_m - new_x), v, new_x - new_y),
                a, new_y)
    # down: u's v-slot <- c; v's c-slot <- u; a(=g)'s u-slot <- v
    st_dn = _replace_child(state, u, v, c)
    st_dn = _replace_child(st_dn, v, c, u)
    st_dn = _replace_child(st_dn, a, u, v)
    b_dn = _put(_put(_put(blen, c, new_m - new_x), u, new_x - new_y),
                v, new_y)
    is_up = (topo & direction_up)[:, None]
    is_dn = (topo & ~direction_up)[:, None]
    out = dict(state)
    for f in ("left", "right", "parent"):
        out[f] = torch.where(is_up, st_up[f],
                             torch.where(is_dn, st_dn[f], state[f]))
    out["blen"] = torch.where(is_up, b_up, torch.where(is_dn, b_dn, b_no))
    return out, torch.where(ok, lnH, NEG_INF)


def _reroot_pruned(state, v, c, u_split):
    """Re-root the pruned subtree hanging from v: place the (degree-2)
    junction v on the edge above c, reversing parent links on the c→v
    path and merging v's two old root edges.  Returns the new state and
    log|Jacobian| of the merge+split length change (reference Move_ExtTBR
    crown rearrangement, src/proposal.c:5047)."""
    L0, R0, P0, B0 = (state["left"], state["right"], state["parent"],
                      state["blen"])
    x, y = _take(L0, v), _take(R0, v)
    m1 = _take(B0, x) + _take(B0, y)
    identity = (c == x) | (c == y)
    q = _take(P0, c)
    t_c = _take(B0, c)
    left, right, par, blen = L0, R0, P0, B0
    # walk the path q -> ... -> child-of-v, reversing each edge; chains
    # whose c is a child of v start (and stay) done
    done = identity
    prev, cur = c, q
    for _ in range(P0.shape[1]):
        active = ~done
        nxt = _take(P0, cur).clamp_min(0)
        last = nxt == v
        other = torch.where(x == cur, y, x)
        new_child = torch.where(last, other, nxt)
        lc = _take(left, cur)
        is_l = lc == prev
        left = _put(left, cur, torch.where(active & is_l, new_child, lc))
        rc = _take(right, cur)
        right = _put(right, cur, torch.where(active & ~is_l, new_child, rc))
        par = _put(par, new_child,
                   torch.where(active, cur, _take(par, new_child)))
        blen = _put(blen, new_child,
                    torch.where(active, torch.where(last, m1, _take(B0, cur)),
                                _take(blen, new_child)))
        done = done | last
        prev = torch.where(active, cur, prev)
        cur = torch.where(active, nxt, cur)
    # v's children become (c, q); split the old edge above c
    left = _put(left, v, c)
    right = _put(right, v, q)
    par = _put(_put(par, c, v), q, v)
    blen = _put(_put(blen, c, u_split * t_c), q, (1.0 - u_split) * t_c)
    lnJ = _ln_len_ratio(t_c, m1)
    keep = identity[:, None]
    out = {**state,
           "left": torch.where(keep, L0, left),
           "right": torch.where(keep, R0, right),
           "parent": torch.where(keep, P0, par),
           "blen": torch.where(keep, B0, blen)}
    return out, torch.where(identity, 0.0, lnJ)


def move_ext_tbr(gen, state, tuning, n_tips):
    """Extending TBR (reference Move_ExtTBR, src/proposal.c:5047): bisect
    a random internal edge (v, parent(v)); on the root side, walk outward
    with extension probability ``tuning`` to choose the reattachment edge
    (the ExtSPR walk); on the crown side, walk down from the pruned
    subtree's merged root edge to choose a new root edge and re-root the
    subtree there.  Hastings combines the two walks' endpoint stop
    factors with the two merge/split length Jacobians."""
    root = 2 * n_tips - 2
    n_nodes = 2 * n_tips - 1
    parent, left = state["parent"], state["left"]
    u = _uniforms(gen, parent, 5 + 4 * n_nodes)
    walk1 = u[:, 5:5 + 2 * n_nodes]
    walk2 = u[:, 5 + 2 * n_nodes:]
    idx = _node_ids(state)
    basal = left[:, root:root + 1]
    # internal edge: v internal, not root, not basal (edge to tip 0)
    vmask = (idx >= n_tips) & (idx != root) & (idx != basal)
    v = _masked_choice(u[:, 0], vmask)
    st, p, s, merged = _detach(state, v)
    pext = tuning.clamp(0.05, 0.95)
    ln_stop = torch.log1p(-pext)

    # --- crown side: walk down from the merged root edge of subtree(v)
    Lc, Rc = st["left"], st["right"]
    x, y = _take(Lc, v), _take(Rc, v)
    d0 = torch.where(u[:, 1] < 0.5, x, y)
    c = d0
    k1 = torch.zeros_like(d0)
    done = torch.zeros_like(d0, dtype=torch.bool)
    c_tip = torch.zeros_like(done)
    for it in range(n_nodes):
        is_tip = c < n_tips
        stop = is_tip | (walk1[:, it] > pext)
        nc = torch.where(walk1[:, n_nodes + it] < 0.5, _take(Lc, c),
                         _take(Rc, c)).clamp_min(0)
        step = ~done & ~stop
        c_tip = torch.where(~done & stop, is_tip, c_tip)
        c = torch.where(step, nc, c)
        k1 = k1 + step.long()
        done = done | stop
    # the reverse crown walk ends at the old merged edge; its continuation
    # is blocked only if the old endpoint child is a tip
    o0 = torch.where(d0 == x, y, x)
    ln_stop_f1 = torch.where(c_tip, 0.0, ln_stop)
    ln_stop_r1 = torch.where(o0 < n_tips, 0.0, ln_stop)
    lnH1_walk = torch.where(k1 > 0, ln_stop_r1 - ln_stop_f1, 0.0)
    st, lnH1_len = _reroot_pruned(st, v, c, u[:, 2])

    # --- root side: the ExtSPR walk from s, then reattach p above w
    d2 = (u[:, 3] < 0.5).long()
    w, k2, w_tip = _walk_out(st["left"], st["right"], st["parent"], n_tips,
                             s, d2, pext, walk2[:, :n_nodes],
                             walk2[:, n_nodes:])
    rev2_tip = _tip_far(st["parent"], n_tips, s, 1 - d2)
    ln_stop_f2 = torch.where(w_tip, 0.0, ln_stop)
    ln_stop_r2 = torch.where(rev2_tip, 0.0, ln_stop)
    lnH2_walk = torch.where(k2 > 0, ln_stop_r2 - ln_stop_f2, 0.0)
    st, t_w = _regraft(st, p, s, w, u[:, 4])
    lnH2_len = _ln_len_ratio(t_w, merged)
    return st, lnH1_walk + lnH1_len + lnH2_walk + lnH2_len


def move_subtree_swap(gen, state, tuning, n_tips):
    """Swap two non-nested subtrees (role of reference Move_ExtSS,
    src/proposal.c:4118, with a uniform partner choice and an exact
    count-based Hastings correction: the number of eligible partners
    depends on the topology, so q is asymmetric)."""
    root = 2 * n_tips - 2
    parent, left = state["parent"], state["left"]
    u = _uniforms(gen, parent, 2)
    idx = _node_ids(state)
    rows = torch.arange(parent.shape[0], device=parent.device)
    basal = left[:, root:root + 1]
    base = (idx != root) & (idx != 0) & (idx != basal)
    v = _masked_choice(u[:, 0], base)

    def partner_mask(desc, par, a):
        # non-nested with a, not a's sibling (sibling swap is the
        # identity); one closure matrix serves all four mask queries
        return (base & ~desc[rows, a] & ~desc[rows, :, a]
                & (par != _take(par, a)[:, None]))

    desc = descendant_matrix(parent)
    wm_v = partner_mask(desc, parent, v)
    w = _masked_choice(u[:, 1], wm_v)
    c_v = wm_v.sum(1)
    c_w = partner_mask(desc, parent, w).sum(1)
    pv, pw = _take(parent, v), _take(parent, w)
    st = _replace_child(state, pv, v, w)
    st = _replace_child(st, pw, w, v)
    par2 = st["parent"]
    desc2 = descendant_matrix(par2)
    c2_v = partner_mask(desc2, par2, v).sum(1)
    c2_w = partner_mask(desc2, par2, w).sum(1)

    def inv(cnt):
        return 1.0 / cnt.clamp_min(1).float()

    lnH = torch.log(inv(c2_v) + inv(c2_w)) - torch.log(inv(c_v) + inv(c_w))
    return st, torch.where(c_v > 0, lnH, NEG_INF)


def _fitch(masks, P2, L2, R2, n_tips, count=False):
    """Fitch downpass sets [C, n_nodes, Ptot] on bit-coded state sets
    (reference GetParsDP, src/mcmc.c:4849); with ``count``, also each
    pattern's number of changes [C, Ptot] (the steps that take the union),
    the root's step included (the parsimony model's tree length)."""
    C = P2.shape[0]
    F = masks.new_zeros((C, P2.shape[1], masks.shape[1]))
    F[:, :n_tips] = masks
    order = postorder_internal(P2, n_tips)
    rows = torch.arange(C, device=P2.device)
    changes = torch.zeros(F.shape[::2], device=P2.device) if count else None
    for i in range(n_tips - 1):
        w = order[:, i]
        a = F[rows, _take(L2, w)]
        b = F[rows, _take(R2, w)]
        inter = a & b
        empty = inter == 0
        if count:
            changes += empty
        F[rows, w] = torch.where(empty, a | b, inter)
    return (F, changes) if count else F


def _pars_scores(F, Fv, P2, n_tips, factors, warp):
    """d(w) = warp * Σ_p factor_p [set(w) | set(parent(w)) misses set(v)]
    for every candidate edge w: [C, n_nodes]."""
    root = 2 * n_tips - 2
    par_eff = torch.where(P2 == root, 0, P2.clamp_min(0))
    Fp = F.gather(1, par_eff[:, :, None].expand_as(F))
    y = (F | Fp) & Fv[:, None, :]
    return warp[:, None] * torch.where(y == 0, factors, 0.0).sum(-1)


def _pars_pick(u, mask, d, s):
    """Softmax pick over ``-d`` among ``mask & idx != s``; returns the
    pick (s when no candidate), whether one existed, and its forward log
    probability."""
    idx = torch.arange(mask.shape[1], device=mask.device)
    fwd_mask = mask & (idx != s[:, None])
    valid = fwd_mask.any(1)
    fwd_logits = torch.where(fwd_mask, -d, NEG_INF)
    pick = torch.where(valid, _gumbel_choice(u, fwd_logits), s)
    lnq = _take(fwd_logits, pick) - torch.logsumexp(fwd_logits, 1)
    return pick, valid, lnq


def make_pars_spr_move(pars_masks, pars_factors):
    """Parsimony-biased SPR (reference Move_ParsSPR, src/proposal.c:10067;
    Fitch machinery GetParsDP src/mcmc.c:4849, InitParsSets :6834).

    Prune a random subtree, Fitch-downpass the remaining tree on bit-coded
    state sets, score every candidate regraft edge w by the weighted count
    of patterns where (set(w) | set(parent(w))) has no overlap with the
    pruned subtree's set, then pick the target from a softmax over
    -warp-scaled scores.  The Hastings ratio is the forward/reverse
    softmax probability ratio (the root-part scores are unchanged by the
    reattachment, so the reverse distribution reuses them) plus the
    uniform edge-split factor.

    pars_masks: int64 [n_tips, Ptot] state bitmasks over all divisions'
    patterns; pars_factors: f32 [Ptot] pattern weight x division warp
    factor.  The softmax temperature (warp) is the autotuned ``tuning``.
    """
    def move(gen, state, tuning, n_tips):
        root = 2 * n_tips - 2
        parent, left = state["parent"], state["left"]
        u = _uniforms(gen, parent, 2 + parent.shape[1])
        idx = _node_ids(state)
        rows = torch.arange(parent.shape[0], device=parent.device)
        basal = left[:, root:root + 1]
        vmask = (idx != root) & (idx != 0) & (idx != basal)
        v = _masked_choice(u[:, 0], vmask)
        st, p, s, merged = _detach(state, v)
        P2 = st["parent"]
        # Fitch downpass on the detached tree (p's own set is junk but p
        # is excluded from the candidates)
        F = _fitch(pars_masks, P2, st["left"], st["right"], n_tips)
        d = _pars_scores(F, F[rows, v], P2, n_tips, pars_factors, tuning)
        sub = subtree_mask(P2, v)
        cmask = (~sub) & (idx != root) & (idx != 0) & (idx != p[:, None])
        # no candidate (v's subtree spans all but the sibling): abort —
        # the reference's abortMove guard (src/proposal.c:10160)
        c, valid, lnq_fwd = _pars_pick(u[:, 2:], cmask, d, s)
        rev_logits = torch.where(cmask & (idx != c[:, None]), -d, NEG_INF)
        lnq_rev = _take(rev_logits, s) - torch.logsumexp(rev_logits, 1)
        st, t_c = _regraft(st, p, s, c, u[:, 1])
        lnH = lnq_rev - lnq_fwd + _ln_len_ratio(t_c, merged)
        return st, torch.where(valid, lnH, NEG_INF)

    move.__name__ = "move_pars_spr"
    return move


def make_pars_tbr_move(pars_masks, pars_factors):
    """Parsimony-biased TBR (reference Move_ParsTBR1,
    src/proposal.c:13224): bisect at an internal node v, re-root the
    pruned subtree on a uniformly chosen internal edge (the uniform
    choice cancels in the Hastings ratio — the subtree's edge count is
    re-rooting-invariant), then reattach on the root side via the same
    Fitch-scored softmax as Move_ParsSPR.

    The subtree's Fitch root set depends on its orientation, so the
    forward softmax is scored with the RE-ROOTED subtree set and the
    reverse with the ORIGINAL orientation's set."""
    def move(gen, state, tuning, n_tips):
        root = 2 * n_tips - 2
        parent, left = state["parent"], state["left"]
        u = _uniforms(gen, parent, 4 + parent.shape[1])
        idx = _node_ids(state)
        rows = torch.arange(parent.shape[0], device=parent.device)
        basal = left[:, root:root + 1]
        # v INTERNAL (a tip subtree cannot re-root: that's plain ParsSPR)
        vmask = (idx >= n_tips) & (idx != root) & (idx != basal)
        v = _masked_choice(u[:, 0], vmask)
        st, p, s, merged = _detach(state, v)
        # original-orientation Fitch pass (root-side sets + old F[v])
        F_old = _fitch(pars_masks, st["parent"], st["left"], st["right"],
                       n_tips)
        Fv_old = F_old[rows, v]
        # crown: uniform new root edge among subtree nodes (not v)
        sub = subtree_mask(st["parent"], v)
        c_edge = _masked_choice(u[:, 1], sub & (idx != v[:, None]))
        st, ln_len1 = _reroot_pruned(st, v, c_edge, u[:, 2])
        F_new = _fitch(pars_masks, st["parent"], st["left"], st["right"],
                       n_tips)
        P2 = st["parent"]
        d_fwd = _pars_scores(F_old, F_new[rows, v], P2, n_tips,
                             pars_factors, tuning)
        d_rev = _pars_scores(F_old, Fv_old, P2, n_tips, pars_factors,
                             tuning)
        sub2 = subtree_mask(P2, v)
        cmask = (~sub2) & (idx != root) & (idx != 0) & (idx != p[:, None])
        w, valid, lnq_fwd = _pars_pick(u[:, 4:], cmask, d_fwd, s)
        rev_logits = torch.where(cmask & (idx != w[:, None]), -d_rev,
                                 NEG_INF)
        lnq_rev = _take(rev_logits, s) - torch.logsumexp(rev_logits, 1)
        st, t_w = _regraft(st, p, s, w, u[:, 3])
        lnH = (lnq_rev - lnq_fwd + ln_len1 + _ln_len_ratio(t_w, merged))
        return st, torch.where(valid, lnH, NEG_INF)

    move.__name__ = "move_pars_tbr"
    return move


# ---------------------------------------------------------------------------
# branch-length moves


def move_blen_multiplier(gen, state, tuning, n_tips, rooted=False):
    """Multiply one random free branch by exp(lambda(u-1/2))."""
    blen = state["blen"]
    u = _uniforms(gen, blen, 2)
    mask = _free_branch_mask(n_tips, blen.device, rooted).expand_as(blen)
    v = _masked_choice(u[:, 0], mask)
    m = torch.exp(tuning * (u[:, 1] - 0.5))
    new = _take(blen, v) * m
    ok = (new >= BRLEN_MIN) & (new <= BRLEN_MAX)
    return ({**state, "blen": _put(blen, v, new)},
            torch.where(ok, torch.log(m), NEG_INF))


def move_treelen_multiplier(gen, state, tuning, n_tips, rooted=False):
    """Scale all free branches; lnH = n_free * log m
    (reference Move_TreeLen src/proposal.c:17136)."""
    blen = state["blen"]
    u = _uniforms(gen, blen, 1)
    mask = _free_branch_mask(n_tips, blen.device, rooted)
    m = torch.exp(tuning * (u[:, 0] - 0.5))
    new = torch.where(mask, blen * m[:, None], blen)
    n_free = mask.sum()
    ok = torch.where(mask, (new >= BRLEN_MIN) & (new <= BRLEN_MAX),
                     True).all(1)
    return ({**state, "blen": new},
            torch.where(ok, n_free * torch.log(m), NEG_INF))


def move_node_slider(gen, state, tuning, n_tips, rooted=False):
    """Pick an internal non-root node; redistribute the two incident branch
    lengths (its own and one child's) keeping the sum, by uniform slide."""
    root = 2 * n_tips - 2
    left, right, blen = state["left"], state["right"], state["blen"]
    u = _uniforms(gen, blen, 3)
    idx = _node_ids(state)
    mask = ((idx >= n_tips) & (idx != root)).expand_as(left)
    if not rooted:
        mask = mask & (idx != left[:, root:root + 1])
    v = _masked_choice(u[:, 0], mask)
    c = torch.where(u[:, 1] < 0.5, _take(left, v), _take(right, v))
    total = _take(blen, v) + _take(blen, c)
    new_v = u[:, 2] * total
    new = _put(_put(blen, v, new_v), c, total - new_v)
    ok = (new_v >= BRLEN_MIN) & (total - new_v >= BRLEN_MIN)
    return {**state, "blen": new}, torch.where(ok, 0.0, NEG_INF)


# ---------------------------------------------------------------------------
# rooted non-clock topology moves (directional root frequencies force a
# rooted tree with free branch lengths; reference TOPOLOGY_RNCL_*
# paramIds, src/model.c:20126-20134; mrbayes_tpu/mcmc/moves.py:828-900)


def move_rooted_nni(gen, state, tuning, n_tips):
    """NNI on a rooted tree: swap a random child of a random internal
    non-root node with that node's sibling.  Symmetric (lnH = 0)."""
    root = 2 * n_tips - 2
    parent, left, right = state["parent"], state["left"], state["right"]
    u = _uniforms(gen, parent, 2)
    idx = _node_ids(state)
    mask = ((idx >= n_tips) & (idx != root)).expand_as(parent)
    v = _masked_choice(u[:, 0], mask)
    p = _take(parent, v)
    lp = _take(left, p)
    s = torch.where(lp == v, _take(right, p), lp)
    c = torch.where(u[:, 1] < 0.5, _take(left, v), _take(right, v))
    st = _replace_child(state, v, c, s)
    st = _replace_child(st, p, s, c)
    return st, torch.zeros_like(tuning)


def move_rooted_spr(gen, state, tuning, n_tips):
    """Rooted SPR: prune the parent edge of a random node v whose parent
    is not the root, close the gap, and regraft onto a uniformly chosen
    edge anywhere outside v's subtree, the root's child edges included,
    so the root itself moves.  lnH = ln(k_f / k_r) + ln(t_w / merged):
    the candidate counts before and after (each with its identity
    target) and the uniform-split length densities."""
    root = 2 * n_tips - 2
    parent = state["parent"]
    u = _uniforms(gen, parent, 3)
    idx = _node_ids(state)
    vmask = (idx != root) & (parent != root)
    v = _masked_choice(u[:, 0], vmask)
    rows = torch.arange(parent.shape[0], device=parent.device)

    def targets(par, pp):
        # not the root, not in v's subtree, not v's parent
        return ((idx != root) & ~descendant_matrix(par)[rows, v]
                & (idx != pp[:, None]))

    st, p, s, merged = _detach(state, v)
    wm = targets(parent, p)
    w = _masked_choice(u[:, 1], wm)
    # the sibling's edge now carries the merged length: regrafting onto
    # it splits that edge
    st, t_w = _regraft(st, p, s, w, u[:, 2])
    k_f = wm.sum(1)
    k_r = targets(st["parent"], p).sum(1)
    lnH = (torch.log(k_f.clamp_min(1).float())
           - torch.log(k_r.clamp_min(1).float()) + _ln_len_ratio(t_w, merged))
    ok = vmask.any(1) & wm.any(1) & (w != v)
    return st, torch.where(ok, lnH, NEG_INF)


# ---------------------------------------------------------------------------
# parameter moves (operate on one random row of a grouped parameter)


def _dirichlet_proposal(gen, old, conc):
    """Propose new ~ Dirichlet(conc * old) per chain; old [C, K], conc
    [C].  Returns (new, lnH)."""
    alpha_f = (conc[:, None] * old).clamp_min(1e-4)
    g = torch._standard_gamma(alpha_f, generator=gen) + 1e-10
    new = g / g.sum(-1, keepdim=True)
    alpha_b = (conc[:, None] * new).clamp_min(1e-4)
    lnH = dirichlet_lpdf(old, alpha_b) - dirichlet_lpdf(new, alpha_f)
    return new, lnH


def _row_index(u, n_rows):
    return (u * n_rows).long().clamp_max(n_rows - 1)


def pick_group(gen, like, n_rows, candidates=None):
    """One row per chain, drawn uniformly from ``range(n_rows)`` or from
    ``candidates`` (a long tensor of row ids on ``like``'s device, built
    once with the engine: a tensor made from host data in the loop would
    synchronise)."""
    u = _uniforms(gen, like, 1)[:, 0]
    if candidates is None:
        return _row_index(u, n_rows)
    return candidates[_row_index(u, candidates.shape[0])]


def make_simplex_move(field, groups=None):
    """Dirichlet move on one random group row of state[field] [C, G, K]
    (reference Move_Statefreqs / Move_Revmat_Dir, src/proposal.c); a
    [C, K] field is itself one simplex.  ``groups``, a long tensor of row
    ids, restricts the candidate rows (nst=mixed rows have their own
    moves)."""
    def move(gen, state, tuning, n_tips):
        arr = state[field]
        if arr.ndim == 2:
            new, lnH = _dirichlet_proposal(gen, arr, tuning)
            return {**state, field: new}, lnH
        gi = pick_group(gen, arr, arr.shape[1], groups)
        rows = torch.arange(arr.shape[0], device=arr.device)
        new_row, lnH = _dirichlet_proposal(gen, arr[rows, gi], tuning)
        out = arr.clone()
        out[rows, gi] = new_row
        return {**state, field: out}, lnH
    move.__name__ = f"move_{field}_dirichlet"
    return move


def make_multiplier_move(field, lo, hi):
    """Multiplier move on one random element of a parameter array
    (flattened over the non-chain axes)."""
    def move(gen, state, tuning, n_tips):
        arr = state[field]
        flat = arr.reshape(arr.shape[0], -1)
        u = _uniforms(gen, arr, 2)
        gi = _row_index(u[:, 0], flat.shape[1])
        m = torch.exp(tuning * (u[:, 1] - 0.5))
        new = _take(flat, gi) * m
        ok = (new >= lo) & (new <= hi)
        return ({**state, field: _put(flat, gi, new).reshape(arr.shape)},
                torch.where(ok, torch.log(m), NEG_INF))
    move.__name__ = f"move_{field}_multiplier"
    return move


def make_slider_move(field, lo, hi):
    """Uniform-window slider with reflection at the bounds."""
    def move(gen, state, tuning, n_tips):
        arr = state[field]
        u = _uniforms(gen, arr, 2)
        gi = _row_index(u[:, 0], arr.shape[1])
        new = _take(arr, gi) + (u[:, 1] - 0.5) * tuning
        # reflect into [lo, hi]
        span = hi - lo
        t = torch.remainder(new - lo, 2 * span)
        new = lo + torch.where(t > span, 2 * span - t, t)
        return {**state, field: _put(arr, gi, new)}, torch.zeros_like(tuning)
    move.__name__ = f"move_{field}_slider"
    return move


def make_jump_move(field, n_values):
    """Jump of one random element of an integer indicator array
    state[field] [C, G] to a uniformly drawn OTHER value in
    range(n_values): the proposal is symmetric, so ln_hastings is 0 (the
    aamodelpr=mixed model jump, reference Move_Aamodel,
    src/proposal.c:66)."""
    def move(gen, state, tuning, n_tips):
        arr = state[field]
        u = _uniforms(gen, arr, 2)
        gi = _row_index(u[:, 0], arr.shape[1])
        off = 1 + _row_index(u[:, 1], n_values - 1)
        new = (_take(arr, gi) + off) % n_values
        return {**state, field: _put(arr, gi, new)}, torch.zeros_like(tuning)
    move.__name__ = f"move_{field}_jump"
    return move


def move_m3omega_slider(gen, state, tuning, n_tips):
    """Reflected window slide of one of M3's three ordered omegas of one
    random group between its neighbours (0 below the first, 1e3 above the
    last), the window cut to the gap (reference Move_OmegaM3,
    src/proposal.c:9446; mrbayes_tpu engine.py:1700-1718)."""
    arr = state["m3omega"]                                   # [C, G, 3]
    u = _uniforms(gen, arr, 3)
    rows = torch.arange(arr.shape[0], device=arr.device)
    gi = _row_index(u[:, 0], arr.shape[1])
    which = _row_index(u[:, 1], 3)
    w = arr[rows, gi]                                        # [C, 3]
    lo = torch.where(which == 0, 0.0, _take(w, (which - 1).clamp_min(0)))
    hi = torch.where(which == 2, 1e3, _take(w, (which + 1).clamp_max(2)))
    win = torch.minimum(tuning, hi - lo)
    new = _take(w, which) + win * (u[:, 2] - 0.5)
    span = (hi - lo).clamp_min(1e-30)
    t = torch.remainder(new - lo, 2 * span)
    new = lo + torch.where(t > span, 2 * span - t, t)
    out = arr.index_put((rows, gi), _put(w, which, new))
    return {**state, "m3omega": out}, torch.zeros_like(tuning)
