"""Array-based phylogenetic trees.

A tree over ``n`` tips is a fixed-size node-indexed structure:

* nodes ``0..n-1`` are tips (taxon order of the data set),
* nodes ``n..2n-2`` are internal; the root is always node ``2n-2``.

Arrays (all length ``2n-1``):

* ``parent[i]``  — parent node id (root: ``-1``)
* ``left[i], right[i]`` — child ids (tips: ``-1``)
* ``blen[i]``    — length of the edge above node ``i``

**Unrooted convention** (reversible, non-clock models): the root node's right
child is always tip 0 with ``blen[0] == 0``; ``blen[left-child-of-root]``
carries the edge adjacent to tip 0.  This yields exactly the ``2n-3`` free
branch lengths of the unrooted tree while keeping a strictly binary rooted
array layout, so the same pruning kernel serves rooted (clock) and unrooted
models.  (The reference stores unrooted trees rooted at a tip instead —
src/bayes.h:594-621, src/utils.c — pointer-based; this dense layout keeps
every chain's tree a fixed-shape tensor row.)

Everything here is host-side numpy; the batched tensor topology utilities
live in ``mrbayes_tpu_torch.ops.traversal``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Tree:
    parent: np.ndarray  # int32 [2n-1]
    left: np.ndarray    # int32 [2n-1]
    right: np.ndarray   # int32 [2n-1]
    blen: np.ndarray    # float64 [2n-1]
    n_tips: int
    rooted: bool = False

    @property
    def n_nodes(self) -> int:
        return 2 * self.n_tips - 1

    @property
    def root(self) -> int:
        return 2 * self.n_tips - 2

    def copy(self) -> "Tree":
        return Tree(self.parent.copy(), self.left.copy(), self.right.copy(),
                    self.blen.copy(), self.n_tips, self.rooted)

    def postorder(self) -> np.ndarray:
        """Internal nodes in child-before-parent order (root last)."""
        order, stack, visited = [], [self.root], set()
        while stack:
            v = stack[-1]
            kids = [k for k in (self.left[v], self.right[v]) if k >= 0]
            ready = all(k in visited or k < self.n_tips for k in kids)
            if ready:
                stack.pop()
                if v >= self.n_tips:
                    order.append(v)
                visited.add(v)
            else:
                stack.extend(k for k in kids
                             if k >= self.n_tips and k not in visited)
        return np.array(order, dtype=np.int32)

    def check(self) -> None:
        """Structural invariants (analog of reference IsTreeConsistent,
        src/utils.c:4778)."""
        n = self.n_tips
        assert self.parent[self.root] == -1
        for i in range(self.n_nodes):
            for c in (self.left[i], self.right[i]):
                if c >= 0:
                    assert self.parent[c] == i, f"parent link broken at {c}"
            if i < n:
                assert self.left[i] == -1 and self.right[i] == -1
        if not self.rooted:
            assert self.right[self.root] == 0, "unrooted: root right != tip 0"
            assert self.blen[0] == 0.0
        assert len(self.postorder()) == n - 1, "tree not fully connected"


# ---------------------------------------------------------------------------
# Newick parsing

def _parse_newick_tokens(s: str):
    """Parse newick into nested (children, label, blen) tuples."""
    pos = [0]

    def parse_clade():
        children = []
        label, blen = "", None
        if s[pos[0]] == "(":
            pos[0] += 1
            while True:
                children.append(parse_clade())
                if s[pos[0]] == ",":
                    pos[0] += 1
                    continue
                if s[pos[0]] == ")":
                    pos[0] += 1
                    break
        j = pos[0]
        while j < len(s) and s[j] not in ",():;":
            j += 1
        label = s[pos[0]:j]
        pos[0] = j
        if j < len(s) and s[j] == ":":
            k = j + 1
            while k < len(s) and s[k] not in ",();":
                k += 1
            blen = float(s[j + 1:k])
            pos[0] = k
        return (children, label, blen)

    return parse_clade()


def parse_newick(newick: str, taxa: list[str], rooted: bool = False) -> Tree:
    """Build a Tree from a newick string whose labels are taxon names or
    1-based numbers. Unrooted inputs (basal bifurcation or trifurcation) are
    re-rooted at tip 0 per the unrooted convention."""
    s = newick.strip().rstrip(";").replace(" ", "")
    node = _parse_newick_tokens(s)
    n = len(taxa)
    name_to_id = {t: i for i, t in enumerate(taxa)}
    for i, t in enumerate(taxa):
        name_to_id.setdefault(str(i + 1), i)

    # collect undirected adjacency with edge lengths
    adj: dict[int, list[tuple[int, float]]] = {}
    next_internal = [n]

    def add_edge(a, b, w):
        adj.setdefault(a, []).append((b, w))
        adj.setdefault(b, []).append((a, w))

    def build(nd) -> int:
        children, label, blen = nd
        if not children:
            if label not in name_to_id:
                raise ValueError(f"unknown taxon {label!r}")
            return name_to_id[label]
        my = next_internal[0]
        next_internal[0] += 1
        for ch in children:
            cid = build(ch)
            add_edge(my, cid, ch[2] if ch[2] is not None else 0.0)
        return my

    top_children, _, _ = node
    if rooted:
        return _build_rooted(node, taxa)
    top_id = build(node)
    # If the file root is a bifurcation, merge its two edges (it is a fake
    # root on an unrooted edge); a trifurcation is a real internal node.
    if len(adj[top_id]) == 2:
        (a, wa), (b, wb) = adj[top_id]
        adj[a] = [(x, w) for x, w in adj[a] if x != top_id] + [(b, wa + wb)]
        adj[b] = [(x, w) for x, w in adj[b] if x != top_id] + [(a, wa + wb)]
        del adj[top_id]

    # Re-root at tip 0: DFS away from tip 0, relabel internal nodes densely.
    t = Tree(parent=np.full(2 * n - 1, -1, np.int32),
             left=np.full(2 * n - 1, -1, np.int32),
             right=np.full(2 * n - 1, -1, np.int32),
             blen=np.zeros(2 * n - 1), n_tips=n, rooted=False)
    new_id = {}
    counter = [n]

    def relabel(old: int) -> int:
        if old < n:
            return old
        if old not in new_id:
            new_id[old] = counter[0]
            counter[0] += 1
        return new_id[old]

    root = t.root
    (basal_old, w0) = adj[0][0]
    basal = relabel(basal_old)
    t.left[root], t.right[root] = basal, 0
    t.parent[basal] = root
    t.parent[0] = root
    t.blen[basal] = w0
    stack = [(basal_old, 0)]  # (old id, old parent id)
    while stack:
        old, old_par = stack.pop()
        me = relabel(old)
        kids = [(x, w) for x, w in adj[old] if x != old_par]
        assert len(kids) == 2, f"non-binary node degree {len(kids)+1}"
        (l_old, wl), (r_old, wr) = kids
        l, r = relabel(l_old), relabel(r_old)
        t.left[me], t.right[me] = l, r
        t.parent[l] = t.parent[r] = me
        t.blen[l], t.blen[r] = wl, wr
        for k_old, _ in kids:
            if k_old >= n:
                stack.append((k_old, old))
    t.check()
    return t


def _build_rooted(node, taxa: list[str]) -> Tree:
    n = len(taxa)
    name_to_id = {t: i for i, t in enumerate(taxa)}
    for i, tx in enumerate(taxa):
        name_to_id.setdefault(str(i + 1), i)
    t = Tree(parent=np.full(2 * n - 1, -1, np.int32),
             left=np.full(2 * n - 1, -1, np.int32),
             right=np.full(2 * n - 1, -1, np.int32),
             blen=np.zeros(2 * n - 1), n_tips=n, rooted=True)
    counter = [n]

    def build(nd, want_root=False) -> int:
        children, label, blen = nd
        if not children:
            return name_to_id[label]
        if len(children) != 2:
            raise ValueError("rooted trees must be binary")
        if want_root:
            my = t.root
        else:
            my = counter[0]
            counter[0] += 1
            if my == t.root:  # reserve root id
                my = counter[0]
                counter[0] += 1
        l = build(children[0])
        r = build(children[1])
        t.left[my], t.right[my] = l, r
        t.parent[l] = t.parent[r] = my
        t.blen[l] = children[0][2] or 0.0
        t.blen[r] = children[1][2] or 0.0
        return my

    build(node, want_root=True)
    t.check()
    return t


def to_newick(t: Tree, taxa: list[str] | None = None, digits: int = 8,
              numbers: bool = False) -> str:
    """Serialize. Unrooted trees are written with a basal trifurcation
    (tip 0 first), matching the reference's .t-file layout."""
    def label(i: int) -> str:
        if numbers or taxa is None:
            return str(i + 1)
        return taxa[i]

    def rec(i: int) -> str:
        if i < t.n_tips:
            return f"{label(i)}:{t.blen[i]:.{digits}g}"
        return (f"({rec(t.left[i])},{rec(t.right[i])})"
                f":{t.blen[i]:.{digits}g}")

    if t.rooted:
        return (f"({rec(t.left[t.root])},{rec(t.right[t.root])});")
    basal = t.left[t.root]
    bl, br = t.left[basal], t.right[basal]
    tip0 = f"{label(0)}:{t.blen[basal]:.{digits}g}"
    return f"({tip0},{rec(bl)},{rec(br)});"


def random_unrooted(n_tips: int, rng: np.random.Generator,
                    mean_blen: float = 0.1) -> Tree:
    """Random topology by sequential addition; exp(mean_blen) branch
    lengths (reference: src/utils.c:2560 GetRandomEmbeddedSubtree area)."""
    n = n_tips
    t = Tree(parent=np.full(2 * n - 1, -1, np.int32),
             left=np.full(2 * n - 1, -1, np.int32),
             right=np.full(2 * n - 1, -1, np.int32),
             blen=rng.exponential(mean_blen, 2 * n - 1), n_tips=n,
             rooted=False)
    root = t.root
    # start: root -> (basal=(1,2) joined at node n, tip0)
    t.blen[0] = 0.0
    basal = n
    t.left[root], t.right[root] = basal, 0
    t.parent[basal], t.parent[0] = root, root
    t.left[basal], t.right[basal] = 1, 2
    t.parent[1] = t.parent[2] = basal
    edges = [1, 2, basal]  # nodes whose parent-edge can be split
    next_int = n + 1
    for tip in range(3, n):
        e = int(rng.integers(len(edges)))
        child = edges[e]
        par = t.parent[child]
        mid = next_int
        next_int += 1
        # split edge (par -> child) with new node mid; attach tip
        if t.left[par] == child:
            t.left[par] = mid
        else:
            t.right[par] = mid
        t.parent[mid] = par
        t.left[mid], t.right[mid] = child, tip
        t.parent[child] = mid
        t.parent[tip] = mid
        t.blen[mid] = rng.exponential(mean_blen)
        edges.extend([tip, mid])
    t.check()
    return t


def _constrained_grouping(n_tips: int, rng: np.random.Generator,
                          masks: list[np.ndarray]) -> tuple:
    """Random nested grouping of taxa where every mask forms a clade
    (role of the reference's constraint-tree starting topologies,
    src/model.c:12753 FillTreeParams).  Returns nested (l, r) tuples
    with ints at the leaves.  Raises on incompatible constraints."""
    comps: list[tuple[object, frozenset]] = [
        (i, frozenset([i])) for i in range(n_tips)]

    def merge(indices: list[int]) -> None:
        while len(indices) > 1:
            i, j = rng.choice(len(indices), 2, replace=False)
            a, b = indices[i], indices[j]
            comps[a] = ((comps[a][0], comps[b][0]),
                        comps[a][1] | comps[b][1])
            comps[b] = None
            indices.remove(b)
        pass

    for mask in sorted(masks, key=lambda m: int(m.sum())):
        tipset = frozenset(np.flatnonzero(mask).tolist())
        if len(tipset) < 2 or len(tipset) >= n_tips:
            continue
        inside = [k for k, c in enumerate(comps)
                  if c is not None and c[1] <= tipset]
        covered = frozenset().union(
            *[comps[k][1] for k in inside]) if inside else frozenset()
        if covered != tipset:
            raise ValueError(
                "incompatible constraints: clade "
                f"{sorted(tipset)} conflicts with an earlier constraint")
        merge(inside)
    rest = [k for k, c in enumerate(comps) if c is not None]
    merge(rest)
    (top, _), = [c for c in comps if c is not None]
    return top


def random_unrooted_constrained(n_tips: int, rng: np.random.Generator,
                                masks: list[np.ndarray],
                                mean_blen: float = 0.1) -> Tree:
    """Random unrooted topology in which every mask is a clade."""
    top = _constrained_grouping(n_tips, rng, masks)

    def nw(node) -> str:
        if isinstance(node, tuple):
            return (f"({nw(node[0])},{nw(node[1])})"
                    f":{rng.exponential(mean_blen):.8g}")
        return f"{node + 1}:{rng.exponential(mean_blen):.8g}"

    taxa = [str(i + 1) for i in range(n_tips)]
    return parse_newick(nw(top) + ";", taxa)


def random_clock_tree_constrained(n_tips: int, rng: np.random.Generator,
                                  masks: list[np.ndarray],
                                  mean_age: float = 1.0,
                                  tip_ages: np.ndarray | None = None):
    """Random rooted clock tree where every mask is a clade: constrained
    grouping for the topology, then bottom-up exponential age increments
    (parents strictly older than children, dated tips respected)."""
    n = n_tips
    top = _constrained_grouping(n, rng, masks)
    if tip_ages is None:
        tip_ages = np.zeros(n)
    t = Tree(parent=np.full(2 * n - 1, -1, np.int32),
             left=np.full(2 * n - 1, -1, np.int32),
             right=np.full(2 * n - 1, -1, np.int32),
             blen=np.zeros(2 * n - 1), n_tips=n, rooted=True)
    ages = np.zeros(2 * n - 1)
    ages[:n] = tip_ages
    counter = [n]
    step = max(mean_age, 2.0 * float(np.max(tip_ages))) / max(n - 1, 1)

    def build(node, is_top=False) -> int:
        if not isinstance(node, tuple):
            return node
        l = build(node[0])
        r = build(node[1])
        me = t.root if is_top else counter[0]
        if not is_top:
            counter[0] += 1
        t.left[me], t.right[me] = l, r
        t.parent[l] = t.parent[r] = me
        ages[me] = (max(ages[l], ages[r])
                    + rng.exponential(step) + 1e-4)
        return me

    build(top, is_top=True)
    for v in range(2 * n - 2):
        t.blen[v] = ages[t.parent[v]] - ages[v]
    t.check()
    return t, ages


def random_clock_tree(n_tips: int, rng: np.random.Generator,
                      mean_age: float = 1.0,
                      tip_ages: np.ndarray | None = None):
    """Random rooted topology with coalescent-style node ages.

    Returns (Tree, ages[2n-1]) with tips at ``tip_ages`` (default 0) and
    the root (node 2n-2) oldest.  Branch 'lengths' in the Tree are the age
    differences.  With dated (fossil) tips, a tip only becomes available
    for joining once the clock has passed its age — a serially-sampled
    coalescent (role of the reference's calibrated starting trees,
    src/utils.c:4164 InitCalibratedBrlens).
    """
    n = n_tips
    t = Tree(parent=np.full(2 * n - 1, -1, np.int32),
             left=np.full(2 * n - 1, -1, np.int32),
             right=np.full(2 * n - 1, -1, np.int32),
             blen=np.zeros(2 * n - 1), n_tips=n, rooted=True)
    ages = np.zeros(2 * n - 1)
    if tip_ages is None:
        tip_ages = np.zeros(n)
    ages[:n] = tip_ages
    if mean_age < 2.0 * float(np.max(tip_ages)):
        mean_age = 2.0 * float(np.max(tip_ages)) + 1e-3
    pending = sorted(range(n), key=lambda i: tip_ages[i])
    active: list[int] = []
    age = 0.0
    for i in range(n - 1):
        while pending and (tip_ages[pending[0]] <= age or len(active) < 2):
            nxt = pending.pop(0)
            age = max(age, tip_ages[nxt])
            active.append(nxt)
        k = len(active)
        age += rng.exponential(2.0 * mean_age / (k * (k - 1)))
        while pending and tip_ages[pending[0]] <= age:
            active.append(pending.pop(0))
        a, b = rng.choice(len(active), 2, replace=False)
        node = n + i
        na, nb = active[a], active[b]
        t.left[node], t.right[node] = na, nb
        t.parent[na] = t.parent[nb] = node
        ages[node] = age
        active = [x for j, x in enumerate(active) if j not in (a, b)]
        active.append(node)
    # ensure root is node 2n-2 (it is, by construction order)
    t.blen = ages - np.where(t.parent >= 0, 0, 0)
    for v in range(2 * n - 2):
        t.blen[v] = ages[t.parent[v]] - ages[v]
    t.blen[t.root] = 0.0
    t.check()
    return t, ages


def tree_length(t: Tree) -> float:
    """Sum of free branch lengths (TL statistic)."""
    mask = np.ones(t.n_nodes, bool)
    mask[t.root] = False
    if not t.rooted:
        mask[0] = False
    return float(t.blen[mask].sum())


# ---------------------------------------------------------------------------
# Starting-tree builders (reference `mcmc starttree=`/`nperts=`,
# src/command.c:14520-14521; RandPerturb src/mcmc.c:2569-2576;
# BuildParsTrees stepwise addition src/mcmc.c:6871 area)


def perturb_nni(t: Tree, n: int, rng: np.random.Generator) -> Tree:
    """Apply ``n`` random NNI rearrangements to a non-clock tree (role
    of the reference's RandPerturb on starting trees).  Branch lengths
    are kept; only the topology changes."""
    t = t.copy()
    n_tips = t.n_tips
    for _ in range(n):
        cands = [v for v in range(n_tips, t.root)
                 if t.parent[v] >= 0 and t.parent[v] != t.root]
        if not cands:
            break
        u = int(rng.choice(cands))
        p = t.parent[u]
        s = t.left[p] if t.right[p] == u else t.right[p]
        c = t.left[u] if rng.random() < 0.5 else t.right[u]
        if t.left[p] == s:
            t.left[p] = c
        else:
            t.right[p] = c
        if t.left[u] == c:
            t.left[u] = s
        else:
            t.right[u] = s
        t.parent[c] = p
        t.parent[s] = u
    t.check()
    return t


def _adjacency_to_tree(adj: dict, elen: dict, ntax: int) -> Tree:
    """Unrooted adjacency (node -> neighbor set, frozenset edge ->
    length) -> Tree in the tip-0-rooted layout, via Newick round trip."""
    def rec(v, p):
        l = max(elen[frozenset((v, p))], 1e-6)
        if v < ntax:
            return f"{v + 1}:{l:.8g}"
        kids = [u for u in adj[v] if u != p]
        return ("(" + ",".join(rec(u, v) for u in kids)
                + f"):{l:.8g}")

    h = next(iter(adj[0]))
    l0 = max(elen[frozenset((0, h))], 1e-6)
    kids = [u for u in adj[h] if u != 0]
    nwk = ("(" + f"1:{l0:.8g}," + ",".join(rec(u, h) for u in kids)
           + ");")
    return parse_newick(nwk, [str(i + 1) for i in range(ntax)])


def neighbor_joining(D: np.ndarray) -> Tree:
    """Neighbor-joining tree from a distance matrix (starttree=nj)."""
    n = D.shape[0]
    assert n >= 4
    size = 2 * n - 2
    M = np.zeros((size, size))
    M[:n, :n] = D
    active = list(range(n))
    nxt = n
    adj: dict = {i: set() for i in range(size)}
    elen: dict = {}

    def join(i, j, li, lj):
        nonlocal nxt
        u = nxt
        nxt += 1
        adj[u].update((i, j))
        adj[i].add(u)
        adj[j].add(u)
        elen[frozenset((i, u))] = max(li, 1e-6)
        elen[frozenset((j, u))] = max(lj, 1e-6)
        return u

    while len(active) > 3:
        r = len(active)
        idx = np.array(active)
        d = M[np.ix_(idx, idx)]
        R = d.sum(axis=1)
        Q = (r - 2) * d - R[:, None] - R[None, :]
        np.fill_diagonal(Q, np.inf)
        a, b = np.unravel_index(np.argmin(Q), Q.shape)
        i, j = int(idx[a]), int(idx[b])
        li = d[a, b] / 2 + (R[a] - R[b]) / (2 * (r - 2))
        lj = d[a, b] - li
        u = join(i, j, li, lj)
        for k in active:
            if k in (i, j):
                continue
            M[u, k] = M[k, u] = (M[i, k] + M[j, k] - M[i, j]) / 2
        active = [k for k in active if k not in (i, j)] + [u]

    i, j, k = active
    dij, dik, djk = M[i, j], M[i, k], M[j, k]
    u = join(i, j, (dij + dik - djk) / 2, (dij + djk - dik) / 2)
    adj[u].add(k)
    adj[k].add(u)
    elen[frozenset((k, u))] = max((dik + djk - dij) / 2, 1e-6)
    return _adjacency_to_tree(adj, elen, n)


def parsimony_stepwise(masks: np.ndarray, weights: np.ndarray,
                       rng: np.random.Generator,
                       mean_blen: float = 0.1) -> Tree:
    """Greedy random-addition-order Fitch stepwise-addition tree
    (starttree=parsimony; role of the reference's BuildParsTrees).

    ``masks`` [ntax, npat] uint32 state bitmasks, ``weights`` [npat]
    pattern counts.  Each candidate edge is scored by the standard
    stepwise heuristic: attaching taxon x on edge e costs one step for
    every pattern whose state set is disjoint from the union of the
    Fitch sets on e's two sides."""
    ntax, npat = masks.shape
    w = np.asarray(weights, np.float64)
    order = [int(x) for x in rng.permutation(ntax)]
    a, b, c = order[:3]
    hub = ntax
    nxt = ntax + 1
    adj: dict = {x: {hub} for x in (a, b, c)}
    adj[hub] = {a, b, c}

    def comb(x, y):
        inter = x & y
        return np.where(inter != 0, inter, x | y)

    for x in order[3:]:
        # Fitch downpass sets rooted at tip a, then "other side" sets
        down: dict = {}
        stack = [(next(iter(adj[a])), a, False)]
        while stack:
            v, p, done = stack.pop()
            if v < ntax:
                down[v] = masks[v]
                continue
            if done:
                kids = [u for u in adj[v] if u != p]
                s = down[kids[0]]
                for u in kids[1:]:
                    s = comb(s, down[u])
                down[v] = s
            else:
                stack.append((v, p, True))
                for u in adj[v]:
                    if u != p:
                        stack.append((u, v, False))
        other: dict = {}
        edges = []
        stack = [(u, a) for u in adj[a]]
        other[next(iter(adj[a]))] = masks[a]
        while stack:
            v, p = stack.pop()
            edges.append((p, v))
            if v >= ntax:
                kids = [u for u in adj[v] if u != p]
                for u in kids:
                    sibs = [down[s2] for s2 in kids if s2 != u]
                    o = other[v]
                    for sb in sibs:
                        o = comb(o, sb)
                    other[u] = o
                    stack.append((u, v))
        xm = masks[x]
        costs = []
        for p, v in edges:
            # Fitch state set OF THE EDGE: soft-combine of the two
            # sides (intersection where nonempty, else union) — the
            # plain union under-counts and degenerates to ties
            f = comb(down[v], other[v])
            cost = float(w[(xm & f) == 0].sum())
            costs.append(cost)
        costs = np.asarray(costs)
        cand = np.flatnonzero(costs == costs.min())
        p, v = edges[int(rng.choice(cand))]
        m = nxt
        nxt += 1
        adj[p].remove(v)
        adj[v].remove(p)
        adj[m] = {p, v, x}
        adj[p].add(m)
        adj[v].add(m)
        adj[x] = {m}

    elen = {}
    for v, nbrs in adj.items():
        for u in nbrs:
            e = frozenset((u, v))
            if e not in elen:
                elen[e] = float(rng.exponential(mean_blen))
    return _adjacency_to_tree(adj, elen, ntax)


def pdistance_matrix(masks: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Pairwise mismatch-proportion distances from bit-coded patterns
    (for the NJ starting tree)."""
    ntax = masks.shape[0]
    w = np.asarray(weights, np.float64)
    tot = w.sum()
    D = np.zeros((ntax, ntax))
    for i in range(ntax):
        dis = (masks[i][None, :] & masks[i + 1:, :]) == 0
        D[i, i + 1:] = D[i + 1:, i] = (dis * w[None, :]).sum(1) / tot
    return np.maximum(D, 1e-4) * (1 - np.eye(ntax))
