"""The plain reference: what a chain's state scores, worked out anew.

Plain PyTorch and NumPy, float64 unless told otherwise, with no kernel,
no cache and no batching across chains (one tree at a time, its
divisions padded into one product); it imports nothing of the program.
From the simulated codes it compresses each division's site patterns
itself; from a chain's tree (a parent array and branch lengths) and each
division's Q (worked out anew by the model family's module under
``models/``) it builds the eigensystem, the discrete gamma categories,
the invariant class, the rate multiplier and P(t), runs Felsenstein's
pruning down the tree with per-pattern scaling, reduces at the root, and
sums the MrBayes 3.2 prior (of an unrooted tree's branch lengths, or of
a clock tree's node ages, and the family's parameters by its module).
The arithmetic follows the float64 NumPy oracle of the program's tests
(gamma category means, rates 1 / (1 - pinvar) for the variable class),
written here for any number of states, a parent array and torch.

``Precision("tf32")`` rounds both operands of every matrix product to
TF32 (a 10-bit mantissa, as the tensor cores read float32) before a
float32 product: the control of ``control.py``, the precision a later
change might be tempted to use.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import gammainc, gammaincinv


# ---------------------------------------------------------------- data
def compress(codes: np.ndarray):
    """(patterns [taxa, P], weights [P]) of the columns of ``codes``."""
    pats, counts = np.unique(codes, axis=1, return_counts=True)
    return pats, counts.astype(np.float64)


def divisions(codes: np.ndarray, ranges):
    """One (patterns, weights, sites) per 1-based inclusive site range."""
    out = []
    for lo, hi in ranges:
        pats, w = compress(codes[:, lo - 1:hi])
        out.append((pats, w, hi - lo + 1))
    return out


# ---------------------------------------------------------------- trees
def children(parent: np.ndarray):
    """(root, children lists) of a parent array."""
    kids = [[] for _ in range(parent.shape[0])]
    root = -1
    for v, p in enumerate(parent.tolist()):
        if p < 0:
            root = v
        else:
            kids[p].append(v)
    return root, kids


def postorder(parent: np.ndarray):
    """(root, children, internal nodes children-first)."""
    root, kids = children(parent)
    order, stack = [], [root]
    while stack:
        v = stack.pop()
        if kids[v]:
            order.append(v)
            stack.extend(kids[v])
    return root, kids, order[::-1]


def splits(parent: np.ndarray, blen: np.ndarray, n_tips: int) -> dict:
    """The unrooted tree's edges: {split: length}, a split being the tip
    set (a bitmask) on the side without tip 0.  The two edges at a root of
    degree two are one edge, with their summed length."""
    root, kids, order = postorder(parent)
    clade = [1 << v if v < n_tips else 0 for v in range(parent.shape[0])]
    for v in order:
        for c in kids[v]:
            clade[v] |= clade[c]
    full = (1 << n_tips) - 1
    out: dict[int, float] = {}
    for v in range(parent.shape[0]):
        if v == root:
            continue
        s = clade[v] if not clade[v] & 1 else full ^ clade[v]
        out[s] = out.get(s, 0.0) + float(blen[v])
    return out


def newick_splits(text: str, n_tips: int) -> dict:
    """{split: length} of a .t file's tree, its tips numbered from 1."""
    body = text[text.index("("):text.rindex(")") + 1]
    full = (1 << n_tips) - 1
    out: dict[int, float] = {}
    stack: list[int] = []
    i, last = 0, 0
    while i < len(body):
        ch = body[i]
        if ch == "(":
            stack.append(0)
            i += 1
        elif ch in ",)":
            if ch == ")":
                last = stack.pop()
                if stack:
                    stack[-1] |= last
            i += 1
            if ch == ")" and i < len(body) and body[i] == ":":
                j = i + 1
                while j < len(body) and body[j] not in ",)":
                    j += 1
                s = last if not last & 1 else full ^ last
                out[s] = out.get(s, 0.0) + float(body[i + 1:j])
                i = j
        else:
            j = i
            while body[j] not in ":,)":
                j += 1
            tip = 1 << (int(body[i:j]) - 1)
            stack[-1] |= tip
            k = j + 1
            while body[k] not in ",)":
                k += 1
            s = tip if not tip & 1 else full ^ tip
            out[s] = out.get(s, 0.0) + float(body[j + 1:k])
            i = k
    return out


# ---------------------------------------------------------------- model
def gamma_rates(alpha: float, k: int) -> np.ndarray:
    """Mean rate of each of k equal-probability gamma categories."""
    cuts = gammaincinv(alpha, np.arange(1, k) / k) / alpha
    cdf = gammainc(alpha + 1, np.r_[0.0, cuts * alpha, np.inf])
    return k * np.diff(cdf)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    """float64, float32, or TF32 products on float32."""

    def __init__(self, name: str):
        if name not in ("float64", "float32", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def mm(self, a, b):
        if self.name == "tf32":
            a, b = to_tf32(a), to_tf32(b)
        return a @ b


class Data:
    """The reference's divisions on ``device``, padded to the longest so
    that one product serves all: tips [taxa, D, S, Pmax] of ``states``
    S (a code of S, missing, all ones), weights [D, Pmax] (0 on the
    padding), and for each pattern the states every taxon allows (the
    invariant class's)."""

    def __init__(self, divs, prec: Precision, device, states: int):
        self.prec, self.device = prec, device
        self.sites = np.array([s for _, _, s in divs], np.float64)
        self.npat = [p.shape[1] for p, _, _ in divs]
        n_tips = divs[0][0].shape[0]
        D, pmax = len(divs), max(self.npat)
        pats = np.zeros((n_tips, D, pmax), np.int64)
        w = np.zeros((D, pmax))
        for d, (p, wd, _) in enumerate(divs):
            pats[:, d, :p.shape[1]] = p
            w[d, :p.shape[1]] = wd
        self.states = states
        states = np.concatenate([np.eye(states), np.ones((1, states))])[pats]
        dt = prec.dtype
        self.n_tips = n_tips
        self.tips = torch.as_tensor(states, dtype=dt, device=device).permute(
            0, 1, 3, 2).contiguous()
        self.weights = torch.as_tensor(w, dtype=dt, device=device)
        self.invariant = torch.as_tensor(states.min(0), dtype=dt,
                                         device=device)   # [D, Pmax, S]


def tree_lnl(parent, blen, data: Data, params, ratemult, n_cats) -> float:
    """lnL of one tree over every division of ``data``: ``params`` each
    division's (q, pi, alpha, pinvar), Q a float64 [S, S] rate matrix
    reversible under pi, ``ratemult`` the weighted simplex of rate
    multipliers or None."""
    prec, dev, dt = data.prec, data.device, data.prec.dtype
    root, kids, order = postorder(np.asarray(parent))
    D = len(params)
    frac = data.sites / data.sites.sum()
    us, uinvs, lams, rates = [], [], [], []
    for d, prm in enumerate(params):
        q = torch.as_tensor(prm["q"], dtype=torch.float64)
        s = torch.as_tensor(prm["pi"], dtype=torch.float64).sqrt()
        lam, v = torch.linalg.eigh((s[:, None] * q / s[None, :]).to(dt))
        us.append(v / s[:, None].to(dt))
        uinvs.append(v.T * s[None, :].to(dt))
        lams.append(lam)
        mult = 1.0 if ratemult is None else float(ratemult[d] / frac[d])
        pinv = prm["pinvar"]
        base = mult / (1.0 - pinv) if pinv > 0 else mult
        rates.append(gamma_rates(prm["alpha"], n_cats) * base)
    S = data.states
    u = torch.stack(us).to(dev)                       # [D, S, S]
    uinv = torch.stack(uinvs).to(dev)
    lam = torch.stack(lams).to(dev)                   # [D, S]
    r = torch.as_tensor(np.array(rates), dtype=dt, device=dev)  # [D, K]
    bl = torch.as_tensor(np.asarray(blen, np.float64), dtype=dt,
                         device=dev)
    # P [nodes, D, K, S, S] = U diag(exp(lam r t)) U^-1
    e = torch.exp(bl[:, None, None, None] * r[None, :, :, None]
                  * lam[None, :, None, :])
    # probabilities, clamped to [0, 1] against round-off as MrBayes' own
    # transition probabilities are
    p = prec.mm(u[None, :, None] * e[..., None, :],
                uinv[None, :, None]).clamp(0.0, 1.0)
    pmax = data.tips.shape[-1]
    part: dict[int, torch.Tensor] = {}
    lnscale = torch.zeros((D, pmax), dtype=dt, device=dev)
    for node in order:
        acc = None
        for c in kids[node]:
            x = (data.tips[c][:, None] if c < data.n_tips
                 else part.pop(c))                    # [D, K|1, S, Pmax]
            y = prec.mm(p[c], x.expand(D, n_cats, S, pmax))
            acc = y if acc is None else acc * y
        m = acc.amax(dim=(1, 2))                      # [D, Pmax]
        # a pattern no state can explain scores 0, not NaN
        m = torch.where(m > 0, m, torch.ones_like(m))
        acc = acc / m[:, None, None]
        lnscale = lnscale + torch.log(m)
        part[node] = acc
    pi = torch.as_tensor(np.array([prm["pi"] for prm in params]),
                         dtype=dt, device=dev)        # [D, S]
    site = (part[root] * pi[:, None, :, None]).sum(2).mean(1)
    ln_site = torch.log(site) + lnscale
    pinv = torch.as_tensor([prm["pinvar"] for prm in params], dtype=dt,
                           device=dev)[:, None]
    cl = (data.invariant * pi[:, None, :]).sum(-1)
    with_inv = torch.logaddexp(
        torch.log1p(-pinv) + ln_site,
        torch.log(pinv) + torch.log(cl))
    ln_site = torch.where(pinv > 0, with_inv, ln_site)
    return float((data.weights * ln_site).sum())


# ---------------------------------------------------------------- prior
def _dirichlet_lpdf(x, alpha: float) -> float:
    x = np.asarray(x, np.float64)
    k = x.shape[0]
    return (math.lgamma(alpha * k) - k * math.lgamma(alpha)
            + (alpha - 1.0) * float(np.log(x).sum()))


def _gamma_lpdf(x: float, shape: float, rate: float) -> float:
    if x <= 0:
        return -math.inf
    return (shape * math.log(rate) - math.lgamma(shape)
            + (shape - 1.0) * math.log(x) - rate * x)


def tree_lnprior(parent, blen, age, spec: dict) -> float:
    """The tree's prior: an unrooted tree's branch lengths under
    gammadir, or a clock tree's node ages under the uniform prior given
    its root age, times the root age's prior.  The uniform topology
    prior, a constant, is left out."""
    parent = np.asarray(parent)
    n_tips = (parent.shape[0] + 1) // 2
    if spec["tree"] == "clock":
        kind, *tp = spec["clock"]
        if kind != "uniform":
            raise ValueError(f"clock prior {spec['clock']}")
        age = np.asarray(age, np.float64)
        root = int(np.nonzero(parent < 0)[0][0])
        inner = parent >= 0
        if (age[parent[inner]] < age[inner]).any():
            return -math.inf
        t1, n = float(age[root]), float(n_tips)
        # the node ages uniform below the root age: 2^(n-1) ranked
        # histories over n! (n - 1) labelled ones, each age density 1/t1
        # below the root (MrBayes 3.2, LnUniformPriorPr without dated tips)
        shape, rate = spec["treeage"][1:]
        return ((n - 1.0) * math.log(2.0) - math.lgamma(n + 1.0)
                - math.log(n - 1.0) - (n - 2.0) * math.log(t1)
                + _gamma_lpdf(t1, shape, rate))
    kind, a_t, b_t, a_f, c_i = spec["brlens"]
    if kind != "gammadir" or a_f != 1.0 or c_i != 1.0:
        raise ValueError(f"brlens prior {spec['brlens']}")
    edges = splits(parent, np.asarray(blen, np.float64), n_tips)
    b = np.fromiter(edges.values(), np.float64)
    n, t = b.shape[0], float(b.sum())
    # compound Dirichlet (Rannala, Zhu & Yang 2012): Gamma(T) x flat
    # Dirichlet on b / T, over T^(n-1)
    return (_gamma_lpdf(t, a_t, b_t) + math.lgamma(n)
            - (n - 1) * math.log(t))


def lnprior(parent, blen, age, params: list[dict], ratemult,
            spec: dict, division_lnprior) -> float:
    """MrBayes' lnPrior of a tree (``tree_lnprior``) and each division's
    ``params`` under ``spec``, by the model family's
    ``division_lnprior(prm, spec)``.  ``ratemult`` is the simplex of rate
    multipliers weighted by site share, or None where ratepr is fixed."""
    lp = tree_lnprior(parent, blen, age, spec)
    for prm in params:
        lp += division_lnprior(prm, spec)
    if ratemult is not None:
        lp += _dirichlet_lpdf(ratemult, spec["ratemult_dirichlet"])
    return lp


def clock_blens(parent, age) -> np.ndarray:
    """A clock tree's branch lengths, age differences (clock rate 1)."""
    parent = np.asarray(parent)
    age = np.asarray(age, np.float64)
    return np.where(parent >= 0, age[np.maximum(parent, 0)] - age, 0.0)


def state_scores(parent, blen, age, params, ratemult, data: Data,
                 n_cats, prior, division_lnprior):
    """(lnL, lnPrior) of one chain's state on the reference's ``data``:
    ``blen`` its branch lengths, ``age`` its node ages on a clock tree
    (else None)."""
    lnl = tree_lnl(parent, blen, data, params, ratemult, n_cats)
    return lnl, lnprior(parent, blen, age, params, ratemult, prior,
                        division_lnprior)
