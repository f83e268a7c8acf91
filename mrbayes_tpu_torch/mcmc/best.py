"""BEST, the multispecies coalescent (MSC): species trees containing gene
trees (reference src/best.c).

Counterpart of ``mrbayes_tpu/mcmc/best.py``, batched over chains (and
over genes where a function takes gene trees).  The reference computes the
joint gene-tree/species-tree prior by mapping each gene tree onto the
species tree, sorting coalescent events per population and accumulating
interval terms (LnPriorProbGeneTree, src/best.c:826).  The density here
keeps the JAX package's sort-free form: with k_b(t) lineages in population
b at time t, the coalescent exponent is

    integral of k_b(t)(k_b(t)-1) dt  =  sum over i != j of |overlap of
    lineages i and j in b|,

a pairwise interval-intersection reduction, computed as one dense
[C, G, V, V, M] min/max expression (C chains, G genes, V gene-tree nodes,
M species-tree nodes) with no data-dependent control flow.  The
per-population event counts and the validity constraint (a coalescence
may not predate the species-tree MRCA of its descendants) come from the
ancestor-matrix machinery of ``ops/traversal.py``.

Populations are species-tree branches; theta_b = ploidy factor x N_b
(src/best.c:841-851), with popvarpr=equal sharing one N.

Gene trees are ``[C, G, 2n-1]`` clock trees (root at node 2n-2), the
species tree ``[C, 2S-1]`` (root at 2S-2).  Nothing here synchronises with
the host: the species-tree move's clustering is a Python loop of masked
merges with the static trip count S(S-1)/2.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.traversal import ancestor_matrix
from .moves import _put, _uniforms

NEG_INF = -1e30
_BIG = 1e30


def species_clades(s_parent: torch.Tensor, n_species: int) -> torch.Tensor:
    """[..., 2S-1, S] float: clade[m, s] = 1 iff species tip s is below or
    at species node m; ``s_parent`` [..., 2S-1]."""
    A = ancestor_matrix(s_parent)                       # [..., M, M]
    return A[..., :n_species, :].transpose(-1, -2)


def gene_species_sets(g_parent: torch.Tensor, tip_species: torch.Tensor,
                      n_tips: int, n_species: int) -> torch.Tensor:
    """[..., 2N-1, S]: D[v, s] = 1 iff gene node v has a descendant tip of
    species s; ``g_parent`` [..., 2N-1], ``tip_species`` [N] long."""
    Ag = ancestor_matrix(g_parent)                      # [..., V, V]
    onehot = (tip_species[:, None] == torch.arange(
        n_species, device=tip_species.device)).to(Ag.dtype)   # [N, S]
    return torch.matmul(Ag[..., :n_tips, :].transpose(-1, -2),
                        onehot).clamp_max(1.0)


def _rows_of(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [C, M, ...] gathered at idx [C, G, V] along M: [C, G, V, ...]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[rows, idx]


def msc_gene_log_prior(g_parent, g_age, tip_species, s_parent, s_age,
                       theta, n_tips: int, n_species: int) -> torch.Tensor:
    """Log density [C, G] of each gene tree under the MSC given its chain's
    species tree (reference LnPriorProbGeneTree, src/best.c:826).

    g_parent/g_age [C, G, V]; tip_species [N] long; s_parent/s_age
    [C, M]; theta [C, M] per population (ploidy factor applied).  The
    overlap tensor is [C, G, V, V, M], so memory grows as O(C G V^2 M):
    fine through tens of taxa, as in the JAX package."""
    V = 2 * n_tips - 1
    dev = g_age.device
    clade = species_clades(s_parent, n_species)         # [C, M, S]
    D = gene_species_sets(g_parent, tip_species, n_tips,
                          n_species)                    # [C, G, V, S]
    A_s = ancestor_matrix(s_parent)                     # [C, M, M]
    sa = s_age[:, None, None, :]                        # [C, 1, 1, M]

    # species MRCA of every gene node: the shallowest species node whose
    # clade holds the gene node's species set
    contains = (D[..., :, None, :]
                <= clade[:, None, None, :, :] + 1e-6).all(-1)   # [C,G,V,M]
    sp_map = torch.where(contains, sa, _BIG).argmin(-1)        # [C, G, V]

    # population top ages (the root population extends to infinity)
    top = torch.where(s_parent >= 0,
                      s_age.gather(-1, s_parent.clamp_min(0)), _BIG)
    topb = top[:, None, None, :]

    # event terms: each gene internal node is a coalescence in the
    # population on sp_map's ancestry whose age interval holds it
    onpath = _rows_of(A_s, sp_map) > 0                  # [C, G, V, M]
    t = g_age[..., None]
    internal = torch.arange(V, device=dev) >= n_tips
    in_pop = (onpath & (t >= sa - 1e-12) & (t < topb)
              & internal[:, None])
    n_events = in_pop.sum(-2).to(g_age.dtype)           # [C, G, M]

    # lineage-pair overlap integral per population; the edges are every
    # node but the gene root (lineage from node to parent)
    edge = torch.arange(V, device=dev) != V - 1
    hi_e = torch.where(g_parent >= 0,
                       g_age.gather(-1, g_parent.clamp_min(0)), g_age)
    live = onpath & edge[:, None]
    lo = torch.where(live, torch.maximum(t, sa), _BIG)
    hi = torch.where(live, torch.minimum(hi_e[..., None], topb), _BIG)
    ov = (torch.minimum(hi[..., :, None, :], hi[..., None, :, :])
          - torch.maximum(lo[..., :, None, :], lo[..., None, :, :])
          ).clamp_min(0.0)                              # [C, G, V, V, M]
    diag = (hi - lo).clamp_min(0.0)
    pairsum = ov.sum((-3, -2)) - diag.sum(-2)           # [C, G, M]

    th = theta[:, None, :]
    lp = (n_events * torch.log(2.0 / th) - pairsum / th).sum(-1)

    # validity: every coalescence at or above its species MRCA, and every
    # event in exactly one population
    mrca_age = s_age[:, None, :].expand(-1, g_age.shape[1], -1).gather(
        -1, sp_map)
    valid_depth = torch.where(internal, g_age >= mrca_age - 1e-9,
                              True).all(-1)
    valid_assign = torch.where(internal, in_pop.sum(-1) == 1, True).all(-1)
    return torch.where(valid_depth & valid_assign, lp, NEG_INF)


def ploidy_factor(ploidy: str) -> float:
    """src/best.c:838-844: diploid 4, haploid 2, z-linked 3."""
    return {"diploid": 4.0, "haploid": 2.0, "zlinked": 3.0}[ploidy.lower()]


# ---------------------------------------------------------------------
# the species-tree proposal from gene-tree minimum depths (reference
# Move_SpeciesTree, src/best.c:1715: GetMinDepthMatrix :1026,
# ModifyDepthMatrix :1202, GetSpeciesTreeFromMinDepths :476, GetMeanDist
# :299, LnProposalProbSpeciesTree :1137)

def min_depth_matrix(g_parent, g_age, tip_species, n_tips: int,
                     S: int) -> torch.Tensor:
    """[C, S, S] symmetric: the minimum over genes of the age of the
    shallowest gene-tree node holding tips of both species (diagonal
    _BIG); g_parent/g_age [C, G, V]."""
    D = gene_species_sets(g_parent, tip_species, n_tips, S) > 0
    has = D[..., :, None] & D[..., None, :]             # [C, G, V, S, S]
    node_min = torch.where(has, g_age[..., None, None], _BIG)
    depth = node_min.amin(dim=(1, 2))                   # [C, S, S]
    eye = torch.eye(S, dtype=torch.bool, device=depth.device)
    return torch.where(eye, _BIG, depth)


def _cross_masks(s_left, s_right, s_parent, S: int) -> torch.Tensor:
    """[C, S-1, S, S] bool: the pairs (i left of m, j right of m) of each
    internal species node m = S..2S-2."""
    clade = species_clades(s_parent, S) > 0             # [C, M, S]
    L = _rows_of(clade, s_left[:, None, S:])[:, 0]      # [C, S-1, S]
    R = _rows_of(clade, s_right[:, None, S:])[:, 0]
    return ((L[..., :, None] & R[..., None, :])
            | (R[..., :, None] & L[..., None, :]))


def _mean_min_dist(s_left, s_right, s_parent, s_age, depth,
                   S: int) -> torch.Tensor:
    """[C]: the mean over internal species nodes of (the least depth of a
    pair the node joins) minus the node's age (GetMeanDist)."""
    cross = _cross_masks(s_left, s_right, s_parent, S)
    d = torch.where(cross, depth[:, None], _BIG)
    return (d.amin(dim=(-2, -1)) - s_age[:, S:]).mean(-1)


def _ln_proposal_prob(s_left, s_right, s_parent, s_age, depth, lam,
                      S: int) -> torch.Tensor:
    """[C]: density of each chain's species tree under the
    truncated-exponential depth-matrix proposal with rate ``lam`` [C]
    (reference LnProposalProbSpeciesTree, src/best.c:1137).  The
    reference's x == 1 case is the limit of the general formula,
    recovered here by clamping."""
    cross = _cross_masks(s_left, s_right, s_parent, S)
    cross = cross & torch.ones(S, S, dtype=torch.bool,
                               device=cross.device).triu(1)
    lam4 = lam[:, None, None, None]
    dep = depth[:, None]                                # [C, 1, S, S]
    dist = (dep - s_age[:, S:, None, None]).clamp_min(0.0)
    norm = (1.0 - torch.exp(-lam4 * dep)).clamp_min(1e-30)
    e = torch.exp(-lam4 * dist)
    dens = lam4 * e / norm
    prob = ((1.0 - e) / norm).clamp_min(1e-30)
    sumdr = torch.where(cross, dens / prob, 0.0).sum((-2, -1))
    logprod = torch.where(cross, torch.log(prob), 0.0).sum((-2, -1))
    total = (torch.log(sumdr.clamp_min(1e-30)) + logprod).sum(-1)
    return torch.where(torch.isnan(total), 0.0, total)


def pair_index(S: int, device):
    """The species pairs i < j of ``np.triu_indices(S, 1)`` as two long
    tensors on ``device`` (made once: index arrays built from host data
    in the generation loop would synchronise)."""
    return tuple(torch.as_tensor(x, device=device)
                 for x in np.triu_indices(S, 1))


def cluster_depths(dmod: torch.Tensor, S: int, pairs=None):
    """Single-linkage clustering of each chain's modified pairwise depths
    dmod [C, P] (the pairs of ``pair_index``, ``pairs`` when given) into a
    clock tree: the pairs in increasing depth, each joining two clusters
    not yet joined at that depth (the reference's sorted-pair polytomy
    resolution, src/best.c:476, as the JAX package's fori_loop of masked
    merges).  Returns (s_left, s_right, s_parent [C, 2S-1] long, s_age
    [C, 2S-1])."""
    C, P = dmod.shape
    M = 2 * S - 1
    dev = dmod.device
    ii, jj = pairs or pair_index(S, dev)
    order = torch.argsort(dmod, dim=-1, stable=True)
    root_of = torch.arange(S, device=dev).expand(C, S)
    sl = torch.zeros((C, M), dtype=torch.long, device=dev)
    sr = torch.zeros_like(sl)
    sp = torch.full_like(sl, -1)
    sa = dmod.new_zeros((C, M))
    cnt = torch.zeros(C, dtype=torch.long, device=dev)
    for step in range(P):
        p = order[:, step]
        ci = root_of.gather(1, ii[p][:, None])[:, 0]
        cj = root_of.gather(1, jj[p][:, None])[:, 0]
        merge = ci != cj
        # a chain whose pair is already joined writes nothing (its k may
        # point past the last node once every merge is done)
        k = (S + cnt).clamp_max(M - 1)
        m2 = merge[:, None]
        sl = torch.where(m2, _put(sl, k, ci), sl)
        sr = torch.where(m2, _put(sr, k, cj), sr)
        sp = torch.where(m2, _put(_put(sp, ci, k), cj, k), sp)
        sa = torch.where(m2, _put(sa, k, dmod.gather(1, p[:, None])[:, 0]),
                         sa)
        member = (root_of == ci[:, None]) | (root_of == cj[:, None])
        root_of = torch.where(member & m2, k[:, None], root_of)
        cnt = cnt + merge.long()
    return sl, sr, sp, sa


def species_tree_proposal(state, tuning, u, tip_species, n_tips: int,
                          S: int, pairs=None):
    """The depth-matrix proposal of every chain from uniforms u [C, P]:
    perturb the gene trees' minimum depths with truncated exponentials
    (ModifyDepthMatrix), cluster them back into a clock tree and return
    (the new s_left, s_right, s_parent, s_age, the log Hastings ratio
    [C]: backward minus forward proposal density)."""
    pairs = pairs or pair_index(S, u.device)
    depth = min_depth_matrix(state["parent"], state["age"], tip_species,
                             n_tips, S)
    dvec = depth[:, pairs[0], pairs[1]]                 # [C, P]
    old = (state["s_left"], state["s_right"], state["s_parent"],
           state["s_age"])
    lam_f = 1.0 / (_mean_min_dist(*old, depth, S)
                   * tuning).clamp_min(1e-12)
    lf = lam_f[:, None]
    delta = torch.log1p(-u * (1.0 - torch.exp(-lf * dvec))) / (-lf)
    sl, sr, sp, sa = cluster_depths(dvec - delta, S, pairs)
    lam_b = 1.0 / (_mean_min_dist(sl, sr, sp, sa, depth, S)
                   * tuning).clamp_min(1e-12)
    ln_fwd = _ln_proposal_prob(sl, sr, sp, sa, depth, lam_f, S)
    ln_bwd = _ln_proposal_prob(*old, depth, lam_b, S)
    return sl, sr, sp, sa, ln_bwd - ln_fwd


def make_species_tree_move(S: int, tip_species, n_tips: int):
    """Move_SpeciesTree on every chain: a whole new species tree from the
    gene trees' perturbed minimum depths (``species_tree_proposal``), its
    uniforms drawn on the device.  The joint MSC prior ratio is left to
    the engine's Metropolis step.  ``tuning`` [C] is the reference's
    lambda divider (lambdadiv, default 1.2, autotuned as a
    multiplier)."""
    P = S * (S - 1) // 2
    pairs = pair_index(S, tip_species.device)

    def mv(gen, state, tuning):
        u = _uniforms(gen, state["s_age"], P)
        sl, sr, sp, sa, lnH = species_tree_proposal(
            state, tuning, u, tip_species, n_tips, S, pairs)
        return ({**state, "s_left": sl, "s_right": sr, "s_parent": sp,
                 "s_age": sa.to(state["s_age"].dtype)}, lnH)

    return mv


def init_compatible_trees(n_tips: int, n_species: int, tip_species,
                          rng: np.random.Generator, n_genes: int):
    """Starting trees (host numpy, the JAX package's draws): a random
    species clock tree with small depths and gene trees whose coalescences
    all predate the species root, which is always MSC-consistent (the
    reference seeds gene trees first and builds the species tree from
    minimum depths, src/best.c:138; this order is simpler and as valid a
    start)."""
    from ..trees import random_clock_tree
    st, s_ages = random_clock_tree(n_species, rng, mean_age=0.05)
    genes = []
    for _ in range(n_genes):
        gt, g_ages = random_clock_tree(n_tips, rng, mean_age=0.3)
        # push every coalescence above the species root age
        root_age = s_ages.max()
        g_ages = np.where(np.arange(2 * n_tips - 1) >= n_tips,
                          g_ages + root_age * 1.05, g_ages)
        genes.append((gt, g_ages))
    return (st, s_ages), genes
