"""Batched topology utilities on the device.

The pruning pass needs internal nodes in child-before-parent order.  The
topology is chain state on the device, so the order is derived with
tensor ops: node depths by pointer doubling on the parent array (O(log n)
gathers), then a stable argsort by decreasing depth.  Every function takes
``parent`` as ``[..., n_nodes]`` (leading axes are chains) with -1 at the
root.  (The reference re-derives a pointer-based downpass after every
topology move — src/utils.c:3909 GetDownPass.)
"""
from __future__ import annotations

import math

import torch


def node_depths(parent: torch.Tensor) -> torch.Tensor:
    """Depth of every node below the root (root depth 0).  After k rounds
    ``anc`` holds the 2^k-th ancestor and ``depth`` the distance walked."""
    n = parent.shape[-1]
    idx = torch.arange(n, device=parent.device).expand_as(parent)
    anc = torch.where(parent < 0, idx, parent)
    depth = (parent >= 0).long()
    for _ in range(max(1, math.ceil(math.log2(n)))):
        depth = depth + depth.gather(-1, anc)
        anc = anc.gather(-1, anc)
    return depth


def postorder_internal(parent: torch.Tensor, n_tips: int) -> torch.Tensor:
    """Internal-node ids (n_tips..2n-2) ordered children-before-parents,
    root last: [..., n_tips - 1]."""
    d = node_depths(parent)[..., n_tips:]
    order = torch.argsort(-d, dim=-1, stable=True)
    return order + n_tips


def subtree_mask(parent: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., n_nodes] bool: nodes in the subtree rooted at v [...] (v
    included), by pointer doubling over ancestor chains."""
    n = parent.shape[-1]
    idx = torch.arange(n, device=parent.device).expand_as(parent)
    anc = torch.where(parent < 0, idx, parent)
    hit = idx == v[..., None]
    for _ in range(max(1, math.ceil(math.log2(n)))):
        hit = hit | hit.gather(-1, anc)
        anc = anc.gather(-1, anc)
    return hit


def descendant_matrix(parent: torch.Tensor) -> torch.Tensor:
    """[..., n, n] bool closure: D[a, i] = i is in the subtree of a.  One
    pointer-doubling pass batched over all nodes, so a move needing
    several subtree or ancestor masks builds it once (D[a, :] = subtree
    of a; D[:, a] = ancestors-or-self of a)."""
    n = parent.shape[-1]
    idx = torch.arange(n, device=parent.device)
    anc = torch.where(parent < 0, idx.expand_as(parent), parent)
    hit = (idx[:, None] == idx[None, :]).expand(parent.shape[:-1] + (n, n))
    for _ in range(max(1, math.ceil(math.log2(n)))):
        hit = hit | hit.gather(-1, anc[..., None, :].expand_as(hit))
        anc = anc.gather(-1, anc)
    return hit


def ancestor_matrix(parent: torch.Tensor) -> torch.Tensor:
    """[..., n, n] float: A[u, v] = 1.0 iff v is an ancestor-or-self of u
    (mrbayes_tpu/ops/traversal.py:42), for monophyly checks, MRCA lookups
    and the CPP clock's inherited rates.  The transpose of
    ``descendant_matrix``."""
    return descendant_matrix(parent).transpose(-1, -2).float()
