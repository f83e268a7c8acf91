"""Divisions stacked into one launch: the stacked kernel, one block per
(division, chain, pattern tile).

Counterpart of ``mrbayes_tpu/ops/pruning_pallas.py`` ``PruningPallasStacked``
(``:728``), which runs the fused down-pass ``_kernel_g`` over a group of
divisions that share the tree, stacked block-diagonally on one union state
axis of width ΣK_d·S_d.  That union exists on the TPU only to feed its
matrix unit: each pattern's arithmetic involves only its own division
(zeros propagate and a pattern's rescaling max is its own division's).
The port keeps no union.  ``csrc/stacked.cu`` runs every member's own walk
in one launch, each block one tile of one division at that division's K_d
and S_d, through the on-chip walk of ``csrc/onchip_walk.cuh`` (partials in
shared memory; a member whose slots do not fit takes the global-scratch
walk of ``csrc/down_pass.cuh`` in a second kernel of the same call).  Its
header records what bounds it.

The group's operands live in flat buffers laid out by ``StackedLayout``
(``pruning_cuda.GroupLayout``, shared with the multiwalk path), division
after division with no padding: operators ``[C, n_int, 2, K_d, S_d,
S_d]``, tips ``[n_tips, S_d, P_d]`` (once for all chains), root partials
``[C, K_d, S_d, P_d]`` and log-scales ``[C, P_d]``.  The kernel reads
them through a per-division table and a tile map made once per chain
count on the device (``csrc/group_walk.cuh``).

The same launch takes a group whose members each have their own tree
(``GeneStackLayout``, ``PruningCudaGeneStack``): the gene trees of a BEST
analysis, the port's counterpart of the JAX engine's vmapped pass over the
genes (``mrbayes_tpu/mcmc/engine.py:_build_best_batched``,
``_best_lnl_batched``).  Its child slots are ``[G, C, n_int, 2]``; the
table's last column points each member at its own block.

The shared-tree path stays opt-in (``Engine(stacked=True)`` or
``MB_TPU_STACKED=1``), as in the JAX package; the gene-tree path is BEST's
likelihood whenever its genes share one model shape.  ``stacked_down``
launches the kernel and takes CUDA tensors only; ``stacked_down_plain``
is its plain PyTorch version (each member through
``pruning_down_plain``).  ``PruningCudaStacked`` and
``PruningCudaGeneStack`` send a CUDA tensor to the kernel and a CPU
tensor to the plain version; there is no fallback from one to the
other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spans import SPANS
from .pruning_cuda import GroupLayout, slot_operands


class StackedLayout(GroupLayout):
    """The layout of a stacked group (each member its own K_d, S_d and
    P_d), its launch plan and its launch (``pruning_cuda.GroupLayout``)."""

    library_name = "stacked"


class GeneStackLayout(StackedLayout):
    """A stacked group whose members each have their own tree: child
    slots lr [G, C, n_int, 2]."""

    tree_per_member = True


def stacked_down(lr: torch.Tensor, pstep: torch.Tensor, tips: torch.Tensor,
                 layout: StackedLayout):
    """Launch the CUDA stacked down-pass.  lr int32 [C, n_int, 2] child
    slots per chain, shared by the group's members (``GeneStackLayout``:
    [G, C, n_int, 2], each member's own); pstep and tips flat
    f32 in ``layout``.  Returns flat (root, ls).  Raises on anything the
    kernel does not take, and when the launch is refused."""
    return layout.down(lr, pstep, tips)


def stacked_down_plain(lr: torch.Tensor, pstep: torch.Tensor,
                       tips: torch.Tensor, layout: StackedLayout):
    """The plain PyTorch version of ``stacked_down``: same operands, same
    flat results, on any device (each member's walks through the plain
    single-division pass, which is what the union computes per member)."""
    return layout.down_plain(lr, pstep, tips)


class PruningCudaStacked:
    """Static wiring of a group of stacked divisions and the callable
    grouped pruning op.

    ``specs``: ``[(tips [n_tips, P_d, S_d], n_cats_d)]`` per member in
    group order, each division's tips with any coding dummy patterns
    already appended.  Calling it maps each chain's (postorder, left,
    right) and the members' transition tensors ``P_list`` (each
    ``[C, n_nodes, K_d, S_d, S_d]``) to flat (root, logscale);
    ``div_view`` slices member d's (root [C, K_d, S_d, P_d], logscale
    [C, P_d]).  ``launches`` counts kernel launches (never plain-version
    calls).
    """

    def __init__(self, specs, device):
        self.n_tips = specs[0][0].shape[0]
        self.layout = StackedLayout(self.n_tips, [k for _, k in specs],
                                    [tp.shape[2] for tp, _ in specs],
                                    [tp.shape[1] for tp, _ in specs])
        self.tips = torch.as_tensor(np.concatenate(
            [np.transpose(np.asarray(tp, np.float32), (0, 2, 1)).ravel()
             for tp, _ in specs]), device=device)
        self.launches = 0

    def operands(self, order, left, right, P_list):
        """(lr int32 [C, n_int, 2], flat pstep): each member's per-step
        operators ``Pd[rows, lch]``, ``Pd[rows, rch]`` gathered into one
        buffer."""
        lr, lch, rch = slot_operands(order, left, right, self.n_tips)
        rows = torch.arange(order.shape[0], device=order.device)[:, None,
                                                                 None]
        nodes = torch.stack([lch, rch], -1)                 # [C, n_int, 2]
        pstep = torch.cat([Pd[rows, nodes].reshape(-1) for Pd in P_list])
        return lr, pstep

    def __call__(self, order, left, right, P_list):
        lr, pstep = self.operands(order, left, right, P_list)
        with SPANS("gen.lnl.launch"):
            if self.tips.is_cuda:
                out = stacked_down(lr, pstep, self.tips, self.layout)
                self.launches += 1
                return out
            return stacked_down_plain(lr, pstep, self.tips, self.layout)

    def div_view(self, root, ls, d: int):
        """(root [C, K_d, S_d, P_d], ls [C, P_d]) of member d from the flat
        outputs."""
        return self.layout.div_view(root, ls, d)


class PruningCudaGeneStack:
    """Static wiring of the gene trees of a BEST analysis, one tree a
    member and every member at one (K, S), and the callable pruning op.

    ``tips_list``: each gene's tips [n_tips, P_g, S].  Calling it maps the
    [G * C] gene trees (gene-major: row g * C + c is gene g of chain c;
    postorder, left, right) and their transition tensors P [G * C,
    n_nodes, K, S, S] to flat (root, logscale) in ``GeneStackLayout``:
    one ``slot_operands`` over the G * C trees, one gather of the
    operators and one ``stacked.cu`` launch.  ``padded`` gives every
    gene's outputs on one pattern axis of P_max for a batched root
    reduction.  ``launches`` counts kernel launches (never plain-version
    calls)."""

    def __init__(self, tips_list, n_cats: int, device):
        G = len(tips_list)
        self.n_tips, _, S = tips_list[0].shape
        self.G, self.K, self.S = G, n_cats, S
        ps = [tp.shape[1] for tp in tips_list]
        self.layout = GeneStackLayout(self.n_tips, [n_cats] * G, [S] * G, ps)
        self.P_max = max(ps)
        self.tips = torch.as_tensor(np.concatenate(
            [np.transpose(np.asarray(tp, np.float32), (0, 2, 1)).ravel()
             for tp in tips_list]), device=device)
        self._pad_index: dict = {}
        self.launches = 0

    def operands(self, order, left, right, P):
        """(lr int32 [G, C, n_int, 2], flat pstep) from the gene-major
        order [G * C, n_int], left/right [G * C, n_nodes] and P [G * C,
        n_nodes, K, S, S]."""
        lr, lch, rch = slot_operands(order, left, right, self.n_tips)
        rows = torch.arange(order.shape[0], device=order.device)[:, None,
                                                                 None]
        pstep = P[rows, torch.stack([lch, rch], -1)]   # [GC, n_int, 2, ...]
        return (lr.view(self.G, -1, *lr.shape[1:]),
                pstep.reshape(-1))

    def __call__(self, order, left, right, P):
        lr, pstep = self.operands(order, left, right, P)
        with SPANS("gen.lnl.launch"):
            if self.tips.is_cuda:
                out = stacked_down(lr, pstep, self.tips, self.layout)
                self.launches += 1
                return out
            return stacked_down_plain(lr, pstep, self.tips, self.layout)

    def padded(self, root, ls):
        """Every gene's (root [G * C, K, S, P_max], ls [G * C, P_max]) from
        the flat outputs, gene-major; a gene's pad patterns repeat its last
        one (weigh them 0)."""
        C = ls.numel() // sum(self.layout.ps)
        key = (C, root.device)
        if key not in self._pad_index:
            self._pad_index[key] = self._make_pad_index(C, root.device)
        ri, li = self._pad_index[key]
        return root.take(ri), ls.take(li)

    def _make_pad_index(self, C: int, device):
        o = self.layout.offsets(C)
        K, S, Pm = self.K, self.S, self.P_max
        c = np.arange(C)[:, None, None, None]
        k = np.arange(K)[None, :, None, None]
        s = np.arange(S)[None, None, :, None]
        ri, li = [], []
        for g, P in enumerate(self.layout.ps):
            p = np.minimum(np.arange(Pm), P - 1)
            ri.append(o[g, 5] + ((c * K + k) * S + s) * P + p)
            li.append(o[g, 6] + np.arange(C)[:, None] * P + p)
        return (torch.as_tensor(np.concatenate(ri).reshape(-1, K, S, Pm),
                                device=device),
                torch.as_tensor(np.concatenate(li).reshape(-1, Pm),
                                device=device))
