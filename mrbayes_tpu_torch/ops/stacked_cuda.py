"""Divisions stacked on the state axis through one single-division launch.

Counterpart of ``mrbayes_tpu/ops/pruning_pallas.py`` ``PruningPallasStacked``
(``:728``), which runs the fused down-pass ``_kernel_g`` over a group of
divisions that share the tree.  Division d's K_d rate categories and S_d
states become one block of width K_d·S_d on a union state axis of width
ΣK_d·S_d, and its patterns one range of the union pattern axis.  Each
step's operator is block-diagonal: division d's per-category operators
sit on the diagonal of its block, every other entry is zero.  A pattern's
tip partials are nonzero only in its own division's block, so zeros
propagate and the per-pattern rescaling max is its own division's; one
postorder walk computes every division's root partials.

There is no kernel of its own: the union is launched through
``pruning_cuda.pruning_down`` (``csrc/pruning.cu``) at K = 1 and
S = ΣK_d·S_d, which the kernel's runtime-S path takes up to
``MAX_RUNTIME_S``.  This module is the operator assembly around it.  The
dense union operator does (ΣK_d·S_d)² work per pattern and step where each
division alone does K_d·S_d², so the path stays opt-in
(``Engine(stacked=True)`` or ``MB_TPU_STACKED=1``), as in the JAX package.
On CPU tensors the wrapper takes the plain version
(``pruning_down_plain``); there is no fallback from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .pruning_cuda import pruning_down, pruning_down_plain, slot_operands


class PruningCudaStacked:
    """Static wiring of a group of stacked divisions and the callable
    grouped pruning op.

    ``specs``: ``[(tips [n_tips, P_d, S_d], n_cats_d)]`` per member in
    group order, each division's tips with any coding dummy patterns
    already appended.  Calling it maps each chain's (postorder, left,
    right) and the members' transition tensors ``P_list`` (each
    ``[C, n_nodes, K_d, S_d, S_d]``) to the union's (root [C, 1, KS, P],
    logscale [C, P]); ``div_view`` slices member d's (root [C, K_d, S_d,
    P_d], logscale [C, P_d]).  ``launches`` counts kernel launches (never
    plain-version calls).
    """

    def __init__(self, specs, device):
        self.n_tips = specs[0][0].shape[0]
        self.block = []       # (state offset, K_d * S_d, K_d, S_d)
        self.prange = []      # (pattern offset, P_d)
        off = pof = 0
        for tp, k in specs:
            _, P, S = tp.shape
            self.block.append((off, k * S, k, S))
            self.prange.append((pof, P))
            off += k * S
            pof += P
        self.KS, self.P = off, pof
        t = np.zeros((self.n_tips, self.KS, self.P), np.float32)
        for (tp, k), (boff, ks, _, _), (p0, P) in zip(specs, self.block,
                                                      self.prange):
            tt = np.transpose(np.asarray(tp, np.float32), (0, 2, 1))
            t[:, boff:boff + ks, p0:p0 + P] = np.tile(tt, (1, k, 1))
        self.tips = torch.as_tensor(t, device=device)       # [n, KS, P]
        self._eyes = [torch.eye(k, device=device) for _, _, k, _ in
                      self.block]
        self.launches = 0

    def operands(self, order, left, right, P_list):
        """(lr int32 [C, n_int, 2], pstep [C, n_int, 2, 1, KS, KS]): the
        block-diagonal union operators of every step, categories folded
        into each division's block (pruning_pallas.py:774-779)."""
        lr, lch, rch = slot_operands(order, left, right, self.n_tips)
        C, n_int = order.shape
        rows = torch.arange(C, device=order.device)[:, None]
        pstep = P_list[0].new_zeros((C, n_int, 2, 1, self.KS, self.KS))
        for Pd, (boff, ks, k, S), eye_k in zip(P_list, self.block,
                                               self._eyes):
            steps = torch.stack([Pd[rows, lch], Pd[rows, rch]], 2)
            pstep[:, :, :, 0, boff:boff + ks, boff:boff + ks] = torch.einsum(
                "cnhksj,kl->cnhkslj", steps, eye_k).reshape(C, n_int, 2,
                                                            ks, ks)
        return lr, pstep

    def __call__(self, order, left, right, P_list):
        lr, pstep = self.operands(order, left, right, P_list)
        if self.tips.is_cuda:
            out = pruning_down(lr, pstep, self.tips)
            self.launches += 1
            return out
        return pruning_down_plain(lr, pstep, self.tips)

    def div_view(self, root, ls, d: int):
        """(root [C, K_d, S_d, P_d], ls [C, P_d]) of member d from the
        union outputs."""
        boff, ks, k, S = self.block[d]
        p0, P = self.prange[d]
        r = root[:, 0, boff:boff + ks, p0:p0 + P]
        return r.reshape(r.shape[0], k, S, P), ls[:, p0:p0 + P]
