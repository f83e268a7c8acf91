"""The multiwalk down-pass as a hand-written CUDA kernel: one launch for
every (division, chain) walk of the divisions that share a tree and a
state count.

Counterpart of ``mrbayes_tpu/ops/pruning_pallas.py`` ``_kernel_w``
(launched by ``_pallas_multiwalk``, wired by ``PruningPallasMultiwalk``).
The kernel source is ``csrc/multiwalk.cu``; its header comment records
what bounds it on an H100 and what its design does about that.  It is
built with the other kernels by ``pruning_cuda.build``.

The launch is the group launch of ``csrc/group_walk.cuh``, shared with
the stacked kernel: one block per (chain, pattern tile of one division),
found through a tile map, each running its division's on-chip walk
(``csrc/onchip_walk.cuh``) in a kernel templated on the group's S; a
division whose slots do not fit takes the global-scratch walk in a second
kernel of the same call.  ``MultiwalkLayout`` (a
``pruning_cuda.GroupLayout`` whose divisions share S) lays the operands
out and plans the launch: division d keeps its own rate-category count
K_d and pattern count P_d, with no padding of either.  For C chains the
flat buffers hold, division after division, operators ``[C, n_int, 2,
K_d, S, S]``, tips ``[n_tips, S, P_d]`` (once for all chains), root
partials ``[C, K_d, S, P_d]`` and log-scales ``[C, P_d]``; ``div_view``
slices one division's outputs back out.

``multiwalk_down`` launches the kernel and takes CUDA tensors only;
``multiwalk_down_plain`` is its plain PyTorch version, the same function
on any device.  ``PruningCudaMultiwalk`` sends a CUDA tensor to the kernel
and a CPU tensor to the plain version; there is no fallback from one to
the other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..spans import SPANS
from .pruning_cuda import GroupLayout, slot_operands


class MultiwalkLayout(GroupLayout):
    """The layout of a multiwalk group, whose divisions share the state
    count S, its launch plan and its launch (``GroupLayout``; the kernel
    is instantiated for S)."""

    library_name = "multiwalk"

    def __init__(self, n_tips: int, S: int, ks, ps):
        super().__init__(n_tips, ks, [S] * len(ks), ps)
        self.S = S

    def plan(self, C: int, device, walk: str | None = None) -> dict:
        """``GroupLayout.plan`` plus the global-scratch kernel's own table
        ``global_table`` [Dg, 7] (K_d, P_d and the offsets of the
        operators, tips, scratch, root and log-scales of each division on
        that walk; None when there is none) and ``global_P_max``."""
        plan = super().plan(C, device, walk)
        if "global_table" not in plan:
            o = self.offsets(C)
            rows, scratch = [], 0
            for d, w in enumerate(plan["walks"]):
                if w == "global":
                    rows.append([o[d, 0], o[d, 1], o[d, 2], o[d, 3], scratch,
                                 o[d, 5], o[d, 6]])
                    scratch += C * self.n_int * self.ks[d] * self.S * self.ps[d]
            if len(rows) * C > 65535:
                raise ValueError(f"multiwalk_down takes at most 65535 "
                                 f"global-scratch walks, got {len(rows) * C}")
            plan["global_table"] = torch.as_tensor(
                np.asarray(rows, np.int64), device=plan["table"].device) \
                if rows else None
            plan["global_P_max"] = max((r[1] for r in rows), default=0)
        return plan

    def launch_args(self, plan) -> list:
        g = plan["global_table"]
        return [None if g is None else g.data_ptr(), plan["n_onchip"],
                0 if g is None else g.shape[0], plan["global_P_max"], self.S]


def multiwalk_down(lr: torch.Tensor, pstep: torch.Tensor, tips: torch.Tensor,
                   layout: MultiwalkLayout):
    """Launch the CUDA multiwalk down-pass.  lr int32 [C, n_int, 2] child
    slots per chain, shared by the group's divisions; pstep and tips flat
    f32 in ``layout``.  Returns flat (root, ls).  Raises on anything the
    kernel does not take, and when the launch is refused."""
    return layout.down(lr, pstep, tips)


def multiwalk_down_plain(lr: torch.Tensor, pstep: torch.Tensor,
                         tips: torch.Tensor, layout: MultiwalkLayout):
    """The plain PyTorch version of ``multiwalk_down``: same operands,
    same flat results, on any device (each division's walks through the
    plain single-division pass)."""
    return layout.down_plain(lr, pstep, tips)


class PruningCudaMultiwalk:
    """Static wiring of a group of divisions that share the tree, and the
    callable grouped pruning op: the counterpart of
    ``PruningPallasMultiwalk``.

    ``specs``: ``[(tips [n_tips, P_d, S], n_cats_d)]`` per member, all
    with the same S.  Calling it maps each chain's (postorder, left, right)
    and the members' transition tensors ``P_list`` (each
    ``[C, n_nodes, K_d, S, S]``) to flat (root, ls); ``div_view`` slices
    member d's (root [C, K_d, S, P_d], logscale [C, P_d]).  ``launches``
    counts kernel launches (never plain-version calls).
    """

    def __init__(self, specs, device):
        n_tips = specs[0][0].shape[0]
        states = {tp.shape[2] for tp, _ in specs}
        if len(states) != 1:
            raise ValueError(f"a multiwalk group shares one state count, "
                             f"got {sorted(states)}")
        S = states.pop()
        self.layout = MultiwalkLayout(n_tips, S, [k for _, k in specs],
                                      [tp.shape[1] for tp, _ in specs])
        self.n_tips = n_tips
        self.tips = torch.as_tensor(np.concatenate(
            [np.transpose(np.asarray(tp, np.float32), (0, 2, 1)).ravel()
             for tp, _ in specs]), device=device)
        self.launches = 0

    def operands(self, order, left, right, P_list):
        """(lr int32 [C, n_int, 2], flat pstep) for the group."""
        lr, lch, rch = slot_operands(order, left, right, self.n_tips)
        rows = torch.arange(order.shape[0], device=order.device)[:, None]
        pstep = torch.cat([torch.stack([Pm[rows, lch], Pm[rows, rch]],
                                       2).reshape(-1) for Pm in P_list])
        return lr, pstep

    def __call__(self, order, left, right, P_list):
        lr, pstep = self.operands(order, left, right, P_list)
        with SPANS("gen.lnl.launch"):
            if self.tips.is_cuda:
                out = multiwalk_down(lr, pstep, self.tips, self.layout)
                self.launches += 1
                return out
            return multiwalk_down_plain(lr, pstep, self.tips, self.layout)

    def div_view(self, root, ls, d: int):
        return self.layout.div_view(root, ls, d)
