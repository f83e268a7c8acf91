"""The multiwalk down-pass as a hand-written CUDA kernel: one launch for
every (division, chain) walk of the divisions that share a tree.

Counterpart of ``mrbayes_tpu/ops/pruning_pallas.py`` ``_kernel_w``
(launched by ``_pallas_multiwalk``, wired by ``PruningPallasMultiwalk``).
The kernel source is ``csrc/multiwalk.cu``; its header comment records
what bounds it on an H100 and what its design does about that.  It is
built with the single-division kernel by ``pruning_cuda.build``.

The group's operands live in flat buffers laid out by ``MultiwalkLayout``
(a ``pruning_cuda.DivisionLayout`` whose divisions share S; the stacked
path's layout is another): division d keeps its own rate-category count K_d and
pattern count P_d, with no padding of either.  For C chains the buffers
hold, division after division, operators ``[C, n_int, 2, K_d, S, S]``,
tips ``[n_tips, S, P_d]`` (once for all chains), root partials
``[C, K_d, S, P_d]`` and log-scales ``[C, P_d]``; ``div_view`` slices
one division's outputs back out.  All divisions of a group share the
state count S (see ``multiwalk.cu``).

``multiwalk_down`` launches the kernel and takes CUDA tensors only;
``multiwalk_down_plain`` is its plain PyTorch version, the same function
on any device.  ``PruningCudaMultiwalk`` sends a CUDA tensor to the kernel
and a CPU tensor to the plain version; there is no fallback from one to
the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .pruning_cuda import (DivisionLayout, check_cuda_operands,
                           check_kernel_shape, device_index, launch_error,
                           library, pruning_down_plain, slot_operands)


class MultiwalkLayout(DivisionLayout):
    """The layout of a multiwalk group, whose divisions share the state
    count S, and the kernel's table."""

    def __init__(self, n_tips: int, S: int, ks, ps):
        super().__init__(n_tips, ks, [S] * len(ks), ps)
        self.S = S
        self.P_max = max(self.ps)
        self._tables: dict = {}

    def table(self, C: int, device) -> torch.Tensor:
        """The kernel's [D, 7] table on ``device``, made once per C."""
        key = (C, str(device))
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(self.offsets(C)[:-1],
                                                device=device)
        return self._tables[key]


def multiwalk_down(lr: torch.Tensor, pstep: torch.Tensor, tips: torch.Tensor,
                   layout: MultiwalkLayout):
    """Launch the CUDA multiwalk down-pass.  lr int32 [C, n_int, 2] child
    slots per chain, shared by the group's divisions; pstep and tips flat
    f32 in ``layout``.  Returns flat (root, ls).  Raises on anything the
    kernel does not take, and when the launch is refused."""
    C = layout.check(lr, pstep, tips)
    check_cuda_operands("multiwalk_down", lr=lr, pstep=pstep, tips=tips)
    for K in layout.ks:
        check_kernel_shape(layout.S, K, "multiwalk_down")
    if layout.D * C > 65535:
        raise ValueError(f"multiwalk_down takes at most 65535 walks, got "
                         f"{layout.D * C}")
    lib = library("multiwalk").lib
    dev = lr.device
    total = layout.offsets(C)[-1]
    table = layout.table(C, dev)
    scratch = torch.empty(int(total[4]), dtype=torch.float32, device=dev)
    root = torch.empty(int(total[5]), dtype=torch.float32, device=dev)
    ls = torch.empty(int(total[6]), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mb_multiwalk_down(
        lr.data_ptr(), pstep.data_ptr(), tips.data_ptr(), scratch.data_ptr(),
        root.data_ptr(), ls.data_ptr(), table.data_ptr(), layout.D, C,
        layout.n_tips, layout.n_int, layout.S, layout.P_max,
        device_index(dev), stream)
    if err != 0:
        raise launch_error(lib, err, "multiwalk_down")
    return root, ls


def multiwalk_down_plain(lr: torch.Tensor, pstep: torch.Tensor,
                         tips: torch.Tensor, layout: MultiwalkLayout):
    """The plain PyTorch version of ``multiwalk_down``: same operands,
    same flat results, on any device (each division's walks through the
    plain single-division pass)."""
    C = layout.check(lr, pstep, tips)
    roots, lss = [], []
    for d in range(layout.D):
        pst, tp = layout.div_operands(pstep, tips, C, d)
        r, l_ = pruning_down_plain(lr, pst.contiguous(), tp.contiguous())
        roots.append(r.reshape(-1))
        lss.append(l_.reshape(-1))
    return torch.cat(roots), torch.cat(lss)


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
        if self.tips.is_cuda:
            out = multiwalk_down(lr, pstep, self.tips, self.layout)
            self.launches += 1
            return out
        return multiwalk_down_plain(lr, pstep, self.tips, self.layout)

    def div_view(self, root, ls, d: int):
        return self.layout.div_view(root, ls, d)
