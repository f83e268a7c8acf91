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
(``pruning_cuda.DivisionLayout``), division after division with no
padding: operators ``[C, n_int, 2, K_d,
S_d, S_d]``, tips ``[n_tips, S_d, P_d]`` (once for all chains), root
partials ``[C, K_d, S_d, P_d]`` and log-scales ``[C, P_d]``.  The kernel
reads them through a per-division table and a tile map made once per
chain count on the device.

The path stays opt-in (``Engine(stacked=True)`` or ``MB_TPU_STACKED=1``),
as in the JAX package.  ``stacked_down`` launches the kernel and takes
CUDA tensors only; ``stacked_down_plain`` is its plain PyTorch version
(each member through ``pruning_down_plain``).  ``PruningCudaStacked``
sends a CUDA tensor to the kernel and a CPU tensor to the plain version;
there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .pruning_cuda import (WALKS, DivisionLayout, check_cuda_operands,
                           check_kernel_shape, device_index, launch_error,
                           library, pruning_down_plain, slot_operands)


class StackedLayout(DivisionLayout):
    """The layout of a stacked group (each member its own K_d, S_d and
    P_d) and the kernel's launch plan per (C, device)."""

    def __init__(self, n_tips: int, ks, ss, ps):
        super().__init__(n_tips, ks, ss, ps)
        self._plans: dict = {}

    def plan(self, C: int, device) -> dict:
        """The kernel's launch plan on ``device``, asked of the kernel
        library once per C: the size rule's ``threads`` a block and its
        shared memory ``smem_bytes``, each member's ``walks``, patterns a
        block ``T`` and ``lanes`` a pattern; the kernel's ``table``
        [D, 10] (K_d, S_d, P_d, the offsets of operators, tips, root, ls
        and scratch, the walk, the lanes) and tile map ``tiles``
        [n_tiles, 2] (member, first pattern) on the device: the
        ``n_onchip`` tiles of the on-chip walks, the costliest members
        first, then the ``n_global`` tiles of the global-scratch walk; and
        the ``scratch`` floats of the members that take that walk."""
        dev = torch.device(device)
        key = (C, device_index(dev))
        if key not in self._plans:
            lib = library("stacked").lib
            kps = np.ascontiguousarray(
                np.stack([self.ks, self.ss, self.ps], 1), np.int32)
            D = self.D
            out = (ctypes.c_int * (2 + 3 * D))()
            err = lib.mb_stacked_plan(kps.ctypes.data, D, C, self.n_tips,
                                      key[1], out)
            if err != 0:
                raise launch_error(lib, err, "stacked_plan")
            walks, T, G = (list(out[2 + j * D:2 + (j + 1) * D])
                           for j in range(3))
            o = self.offsets(C)
            table, scratch = [], 0
            for d, (K, S, P) in enumerate(zip(self.ks, self.ss, self.ps)):
                table.append([K, S, P, *o[d, [2, 3, 5, 6]], scratch,
                              walks[d], G[d]])
                if WALKS[walks[d]] == "global":
                    scratch += C * self.n_int * K * S * P
            names = [WALKS[w] for w in walks]
            tiles, n_onchip = self.tile_map(names, T)
            self._plans[key] = {
                "threads": out[0], "smem_bytes": out[1],
                "walks": names, "T": T, "lanes": G,
                "table": torch.as_tensor(np.asarray(table, np.int64),
                                         device=dev),
                "tiles": torch.as_tensor(tiles, device=dev),
                "n_onchip": n_onchip, "n_global": len(tiles) - n_onchip,
                "scratch": scratch}
        return self._plans[key]

    def tile_map(self, walks, T):
        """The tile map for members' ``walks`` (names) and patterns a block
        ``T``: int32 [n_tiles, 2] (member, first pattern), the on-chip
        kernel's tiles first, the costliest members' (K_d * S_d^2 a step
        and pattern) leading so that their walks start first, then the
        global-scratch kernel's; and the count of on-chip tiles."""
        costly = sorted(range(self.D),
                        key=lambda d: -self.ks[d] * self.ss[d] ** 2)
        onchip = [(d, p0) for d in costly if walks[d] != "global"
                  for p0 in range(0, self.ps[d], T[d])]
        tiles = onchip + [(d, p0) for d in range(self.D)
                          if walks[d] == "global"
                          for p0 in range(0, self.ps[d], T[d])]
        if len(tiles) > 65535:
            raise ValueError(f"stacked_down takes at most 65535 pattern "
                             f"tiles, got {len(tiles)}")
        return np.asarray(tiles, np.int32).reshape(-1, 2), len(onchip)


def stacked_down(lr: torch.Tensor, pstep: torch.Tensor, tips: torch.Tensor,
                 layout: StackedLayout):
    """Launch the CUDA stacked down-pass.  lr int32 [C, n_int, 2] child
    slots per chain, shared by the group's members; pstep and tips flat
    f32 in ``layout``.  Returns flat (root, ls).  Raises on anything the
    kernel does not take, and when the launch is refused."""
    C = layout.check(lr, pstep, tips)
    check_cuda_operands("stacked_down", lr=lr, pstep=pstep, tips=tips)
    for K, S in zip(layout.ks, layout.ss):
        check_kernel_shape(S, K, "stacked_down")
    lib = library("stacked").lib
    dev = lr.device
    plan = layout.plan(C, dev)
    total = layout.offsets(C)[-1]
    scratch = torch.empty(plan["scratch"], dtype=torch.float32, device=dev) \
        if plan["scratch"] else None
    root = torch.empty(int(total[5]), dtype=torch.float32, device=dev)
    ls = torch.empty(int(total[6]), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mb_stacked_down(
        lr.data_ptr(), pstep.data_ptr(), tips.data_ptr(),
        None if scratch is None else scratch.data_ptr(), root.data_ptr(),
        ls.data_ptr(), plan["table"].data_ptr(), plan["tiles"].data_ptr(),
        plan["n_onchip"], plan["n_global"], C, layout.n_tips, layout.n_int,
        plan["threads"], plan["smem_bytes"], device_index(dev), stream)
    if err != 0:
        raise launch_error(lib, err, "stacked_down")
    return root, ls


def stacked_down_plain(lr: torch.Tensor, pstep: torch.Tensor,
                       tips: torch.Tensor, layout: StackedLayout):
    """The plain PyTorch version of ``stacked_down``: same operands, same
    flat results, on any device (each member's walks through the plain
    single-division pass, which is what the union computes per member)."""
    C = layout.check(lr, pstep, tips)
    roots, lss = [], []
    for d in range(layout.D):
        pst, tp = layout.div_operands(pstep, tips, C, d)
        r, l_ = pruning_down_plain(lr, pst.contiguous(), tp.contiguous())
        roots.append(r.reshape(-1))
        lss.append(l_.reshape(-1))
    return torch.cat(roots), torch.cat(lss)


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
        if self.tips.is_cuda:
            out = stacked_down(lr, pstep, self.tips, self.layout)
            self.launches += 1
            return out
        return stacked_down_plain(lr, pstep, self.tips, self.layout)

    def div_view(self, root, ls, d: int):
        """(root [C, K_d, S_d, P_d], ls [C, P_d]) of member d from the flat
        outputs."""
        return self.layout.div_view(root, ls, d)
