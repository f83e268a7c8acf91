"""The level-batched (wavefront) down-pass as a hand-written CUDA kernel.

Counterpart of ``mrbayes_tpu/ops/pruning_pallas.py`` ``_kernel_wavefront``
(launched by ``_pallas_batched_wavefront``, wired by
``PruningPallasWavefront``).  Instead of one dependent step per internal
node, the internal nodes of each chain's tree are grouped by root distance
into rows of up to W nodes; every node of a row depends only on earlier
rows, so the dependent chain shrinks from n_int steps to about the tree's
height.  The kernel source is ``csrc/wavefront.cu``; its header comment
records what bounds it on an H100 and what its design does about that.
It is built with the other kernels by ``pruning_cuda.build``.

The kernel takes ``pruning_cuda.pruning_down``'s operands (``lr``
[C, n_int, 2] child slots, ``pstep`` [C, n_int, 2, K, S, S], tips) and
builds the rows itself, in each block, from ``lr`` alone: each step's
depth (by pointer jumping), runs of one depth split at W, deepest first,
and a stable counting sort by decreasing depth.  Its partials live in
shared-memory slots, one a cherry (a step whose children are both tips):
every other step writes its first internal child's slot.
``row_schedule`` and ``chain_slot_map`` are the numpy twins of the rows
and the slots.  So the wiring's operands are ``PruningCuda.operands``: no
schedule is built by PyTorch ops on the CUDA path.

``wavefront_down`` launches the kernel and takes CUDA tensors only;
``wavefront_down_plain`` is its plain PyTorch version, the same function
on any device, which follows the TPU kernel literally: the schedule of
``wavefront_schedule`` (``PruningPallasWavefront.__call__``'s, with its
trash slot, zero operator and masks) over a zero-padded operator tensor.
``PruningCudaWavefront`` sends a CUDA tensor to the kernel and a CPU
tensor to the plain version; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..spans import SPANS
from .pruning_cuda import (WALKS, PruningCuda, check_step_operands,
                           check_cuda_operands, check_kernel_shape,
                           device_index, launch_error, library)
from .traversal import node_depths

_TINY = 1e-30
W_DEFAULT = 8        # row width, as mrbayes_tpu/ops/pruning.py:48
MAX_W = 16           # kMaxW of the kernel


def parent_from_children(left, right, n_tips: int):
    """parent [C, n_nodes] (-1 at the root) from left/right [C, n_nodes]:
    one scatter per side over the internal nodes, on the device."""
    n = left.shape[-1]
    ids = torch.arange(n_tips, n, dtype=left.dtype,
                       device=left.device).expand(left.shape[0], -1)
    parent = torch.full_like(left, -1)
    parent.scatter_(1, left[:, n_tips:], ids)
    parent.scatter_(1, right[:, n_tips:], ids)
    return parent


def step_depths(lr, n_tips: int):
    """Each step's root distance [C, n_int] from child slots lr
    [C, n_int, 2] (slot n_tips + i is step i's output; the last step is
    the root), on the device: the parent of every slot, then
    ``node_depths``."""
    C = lr.shape[0]
    lr = lr.long()
    pad = lr.new_zeros((C, n_tips))
    parent = parent_from_children(torch.cat([pad, lr[..., 0]], 1),
                                  torch.cat([pad, lr[..., 1]], 1), n_tips)
    return node_depths(parent)[:, n_tips:]


def wavefront_schedule(lr, n_tips: int, W: int):
    """The rows of every chain's tree, on the device: the port of
    ``PruningPallasWavefront.__call__``'s schedule (pruning_pallas.py:
    642-689), with the steps first sorted stably by decreasing depth (the
    identity on ``postorder_internal``'s order, whose rows are then JAX's
    exactly).

    lr [C, n_int, 2] child slots.  Returns (nrows int32 [C], row_lr int32
    [C, R*W, 2] child slots, row_out int32 [C, R*W] output slots, bidx
    int32 [C, R*W] operator rows, wmask f32 [C, R*W]) with R = n_int rows
    of room.  Entry r*W + w of a row holds step i (its operators row i of
    the step operators, its output slot n_tips + i); padded entries point
    at the trash slot n_tips + n_int, take the zero operator row n_int and
    have wmask 0."""
    C, n_int = lr.shape[:2]
    dev = lr.device
    depth = step_depths(lr, n_tips)
    order = torch.argsort(-depth, dim=1, stable=True)     # steps, by row
    d = depth.gather(1, order)                             # non-increasing
    pos = torch.arange(n_int, device=dev).expand(C, -1)
    first = torch.ones_like(d, dtype=torch.bool)
    first[:, 1:] = d[:, 1:] != d[:, :-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=1).values
    within = pos - start
    row = torch.cumsum((first | (within % W == 0)).long(), 1) - 1
    flat = row * W + within % W                      # [C, n_int], distinct
    nrows = (row[:, -1] + 1).to(torch.int32)
    trash = n_tips + n_int
    RW = n_int * W
    steps = order.to(torch.int32)
    row_lr = torch.full((C, RW, 2), trash, dtype=torch.int32, device=dev)
    row_lr.scatter_(1, flat[..., None].expand(-1, -1, 2),
                    lr.gather(1, order[..., None].expand(-1, -1, 2)))
    row_out = torch.full((C, RW), trash, dtype=torch.int32, device=dev)
    row_out.scatter_(1, flat, steps + n_tips)
    bidx = torch.full((C, RW), n_int, dtype=torch.int32, device=dev)
    bidx.scatter_(1, flat, steps)
    wmask = torch.zeros((C, RW), dtype=torch.float32, device=dev)
    wmask.scatter_(1, flat, 1.0)
    return nrows, row_lr, row_out, bidx, wmask


def row_schedule(lr, n_tips: int, W: int):
    """The numpy twin of the kernel's in-block schedule
    (``csrc/wavefront.cu:build_rows``) for one chain's child slots lr
    [n_int, 2]: each step's parent and its depth (the root, the last step,
    at 0; the kernel jumps pointers, one reverse pass gives the same), a
    stable counting sort by decreasing depth, and rows as runs of one
    depth split at W.  Returns (seq
    [n_int], the steps in row order; rowbeg [nrows + 1], the first
    position of each row in seq)."""
    lr = np.asarray(lr)
    n_int = lr.shape[0]
    par = np.empty(n_int, np.int64)
    for i, children in enumerate(lr):
        for c in children:
            if c >= n_tips:
                par[c - n_tips] = i
    depth = np.zeros(n_int, np.int64)
    cnt = np.zeros(n_int, np.int64)
    cnt[0] = 1
    for i in range(n_int - 2, -1, -1):
        depth[i] = depth[par[i]] + 1
        cnt[depth[i]] += 1
    start = np.zeros(n_int, np.int64)
    rowbeg, q = [], 0
    for d in range(int(depth.max()), -1, -1):
        start[d] = q
        rowbeg.extend(q + k for k in range(0, int(cnt[d]), W))
        q += int(cnt[d])
    rowbeg.append(n_int)
    seq = np.empty(n_int, np.int64)
    seen = np.zeros(n_int, np.int64)
    for i in range(n_int):
        seq[start[depth[i]] + seen[depth[i]]] = i
        seen[depth[i]] += 1
    return seq, np.asarray(rowbeg, np.int64)


def chain_slot_map(lr, n_tips: int) -> np.ndarray:
    """The numpy twin of the kernel's slot map (``csrc/wavefront.cu:
    build_rows``) for one chain's child slots lr [n_int, 2]: a step whose
    children are both tips (a cherry) takes a slot of its own, numbered by
    the cherries' order in the steps, and every other step writes the slot
    of its first internal child (left, else right), which only it reads.
    Returns step i's shared-memory slot [n_int] int64 (-1 at the root,
    which writes the root partials); there are at most n_tips // 2."""
    lr = np.asarray(lr)
    n_int = lr.shape[0]
    slot = np.empty(n_int, np.int64)
    cherries = 0
    for i, (c0, c1) in enumerate(lr):
        first = c0 if c0 >= n_tips else c1
        if first >= n_tips:
            slot[i] = slot[first - n_tips]
        else:
            slot[i] = cherries
            cherries += 1
    slot[n_int - 1] = -1
    return slot


def wavefront_plan(C: int, n_tips: int, K: int, S: int, P: int, W: int,
                   device) -> dict:
    """The kernel's plan for one launch (``csrc/wavefront.cu``), asked of
    the kernel library once per shape and device: ``walk`` ("whole": the
    chain's operators on chip; "staged": a row's operators copied a row
    ahead), the ``threads`` of a block (``groups`` row-slot groups of
    whole warps, each running the row's steps it is given one after
    another), the patterns ``T`` it covers, the ``lanes`` of a pattern and
    its dynamic shared memory ``smem_bytes``.  Raises ValueError where no block holds
    the shape's slots."""
    return _plan(C, n_tips, K, S, P, W, device_index(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _plan(C, n_tips, K, S, P, W, dev):
    lib = library("wavefront").lib
    out = (ctypes.c_int * 6)()
    err = lib.mb_wavefront_plan(C, n_tips, K, S, P, W, dev, out)
    if err == 1:            # cudaErrorInvalidValue
        raise ValueError(f"wavefront_down: no block of the device holds "
                         f"the slots of n_tips={n_tips}, K={K}, S={S} at "
                         f"W={W}")
    if err != 0:
        raise launch_error(lib, err, "wavefront_plan")
    return {"walk": WALKS[out[0]], "threads": out[1], "smem_bytes": out[2],
            "T": out[3], "lanes": out[4], "groups": out[5]}


def wavefront_launch(lr, pstep, tips, root, ls, W: int, plan) -> int:
    """One launch of ``csrc/wavefront.cu`` on preallocated outputs as
    ``plan`` (``wavefront_plan``) says, on the current stream of the
    operands' device.  Returns the CUDA error code (0 = success)."""
    C, n_int = lr.shape[:2]
    K, S = pstep.shape[3:5]
    n_tips, _, P = tips.shape
    dev = lr.device
    return library("wavefront").lib.mb_wavefront_down(
        lr.data_ptr(), pstep.data_ptr(), tips.data_ptr(), root.data_ptr(),
        ls.data_ptr(), C, n_tips, n_int, K, S, P, W,
        WALKS.index(plan["walk"]), plan["threads"], plan["smem_bytes"],
        plan["T"], plan["lanes"], plan["groups"], device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)


def _check_width(W: int):
    if not 1 <= W <= MAX_W:
        raise ValueError(f"row width W must be in [1, {MAX_W}], got {W}")


def wavefront_down(lr, pstep, tips, W: int = W_DEFAULT):
    """Launch the CUDA wavefront down-pass on ``pruning_down``'s operands:
    lr int32 [C, n_int, 2] child slots (any children-before-parents
    order, the root last), pstep f32 [C, n_int, 2, K, S, S], tips f32
    [n_tips, S, P].  Returns (root [C, K, S, P], ls [C, P]).  Raises on
    anything the kernel does not take, and when the launch is refused."""
    C, n_int, K, S, n_tips, P = check_step_operands(lr, pstep, tips)
    _check_width(W)
    check_cuda_operands("wavefront_down", lr=lr, pstep=pstep, tips=tips)
    check_kernel_shape(S, K, "wavefront_down")
    dev = lr.device
    plan = wavefront_plan(C, n_tips, K, S, P, W, dev)
    root = torch.empty((C, K, S, P), dtype=torch.float32, device=dev)
    ls = torch.empty((C, P), dtype=torch.float32, device=dev)
    err = wavefront_launch(lr, pstep, tips, root, ls, W, plan)
    if err != 0:
        raise launch_error(library("wavefront").lib, err, "wavefront_down")
    return root, ls


def wavefront_down_plain(lr, pstep, tips, W: int = W_DEFAULT):
    """The plain PyTorch version of ``wavefront_down``: same operands, same
    results, on any device.  It follows the TPU kernel literally: the
    schedule of ``wavefront_schedule``, the operators padded with a zero
    row, padded entries computing from a trash slot (kept finite, ones at
    the start, pruning_pallas.py:497-499) with the zero operator, and
    their log-scales selected away."""
    C, n_int, K, S, n_tips, P = check_step_operands(lr, pstep, tips)
    _check_width(W)
    nrows, row_lr, row_out, bidx, wmask = wavefront_schedule(lr, n_tips, W)
    bstep = pstep.new_zeros((C, n_int + 1, 2, K, S, S))
    bstep[:, :n_int] = pstep
    rows = torch.arange(C, device=tips.device)[:, None]
    cl = tips.new_empty((C, n_tips + n_int + 1, K, S, P))
    cl[:, :n_tips] = tips[None, :, None]
    cl[:, -1] = 1.0
    ls = tips.new_zeros((C, P))
    lrw = row_lr.long().view(C, n_int, W, 2)
    out = row_out.long().view(C, n_int, W)
    b = bidx.long().view(C, n_int, W)
    mask = wmask.view(C, n_int, W)
    # rows past a chain's nrows hold only padded entries
    for r in range(int(nrows.max())):
        wl = torch.einsum("cwksj,cwkjp->cwksp", bstep[rows, b[:, r], 0],
                          cl[rows, lrw[:, r, :, 0]])
        wr = torch.einsum("cwksj,cwkjp->cwksp", bstep[rows, b[:, r], 1],
                          cl[rows, lrw[:, r, :, 1]])
        x = wl * wr
        m = torch.clamp_min(x.amax(dim=(2, 3)), _TINY)          # [C, W, P]
        cl[rows, out[:, r]] = x / m[:, :, None, None]
        ls = ls + torch.where(mask[:, r, :, None] > 0.0, torch.log(m),
                              0.0).sum(1)
    return cl[:, n_tips + n_int - 1], ls


class PruningCudaWavefront(PruningCuda):
    """Per-division wiring of the wavefront pass: the counterpart of
    ``PruningPallasWavefront``.  Its operands are ``PruningCuda``'s
    (the kernel builds its rows from ``lr``); calling it maps each chain's
    (postorder, left, right, P-tensor) to (root partials [C, K, S, P],
    logscale [C, P]).  ``launches`` counts kernel launches (never
    plain-version calls)."""

    def __init__(self, tips, n_cats: int, device, W: int = W_DEFAULT):
        super().__init__(tips, n_cats, device)
        _check_width(W)
        self.W = W

    def __call__(self, order, left, right, Pmat):
        lr, pstep = self.operands(order, left, right, Pmat)
        with SPANS("gen.lnl.launch"):
            if self.tips.is_cuda:
                out = wavefront_down(lr, pstep, self.tips, self.W)
                self.launches += 1
                return out
            return wavefront_down_plain(lr, pstep, self.tips, self.W)
