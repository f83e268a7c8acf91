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

``wavefront_schedule`` builds the rows on the device, batched over chains
(the port of ``PruningPallasWavefront.__call__``); the row count stays a
device tensor ``nrows [C]`` that the kernel reads, so the schedule never
makes the host wait.  Padded row entries point at a trash slot
(n_tips + n_int), take the zero operator ``bidx = n_int`` and have
``wmask = 0``.

``wavefront_down`` launches the kernel and takes CUDA tensors only;
``wavefront_down_plain`` is its plain PyTorch version, the same function
on any device.  ``PruningCudaWavefront`` sends a CUDA tensor to the kernel
and a CPU tensor to the plain version; there is no fallback from one to
the other.
"""
from __future__ import annotations

import torch

from .pruning_cuda import (PruningCuda, check_cuda_operands,
                           check_kernel_shape, device_index, launch_error,
                           library, slot_operands)
from .traversal import node_depths

_TINY = 1e-30
W_DEFAULT = 8        # row width, as mrbayes_tpu/ops/pruning.py:48
MAX_W = 16           # blockDim.y of the kernel


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


def wavefront_schedule(order, left, right, parent, n_tips: int, W: int):
    """The rows of every chain's tree, on the device.

    order [C, n_int] (children before parents, by decreasing depth, as
    ``postorder_internal`` gives it); left/right/parent [C, n_nodes].
    Returns (nrows int32 [C], row_lr int32 [C, R*W, 2] child slots,
    row_out int32 [C, R*W] output slots, bidx int32 [C, R*W] operator rows,
    wmask f32 [C, R*W], left children [C, n_int], right children
    [C, n_int]) with R = n_int rows of room.  Entry r*W + w of a row holds
    the node at order position i, whose operators are row i of the step
    operators."""
    C, n_int = order.shape
    dev = order.device
    d = node_depths(parent).gather(1, order)          # non-increasing
    pos = torch.arange(n_int, device=dev).expand(C, -1)
    first = torch.ones_like(d, dtype=torch.bool)
    first[:, 1:] = d[:, 1:] != d[:, :-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=1).values
    within = pos - start
    row = torch.cumsum((first | (within % W == 0)).long(), 1) - 1
    flat = row * W + within % W                      # [C, n_int], distinct
    nrows = (row[:, -1] + 1).to(torch.int32)
    lr, lch, rch = slot_operands(order, left, right, n_tips)
    trash = n_tips + n_int
    RW = n_int * W
    steps = torch.arange(n_int, dtype=torch.int32, device=dev).expand(C, -1)
    row_lr = torch.full((C, RW, 2), trash, dtype=torch.int32, device=dev)
    row_lr.scatter_(1, flat[..., None].expand(-1, -1, 2), lr)
    row_out = torch.full((C, RW), trash, dtype=torch.int32, device=dev)
    row_out.scatter_(1, flat, steps + n_tips)
    bidx = torch.full((C, RW), n_int, dtype=torch.int32, device=dev)
    bidx.scatter_(1, flat, steps)
    wmask = torch.zeros((C, RW), dtype=torch.float32, device=dev)
    wmask.scatter_(1, flat, 1.0)
    return nrows, row_lr, row_out, bidx, wmask, lch, rch


def _check_operands(nrows, row_lr, row_out, bidx, wmask, pstep, tips, W):
    for name, t in (("nrows", nrows), ("row_lr", row_lr),
                    ("row_out", row_out), ("bidx", bidx)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if wmask.dtype != torch.float32 or pstep.dtype != torch.float32 \
            or tips.dtype != torch.float32:
        raise TypeError("wmask, pstep and tips must be float32")
    if not 1 <= W <= MAX_W:
        raise ValueError(f"row width W must be in [1, {MAX_W}], got {W}")
    if pstep.ndim != 6 or pstep.shape[2] != 2 \
            or pstep.shape[4] != pstep.shape[5]:
        raise ValueError(f"pstep must be [C, n_int + 1, 2, K, S, S], got "
                         f"{tuple(pstep.shape)}")
    C, n_int = pstep.shape[0], pstep.shape[1] - 1
    K, S = pstep.shape[3], pstep.shape[4]
    if tips.ndim != 3 or tips.shape[1] != S or tips.shape[0] != n_int + 1:
        raise ValueError(f"tips must be [n_int + 1, S, P] = [{n_int + 1}, "
                         f"{S}, P], got {tuple(tips.shape)}")
    n_tips, _, P = tips.shape
    RW = n_int * W
    if nrows.shape != (C,):
        raise ValueError(f"nrows must be [{C}], got {tuple(nrows.shape)}")
    if row_lr.shape != (C, RW, 2):
        raise ValueError(f"row_lr must be [{C}, {RW}, 2], got "
                         f"{tuple(row_lr.shape)}")
    for name, t in (("row_out", row_out), ("bidx", bidx), ("wmask", wmask)):
        if t.shape != (C, RW):
            raise ValueError(f"{name} must be [{C}, {RW}], got "
                             f"{tuple(t.shape)}")
    return C, n_int, K, S, n_tips, P


def wavefront_down(nrows, row_lr, row_out, bidx, wmask, pstep, tips,
                   W: int = W_DEFAULT):
    """Launch the CUDA wavefront down-pass on a schedule from
    ``wavefront_schedule`` and step operators pstep f32 [C, n_int + 1, 2,
    K, S, S] (row n_int zero); tips f32 [n_tips, S, P].  Returns (root
    [C, K, S, P], ls [C, P]).  Raises on anything the kernel does not
    take, and when the launch is refused."""
    C, n_int, K, S, n_tips, P = _check_operands(
        nrows, row_lr, row_out, bidx, wmask, pstep, tips, W)
    check_cuda_operands("wavefront_down", nrows=nrows, row_lr=row_lr,
                        row_out=row_out, bidx=bidx, wmask=wmask,
                        pstep=pstep, tips=tips)
    check_kernel_shape(S, K, "wavefront_down")
    lib = library("wavefront").lib
    dev = pstep.device
    scratch = torch.empty((C, n_int, K, S, P), dtype=torch.float32,
                          device=dev)
    root = torch.empty((C, K, S, P), dtype=torch.float32, device=dev)
    ls = torch.empty((C, P), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mb_wavefront_down(
        nrows.data_ptr(), row_lr.data_ptr(), row_out.data_ptr(),
        bidx.data_ptr(), wmask.data_ptr(), pstep.data_ptr(),
        tips.data_ptr(), scratch.data_ptr(), root.data_ptr(), ls.data_ptr(),
        C, n_tips, n_int, n_int, W, K, S, P,
        device_index(dev),
        stream)
    if err != 0:
        raise launch_error(lib, err, "wavefront_down")
    return root, ls


def wavefront_down_plain(nrows, row_lr, row_out, bidx, wmask, pstep, tips,
                         W: int = W_DEFAULT):
    """The plain PyTorch version of ``wavefront_down``: same operands, same
    results, on any device.  It follows the TPU kernel literally: padded
    entries compute from the trash slot (kept finite, ones at the start,
    pruning_pallas.py:497-499) with the zero operator, and their
    log-scales are selected away."""
    C, n_int, K, S, n_tips, P = _check_operands(
        nrows, row_lr, row_out, bidx, wmask, pstep, tips, W)
    rows = torch.arange(C, device=tips.device)[:, None]
    cl = tips.new_empty((C, n_tips + n_int + 1, K, S, P))
    cl[:, :n_tips] = tips[None, :, None]
    cl[:, -1] = 1.0
    ls = tips.new_zeros((C, P))
    lr = row_lr.long().view(C, n_int, W, 2)
    out = row_out.long().view(C, n_int, W)
    b = bidx.long().view(C, n_int, W)
    mask = wmask.view(C, n_int, W)
    # rows past a chain's nrows hold only padded entries
    for r in range(int(nrows.max())):
        wl = torch.einsum("cwksj,cwkjp->cwksp", pstep[rows, b[:, r], 0],
                          cl[rows, lr[:, r, :, 0]])
        wr = torch.einsum("cwksj,cwkjp->cwksp", pstep[rows, b[:, r], 1],
                          cl[rows, lr[:, r, :, 1]])
        x = wl * wr
        m = torch.clamp_min(x.amax(dim=(2, 3)), _TINY)          # [C, W, P]
        cl[rows, out[:, r]] = x / m[:, :, None, None]
        ls = ls + torch.where(mask[:, r, :, None] > 0.0, torch.log(m),
                              0.0).sum(1)
    return cl[:, n_tips + n_int - 1], ls


class PruningCudaWavefront(PruningCuda):
    """Per-division wiring of the wavefront pass: the counterpart of
    ``PruningPallasWavefront``.  Calling it maps each chain's (postorder,
    left, right, P-tensor) to (root partials [C, K, S, P], logscale
    [C, P]), like ``PruningCuda``; the schedule's node depths come from
    the parent array that left/right imply.  ``launches`` counts kernel
    launches (never plain-version calls)."""

    def __init__(self, tips, n_cats: int, device, W: int = W_DEFAULT):
        super().__init__(tips, n_cats, device)
        if not 1 <= W <= MAX_W:
            raise ValueError(f"row width W must be in [1, {MAX_W}]")
        self.W = W

    def operands(self, order, left, right, Pmat):
        """(nrows, row_lr, row_out, bidx, wmask, pstep [C, n_int + 1, 2,
        K, S, S]) from the chains' trees and Pmat [C, n_nodes, K, S, S]."""
        parent = parent_from_children(left, right, self.n_tips)
        nrows, row_lr, row_out, bidx, wmask, lch, rch = wavefront_schedule(
            order, left, right, parent, self.n_tips, self.W)
        C, n_int = order.shape
        rows = torch.arange(C, device=order.device)[:, None]
        pstep = Pmat.new_zeros((C, n_int + 1, 2) + Pmat.shape[2:])
        pstep[:, :n_int, 0] = Pmat[rows, lch]
        pstep[:, :n_int, 1] = Pmat[rows, rch]
        return nrows, row_lr, row_out, bidx, wmask, pstep

    def __call__(self, order, left, right, Pmat):
        ops = self.operands(order, left, right, Pmat)
        if self.tips.is_cuda:
            out = wavefront_down(*ops, self.tips, self.W)
            self.launches += 1
            return out
        return wavefront_down_plain(*ops, self.tips, self.W)
