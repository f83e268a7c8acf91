"""Site-pattern sharding of one division's pruning pass (the ``sites``
mesh axis).

Counterpart of ``mrbayes_tpu/ops/pruning_pallas.py``
``PruningPallasSharded`` (``:429-465``), which runs the fused down-pass
``_kernel_g`` per device on that device's block of the pattern axis under
``shard_map``, with ``lr`` and the operators replicated, and leaves the
pattern-weighted root sum to GSPMD's psum.  Here shard j owns the
contiguous slice ``[n_tips, S, P/k]`` of the division's tips on its own
device; a call computes the slot relabelling and the per-step operators
once on the engine's device (as ``PruningCuda.operands`` does), sends them
to each shard's device with ``.to(dev, non_blocking=True)`` (no copy when
the device is the engine's) and launches ``pruning_cuda.pruning_down``
(``csrc/pruning.cu``) once per shard on that device's current stream.

There is no kernel of its own: the work per shard is ``pruning.cu``'s.
The new part is the wiring and the reduction.  ``loglik`` reduces each
shard's root partials to the per-chain sum Σ_p w_p ln L_p on the shard's
own device (``pruning.site_loglik_from_root``, the root reduction of every
path); only those ``[C]`` partial sums cross devices, and they are added
on the engine's device in shard order (the port's psum).  Under an
ascertainment coding the pruner also owns the division's S one-hot dummy
patterns, as a ``PruningCuda`` over [n_tips, S, S] on the engine's device:
their pass is not sharded (mrbayes_tpu/ops/pruning.py:288-303 runs it as
a scan; here it is one more ``pruning.cu`` launch), and ``loglik``
subtracts the correction it gives.

A mesh may name one device several times (``[cuda:0] * 4`` is four shards
on one card: four launches on pattern slices, then the reduction), or
``["cpu"] * k`` on the CPU, where each shard takes the plain version
``pruning_down_plain``.  A CUDA shard launches the kernel; there is no
fallback from one to the other, and devices of another type than the
engine's raise.
"""
from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from ..spans import SPANS
from .pruning import coding_correction, site_loglik_from_root
from .pruning_cuda import PruningCuda, pruning_down, pruning_down_plain


class Shards:
    """An array cut along its pattern axis into k contiguous slices of
    equal length, slice j on shard j's device: the port's form of a tensor
    placed under ``PartitionSpec("sites")``.  ``sum()`` is the sum of
    every element on ``device`` (a pattern-weight total), computed once.
    """

    def __init__(self, parts, device):
        self.parts = tuple(parts)
        self.device = torch.device(device)

    @classmethod
    def scatter(cls, x: np.ndarray, axis: int, devices, device):
        """Cut host array ``x`` (its ``axis`` a multiple of
        ``len(devices)``) into one contiguous slice per device."""
        k = len(devices)
        if x.shape[axis] % k:
            raise ValueError(f"pattern axis {x.shape[axis]} is not a "
                             f"multiple of {k} shards")
        return cls([torch.as_tensor(np.ascontiguousarray(s), device=d)
                    for s, d in zip(np.split(x, k, axis), devices)], device)

    def double(self):
        return Shards([p.double() for p in self.parts], self.device)

    @cached_property
    def _total(self):
        return sum(p.sum().to(self.device, non_blocking=True)
                   for p in self.parts)

    def sum(self):
        return self._total


class PruningCudaSharded:
    """Static wiring of one division's pattern-sharded pruning pass and
    the callable op: the counterpart of ``PruningPallasSharded``.

    ``tips`` [n_tips, P, S] on the host, the real patterns only, P a
    multiple of ``len(devices)`` (``parallel.mesh.shard_engine_data`` pads
    it); ``devices`` the shards' devices in order (repeats allowed);
    ``device`` the engine's, where the operators are built, the dummy
    patterns of a ``coding`` other than "all" are pruned (``dummy``) and
    the partial sums land.  Calling it maps each chain's (postorder, left,
    right, P-tensor) to one (root [C, K, S, P/k], logscale [C, P/k]) per
    shard, on the shard's device.  ``launches`` counts kernel launches,
    one per CUDA shard and call (never plain-version calls); ``dummy``
    counts its own.
    """

    def __init__(self, tips: np.ndarray, n_cats: int, devices, device,
                 coding: str = "all"):
        self.device = torch.device(device)
        self.devices = [torch.device(d) for d in devices]
        wrong = [str(d) for d in self.devices if d.type != self.device.type]
        if wrong:
            raise ValueError(f"shard devices {wrong} are not of the "
                             f"engine's device type {self.device.type}")
        n_tips, P, S = tips.shape
        self.n_tips, self.P, self.S, self.K = n_tips, P, S, n_cats
        tt = np.transpose(np.asarray(tips, np.float32), (0, 2, 1))
        self.tips = Shards.scatter(tt, 2, self.devices,
                                   self.device).parts        # [n, S, P/k]
        self.coding = coding
        self.dummy = None if coding == "all" else PruningCuda(
            np.broadcast_to(np.eye(S, dtype=np.float32), (n_tips, S, S)),
            n_cats, self.device)
        self.launches = 0

    # (lr, pstep) on the engine's device, built once for every shard
    operands = PruningCuda.operands

    def __call__(self, order, left, right, Pmat):
        lr, pstep = self.operands(order, left, right, Pmat)
        out = []
        for dev, tips in zip(self.devices, self.tips):
            lr_d = lr.to(dev, non_blocking=True)
            pstep_d = pstep.to(dev, non_blocking=True)
            with SPANS("gen.lnl.launch"):
                if tips.is_cuda:
                    out.append(pruning_down(lr_d, pstep_d, tips))
                    self.launches += 1
                else:
                    out.append(pruning_down_plain(lr_d, pstep_d, tips))
        return out

    def loglik(self, order, left, right, Pmat, pi, pinv, const_mask,
               weights: Shards, cat_weights=None):
        """Σ_p w_p ln L_p [C] over every shard's patterns, on the engine's
        device, less the coding correction: each shard's root reduction
        (``site_loglik_from_root`` with its slice of ``const_mask``, a
        ``Shards`` or None) and weighted sum run on the shard's device,
        and the [C] partial sums are added here in shard order."""
        cmasks = const_mask.parts if const_mask is not None \
            else (None,) * len(self.devices)
        total = None
        for (root, ls), w, cm in zip(self(order, left, right, Pmat),
                                     weights.parts, cmasks):
            dev = root.device
            pinv_d, cw = (x.to(dev, non_blocking=True)
                          if torch.is_tensor(x) else x
                          for x in (pinv, cat_weights))
            ln = site_loglik_from_root(
                root, ls, pi.to(dev, non_blocking=True), pinv_d, cm, cw)
            part = (w * ln).sum(-1).to(self.device, non_blocking=True)
            total = part if total is None else total + part
        if self.dummy is None:
            return total
        root, ls = self.dummy(order, left, right, Pmat)
        dmask = (torch.eye(self.S, dtype=root.dtype, device=root.device)
                 if const_mask is not None else None)
        ln_dummy = site_loglik_from_root(root, ls, pi, pinv, dmask,
                                         cat_weights)
        return total - coding_correction(ln_dummy, weights.sum(),
                                         self.coding)
