"""Sharding the MC3 engine over devices.

Counterpart of ``mrbayes_tpu/parallel/mesh.py``, whose mesh has two axes
(SURVEY §2.2):

* ``chains`` spreads runs × chains over devices or processes, and the
  swap step then gathers each chain's (lnL, lnP).  Not ported yet: a
  mesh with more than one chain shard raises ``NotImplementedError``
  naming ROADMAP Queue 1 item 11b, which also brings ``put_global``,
  ``init_distributed`` and ``gather_to_host``.
* ``sites`` splits the pattern axis within a chain, the axis the
  reference left unbuilt (dead code at src/mcmc.c:18358-18372).  Each
  shard runs the pruning kernel on its own pattern slice and the root
  sum is reduced across shards (``ops/sharded_cuda.py``).  Ported.

JAX places global arrays under named shardings and lets GSPMD insert the
psum.  Here the mesh is a grid of ``torch.device``; a device may appear
more than once (``[cuda:0] * 4`` is four shards on one card, the way
the JAX tests shard over 8 virtual CPU devices), and ``["cpu"] * k`` runs
the plain versions on the CPU.  Everything runs in one process.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.sharded_cuda import PruningCudaSharded, Shards


def _chains_not_ported(n_chain_shards: int, n_site_shards: int):
    return NotImplementedError(
        f"a mesh of {n_chain_shards} chain shards x {n_site_shards} site "
        f"shards: the chains mesh axis is not ported to mrbayes_tpu_torch "
        f"yet (ROADMAP Queue 1 item 11b); only site shards are")


def _cuda_devices() -> list:
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


class Mesh:
    """A [chains, sites] grid of torch devices (``devices[c][s]``)."""

    axis_names = ("chains", "sites")

    def __init__(self, grid):
        self.devices = [[torch.device(d) for d in row] for row in grid]
        self.shape = {"chains": len(self.devices),
                      "sites": len(self.devices[0])}

    def site_devices(self) -> list:
        """The devices of the ``sites`` axis, in shard order."""
        return self.devices[0]


def make_mesh(n_chain_shards: int, n_site_shards: int = 1,
              devices=None) -> Mesh:
    """A mesh over the first ``n_chain_shards * n_site_shards`` of
    ``devices`` (default: every CUDA device; a list may repeat a device,
    or be ``["cpu"] * k``)."""
    if n_chain_shards > 1:
        raise _chains_not_ported(n_chain_shards, n_site_shards)
    if devices is None:
        devices = _cuda_devices()
    need = n_chain_shards * n_site_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([list(devices[:need])])


def _pad_to_multiple(x: np.ndarray, axis: int, m: int):
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, 0
    width = [(0, 0)] * x.ndim
    width[axis] = (0, pad)
    return np.pad(x, width), pad


def shard_engine_data(eng, mesh: Mesh) -> None:
    """Re-place the engine's per-division pattern data sharded over the
    ``sites`` axis: each division's pattern weights and constant-state
    masks padded to a multiple of the shard count and cut into one slice
    per shard, and its pruner replaced by a ``PruningCudaSharded`` over its
    tips (without coding dummies) padded the same way (weight 0, zero tips,
    zero mask rows: a padded pattern adds exactly 0).  The sharded pruner
    holds the tips and, for a coded division, the dummy patterns' pass, so
    the engine's whole-division tips are dropped.  The multiwalk and
    stacked groups are cleared (mrbayes_tpu/parallel/mesh.py:95-98) and a
    wavefront pruner becomes a sharded one.  A division without a pruner
    (parsimony model, continuous data) keeps its data whole; an adgamma
    division gathers its shards' root partials for the HMM along the
    sites.  The parsimony masks of the
    proposals stay whole on the engine's device.  The identity at one site
    shard."""
    k = mesh.shape["sites"]
    if k == 1:
        return
    if any(isinstance(p, PruningCudaSharded) for p in eng._pruners):
        raise ValueError("the engine's data is sharded already")
    devices = mesh.site_devices()
    ws, cms, pruners = [], [], []
    for i, cfg in enumerate(eng.div_cfg):
        if eng._pruners[i] is None:
            # a parsimony-model or continuous division prunes nothing:
            # its data stay whole (mrbayes_tpu/parallel/mesh.py:87-92)
            ws.append(eng.weights[i])
            cms.append(eng.const_masks[i])
            pruners.append(None)
            continue
        tp, _ = _pad_to_multiple(eng._model_tips[i], 1, k)
        w, _ = _pad_to_multiple(eng.weights[i].cpu().numpy(), 0, k)
        cm, _ = _pad_to_multiple(eng.const_masks[i].cpu().numpy(), 0, k)
        pruners.append(PruningCudaSharded(tp, cfg.n_cats, devices,
                                          eng.device, cfg.coding))
        ws.append(Shards.scatter(w, 0, devices, eng.device))
        cms.append(Shards.scatter(cm, 0, devices, eng.device))
    eng.weights, eng.const_masks, eng._pruners = ws, cms, pruners
    eng.tip_partials = [None] * len(eng.div_cfg)
    eng._multiwalk_pruners = []
    eng._stacked_pruners = []


def shard_chains(eng, mesh: Mesh, states: dict, bk: dict):
    """Place the chain states and bookkeeping over the ``chains`` axis:
    the identity at one chain shard, the only mesh ported."""
    if mesh.shape["chains"] > 1:
        raise _chains_not_ported(mesh.shape["chains"], mesh.shape["sites"])
    return states, bk


def auto_mesh(n_chains_total: int, devices=None) -> Mesh:
    """Default mesh for a run (mrbayes_tpu/parallel/mesh.py:129-141): as
    many chain shards as divide both the chain count and the device count,
    the remaining devices on the ``sites`` axis.  Raises
    ``NotImplementedError`` when that gives more than one chain shard."""
    if devices is None:
        devices = _cuda_devices()
    chain_shards = math.gcd(n_chains_total, len(devices))
    return make_mesh(chain_shards, len(devices) // chain_shards, devices)
