"""Sharding the MC3 engine over processes and devices.

Counterpart of ``mrbayes_tpu/parallel/mesh.py``, whose mesh has two axes
(SURVEY §2.2):

* ``chains`` spreads runs × chains over processes, as the reference
  spreads them over MPI ranks (src/mcmc.c:18331).  Here a chain shard is
  a process of a ``torch.distributed`` group (``init_distributed``): rank
  r of N holds chains ``[r·C/N, (r+1)·C/N)`` of the flat runs × chains
  axis on its own device, and ``C % N`` must be 0, as the reference
  requires (src/mcmc.c:18331-18357).  Every process builds the same full
  starting state from the same seeds and keeps its slice
  (``put_global``, ``shard_chains``); the move sequence and the swap
  draws come from generators seeded alike everywhere, so ``temp_id``
  stays the same on every rank; the swap step gathers E = power·lnL + lnP
  of a run's chains where the run spans ranks (one collective a swap
  generation) and needs none where every rank holds whole runs.  The
  runner's one device->host copy a block becomes one all-gather
  (``gather_to_host``).  One process never holds more than one chain
  shard: a mesh that asks for that raises, naming the rule.
* ``sites`` splits the pattern axis within a chain, the axis the
  reference left unbuilt (dead code at src/mcmc.c:18358-18372).  Each
  shard runs the pruning kernel on its own pattern slice and the root
  sum is reduced across shards (``ops/sharded_cuda.py``).  It stays
  within a process: its devices are the process's own.

JAX places global arrays under named shardings and lets GSPMD insert the
collectives.  Here the mesh holds this process's row of devices; a device
may appear more than once (``[cuda:0] * 4`` is four site shards on one
card, the way the JAX tests shard over 8 virtual CPU devices), and
``["cpu"] * k`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.sharded_cuda import PruningCudaSharded, Shards

# the bookkeeping keys indexed by chain (sliced like the states) and the
# per-run swap matrices (kept whole), as JAX's shard_chains splits them
CHAIN_BK = ("tuning", "tries", "accepts", "tries_total", "accepts_total")
SWAP_BK = ("swap_tries", "swap_accepts")


@dataclass
class World:
    """This process's place in a ``torch.distributed`` group: its rank,
    the group's size, the backend, its device and the collectives it has
    issued (``collectives``, counted where each is made)."""
    rank: int
    size: int
    backend: str
    device: torch.device
    collectives: int = 0


_WORLD: World | None = None


def world() -> World | None:
    """The group ``init_distributed`` joined, or None."""
    return _WORLD


def process_count() -> int:
    return 1 if _WORLD is None else _WORLD.size


def process_index() -> int:
    return 0 if _WORLD is None else _WORLD.rank


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own generator (``bk["rng"]``, the
    proposals and acceptance uniforms): ``seed`` itself on rank 0, so a
    world of one draws today's numbers; on rank r > 0 the first 64-bit
    word of ``numpy.random.SeedSequence([seed, r])``."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0])


def choose_backend(device: torch.device, local_processes: int) -> str:
    """``nccl`` where every rank of a host has a card of its own, ``gloo``
    where ranks share a card or run on the CPU (NCCL refuses two ranks on
    one device)."""
    if device.type == "cuda" \
            and local_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device=None, timeout: float | None = None) -> World:
    """Join a group of ``num_processes`` processes (the counterpart of
    MPI_Init, reference src/bayes.c:177; JAX ``jax.distributed``) through
    ``tcp://<coordinator>`` (``host:port`` of rank 0's store).  The rank's
    device is ``cuda:(local rank % cards)``, the local rank being
    ``LOCAL_RANK`` or else ``process_id``, unless ``device`` names the CPU;
    with no card a CUDA request raises.  The backend follows
    ``choose_backend`` (``LOCAL_WORLD_SIZE`` or else ``num_processes``
    ranks a host) and is not retried on another.  A collective waits at
    most ``timeout`` seconds (default ``MB_DIST_TIMEOUT``, else 300), so a
    peer of a rank that failed exits instead of hanging."""
    global _WORLD
    from .. import resolve_device
    if _WORLD is not None:
        raise RuntimeError("init_distributed was called already")
    import torch.distributed as dist
    dev = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_size)
    if timeout is None:
        timeout = float(os.environ.get("MB_DIST_TIMEOUT", 300))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout),
        **({"device_id": dev} if backend == "nccl" else {}))
    _WORLD = World(process_id, num_processes, backend, dev)
    return _WORLD


def shutdown_distributed() -> None:
    """Leave the group (a no-op without one)."""
    global _WORLD
    if _WORLD is None:
        return
    import torch.distributed as dist
    dist.destroy_process_group()
    _WORLD = None


def barrier() -> None:
    if _WORLD is not None:
        import torch.distributed as dist
        _WORLD.collectives += 1
        dist.barrier()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """[N, *x.shape]: every rank's ``x`` in rank order, on ``x``'s device;
    one collective.  Gloo gathers host copies (it has no
    ``all_gather_into_tensor``)."""
    import torch.distributed as dist
    w = _WORLD
    w.collectives += 1
    x = x.contiguous()
    if w.backend == "nccl":
        out = x.new_empty((w.size,) + tuple(x.shape))
        dist.all_gather_into_tensor(out, x)
        return out
    xc = x.cpu()
    outs = [torch.empty_like(xc) for _ in range(w.size)]
    dist.all_gather(outs, xc)
    return torch.stack(outs).to(x.device)


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj`` in rank order (one collective)."""
    import torch.distributed as dist
    _WORLD.collectives += 1
    out = [None] * _WORLD.size
    dist.all_gather_object(out, obj)
    return out


def _cuda_devices() -> list:
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _local_devices() -> list:
    """This process's devices: its rank's device in a group, every CUDA
    device otherwise."""
    return [_WORLD.device] if _WORLD is not None else _cuda_devices()


class Mesh:
    """This process's row of a [chains, sites] grid: ``shape["chains"]``
    chain shards, one a process (this one is ``chain_index``), each over
    the ``sites`` devices of its own process (``devices[0]``)."""

    axis_names = ("chains", "sites")

    def __init__(self, row, n_chain_shards: int = 1, chain_index: int = 0):
        self.devices = [[torch.device(d) for d in row]]
        self.chain_index = chain_index
        self.shape = {"chains": n_chain_shards, "sites": len(row)}

    def site_devices(self) -> list:
        """The devices of the ``sites`` axis, in shard order."""
        return self.devices[0]


def _one_shard_a_process(n_chain_shards: int, n_processes: int):
    return ValueError(
        f"a mesh of {n_chain_shards} chain shards over {n_processes} "
        f"process(es): a chain shard is a process, so launch one process a "
        f"chain shard (--nprocs {n_chain_shards}, or init_distributed with "
        f"{n_chain_shards} processes)")


def make_mesh(n_chain_shards: int, n_site_shards: int = 1,
              devices=None) -> Mesh:
    """A mesh of ``n_chain_shards`` chain shards, which must equal the
    number of processes (one chain shard a process), each over the first
    ``n_site_shards`` of its process's ``devices`` (default: the rank's
    device in a group, every CUDA device in one process; a list may repeat
    a device, or be ``["cpu"] * k``)."""
    n_proc = process_count()
    if n_chain_shards != n_proc:
        raise _one_shard_a_process(n_chain_shards, n_proc)
    if devices is None:
        devices = _local_devices()
    if len(devices) < n_site_shards:
        raise ValueError(f"need {n_site_shards} devices, have "
                         f"{len(devices)}")
    return Mesh(list(devices[:n_site_shards]), n_chain_shards,
                process_index())


def auto_mesh(n_chains_total: int, devices=None) -> Mesh:
    """Default mesh for a run over N processes of d devices each
    (mrbayes_tpu/parallel/mesh.py:129-141).  JAX takes gcd(C, N·d) chain
    shards and the remaining devices on ``sites``; the port keeps that
    wherever it gives one chain shard a process, and otherwise takes N
    chain shards with each process's devices on ``sites``, so the mesh is
    N x d in every case.  ``C % N != 0`` raises, as in the reference."""
    if devices is None:
        devices = _local_devices()
    n_proc = process_count()
    if n_chains_total % n_proc:
        raise ValueError(f"{n_chains_total} chains do not divide over "
                         f"{n_proc} processes (runs x chains must be a "
                         f"multiple of the process count)")
    return make_mesh(n_proc, len(devices), devices)


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


def put_global(x, chains: slice | None, device) -> torch.Tensor:
    """A full host value (array or tensor), the same on every process
    since every process builds it from the same seeds (the reference
    broadcasts its seeds for the same reason, src/bayes.c:499), placed on
    ``device``: the rows ``chains`` of its chain axis, or all of it when
    ``chains`` is None (a replicated value)."""
    t = torch.as_tensor(x)
    if chains is not None:
        t = t[chains]
    return t.to(device).contiguous()


def shard_chains(eng, mesh: Mesh, states: dict, bk: dict):
    """Place the chain states and bookkeeping over the ``chains`` axis
    (mrbayes_tpu/parallel/mesh.py:110-126): this rank keeps its slice of
    every chain-indexed state tensor and of ``tuning``, ``tries``,
    ``accepts``, ``tries_total`` and ``accepts_total``; ``temp_id``,
    ``swap_tries`` and ``swap_accepts`` and the generators stay whole (the
    swap decision is computed alike everywhere, as the reference's shared
    swapSeed, src/mcmc.c:5217).  The engine is told its slice
    (``Engine.set_chain_slice``).  The identity at one chain shard."""
    n = mesh.shape["chains"]
    if n == 1:
        return states, bk
    if n != process_count():
        raise _one_shard_a_process(n, process_count())
    C = eng.mcmc.n_chains_total
    if C % n:
        raise ValueError(f"{C} chains do not divide over {n} processes")
    per = C // n
    lo = mesh.chain_index * per
    sl = slice(lo, lo + per)
    dev = eng.device
    states = {k: put_global(v, sl if v.ndim and v.shape[0] == C else None,
                            dev) for k, v in states.items()}
    bk = {k: (put_global(v, sl if k in CHAIN_BK else None, dev)
              if torch.is_tensor(v) else v) for k, v in bk.items()}
    eng.set_chain_slice(lo, lo + per)
    return states, bk


def gather_to_host(states: dict, bk: dict, report=None, flags=()):
    """Every process's full host view of a chain-sharded run, with ONE
    collective (the role of the reference's ReassembleParamVals gather,
    src/mcmc.c:14313; every rank gets it, so diagnostics stay replicated).
    Each rank packs its state tensors (the eigensystem cache left out),
    its slice of ``temp_id`` and of the chain-indexed bookkeeping, its
    swap matrices, its rows of the report columns (``report`` [R, cols],
    zero where the run's cold chain is another rank's) and its ``flags``
    into one float64 buffer, as ``run.host_states`` does, and the buffers
    are all-gathered.  Returns (host, host_bk, flags [N, len(flags)]):
    ``host`` as ``run.host_states`` gives it (states, ``temp_id``,
    ``report``), ``host_bk`` the chain-indexed bookkeeping and the swap
    matrices, run r's rows taken from the rank that holds its first
    chain."""
    per = bk["tuning"].shape[0]
    lo = process_index() * per
    parts = [("state", k, v) for k, v in states.items()
             if not k.startswith("eig")]
    parts.append(("state", "temp_id", bk["temp_id"][lo:lo + per]))
    parts += [("bk", k, bk[k]) for k in CHAIN_BK + SWAP_BK]
    if report is not None:
        parts.append(("report", "report", report))
    parts.append(("flags", "flags", torch.as_tensor(
        list(flags), dtype=torch.float64, device=bk["temp_id"].device)))
    flat = torch.cat([t.reshape(-1).to(torch.float64) for _, _, t in parts])
    buf = all_gather(flat).cpu().numpy()               # [N, L]
    n = buf.shape[0]
    host, host_bk, at = {}, {}, 0
    for kind, k, t in parts:
        shape = tuple(t.shape)
        seg = buf[:, at:at + t.numel()].reshape((n,) + shape)
        at += t.numel()
        dtype = {torch.float32: np.float32, torch.bool: np.bool_}.get(
            t.dtype, np.int64)
        out = host_bk if kind == "bk" else host
        if kind == "flags":
            out_flags = seg
        elif kind == "report":
            host[k] = seg.sum(0).astype(dtype)
        elif k in SWAP_BK:
            runs = np.arange(shape[0])
            out[k] = seg[runs * shape[1] // per, runs].astype(dtype)
        elif shape and shape[0] == per:
            # chain-indexed: the ranks' slices in rank order
            out[k] = seg.reshape((n * per,) + shape[1:]).astype(dtype)
        else:
            out[k] = seg[0].astype(dtype)
    return host, host_bk, out_flags


def replicate_bookkeeping(bk: dict, host_bk: dict, temp_id) -> dict:
    """``bk`` with the gathered ``temp_id`` and swap matrices put back on
    its device: where every rank holds whole runs, a rank's swaps change
    only its own runs' rows during a block, and this makes the copies
    identical again on every rank."""
    dev = bk["temp_id"].device
    out = dict(bk)
    out["temp_id"] = torch.as_tensor(temp_id, dtype=bk["temp_id"].dtype,
                                     device=dev)
    for k in SWAP_BK:
        out[k] = torch.as_tensor(host_bk[k], dtype=bk[k].dtype, device=dev)
    return out
