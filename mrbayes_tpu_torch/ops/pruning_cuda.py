"""The fused Felsenstein down-pass as a hand-written CUDA kernel.

Counterpart of ``mrbayes_tpu/ops/pruning_pallas.py`` (``_kernel_g``, wired
by ``PruningPallas``).  The kernel source is ``csrc/pruning.cu``; its
header comment records what bounds it on an H100 (latency: the
n_int-step dependent chain plus the launch) and what its design does
about that.  It is compiled with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` beside this package (listed in ``.gitignore``) and loaded with
``ctypes`` through a plain C interface.

The kernel has five walks.  Most shapes take the on-chip walk of
``csrc/onchip_walk.cuh``: one block per (chain, tile of T patterns), the
K·S entries of a step spread over up to 32 lanes of a pattern, every
partial in shared memory, at most n_tips / 2 live slots (``live_slot_map``
is the Python twin of the kernel's slot allocator), with the chain's
operators on chip ("whole") or staged a step ahead ("staged").  Where the
tips are 0/1 and packed as bit masks (``pack_tips``; ``PruningCuda``
packs them once a division), large trees take the Strahler walk of
``csrc/strahler_walk.cuh`` ("strahler", "strahler_staged"): the same
step, its steps in a Strahler postorder that a pre-pass kernel writes
from lr (``strahler_schedule`` is its twin), at most floor(log2 n_tips)
live slots, so a block holds many more patterns.  A shape
that does not fit a block of 32 threads takes the tiled walk of
``csrc/tiled_walk.cuh`` ("tiled"): one thread-block cluster per (chain,
tile), the categories split across its blocks, each (step, category) a
block-cooperative product on operators streamed through shared memory,
the partials on chip and the step's max combined through distributed
shared memory.  Only a shape whose slots fit neither takes the
global-scratch walk of ``csrc/down_pass.cuh`` ("global").  The size rule
picks the walk and the block; ``pruning_plan`` reports its choice and
``size_rule`` is its Python twin.

Differences from the TPU layout, all deliberate:
  * per-category S×S operators ``Pstep [C, n_int, 2, K, S, S]`` instead of
    block-diagonal [KSp, KSp] ones (no K-fold zero work);
  * ``tips [n_tips, S, P]`` once, shared by all chains (no K-tiling);
  * no padding of P or K·S; the kernel masks the ragged pattern edge;
  * one grid slice per chain (no walk interleaving).

The kernel library is built together with the multiwalk kernel's
(``csrc/multiwalk.cu``, wired by ``ops/multiwalk_cuda.py``), the
wavefront kernel's (``csrc/wavefront.cu``, wired by
``ops/wavefront_cuda.py``) and the stacked kernel's (``csrc/stacked.cu``,
wired by ``ops/stacked_cuda.py``) and the batched eigensolver's
(``csrc/eigh.cu``, wired by ``ops/eigh_cuda.py``): ``build`` starts one
``nvcc`` per source at once.  The stacked and multiwalk kernels share the group launch
of ``csrc/group_walk.cuh`` (a tile map and a per-division table), laid
out and planned by ``GroupLayout``.

``pruning_down`` launches the kernel and takes CUDA tensors only;
``pruning_down_plain`` is its plain PyTorch version, the same function on
any device.  ``PruningCuda`` sends a CUDA tensor to the kernel and a CPU
tensor to the plain version; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from ..spans import SPANS

_TINY = 1e-30
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, "_build")
# one shared library per source, all compiled at once; every source
# includes the shared walks
SOURCES = {"pruning": "pruning.cu", "multiwalk": "multiwalk.cu",
           "wavefront": "wavefront.cu", "stacked": "stacked.cu",
           "eigh": "eigh.cu"}
_HEADERS = ("down_pass.cuh", "onchip_walk.cuh", "group_walk.cuh",
            "tiled_walk.cuh", "strahler_walk.cuh")
# state counts with a template in the on-chip walk (csrc/onchip_walk.cuh;
# the tiled walk's launch in csrc/pruning.cu has one for S 61, the codons)
TEMPLATED_S = (2, 3, 4, 8, 20)
# the runtime-S paths keep no per-S arrays, so this cap is only a sanity
# bound (the largest data type, codons, has 61 states)
MAX_RUNTIME_S = 64
MAX_RUNTIME_K = 16
# the walks of the size rule in csrc/onchip_walk.cuh, by its codes (the
# tiled and Strahler walks are pruning.cu's alone)
WALKS = ("whole", "staged", "global", "tiled", "strahler", "strahler_staged")
# the walks that read packed tips (csrc/strahler_walk.cuh)
STRAHLER_WALKS = ("strahler", "strahler_staged")
# threads a block of the global-scratch walk (kThreads, csrc/down_pass.cuh)
GLOBAL_THREADS = 128
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_GROUP_PLAN = [_PTR] + [_INT] * 4 + [_PTR]
_ENTRY_POINTS = {
    "pruning": {"mb_pruning_down": [_PTR] * 8 + [_INT] * 13 + [_PTR],
                "mb_pruning_plan": [_INT] * 7 + [_PTR],
                "mb_tiled_plan": [_INT] * 8 + [_PTR],
                "mb_strahler_schedule": [_PTR] * 2 + [_INT] * 4 + [_PTR]},
    "multiwalk": {"mb_multiwalk_down": [_PTR] * 9 + [_INT] * 10 + [_PTR],
                  "mb_group_plan": _GROUP_PLAN},
    "wavefront": {"mb_wavefront_down": [_PTR] * 5 + [_INT] * 14 + [_PTR],
                  "mb_wavefront_plan": [_INT] * 7 + [_PTR]},
    "stacked": {"mb_stacked_down": [_PTR] * 8 + [_INT] * 8 + [_PTR],
                "mb_group_plan": _GROUP_PLAN},
    "eigh": {"mb_eigh_jacobi": [_PTR] * 4 + [_INT] * 3 + [_PTR],
             "mb_eigh_jacobi_before": [_PTR] * 4 + [_INT] * 3 + [_PTR],
             "mb_eigh_plan": [_INT, _PTR]},
}


class KernelBuild:
    """One loaded shared library plus how it was built."""

    def __init__(self, lib, path: str, seconds: float, log: str):
        self.lib, self.path, self.seconds, self.log = lib, path, seconds, log


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.abspath(os.path.join(
        _BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so"))


def build(verbose: bool = False) -> dict[str, KernelBuild]:
    """Compile every source of ``csrc/`` (one ``nvcc`` per source, all
    started together; a source whose library was already built from the
    same sources and flags is skipped) and load each library.
    ``verbose`` adds ``-Xptxas -v`` so each log reports registers, shared
    memory and spills per kernel instantiation."""
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    os.makedirs(_BUILD_DIR, exist_ok=True)
    jobs = {}
    for name, src in SOURCES.items():
        path = _library_path(name)
        if verbose or not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [_nvcc(), *flags, "-o", tmp, os.path.join(_CSRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, path, time.perf_counter())
    logs, seconds = {}, {}
    for name, (proc, tmp, path, t0) in jobs.items():
        logs[name] = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]} "
                               f"({proc.returncode}):\n{logs[name]}")
        os.replace(tmp, path)
    out = {}
    for name in SOURCES:
        path = _library_path(name)
        lib = ctypes.CDLL(path)
        for fn_name, argtypes in _ENTRY_POINTS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.mb_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mb_cuda_error_string.restype = ctypes.c_char_p
        out[name] = KernelBuild(lib, path, seconds.get(name, 0.0),
                                logs.get(name, ""))
    return out


class _Libraries:
    """The process's loaded kernel libraries, built on first use."""

    def __init__(self):
        self.builds: dict[str, KernelBuild] | None = None

    def get(self, verbose: bool = False) -> dict[str, KernelBuild]:
        if self.builds is None:
            self.builds = build(verbose)
        return self.builds


_LIBRARIES = _Libraries()


def libraries(verbose: bool = False) -> dict[str, KernelBuild]:
    """Every kernel library, by name (built now if this process has not
    built them yet; ``verbose`` applies to that build)."""
    return _LIBRARIES.get(verbose)


def library(name: str = "pruning") -> KernelBuild:
    """One loaded kernel library (``pruning``, ``multiwalk``,
    ``wavefront``, ``stacked`` or ``eigh``)."""
    return _LIBRARIES.get()[name]


def launch_error(lib, err: int, what: str) -> RuntimeError:
    msg = lib.mb_cuda_error_string(err).decode()
    return RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def check_kernel_shape(S: int, K: int, what: str):
    """Raise unless the kernels take S states with K rate categories."""
    if S not in TEMPLATED_S and not (
            S <= MAX_RUNTIME_S and K <= MAX_RUNTIME_K):
        raise ValueError(f"{what} supports the templated S in {TEMPLATED_S} "
                         f"or S <= {MAX_RUNTIME_S} with K <= "
                         f"{MAX_RUNTIME_K}; got S={S}, K={K}")


def check_cuda_operands(what: str, **tensors):
    """Raise unless every operand is a contiguous CUDA tensor on one
    device."""
    dev = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{what}: operands on different devices")
        dev = t.device


def check_step_operands(lr, pstep, tips):
    if lr.dtype != torch.int32:
        raise TypeError(f"lr must be int32, got {lr.dtype}")
    if pstep.dtype != torch.float32 or tips.dtype != torch.float32:
        raise TypeError("pstep and tips must be float32")
    if lr.ndim != 3 or lr.shape[2] != 2:
        raise ValueError(f"lr must be [C, n_int, 2], got {tuple(lr.shape)}")
    C, n_int = lr.shape[:2]
    if pstep.ndim != 6 or pstep.shape[:3] != (C, n_int, 2) \
            or pstep.shape[4] != pstep.shape[5]:
        raise ValueError(f"pstep must be [C, n_int, 2, K, S, S], got "
                         f"{tuple(pstep.shape)}")
    K, S = pstep.shape[3], pstep.shape[4]
    if tips.ndim != 3 or tips.shape[1] != S:
        raise ValueError(f"tips must be [n_tips, S, P], got "
                         f"{tuple(tips.shape)}")
    n_tips, _, P = tips.shape
    if n_int != n_tips - 1:
        raise ValueError(f"n_int {n_int} != n_tips - 1 ({n_tips - 1})")
    return C, n_int, K, S, n_tips, P


def device_index(dev: torch.device) -> int:
    """The CUDA device number of ``dev`` (the current one for "cuda")."""
    return dev.index if dev.index is not None else torch.cuda.current_device()


def pruning_plan(C: int, n_tips: int, K: int, S: int, P: int,
                 device, packed: bool = False) -> dict:
    """The size rule's choice for one ``pruning_down`` launch
    (``csrc/onchip_walk.cuh``, then ``csrc/strahler_walk.cuh`` where the
    tips are ``packed`` as masks, then ``csrc/tiled_walk.cuh``), asked of
    the kernel library once per shape and device: ``walk`` ("whole",
    "staged", "strahler", "strahler_staged", "tiled" or "global"), the
    ``threads`` of a block, the patterns ``T`` it covers, the ``lanes`` of
    a pattern (along s on the tiled walk), the blocks of a ``cluster`` (0
    off the tiled walk) and the block's dynamic shared memory
    ``smem_bytes``, which ``pruning_launch`` passes to the kernel library
    as they are.  ``size_rule`` is its Python twin."""
    return _plan(C, n_tips, K, S, P, device_index(torch.device(device)),
                 packed=bool(packed))


def tiled_plan(C: int, n_tips: int, K: int, S: int, P: int, device,
               cluster: int = 0, T: int = 0) -> dict:
    """The tiled walk's plan with the blocks of a ``cluster`` and the
    patterns ``T`` of a block forced where they are > 0 (0: the size
    rule's), in ``pruning_plan``'s form; ``walk`` is "global" where no
    block fits.  ``chip_smoke.py`` times the walk's other designs with
    it."""
    return _plan(C, n_tips, K, S, P, device_index(torch.device(device)),
                 (cluster, T))


@functools.lru_cache(maxsize=None)
def _plan(C, n_tips, K, S, P, dev, forced=None, packed=False):
    lib = library("pruning").lib
    out = (ctypes.c_int * 6)()
    if forced is None:
        err = lib.mb_pruning_plan(C, n_tips, K, S, P, dev, int(packed), out)
    else:
        err = lib.mb_tiled_plan(C, n_tips, K, S, P, dev, *forced, out)
    if err != 0:
        raise launch_error(lib, err, "pruning_plan")
    return {"walk": WALKS[out[0]], "threads": out[1], "T": out[3],
            "lanes": out[4], "cluster": out[5], "smem_bytes": out[2]}


# the limits of an H100 that the size rule reads (opt-in shared memory a
# block, streaming multiprocessors, shared memory of an SM and the part
# the system keeps a block) and the constants of its headers
H100_SMEM_OPTIN, H100_SMS = 232_448, 132
H100_SMEM_SM, H100_SMEM_RESERVED = 233_472, 1_024
_STRAHLER_MAX_TIPS = 2048
_MAX_ITEMS, _THREADS_PER_SM, _GLOBAL_BLOCK = 8, 512, 128
_TILED_ROWS, _TILED_MAX_CLUSTER = 4, 8
_TILED_BLOCKS_PER_SM, _TILED_TILES = 2, (32, 16, 8, 4)


def _pow2_at_least(n: int) -> int:
    v = 1
    while v < n:
        v <<= 1
    return v


def _onchip_smem_bytes(n_tips, K, S, G, BT, staged) -> int:
    """``onchip_smem_bytes`` of ``csrc/onchip_walk.cuh``."""
    n_int, L, T = n_tips - 1, n_tips // 2, BT // G
    step = 2 * K * S * S
    words = ((2 * step if staged else n_int * step) + L * K * S * (T | 1)
             + n_tips * S * T + 3 * n_int + (L + 31) // 32)
    return (4 * words + 15) // 16 * 16


def strahler_slots(n_tips: int) -> int:
    """Slots of the Strahler walk: floor(log2 n_tips), at least 1."""
    return max(1, n_tips.bit_length() - 1)


def _strahler_smem_bytes(n_tips, K, S, G, BT, staged) -> int:
    """``strahler_smem_bytes`` of ``csrc/strahler_walk.cuh``."""
    n_int, T = n_tips - 1, BT // G
    step = 2 * K * S * S
    words = (4 * n_int + (2 * step if staged else n_int * step)
             + strahler_slots(n_tips) * K * S * (T | 1)
             + (n_tips * T * (1 if S <= 8 else 4) + 3) // 4)
    return (4 * words + 15) // 16 * 16


def _busy_threads(nbytes, BT, lanes, smem_sm, reserved, sms) -> int:
    """``busy_threads`` of ``csrc/strahler_walk.cuh``: threads a block keeps
    busy on an SM, times the SMs, at most the launch's lanes."""
    per_sm = min(min(smem_sm // (nbytes + reserved), 32) * BT,
                 _THREADS_PER_SM)
    return min(per_sm * sms, lanes)


def _strahler_plan(C, n_tips, K, S, P, G, today, smem, sms, smem_sm,
                   reserved):
    """``strahler_plan`` of ``csrc/strahler_walk.cuh``: the Strahler
    walk's block where it keeps more than twice as many threads busy as
    ``today``'s on-chip block, else None."""
    if n_tips < 3 or n_tips > _STRAHLER_MAX_TIPS or S > 32:
        return None
    lanes = C * P * G
    best = 2 * _busy_threads(today["smem_bytes"], today["threads"], lanes,
                         smem_sm, reserved, sms)
    pick = None
    for staged in (False, True):
        for BT in (128, 64, 32):
            if BT < G:
                continue
            b = _strahler_smem_bytes(n_tips, K, S, G, BT, staged)
            if b > smem:
                continue
            busy = _busy_threads(b, BT, lanes, smem_sm, reserved, sms)
            if busy > best:
                best = busy
                pick = {"walk": "strahler_staged" if staged else "strahler",
                        "threads": BT, "T": BT // G, "lanes": G,
                        "cluster": 0, "smem_bytes": b}
    return pick


def strahler_block(n_tips: int, K: int, S: int, G: int, threads: int,
                   staged: bool) -> dict:
    """A Strahler walk's plan forced to ``threads`` a block, G lanes a
    pattern and whole or ``staged`` operators, in ``pruning_plan``'s form
    (``chip_smoke.py`` times the walk's other blocks with it)."""
    return {"walk": "strahler_staged" if staged else "strahler",
            "threads": threads, "T": threads // G, "lanes": G, "cluster": 0,
            "smem_bytes": _strahler_smem_bytes(n_tips, K, S, G, threads,
                                               staged)}


def busy_warps(plan: dict, C: int, P: int, smem_sm: int = H100_SMEM_SM,
               reserved: int = H100_SMEM_RESERVED,
               sms: int = H100_SMS) -> float:
    """Warps an on-chip or Strahler ``plan`` keeps busy on an SM at C
    chains and P patterns, as the size rule counts them (``busy_threads``
    of ``csrc/strahler_walk.cuh``, over 32), an H100's by default."""
    return _busy_threads(plan["smem_bytes"], plan["threads"],
                         C * P * plan["lanes"], smem_sm, reserved,
                         sms) / (32 * sms)


def _walk_at(n_tips, K, S, G, BT, budget) -> str:
    if G > 32 or K * S > G * _MAX_ITEMS:
        return "global"
    if _onchip_smem_bytes(n_tips, K, S, G, BT, False) <= budget:
        return "whole"
    if _onchip_smem_bytes(n_tips, K, S, G, BT, True) <= budget:
        return "staged"
    return "global"


def _tiled_lanes(S: int) -> int:
    """Lanes of a warp that share a pattern on the tiled walk."""
    return min(16, _pow2_at_least(-(-S // _TILED_ROWS)))


def tiled_cluster(K: int) -> int:
    """Blocks of a tiled walk's cluster for K categories."""
    per = -(-K // _TILED_MAX_CLUSTER)
    return -(-K // per)


def _tiled_smem_bytes(n_tips, K, S, T, Q) -> int:
    """``tiled_smem_bytes`` of ``csrc/tiled_walk.cuh``."""
    op_words = (S * S + 6) // 4 * 4
    L1, kq = n_tips // 2 + 1, -(-K // Q)
    words = (2 * (2 * op_words + 2 * S * T) + L1 * kq * S * T + 2 * T + 8
             + 3 * (n_tips - 1) + (L1 + 31) // 32)
    return (4 * words + 15) // 16 * 16


def _tiled_threads(S, T, per_sm) -> int:
    """Consumer warps (four an SM where B allows: per_sm blocks an SM) and
    the producer warp."""
    lp = 32 // _tiled_lanes(S)
    width = min(4, max(1, T // (lp * max(1, 4 // per_sm))))
    return 32 * (T // (lp * width) + 1)


def size_rule(C: int, n_tips: int, K: int, S: int, P: int,
              smem: int = H100_SMEM_OPTIN, sms: int = H100_SMS, *,
              packed: bool = False, smem_sm: int = H100_SMEM_SM,
              reserved: int = H100_SMEM_RESERVED) -> dict:
    """The Python twin of ``pruning_plan`` (``mb_pruning_plan``: the
    on-chip walk's rule of ``csrc/onchip_walk.cuh:onchip_plan`` for one
    division, then, with ``packed`` tips, ``csrc/strahler_walk.cuh:
    strahler_plan``, or ``csrc/tiled_walk.cuh:tiled_plan`` where no
    on-chip walk fits) for a device with ``smem`` bytes of opt-in shared
    memory a block, ``sms`` multiprocessors, ``smem_sm`` bytes of shared
    memory an SM and ``reserved`` of them kept a block, an H100's by
    default."""
    most = min(_pow2_at_least(K * S), 32)
    want = -(-sms * _THREADS_PER_SM // (C * P))
    G = max(_pow2_at_least(min(want, most)),
            _pow2_at_least(-(-K * S // _MAX_ITEMS)))
    BT = 32
    for cand in (256, 128, 64):
        same = (_walk_at(n_tips, K, S, G, cand, smem)
                == _walk_at(n_tips, K, S, G, 32, smem))
        if same and -(-P // max(1, cand // G)) * C >= sms:
            BT = cand
            break
    walk = _walk_at(n_tips, K, S, G, BT, smem)
    if walk != "global":
        today = {"walk": walk, "threads": BT, "T": BT // G, "lanes": G,
                 "cluster": 0, "smem_bytes": _onchip_smem_bytes(
                     n_tips, K, S, G, BT, walk == "staged")}
        pick = packed and _strahler_plan(C, n_tips, K, S, P, G, today, smem,
                                         sms, smem_sm, reserved)
        return pick or today
    Q = tiled_cluster(K)
    fits = [T for T in _TILED_TILES if T >= 32 // _tiled_lanes(S)
            and _tiled_smem_bytes(n_tips, K, S, T, Q) <= smem]
    pick = next((T for T in fits
                 if 2 * _tiled_smem_bytes(n_tips, K, S, T, Q) <= smem
                 and Q * C * -(-P // T) >= _TILED_BLOCKS_PER_SM * sms),
                fits[0] if fits else 0)
    if pick:
        b = _tiled_smem_bytes(n_tips, K, S, pick, Q)
        return {"walk": "tiled", "threads": _tiled_threads(S, pick, smem // b),
                "T": pick, "lanes": _tiled_lanes(S), "cluster": Q,
                "smem_bytes": b}
    return {"walk": "global", "threads": _GLOBAL_BLOCK, "T": _GLOBAL_BLOCK,
            "lanes": 1, "cluster": 0, "smem_bytes": 0}


def pruning_launch(lr, pstep, tips, scratch, root, ls, plan, masks=None,
                   sched=None) -> int:
    """One launch of ``csrc/pruning.cu`` on preallocated outputs (scratch
    ``[C, n_int, K, S, P]`` on the global walk, else None; on a Strahler
    walk the ``masks`` of ``pack_tips`` and the schedule's buffer
    ``sched`` int32 [C, n_int, 4], else None) as ``plan``
    (``pruning_plan``) says, on the current stream of the operands'
    device.  Returns the CUDA error code (0 = success)."""
    C, n_int = lr.shape[:2]
    K, S = pstep.shape[3:5]
    n_tips, _, P = tips.shape
    dev = lr.device
    return library("pruning").lib.mb_pruning_down(
        lr.data_ptr(), pstep.data_ptr(), tips.data_ptr(),
        None if scratch is None else scratch.data_ptr(), root.data_ptr(),
        ls.data_ptr(), None if masks is None else masks.data_ptr(),
        None if sched is None else sched.data_ptr(), C, n_tips, n_int, K, S,
        P, WALKS.index(plan["walk"]), plan["threads"], plan["smem_bytes"],
        plan["T"], plan["lanes"], plan["cluster"], device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)


def launch_buffers(plan, C: int, n_int: int, K: int, S: int, P: int, dev):
    """The scratch a launch on ``plan`` needs beside its outputs:
    (scratch [C, n_int, K, S, P] on the global-scratch walk, the
    schedule's sched int32 [C, n_int, 4] on a Strahler walk), None where
    the walk needs none."""
    scratch = torch.empty((C, n_int, K, S, P), dtype=torch.float32,
                          device=dev) if plan["walk"] == "global" else None
    sched = torch.empty((C, n_int, 4), dtype=torch.int32, device=dev) \
        if plan["walk"] in STRAHLER_WALKS else None
    return scratch, sched


def pruning_down(lr: torch.Tensor, pstep: torch.Tensor, tips: torch.Tensor,
                 masks: torch.Tensor | None = None):
    """Launch the CUDA down-pass.  lr int32 [C, n_int, 2] child slots per
    step; pstep f32 [C, n_int, 2, K, S, S]; tips f32 [n_tips, S, P];
    ``masks`` the tips packed by ``pack_tips`` (or None), which lets the
    size rule take a Strahler walk.  Returns (root [C, K, S, P],
    ls [C, P]).  Raises on anything the kernel does not take, and when
    the launch is refused."""
    C, n_int, K, S, n_tips, P = check_step_operands(lr, pstep, tips)
    check_cuda_operands("pruning_down", lr=lr, pstep=pstep, tips=tips)
    check_kernel_shape(S, K, "pruning_down")
    if masks is not None:
        check_cuda_operands("pruning_down", lr=lr, masks=masks)
        want = torch.uint8 if S <= 8 else torch.int32
        if masks.dtype != want \
                or tuple(masks.shape) != (n_tips, mask_pitch(S, P)):
            raise ValueError(f"masks must be {want} [{n_tips}, "
                             f"{mask_pitch(S, P)}], got {masks.dtype} "
                             f"{tuple(masks.shape)}")
    dev = lr.device
    plan = pruning_plan(C, n_tips, K, S, P, dev, masks is not None)
    scratch, sched = launch_buffers(plan, C, n_int, K, S, P, dev)
    root = torch.empty((C, K, S, P), dtype=torch.float32, device=dev)
    ls = torch.empty((C, P), dtype=torch.float32, device=dev)
    err = pruning_launch(lr, pstep, tips, scratch, root, ls, plan, masks,
                         sched)
    if err != 0:
        raise launch_error(library("pruning").lib, err, "pruning_down")
    return root, ls


def mask_pitch(S: int, P: int) -> int:
    """The row pitch of ``pack_tips``'s masks: P rounded up to a whole
    word for byte masks (S <= 8), P for 32-bit ones."""
    return -(-P // 4) * 4 if S <= 8 else P


def pack_tips(tips: torch.Tensor) -> torch.Tensor | None:
    """The Strahler walk's tips (``csrc/strahler_walk.cuh``): bit j of tip
    t's mask at pattern p is tips[t, j, p], for tips [n_tips, S, P] whose
    every entry is exactly 0 or 1.  uint8 [n_tips, pitch] (P rounded up
    to a multiple of 4, zeros past P) for S <= 8, int32 [n_tips, P] (the
    bits of a uint32) up to S 32, on the tips' device; None for S > 32 or
    any other entry, where the tips stay floats."""
    n_tips, S, P = tips.shape
    if S > 32 or not bool(((tips == 0) | (tips == 1)).all()):
        return None
    bit = torch.arange(S, device=tips.device, dtype=torch.int64)
    word = ((tips != 0).to(torch.int64) << bit[None, :, None]).sum(1)
    if S > 8:
        # the bits of a uint32 in an int32
        return torch.where(word >= 2 ** 31, word - 2 ** 32,
                           word).to(torch.int32)
    out = torch.zeros((n_tips, mask_pitch(S, P)), dtype=torch.uint8,
                      device=tips.device)
    out[:, :P] = word.to(torch.uint8)
    return out


def pruning_down_plain(lr: torch.Tensor, pstep: torch.Tensor,
                       tips: torch.Tensor):
    """The plain PyTorch version of ``pruning_down``: same operands, same
    results, on any device."""
    C, n_int, K, S, n_tips, P = check_step_operands(lr, pstep, tips)
    rows = torch.arange(C, device=lr.device)
    cl = tips.new_empty((C, n_tips + n_int, K, S, P))
    cl[:, :n_tips] = tips[None, :, None]
    ls = tips.new_zeros((C, P))
    slots = lr.long()
    for i in range(n_int):
        wl = torch.einsum("cksj,ckjp->cksp", pstep[:, i, 0],
                          cl[rows, slots[:, i, 0]])
        wr = torch.einsum("cksj,ckjp->cksp", pstep[:, i, 1],
                          cl[rows, slots[:, i, 1]])
        x = wl * wr
        m = torch.clamp_min(x.amax(dim=(1, 2)), _TINY)      # [C, P]
        cl[:, n_tips + i] = x / m[:, None, None]
        ls = ls + torch.log(m)
    return cl[:, -1], ls


def slot_operands(order, left, right, n_tips: int):
    """Slot relabelling on the device, batched over chains: node
    order[c, i] computes into slot n_tips + i, so a kernel reads children
    by slot.  order [C, n_int]; left/right [C, n_nodes].  Returns (lr int32
    [C, n_int, 2], left children [C, n_int], right children [C, n_int])."""
    C, n_int = order.shape
    ar = torch.arange(n_tips + n_int, device=order.device)
    slot = ar.expand(C, -1).scatter(1, order, ar[n_tips:].expand(C, -1))
    lch = left.gather(1, order)
    rch = right.gather(1, order)
    lr = torch.stack([slot.gather(1, lch), slot.gather(1, rch)], -1)
    return lr.to(torch.int32), lch, rch


def strahler_schedule(lr, n_tips: int) -> np.ndarray:
    """The Python twin of the Strahler walk's pre-pass
    (``csrc/strahler_walk.cuh:strahler_schedule_kernel``) for one chain's
    child slots lr [n_int, 2], given in a postorder whose last step is the
    root: int64 [n_int, 4], row q the q-th step of the walk (its original
    step index, its left and right child codes, its slot).  The walk
    visits first, at every internal node, the child whose subtree needs
    more slots (its Strahler number with tips 0; the left one on a tie);
    a step's slot is its depth in the stack of live partials; a child code
    is a tip's index, or -(slot + 1) of an internal child."""
    lr = np.asarray(lr, np.int64)
    n_int = lr.shape[0]
    need = np.zeros(n_int, np.int64)
    size = np.zeros(n_int, np.int64)
    first = np.zeros(n_int, np.int64)
    for i, children in enumerate(lr):
        nd = [need[c - n_tips] if c >= n_tips else 0 for c in children]
        sz = [size[c - n_tips] if c >= n_tips else 0 for c in children]
        need[i] = nd[0] + 1 if nd[0] == nd[1] else max(nd)
        size[i] = sz[0] + sz[1] + 1
        first[i] = int(nd[1] > nd[0])
    pos = np.zeros(n_int, np.int64)
    depth = np.zeros(n_int, np.int64)
    pos[-1] = n_int - 1
    out = np.zeros((n_int, 4), np.int64)
    for i in range(n_int - 1, -1, -1):
        e, d = pos[i], depth[i]
        a, b = lr[i, first[i]], lr[i, 1 - first[i]]
        db = d
        if a >= n_tips:
            pos[a - n_tips] = e - size[i] + size[a - n_tips]
            depth[a - n_tips] = d
            db = d + 1
        if b >= n_tips:
            pos[b - n_tips], depth[b - n_tips] = e - 1, db
        codes = [c if c < n_tips else -depth[c - n_tips] - 1 for c in lr[i]]
        out[e] = (i, *codes, d)
    return out


def strahler_slot_map(lr, n_tips: int):
    """The Strahler walk's order and slots for one chain's child slots lr
    [n_int, 2] (``strahler_schedule``): (order [n_int], the original step
    the walk takes q-th; slot [n_int], step i's shared-memory slot).  At
    most ``strahler_slots(n_tips)`` slots are used."""
    sched = strahler_schedule(lr, n_tips)
    slot = np.empty(len(sched), np.int64)
    slot[sched[:, 0]] = sched[:, 3]
    return sched[:, 0].copy(), slot


def strahler_schedule_cuda(lr: torch.Tensor) -> torch.Tensor:
    """The Strahler walk's pre-pass alone on the card: int32
    [C, n_int, 4], each chain's ``strahler_schedule``."""
    check_cuda_operands("strahler_schedule", lr=lr)
    if lr.dtype != torch.int32 or lr.ndim != 3 or lr.shape[2] != 2:
        raise ValueError(f"lr must be int32 [C, n_int, 2], got {lr.dtype} "
                         f"{tuple(lr.shape)}")
    C, n_int = lr.shape[:2]
    sched = torch.empty((C, n_int, 4), dtype=torch.int32, device=lr.device)
    lib = library("pruning").lib
    err = lib.mb_strahler_schedule(
        lr.data_ptr(), sched.data_ptr(), C, n_int + 1, n_int,
        device_index(lr.device),
        torch.cuda.current_stream(lr.device).cuda_stream)
    if err != 0:
        raise launch_error(lib, err, "strahler_schedule")
    return sched


def live_slot_map(lr, n_tips: int, spare: bool = False) -> np.ndarray:
    """The Python twin of the on-chip walk's live-slot allocator
    (``csrc/onchip_walk.cuh:build_slot_map``), for one chain's child slots
    lr [n_int, 2] (slots below n_tips are tips, slot n_tips + j is step j's
    output).  Walking the steps in order, it frees the slot of each
    internal child and then takes the lowest free slot for the step; with
    ``spare`` (the tiled walk's map) it takes the step's slot first, so a
    step never writes a slot it reads.  Returns step i's shared-memory
    slot [n_int] int64; at most n_tips // 2 slots are used (one more with
    ``spare``)."""
    lr = np.asarray(lr)
    slot = np.empty(lr.shape[0], np.int64)
    free = [True] * (n_tips // 2 + spare)
    for i, children in enumerate(lr):
        if spare:
            slot[i] = free.index(True)
            free[slot[i]] = False
        for c in children:
            if c >= n_tips:
                free[slot[c - n_tips]] = True
        if not spare:
            slot[i] = free.index(True)
            free[slot[i]] = False
    return slot


class DivisionLayout:
    """Where each division's operands and outputs sit in the flat buffers
    of a group of divisions that share one tree, division d with its own
    K_d, S_d and P_d, for any chain count C.  With ``tree_per_member`` each
    member has its own tree (the gene trees of a BEST analysis): the child
    slots are lr [D, C, n_int, 2], member d's block at d * C * n_int * 2."""

    tree_per_member = False

    def __init__(self, n_tips: int, ks, ss, ps):
        self.n_tips, self.n_int = n_tips, n_tips - 1
        self.ks, self.ss, self.ps = ([int(v) for v in x]
                                     for x in (ks, ss, ps))
        self.D = len(self.ks)
        self._offsets: dict = {}

    def offsets(self, C: int) -> np.ndarray:
        """[D + 1, 7] int64: per division d, K_d, P_d and the element
        offsets of its operators, tips, scratch, root partials and
        log-scales; the last row holds the buffer sizes."""
        if C not in self._offsets:
            self._offsets[C] = self._make_offsets(C)
        return self._offsets[C]

    def _make_offsets(self, C: int) -> np.ndarray:
        n_int, rows = self.n_int, []
        at = np.zeros(5, np.int64)
        for K, S, P in zip(self.ks, self.ss, self.ps):
            rows.append([K, P, *at])
            at += [C * n_int * 2 * K * S * S, self.n_tips * S * P,
                   C * n_int * K * S * P, C * K * S * P, C * P]
        return np.asarray(rows + [[0, 0, *at]], np.int64)

    def check(self, lr, pstep, tips) -> int:
        """Raise unless the operands fit this layout; returns C."""
        if lr.dtype != torch.int32:
            raise TypeError(f"lr must be int32, got {lr.dtype}")
        if pstep.dtype != torch.float32 or tips.dtype != torch.float32:
            raise TypeError("pstep and tips must be float32")
        lead = (self.D,) if self.tree_per_member else ()
        if lr.ndim != 3 + len(lead) or lr.shape[:len(lead)] != lead \
                or lr.shape[-2:] != (self.n_int, 2):
            want = "".join(f"{d}, " for d in lead)
            raise ValueError(f"lr must be [{want}C, {self.n_int}, 2], got "
                             f"{tuple(lr.shape)}")
        C = lr.shape[-3]
        total = self.offsets(C)[-1]
        if pstep.ndim != 1 or pstep.numel() != total[2]:
            raise ValueError(f"pstep must be flat with {total[2]} elements, "
                             f"got {tuple(pstep.shape)}")
        if tips.ndim != 1 or tips.numel() != total[3]:
            raise ValueError(f"tips must be flat with {total[3]} elements, "
                             f"got {tuple(tips.shape)}")
        return C

    def div_view(self, root, ls, d: int):
        """(root [C, K_d, S_d, P_d], ls [C, P_d]) of division d from the
        flat outputs."""
        C = ls.numel() // sum(self.ps)
        o = self.offsets(C)
        K, S, P = self.ks[d], self.ss[d], self.ps[d]
        r = root[o[d, 5]:o[d + 1, 5]].view(C, K, S, P)
        return r, ls[o[d, 6]:o[d + 1, 6]].view(C, P)

    def lr_offset(self, C: int, d: int) -> int:
        """The element offset of member d's child slots in lr: 0 when the
        members share the tree."""
        return d * C * self.n_int * 2 if self.tree_per_member else 0

    def member_lr(self, lr, d: int):
        """Member d's child slots [C, n_int, 2]."""
        return lr[d] if self.tree_per_member else lr

    def div_operands(self, pstep, tips, C: int, d: int):
        """Division d's (pstep [C, n_int, 2, K_d, S_d, S_d], tips
        [n_tips, S_d, P_d]) views of the flat operands."""
        o = self.offsets(C)
        K, S, P = self.ks[d], self.ss[d], self.ps[d]
        return (pstep[o[d, 2]:o[d + 1, 2]].view(C, self.n_int, 2, K, S, S),
                tips[o[d, 3]:o[d + 1, 3]].view(self.n_tips, S, P))


class GroupLayout(DivisionLayout):
    """The layout of a group of divisions launched together through the
    tile map and per-division table of ``csrc/group_walk.cuh`` (the
    stacked and multiwalk kernels), the launch plan per (C, device) and
    the launch.  ``library_name`` names the kernel library; a subclass's
    ``launch_args`` are the arguments its launch takes after the tile
    map."""

    library_name = ""

    def __init__(self, n_tips: int, ks, ss, ps):
        super().__init__(n_tips, ks, ss, ps)
        self._plans: dict = {}

    def launch_args(self, plan) -> list:
        """The launch's arguments between the tile map and the chain
        count: here the on-chip and global tile counts."""
        return [plan["n_onchip"], plan["n_global"]]

    def plan(self, C: int, device, walk: str | None = None) -> dict:
        """The kernels' launch plan on ``device``, asked of the kernel
        library once per C: the size rule's ``threads`` a block and its
        shared memory ``smem_bytes``, each member's ``walks``, patterns a
        block ``T`` and ``lanes`` a pattern; the kernels' ``table``
        [D, 11] (K_d, S_d, P_d, the offsets of operators, tips, root, ls
        and scratch, the walk, the lanes, the offset of the member's child
        slots) and tile map ``tiles``
        [n_tiles, 2] (member, first pattern) on the device: the
        ``n_onchip`` tiles of the on-chip walks, the costliest members
        first, then the ``n_global`` tiles of the global-scratch walk; and
        the ``scratch`` floats of the members that take that walk.
        ``walk="global"`` puts every member on the global-scratch walk,
        the old walk, which ``chip_smoke.py`` times beside the on-chip
        one."""
        dev = torch.device(device)
        key = (C, device_index(dev), walk)
        if key not in self._plans:
            lib = library(self.library_name).lib
            kps = np.ascontiguousarray(
                np.stack([self.ks, self.ss, self.ps], 1), np.int32)
            D = self.D
            out = (ctypes.c_int * (2 + 3 * D))()
            err = lib.mb_group_plan(kps.ctypes.data, D, C, self.n_tips,
                                    key[1], out)
            if err != 0:
                raise launch_error(lib, err, f"{self.library_name}_plan")
            walks, T, G = (list(out[2 + j * D:2 + (j + 1) * D])
                           for j in range(3))
            if walk == "global":
                walks = [WALKS.index("global")] * D
                T, G = [GLOBAL_THREADS] * D, [1] * D
            o = self.offsets(C)
            table, scratch = [], 0
            for d, (K, S, P) in enumerate(zip(self.ks, self.ss, self.ps)):
                table.append([K, S, P, *o[d, [2, 3, 5, 6]], scratch,
                              walks[d], G[d], self.lr_offset(C, d)])
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
            raise ValueError(f"{self.library_name}_down takes at most 65535 "
                             f"pattern tiles, got {len(tiles)}")
        return np.asarray(tiles, np.int32).reshape(-1, 2), len(onchip)

    def launch(self, lr, pstep, tips, plan, scratch, root, ls) -> int:
        """One launch of the group's kernels on preallocated flat outputs
        (scratch with ``plan["scratch"]`` floats, or None when it is 0) as
        ``plan`` says, on the current stream of the operands' device.
        Returns the CUDA error code (0 = success)."""
        dev = lr.device
        fn = getattr(library(self.library_name).lib,
                     f"mb_{self.library_name}_down")
        return fn(
            lr.data_ptr(), pstep.data_ptr(), tips.data_ptr(),
            None if scratch is None else scratch.data_ptr(), root.data_ptr(),
            ls.data_ptr(), plan["table"].data_ptr(), plan["tiles"].data_ptr(),
            *self.launch_args(plan), lr.shape[-3], self.n_tips, self.n_int,
            plan["threads"], plan["smem_bytes"], device_index(dev),
            torch.cuda.current_stream(dev).cuda_stream)

    def down(self, lr, pstep, tips):
        """Check the operands, allocate the flat outputs and launch.
        Returns flat (root, ls).  Raises on anything the kernels do not
        take, and when the launch is refused."""
        what = f"{self.library_name}_down"
        C = self.check(lr, pstep, tips)
        check_cuda_operands(what, lr=lr, pstep=pstep, tips=tips)
        for K, S in zip(self.ks, self.ss):
            check_kernel_shape(S, K, what)
        dev = lr.device
        plan = self.plan(C, dev)
        total = self.offsets(C)[-1]
        scratch = torch.empty(plan["scratch"], dtype=torch.float32,
                              device=dev) if plan["scratch"] else None
        root = torch.empty(int(total[5]), dtype=torch.float32, device=dev)
        ls = torch.empty(int(total[6]), dtype=torch.float32, device=dev)
        err = self.launch(lr, pstep, tips, plan, scratch, root, ls)
        if err != 0:
            raise launch_error(library(self.library_name).lib, err, what)
        return root, ls

    def down_plain(self, lr, pstep, tips):
        """The plain PyTorch version of ``down``: same operands, same flat
        results, on any device (each member's walks through
        ``pruning_down_plain``)."""
        C = self.check(lr, pstep, tips)
        roots, lss = [], []
        for d in range(self.D):
            pst, tp = self.div_operands(pstep, tips, C, d)
            r, l_ = pruning_down_plain(self.member_lr(lr, d),
                                       pst.contiguous(), tp.contiguous())
            roots.append(r.reshape(-1))
            lss.append(l_.reshape(-1))
        return torch.cat(roots), torch.cat(lss)


class PruningCuda:
    """Per-division static wiring and the callable pruning op: the
    counterpart of ``PruningPallas``.

    Built once per (division, engine) from the constant tip partials
    [n_tips, P, S], with their masks (``pack_tips``) where every entry is
    0 or 1; calling it maps each chain's (postorder, left, right,
    P-tensor) to (root partials [C, K, S, P], logscale [C, P]).
    ``launches`` counts kernel launches (never plain-version calls),
    ``launches_by_walk`` the same by the size rule's walk; each launch
    also adds one to the spans counter ``pruning.walk.<walk>``.
    """

    def __init__(self, tips: np.ndarray, n_cats: int, device):
        n_tips, P, S = tips.shape
        self.n_tips, self.P, self.S, self.K = n_tips, P, S, n_cats
        host = torch.as_tensor(
            np.ascontiguousarray(np.transpose(tips, (0, 2, 1))),
            dtype=torch.float32)                                # [n, S, P]
        self.tips = host.to(device)
        masks = pack_tips(host)
        self.masks = None if masks is None else masks.to(device)
        self.launches = 0
        self.launches_by_walk: dict[str, int] = {}

    def operands(self, order, left, right, Pmat):
        """(lr int32 [C, n_int, 2], pstep [C, n_int, 2, K, S, S]) from
        order [C, n_int], left/right [C, n_nodes] and Pmat
        [C, n_nodes, K, S, S] (see ``slot_operands``)."""
        lr, lch, rch = slot_operands(order, left, right, self.n_tips)
        rows = torch.arange(order.shape[0], device=order.device)[:, None]
        pstep = torch.stack([Pmat[rows, lch], Pmat[rows, rch]], 2)
        return lr, pstep.contiguous()

    def __call__(self, order, left, right, Pmat):
        lr, pstep = self.operands(order, left, right, Pmat)
        with SPANS("gen.lnl.launch"):
            if self.tips.is_cuda:
                root, ls = pruning_down(lr, pstep, self.tips, self.masks)
                self.count_launch(lr.shape[0], lr.device)
                return root, ls
            return pruning_down_plain(lr, pstep, self.tips)

    def count_launch(self, C: int, dev):
        """Count one kernel launch at C chains under its walk."""
        walk = pruning_plan(C, self.n_tips, self.K, self.S, self.P, dev,
                            self.masks is not None)["walk"]
        self.launches += 1
        self.launches_by_walk[walk] = self.launches_by_walk.get(walk, 0) + 1
        SPANS.add(f"pruning.walk.{walk}", 1)
