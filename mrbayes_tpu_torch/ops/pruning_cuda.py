"""The fused Felsenstein down-pass as a hand-written CUDA kernel.

Counterpart of ``mrbayes_tpu/ops/pruning_pallas.py`` (``_kernel_g``, wired
by ``PruningPallas``).  The kernel source is ``csrc/pruning.cu``; its
header comment records what bounds it on an H100 (latency: the
n_int-step dependent chain plus the launch) and what its design does
about that.  It is compiled with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` beside this package (listed in ``.gitignore``) and loaded with
``ctypes`` through a plain C interface.

Differences from the TPU layout, all deliberate:
  * per-category S×S operators ``Pstep [C, n_int, 2, K, S, S]`` instead of
    block-diagonal [KSp, KSp] ones (no K-fold zero work);
  * ``tips [n_tips, S, P]`` once, shared by all chains (no K-tiling);
  * no padding of P or K·S; the kernel masks the ragged pattern edge;
  * one grid slice per chain (no walk interleaving).

``pruning_down`` launches the kernel and takes CUDA tensors only;
``pruning_down_plain`` is its plain PyTorch version, the same function on
any device.  ``PruningCuda`` sends a CUDA tensor to the kernel and a CPU
tensor to the plain version; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

_TINY = 1e-30
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "csrc", "pruning.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, "_build")
MAX_RUNTIME_S = 64
MAX_RUNTIME_K = 16
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


class KernelBuild:
    """The loaded shared library plus how it was built."""

    def __init__(self, lib, path: str, seconds: float, log: str):
        self.lib, self.path, self.seconds, self.log = lib, path, seconds, log


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(verbose: bool = False) -> KernelBuild:
    """Compile ``csrc/pruning.cu`` (skipped when a library built from the
    same source and flags exists) and load it.  ``verbose`` adds
    ``-Xptxas -v`` so the log reports registers, shared memory and
    spills per kernel instantiation."""
    with open(_SRC, "rb") as f:
        src = f.read()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    path = os.path.abspath(os.path.join(_BUILD_DIR, f"libpruning_{tag}.so"))
    log, seconds = "", 0.0
    if verbose or not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, _SRC],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.mb_pruning_down.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.mb_pruning_down.restype = ctypes.c_int
    lib.mb_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mb_cuda_error_string.restype = ctypes.c_char_p
    return KernelBuild(lib, path, seconds, log)


class _Library:
    """The process's loaded kernel library, built on first use."""

    def __init__(self):
        self.build: KernelBuild | None = None

    def get(self, verbose: bool = False) -> KernelBuild:
        if self.build is None:
            self.build = build(verbose)
        return self.build


_LIBRARY = _Library()


def library(verbose: bool = False) -> KernelBuild:
    """The loaded kernel library (built now if this process has not built
    it yet; ``verbose`` applies to that build)."""
    return _LIBRARY.get(verbose)


def _check_operands(lr, pstep, tips):
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


def pruning_down(lr: torch.Tensor, pstep: torch.Tensor, tips: torch.Tensor):
    """Launch the CUDA down-pass.  lr int32 [C, n_int, 2] child slots per
    step; pstep f32 [C, n_int, 2, K, S, S]; tips f32 [n_tips, S, P].
    Returns (root [C, K, S, P], ls [C, P]).  Raises on anything the kernel
    does not take, and when the launch is refused."""
    C, n_int, K, S, n_tips, P = _check_operands(lr, pstep, tips)
    for name, t in (("lr", lr), ("pstep", pstep), ("tips", tips)):
        if not t.is_cuda:
            raise ValueError(f"pruning_down: {name} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"pruning_down: {name} is not contiguous")
        if t.device != lr.device:
            raise ValueError("pruning_down: operands on different devices")
    if S not in (2, 4, 20) and not (
            S <= MAX_RUNTIME_S and K <= MAX_RUNTIME_K):
        raise ValueError(f"pruning_down supports S in (2, 4, 20) or S <= "
                         f"{MAX_RUNTIME_S} with K <= {MAX_RUNTIME_K}; got "
                         f"S={S}, K={K}")
    lib = _LIBRARY.get().lib
    dev = lr.device
    scratch = torch.empty((C, n_int, K, S, P), dtype=torch.float32,
                          device=dev)
    root = torch.empty((C, K, S, P), dtype=torch.float32, device=dev)
    ls = torch.empty((C, P), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mb_pruning_down(
        lr.data_ptr(), pstep.data_ptr(), tips.data_ptr(), scratch.data_ptr(),
        root.data_ptr(), ls.data_ptr(), C, n_tips, n_int, K, S, P,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    if err != 0:
        msg = lib.mb_cuda_error_string(err).decode()
        raise RuntimeError(f"pruning_down launch failed: CUDA error {err} "
                           f"({msg})")
    return root, ls


def pruning_down_plain(lr: torch.Tensor, pstep: torch.Tensor,
                       tips: torch.Tensor):
    """The plain PyTorch version of ``pruning_down``: same operands, same
    results, on any device."""
    C, n_int, K, S, n_tips, P = _check_operands(lr, pstep, tips)
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


class PruningCuda:
    """Per-division static wiring and the callable pruning op: the
    counterpart of ``PruningPallas``.

    Built once per (division, engine) from the constant tip partials
    [n_tips, P, S]; calling it maps each chain's (postorder, left, right,
    P-tensor) to (root partials [C, K, S, P], logscale [C, P]).
    ``launches`` counts kernel launches (never plain-version calls).
    """

    def __init__(self, tips: np.ndarray, n_cats: int, device):
        n_tips, P, S = tips.shape
        self.n_tips, self.P, self.S, self.K = n_tips, P, S, n_cats
        self.tips = torch.as_tensor(
            np.ascontiguousarray(np.transpose(tips, (0, 2, 1))),
            dtype=torch.float32, device=device)                 # [n, S, P]
        self.launches = 0

    def operands(self, order, left, right, Pmat):
        """Slot relabelling on the device, batched over chains: node
        order[c, i] computes into slot n_tips + i, so the kernel reads
        children by slot.  order [C, n_int]; left/right [C, n_nodes];
        Pmat [C, n_nodes, K, S, S].  Returns (lr int32 [C, n_int, 2],
        pstep [C, n_int, 2, K, S, S])."""
        C, n_int = order.shape
        n_tips = self.n_tips
        ar = torch.arange(n_tips + n_int, device=order.device)
        slot = ar.expand(C, -1).scatter(1, order, ar[n_tips:].expand(C, -1))
        lch = left.gather(1, order)
        rch = right.gather(1, order)
        lr = torch.stack([slot.gather(1, lch), slot.gather(1, rch)], -1)
        rows = torch.arange(C, device=order.device)[:, None]
        pstep = torch.stack([Pmat[rows, lch], Pmat[rows, rch]], 2)
        return lr.to(torch.int32), pstep.contiguous()

    def __call__(self, order, left, right, Pmat):
        lr, pstep = self.operands(order, left, right, Pmat)
        if self.tips.is_cuda:
            root, ls = pruning_down(lr, pstep, self.tips)
            self.launches += 1
            return root, ls
        return pruning_down_plain(lr, pstep, self.tips)
