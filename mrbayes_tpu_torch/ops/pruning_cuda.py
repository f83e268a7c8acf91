"""The fused Felsenstein down-pass as a hand-written CUDA kernel.

Counterpart of ``mrbayes_tpu/ops/pruning_pallas.py`` (``_kernel_g``, wired
by ``PruningPallas``).  The kernel source is ``csrc/pruning.cu``; its
header comment records what bounds it on an H100 (latency: the
n_int-step dependent chain plus the launch) and what its design does
about that.  It is compiled with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` beside this package (listed in ``.gitignore``) and loaded with
``ctypes`` through a plain C interface.  The per-thread walk is shared
with the multiwalk kernel (``csrc/down_pass.cuh``).

Differences from the TPU layout, all deliberate:
  * per-category S×S operators ``Pstep [C, n_int, 2, K, S, S]`` instead of
    block-diagonal [KSp, KSp] ones (no K-fold zero work);
  * ``tips [n_tips, S, P]`` once, shared by all chains (no K-tiling);
  * no padding of P or K·S; the kernel masks the ragged pattern edge;
  * one grid slice per chain (no walk interleaving).

The kernel library is built together with the multiwalk kernel's
(``csrc/multiwalk.cu``, wired by ``ops/multiwalk_cuda.py``) and the
wavefront kernel's (``csrc/wavefront.cu``, wired by
``ops/wavefront_cuda.py``): ``build`` starts one ``nvcc`` per source at
once.  The stacked-division path (``ops/stacked_cuda.py``) launches this
kernel at K = 1 and S = the union width of its divisions, which the
runtime-S path takes up to ``MAX_RUNTIME_S``.

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
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, "_build")
# one shared library per source, all compiled at once; every source
# includes the shared per-thread walk
SOURCES = {"pruning": "pruning.cu", "multiwalk": "multiwalk.cu",
           "wavefront": "wavefront.cu"}
_HEADERS = ("down_pass.cuh",)
# the runtime-S path keeps no per-S arrays, so its cap is only a sanity
# bound; it must take the stacked path's union width (up to 96 at K = 1)
MAX_RUNTIME_S = 128
MAX_RUNTIME_K = 16
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ENTRY_POINTS = {
    "pruning": ("mb_pruning_down", [_PTR] * 6 + [_INT] * 7 + [_PTR]),
    "multiwalk": ("mb_multiwalk_down", [_PTR] * 7 + [_INT] * 7 + [_PTR]),
    "wavefront": ("mb_wavefront_down", [_PTR] * 10 + [_INT] * 9 + [_PTR]),
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
        fn_name, argtypes = _ENTRY_POINTS[name]
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
    """One loaded kernel library (``pruning``, ``multiwalk`` or
    ``wavefront``)."""
    return _LIBRARIES.get()[name]


def launch_error(lib, err: int, what: str) -> RuntimeError:
    msg = lib.mb_cuda_error_string(err).decode()
    return RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def check_kernel_shape(S: int, K: int, what: str):
    """Raise unless the kernels take S states with K rate categories."""
    if S not in (2, 4, 20) and not (
            S <= MAX_RUNTIME_S and K <= MAX_RUNTIME_K):
        raise ValueError(f"{what} supports S in (2, 4, 20) or S <= "
                         f"{MAX_RUNTIME_S} with K <= {MAX_RUNTIME_K}; got "
                         f"S={S}, K={K}")


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
    check_cuda_operands("pruning_down", lr=lr, pstep=pstep, tips=tips)
    check_kernel_shape(S, K, "pruning_down")
    lib = library("pruning").lib
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
        raise launch_error(lib, err, "pruning_down")
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
        """(lr int32 [C, n_int, 2], pstep [C, n_int, 2, K, S, S]) from
        order [C, n_int], left/right [C, n_nodes] and Pmat
        [C, n_nodes, K, S, S] (see ``slot_operands``)."""
        lr, lch, rch = slot_operands(order, left, right, self.n_tips)
        rows = torch.arange(order.shape[0], device=order.device)[:, None]
        pstep = torch.stack([Pmat[rows, lch], Pmat[rows, rch]], 2)
        return lr, pstep.contiguous()

    def __call__(self, order, left, right, Pmat):
        lr, pstep = self.operands(order, left, right, Pmat)
        if self.tips.is_cuda:
            root, ls = pruning_down(lr, pstep, self.tips)
            self.launches += 1
            return root, ls
        return pruning_down_plain(lr, pstep, self.tips)
