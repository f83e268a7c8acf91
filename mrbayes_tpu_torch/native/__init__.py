"""Native host-side runtime components (C++, built on demand).

The reference's runtime around the sampler is native C (NEXUS machinery,
tree containers, sumt's split counters); the port keeps the compute
path in PyTorch and CUDA and rebuilds the host-side hot spots here.
`treeio.cpp` batch-parses .t tree-sample files into edge bitmask/branch
-length arrays for sumt/comparetree.

The shared library is compiled with the system g++ on first use into
``_build/`` beside the package (listed in ``.gitignore``) and cached by
source hash; any failure (no compiler, parse error) makes callers take
the pure-Python .t reader instead.  This is host code: no device work
falls back here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, os.pardir, "_build")
_LIB = None
_TRIED = False


def _build() -> str | None:
    src = os.path.join(_HERE, "treeio.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    out = os.path.abspath(os.path.join(_BUILD_DIR, f"treeio_{tag}.so"))
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = out + f".build{os.getpid()}"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except Exception:
        return None


def lib():
    """ctypes handle to the native library, or None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("MB_TPU_NO_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        L = ctypes.CDLL(path)
        L.mbt_parse_t.restype = ctypes.c_long
        L.mbt_parse_t.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_long, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ]
        _LIB = L
    except Exception:
        _LIB = None
    return _LIB


def parse_t_text(text: str, ntax: int):
    """Parse every tree line of a .t file's text.

    Returns (splits [T, E, W] uint64, blens [T, E] f64, nedges [T] i32,
    rooted [T] i8) or None when the native path is unavailable or the
    file contains non-numeric labels."""
    L = lib()
    if L is None:
        return None
    data = text.encode()
    # crude upper bound on the number of tree lines
    max_trees = text.count("tree ") + 1
    max_edges = 2 * ntax + 2
    nwords = (ntax + 63) // 64
    splits = np.zeros((max_trees, max_edges, nwords), np.uint64)
    blens = np.zeros((max_trees, max_edges), np.float64)
    nedges = np.zeros(max_trees, np.int32)
    rooted = np.zeros(max_trees, np.int8)
    n = L.mbt_parse_t(data, len(data), ntax, nwords, max_trees,
                      max_edges, splits, blens, nedges, rooted)
    if n < 0:
        return None
    return (splits[:n], blens[:n], nedges[:n], rooted[:n])
