"""Thread splits of ``csrc/eigh.cu`` timed against each other on one CUDA
GPU.

Usage (from the repository root, on a machine with a CUDA GPU and nvcc):

    python -m mrbayes_tpu_torch.eigh_bench [--out runs/eigh_bench.json]
        [--splits 61:512x8,61:256x8,20:64x2,...]

Each split ``S:PxW`` (S 20 or 61, or 0 for the runtime-S kernel; P
producer threads, W consumer warps) is a copy of ``csrc/eigh.cu`` whose
``Split<S>`` reads (P, W), built with ``nvcc -Xptxas -v`` (all at once)
into ``_build/eigh_bench/``.  Each is launched on seeded symmetrised
reversible generators (every fourth Poisson's) at its S's batches,
checked against ``torch.linalg.eigh`` (reconstruction within 1e-10 of
|A|) and timed from CUDA-graph replays of raw launches, beside the kept
first design on the same batch.  It prints one JSON object with the
card's name and power limit, each split's registers and spills, and its
ms per batch.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from .ops import pruning_cuda as PC

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build",
                    "eigh_bench")
# the splits timed by default, S:PxW (instantiation S, producers P,
# consumer warps W); the source's own split is the first of each S
SPLITS = "61:512x8,61:384x8,61:256x8,61:512x4,20:64x5,20:64x2,20:64x4," \
         "20:64x10,20:32x5,0:256x8,0:512x8"
# (B, S) batches timed for each instantiation: the main path's, and runtime
# S at the NY98 batch
CASES = {20: [(8, 20), (32, 20)], 61: [(24, 61), (96, 61)],
         0: [(24, 60), (24, 64)]}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def reversible_batch(rng, B: int, S: int) -> np.ndarray:
    """B seeded symmetrised reversible generators D^1/2 Q D^-1/2 [B, S, S]
    (float64): every fourth Poisson's (equal rates and frequencies: one
    eigenvalue S - 1 times), the others gamma(1) exchangeabilities and
    Dirichlet(2) frequencies."""
    out = []
    for i in range(B):
        poisson = i % 4 == 0
        pi = np.full(S, 1.0 / S) if poisson else rng.dirichlet(np.ones(S) * 2)
        ex = (np.ones(S * (S - 1) // 2) if poisson
              else rng.gamma(1.0, 1.0, S * (S - 1) // 2))
        R = np.zeros((S, S))
        R[np.triu_indices(S, 1)] = ex
        Q = (R + R.T) * pi[None]
        np.fill_diagonal(Q, -Q.sum(1))
        Q /= -(pi * np.diag(Q)).sum()
        sq = np.sqrt(pi)
        A = Q * (sq[:, None] / sq[None, :])
        out.append(0.5 * (A + A.T))
    return np.stack(out)


def split_source(src: str, S: int, producers: int, warps: int) -> str:
    """``src`` with Split<S> (the primary template for S = 0) set to
    (producers, warps)."""
    head = (r"template <int kS> struct Split \{" if S == 0
            else rf"template <> struct Split<{S}> \{{")
    pat = head + r"\n  static constexpr int producers = \d+, " \
                 r"consumer_warps = \d+;"
    new, count = re.subn(
        pat, lambda m: m.group(0).split("\n")[0] +
        f"\n  static constexpr int producers = {producers}, "
        f"consumer_warps = {warps};", src)
    if count != 1:
        raise ValueError(f"no Split<{S}> in csrc/eigh.cu")
    return new


def build(splits):
    """{split: (ctypes library, ptxas summary lines)}, one nvcc a split,
    all started together."""
    os.makedirs(_OUT, exist_ok=True)
    src = open(os.path.join(_CSRC, "eigh.cu")).read()
    jobs = {}
    for sp in splits:
        S, P, W = sp
        tag = f"eigh_{S}_{P}x{W}"
        cu = os.path.join(_OUT, tag + ".cu")
        with open(cu, "w") as f:
            f.write(split_source(src, S, P, W))
        so = os.path.join(_OUT, f"lib{tag}.so")
        jobs[sp] = (subprocess.Popen(
            [PC._nvcc(), *PC.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for sp, (proc, so) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on split {sp}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn in ("mb_eigh_jacobi", "mb_eigh_jacobi_before"):
            getattr(lib, fn).argtypes = [_PTR] * 4 + [_INT] * 3 + [_PTR]
            getattr(lib, fn).restype = ctypes.c_int
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        out[sp] = (lib, regs)
    return out


def graph_ms(fn, n=20, reps=3) -> float:
    """ms per call of ``fn`` (raw launches on the current stream) from
    CUDA events around replays of a graph of n calls."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * reps)


def settle(limit_s: float = 30.0):
    """Wait for the current stream, ending the process (exit 3) if it has
    not finished within ``limit_s``: a kernel that never ends would
    otherwise hold the card until the caller's time limit."""
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > limit_s:
            print(f"eigh_bench: no end after {limit_s} s", flush=True)
            os._exit(3)
        time.sleep(1e-3)


def time_split(lib, B: int, S: int, seed: int) -> dict:
    """The split's and the first design's ms on one seeded batch, after
    checking the split's reconstruction."""
    A = torch.tensor(reversible_batch(np.random.default_rng(seed), B, S),
                     dtype=torch.float64, device="cuda")
    w = torch.empty((B, S), dtype=torch.float64, device="cuda")
    V = torch.empty((B, S, S), dtype=torch.float64, device="cuda")
    sw = torch.empty(B, dtype=torch.int32, device="cuda")

    def launch(fn, sweeps=None):       # on the stream current at the call
        err = fn(A.data_ptr(), w.data_ptr(), V.data_ptr(),
                 None if sweeps is None else sweeps.data_ptr(), B, S, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    launch(lib.mb_eigh_jacobi, sw)
    settle()
    rec = ((V @ torch.diag_embed(w) @ V.transpose(-1, -2) - A).norm(
        dim=(1, 2)) / A.norm(dim=(1, 2))).max().item()
    if not rec <= 1e-10:
        raise AssertionError(f"B={B} S={S}: reconstruction {rec:.3e}")
    return {"ms": graph_ms(lambda: launch(lib.mb_eigh_jacobi)),
            "before_ms": graph_ms(lambda: launch(lib.mb_eigh_jacobi_before)),
            "sweeps_mean": float(sw.float().mean()), "reconstruction": rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splits", default=SPLITS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("eigh_bench: no CUDA device")
    splits = [tuple(int(x) for x in re.split("[:x]", sp))
              for sp in args.splits.split(",")]
    t0 = time.perf_counter()
    libs = build(splits)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    rows = []
    for sp in splits:
        lib, regs = libs[sp]
        row = {"split": f"{sp[0]}:{sp[1]}x{sp[2]}", "ptxas": regs}
        for i, (B, S) in enumerate(CASES[sp[0]]):
            row[f"B{B}_S{S}"] = time_split(lib, B, S, 300 + i)
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {"card": card, "wall_s": time.perf_counter() - t0,
              "splits": rows}
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
