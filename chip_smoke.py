"""Smoke run of mrbayes_tpu_torch on one CUDA GPU.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name, count, and name/power limit from nvidia-smi;
  2. build: compile csrc/pruning.cu with nvcc for sm_90a (-Xptxas -v);
  3. kernels: the CUDA pruning kernel against its plain PyTorch version on
     the card at the test shapes and the primates shapes, and their times;
  4. engine: primates GTR+I+G Metropolis-coupled MCMC at 4 and 32 chains
     through the library entry points (Engine, init_chains, run_block):
     the kernel's launch count over the timed blocks, max lnL, carried
     versus recomputed scores, and one block and one generation of each
     move type with host synchronisation made an error;
  5. golden: the gtr_ig rows of tests/golden_primates.json evaluated on
     the card against the reference MrBayes lnL.

It prints one JSON line describing the kernels, then the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PRIMATES = os.path.join(HERE, "tests", "data", "ref", "examples",
                        "primates.nex")
GOLDEN = os.path.join(HERE, "tests", "golden_primates.json")
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
RTOL = ATOL = 2e-5               # per-pattern lnL, kernel vs plain version
# (n_tips, P, S, K) of tests/test_pallas.py and tests/test_torch_pruning.py,
# the S = 2 and runtime-S paths, and primates
KERNEL_CASES = [(8, 137, 4, 4, C) for C in (1, 4, 8)] \
    + [(12, 434, 4, 1, C) for C in (1, 4, 8)] \
    + [(6, 40, 20, 2, C) for C in (1, 4, 8)] \
    + [(24, 64, 2, 4, 4), (6, 40, 61, 3, 4), (9, 70, 32, 16, 2)] \
    + [(12, 413, 4, 4, C) for C in (4, 32)]
WARM_GENS, BLOCK_GENS, BLOCKS, SYNC_GENS = 50, 200, 5, 50


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_case(torch, n_tips, P, S, K, C, seed):
    """Operands of one kernel call from a seed: each chain's random tree,
    row-stochastic per-branch operators and shared 0/1 tip partials."""
    from mrbayes_tpu_torch.ops.pruning_cuda import PruningCuda
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    from mrbayes_tpu_torch.trees import random_unrooted
    rng = np.random.default_rng(seed)
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    tips = (rng.random((n_tips, P, S)) < 0.4).astype(np.float32)
    tips[..., 0] = 1.0
    Pm = rng.random((C, 2 * n_tips - 1, K, S, S)).astype(np.float32) + 0.05
    Pm /= Pm.sum(-1, keepdims=True)
    pi = rng.random(S).astype(np.float32) + 0.2
    dev = torch.device("cuda")
    pruner = PruningCuda(tips, K, dev)

    def stack(field):
        return torch.as_tensor(np.stack([getattr(t, field) for t in trees]),
                               device=dev).long()

    left, right, parent = stack("left"), stack("right"), stack("parent")
    order = postorder_internal(parent, n_tips)
    lr, pstep = pruner.operands(order, left, right,
                                torch.as_tensor(Pm, device=dev))
    return lr, pstep, pruner.tips, torch.as_tensor(pi / pi.sum(),
                                                   device=dev)


def site_lnl(torch, root, ls, pi):
    K = root.shape[1]
    return torch.log(torch.einsum("cksp,s->cp", root, pi) / K) + ls


def time_events(torch, fn, n):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def phase_kernels(torch):
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    worst = 0.0
    timing = {}
    for i, (n_tips, P, S, K, C) in enumerate(KERNEL_CASES):
        lr, pstep, tips, pi = kernel_case(torch, n_tips, P, S, K, C, 100 + i)
        root_k, ls_k = PC.pruning_down(lr, pstep, tips)
        torch.cuda.synchronize()
        root_p, ls_p = PC.pruning_down_plain(lr, pstep, tips)
        a, b = site_lnl(torch, root_k, ls_k, pi), site_lnl(torch, root_p,
                                                          ls_p, pi)
        err = (a - b).abs()
        bad = (err > ATOL + RTOL * b.abs()).sum().item()
        worst = max(worst, err.max().item())
        log(f"kernel n_tips={n_tips} P={P} S={S} K={K} C={C}: max |dlnL| "
            f"{err.max().item():.3e} (lnL range {b.min().item():.1f}.."
            f"{b.max().item():.1f}) {'OK' if bad == 0 else 'MISMATCH'}")
        if bad:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"at {bad} patterns")
        if (n_tips, P, S, K) != (12, 413, 4, 4):
            continue
        # raw launches on preallocated outputs (kernel time), the wrapper
        # (operand checks + allocation + launch) and the plain version
        lib = PC.library().lib
        n_int = n_tips - 1
        scratch = torch.empty((C, n_int, K, S, P), device="cuda")
        root = torch.empty((C, K, S, P), device="cuda")
        ls = torch.empty((C, P), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def raw():
            lib.mb_pruning_down(lr.data_ptr(), pstep.data_ptr(),
                                tips.data_ptr(), scratch.data_ptr(),
                                root.data_ptr(), ls.data_ptr(), C, n_tips,
                                n_int, K, S, P, 0, stream)

        nbytes = 4 * (lr.numel() + pstep.numel() + tips.numel()
                      + root.numel() + ls.numel())
        flops = 2 * C * n_int * 2 * K * S * S * P
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = flops / H100_FP32_FLOPS * 1e3
        timing[C] = {
            "ms": time_events(torch, raw, 500),
            "wrapper_ms": time_events(
                torch, lambda: PC.pruning_down(lr, pstep, tips), 200),
            "plain_ms": time_events(
                torch, lambda: PC.pruning_down_plain(lr, pstep, tips), 20),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}
        log(f"kernel timing primates C={C}: {json.dumps(timing[C])}")
    return worst, timing


def primates_dataset():
    from mrbayes_tpu_torch.data import DataSet, make_divisions
    from mrbayes_tpu_torch.nexus.parser import read_nexus_file
    nf = read_nexus_file(PRIMATES)
    return DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                   divisions=make_divisions(nf.matrix))


def phase_engine(torch, ds, nchains, power_line):
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                 mcmc=McmcSettings(nruns=1, nchains=nchains, seed=3),
                 device="cuda")
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, WARM_GENS)
    torch.cuda.synchronize()
    pruner = eng._pruners[0]
    pruner.launches = 0                      # the main path's run starts
    rates = []
    for _ in range(BLOCKS):
        t0 = time.perf_counter()
        states, bk = eng.run_block(states, bk, BLOCK_GENS)
        torch.cuda.synchronize()
        rates.append(BLOCK_GENS / (time.perf_counter() - t0))
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, bk = eng.run_block(states, bk, SYNC_GENS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = pruner.launches               # ... and ends here
    gens = BLOCKS * BLOCK_GENS + SYNC_GENS
    if launches < gens:
        raise AssertionError(f"{launches} kernel launches for {gens} "
                             f"generations")
    # a short block need not draw every move type: run one generation of
    # each under the same sync check (outside the counted run)
    heats = 1.0 / (1.0 + eng.mcmc.temp * bk["temp_id"].float())
    u = torch.rand((nchains,), generator=bk["rng"], device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for m in range(len(eng.moves)):
            eng._chain_step(bk["rng"], states, heats, bk["tuning"][:, m],
                            1.0, m, u)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    max_lnl = states["lnL"].max().item()
    if not max_lnl > -8500.0:
        raise AssertionError(f"max lnL {max_lnl} <= -8500")
    cold = eng.cold_indices(bk)[0]
    fresh = eng.score(states)
    for k in ("lnL", "lnP_tree", "lnP_par"):
        a, b = states[k][cold].item(), fresh[k][cold].item()
        if abs(a - b) > 1e-3 + 1e-6 * abs(b):
            raise AssertionError(f"carried {k} {a} != recomputed {b}")
    rate = float(np.median(rates))
    swaps = int(bk["swap_tries"].sum().item())
    log(f"engine primates GTR+I+G {nchains} chains: median {rate:.1f} "
        f"gens/s over {BLOCKS} blocks of {BLOCK_GENS} gens (min "
        f"{min(rates):.1f}, max {max(rates):.1f}), max lnL "
        f"{max_lnl:.2f}, cold lnL {states['lnL'][cold].item():.3f}, "
        f"launches {launches} for {gens} gens, swap tries {swaps}, "
        f"no host sync in a {SYNC_GENS}-gen block or in any of the "
        f"{len(eng.moves)} move types; card {power_line}")
    return {"gens_per_s": rate, "gens_per_s_blocks": rates,
            "launches": launches, "gens": gens, "max_lnL": max_lnl}


def phase_golden(torch, ds):
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    from mrbayes_tpu_torch.trees import parse_newick
    rows = [r for r in json.load(open(GOLDEN)) if r["model"] == "gtr_ig"]
    eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                 mcmc=McmcSettings(nruns=1, nchains=1), device="cuda")
    worst = 0.0
    for rec in rows:
        t = parse_newick(rec["newick"], ds.taxa)
        st = {k: torch.as_tensor(np.asarray(getattr(t, k))[None],
                                 device="cuda").long()
              for k in ("left", "right", "parent")}
        st["blen"] = torch.as_tensor(np.asarray(t.blen, np.float32)[None],
                                     device="cuda")
        for k, f in (("pi", "pi"), ("revmat", "revmat")):
            st[k] = torch.tensor([[rec[f]]], dtype=torch.float32,
                                 device="cuda")
        st["shape"] = torch.tensor([[rec["alpha"]]], device="cuda")
        st["pinvar"] = torch.tensor([[rec["pinvar"]]], device="cuda")
        lnl = eng.log_likelihood(eng.refresh_eigs(st))[0].item()
        worst = max(worst, abs(lnl - rec["lnL"]))
        if abs(lnl - rec["lnL"]) >= 0.35:
            raise AssertionError(f"golden gtr_ig lnL {lnl} vs reference "
                                 f"{rec['lnL']}")
    log(f"golden gtr_ig: {len(rows)} rows, max |lnL - reference| "
        f"{worst:.4f} (limit 0.35)")
    return worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mrbayes_tpu_torch.ops import pruning_cuda as PC

    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    power_line = nvidia_smi_line()
    log(f"device: {name} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(power_line)

    # 2. build
    kb = PC.library(verbose=True)
    log(f"build: {kb.path} in {kb.seconds:.2f} s\n{kb.log.strip()}")

    # 3. kernels
    max_err, timing = phase_kernels(torch)

    # 4. engine (the main path)
    ds = primates_dataset()
    log(f"primates: {ds.ntax} taxa, {ds.divisions[0].npat} patterns")
    runs = {C: phase_engine(torch, ds, C, power_line) for C in (4, 32)}

    # 5. golden
    phase_golden(torch, ds)

    t4, t32 = timing[4], timing[32]
    kernels = [{
        "name": "pruning_down",
        "route": "cuda",
        "source": "mrbayes_tpu_torch/csrc/pruning.cu",
        "replaces": "mrbayes_tpu/ops/pruning_pallas.py:94",
        "launches": sum(r["launches"] for r in runs.values()),
        "launches_per_run": {f"c{C}": r["launches"] for C, r in runs.items()},
        "gens_per_run": {f"c{C}": r["gens"] for C, r in runs.items()},
        "max_abs_err": max_err,
        "max_err": max_err,
        "ms": t4["ms"],
        "kernel_ms": t4["ms"],
        "wrapper_ms": t4["wrapper_ms"],
        "plain_ms": t4["plain_ms"],
        "bound_ms": t4["bound_ms"],
        "bound_by": t4["bound_by"],
        "library_ms": None,
        "shape": "primates n_tips=12 P=413 K=4 S=4 C=4",
        "c32": {k: t32[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                    "bound_ms", "bound_by")},
        "gens_per_s": {f"c{C}": r["gens_per_s"] for C, r in runs.items()},
        "gens_per_s_blocks": {f"c{C}": r["gens_per_s_blocks"]
                              for C, r in runs.items()},
        "card": power_line,
    }]
    log(power_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
