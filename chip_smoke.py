"""Smoke run of mrbayes_tpu_torch on one CUDA GPU.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py [--test1-gens N] [--primates-blocks N]

Phases, each fatal on failure:
  1. device: the card's name, count, and name/power limit from nvidia-smi;
  2. build: compile every csrc/*.cu with nvcc for sm_90a (-Xptxas -v), one
     nvcc per source, all started together;
  3. kernels: the single-division pruning kernel and the multiwalk kernel
     against their plain PyTorch versions on the card, at the test shapes,
     primates' and test1's, and their times;
  4. primates: GTR+I+G Metropolis-coupled MCMC at 4 and 32 chains through
     the library entry points (Engine, init_chains, run_block): the
     pruning kernel's launches over the timed blocks, max lnL, carried
     versus recomputed scores, one block and one generation of each move
     type with host synchronisation made an error;
  5. golden gtr_ig: the tests/golden_primates.json rows on the card;
  6. test1: testing/test1.nex (two partitions, nst=mixed, invgamma,
     unlinked parameters, ratepr=variable, 2 runs x 4 chains, 20,000
     generations) through cli.Interpreter.execute_file with the multiwalk
     switch on: the reference's envelope on the written files, the
     multiwalk kernel's launches, carried versus recomputed scores, and
     the sump and sumt tables;
  7. switch: the same test1 engine with the multiwalk switch off and on,
     3 blocks of 200 generations each, in turns;
  8. sync: a block and one generation of each test1 move type with host
     synchronisation made an error;
  9. golden partitioned: the primates_part2_unlinked_gtr_g rows of
     tests/golden_extra.json through the port's CLI and engine.

It prints one JSON line describing the kernels, then the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "tests", "data", "ref", "examples")
PRIMATES = os.path.join(EXAMPLES, "primates.nex")
GOLDEN = os.path.join(HERE, "tests", "golden_primates.json")
GOLDEN_EXTRA = os.path.join(HERE, "tests", "golden_extra.json")
OUT = os.path.join(HERE, "runs")           # run outputs (gitignored)
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
RTOL = ATOL = 2e-5               # per-pattern lnL, kernel vs plain version
# (n_tips, P, S, K, C) of tests/test_pallas.py and tests/test_torch_pruning.py,
# the S = 2 and runtime-S paths, and primates
KERNEL_CASES = [(8, 137, 4, 4, C) for C in (1, 4, 8)] \
    + [(12, 434, 4, 1, C) for C in (1, 4, 8)] \
    + [(6, 40, 20, 2, C) for C in (1, 4, 8)] \
    + [(24, 64, 2, 4, 4), (6, 40, 61, 3, 4), (9, 70, 32, 16, 2)] \
    + [(12, 413, 4, 4, C) for C in (4, 32)]
# multiwalk groups (n_tips, P_d, K_d, S, C): test1 at 8 and 32 chains, a
# group mixing K = 1 and K = 4, three divisions, and the S = 20 and
# runtime-S paths.  One group shares one S (the engine groups by S).
TEST1_SHAPE = (12, (199, 258), (4, 4), 4)
MULTIWALK_CASES = [TEST1_SHAPE + (8,), TEST1_SHAPE + (32,),
                   (12, (199, 258), (1, 4), 4, 8),
                   (12, (137, 40, 300), (4, 2, 1), 4, 4),
                   (6, (40, 64), (2, 1), 20, 4),
                   (6, (40, 23), (3, 1), 61, 2)]
WARM_GENS, BLOCK_GENS, SYNC_GENS = 50, 200, 50
DEV = "cuda"
TEST1_GENS = 20000


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_walks(torch, rng, n_tips, C):
    """Each chain's random tree on the card: (order, left, right)."""
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    from mrbayes_tpu_torch.trees import random_unrooted
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]

    def stack(field):
        return torch.as_tensor(np.stack([getattr(t, field) for t in trees]),
                               device=DEV).long()

    left, right, parent = stack("left"), stack("right"), stack("parent")
    return postorder_internal(parent, n_tips), left, right


def random_operands(rng, n_tips, P, S, K, C):
    """0/1 tip partials, row-stochastic per-branch operators and a pi."""
    tips = (rng.random((n_tips, P, S)) < 0.4).astype(np.float32)
    tips[..., 0] = 1.0
    Pm = rng.random((C, 2 * n_tips - 1, K, S, S)).astype(np.float32) + 0.05
    Pm /= Pm.sum(-1, keepdims=True)
    pi = rng.random(S).astype(np.float32) + 0.2
    return tips, Pm, pi / pi.sum()


def kernel_case(torch, n_tips, P, S, K, C, seed):
    """Operands of one single-division kernel call from a seed."""
    from mrbayes_tpu_torch.ops.pruning_cuda import PruningCuda
    rng = np.random.default_rng(seed)
    order, left, right = random_walks(torch, rng, n_tips, C)
    tips, Pm, pi = random_operands(rng, n_tips, P, S, K, C)
    pruner = PruningCuda(tips, K, torch.device(DEV))
    lr, pstep = pruner.operands(order, left, right,
                                torch.as_tensor(Pm, device=DEV))
    return lr, pstep, pruner.tips, torch.as_tensor(pi, device=DEV)


def multiwalk_case(torch, n_tips, Ps, Ks, S, C, seed):
    """Operands of one multiwalk call from a seed: the group's wiring,
    lr, the flat operators and one pi per division."""
    from mrbayes_tpu_torch.ops.multiwalk_cuda import PruningCudaMultiwalk
    rng = np.random.default_rng(seed)
    order, left, right = random_walks(torch, rng, n_tips, C)
    specs, P_list, pis = [], [], []
    for P, K in zip(Ps, Ks):
        tips, Pm, pi = random_operands(rng, n_tips, P, S, K, C)
        specs.append((tips, K))
        P_list.append(torch.as_tensor(Pm, device=DEV))
        pis.append(torch.as_tensor(pi, device=DEV))
    group = PruningCudaMultiwalk(specs, torch.device(DEV))
    lr, pstep = group.operands(order, left, right, P_list)
    return group, lr, pstep, pis


def site_lnl(torch, root, ls, pi):
    K = root.shape[1]
    return torch.log(torch.einsum("cksp,s->cp", root, pi) / K) + ls


def compare(torch, a, b, what):
    err = (a - b).abs()
    bad = (err > ATOL + RTOL * b.abs()).sum().item()
    log(f"{what}: max |dlnL| {err.max().item():.3e} (lnL range "
        f"{b.min().item():.1f}..{b.max().item():.1f}) "
        f"{'OK' if bad == 0 else 'MISMATCH'}")
    if bad:
        raise AssertionError(f"{what}: the kernel disagrees with its plain "
                             f"version at {bad} patterns")
    return err.max().item()


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


def bound(nbytes, flops):
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}


def phase_kernels(torch):
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    worst = 0.0
    timing = {}
    for i, (n_tips, P, S, K, C) in enumerate(KERNEL_CASES):
        lr, pstep, tips, pi = kernel_case(torch, n_tips, P, S, K, C, 100 + i)
        root_k, ls_k = PC.pruning_down(lr, pstep, tips)
        torch.cuda.synchronize()
        root_p, ls_p = PC.pruning_down_plain(lr, pstep, tips)
        worst = max(worst, compare(
            torch, site_lnl(torch, root_k, ls_k, pi),
            site_lnl(torch, root_p, ls_p, pi),
            f"pruning_down n_tips={n_tips} P={P} S={S} K={K} C={C}"))
        if (n_tips, P, S, K) != (12, 413, 4, 4):
            continue
        # raw launches on preallocated outputs (kernel time), the wrapper
        # (operand checks + allocation + launch) and the plain version
        lib = PC.library("pruning").lib
        n_int = n_tips - 1
        scratch = torch.empty((C, n_int, K, S, P), device=DEV)
        root = torch.empty((C, K, S, P), device=DEV)
        ls = torch.empty((C, P), device=DEV)
        stream = torch.cuda.current_stream().cuda_stream

        def raw():
            lib.mb_pruning_down(lr.data_ptr(), pstep.data_ptr(),
                                tips.data_ptr(), scratch.data_ptr(),
                                root.data_ptr(), ls.data_ptr(), C, n_tips,
                                n_int, K, S, P, 0, stream)

        timing[C] = {
            "ms": time_events(torch, raw, 500),
            "wrapper_ms": time_events(
                torch, lambda: PC.pruning_down(lr, pstep, tips), 200),
            "plain_ms": time_events(
                torch, lambda: PC.pruning_down_plain(lr, pstep, tips), 20),
            **bound(4 * (lr.numel() + pstep.numel() + tips.numel()
                         + root.numel() + ls.numel()),
                    2 * C * n_int * 2 * K * S * S * P)}
        log(f"pruning_down timing primates C={C}: {json.dumps(timing[C])}")
    return worst, timing


def phase_multiwalk_kernels(torch):
    from mrbayes_tpu_torch.ops import multiwalk_cuda as MW
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    worst = 0.0
    timing = {}
    log("multiwalk: mixed S in one group is not a case: the engine groups "
        "divisions by state count (csrc/multiwalk.cu)")
    for i, (n_tips, Ps, Ks, S, C) in enumerate(MULTIWALK_CASES):
        group, lr, pstep, pis = multiwalk_case(torch, n_tips, Ps, Ks, S, C,
                                               200 + i)
        lay = group.layout
        root_k, ls_k = MW.multiwalk_down(lr, pstep, group.tips, lay)
        torch.cuda.synchronize()
        root_p, ls_p = MW.multiwalk_down_plain(lr, pstep, group.tips, lay)
        for d in range(lay.D):
            worst = max(worst, compare(
                torch, site_lnl(torch, *lay.div_view(root_k, ls_k, d), pis[d]),
                site_lnl(torch, *lay.div_view(root_p, ls_p, d), pis[d]),
                f"multiwalk_down n_tips={n_tips} P={Ps} K={Ks} S={S} C={C} "
                f"division {d}"))
        if (n_tips, Ps, Ks, S) != TEST1_SHAPE:
            continue
        lib = MW.library("multiwalk").lib
        pr_lib = PC.library("pruning").lib
        n_int = n_tips - 1
        total = lay.offsets(C)[-1]
        table = lay.table(C, lr.device)
        scratch = torch.empty(int(total[4]), device=DEV)
        root = torch.empty(int(total[5]), device=DEV)
        ls = torch.empty(int(total[6]), device=DEV)
        stream = torch.cuda.current_stream().cuda_stream
        tips = group.tips

        def raw():
            lib.mb_multiwalk_down(
                lr.data_ptr(), pstep.data_ptr(), tips.data_ptr(),
                scratch.data_ptr(), root.data_ptr(), ls.data_ptr(),
                table.data_ptr(), lay.D, C, n_tips, n_int, S, lay.P_max, 0,
                stream)

        # the same work as one single-division launch per division
        per_div = []
        for d in range(lay.D):
            pst, tp = lay.div_operands(pstep, tips, C, d)
            K, P = lay.ks[d], lay.ps[d]
            per_div.append((pst, tp, K, P,
                            torch.empty((C, n_int, K, S, P), device=DEV),
                            torch.empty((C, K, S, P), device=DEV),
                            torch.empty((C, P), device=DEV)))

        def per_division():
            for pst, tp, K, P, sc, rt, l_ in per_div:
                pr_lib.mb_pruning_down(lr.data_ptr(), pst.data_ptr(),
                                       tp.data_ptr(), sc.data_ptr(),
                                       rt.data_ptr(), l_.data_ptr(), C,
                                       n_tips, n_int, K, S, P, 0, stream)

        flops = sum(2 * C * n_int * 2 * K * S * S * P
                    for K, P in zip(lay.ks, lay.ps))
        timing[C] = {
            "ms": time_events(torch, raw, 500),
            "wrapper_ms": time_events(
                torch, lambda: MW.multiwalk_down(lr, pstep, tips, lay), 200),
            "plain_ms": time_events(
                torch, lambda: MW.multiwalk_down_plain(lr, pstep, tips, lay),
                20),
            "pruning_down_per_division_ms": time_events(
                torch, per_division, 500),
            **bound(4 * (lr.numel() + pstep.numel() + tips.numel()
                         + root.numel() + ls.numel()) + 8 * table.numel(),
                    flops)}
        log(f"multiwalk_down timing test1 C={C}: {json.dumps(timing[C])}")
    return worst, timing


def primates_dataset():
    from mrbayes_tpu_torch.data import DataSet, make_divisions
    from mrbayes_tpu_torch.nexus.parser import read_nexus_file
    nf = read_nexus_file(PRIMATES)
    return DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                   divisions=make_divisions(nf.matrix))


def sync_checked(torch, eng, states, bk, n_gens):
    """A block and one generation of each move type with host
    synchronisation made an error (outside any counted run)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, bk = eng.run_block(states, bk, n_gens)
        heats = 1.0 / (1.0 + eng.mcmc.temp * bk["temp_id"].float())
        u = torch.rand((eng.mcmc.n_chains_total,), generator=bk["rng"],
                       device=DEV)
        for m in range(len(eng.moves)):
            eng._chain_step(bk["rng"], states, heats, bk["tuning"][:, m],
                            1.0, m, u)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return states, bk


def assert_carried(eng, states, bk):
    cold = eng.cold_indices(bk)[0]
    fresh = eng.score(states)
    for k in ("lnL", "lnP_tree", "lnP_par"):
        a, b = states[k][cold].item(), fresh[k][cold].item()
        if abs(a - b) > 1e-3 + 1e-6 * abs(b):
            raise AssertionError(f"carried {k} {a} != recomputed {b}")
    return cold


def phase_primates(torch, ds, nchains, blocks, power_line):
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                 mcmc=McmcSettings(nruns=1, nchains=nchains, seed=3),
                 device=DEV)
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, WARM_GENS)
    torch.cuda.synchronize()
    pruner = eng._pruners[0]
    pruner.launches = 0                      # the main path's run starts
    rates = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        states, bk = eng.run_block(states, bk, BLOCK_GENS)
        torch.cuda.synchronize()
        rates.append(BLOCK_GENS / (time.perf_counter() - t0))
    launches = pruner.launches               # ... and ends here
    gens = blocks * BLOCK_GENS
    if launches < gens:
        raise AssertionError(f"{launches} kernel launches for {gens} "
                             f"generations")
    states, bk = sync_checked(torch, eng, states, bk, SYNC_GENS)
    max_lnl = states["lnL"].max().item()
    if not max_lnl > -8500.0:
        raise AssertionError(f"max lnL {max_lnl} <= -8500")
    cold = assert_carried(eng, states, bk)
    rate = float(np.median(rates))
    log(f"primates GTR+I+G {nchains} chains: median {rate:.1f} gens/s over "
        f"{blocks} blocks of {BLOCK_GENS} gens (min {min(rates):.1f}, max "
        f"{max(rates):.1f}), max lnL {max_lnl:.2f}, cold lnL "
        f"{states['lnL'][cold].item():.3f}, pruning_down launches "
        f"{launches} for {gens} gens, no host sync in a {SYNC_GENS}-gen "
        f"block or in any of the {len(eng.moves)} move types; card "
        f"{power_line}")
    return {"gens_per_s": rate, "gens_per_s_blocks": rates,
            "launches": launches, "gens": gens, "max_lnL": max_lnl}


def phase_golden(torch, ds):
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    from mrbayes_tpu_torch.trees import parse_newick
    rows = [r for r in json.load(open(GOLDEN)) if r["model"] == "gtr_ig"]
    eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                 mcmc=McmcSettings(nruns=1, nchains=1), device=DEV)
    worst = 0.0
    for rec in rows:
        st = tree_state(torch, parse_newick(rec["newick"], ds.taxa))
        for k, f in (("pi", "pi"), ("revmat", "revmat")):
            st[k] = torch.tensor([[rec[f]]], dtype=torch.float32,
                                 device=DEV)
        st["shape"] = torch.tensor([[rec["alpha"]]], device=DEV)
        st["pinvar"] = torch.tensor([[rec["pinvar"]]], device=DEV)
        lnl = eng.log_likelihood(eng.refresh_eigs(st))[0].item()
        worst = max(worst, abs(lnl - rec["lnL"]))
        if abs(lnl - rec["lnL"]) >= 0.35:
            raise AssertionError(f"golden gtr_ig lnL {lnl} vs reference "
                                 f"{rec['lnL']}")
    log(f"golden gtr_ig: {len(rows)} rows, max |lnL - reference| "
        f"{worst:.4f} (limit 0.35)")
    return worst


def tree_state(torch, t):
    st = {k: torch.as_tensor(np.asarray(getattr(t, k))[None],
                             device=DEV).long()
          for k in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(np.asarray(t.blen, np.float32)[None],
                                 device=DEV)
    return st


def phase_test1(torch, ngen, power_line):
    """test1 through the CLI with the multiwalk switch on.  The engine is
    built inside ``execute_file``, so its launch counts start at 0 there
    and are read when the run is over."""
    from mrbayes_tpu_torch.envelope import envelope_errors, run_test1
    workdir = os.path.join(OUT, "test1")
    shutil.rmtree(workdir, ignore_errors=True)
    it, stats, lines = run_test1(workdir, ngen, device=DEV, multiwalk=True)
    runner = it._last_runner
    eng = runner.eng
    groups = eng._multiwalk_pruners
    if len(groups) != 1 or groups[0][0] != [0, 1]:
        raise AssertionError(f"expected test1's two divisions in one "
                             f"multiwalk group, got "
                             f"{[g for g, _ in groups]}")
    mw_launches = groups[0][1].launches
    pd_launches = sum(p.launches for p in eng._pruners)
    if mw_launches < ngen:
        raise AssertionError(f"{mw_launches} multiwalk launches for {ngen} "
                             f"generations")
    assert_carried(eng, runner.final_states, runner.final_bk)
    for phrase in ("Average PSRF for parameter values",
                   "Model probabilities for gtrsubmodel",
                   "Credible sets of trees", "Consensus tree written to"):
        if not any(phrase in ln for ln in lines):
            raise AssertionError(f"sump/sumt printed no {phrase!r}")
    n_rows = []
    for r in (1, 2):
        with open(os.path.join(workdir, f"test1.run{r}.p")) as f:
            n_rows.append(sum(1 for ln in f if ln[:1].isdigit()))
        with open(os.path.join(workdir, f"test1.run{r}.t")) as f:
            text = f.read()
        if not text.rstrip().endswith("end;") \
                or text.count("tree gen.") != n_rows[-1]:
            raise AssertionError(f"incomplete test1.run{r}.t")
    expect_rows = ngen // eng.mcmc.samplefreq + 1
    if n_rows != [expect_rows] * 2:
        raise AssertionError(f".p rows {n_rows}, expected {expect_rows}")
    if ngen >= TEST1_GENS:
        errors = envelope_errors(stats)
    else:
        errors = ([] if stats["best_lnl"] > -5800.0 else
                  [f"best lnL {stats['best_lnl']:.2f} <= -5800"])
    log(f"test1 through the CLI, multiwalk on: {json.dumps(stats)}; "
        f"multiwalk launches {mw_launches}, pruning_down launches "
        f"{pd_launches}, for {ngen} gens; card {power_line}")
    if errors:
        raise AssertionError(f"test1 outside its envelope: {errors}")
    return it, {**stats, "multiwalk_launches": mw_launches,
                "pruning_down_launches": pd_launches}


def phase_switch(torch, it, blocks, power_line):
    """gens/s of the test1 engine with the switch off and on, in turns."""
    engines = {sw: it.build_engine(multiwalk=sw) for sw in (False, True)}
    runs = {}
    for sw, eng in engines.items():
        states, bk = eng.init_chains()
        states, bk = eng.run_block(states, bk, WARM_GENS)
        runs[sw] = [states, bk]
    torch.cuda.synchronize()
    pr = engines[False]._pruners
    for p in pr:
        p.launches = 0                       # the switch-off run starts
    rates = {False: [], True: []}
    for b in range(blocks):
        for sw in ((False, True) if b % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            runs[sw] = list(engines[sw].run_block(*runs[sw], BLOCK_GENS))
            torch.cuda.synchronize()
            rates[sw].append(BLOCK_GENS / (time.perf_counter() - t0))
    off_launches = sum(p.launches for p in pr)   # ... and ends here
    if off_launches < 2 * blocks * BLOCK_GENS:
        raise AssertionError(f"{off_launches} pruning_down launches for "
                             f"{blocks * BLOCK_GENS} gens x 2 divisions")
    out = {"off": float(np.median(rates[False])),
           "on": float(np.median(rates[True])),
           "off_blocks": rates[False], "on_blocks": rates[True],
           "pruning_down_launches_off": off_launches}
    log(f"test1 switch off/on, {blocks} blocks of {BLOCK_GENS} gens each, "
        f"in turns: {json.dumps(out)}; card {power_line}")
    eng = engines[True]
    sync_checked(torch, eng, *runs[True], SYNC_GENS)
    names = ", ".join(m.name for m in eng.moves)
    log(f"test1: no host sync in a {SYNC_GENS}-gen block or in any of the "
        f"{len(eng.moves)} move types ({names})")
    return out


def phase_golden_partitioned(torch):
    from mrbayes_tpu_torch.cli import Interpreter
    from mrbayes_tpu_torch.trees import parse_newick
    rows = [r for r in json.load(open(GOLDEN_EXTRA))
            if r["name"] == "primates_part2_unlinked_gtr_g"]
    it = Interpreter(log=lambda m: None, device=DEV)
    for c in rows[0]["commands"]:
        it.run_line(c.replace("/root/reference/examples", EXAMPLES))
    worst = {}
    for sw in (False, True):
        eng = it.build_engine(multiwalk=sw)
        worst[sw] = 0.0
        for rec in rows:
            st = tree_state(torch, parse_newick(rec["newick"], eng.data.taxa))
            for k, v in rec["state"].items():
                st[k] = torch.tensor([v], dtype=torch.float32, device=DEV)
            lnl = eng.log_likelihood(eng.refresh_eigs(st))[0].item()
            worst[sw] = max(worst[sw], abs(lnl - rec["lnL"]))
            if abs(lnl - rec["lnL"]) >= rec["tol"]:
                raise AssertionError(
                    f"golden {rec['name']}@{rec['gen']} (multiwalk {sw}): "
                    f"lnL {lnl} vs reference {rec['lnL']}")
    log(f"golden primates_part2_unlinked_gtr_g: {len(rows)} rows, max "
        f"|lnL - reference| {worst[False]:.4f} per division, "
        f"{worst[True]:.4f} multiwalk (limit {rows[0]['tol']})")
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--test1-gens", type=int, default=TEST1_GENS)
    ap.add_argument("--primates-blocks", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    power_line = nvidia_smi_line()
    log(f"device: {name} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(power_line)

    # 2. build
    t0 = time.perf_counter()
    builds = PC.libraries(verbose=True)
    log(f"build: {len(builds)} libraries in {time.perf_counter() - t0:.2f} "
        f"s wall")
    for nm, kb in builds.items():
        log(f"build {nm}: {kb.path} in {kb.seconds:.2f} s\n{kb.log.strip()}")

    # 3. kernels
    err_pd, t_pd = phase_kernels(torch)
    err_mw, t_mw = phase_multiwalk_kernels(torch)

    # 4.-5. primates, the first slice's main path
    ds = primates_dataset()
    log(f"primates: {ds.ntax} taxa, {ds.divisions[0].npat} patterns")
    runs = {C: phase_primates(torch, ds, C, args.primates_blocks, power_line)
            for C in (4, 32)}
    phase_golden(torch, ds)

    # 6.-9. test1, this slice's main path
    it, t1 = phase_test1(torch, args.test1_gens, power_line)
    switch = phase_switch(torch, it, 3, power_line)
    phase_golden_partitioned(torch)

    keys = ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [{
        "name": "pruning_down",
        "route": "cuda",
        "source": "mrbayes_tpu_torch/csrc/pruning.cu",
        "replaces": "mrbayes_tpu/ops/pruning_pallas.py:94",
        "launches": sum(r["launches"] for r in runs.values()),
        "launches_per_run": {f"primates_c{C}": r["launches"]
                             for C, r in runs.items()},
        "gens_per_run": {f"primates_c{C}": r["gens"]
                         for C, r in runs.items()},
        "launches_test1_switch_off": switch["pruning_down_launches_off"],
        "max_abs_err": err_pd,
        "ms": t_pd[4]["ms"],
        "wrapper_ms": t_pd[4]["wrapper_ms"],
        "plain_ms": t_pd[4]["plain_ms"],
        "bound_ms": t_pd[4]["bound_ms"],
        "bound_by": t_pd[4]["bound_by"],
        "library_ms": None,
        "shape": "primates n_tips=12 P=413 K=4 S=4 C=4",
        "c32": {k: t_pd[32][k] for k in keys},
        "gens_per_s": {f"primates_c{C}": r["gens_per_s"]
                       for C, r in runs.items()},
        "gens_per_s_blocks": {f"primates_c{C}": r["gens_per_s_blocks"]
                              for C, r in runs.items()},
        "card": power_line,
    }, {
        "name": "multiwalk_down",
        "route": "cuda",
        "source": "mrbayes_tpu_torch/csrc/multiwalk.cu",
        "replaces": "mrbayes_tpu/ops/pruning_pallas.py:144",
        "launches": t1["multiwalk_launches"],
        "gens": args.test1_gens,
        "max_abs_err": err_mw,
        "ms": t_mw[8]["ms"],
        "wrapper_ms": t_mw[8]["wrapper_ms"],
        "plain_ms": t_mw[8]["plain_ms"],
        "pruning_down_per_division_ms":
            t_mw[8]["pruning_down_per_division_ms"],
        "bound_ms": t_mw[8]["bound_ms"],
        "bound_by": t_mw[8]["bound_by"],
        "library_ms": None,
        "shape": "test1 D=2 n_tips=12 P=199,258 K=4 S=4 C=8",
        "c32": {k: t_mw[32][k] for k in keys
                + ("pruning_down_per_division_ms",)},
        "test1": {k: t1[k] for k in ("best_lnl", "tl_mean", "asdsf",
                                     "avg_psrf", "run_s", "gens_per_s")},
        "test1_gens_per_s_switch": {"off": switch["off"],
                                    "on": switch["on"]},
        "card": power_line,
    }]
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    log(power_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
