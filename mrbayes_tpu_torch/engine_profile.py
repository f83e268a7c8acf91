"""Where a generation's time goes: one engine of ``chip_smoke.py`` on one
device.

Usage (from the repository root, on a machine with a CUDA GPU):

    python -m mrbayes_tpu_torch.engine_profile --chains 4 --gens 100
    python -m mrbayes_tpu_torch.engine_profile --config test1 [--multiwalk]
    python -m mrbayes_tpu_torch.engine_profile --config test2 [--multiwalk]
    python -m mrbayes_tpu_torch.engine_profile --config cynmix \
        [--wavefront] [--stacked] [--multiwalk]
    python -m mrbayes_tpu_torch.engine_profile --config replicase_ny98
    python -m mrbayes_tpu_torch.engine_profile --config avian_gtr
    python -m mrbayes_tpu_torch.engine_profile --config hymfossil
    python -m mrbayes_tpu_torch.engine_profile --config kim_doublet
    python -m mrbayes_tpu_torch.engine_profile --config replicase_m10
    python -m mrbayes_tpu_torch.engine_profile --config kim_unlinked
    python -m mrbayes_tpu_torch.engine_profile --config primates_covarion
    python -m mrbayes_tpu_torch.engine_profile --config avian_covarion
    python -m mrbayes_tpu_torch.engine_profile --config primates_adgamma
    python -m mrbayes_tpu_torch.engine_profile --config cynmix_symdiri
    python -m mrbayes_tpu_torch.engine_profile --config finch
    python -m mrbayes_tpu_torch.engine_profile [--config ...] --sites 4

``--config primates`` (the default) is primates GTR+I+G, 1 run;
``--config test1`` is test1's partitioned model, ``--config test2`` the
same on test2's IGR relaxed clock, ``--config cynmix`` cynmix's
favored total-evidence model, ``--config avian`` avian_ovomucoids under
aamodelpr=mixed, ``--config avian_gtr`` the same under
aamodelpr=fixed(gtr), ``--config replicase_ny98`` replicase under
NY98 (``replicase_m3``, ``replicase_m10``: under M3 and M10),
``--config hymfossil`` hymfossil.nex's fossilized birth-death
total-evidence dating (114 taxa, 15 divisions), ``--config kim_doublet``
kim.nex's stem doublets (9 divisions), ``--config kim_unlinked`` its
six unlinked gene trees, ``--config primates_covarion`` and
``avian_covarion`` primates under HKY+G and avian under Jones+G with the
covarion model (``restriction_directional``, ``restriction_mixed``: the
restriction matrix under directional and mixed root frequencies),
``primates_adgamma`` primates under GTR with autocorrelated gamma rates,
``primates_lnorm_kmix`` its codon positions under lognormal and kmixture
rates, ``cynmix_symdiri`` and ``cynmix_parsmodel`` cynmix's favored
model with symdirihyperpr or the parsimony model on its morphology,
``finch`` finch.nex's BEST analysis (30 gene trees) (each built through
the CLI's commands, ``envelope.BATCHES``), 2 runs, with the kernel-path
switches as given.  ``--chains`` is the chain
count per run; ``--sites k`` shards the engine's patterns over k site
shards of its device (``parallel.mesh``).  It builds the engine, warms it
up, and then runs ``run_block`` under ``torch.profiler``: wall time, the
device's busy and idle share (summed kernel time over the window), kernel
launches per generation, the kernels and host operators that take the
most time (the program's spans among them: ``gen.propose.<move>``,
``gen.eigs``, ``gen.lnl`` and the rest, ``spans.py``), and each of the
port's kernels (``csrc/*.cu``): launches, device ms and share of the busy
time and of the wall time.  The host time by span and move type without
the profiler is a CLI run's end-of-run table ("Host self time by span",
and the host's ms a proposal beside the acceptance rates).

It prints one JSON object (also written to ``--out``).  ``--device cpu``
rehearses it on the CPU; those numbers are CPU numbers and are labelled so.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from .data import DataSet, make_divisions
from .mcmc.engine import Engine
from .mcmc.settings import DivisionSettings, McmcSettings
from .nexus.parser import read_nexus_file

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name fragments of the port's kernels (csrc/*.cu) in a profiler trace
PORT_KERNELS = ("pruning", "multiwalk", "wavefront", "stacked",
                "eigh_jacobi")
PRIMATES = os.path.join(_ROOT, "tests", "data", "ref", "examples",
                        "primates.nex")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return line[0] if line else torch.cuda.get_device_name(dev)


def profile_block(eng, states, bk, gens, dev, top=12):
    """run_block under torch.profiler: busy share, launches, top names."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        states, bk = eng.run_block(states, bk, gens)
        _sync(dev)
        wall = time.perf_counter() - t0
    kernels, host = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.key] = (e.count, e.self_cpu_time_total / 1e3)
    busy_ms = sum(v[1] for v in kernels.values())
    n_kernels = sum(v[0] for v in kernels.values())

    def ranked(d):
        return [{"name": k[:90], "count": v[0], "ms": v[1]}
                for k, v in sorted(d.items(), key=lambda kv: -kv[1][1])[:top]]

    # the port's hand-written kernels, summed over their instantiations
    ours = {}
    for name, (count, ms) in kernels.items():
        for tag in PORT_KERNELS:
            if tag in name:
                o = ours.setdefault(tag, {"launches": 0, "ms": 0.0})
                o["launches"] += count
                o["ms"] += ms
    for o in ours.values():
        o["launches_per_gen"] = o["launches"] / gens
        o["share_of_busy"] = o["ms"] / busy_ms if busy_ms else None
        o["share_of_wall"] = o["ms"] / (wall * 1e3)

    out = {"gens": gens, "wall_ms": wall * 1e3,
           "ms_per_gen": wall * 1e3 / gens,
           "device_busy_ms": busy_ms if dev.type == "cuda" else None,
           "device_idle_share": (1.0 - busy_ms / (wall * 1e3)
                                 if dev.type == "cuda" else None),
           "kernel_launches_per_gen": (n_kernels / gens
                                       if dev.type == "cuda" else None),
           "top_kernels": ranked(kernels),
           "port_kernels": ours,
           "top_host_ops_self": ranked(host)}
    return out, states, bk


def configs() -> dict:
    """The CLI-built configurations: ``envelope.BATCHES`` (test1, test2,
    cynmix, avian under aamodelpr=mixed, replicase under NY98, hymfossil's
    FBD dating, kim, primates and avian under the covarion model, the
    restriction matrix under directional root frequencies) and avian
    under aamodelpr=fixed(gtr), whose every Q move refreshes an S = 20
    eigensystem through ``csrc/eigh.cu``."""
    from .envelope import AVIAN, BATCHES
    return {**{k: v for k, v in BATCHES.items() if v[0] is not None},
            "avian_gtr": (AVIAN, ("prset aamodelpr=fixed(gtr)",))}


def build_engine(config: str, chains: int, device, **switches):
    """(engine, description) of one profiled configuration, with the
    kernel-path switches given (``multiwalk=``, ``wavefront=``,
    ``stacked=``)."""
    if config == "primates":
        nf = read_nexus_file(PRIMATES)
        ds = DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                     divisions=make_divisions(nf.matrix))
        eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                     mcmc=McmcSettings(nruns=1, nchains=chains, seed=3),
                     device=device)
        return eng, f"primates GTR+I+G, 1 run x {chains} chains"
    from .cli import Interpreter
    data, model = configs()[config]
    it = Interpreter(log=lambda m: None, device=device, **switches)
    for line in (f"execute {data}", *model,
                 f"mcmcp nruns=2 nchains={chains} seed=3"):
        it.run_line(line)
    on = [k for k, v in switches.items() if v]
    return it.build_engine(), (f"{config}, 2 runs x {chains} chains, "
                               f"switches on: {', '.join(on) or 'none'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--gens", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a CUDA device)")
    ap.add_argument("--config", choices=("primates", *configs()),
                    default="primates")
    ap.add_argument("--multiwalk", action="store_true",
                    help="test1, test2, cynmix: group the divisions of "
                         "one state "
                         "count into one multiwalk launch")
    ap.add_argument("--wavefront", action="store_true",
                    help="cynmix: the level-batched pruner for every "
                         "division it takes")
    ap.add_argument("--stacked", action="store_true",
                    help="cynmix: stack the small divisions into one "
                         "launch")
    ap.add_argument("--sites", type=int, default=1,
                    help="site shards, all on the engine's device")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    eng, config = build_engine(args.config, args.chains, args.device,
                               multiwalk=args.multiwalk,
                               wavefront=args.wavefront,
                               stacked=args.stacked)
    dev = eng.device
    if args.sites > 1:
        from .parallel.mesh import make_mesh, shard_engine_data
        shard_engine_data(eng, make_mesh(1, args.sites, [dev] * args.sites))
        config += f", over {args.sites} site shards of one device"
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, 50)
    block, states, bk = profile_block(eng, states, bk, args.gens, dev)
    result = {"device": _device_name(dev), "torch": torch.__version__,
              "config": config,
              "run_block": block}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
