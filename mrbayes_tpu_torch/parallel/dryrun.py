"""The product path over a ``sites`` mesh: a dry run of a sharded analysis.

Counterpart of ``__graft_entry__.dryrun_multichip`` (``:70-131``) for the
one mesh axis the port carries.  ``dryrun_sites(k)`` shards the primates
analysis of that dry run (two partitions, 1-400 and 401-., GTR+I+G each
with unlinked parameters and variable rate multipliers; 2 runs x 2
chains) over k site shards and drives it through ``McmcRunner`` for 300
generations with the ``.p``/``.t``/``.ckp`` files written.  It then
recomputes every chain's final lnL on an engine that is not sharded and
holds the two at JAX's ``rtol=2e-4, atol=2e-3``.

    python -m mrbayes_tpu_torch.parallel.dryrun [N_SHARDS] [--device cpu]

runs on N_SHARDS (default 4) shards of the first CUDA device, or of the
CPU.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile

import numpy as np

from ..cli import Interpreter
from ..envelope import PRIMATES
from ..mcmc.engine import SCORE_KEYS
from ..mcmc.run import McmcRunner
from .mesh import make_mesh, shard_engine_data

# the dry run's model (__graft_entry__._build_engine) as batch commands
MODEL = ("partition d = 2: 1-400, 401-.", "set partition=d",
         "lset applyto=(all) nst=6 rates=invgamma",
         "unlink statefreq=(all) revmat=(all) shape=(all) pinvar=(all)",
         "prset applyto=(all) ratepr=variable")


def _engine(device, nruns, nchains, seed):
    it = Interpreter(log=lambda m: None, device=device)
    for line in (f"execute {PRIMATES}", *MODEL,
                 f"mcmcp nruns={nruns} nchains={nchains} seed={seed} "
                 f"ngen=300 samplefreq=50 printfreq=300 checkfreq=150 "
                 f"diagnfreq=300"):
        it.run_line(line)
    return it.build_engine()


def dryrun_sites(n_shards: int, devices=None, workdir: str | None = None,
                 log=lambda m: None) -> dict:
    """Run the sharded dry run over ``devices`` (default: the first
    ``n_shards`` CUDA devices; a list may repeat a device, or be
    ``["cpu"] * k``), writing into ``workdir`` (default: a temporary
    directory).  Raises on any failed check; returns a summary."""
    mesh = make_mesh(1, n_shards, devices)
    device = mesh.site_devices()[0]
    nruns, nchains = 2, 2
    eng = _engine(device, nruns, nchains, seed=1)
    shard_engine_data(eng, mesh)
    with tempfile.TemporaryDirectory() as td:
        out = workdir or td
        os.makedirs(out, exist_ok=True)
        prefix = os.path.join(out, "dryrun")
        runner = McmcRunner(eng, file_prefix=prefix, log=log, mesh=mesh)
        fstates, _ = runner.run()
        pfiles = sorted(glob.glob(prefix + ".run*.p"))
        if len(pfiles) != nruns:
            raise AssertionError(f".p files {pfiles}, expected {nruns}")
        with open(pfiles[0]) as f:
            rows = [ln for ln in f if ln[:1].isdigit()]
        if len(rows) != 300 // 50 + 1:
            raise AssertionError(f"{len(rows)} sample rows, expected 7")
        if not glob.glob(prefix + ".run*.t") or not os.path.exists(
                prefix + ".ckp"):
            raise AssertionError("tree files or checkpoint missing")
        lnl = float(rows[-1].split("\t")[1])
    if not lnl < 0.0:
        raise AssertionError(f"final cold lnL {lnl}")
    # the per-shard reduction against the plain sum: every chain's final
    # lnL recomputed on an engine that is not sharded
    eng_u = _engine(device, nruns, nchains, seed=1)
    lnl_s = fstates["lnL"].cpu().numpy()
    lnl_u = eng_u.log_likelihood({k: v for k, v in fstates.items()
                                  if k not in SCORE_KEYS}).cpu().numpy()
    np.testing.assert_allclose(lnl_s, lnl_u, rtol=2e-4, atol=2e-3)
    launches = sum(p.launches for p in eng._pruners)
    summary = {"mesh": mesh.shape, "devices": [str(d) for d in
                                               mesh.site_devices()],
               "chains": f"{nruns}x{nchains}", "gens": 300,
               "final_cold_lnL": lnl,
               "max_abs_diff_unsharded": float(np.abs(lnl_s - lnl_u).max()),
               "sharded_launches": launches}
    log(f"dryrun_sites OK: {summary}")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "mrbayes_tpu_torch.parallel.dryrun")
    ap.add_argument("n_shards", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda:0",
                    help="the device every shard runs on")
    args = ap.parse_args(argv)
    dryrun_sites(args.n_shards, [args.device] * args.n_shards, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
