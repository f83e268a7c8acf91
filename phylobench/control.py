"""The readings the check's limits are set from, on the card.

    python3 phylobench/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 10 --out <file.jsonl>

For each seed, in one process (the kernels are built once), the cell's
own run through ``cell.drive`` (set-up and a window of ``--seconds`` at
its load), then ``check.compare`` on what it produced, and on the same
final states, each put in the program's place by
``check.in_place_of_program`` and held by the same ``check.compare``:

* ``tf32``: the control, the reference in the nearest precision below
  the configuration's float32 with TF32 off, TF32 products
  (``reference.Precision("tf32")``); it must come out not correct;
* ``float32``: the reference in the configuration's own precision, for
  scale (what float32 arithmetic alone reads);
* ``altered_<k>``: the program's own lnL with ``k`` mean patterns' share
  left out, in every chain, and ``altered_<k>_one_run`` in the first
  run's chains alone: the smallest altered answer the limits see.

The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT

ALTERED = (1, 4, 16)


def _numbers(result) -> dict:
    correct, numbers, extra = result
    return {"correct": bool(correct),
            "numbers": {k: v for k, (v, _) in numbers.items()},
            "gap_quartiles": extra["gap_quartiles"]}


def readings(workload: str, seed: int, seconds: float, device,
             bench=None, here=None, log=None) -> dict:
    import numpy as np
    from phylobench import cell, check, registry
    run = cell.Run(workload, seed, seconds, False, device, bench,
                   here or registry.HERE, log)
    try:
        _, prog, _ = cell.drive(run, False, time.perf_counter())
        f64 = run.reference_data("float64")
        sound = check.compare(prog, f64, run.cfg, run.model)
        scores = (sound[2]["final"], sound[2]["start"])
        out = {"seed": seed, "patterns": f64.npat, "gens": prog["gens"],
               "lnpost_ref_max": float(scores[0].sum(1).max()),
               "program": _numbers(sound)}

        def held(lnl_lnp):
            return _numbers(check.compare(
                check.in_place_of_program(prog, lnl_lnp), f64, run.cfg,
                run.model, scores))

        for prec in ("tf32", "float32"):
            other = check.score_chains(prog["final"],
                                       run.reference_data(prec), run.cfg,
                                       run.model)
            out[prec] = held(other)
        carried = np.stack([prog["final"]["lnL"].astype(np.float64),
                            prog["final"]["lnP"].astype(np.float64)], 1)
        n_pat, nc = sum(f64.npat), prog["nchains"]
        for k in ALTERED:
            every = carried.copy()
            every[:, 0] *= 1.0 - k / n_pat
            out[f"altered_{k}"] = held(every)
            one = carried.copy()
            one[:nc, 0] = every[:nc, 0]
            out[f"altered_{k}_one_run"] = held(one)
        return out
    finally:
        run.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("phylobench control: no CUDA card", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for s in args.seeds.split(","):
        t = time.perf_counter()
        rec = readings(args.workload, int(s), args.seconds, "cuda",
                       log=lambda m: None)
        rec["seconds"] = time.perf_counter() - t
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
