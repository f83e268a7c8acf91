"""The benchmark of ``mrbayes_tpu_torch``: one run of one cell.

    python3 phylobench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
Prints the cell's metrics as the last line of standard output, one JSON
object, and each number compared with the reference beside its limit as
the last lines of standard error.  Without a card, or with fewer than the
cell asks for, it exits with 2 and prints no result; with a module of JAX
or the JAX package loaded once the window has closed, with 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this folder heads sys.path, where its modules would
# shadow others of the same name (trace): the checkout's root goes there
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(HERE, ".cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one process with few threads: the host paces the launches, and idle
    # OpenMP workers would only take cores from it on a shared host
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)
    from phylobench import cell, registry
    bench = registry.benchmark(ROOT)
    chips = registry.workload(args.workload, bench)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"phylobench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    out = cell.execute(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", T_START, bench=bench)
    found = cell.forbidden_modules()
    if found:
        print("phylobench: modules of JAX or the JAX package loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
