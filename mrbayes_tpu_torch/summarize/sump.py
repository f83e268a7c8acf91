"""``sump``: summarize .p parameter-sample files.

Reads the tab-separated sample files (ours or the reference's — identical
layout), applies burn-in, and prints/writes the parameter table with mean,
variance, 95% HPD, median, ESS, and PSRF, plus the harmonic-mean marginal
likelihood (reference: DoSump src/sumpt.c:193, GetSummary src/utils.c:648,
HarmonicArithmeticMeanOnLogs src/utils.c:696).
"""
from __future__ import annotations

import glob
import re

import numpy as np

from ..mcmc.diagnostics import ess, hpd_interval, psrf, summarize_param


def read_p_file(path: str) -> tuple[list[str], np.ndarray]:
    header: list[str] = []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("["):
                continue
            parts = line.split("\t")
            if parts[0].lower() == "gen":
                header = [p.strip() for p in parts]
                continue
            if parts[0] and (parts[0][0].isdigit() or parts[0][0] == "-"):
                rows.append([float(x) for x in parts])
    return header, np.array(rows)


def find_run_files(prefix: str, ext: str) -> list[str]:
    """The runs' ``<prefix>.run<r>.<ext>`` files (a BEST run's gene-tree
    files ``<prefix>.run<r>.gene<g>.t`` are not runs of the species tree:
    the JAX package's glob counts them, ROADMAP Queue 3), else
    ``<prefix>.<ext>``."""
    pat = re.compile(re.escape(prefix) + r"\.run\d+\." + re.escape(ext))
    files = sorted(f for f in glob.glob(f"{prefix}.run*.{ext}")
                   if pat.fullmatch(f))
    if not files:
        single = f"{prefix}.{ext}"
        files = [single] if glob.glob(single) else []
    return files


def harmonic_mean_lnl(lnl: np.ndarray) -> float:
    """Harmonic mean estimator on logs (numerically stable)."""
    x = -lnl
    m = x.max()
    return float(-(m + np.log(np.mean(np.exp(x - m)))))


def sump(prefix: str, burninfrac: float = 0.25, log=print,
         write_files: bool = True, hpd: bool = True,
         outputname: str | None = None, nruns: int | None = None) -> dict:
    """``hpd=False``: equal-tail percentile intervals (sump Hpd=No);
    ``outputname``: prefix for written files (sump Outputname);
    ``nruns``: summarize only the first N run files (sump Nruns)."""
    files = find_run_files(prefix, "p")
    if not files:
        raise FileNotFoundError(f"no .p files match {prefix}")
    if nruns is not None:
        files = files[:nruns]
    out_prefix = outputname or prefix
    runs = []
    header = None
    for path in files:
        hdr, rows = read_p_file(path)
        header = header or hdr
        burn = int(len(rows) * burninfrac)
        runs.append(rows[burn:])
    n_samp = sum(len(r) for r in runs)
    log(f"   Summarizing {n_samp} samples from {len(files)} run(s) "
        f"(burninfrac={burninfrac})")
    results = {}
    log("")
    log("      %-16s %10s %10s %10s %10s %10s %8s %8s %6s" % (
        "Parameter", "Mean", "Variance", "Lower", "Upper", "Median",
        "minESS", "avgESS", "PSRF"))
    model_indicators = {}
    for j, name in enumerate(header):
        if name in ("Gen",):
            continue
        per_run = [r[:, j] for r in runs]
        if name.startswith(("gtrsubmodel", "aamodel", "rclModel")):
            # model-indicator column: report posterior model probabilities
            # (reference PrintModelStats src/sumpt.c:2104)
            allv = np.concatenate(per_run).astype(np.int64)
            vals, counts = np.unique(allv, return_counts=True)
            order = np.argsort(-counts)
            model_indicators[name] = [(int(vals[i]),
                                       counts[i] / len(allv))
                                      for i in order[:10]]
            continue
        s = summarize_param(per_run, hpd=hpd)
        results[name] = s
        if name in ("lnLike", "lnPrior"):
            continue
        log("      %-16s %10.6f %10.6f %10.6f %10.6f %10.6f %8.1f %8.1f "
            "%6.3f" % (name, s["mean"], s["var"], s["hpd_lower"],
                       s["hpd_upper"], s["median"], s["min_ess"],
                       s["avg_ess"], s["psrf"]))
    for name, models in model_indicators.items():
        log("")
        log(f"      Model probabilities for {name}:")
        for code, p in models:
            log(f"         {code}: {p:.4f}")
        results["_" + name] = models
    # marginal likelihood (harmonic mean) per run
    ln_j = header.index("lnLike")
    log("")
    for i, r in enumerate(runs):
        hm = harmonic_mean_lnl(r[:, ln_j])
        log(f"      Run {i + 1} marginal likelihood (harmonic mean): "
            f"{hm:.2f}")
        results.setdefault("_harmonic_mean", []).append(hm)
    if write_files:
        with open(f"{out_prefix}.pstat", "w") as f:
            f.write("Parameter\tMean\tVariance\tLower\tUpper\tMedian\t"
                    "minESS\tavgESS\tPSRF\n")
            for name, s in results.items():
                if name.startswith("_") or name in ("lnLike", "lnPrior"):
                    continue
                f.write(f"{name}\t{s['mean']:.6e}\t{s['var']:.6e}\t"
                        f"{s['hpd_lower']:.6e}\t{s['hpd_upper']:.6e}\t"
                        f"{s['median']:.6e}\t{s['min_ess']:.2f}\t"
                        f"{s['avg_ess']:.2f}\t{s['psrf']:.4f}\n")
        with open(f"{out_prefix}.lstat", "w") as f:
            f.write("run\tharmonic_mean\n")
            for i, hm in enumerate(results.get("_harmonic_mean", [])):
                f.write(f"{i + 1}\t{hm:.6e}\n")
        if model_indicators:
            # model-indicator probabilities (reference writes .mstat from
            # PrintModelStats, src/sumpt.c:2104)
            with open(f"{out_prefix}.mstat", "w") as f:
                f.write("Indicator\tModel\tProbability\n")
                for name, models in model_indicators.items():
                    for code, p in models:
                        f.write(f"{name}\t{code}\t{p:.6f}\n")
    # average PSRF across parameters (reference prints this; the CI
    # envelope checks it, testing/runtests.sh.in:143-161)
    psrfs = [s["psrf"] for k, s in results.items()
             if not k.startswith("_") and k not in ("lnLike", "lnPrior")
             and np.isfinite(s["psrf"]) and s["psrf"] <= 10.0]
    if psrfs:
        avg = float(np.mean(psrfs))
        results["_avg_psrf"] = avg
        # exact text the reference CI greps (testing/runtests.sh.in:146)
        log("      Average PSRF for parameter values (excluding NA and "
            f">10.0) = {avg:.3f}")
    return results
