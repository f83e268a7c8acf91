"""``comparetree`` and ``plot``: posterior comparison utilities.

comparetree: split-frequency comparison of two tree-sample files with an
ASCII scatter plot and a .pairs output (reference DoCompareTree,
src/sumpt.c:3686).  plot: ASCII trace of sampled parameters from .p files
(reference DoPlot, src/sumpt.c).
"""
from __future__ import annotations

import numpy as np

from ..mcmc.diagnostics import splits_of_tree
from .sump import find_run_files, read_p_file
from .sumt import read_t_file


def _split_freqs(path: str, burninfrac: float, taxa=None):
    taxa, trees = read_t_file(path, taxa)
    burn = int(len(trees) * burninfrac)
    trees = trees[burn:]
    counts: dict[frozenset, int] = {}
    for t in trees:
        for key in splits_of_tree(t):   # already normalized to non-tip0 side
            counts[key] = counts.get(key, 0) + 1
    n = max(len(trees), 1)
    return taxa, {k: v / n for k, v in counts.items()}, n


def ascii_scatter(xs, ys, log=print, width: int = 64, height: int = 16,
                  xlabel: str = "file 1", ylabel: str = "file 2"):
    grid = [[" "] * width for _ in range(height)]
    for x, y in zip(xs, ys):
        cx = min(width - 1, int(x * (width - 1)))
        cy = min(height - 1, int(y * (height - 1)))
        grid[height - 1 - cy][cx] = "*"
    log("   +" + "-" * width + "+  1.0 " + ylabel)
    for row in grid:
        log("   |" + "".join(row) + "|")
    log("   +" + "-" * width + "+")
    log("   0.0" + " " * (width - 6) + "1.0  " + xlabel)


def comparetree(file1: str, file2: str, outputname: str | None = None,
                burninfrac: float = 0.25, log=print) -> dict:
    """Compare split frequencies between two tree files; write
    ``<outputname>.pairs`` and print an ASCII scatter (reference
    DoCompareTree, src/sumpt.c:3686)."""
    taxa, f1, n1 = _split_freqs(file1, burninfrac)
    _, f2, n2 = _split_freqs(file2, burninfrac, taxa)
    keys = sorted(set(f1) | set(f2),
                  key=lambda k: -(f1.get(k, 0.0) + f2.get(k, 0.0)))
    log(f"   Read {n1} trees from {file1}, {n2} trees from {file2} "
        f"(after burn-in fraction {burninfrac})")
    log("   Split frequency comparison (top 20):")
    log("   freq1    freq2    split")
    rows = []
    for k in keys:
        a, b = f1.get(k, 0.0), f2.get(k, 0.0)
        rows.append((a, b, k))
    for a, b, k in rows[:20]:
        stars = "".join("*" if i in k else "." for i in range(len(taxa)))
        log(f"   {a:6.4f}   {b:6.4f}   {stars}")
    ascii_scatter([r[0] for r in rows], [r[1] for r in rows], log=log)
    d = float(np.sqrt(np.mean([(a - b) ** 2 for a, b, _ in rows]))) \
        if rows else 0.0
    log(f"   Root-mean-square split frequency difference: {d:.6f}")
    if outputname:
        with open(outputname + ".pairs", "w") as f:
            f.write("freq1\tfreq2\tsplit\n")
            for a, b, k in rows:
                stars = "".join("*" if i in k else "."
                                for i in range(len(taxa)))
                f.write(f"{a:.6f}\t{b:.6f}\t{stars}\n")
        log(f"   Wrote split pairs to \"{outputname}.pairs\"")
    return {"rmsd": d, "n_splits": len(rows)}


def compareref(file1: str, file2: str, outputname: str | None = None,
               nruns: int = 1, burninfrac: float = 0.25,
               minpartfreq: float = 0.10, stat: str = "avgstddev",
               log=print) -> dict:
    """Compare a tree-sample file against reference tree samples,
    writing the running (A/M)SDSF per test tree to ``<out>.sdsf``
    (reference DoCompRefTree, src/sumpt.c:4609: the reference pool is
    one split-frequency "run", the growing test pool the other, and the
    per-tree statistic is CalcTopoConvDiagn2's stddev over ALL observed
    splits — no minpartfreq filter, src/mcmc.c:1866-1898).

    ``file2`` is a file PREFIX: ``<file2>.t`` (nruns=1) or
    ``<file2>.run<N>.t``; ``file1`` is used as given (same asymmetry as
    the reference, src/sumpt.c:4660-4666,4755)."""
    from ..nexus.parser import read_nexus_file
    from ..trees import parse_newick

    taxa = None
    ref_counts: dict[frozenset, int] = {}
    n_ref = 0
    for n in range(nruns):
        path = f"{file2}.t" if nruns == 1 else f"{file2}.run{n + 1}.t"
        taxa, trees = read_t_file(path, taxa)
        burn = int(len(trees) * burninfrac)
        for t in trees[burn:]:
            for s in splits_of_tree(t):
                ref_counts[s] = ref_counts.get(s, 0) + 1
            n_ref += 1
        log(f"   Processed run {n + 1} of the reference trees: "
            f"{len(trees)} trees, {burn} discarded as burnin")
    log(f"   {n_ref} reference trees in total from {nruns} runs")
    if n_ref == 0:
        raise ValueError("no reference trees after burnin")

    nf = read_nexus_file(file1)
    if nf.translate:
        taxa = [nf.translate[k] for k in
                sorted(nf.translate, key=lambda x: int(x))]
    test_counts: dict[frozenset, int] = {}
    n_test = 0
    skip = 1       # reference skips the first tree (src/sumpt.c:4775)
    rows = []
    for i, ent in enumerate(nf.trees):
        if i < skip:
            continue
        t = parse_newick(ent.newick, taxa)
        for s in splits_of_tree(t):
            test_counts[s] = test_counts.get(s, 0) + 1
        n_test += 1
        try:
            gen = int(ent.name.rsplit(".", 1)[-1])
        except ValueError:
            gen = i
        sds = []
        for s in set(ref_counts) | set(test_counts):
            fr = ref_counts.get(s, 0) / n_ref
            ft = test_counts.get(s, 0) / n_test
            sds.append(np.std([fr, ft], ddof=1))
        if not sds:
            rows.append((gen, None))
        elif stat == "maxstddev":
            rows.append((gen, float(np.max(sds))))
        else:
            rows.append((gen, float(np.mean(sds))))
    log(f"   {skip} trees discarded, the last {n_test} trees compared "
        f"to the reference")
    out = (outputname or file1) + ".sdsf"
    hdr = "MSDSF" if stat == "maxstddev" else "ASDSF"
    with open(out, "w") as f:
        f.write(f"Gen\t{hdr}\n")
        for gen, v in rows:
            f.write(f"{gen}\tNA\n" if v is None else f"{gen}\t{v:.6f}\n")
    log(f"   Wrote running {hdr} to \"{out}\"")
    final = next((v for g, v in reversed(rows) if v is not None), None)
    if final is not None:
        log(f"   Final {hdr}: {final:.6f}")
    return {"final": final, "n_test": n_test, "n_ref": n_ref,
            "outfile": out}


def plot(prefix: str, parameter: str = "LnL", burninfrac: float = 0.25,
         log=print, width: int = 64, height: int = 18):
    """ASCII trace plot of a sampled parameter across generations
    (reference DoPlot, src/sumpt.c)."""
    files = find_run_files(prefix, "p")
    if not files:
        raise FileNotFoundError(f"no .p files for prefix {prefix!r}")
    for path in files:
        cols, data = read_p_file(path)
        low = [c.lower() for c in cols]
        want = parameter.lower()
        if want in ("lnl", "loglik", "lnlike", "lnlikelihood"):
            want = "lnlike"
        try:
            ci = low.index(want)
        except ValueError:
            raise ValueError(f"parameter {parameter!r} not in {cols}")
        burn = int(data.shape[0] * burninfrac)
        y = data[burn:, ci]
        g = data[burn:, 0]
        if len(y) < 2:
            log("   (too few samples to plot)")
            continue
        lo, hi = float(y.min()), float(y.max())
        span = (hi - lo) or 1.0
        xs = (g - g.min()) / max(g.max() - g.min(), 1.0)
        ys = (y - lo) / span
        log(f"   {path}: {cols[ci]} trace "
            f"({len(y)} samples, burn-in {burn})")
        log(f"   max = {hi:.4f}")
        ascii_scatter(xs, ys, log=log, xlabel="generation",
                      ylabel=cols[ci])
        log(f"   min = {lo:.4f}")
