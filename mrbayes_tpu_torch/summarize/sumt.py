"""``sumt``: summarize .t tree-sample files.

Reads Newick samples (ours or the reference's), applies burn-in, counts
splits and topologies, builds the majority-rule (+compatible) consensus
tree with mean branch lengths and support values, and writes
.parts/.tstat/.vstat/.con.tre/.trprobs (reference: DoSumt src/sumpt.c:4899,
ConTree :3230, TreeProb :8579).
"""
from __future__ import annotations

import numpy as np

from ..mcmc.diagnostics import SplitCounter, splits_of_tree
from ..nexus.parser import read_nexus_file
from ..trees import Tree, parse_newick
from .sump import find_run_files


def read_t_file(path: str, taxa_hint: list[str] | None = None,
                rooted: bool = False):
    nf = read_nexus_file(path)
    taxa = taxa_hint
    if nf.translate:
        taxa = [nf.translate[k] for k in
                sorted(nf.translate, key=lambda x: int(x))]
    trees = [parse_newick(t.newick, taxa, rooted=rooted)
             for t in nf.trees]
    return taxa, trees


class TreeSummary:
    """rooted=True switches from unrooted split semantics to rooted
    CLADE semantics (clock trees): clades are not complement-normalized,
    so e.g. {0,1} and its complement count as distinct groups, matching
    the reference's rooted sumt (sumtParams.isRooted,
    src/sumpt.c:4899ff)."""

    def __init__(self, n_runs: int, taxa: list[str],
                 rooted: bool = False):
        self.taxa = taxa
        self.n = len(taxa)
        self.rooted = rooted
        self.counter = SplitCounter(n_runs)
        self.blen_sum: dict[frozenset, float] = {}
        self.blen_sumsq: dict[frozenset, float] = {}
        self.blen_count: dict[frozenset, int] = {}
        self.topo_counts: dict[tuple, int] = {}
        self.n_trees = 0

    def add(self, run: int, t: Tree):
        if not self.rooted:
            self.counter.add(run, t)
        self.n_trees += 1
        splits = []
        # per-split branch lengths: map each edge to its normalized split
        below = [set() for _ in range(t.n_nodes)]
        for v in range(t.n_tips):
            below[v] = {v}
        for v in t.postorder():
            below[v] = below[t.left[v]] | below[t.right[v]]
        if self.rooted:
            for v in range(t.n_nodes - 1):
                s = below[v]
                key = frozenset(s)
                length = float(t.blen[v])
                self.blen_sum[key] = self.blen_sum.get(key, 0.0) + length
                self.blen_sumsq[key] = (self.blen_sumsq.get(key, 0.0)
                                        + length ** 2)
                self.blen_count[key] = self.blen_count.get(key, 0) + 1
                if 1 < len(s) < self.n:
                    splits.append(key)
                    if key not in self.counter.counts:
                        self.counter.counts[key] = np.zeros(
                            self.counter.n_runs, np.int64)
                    self.counter.counts[key][run] += 1
            self.counter.n_trees[run] += 1
            self.counter.samples = None
            topo = tuple(sorted(splits, key=sorted))
            self.topo_counts[topo] = self.topo_counts.get(topo, 0) + 1
            return
        for v in range(t.n_nodes - 1):
            if v == 0 and not t.rooted:
                # tip0's pendant edge is carried by the basal node
                continue
            s = below[v]
            length = float(t.blen[v])
            if not t.rooted and t.parent[v] == t.root:
                # basal edge: pendant edge of tip 0
                s = {0}
            key = self._norm(s)
            self.blen_sum[key] = self.blen_sum.get(key, 0.0) + length
            self.blen_sumsq[key] = self.blen_sumsq.get(key, 0.0) + length**2
            self.blen_count[key] = self.blen_count.get(key, 0) + 1
            if 1 < len(s) < self.n - 1:
                splits.append(key)
        topo = tuple(sorted(splits, key=sorted))
        self.topo_counts[topo] = self.topo_counts.get(topo, 0) + 1

    def _norm(self, s: set) -> frozenset:
        if 0 in s and len(s) > 1:
            return frozenset(set(range(self.n)) - s)
        return frozenset(s)

    # ---------------------------------------------------------- consensus
    def consensus(self, allcompat: bool = False):
        """Splits for the consensus: majority rule (>50%), optionally
        extended with compatible lower-frequency splits."""
        total = self.counter.n_trees.sum()
        freq = {s: c.sum() / total for s, c in self.counter.counts.items()}
        chosen: list[frozenset] = []
        for s, f in sorted(freq.items(), key=lambda kv: -kv[1]):
            if f > 0.5:
                chosen.append(s)
            elif allcompat and all(_compatible(s, c) for c in chosen):
                chosen.append(s)
        return chosen, freq

    def consensus_newick(self, allcompat: bool = False,
                         figtree: bool = False) -> str:
        chosen, freq = self.consensus(allcompat)
        children = _containment_forest(chosen, self.n,
                                       rooted=self.rooted)
        def mean_blen(key):
            c = self.blen_count.get(key, 0)
            return self.blen_sum.get(key, 0.0) / c if c else 0.0

        def sd_blen(key):
            c = self.blen_count.get(key, 0)
            if c < 2:
                return 0.0
            m = mean_blen(key)
            var = self.blen_sumsq[key] / c - m * m
            return float(np.sqrt(max(var, 0.0)))

        def annot(key, f):
            if not figtree:
                return ""
            return (f"[&prob={f:.8f},length_mean={mean_blen(key):.8e},"
                    f"length_sd={sd_blen(key):.8e}]")

        def render(item) -> str:
            if isinstance(item, frozenset) and len(item) == 1:
                (tip,) = item
                key = frozenset([tip])
                return (f"{tip + 1}{annot(key, 1.0)}:{mean_blen(key):.8f}")
            kids = children[item]
            inner = ",".join(render(k) for k in kids)
            f = (self.counter.counts[item].sum() / self.counter.n_trees.sum()
                 if item in self.counter.counts else 1.0)
            return f"({inner}){annot(item, f)}:{mean_blen(item):.8f}"

        if self.rooted:
            return "(" + ",".join(render(k)
                                  for k in children["root"]) + ");"
        top = ",".join(render(k) for k in children["root"])
        tip0 = f"1{annot(frozenset([0]), 1.0)}:{mean_blen(frozenset([0])):.8f}"
        return f"({tip0},{top});"

    def topology_newick(self, topo: tuple) -> str:
        """Render a topology key (tuple of normalized internal splits, as
        stored by ``add``) back to a branch-length-free Newick string —
        the reference writes each unique topology into .trprobs via
        RetrieveUTopology + WriteTopologyToFile (src/sumpt.c:8643-8671).
        Accepts both key encodings: frozensets (Python reader) and packed
        little-endian uint64 bitmask bytes (native fast path,
        fast_t.py:136)."""
        splits = []
        for k in topo:
            if isinstance(k, bytes):
                words = np.frombuffer(k, dtype=np.uint64)
                bits = np.unpackbits(words.view(np.uint8),
                                     bitorder="little")
                k = frozenset(int(i) for i in np.flatnonzero(bits[:self.n]))
            splits.append(k)
        children = _containment_forest(splits, self.n,
                                       rooted=self.rooted)

        def render(item) -> str:
            if isinstance(item, frozenset) and len(item) == 1:
                (tip,) = item
                return str(tip + 1)
            return "(" + ",".join(render(k) for k in children[item]) + ")"

        top = ",".join(render(k) for k in children["root"])
        if self.rooted:
            return f"({top})"
        return f"(1,{top})"


def _containment_forest(chosen: list, n: int, rooted: bool = False) -> dict:
    """Containment forest over splits: parent = smallest chosen split
    strictly containing the node's set; "root" = full set minus tip0
    (unrooted) or the full set (rooted: every tip hangs off the forest).
    Values are child lists of splits / tip singletons."""
    chosen_sorted = sorted(chosen, key=len)
    children: dict[object, list] = {"root": []}
    for s in chosen_sorted:
        children[s] = []
    first_tip = 0 if rooted else 1
    for item in list(chosen_sorted) + [frozenset([i])
                                       for i in range(first_tip, n)]:
        if isinstance(item, frozenset) and len(item) == 1 \
                and item in children:
            continue
        parent = None
        for cand in chosen_sorted:
            if len(cand) > len(item) and item < cand:
                parent = cand
                break
        key = parent if parent is not None else "root"
        children[key].append(item)
    return children


def _compatible(a: frozenset, b: frozenset) -> bool:
    return a.isdisjoint(b) or a <= b or b <= a


def sumt(prefix: str, burninfrac: float = 0.25, log=print,
         write_files: bool = True, allcompat: bool = False,
         minpartfreq: float = 0.10, conformat: str = "figtree",
         calctreeprobs: bool = True,
         outputname: str | None = None, nruns: int | None = None) -> dict:
    """Reference sumt options carried (src/command.c Sumt params):
    ``minpartfreq`` — bipartitions below this frequency are dropped from
    the .parts/.vstat tables (default 0.10, reference Minpartfreq);
    ``conformat`` — 'figtree' (annotated) or 'simple' .con.tre;
    ``calctreeprobs`` — write .trprobs or skip it;
    ``outputname`` — prefix for written files; ``nruns`` — first N runs.
    """
    files = find_run_files(prefix, "t")
    if not files:
        raise FileNotFoundError(f"no .t files match {prefix}")
    if nruns is not None:
        files = files[:nruns]
    out_prefix = outputname or prefix
    # fast path: C++ batch parser + vectorized accumulation
    # (native/treeio.cpp); falls back to the Python reader on named
    # labels, parse errors, or a missing compiler
    from .fast_t import add_run_native, read_translate
    texts = [open(p).read() for p in files]
    # rooted (clock) samples -> clade semantics via the Python reader
    # (the native fast path canonicalizes to unrooted splits)
    rooted = "[&R]" in texts[0]
    taxa = read_translate(texts[0])
    ts = None
    if taxa is not None and not rooted:
        ts = TreeSummary(len(files), taxa)
        for r, text in enumerate(texts):
            if not add_run_native(ts, r, text, burninfrac):
                ts = None
                break
    if ts is None:
        taxa = None
        per_run_trees = []
        for path in files:
            taxa, trees = read_t_file(path, taxa, rooted=rooted)
            burn = int(len(trees) * burninfrac)
            per_run_trees.append(trees[burn:])
        ts = TreeSummary(len(files), taxa, rooted=rooted)
        for r, trees in enumerate(per_run_trees):
            for t in trees:
                ts.add(r, t)
    total = int(ts.counter.n_trees.sum())
    log(f"   Summarizing trees: {total} samples from {len(files)} run(s)")
    asdsf = ts.counter.asdsf()
    if len(files) > 1:
        # exact text the reference CI greps (testing/runtests.sh.in:127)
        log(f"   Average standard deviation of split frequencies = "
            f"{asdsf:.6f}")
    chosen, freq = ts.consensus(allcompat)
    log(f"   Credible splits (>50%): {len(chosen)}")
    con = ts.consensus_newick(allcompat)
    if write_files:
        with open(f"{out_prefix}.parts", "w") as f:
            f.write("ID\tPartition\tFreq\n")
            shown = [(s, fq) for s, fq in sorted(freq.items(),
                                                 key=lambda kv: -kv[1])
                     if fq >= minpartfreq]
            for i, (s, fq) in enumerate(shown):
                bits = "".join("*" if j in s else "." for j in range(ts.n))
                f.write(f"{i + 1}\t{bits}\t{fq:.6f}\n")
        with open(f"{out_prefix}.tstat", "w") as f:
            f.write("ID\tFreq\tProbability\n")
            tot = sum(ts.topo_counts.values())
            for i, (topo, c) in enumerate(sorted(ts.topo_counts.items(),
                                                 key=lambda kv: -kv[1])):
                f.write(f"{i + 1}\t{c}\t{c / tot:.6f}\n")
        with open(f"{out_prefix}.vstat", "w") as f:
            f.write("Partition\tMean\tSD\tFreq\n")
            for s, fq in sorted(freq.items(), key=lambda kv: -kv[1]):
                c = ts.blen_count.get(s, 0)
                if not c or fq < minpartfreq:
                    continue
                m = ts.blen_sum[s] / c
                var = ts.blen_sumsq[s] / c - m * m
                bits = "".join("*" if j in s else "." for j in range(ts.n))
                f.write(f"{bits}\t{m:.6e}\t{np.sqrt(max(var, 0)):.6e}\t"
                        f"{fq:.6f}\n")
        with open(f"{out_prefix}.con.tre", "w") as f:
            f.write("#NEXUS\nbegin trees;\n   translate\n")
            for i, name in enumerate(taxa):
                sep = "," if i < len(taxa) - 1 else ";"
                f.write(f"       {i + 1} {name}{sep}\n")
            fig = ts.consensus_newick(
                allcompat, figtree=(conformat != "simple"))
            tag = "&R" if ts.rooted else "&U"
            f.write(f"   tree con_all_compat = [{tag}] {fig}\nend;\n")
        if calctreeprobs:
            _write_trprobs(out_prefix, ts, taxa)
        # credible-set summary (reference src/sumpt.c:8678-8692)
        probs = sorted((c for c in ts.topo_counts.values()), reverse=True)
        tot = sum(probs)
        log(f"   Credible sets of trees ({len(probs)} tree"
            f"{'s' if len(probs) > 1 else ''} sampled):")
        for level in (0.5, 0.9, 0.95, 0.99):
            cum2, k2 = 0.0, 0
            for c in probs:
                cum2 += c / tot
                k2 += 1
                if cum2 >= level:
                    break
            log(f"      {int(level * 100)} % credible set contains "
                f"{k2} tree{'s' if k2 > 1 else ''}")
    return {"asdsf": asdsf, "consensus": con, "n_splits": len(chosen),
            "split_freqs": freq, "summary": ts}


def _write_trprobs(out_prefix, ts, taxa):
    """Topology credibility file (reference TreeProb, src/sumpt.c:8579);
    skipped when sumt calctreeprobs=no."""
    with open(f"{out_prefix}.trprobs", "w") as f:
        # reference TreeProb output format (src/sumpt.c:8652-8671):
        # header comment, translate table, one 'tree tree_<i> [p,P] =
        # [&W p] <newick>;' line per unique topology
        f.write("#NEXUS\n"
                "[This file contains the trees that were found during "
                "the MCMC\nsearch, sorted by posterior probability. "
                "\"p\" indicates the\nposterior probability of the "
                "tree whereas \"P\" indicates the\ncumulative "
                "posterior probability.]\n\n")
        f.write("begin trees;\n   translate\n")
        for i, name in enumerate(taxa):
            sep = ";" if i == len(taxa) - 1 else ","
            f.write(f"   {i + 1:>2} {name}{sep}\n")
        tot = sum(ts.topo_counts.values())
        cum = 0.0
        for i, (topo, c) in enumerate(sorted(ts.topo_counts.items(),
                                             key=lambda kv: -kv[1])):
            p = c / tot
            cum += p
            f.write(f"   tree tree_{i + 1} [p = {p:.3f}, "
                    f"P = {cum:.3f}] = [&W {p:.6f}] "
                    f"{ts.topology_newick(topo)};\n")
        f.write("end;\n")
