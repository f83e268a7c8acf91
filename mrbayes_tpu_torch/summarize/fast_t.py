"""Native-accelerated .t file summarization.

Feeds TreeSummary (summarize/sumt.py) from the C++ batch parser
(native/treeio.cpp) + vectorized numpy accumulation instead of per-tree
Python Newick parsing — the host-side analog of the reference's C split
counters (AddSumtPartition src/sumpt.c:2912).  Returns False when the
native path is unavailable (no compiler, named labels, parse error); the
caller falls back to the pure-Python reader.
"""
from __future__ import annotations

import numpy as np

from ..native import parse_t_text


def read_translate(text: str) -> list[str] | None:
    """Taxon labels from a trees-block translate table (numeric keys)."""
    low = text.lower()
    i = low.find("translate")
    if i < 0:
        return None
    j = text.find(";", i)
    if j < 0:
        return None
    pairs = []
    for item in text[i + len("translate"):j].split(","):
        toks = item.split()
        if len(toks) >= 2 and toks[0].isdigit():
            pairs.append((int(toks[0]), toks[1]))
    if not pairs:
        return None
    pairs.sort()
    if [k for k, _ in pairs] != list(range(1, len(pairs) + 1)):
        return None
    return [name for _, name in pairs]


def _mask_to_frozenset(mask_words: np.ndarray, n: int) -> frozenset:
    bits = np.unpackbits(mask_words.view(np.uint8), bitorder="little")
    return frozenset(int(i) for i in np.flatnonzero(bits[:n]))


def add_run_native(ts, run: int, text: str, burninfrac: float) -> bool:
    """Parse one run's .t text natively and accumulate into TreeSummary.
    Returns False to request the Python fallback."""
    n = ts.n
    parsed = parse_t_text(text, n)
    if parsed is None:
        return False
    splits, blens, nedges, rooted = parsed
    T = len(nedges)
    if T == 0:
        return True
    burn = int(T * burninfrac)
    splits, blens, nedges, rooted = (splits[burn:], blens[burn:],
                                     nedges[burn:], rooted[burn:])
    T = len(nedges)
    E = splits.shape[1]
    valid = np.arange(E)[None, :] < nedges[:, None]
    flat_masks = splits[valid]                      # [M, W]
    flat_blens = blens[valid]
    tree_of = np.repeat(np.arange(T), nedges)
    uniq, inverse = np.unique(flat_masks, axis=0, return_inverse=True)
    U = len(uniq)
    pc = np.unpackbits(uniq.view(np.uint8), axis=1,
                       bitorder="little")[:, :n].sum(1)

    # Rooted samples: the Python reader re-roots at tip 0, merging the
    # root bifurcation's two edges into one.  After canonicalization the
    # pair shares one mask (or appears as {0} + its size-(n-1)
    # complement), so: remap complements of tip 0's pendant onto {0},
    # then merge per-tree duplicate ids by summing their lengths.
    comp = np.flatnonzero(pc == n - 1)
    if len(comp):
        zero_mask = np.zeros_like(uniq[0])
        zero_mask[0] = np.uint64(1)
        zid = np.nonzero((uniq == zero_mask[None, :]).all(1))[0]
        if len(zid) == 0:
            uniq = np.concatenate([uniq, zero_mask[None, :]])
            pc = np.append(pc, 1)
            zid = [U]
            U += 1
        remap = np.arange(U)
        remap[comp] = zid[0]
        inverse = remap[inverse]
    order = np.lexsort((inverse, tree_of))
    inverse, tree_of, flat_blens = (inverse[order], tree_of[order],
                                    flat_blens[order])
    dup = np.zeros(len(inverse), bool)
    if len(inverse) > 1:
        dup[1:] = ((inverse[1:] == inverse[:-1])
                   & (tree_of[1:] == tree_of[:-1]))
    if dup.any():
        first = np.flatnonzero(dup) - 1
        np.add.at(flat_blens, first, flat_blens[np.flatnonzero(dup)])
        keep = ~dup
        inverse, tree_of, flat_blens = (inverse[keep], tree_of[keep],
                                        flat_blens[keep])

    # branch-length moments per unique split
    s1 = np.bincount(inverse, weights=flat_blens, minlength=U)
    s2 = np.bincount(inverse, weights=flat_blens ** 2, minlength=U)
    cnt = np.bincount(inverse, minlength=U)

    keys = [_mask_to_frozenset(uniq[i], n) for i in range(U)]
    for i in range(U):
        if not cnt[i]:
            continue
        k = keys[i]
        ts.blen_sum[k] = ts.blen_sum.get(k, 0.0) + float(s1[i])
        ts.blen_sumsq[k] = ts.blen_sumsq.get(k, 0.0) + float(s2[i])
        ts.blen_count[k] = ts.blen_count.get(k, 0) + int(cnt[i])

    # split-frequency counter (ASDSF): nontrivial unrooted splits — the
    # Python reader re-roots every sample at tip 0 and summarizes
    # unrooted splits even for clock trees, so the fast path matches
    # (rooted-consensus semantics are a shared TODO with read_t_file)
    c_sel = (pc > 1) & (pc < n - 1)
    c_cnt = np.bincount(inverse, weights=c_sel[inverse].astype(np.float64),
                        minlength=U).astype(np.int64)
    for i in range(U):
        if not c_sel[i] or c_cnt[i] == 0:
            continue
        k = keys[i]
        if k not in ts.counter.counts:
            ts.counter.counts[k] = np.zeros(ts.counter.n_runs, np.int64)
        ts.counter.counts[k][run] += int(c_cnt[i])
    ts.counter.n_trees[run] += T
    ts.counter.samples = None      # bulk mode: no per-sample record
    ts.n_trees += T

    # topology keys: sorted tuple of nontrivial split ids per tree —
    # byte-string ids keep keys stable across runs
    t_sel = (pc > 1) & (pc < n - 1)
    id_bytes = [uniq[i].tobytes() for i in range(U)]
    sel_edges = t_sel[inverse]
    inv_sel = inverse[sel_edges]
    tree_sel = tree_of[sel_edges]
    order = np.lexsort((inv_sel, tree_sel))
    inv_sel, tree_sel = inv_sel[order], tree_sel[order]
    bounds = np.searchsorted(tree_sel, np.arange(T + 1))
    for t in range(T):
        ids = inv_sel[bounds[t]:bounds[t + 1]]
        topo = tuple(id_bytes[i] for i in ids)
        ts.topo_counts[topo] = ts.topo_counts.get(topo, 0) + 1
    return True
