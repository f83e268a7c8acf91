"""Peaks of the card and the likelihood's work, counted from a cell's
shapes.

The bound arithmetic is the one the port's kernel table has used since
its first CUDA kernel: a down-pass of C chains over n_int internal nodes,
K rate categories, S states and P patterns needs 2 products of an S x S
operator with an S-vector per (chain, node, category, pattern), each 2 S^2
operations, so 4 C n_int K S^2 P operations, and reads the tip states,
the child index pairs and the per-branch operators and writes the root
partials and the per-pattern log scalers once, 4 bytes each.  Its bound
time is the larger of operations over the float32 rate outside the
tensor cores and bytes over HBM bandwidth.  It counts the same work
whatever kernel, fusion or graph carries it out.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates; a card may run below its 700 W
# limit, so every result records the limit it read
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}
DEFAULT_KIND = "NVIDIA H100 80GB HBM3"


def peaks(kind: str) -> dict:
    """The card's peaks; an H100 of another name reads the SXM part's."""
    return PEAKS.get(kind, PEAKS[DEFAULT_KIND])


def down_pass_work(chains: int, n_tips: int, n_cats: int, n_states: int,
                   n_patterns: int) -> tuple[float, float]:
    """(operations, bytes) of one down-pass of every chain over one
    division on a binary tree of ``n_tips`` tips (n_tips - 1 internal
    nodes in the rooted layout the kernels walk)."""
    C, K, S, P = chains, n_cats, n_states, n_patterns
    n_int = n_tips - 1
    flops = 4.0 * C * n_int * K * S * S * P
    nbytes = 4.0 * (C * n_int * 2                 # child index pairs
                    + C * n_int * 2 * K * S * S   # branch operators
                    + n_tips * S * P              # tip states
                    + C * K * S * P               # root partials
                    + C * P)                      # log scalers
    return flops, nbytes


def likelihood_work(chains: int, n_tips: int, n_cats: int, n_states: int,
                    patterns: list[int]) -> dict:
    """One ``log_likelihood`` call's work summed over divisions, and its
    bound time on the card."""
    flops = nbytes = 0.0
    for p in patterns:
        f, b = down_pass_work(chains, n_tips, n_cats, n_states, p)
        flops += f
        nbytes += b
    pk = peaks(DEFAULT_KIND)
    ops_s = flops / pk["fp32_flops"]
    bytes_s = nbytes / pk["hbm_bytes_per_s"]
    return {"flops": flops, "bytes": nbytes,
            "fp32_flops": pk["fp32_flops"],
            "bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}
