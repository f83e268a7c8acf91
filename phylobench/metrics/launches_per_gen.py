"""Device kernels (memory copies and sets left out) in the traced
stretch's profile, over its generations: the generation loop's launch
count (``Engine.run_block``, ``_chain_step``, ``_swap_step``) with the
chain start and sample copies of its ``mcmc`` spread over them."""
NAME = "launches_per_gen"
UNIT = "launches/gen"
LAYER = "generation loop"
MOVES = "gens_per_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("gens") or not tr.get("kernels"):
        return None
    return tr["kernels"] / tr["gens"]
