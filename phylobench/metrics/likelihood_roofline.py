"""The likelihood's share of its roofline in the traced stretch: the
bound time of one ``log_likelihood`` call's down-pass work, counted from
the cell's shapes (``roofline.likelihood_work``: 4 C n_int K S^2 P
operations against the float32 peak, or its bytes against HBM, the
larger), times the calls in the stretch, over the device's busy time
there.  It reads the same work whatever kernel, fusion or graph does it;
the card's power limit is in the result's ``device``."""
NAME = "likelihood_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "gens_per_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("busy_s") or not tr.get("loglik_calls"):
        return None
    return 100.0 * record["work"]["bound_s"] * tr["loglik_calls"] \
        / tr["busy_s"]
