"""The whole step's share of the card's float32 peak in the traced
stretch: the likelihood's operations counted from the cell's shapes
(``roofline.likelihood_work``) times its calls there, over the stretch's
length as the profiler's trace gives it (``window_s``, idle time
included) and the peak.  Beside ``likelihood_roofline``, which divides
the same work by the busy time alone, it reads what a kernel's own
roofline cannot: work moved off the card or time the card waits."""
NAME = "step_mfu"
UNIT = "%"
LAYER = "device"
MOVES = "gens_per_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("window_s") or not tr.get("loglik_calls"):
        return None
    flops = record["work"]["flops"] * tr["loglik_calls"]
    return 100.0 * flops / (tr["window_s"] * record["work"]["fp32_flops"])
