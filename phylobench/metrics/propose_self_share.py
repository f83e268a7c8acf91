"""Share of the timed run's wall time (``McmcRunner.wall_seconds``) that
the host spends making proposals: the self time of the program's
``gen.propose.<move>`` spans, summed over the move types, in the untraced
window.  In a card-paced cell a span absorbs the launch queue's
back-pressure, so the share is read where the host paces the run."""
NAME = "propose_self_share"
UNIT = "%"
LAYER = "generation loop"
MOVES = "gens_per_s"


def read(record):
    t = record.get("timed")
    if not t or not t.get("runner_wall_s"):
        return None
    own = [v for k, v in t["phase_times"].items()
           if k.startswith("gen.propose.") and k.endswith(".self_s")]
    return 100.0 * sum(own) / t["runner_wall_s"] if own else None
