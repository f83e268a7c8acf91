"""Share of the timed run's wall time (``McmcRunner.wall_seconds``) that
the host spends inside the generation loop's likelihood: the inclusive
time of the program's ``gen.lnl`` span (``Engine.log_likelihood``, its
P(t) operands and kernel calls included), in the untraced window."""
NAME = "loglik_span_share"
UNIT = "%"
LAYER = "likelihood"
MOVES = "gens_per_s"


def read(record):
    t = record.get("timed")
    if not t or not t.get("runner_wall_s"):
        return None
    v = t["phase_times"].get("gen.lnl.incl_s")
    return None if v is None else 100.0 * v / t["runner_wall_s"]
