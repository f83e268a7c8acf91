"""Share of the timed run's wall time (``McmcRunner.wall_seconds``) that
the host spends refreshing eigensystems in the generation loop: the self
time of the program's ``gen.eigs`` span (``Engine.refresh_eigs``: Q, the
eigensystems), in the untraced window."""
NAME = "eigs_self_share"
UNIT = "%"
LAYER = "substitution model"
MOVES = "gens_per_s"


def read(record):
    t = record.get("timed")
    if not t or not t.get("runner_wall_s"):
        return None
    v = t["phase_times"].get("gen.eigs.self_s")
    return None if v is None else 100.0 * v / t["runner_wall_s"]
