"""Share of the traced stretch's wall time the host spends inside the
engine's ``refresh_eigs`` (the benchmark's range around it): Q, the
eigensystems and the category rates of the substitution model."""
NAME = "eigs_host_share"
UNIT = "%"
LAYER = "substitution model"
MOVES = "gens_per_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("window_s"):
        return None
    return 100.0 * tr["range_host_s"]["phylobench.refresh_eigs"] \
        / tr["window_s"]
