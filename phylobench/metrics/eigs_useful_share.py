"""Share of the eigensystems the generation loop computes whose inputs the
proposing move changed: the program's counters ``eig_rows_changed`` over
``eig_rows`` ((eigensystem, chain) pairs of ``Engine.refresh_eigs``), in
the untraced window; the rest were recomputed from unchanged inputs."""
NAME = "eigs_useful_share"
UNIT = "%"
LAYER = "substitution model"
MOVES = "gens_per_s"


def read(record):
    t = record.get("timed")
    if not t:
        return None
    pt = t["phase_times"]
    if not pt.get("eig_rows"):
        return None
    return 100.0 * pt["eig_rows_changed"] / pt["eig_rows"]
