"""Share of the timed run's wall time (``McmcRunner.wall_seconds``) that
the run driver spends writing samples, computing the ASDSF diagnostics
and checkpointing: ``McmcRunner.phase_times`` sample_io + diagnostics +
checkpoint, the program's own host-clock spans."""
NAME = "driver_share"
UNIT = "%"
LAYER = "run driver"
MOVES = "gens_per_s"


def read(record):
    t = record.get("timed")
    if not t or not t.get("runner_wall_s"):
        return None
    pt = t["phase_times"]
    spent = pt["sample_io"] + pt["diagnostics"] + pt["checkpoint"]
    return 100.0 * spent / t["runner_wall_s"]
