"""Share of the timed ``mcmc`` command's wall time that goes to building
its engine again (``cli.py`` ``do_mcmc``, the program's
``mcmc.engine_build`` span, self time): a window's set-up cost that no
generation needs."""
NAME = "window_build_share"
UNIT = "%"
LAYER = "CLI and data"
MOVES = "gens_per_s"


def read(record):
    t = record.get("timed")
    if not t or not t.get("wall_s"):
        return None
    v = t["phase_times"].get("mcmc.engine_build.self_s")
    return None if v is None else 100.0 * v / t["wall_s"]
