"""Seconds from the CLI's ``execute`` of the simulated matrix to the first
engine's build returning (``cli.py``, ``nexus/``, ``data.py``,
``Engine.__init__``), on the host clock; part of set-up."""
NAME = "engine_build_s"
UNIT = "s"
LAYER = "CLI and data"
MOVES = "setup_s"


def read(record):
    return record.get("engine_build_s")
