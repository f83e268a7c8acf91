"""Share of the traced stretch in which no operation ran on the card: 1
less the union of the device operations' intervals over its length."""
NAME = "device_idle_share"
UNIT = "%"
LAYER = "device"
MOVES = "gens_per_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("window_s") or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
