"""Device time, per generation, of the kernels the host launched inside
the engine's ``log_likelihood`` (the benchmark's range around it; each
kernel matched to its launch by the profiler's correlation id): P(t),
the down-pass kernels and the root reduction of every division."""
NAME = "loglik_device_ms"
UNIT = "ms/gen"
LAYER = "likelihood"
MOVES = "gens_per_s"


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("gens") or not tr.get("loglik_kernel_s"):
        return None
    return 1e3 * tr["loglik_kernel_s"] / tr["gens"]
