"""One run of one cell: set-up, the timed window, the check and the
result.

Set-up, for the cell's own shapes only: the alignment simulated from the
seed and written as NEXUS under ``TMPDIR``; the CLI's ``execute``, the
configuration's commands and ``mcmcp`` with the mix's settings and MCMC
seeds (outputs under ``TMPDIR``); one short ``mcmc`` that warms every kernel and shape
and gives the rate.  The window is then the CLI's own ``mcmc ngen=N``
(``Interpreter.do_mcmc``: the engine build, ``McmcRunner.run`` with its
chain start, blocks of ``Engine.run_block``, sample rows, diagnostics and
the final checkpoint), N the whole multiple of ``samplefreq`` nearest to
the warm-up's rate times ``--seconds``, at least one block.

With ``--trace 1`` a traced stretch of the mix's ``trace_gens``
generations (one ``mcmc``, the profiler running from the engine's build
to the command's end, ranges around the engine's likelihood and
eigensystem refresh) follows the window, once its outputs are copied:
a host that ran under the profiler stays slower for a while, so the
window runs untraced and first, and the per-layer metrics read both.

After the window the program's outputs (every chain's first and final
state, its cold chains, the last ``.p`` and ``.t`` lines, its pattern
counts) are copied to the host; after the traced stretch, if any, the
peak device memory is read, the program is freed, and
``check.compare`` holds the outputs against the reference.
"""
from __future__ import annotations

import gc
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, registry, roofline, simulate, trace
from . import reference as R

FORBIDDEN = ("jax", "jaxlib", "flax", "mrbayes_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def data_seed(seed: int) -> int:
    """The simulation's seed in [1, 2^31 - 1] from any whole number."""
    word = np.random.SeedSequence(abs(int(seed))).generate_state(1)[0]
    return int(word) % (2 ** 31 - 2) + 1


def division_ranges(cfg: dict, sites: int) -> list[tuple[int, int]]:
    """The 1-based site ranges of the divisions the commands make."""
    if cfg["reference"]["divisions"] == "loci":
        return simulate.locus_ranges(sites, cfg["simulation"]["loci"])
    return [(1, sites)]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


def _host(states: dict, fields) -> dict:
    return {k: states[k].detach().cpu().numpy() for k in fields
            if k in states}


def _last_sample(prefix: str, r: int):
    """(header, last row) of run r's .p file and its last .t tree line."""
    with open(f"{prefix}.run{r + 1}.p") as f:
        lines = [ln.rstrip("\n").split("\t") for ln in f if ln.strip()]
    header = next(ln for ln in lines if ln[0] == "Gen")
    with open(f"{prefix}.run{r + 1}.t") as f:
        tree = [ln for ln in f if ln.lstrip().startswith("tree gen.")][-1]
    return header, lines[-1], tree


class Run:
    """The state of one run; ``execute`` does it all."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace_on: bool, device, bench: dict | None = None,
                 here: str = registry.HERE, log=None):
        self.bench = bench or registry.benchmark()
        self.w = registry.workload(workload, self.bench)
        self.cfg = registry.config(self.w["config"], here)
        self.mix = registry.traffic(self.w["traffic"], here)
        self.model = registry.model(self.cfg["model"]["module"], here)
        self.fields = check.STATE_FIELDS + tuple(self.model.FIELDS)
        self.seed, self.seconds, self.trace_on = seed, seconds, trace_on
        self.device = torch.device(device)
        self.log = log or (lambda m: print(m, file=sys.stderr, flush=True))
        self.builds: list[float] = []
        self.init_states = None
        self.counts: dict = {}
        self.window = trace.Window(self.device)
        self.tracing = False

    # ------------------------------------------------------------ set-up
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap_build(self, it):
        build = it.build_engine

        def build_engine(**kwargs):
            eng = build(**kwargs)
            self.builds.append(time.perf_counter())
            init = eng.init_chains

            def init_chains(*a, **k):
                states, bk = init(*a, **k)
                self.init_states = _host(states, self.fields)
                return states, bk

            eng.init_chains = init_chains
            if self.tracing:
                trace.instrument(eng, self.counts)
                self.window.start()
            return eng

        it.build_engine = build_engine

    def setup(self):
        self.tmp = tempfile.mkdtemp(prefix="phylobench-")
        self.codes = self.model.simulate(self.cfg["simulation"],
                                         data_seed(self.seed))
        path = os.path.join(self.tmp, "data.nex")
        with open(path, "w") as f:
            f.write(self.model.nexus_text(self.codes))
        self.prefix = os.path.join(self.tmp, "run")
        from mrbayes_tpu_torch.cli import Interpreter
        self.it = Interpreter(log=self.log, device=self.device,
                              **self.mix["switches"])
        self._wrap_build(self.it)
        self.t_execute = time.perf_counter()
        self.it.run_line(f"execute '{path}'")
        for cmd in self.cfg["commands"]:
            self.it.run_line(cmd)
        # the mix's MCMC seeds: every --seed draws the same moves in the
        # same order on its own data, so seeds change the data, not the work
        mc = {**self.mix["mcmcp"], **self.mix["mcmc_seeds"]}
        self.it.run_line(
            "mcmcp " + " ".join(f"{k}={v}" for k, v in mc.items())
            + f" filename='{self.prefix}'")
        self.it.run_line(f"mcmc ngen={self.mix['warmup_gens']}")
        runner = self.it._last_runner
        self.engine_build_s = self.builds[0] - self.t_execute
        self.rate = runner.generations / runner.wall_seconds
        sf = mc["samplefreq"]
        self.gens = max(sf, int(round(self.rate * self.seconds / sf)) * sf)
        self._sync()

    # ------------------------------------------------------------ windows
    def traced(self):
        """The traced stretch: one ``mcmc`` of ``trace_gens``."""
        self.window.warm()
        self.tracing = True
        self.it.run_line(f"mcmc ngen={self.mix['trace_gens']}")
        self.window.stop()
        self.tracing = False
        self.trace_gens = self.it._last_runner.generations
        rec = self.window.reduce()
        rec["gens"] = self.trace_gens
        rec["loglik_calls"] = self.counts.get(trace.LOGLIK, 0)
        self.window.prof = None
        return rec

    def timed(self):
        self._sync()
        t0 = time.perf_counter()
        self.it.run_line(f"mcmc ngen={self.gens}")
        self._sync()
        self.wall_s = time.perf_counter() - t0
        self.window_build_s = self.builds[-1] - t0

    def collect(self) -> dict:
        """The timed run's outputs on the host."""
        runner = self.it._last_runner
        mc = self.mix["mcmcp"]
        prog = {
            "gens": runner.generations,
            "nchains": mc["nchains"], "nruns": mc["nruns"],
            "init": self.init_states,
            "final": _host(runner.final_states, self.fields),
            "temp_id": runner.final_bk["temp_id"].cpu().numpy(),
            "npat": [d.npat for d in runner.eng.data.divisions],
            "samples": [_last_sample(self.prefix, r)
                        for r in range(mc["nruns"])],
            "phase_times": dict(runner.phase_times),
            "runner_wall_s": runner.wall_seconds,
        }
        # the window's chains go, so a traced stretch after it fits in
        # the same memory
        self.it._last_runner = None
        return prog

    def free(self):
        """Read the peak device memory, then free the program."""
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)
        self.it = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_data(self, precision: str = "float64") -> R.Data:
        ranges = division_ranges(self.cfg, self.codes.shape[1])
        return R.Data(R.divisions(self.codes, ranges),
                      R.Precision(precision), self.device,
                      self.model.STATES)

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def drive(run: Run, trace_on: bool, t_start: float):
    """Set-up, the timed window, its outputs, the traced stretch if
    asked, then the program freed: (setup_s, outputs, trace record or
    None).  The benchmark's runs and ``control.py`` both go through
    here."""
    run.setup()
    setup_s = time.perf_counter() - t_start
    run.timed()
    found = forbidden_modules()
    if found:
        raise RuntimeError("modules of JAX or the JAX package loaded: "
                           + ", ".join(found))
    prog = run.collect()
    rec = run.traced() if trace_on else None
    run.free()
    return setup_s, prog, rec


def execute(workload: str, seed: int, seconds: float, trace_on: bool,
            device, t_start: float, bench: dict | None = None,
            here: str = registry.HERE, log=None) -> dict:
    """One run of ``workload``: the result object of the benchmark's last
    line, or raises."""
    run = Run(workload, seed, seconds, trace_on, device, bench, here, log)
    try:
        setup_s, prog, rec = drive(run, trace_on, t_start)
        data = run.reference_data()
        correct, numbers, extra = check.compare(prog, data, run.cfg,
                                                run.model)
    finally:
        run.close()
    mc = run.mix["mcmcp"]
    work = roofline.likelihood_work(
        mc["nruns"] * mc["nchains"], run.codes.shape[0],
        run.cfg["model"]["ngammacat"], run.model.STATES, data.npat)
    record = {
        "engine_build_s": run.engine_build_s,
        "timed": {"gens": prog["gens"], "wall_s": run.wall_s,
                  "phase_times": prog["phase_times"],
                  "runner_wall_s": prog["runner_wall_s"]},
        "trace": rec,
        "work": work,
    }
    if trace_on:
        metrics = {}
        for m in registry.per_layer(workload, run.bench):
            v = registry.metric(m["name"], here).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # an end-to-end metric ``<name>.<suffix>`` is ``<name>`` under a
        # bound of its own
        e2e = {"gens_per_s": prog["gens"] / run.wall_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in registry.end_to_end(workload, run.bench)}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": _kind(run.device), "count": 1,
              "memory_peak_bytes": int(run.memory_peak),
              "power_limit": power_limit() if run.device.type == "cuda"
              else "no card"}
    out = {"correct": bool(correct), "attempted": run.gens,
           "failed": run.gens - prog["gens"], "metrics": metrics,
           "device": device}
    if trace_on:
        device["busy_s"] = rec["busy_s"]
        device["window_s"] = rec["window_s"]
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           rec["device_ops"]],
                            "idle_gaps": [list(x) for x in
                                          rec["idle_gaps"]]}
        out["trace_counts"] = {"kernels": rec["kernels"],
                               "unmatched_kernels": rec["unmatched_kernels"],
                               "gens": rec["gens"]}
    out["run_info"] = {"patterns": data.npat, "gens": run.gens,
                       "lnpost_rel_gaps": extra["gap_quartiles"],
                       "warmup_rate": run.rate, "seed": run.seed,
                       "timed_gens_per_s": prog["gens"] / run.wall_s,
                       "window_build_s": run.window_build_s,
                       "setup_s": setup_s}
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    return out


def _kind(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
