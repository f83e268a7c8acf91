"""Steppingstone sampling: marginal-likelihood estimation by power
posteriors (Xie et al. 2011; reference DoSs src/mcmc.c:4057, the step
ladder from Beta(alpha, 1) quantiles src/mcmc.c:16325-16430).

Counterpart of ``mrbayes_tpu/mcmc/steppingstone.py``.  The chains sample
p(D|theta)^beta p(theta) along a descending ladder beta_0 = 1 > beta_1 >
... > beta_K = 0 with beta_k = ((K - k) / K)^(1 / alpha); step k
contributes log E_{beta_k}[exp((beta_{k-1} - beta_k) lnL)], estimated from
the cold chain's samples, and the contributions sum to the log marginal
likelihood.  A step's beta is ``bk["power"]``, a host float that
``Engine.run_block`` passes into every acceptance and swap ratio, so the
ladder adds no host synchronisation: each sample's lnL comes from the
runner's one device->host copy a block.  Over the processes of a
``chains`` mesh every rank runs the ladder on its chains, gets each
sample from the runner's one gather a block, and only rank 0 writes the
.ss file.
"""
from __future__ import annotations

import os

import numpy as np

from .engine import Engine
from .run import McmcRunner


def beta_ladder(nsteps: int, alpha: float = 0.4) -> np.ndarray:
    """beta_0..beta_K descending from 1.0 to 0.0."""
    k = np.arange(nsteps + 1)
    return ((nsteps - k) / nsteps) ** (1.0 / alpha)


def step_contribution(delta_beta: float, lnls) -> float:
    """One step's log mean exp((beta_{k-1} - beta_k) lnL), computed
    stably from the step's sampled lnL."""
    x = delta_beta * np.asarray(lnls, np.float64)
    m = x.max()
    return float(m + np.log(np.mean(np.exp(x - m))))


class SsRunner(McmcRunner):
    """Runs the steppingstone analysis and writes the .ss file (the
    reference's format: each step's beta, mean lnL and contribution)."""

    def __init__(self, engine: Engine, nsteps: int = 50, alpha: float = 0.4,
                 burninss: int = -1, **kw):
        super().__init__(engine, **kw)
        self.nsteps = nsteps
        self.alpha = alpha
        self.burninss = burninss  # < 0: |burninss| steps' worth of burnin

    def _ss_extra(self, lnZ, step, samples):
        """The steppingstone accumulators for the checkpoint (the
        reference keeps its SS state in the .ckp,
        src/mcmc.c:11253-11282)."""
        n_in_step = len(samples[0]) if samples else 0
        pad = np.full((self.mc.nruns, max(1, n_in_step)), np.nan)
        for r in range(min(self.mc.nruns, len(samples))):
            pad[r, :len(samples[r])] = samples[r]
        return {"lnZ": np.asarray(lnZ, np.float64),
                "step": np.asarray([step], np.int64),
                "n_in_step": np.asarray([n_in_step], np.int64),
                "samples": pad}

    def run_ss(self):
        mc = self.mc
        eng = self.eng
        betas = beta_ladder(self.nsteps, self.alpha)
        gens_per_step = max(mc.samplefreq,
                            (mc.ngen // self.nsteps)
                            // mc.samplefreq * mc.samplefreq)
        n_samples = max(1, gens_per_step // mc.samplefreq)
        burn_gens = gens_per_step * abs(self.burninss) \
            if self.burninss != 0 else 0
        lnZ = np.zeros(mc.nruns)
        gen = 0
        start_step, start_sample = 1, 0
        resume_samples = None
        resumed = False
        if self._resuming():
            states, bk, gen = self.read_checkpoint()
            ex = self._ckp_extra
            if "lnZ" in ex:
                lnZ = np.asarray(ex["lnZ"], np.float64).reshape(mc.nruns)
                start_step = int(np.asarray(ex["step"]).reshape(-1)[0])
                start_sample = int(
                    np.asarray(ex["n_in_step"]).reshape(-1)[0])
                pad = np.asarray(ex.get("samples", np.zeros((mc.nruns, 0))))
                resume_samples = [
                    [float(x) for x in pad[r][:start_sample]
                     if np.isfinite(x)] for r in range(mc.nruns)]
                resumed = True
                self.log(f"   Resuming steppingstone at step "
                         f"{start_step}/{self.nsteps} (sample "
                         f"{start_sample}/{n_samples}), generation {gen}")
            else:
                self.log("   Checkpoint has no steppingstone state; "
                         "restarting the ladder from step 1")
        if not resumed:
            states, bk = eng.init_chains()
            gen = 0
        states, bk = self._shard(states, bk)
        self._open_files(append=resumed, start_gen=gen)
        # the .ss rows of completed steps survive a resume
        old_rows = []
        if resumed and os.path.exists(f"{self.prefix}.ss"):
            with open(f"{self.prefix}.ss") as f:
                for line in f:
                    parts = line.split("\t")
                    if parts and parts[0].isdigit() \
                            and int(parts[0]) < start_step:
                        old_rows.append(line.rstrip("\n"))
        with self._open(f"{self.prefix}.ss", "w") as ssf:
            ssf.write(f"[ID: {mc.seed:010d}]\n")
            ssf.write("Step\tbeta\tmeanLnL\tcontribution\n")
            for row in old_rows:
                ssf.write(row + "\n")
            ssf.flush()
            self.log(f"   Steppingstone: {self.nsteps} steps x "
                     f"{gens_per_step} generations (alpha={self.alpha})")
            # the initial burn-in at beta = 1 (fresh starts only)
            if burn_gens and not resumed:
                bk = {**bk, "power": 1.0}
                for _ in range(burn_gens // mc.samplefreq):
                    states, bk = eng.run_block(states, bk, mc.samplefreq)
            for step in range(start_step, self.nsteps + 1):
                b_prev, b_k = betas[step - 1], betas[step]
                # the ladder sets the power, whatever a checkpoint held
                bk = {**bk, "power": float(b_k)}
                if step == start_step and resume_samples is not None:
                    samples = resume_samples
                    first_sample = start_sample
                else:
                    samples = [[] for _ in range(mc.nruns)]
                    first_sample = 0
                for _ in range(first_sample, n_samples):
                    states, bk = eng.run_block(states, bk, mc.samplefreq)
                    gen += mc.samplefreq
                    host, bk, _ = self._gather(states, bk)
                    for r, slot in enumerate(eng.cold_indices(host)):
                        samples[r].append(float(host["lnL"][slot]))
                    self._write_sample(gen, host)
                    if mc.checkfreq and gen % mc.checkfreq == 0:
                        self.write_checkpoint(
                            states, bk, gen,
                            extra=self._ss_extra(lnZ, step, samples))
                contrib = [step_contribution(b_prev - b_k, samples[r])
                           for r in range(mc.nruns)]
                lnZ += contrib
                ssf.write(f"{step}\t{b_k:.6f}\t"
                          f"{np.mean([np.mean(s) for s in samples]):.4f}\t"
                          f"{np.mean(contrib):.6f}\n")
                ssf.flush()
                # the step's end: a checkpoint with the step completed, so
                # a resume never runs a finished step again
                if mc.checkfreq:
                    self.write_checkpoint(
                        states, bk, gen,
                        extra=self._ss_extra(lnZ, step + 1, []))
                if step % max(1, self.nsteps // 10) == 0:
                    self.log(f"   Step {step}/{self.nsteps} (beta="
                             f"{b_k:.4f}): running lnZ = "
                             + " ".join(f"{z:.2f}" for z in lnZ))
        self._close_files()
        for r in range(mc.nruns):
            self.log(f"   Marginal likelihood (SS) for run {r + 1} = "
                     f"{lnZ[r]:.2f}")
        self.log("   Analysis completed")
        self.final_states, self.final_bk = states, bk
        return lnZ


def sumss(prefix: str, log=print) -> dict:
    """Summarize a .ss file (reference DoSumSs src/sumpt.c:534)."""
    steps = []
    with open(f"{prefix}.ss") as f:
        for line in f:
            if line.startswith(("[", "Step")):
                continue
            parts = line.split()
            if len(parts) >= 4:
                steps.append((int(parts[0]), float(parts[1]),
                              float(parts[2]), float(parts[3])))
    lnZ = sum(s[3] for s in steps)
    log(f"   Steppingstone steps: {len(steps)}")
    log(f"   Marginal likelihood (SS) = {lnZ:.2f}")
    log("   Step  beta      meanLnL      contribution")
    for s in steps[:: max(1, len(steps) // 10)]:
        log(f"   {s[0]:4d}  {s[1]:.4f}  {s[2]:12.2f}  {s[3]:10.4f}")
    return {"lnZ": lnZ, "steps": steps}
