"""MCMC run driver: sampling, output files, convergence, checkpointing.

Counterpart of ``mrbayes_tpu/mcmc/run.py``.  Host-side orchestration
around ``Engine.run_block``: the device advances ``samplefreq``
generations per block; at each block boundary the driver makes ONE
device->host copy of the chain states (every state tensor packed into one
buffer) and from it writes the ``.p``/``.t`` sample rows of each run's
cold chain (one ``.tree<t>.run<r>.t`` file a tree under unlinked trees,
with a ``TL{divisions}`` column each; under BEST the species tree in
``.run<r>.t`` and each gene tree in ``.run<r>.gene<g>.t``), updates the
split counters for
ASDSF (the worst tree's), prints progress and checkpoints.  File formats
follow the reference (PreparePrintFiles src/mcmc.c:10427,
PrintStatesToFiles :13186), so the reference's own sump/sumt can read
them.

The ``report`` command's columns (ancestral states, site rates, positive
selection; ``mcmc/report.py``) are computed on the device for each run's
cold chain and ride in the same one copy a block.

With a mesh (``parallel/mesh.py``) the engine's data may be sharded over
the ``sites`` axis within the process, and the chains over the
processes of a ``torch.distributed`` group (the ``chains`` axis, one
process a chain shard; mrbayes_tpu run.py:281-285).  Then each rank
holds its slice of the chains, the block's one copy becomes one
all-gather that gives every rank the full host view
(``mesh.gather_to_host``), and every rank records the same samples, so
the stoprule and the ASDSF are decided alike everywhere; a SIGINT on
any rank rides in that gather, so all stop at the same block.  Only
rank 0 logs and writes files and checkpoints, after the gather; a
barrier follows each checkpoint.
"""
from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

from ..models.codes import BASES
from ..trees import to_newick
from ..parallel import mesh as PM
from ..spans import SPANS, self_seconds
from .diagnostics import SplitCounter
from .engine import PI_FIELDS, SCORE_KEYS, Engine

_REV_NAMES = ("A<->C", "A<->G", "A<->T", "C<->G", "C<->T", "G<->T")
_AA = "ARNDCQEGHILKMFPSTWYV"
_AA3 = ("Ala", "Arg", "Asn", "Asp", "Cys", "Gln", "Glu", "Gly", "His", "Ile",
        "Leu", "Lys", "Met", "Phe", "Pro", "Ser", "Thr", "Trp", "Tyr", "Val")


def param_columns(eng: Engine):
    """Ordered (column-name, extractor) pairs mirroring the reference's .p
    layout; names get {d}/{all} suffixes for partitioned models.  An
    extractor maps (host states, chain slot) to a float."""
    cols = []
    n_div = eng.n_div
    multi = n_div > 1

    def suffix(param, gid):
        if not multi:
            return ""
        # the state-frequency fields share one group attribute (pi_group)
        # keyed by pi_field
        divs = [i + 1 for i, c in enumerate(eng.div_cfg)
                if (c.pi_field == param and c.pi_group == gid
                    if param in PI_FIELDS
                    else getattr(c, f"{param}_group") == gid)]
        if len(divs) == n_div:
            return "{all}"
        return "{" + ",".join(map(str, divs)) + "}"

    if eng.n_trees > 1:
        # one TL column an unlinked tree, tagged with its divisions (the
        # reference prints TL{divs} a brlens parameter; mrbayes_tpu
        # run.py:45-49)
        for t in range(eng.n_trees):
            divs = [i + 1 for i in range(n_div) if eng.div_tree[i] == t]
            cols.append(("TL{" + ",".join(map(str, divs)) + "}",
                         lambda st, s, t=t: float(np.sum(
                             eng.effective_blens(st, s, t)))))
    else:
        cols.append(("TL" + ("{all}" if multi else ""),
                     lambda st, s: float(np.sum(
                         eng.effective_blens(st, s)))))
    cols += _clock_columns(eng, multi)
    for gid in range(eng.n_groups.get("revmat", 0)):
        for k, nm in enumerate(_REV_NAMES):
            cols.append((f"r({nm})" + suffix("revmat", gid),
                         lambda st, s, g=gid, k=k:
                         float(st["revmat"][s, g, k])))
        if gid in eng._mixed_rev:
            # submodel indicator: growth string as digits (e.g. 112123),
            # reference prints gtrsubmodel{...} (src/mcmc.c:12934)
            cols.append(("gtrsubmodel" + suffix("revmat", gid),
                         lambda st, s, g=gid: float("".join(
                             str(int(x) + 1)
                             for x in np.asarray(st["gtr_class"][s, g])))))
    for gid in range(eng.n_groups.get("aarevmat", 0)):
        # upper-triangle pairs in the reference's amino-acid order
        # (src/model.c:19267-19285)
        for k, (i, j) in enumerate(zip(*np.triu_indices(20, 1))):
            cols.append((f"r({_AA[i]}<->{_AA[j]})" + suffix("aarevmat", gid),
                         lambda st, s, g=gid, k=k:
                         float(st["aarevmat"][s, g, k])))
    for gid in range(eng.n_groups.get("tratio", 0)):
        cols.append(("kappa" + suffix("tratio", gid),
                     lambda st, s, g=gid: float(st["tratio"][s, g])))
    for gid in range(eng.n_groups.get("omega", 0)):
        cols.append(("omega" + suffix("omega", gid),
                     lambda st, s, g=gid: float(st["omega"][s, g])))
    for gid in range(eng.n_groups.get("ny98", 0)):
        # unsuffixed, as the JAX package prints them
        cols.append(("omega(1)", lambda st, s, g=gid:
                     float(st["omega1"][s, g])))
        cols.append(("omega(3)", lambda st, s, g=gid:
                     float(st["omega3"][s, g])))
        for k, nm in enumerate(("-", "N", "+")):
            cols.append((f"pi({nm})", lambda st, s, g=gid, k=k:
                         float(st["omegaprobs"][s, g, k])))
    for gid in range(eng.n_groups.get("m3", 0)):
        # M3's omegas and class frequencies, interleaved and unsuffixed as
        # the JAX package prints them (run.py:156-161); M10 prints none
        for k in range(3):
            cols.append((f"omega({k + 1})", lambda st, s, g=gid, k=k:
                         float(st["m3omega"][s, g, k])))
            cols.append((f"pi({k + 1})", lambda st, s, g=gid, k=k:
                         float(st["m3probs"][s, g, k])))
    for gid in range(eng.n_groups.get("pi", 0)):
        for k, nm in enumerate("ACGT"):
            cols.append((f"pi({nm})" + suffix("pi", gid),
                         lambda st, s, g=gid, k=k: float(st["pi"][s, g, k])))
    for gid in range(eng.n_groups.get("pi20", 0)):
        # the reference prints three-letter names (pi(Ala) ...)
        for k, nm in enumerate(_AA3):
            cols.append((f"pi({nm})" + suffix("pi20", gid),
                         lambda st, s, g=gid, k=k:
                         float(st["pi20"][s, g, k])))
    for gid in range(eng.n_groups.get("pi2", 0)):
        for k in range(2):
            cols.append((f"pi({k})" + suffix("pi2", gid),
                         lambda st, s, g=gid, k=k: float(st["pi2"][s, g, k])))
    cols += _root_freq_columns(eng, suffix)
    for gid in range(eng.n_groups.get("pi61", 0)):
        code = next(c.codon for c in eng.div_cfg
                    if c.pi_field == "pi61" and c.pi_group == gid)
        for k, b in enumerate(code.bases):
            cols.append((f"pi({''.join(BASES[x] for x in b)})"
                         + suffix("pi61", gid),
                         lambda st, s, g=gid, k=k:
                         float(st["pi61"][s, g, k])))
    for gid in range(eng.n_groups.get("pi16", 0)):
        # the doublets AA, AC, ..., TT (mrbayes_tpu run.py:209-214)
        for k, (x, y) in enumerate((x, y) for x in "ACGT" for y in "ACGT"):
            cols.append((f"pi({x}{y})" + suffix("pi16", gid),
                         lambda st, s, g=gid, k=k:
                         float(st["pi16"][s, g, k])))
    for gid in range(eng.n_groups.get("shape", 0)):
        cols.append(("alpha" + suffix("shape", gid),
                     lambda st, s, g=gid: float(st["shape"][s, g])))
    for gid in range(eng.n_groups.get("mixtrates", 0)):
        # the kmixture rates, stored as a simplex, printed with mean 1
        # (reference mixturerates columns, src/model.c:19830; mrbayes_tpu
        # run.py:218-225)
        km = eng._simplex_width("mixtrates", gid)
        for k in range(km):
            cols.append((f"mixturerates{suffix('mixt', gid)}[{k + 1}]",
                         lambda st, s, g=gid, k=k, km=km:
                         float(st["mixtrates"][s, g, k]) * km))
    for gid in range(eng.n_groups.get("ratecorr", 0)):
        cols.append(("corr" + suffix("ratecorr", gid),
                     lambda st, s, g=gid: float(st["ratecorr"][s, g])))
    for gid in range(eng.n_groups.get("pinvar", 0)):
        cols.append(("pinvar" + suffix("pinvar", gid),
                     lambda st, s, g=gid: float(st["pinvar"][s, g])))
    for gid in range(eng.n_groups.get("covswitch", 0)):
        # the reference's s(off->on) / s(on->off) (mrbayes_tpu run.py:232)
        for k, nm in enumerate(("s(off->on)", "s(on->off)")):
            cols.append((nm + suffix("covswitch", gid),
                         lambda st, s, g=gid, k=k:
                         float(st["covswitch"][s, g, k])))
    for gid in range(eng.n_groups.get("aamodel", 0)):
        cols.append(("aamodel" + suffix("aamodel", gid),
                     lambda st, s, g=gid: float(st["aamodel_idx"][s, g])))
    for gid in range(eng.n_groups.get("brownscale", 0)):
        # continuous data's Brownian variance rate sigma^2
        cols.append(("brownScale" + suffix("brownscale", gid),
                     lambda st, s, g=gid: float(st["brownscale"][s, g])))
    if eng.ratemult_on:
        # BEST's gene rates print as g_m{i} (reference P_GENETREERATE,
        # src/model.c:20048; mrbayes_tpu run.py:246-252)
        mname = "g_m" if eng.generate_on else "m"
        for d in range(n_div):
            cols.append((f"{mname}{{{d + 1}}}",
                         lambda st, s, d=d: float(
                             st["ratemult"][s, d] / eng.div_char_frac[d])))
    return cols


def _root_freq_columns(eng: Engine, suffix):
    """The directional root frequencies' columns (mrbayes_tpu
    run.py:180-198): rootpi(0) and rootpi(1) a group, -9999 while a mixed
    run is in the stationary state, and a mixed group's statefrmod
    indicator (the reference's .p output)."""
    cols = []
    for gid in range(eng.n_groups.get("rootpi2", 0)):
        mixed = any(c.dirpi_mix for c in eng.div_cfg
                    if c.rootpi_group == gid)

        def rootv(st, s, g, k, mixed=mixed):
            if mixed and int(st["dirpi_on"][s, g]) == 0:
                return -9999.0
            return float(st["rootpi2"][s, g, k])

        for k in (0, 1):
            cols.append((f"rootpi({k})" + suffix("rootpi", gid),
                         lambda st, s, g=gid, k=k: rootv(st, s, g, k)))
        if mixed:
            cols.append(("statefrmod", lambda st, s, g=gid:
                         float(st["dirpi_on"][s, g])))
    return cols


def _clock_columns(eng: Engine, multi: bool):
    """A clock model's columns after TL (mrbayes_tpu run.py:68-116): the
    tree height in substitutions, the sampled clock rate, the CPP rate and
    event count or the branch-rate variance (and the mixed model's
    indicator), the tree-process parameters and the number of sampled
    ancestors."""
    ts = eng.tree_settings
    if eng.best:
        return _best_columns(eng)
    if not ts.clock:
        return []
    root = eng.n_nodes - 1

    def field(name):
        return lambda st, s: float(st[name][s, 0])

    cols = [("TH" + ("{all}" if multi else ""),
             lambda st, s: float(st["age"][s, root])
             * (float(st["clockrate"][s, 0]) if "clockrate" in st else 1.0))]
    if ts.clockratepr.kind != "fixed":
        cols.append(("clockrate", field("clockrate")))
    if ts.clockvarpr == "cpp":
        cols += [("cppRate", field("cpprate")),
                 ("nEvents", lambda st, s: float(np.sum(st["cpp_n"][s])))]
    elif ts.clockvarpr != "strict":
        cols.append((f"{ts.clockvarpr}var" + ("{all}" if multi else ""),
                     field("clockvar")))
        if ts.clockvarpr == "mixed":
            # 0 = IGR, 1 = ILN (the reference's RCL_* indicators)
            cols.append(("rclModel", field("rcl_model")))
    if ts.clockpr in ("birthdeath", "fossilization"):
        cols += [("net_speciation", field("speciation")),
                 ("relative_extinction", field("extinction"))]
    if ts.clockpr == "coalescence":
        cols.append(("theta", field("popsize")))
        if ts.growthpr.kind != "fixed":
            cols.append(("growthRate", field("growth")))
    if ts.clockpr == "fossilization":
        cols.append(("relative_fossilization", field("fossilization")))
        if eng._samples_ancestors():
            cols.append(("nSampledAncestors",
                         lambda st, s: float(np.sum(st["sa"][s]))))
    return cols


def _best_columns(eng: Engine):
    """BEST's columns after TL, where a clock model's TH is dropped
    (mrbayes_tpu run.py:58-72): the species tree's height, the population
    sizes (theta[k] with popvarpr=variable, one theta otherwise) and,
    under birthdeath, its parameters."""
    ts = eng.tree_settings
    root = 2 * eng.n_species - 2
    cols = [("speciesTreeHeight", lambda st, s: float(st["s_age"][s, root]))]
    npop = 2 * eng.n_species - 1 if ts.popvarpr == "variable" else 1
    for k in range(npop):
        cols.append((f"theta[{k + 1}]" if npop > 1 else "theta",
                     lambda st, s, k=k: float(st["popsize"][s, k])))
    if ts.clockpr == "birthdeath":
        cols += [("net_speciation",
                  lambda st, s: float(st["speciation"][s, 0])),
                 ("relative_extinction",
                  lambda st, s: float(st["extinction"][s, 0]))]
    return cols


def host_states(states: dict, bk: dict, report=None) -> dict:
    """Every chain-state tensor plus ``temp_id`` (and the report columns
    [runs, columns], as ``report``) on the host, with ONE device->host
    copy: the tensors are packed as float64 into one buffer (float32
    values and small integers round-trip exactly) and unpacked into their
    own dtypes.  The eigensystem cache is left out."""
    keys = [k for k in states if not k.startswith("eig")]
    parts = [states[k] for k in keys] + [bk["temp_id"]]
    names = keys + ["temp_id"]
    if report is not None:
        parts.append(report)
        names.append("report")
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in parts])
    buf = flat.cpu().numpy()
    out, at = {}, 0
    for k, t in zip(names, parts):
        n = t.numel()
        dtype = {torch.float32: np.float32, torch.bool: np.bool_}.get(
            t.dtype, np.int64)
        out[k] = buf[at:at + n].reshape(tuple(t.shape)).astype(dtype)
        at += n
    return out


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rooting(t) -> str:
    """The reference's rooting comment of a tree line."""
    return "[&R]" if t.rooted else "[&U]"


class _NullFile:
    """Where a rank other than 0 writes its sample rows: nowhere (the
    reference's MrBayesPrint gating, src/utils.c:1136)."""

    def write(self, s):
        return len(s)

    def flush(self):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


class McmcRunner:
    def __init__(self, engine: Engine, file_prefix: str | None = None,
                 log=print, report: dict | None = None, mesh=None,
                 span_mark=None):
        self.eng = engine
        # the spans' totals at the start of this run's command
        # (``SPANS.mark()``; None: at ``run``), for ``phase_times``
        self.span_mark = span_mark
        self.phase_times: dict = {}
        self.mc = engine.mcmc
        self.prefix = file_prefix or self.mc.filename
        self.mesh = mesh
        n_proc = PM.process_count()
        self.multiprocess = n_proc > 1
        self.is_main = PM.process_index() == 0
        if self.multiprocess and (mesh is None
                                  or mesh.shape["chains"] != n_proc):
            raise ValueError(f"a run over {n_proc} processes needs a mesh "
                             f"of {n_proc} chain shards")
        if not self.is_main:
            log = lambda msg: None   # noqa: E731  (rank 0 logs)
        self.log = log
        self.cols = param_columns(engine)
        # the report command's ancstates/siterates/possel/siteomega
        # columns (mcmc/report.py; reference src/mcmc.c:12456-13147)
        self.reporter = None
        if report:
            from .report import Reporter
            rep = Reporter(engine, report, log=log)
            if rep.headers:
                self.reporter = rep
                log(f"   Reporting {len(rep.headers)} extra sample "
                    "columns (report command)")
        self.n_trees = engine.n_trees
        # split frequencies of each tree parameter
        self.splits = [SplitCounter(self.mc.nruns)
                       for _ in range(self.n_trees)]
        self.param_samples: list[list[dict]] = [
            [] for _ in range(self.mc.nruns)]
        self.asdsf_series: list[tuple[int, float]] = []

    # ------------------------------------------------------------- files
    @staticmethod
    def _truncate_after(path: str, gen: int, tree_file: bool):
        """Drop sample rows newer than the checkpoint generation so an
        append run continues seamlessly (reference ReusePreviousResults,
        src/mcmc.c:15840, src/utils.c:289)."""
        if not os.path.exists(path):
            return
        with open(path) as f:
            lines = f.readlines()
        kept = []
        for ln in lines:
            tok = ln.split()
            g = None
            if tree_file and len(tok) >= 2 and tok[0] == "tree" \
                    and tok[1].startswith("gen."):
                g = int(tok[1][4:])
            elif not tree_file and tok and tok[0].isdigit():
                g = int(tok[0])
            if g is not None and g > gen:
                continue
            if tree_file and ln.strip() == "end;":
                continue        # reopened for more samples
            kept.append(ln)
        with open(path, "w") as f:
            f.writelines(kept)

    def _tree_paths(self, r: int) -> list[str]:
        """Run r's tree-sample files: one a tree parameter, named
        <prefix>.tree<t>.run<r>.t for unlinked trees (reference
        src/mcmc.c:10510; mrbayes_tpu run.py:341-347)."""
        if self.n_trees > 1:
            return [f"{self.prefix}.tree{t + 1}.run{r + 1}.t"
                    for t in range(self.n_trees)]
        return [f"{self.prefix}.run{r + 1}.t"]

    def _gene_paths(self, r: int) -> list[str]:
        """Run r's gene-tree files under BEST, <prefix>.run<r>.gene<g>.t
        (mrbayes_tpu run.py:387-395); none otherwise."""
        if not self.eng.best:
            return []
        return [f"{self.prefix}.run{r + 1}.gene{g + 1}.t"
                for g in range(self.eng.n_div)]

    def _open(self, path: str, mode: str):
        """``path`` opened on rank 0; elsewhere a file that writes
        nowhere."""
        return open(path, mode) if self.is_main else _NullFile()

    def _open_files(self, append: bool, start_gen: int = 0):
        mode = "a" if append else "w"
        self.pf, self.tf, self.gf = [], [], []
        seed_id = self.mc.seed

        def tree_header(f, labels):
            f.write(f"#NEXUS\n[ID: {seed_id:010d}]\n"
                    "[Param: tree]\nbegin trees;\n   translate\n")
            for i, name in enumerate(labels):
                sep = "," if i < len(labels) - 1 else ";"
                f.write(f"       {i + 1} {name}{sep}\n")

        for r in range(self.mc.nruns):
            base = f"{self.prefix}.run{r + 1}"
            if append and self.is_main:
                self._truncate_after(base + ".p", start_gen, False)
                for path in self._tree_paths(r) + self._gene_paths(r):
                    self._truncate_after(path, start_gen, True)
            pf = self._open(base + ".p", mode)
            tfs = [self._open(path, mode) for path in self._tree_paths(r)]
            gfs = [self._open(path, mode) for path in self._gene_paths(r)]
            if not append:
                pf.write(f"[ID: {seed_id:010d}]\n")
                hdr = "Gen\tlnLike\tlnPrior\t" \
                    + "\t".join(n for n, _ in self.cols)
                if self.reporter is not None:
                    hdr += "\t" + "\t".join(self.reporter.headers)
                pf.write(hdr + "\n")
                for tf in tfs:
                    tree_header(tf, self.eng.tree_taxa_labels)
                for gf in gfs:
                    tree_header(gf, self.eng.data.taxa)
            self.pf.append(pf)
            self.tf.append(tfs)
            self.gf.append(gfs)
        self.mcmcf = self._open(f"{self.prefix}.mcmc", mode)
        if not append:
            self.mcmcf.write(f"[ID: {seed_id:010d}]\n")
            self.mcmcf.write("Gen\tAvgStdDev(s)\n")

    def _close_files(self):
        """Close the .p, .t (ending its trees block) and .mcmc files."""
        for f in self.pf:
            f.close()
        for f in (f for tfs in self.tf + self.gf for f in tfs):
            f.write("end;\n")
            f.close()
        self.mcmcf.close()

    def _debug_checks(self, gen: int, host, states):
        """Opt-in in-loop invariants (role of the reference's
        --enable-debug generation checks: IsTreeConsistent
        src/utils.c:4778 and the DEBUG_LNLIKELIHOOD full-recompute
        cross-check, src/mcmc.c:16769-16861).  MB_DEBUG=1 validates every
        chain's tree at each sample boundary; MB_DEBUG_LNL=1 recomputes
        the carried lnL/lnP from scratch and raises on drift.  The
        tolerance on the carried prior components scales with |lnP|
        (float32 sums)."""
        if os.environ.get("MB_DEBUG"):
            for slot in range(self.mc.n_chains_total):
                for t in range(self.n_trees):
                    self.eng.extract_tree(host, slot, t).check()
        if os.environ.get("MB_DEBUG_LNL"):
            # this process's chains against their rows of the host view
            sl = slice(*self.eng.chain_slice)
            fresh = self.eng.score({k: v for k, v in states.items()
                                    if k not in SCORE_KEYS})
            diff = {k: float(np.abs(fresh[k].cpu().numpy()
                                    - host[k][sl]).max()) for k in SCORE_KEYS}
            scale = 1e-6 * float(np.abs(host["lnP"]).max())
            if diff["lnL"] > 0.5 or diff["lnP"] > 0.5 \
                    or diff["lnP_tree"] > 1e-3 + scale \
                    or diff["lnP_par"] > 1e-3 + scale:
                raise AssertionError(
                    f"DEBUG_LNL drift at gen {gen}: max |dlnL|="
                    f"{diff['lnL']:.4f} |dlnP|={diff['lnP']:.4f} "
                    f"|dlnP_tree|={diff['lnP_tree']:.5f} "
                    f"|dlnP_par|={diff['lnP_par']:.5f} (carried vs "
                    f"recomputed)")

    def _host(self, states, bk) -> dict:
        """The block's one device->host copy (``host_states``), with the
        report columns of each run's cold chain when reporting."""
        rep = None
        if self.reporter is not None:
            rep = self.reporter.compute(states, self.reporter.cold_slots(bk))
        return host_states(states, bk, rep)

    def _gather(self, states, bk, abort: bool = False):
        """(host view, bk, abort): in one process ``_host`` and ``bk``
        unchanged.  Over processes the block's one all-gather
        (``mesh.gather_to_host``): every rank gets the full host view, the
        gathered bookkeeping (kept as ``_host_bk`` for the checkpoint and
        the summaries) and ``temp_id`` and the swap matrices put back on
        its device, identical on every rank; the report rows of each run
        come from the rank that holds its cold chain, and ``abort`` is
        true when any rank's is."""
        if not self.multiprocess:
            return self._host(states, bk), bk, abort
        rep = None
        if self.reporter is not None:
            lo, hi = self.eng.chain_slice
            slots = self.reporter.cold_slots(bk) - lo
            mine = (slots >= 0) & (slots < hi - lo)
            rep = torch.where(mine[:, None], self.reporter.compute(
                states, slots.clamp(0, hi - lo - 1)), 0.0)
        host, self._host_bk, flags = PM.gather_to_host(
            states, bk, rep, flags=(float(abort),))
        bk = PM.replicate_bookkeeping(bk, self._host_bk, host["temp_id"])
        return host, bk, bool(flags.any())

    def _write_sample(self, gen: int, host):
        for r, slot in enumerate(self.eng.cold_indices(host)):
            lnL = float(host["lnL"][slot])
            lnP = float(host["lnP"][slot])
            vals = [fn(host, slot) for _, fn in self.cols]
            rep = ([float(x) for x in host["report"][r]]
                   if "report" in host else [])
            self.pf[r].write(
                f"{gen}\t{lnL:.6e}\t{lnP:.6e}\t"
                + "\t".join(f"{v:.6e}" for v in vals + rep) + "\n")
            for ti in range(self.n_trees):
                t = self.eng.extract_tree(host, slot, ti)
                self.tf[r][ti].write(f"   tree gen.{gen} = {_rooting(t)} "
                                     + to_newick(t, numbers=True) + "\n")
                self.splits[ti].add(r, t)
            for g, gf in enumerate(self.gf[r]):
                gt = self.eng.extract_gene_tree(host, slot, g)
                gf.write(f"   tree gen.{gen} = [&R] "
                         + to_newick(gt, numbers=True) + "\n")
            self.param_samples[r].append(
                dict(zip(["Gen", "lnLike", "lnPrior"]
                         + [n for n, _ in self.cols], [gen, lnL, lnP] + vals)))

    # --------------------------------------------------------- checkpoint
    # The reference checkpoints every chain's full state, move tuning and
    # RNG seeds to a rotated .ckp file (PrintCheckPoint src/mcmc.c:11192,
    # resume :2449-2490).  Here every state key and every bookkeeping key
    # is one `array` command of an `mbtpu_state` block; the three torch
    # generators are stored as their state bytes, so a resumed run draws
    # the numbers the uninterrupted run would have drawn.
    _GENERATORS = ("rng", "rng_host", "rng_swap")

    @staticmethod
    def _fmt_array(a: np.ndarray) -> str:
        flat = a.reshape(-1)
        if np.issubdtype(a.dtype, np.floating):
            # 9 significant digits round-trip float32 exactly
            return " ".join(f"{float(x):.9e}" for x in flat)
        return " ".join(str(int(x)) for x in flat)

    def write_checkpoint(self, states, bk, gen: int, extra=None):
        """Rotated self-describing NEXUS checkpoint: a standard trees
        block with every chain's current tree, then the exact state in an
        `mbtpu_state` block (NEXUS readers skip unknown blocks), with
        ``extra`` arrays as ``ss.<key>`` (the steppingstone accumulators;
        the reference keeps its SS state in the .ckp too,
        src/mcmc.c:11253-11282).  Over processes every rank takes part in
        a gather of the chains and of every rank's generator states, rank
        0 writes, and a barrier follows."""
        if self.multiprocess:
            # every rank's chains and generators
            host, _, _ = self._gather(states, bk)
            gens = PM.all_gather_object({
                k: bk[k].get_state().numpy() for k in self._GENERATORS})
            bk = {**bk, **self._host_bk, "temp_id": host["temp_id"],
                  **{k: np.stack([g[k] for g in gens])
                     for k in self._GENERATORS}}
            if not self.is_main:
                PM.barrier()
                return
        else:
            host = host_states(states, bk)
        # the text from the host copy: a span of its own, so an idle card
        # while it is written is named in a device trace
        with SPANS("run.checkpoint.write"):
            self._write_ckp(host, bk, gen, extra)
        PM.barrier()

    def _write_ckp(self, host, bk, gen: int, extra):
        """``<prefix>.ckp`` from the host view ``host`` (the chains) and
        the bookkeeping ``bk`` (see ``write_checkpoint``)."""
        mc = self.mc
        nc = mc.nchains
        lines = ["#NEXUS", f"[ID: {mc.seed:010d}]", f"[generation: {gen}]",
                 f"[seed: {mc.seed}]", f"[swapseed: {mc.swapseed}]",
                 "begin trees;", "   translate"]
        labels = self.eng.tree_taxa_labels
        for i, name in enumerate(labels):
            sep = "," if i < len(labels) - 1 else ";"
            lines.append(f"       {i + 1} {name}{sep}")
        tid = host["temp_id"]
        for slot in range(mc.n_chains_total):
            r, c = slot // nc, slot % nc
            for ti in range(self.n_trees):
                t = self.eng.extract_tree(host, slot, ti)
                tree = f"tree={ti + 1}." if self.n_trees > 1 else ""
                lines.append(f"   tree gen.{gen}${tree}run={r + 1}.chain="
                             f"{c + 1}.heat={int(tid[slot])} = "
                             f"{_rooting(t)} " + to_newick(t, numbers=True))
        lines += ["end;", "begin mbtpu_state;", f"   generation {gen};"]

        def dump(prefix, d):
            for k, v in d.items():
                a = np.asarray(v)
                shape = ",".join(str(s) for s in a.shape)
                lines.append(f"   array {prefix}.{k} {a.dtype.name} "
                             f"[{shape}] = {self._fmt_array(a)};")

        dump("states", {k: v for k, v in host.items()
                        if k not in ("temp_id", "report")})
        dump("bk", {k: (v.get_state().numpy()
                        if isinstance(v, torch.Generator)
                        else v.cpu().numpy() if torch.is_tensor(v) else v)
                    for k, v in bk.items()})
        if extra:
            dump("ss", {k: np.asarray(v) for k, v in extra.items()})
        lines.append("end;")
        path = f"{self.prefix}.ckp"
        if os.path.exists(path):
            os.replace(path, path + "~")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    def read_checkpoint(self):
        """(states, bk, generation) from ``<prefix>.ckp``, all chains (a
        process of a ``chains`` mesh keeps its slice in ``shard_chains``);
        the scores are recomputed exactly.  Its ``ss.`` arrays go to
        ``_ckp_extra``.  A checkpoint of N processes holds a generator
        state a rank, and rank r takes row r; one of one process gives its
        ``rng`` to rank 0, and ranks r > 0 keep theirs from
        ``mesh.rank_seed``."""
        with open(f"{self.prefix}.ckp") as f:
            arrays, gen = self._parse_nexus_ckp(f.read())
        self._ckp_extra = {k[len("ss."):]: v for k, v in arrays.items()
                           if k.startswith("ss.")}
        states, bk = self.eng.init_chains()
        dev = self.eng.device
        states = {k: (torch.as_tensor(arrays["states." + k].reshape(
            tuple(v.shape)), dtype=v.dtype, device=dev)
            if "states." + k in arrays else v)
            for k, v in states.items() if k not in SCORE_KEYS}
        for k, v in list(bk.items()):
            a = arrays.get("bk." + k)
            if a is None:
                continue
            if isinstance(v, torch.Generator):
                if a.ndim == 2:
                    if a.shape[0] != PM.process_count():
                        raise ValueError(
                            f"the checkpoint was written by {a.shape[0]} "
                            f"processes, this run has "
                            f"{PM.process_count()}")
                    a = a[PM.process_index()]
                elif k == "rng" and PM.process_index() > 0:
                    continue
                v.set_state(torch.as_tensor(a.astype(np.uint8)))
            elif torch.is_tensor(v):
                bk[k] = torch.as_tensor(a.reshape(tuple(v.shape)),
                                        dtype=v.dtype, device=dev)
            else:
                bk[k] = type(v)(a.reshape(()))
        states = self.eng.score(self.eng.refresh_eigs(states))
        return states, bk, gen

    @staticmethod
    def _parse_nexus_ckp(text: str):
        """Parse the mbtpu_state block of a NEXUS checkpoint."""
        arrays: dict = {}
        gen = 0
        body = text.split("begin mbtpu_state;", 1)[1]
        for stmt in body.split(";"):
            toks = stmt.split()
            if not toks:
                continue
            if toks[0] == "generation":
                gen = int(toks[1])
            elif toks[0] == "array":
                name, dtype, shape = toks[1], toks[2], toks[3]
                shp = tuple(int(s) for s in shape.strip("[]").split(",")
                            if s)
                a = np.array([float(x) for x in toks[5:]], dtype=dtype)
                arrays[name] = a.reshape(shp)
            elif toks[0] == "end":
                break
        return arrays, gen

    # --------------------------------------------------------------- run
    # The run is recorded in host spans (``spans.py``): ``run.chain_start``
    # (starting or resumed states, output files, the first sample), then
    # ``run.loop`` over the wall time ``wall_seconds`` counts, its self
    # time the driver's own remainder, with a block's ``run.block`` (the
    # host's call of ``Engine.run_block``, its ``gen.*`` spans inside),
    # ``run.wait`` (the gather, which waits for the card),
    # ``run.sample_io``, ``run.diagnostics`` and ``run.checkpoint``.
    def run(self):
        mc = self.mc
        eng = self.eng
        mark = self.span_mark if self.span_mark is not None \
            else SPANS.mark()
        SPANS.watch_profiler()
        start_gen = 0
        with SPANS("run.chain_start"):
            if self._resuming():
                states, bk, start_gen = self.read_checkpoint()
                self.log(f"   Resuming from checkpoint at generation "
                         f"{start_gen}")
            else:
                states, bk = eng.init_chains()
            states, bk = self._shard(states, bk)
            self._open_files(append=start_gen > 0, start_gen=start_gen)
            host, bk, _ = self._gather(states, bk)
            self.log(f"   Running Markov chain ( {mc.nruns} runs x "
                     f"{mc.nchains} chains, {mc.ngen} generations ) on "
                     f"{eng.device}")
            self.log("   Initial log likelihoods: "
                     + " ".join(f"{v:.2f}" for v in host["lnL"]))
            if start_gen == 0:
                self._write_sample(0, host)
        # graceful SIGINT: the first ^C stops at the next block boundary
        # (checkpoint written); a second aborts (reference CatchInterrupt,
        # src/mcmc.c:2205, :15495)
        self._abort = False

        def on_sigint(sig, frame):
            if self._abort:
                raise KeyboardInterrupt
            self._abort = True
            self.log("   ^C received: stopping at the next sample "
                     "boundary (checkpoint will be written); press ^C "
                     "again to abort immediately")

        try:
            prev_handler = signal.signal(signal.SIGINT, on_sigint)
        except ValueError:       # not the main thread
            prev_handler = None
        t0 = time.perf_counter()
        gen = start_gen
        stopped = False
        with SPANS("run.loop"):
            while gen < mc.ngen and not stopped:
                n = min(mc.samplefreq, mc.ngen - gen)
                with SPANS("run.block"):
                    states, bk = eng.run_block(states, bk, n)
                # waits for the device; over processes, any rank's ^C
                # stops every rank at this block
                with SPANS("run.wait"):
                    host, bk, abort = self._gather(states, bk, self._abort)
                    SPANS.add("eig_rows_changed", eng.take_eig_tally())
                self._abort = self._abort or abort
                gen += n
                if self._abort:
                    self.log(f"   Run aborted by user at generation {gen}")
                    stopped = True
                with SPANS("run.sample_io"):
                    if os.environ.get("MB_DEBUG") \
                            or os.environ.get("MB_DEBUG_LNL"):
                        self._debug_checks(gen, host, states)
                    if gen % mc.samplefreq == 0 or gen == mc.ngen \
                            or stopped:
                        self._write_sample(gen, host)
                if gen % mc.printfreq == 0 or gen == mc.ngen:
                    cold = eng.cold_indices(host)
                    rate = (gen - start_gen) / max(
                        time.perf_counter() - t0, 1e-9)
                    eta = (mc.ngen - gen) / max(rate, 1e-9)
                    self.log(f"   {gen} -- "
                             + " ".join(f"[{host['lnL'][c]:.3f}]"
                                        for c in cold)
                             + f" -- {rate:.0f} gen/s -- {eta:.0f} s "
                             "remaining")
                with SPANS("run.diagnostics"):
                    if gen % mc.diagnfreq == 0 and mc.nruns > 1:
                        asdsf = self._burned_asdsf()
                        self.asdsf_series.append((gen, asdsf))
                        self.mcmcf.write(f"{gen}\t{asdsf:.6f}\n")
                        self.mcmcf.flush()
                        self.log(f"   Average standard deviation of split "
                                 f"frequencies: {asdsf:.6f}")
                        if mc.stoprule and asdsf < mc.stopval:
                            self.log("   Analysis stopped: convergence "
                                     "criterion reached")
                            stopped = True
                with SPANS("run.checkpoint"):
                    if mc.checkfreq and gen % mc.checkfreq == 0:
                        self.write_checkpoint(states, bk, gen)
            with SPANS("run.checkpoint"):
                self.write_checkpoint(states, bk, gen)
            if prev_handler is not None:
                signal.signal(signal.SIGINT, prev_handler)
            self._close_files()
        dt = time.perf_counter() - t0
        self.wall_seconds = dt
        self.generations = gen - start_gen
        self.phase_times = self._phase_times(SPANS.since(mark))
        self.log(f"   Analysis completed in {dt:.0f} seconds")
        self.log(f"   Analysis used {dt:.2f} seconds of total time")
        self._print_time_breakdown(dt)
        for r, slot in enumerate(eng.cold_indices(host)):
            best = max((s["lnLike"] for s in self.param_samples[r]),
                       default=float(host["lnL"][slot]))
            self.log(f"   Likelihood of best state for \"cold\" chain of "
                     f"run {r + 1} was {best:.2f}")
        self._print_move_summary(self._host_bk if self.multiprocess else bk)
        self.final_states, self.final_bk = states, bk
        return states, bk

    @staticmethod
    def _phase_times(view: dict) -> dict:
        """The run's host time by phase, seconds: ``device`` (the block's
        call and the wait for it), ``sample_io``, ``diagnostics`` and
        ``checkpoint`` (inclusive), then every span's ``.count``,
        ``.incl_s`` and ``.self_s`` and the counters of ``view``."""
        def incl(name):
            return view.get(f"{name}.incl_s", 0.0)

        return {"device": incl("run.block") + incl("run.wait"),
                "sample_io": incl("run.sample_io"),
                "diagnostics": incl("run.diagnostics"),
                "checkpoint": incl("run.checkpoint"), **view}

    def _print_time_breakdown(self, dt: float):
        """The phases over the wall time, then every span's self time and
        the eigensystem counts."""
        pt = self.phase_times
        phases = ("device", "sample_io", "diagnostics", "checkpoint")
        tracked = sum(pt[k] for k in phases)
        self.log("   Time breakdown: "
                 + "  ".join(f"{k} {pt[k]:.2f}s ({pt[k] / max(dt, 1e-9):.0%})"
                             for k in phases)
                 + f"  other {max(dt - tracked, 0.0):.2f}s")
        # the command's time in spans: the engine build, the chain start
        # and the loop
        own = self_seconds(pt)
        base = max(sum(own.values()), 1e-9)
        self.log(f"   Host self time by span, of {base:.2f}s in spans: "
                 + "  ".join(f"{k} {v:.3f}s ({v / base:.1%})"
                             for k, v in own.items()))
        if pt.get("eig_rows"):
            self.log(f"   Eigensystems: {pt['eig_rows']} computed, "
                     f"{pt['eig_rows_changed']} with changed inputs")

    def _resuming(self) -> bool:
        """True when ``append=yes`` finds ``<prefix>.ckp``.  Over processes
        every rank must see it alike (they share a directory); a rank that
        does not would run another number of generations and hang its
        peers, so a disagreement raises on every rank."""
        found = self.mc.append and os.path.exists(f"{self.prefix}.ckp")
        if self.multiprocess and len(set(PM.all_gather_object(found))) > 1:
            raise RuntimeError(
                f"append=yes: {self.prefix}.ckp is visible to some ranks "
                f"only; launch every rank in one shared directory")
        return found

    def _shard(self, states, bk):
        """Place the run on the mesh's ``chains`` axis (this process's
        slice; the identity without a mesh or at one chain shard) and log
        it."""
        if self.mesh is None:
            return states, bk
        states, bk = PM.shard_chains(self.eng, self.mesh, states, bk)
        n = PM.process_count()
        backend = f", backend {PM.world().backend}" if n > 1 else ""
        self.log(f"   Sharding over mesh {self.mesh.shape} "
                 f"({n} process(es){backend})")
        return states, bk

    def _burned_asdsf(self) -> float:
        """Live ASDSF with relative burn-in applied over the recorded
        per-sample split sets (reference src/mcmc.c:1750)."""
        mc = self.mc
        burn = mc.burninfrac if mc.relburnin else 0.0
        # the worst tree parameter's (mrbayes_tpu run.py:753-760)
        return max(sc.asdsf(mc.minpartfreq, burn_frac=burn)
                   for sc in self.splits)

    def _print_move_summary(self, bk):
        """The move and swap tables from ``bk`` (tensors, or the gathered
        host arrays over processes)."""
        tries = _np(bk["tries_total"]).sum(0)
        accepts = _np(bk["accepts_total"]).sum(0)
        pt = self.phase_times
        self.log("   Acceptance rates per move (all chains), and the "
                 "host's ms a proposal:")
        for i, mv in enumerate(self.eng.moves):
            if tries[i]:
                span = f"gen.propose.{mv.name}"
                n = pt.get(f"{span}.count")
                ms = (f"{1e3 * pt[f'{span}.self_s'] / n:8.3f}" if n
                      else f"{'--':>8s}")
                self.log(f"      {accepts[i] / tries[i]:6.1%}  "
                         f"({int(tries[i]):9d} tries)  {ms} ms  {mv.name}")
        self._print_swap_info(bk)

    def _print_swap_info(self, bk):
        """Chain swap matrix per run: upper triangle = acceptance rate,
        lower triangle = attempt count (reference PrintSwapInfo,
        src/mcmc.c:13579)."""
        if self.mc.nchains < 2:
            return
        st = _np(bk["swap_tries"])
        sa = _np(bk["swap_accepts"])
        nc = self.mc.nchains
        for r in range(self.mc.nruns):
            self.log(f"   Chain swap information for run {r + 1} "
                     "(upper: acceptance rate, lower: attempts):")
            self.log("            " + "".join(f"{c + 1:>9d}"
                                              for c in range(nc)))
            for i in range(nc):
                cells = []
                for j in range(nc):
                    if j > i:
                        t = st[r, i, j]
                        cells.append(f"{sa[r, i, j] / t:9.2f}" if t
                                     else f"{'--':>9s}")
                    elif j < i:
                        cells.append(f"{int(st[r, j, i]):9d}")
                    else:
                        cells.append(f"{'--':>9s}")
                self.log(f"      {i + 1:>4d}  " + "".join(cells))
