"""The test1 and test2 envelope runs: MrBayes' own CI checks
(testing/test1.nex and testing/test2.nex with testing/runtests.sh.in:82-
161's statistics) through the port's CLI.

test1 is primates.nex split into two partitions (1-400, 401-.) under
nst=mixed rates=invgamma with state frequencies, exchangeabilities,
pinvar and shape unlinked and ratepr=variable, 2 runs x 4 chains.  test2
is the same data and substitution model on a clock tree: a uniform
clock, an exponential(1) clock rate and IGR relaxed branch rates
(``brlenspr=clock:uniform clockratepr=exp(1) clockvarpr=igr``), with the
default (fixed) rate multipliers.  Either run must land in the
reference's envelope (the same for both, tests/envelope_check.py):

  * cold-chain best lnL    in [-5715, -5700]
  * posterior mean TL      in [2.2, 4.5] (the reference binary's own
    measured range on this configuration; see tests/envelope_check.py)
  * final ASDSF            < 0.05
  * average PSRF           in [0.95, 1.2]

Usage (on the GPU; ``--device cpu`` for the CPU):

    python -m mrbayes_tpu_torch.envelope [--config test1|test2]
        [--ngen 20000] [--multiwalk] [--workdir runs/envelope]

prints one ``ENVELOPE {...}`` JSON line and exits 1 outside the envelope.
``run_batch`` also runs cynmix's favored model, avian_ovomucoids.nex under
``aamodelpr=mixed``, replicase.nex under the NY98, M3 and M10 codon
models, hymfossil.nex's fossilized birth-death dating analysis, and
kim.nex's stem-doublet model and its unlinked gene trees, primates and
avian under the covarion model, the restriction matrix under
directional and mixed root frequencies, primates under autocorrelated
gamma and (by codon position) lognormal and kmixture rates, cynmix with
symdirihyperpr or the parsimony model on its morphology, simulated
continuous traits, and finch.nex's BEST analysis the same way
(``chip_smoke.py`` drives them on the card).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .mcmc.diagnostics import psrf

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, os.pardir, "tests", "data", "ref", "examples")
PRIMATES = os.path.join(EXAMPLES, "primates.nex")
CYNMIX = os.path.join(EXAMPLES, "cynmix.nex")
AVIAN = os.path.join(EXAMPLES, "avian_ovomucoids.nex")
REPLICASE = os.path.join(EXAMPLES, "replicase.nex")
HYMFOSSIL = os.path.join(EXAMPLES, "hymfossil.nex")
KIM = os.path.join(EXAMPLES, "kim.nex")
FINCH = os.path.join(EXAMPLES, "finch.nex")
RESTRICTION = os.path.join(HERE, os.pardir, "tests", "data", "restriction.nex")

# test1's model commands, after its execute
TEST1_MODEL = ("partition test = 2: 1-400, 401-.",
               "set partition=test",
               "lset applyto=(all) nst=mixed rates=invgamma",
               "unlink statefreq=(all) revmat=(all) pinvar=(all) shape=(all)",
               "prset applyto=(all) ratepr=variable")
# test2's model commands, after its execute (tests/envelope_check.py:41-56)
TEST2_MODEL = ("partition test = 2: 1-400, 401-.",
               "set partition=test",
               "lset applyto=(all) nst=mixed rates=invgamma",
               "unlink statefreq=(all) revmat=(all) pinvar=(all) shape=(all)",
               "prset brlenspr=clock:uniform clockratepr=exp(1) "
               "clockvarpr=igr")
# cynmix's favored partition under the model of the MrBayes manual's
# partitioned tutorial (the commented-out block of cynmix.nex): Mk with
# gamma rates on the morphology, GTR+I+G on each of the four genes, every
# parameter unlinked, variable rate multipliers
CYNMIX_MODEL = ("set partition=favored",
                "lset applyto=(1) rates=gamma",
                "lset applyto=(2,3,4,5) rates=invgamma nst=6",
                "unlink revmat=(all) pinvar=(all) shape=(all) "
                "statefreq=(all)",
                "prset applyto=(all) ratepr=variable")
# the MrBayes manual's protein example (the commented-out block of
# avian_ovomucoids.nex): the chain integrates over the fixed amino-acid
# models
AVIAN_MODEL = ("prset aamodelpr=mixed",)
# replicase.nex under NY98 (the replicase_ny98 rows of
# tests/golden_extra.json)
REPLICASE_NY98_MODEL = ("lset nucmodel=codon omegavar=ny98",)
# ... and under M3 and M10 (the replicase_m10 rows)
REPLICASE_M3_MODEL = ("lset nucmodel=codon omegavar=m3",)
REPLICASE_M10_MODEL = ("lset nucmodel=codon omegavar=m10",)
# kim.nex (Kim, Kjer and Duckett 2003; its own block defines the 110 stem
# pairs and the partitions) under the kim_stems_doublet_gtr rows' model:
# the 18S stems as GTR doublets, the loops, EF1a and CO1 under F81 and the
# proteins under Poisson with equal frequencies, Mk on the morphology
KIM_DOUBLET_MODEL = ("set partition=by_gene_and_struct",
                     "lset applyto=(1) nucmodel=doublet nst=6",
                     "prset applyto=(2,4) statefreqpr=fixed(equal)",
                     "prset applyto=(3,5,6) statefreqpr=fixed(equal)")
# ... and with one tree a locus (molecular against morphological trees)
KIM_UNLINKED_MODEL = ("set partition=by_gene",
                      "unlink topology=(all) brlens=(all)")
# hymfossil.nex's total-evidence dating analysis (Ronquist et al. 2012,
# Syst. Biol. 61:973): seven user partitions (morphology, six genes; the
# third codon positions of CO1 excluded), ordered morphology, 45 fossils
# with fixed ages, the fossilized birth-death prior with random sampling
# (the hymfossil_fbd_totev rows of tests/golden_extra.json)
HYMFOSSIL_MODEL = (
    "charset MV = 1-236",
    "charset MS = 237-353",
    "charset 12S = 354-556",
    "charset 16S = 557-778",
    "charset 18S = 779-1669",
    "charset 28S = 1670-2221",
    "charset CO1 = 2222-3265",
    "charset CO1_12 = 2222-3265\\3 2223-3265\\3",
    "charset CO1_3 = 2224-3265\\3",
    "charset Ef1aF2 = 3266-4357",
    "charset Ef1aF2_12 = 3266-4357\\3 3267-4357\\3",
    "charset Ef1aF2_3 = 3268-4357\\3",
    "charset Ef1aF1 = 4358-5449",
    "charset Ef1aF1_12 = 4358-5449\\3 4359-5449\\3",
    "charset Ef1aF1_3 = 4360-5449\\3",
    "charset morph_ordered = 20 23 27 30 35 36 41 42 44 46 48 59 65 "
    "75 78 79 89 99 112 117 134 146 157 159 171 185 191 192 193 196 "
    "218 228 229 230 237 263 266 288 296 299 304 343 347 349",
    "charset morph_excluded = 96 136 212 216 217 218 219 220",
    "charset morph_constant = 277 331",
    "ctype ordered: morph_ordered",
    "exclude morph_excluded morph_constant",
    "partition without_CO1_3 = 7: MV MS, 12S 16S, 18S, 28S, CO1_12 "
    "CO1_3, Ef1aF1_12 Ef1aF2_12, Ef1aF1_3 Ef1aF2_3",
    "exclude CO1_3",
    "set partition = without_CO1_3",
    "lset applyto=(1) coding=variable rates=gamma",
    "lset applyto=(2,3,4,5,6,7) nst=6 rates=gamma",
    "prset applyto=(4) statefreqpr=fixed(equal)",
    "unlink statefreq=(all) revmat=(all) shape=(all)",
    "prset applyto=(all) ratepr=variable",
    "calibrate Triassoxyela=fixed(235) Asioxyela=fixed(235) "
    "Nigrimonticola=fixed(157) Gigantoxyelinae=fixed(135) "
    "Spathoxyela=fixed(135) Xyela_mesozoica=fixed(135) "
    "Angaridyela=fixed(135) Xyelotoma=fixed(157) Undatoma=fixed(148) "
    "Dahuratoma=fixed(134) Mesolyda=fixed(157) Turgidontes=fixed(134)"
    " Aulidontes=fixed(157) Protosirex=fixed(157) Aulisca=fixed(157) "
    "Anaxyela=fixed(157) Syntexyela=fixed(157) Karatavites=fixed(157)"
    " Stephanogaster=fixed(157) Leptephialtites=fixed(157) "
    "Cleistogaster=fixed(179) Sepulca=fixed(157) Onochoius=fixed(135)"
    " Ghilarella=fixed(119) Paroryssus=fixed(157) "
    "Praeoryssus=fixed(157) Mesorussus=fixed(97) "
    "Trematothorax=fixed(135) Thoracotrema=fixed(119) "
    "Prosyntexis=fixed(83) Kulbastavia=fixed(157) "
    "Brachysyntexis=fixed(157) Symphytopterus=fixed(157) "
    "Eoxyela=fixed(179) Liadoxyela=fixed(179) Abrotoxyela=fixed(164) "
    "Pseudoxyelocerus=fixed(182) Palaeathalia=fixed(135) "
    "Ferganolyda=fixed(179) PamphiliidaeUndesc=fixed(164) "
    "Rudisiricius=fixed(164) Sogutia=fixed(187) Xyelula=fixed(182) "
    "Brigittepterus=fixed(182) Grimmaratavites=fixed(182)",
    "prset brlenspr=clock:fossilization",
    "prset speciationpr=exp(20)",
    "prset extinctionpr=beta(1,1)",
    "prset fossilizationpr=beta(1,1)",
    "prset sampleprob=0.0005",
    "prset nodeagepr=calibrated",
    "prset clockratepr=lognorm(-7.1,0.5)",
)
# primates under HKY+G with the covarion model (the primates_covarion_hky
# rows' model with gamma rates: 8 states, 4 categories), and avian under
# Jones+G with it (40 states)
PRIMATES_COVARION_MODEL = ("lset nst=2 rates=gamma covarion=yes",)
AVIAN_COVARION_MODEL = ("prset aamodelpr=fixed(jones)",
                        "lset rates=gamma covarion=yes")
# the restriction_directional and restriction_mixedfreq rows' models
RESTRICTION_MODEL = ("lset coding=noabsencesites",
                     "prset statefreqpr=dirichlet(1,1)")
# the rest of the other likelihood families: primates under GTR with
# autocorrelated gamma rates, the primates_part2_unlinked_gtr_g rows'
# partition by codon position under lognormal (first and second
# positions) and kmixture (third) rates, cynmix's favored model with a
# sampled symmetric Dirichlet on its morphology's state frequencies or the
# parsimony model on its morphology, and Brownian-motion traits
PRIMATES_ADGAMMA_MODEL = ("lset nst=6 rates=adgamma",)
PRIMATES_LNORM_KMIX_MODEL = (
    "charset first_second = 1-898\\3 2-898\\3",
    "charset third = 3-898\\3",
    "partition bycodon = 2: first_second, third",
    "set partition = bycodon",
    "lset applyto=(1) nst=6 rates=lnorm",
    "lset applyto=(2) nst=6 rates=kmixture nmixtcat=4",
    "unlink statefreq=(all) revmat=(all) shape=(all)",
    "prset applyto=(all) ratepr=variable")
CYNMIX_SYMDIRI_MODEL = CYNMIX_MODEL + (
    "prset applyto=(1) symdirihyperpr=exponential(1.0)",)
CYNMIX_PARSMODEL_MODEL = CYNMIX_MODEL + ("lset applyto=(1) parsmodel=yes",)
# the continuous run's matrix is written from a seed (no data file)
CONTINUOUS_MODEL = ("prset brownscalepr=gamma(1,10)",)
CONTINUOUS_SHAPE = (32, 50)          # taxa x traits
CONTINUOUS_SEED = 1
# the batch runs: name -> (data file, model commands after its execute);
# a data file None is written by ``write_continuous`` beside the batch
BATCHES = {"test1": (PRIMATES, TEST1_MODEL), "test2": (PRIMATES, TEST2_MODEL),
           "cynmix": (CYNMIX, CYNMIX_MODEL),
           "avian": (AVIAN, AVIAN_MODEL),
           "replicase_ny98": (REPLICASE, REPLICASE_NY98_MODEL),
           "replicase_m3": (REPLICASE, REPLICASE_M3_MODEL),
           "replicase_m10": (REPLICASE, REPLICASE_M10_MODEL),
           "hymfossil": (HYMFOSSIL, HYMFOSSIL_MODEL),
           "kim_doublet": (KIM, KIM_DOUBLET_MODEL),
           "kim_unlinked": (KIM, KIM_UNLINKED_MODEL),
           "primates_covarion": (PRIMATES, PRIMATES_COVARION_MODEL),
           "avian_covarion": (AVIAN, AVIAN_COVARION_MODEL),
           "restriction_directional": (RESTRICTION, RESTRICTION_MODEL + (
               "lset statefrmod=directional",)),
           "restriction_mixed": (RESTRICTION, RESTRICTION_MODEL + (
               "lset statefrmod=mixed",)),
           "primates_adgamma": (PRIMATES, PRIMATES_ADGAMMA_MODEL),
           "primates_lnorm_kmix": (PRIMATES, PRIMATES_LNORM_KMIX_MODEL),
           "cynmix_symdiri": (CYNMIX, CYNMIX_SYMDIRI_MODEL),
           "cynmix_parsmodel": (CYNMIX, CYNMIX_PARSMODEL_MODEL),
           "continuous": (None, CONTINUOUS_MODEL),
           # finch.nex's own mrbayes block sets its BEST model (30 loci,
           # popvarpr=variable, popsizepr=gamma(1,100))
           "finch": (FINCH, ())}
BATCH = """#NEXUS
begin mrbayes;
    set autoclose=yes nowarn=yes;
    execute {data};
{model}    mcmc ngen={ngen} nruns={nruns} nchains=4 samplefreq={samplefreq}
         printfreq={printfreq} diagnfreq={diagnfreq} file={prefix};
    sump;
    sumt;
end;
"""


def write_batch(name: str, workdir: str, ngen: int = 20000,
                samplefreq: int = 100, diagnfreq: int = 2000,
                nruns: int = 2) -> str:
    """Write the batch file of run ``name`` (a key of ``BATCHES``: its
    data, its model, an mcmc of ``nruns`` runs x 4 chains, sump and sumt)
    into ``workdir``; returns its path."""
    data, model = BATCHES[name]
    os.makedirs(workdir, exist_ok=True)
    if data is None:
        data = write_continuous(os.path.join(workdir, f"{name}_data.nex"))
    path = os.path.join(workdir, f"{name}.nex")
    with open(path, "w") as f:
        f.write(BATCH.format(
            data=os.path.abspath(data),
            model="".join(f"    {c};\n" for c in model), ngen=ngen,
            samplefreq=samplefreq, printfreq=min(2000, diagnfreq),
            diagnfreq=diagnfreq, nruns=nruns,
            prefix=os.path.join(os.path.abspath(workdir), name)))
    return path


def write_continuous(path: str) -> str:
    """Write a continuous matrix of ``CONTINUOUS_SHAPE`` taxa x traits
    simulated under Brownian motion (unit rate) down a random tree drawn
    from ``CONTINUOUS_SEED``; returns its path."""
    from .trees import random_unrooted
    ntax, nchar = CONTINUOUS_SHAPE
    rng = np.random.default_rng(CONTINUOUS_SEED)
    t = random_unrooted(ntax, rng, mean_blen=0.1)
    x = np.zeros((t.n_nodes, nchar))
    todo = [t.root]                          # parents before children
    while todo:
        v = todo.pop()
        if v >= ntax:
            for c in (t.left[v], t.right[v]):
                x[c] = x[v] + rng.normal(0.0, np.sqrt(t.blen[c]), nchar)
                todo.append(c)
    rows = "\n".join(f"  t{i + 1} " + " ".join(f"{v:.6f}" for v in x[i])
                     for i in range(ntax))
    with open(path, "w") as f:
        f.write(f"#NEXUS\nbegin data;\n  dimensions ntax={ntax} "
                f"nchar={nchar};\n  format datatype=continuous;\n"
                f"  matrix\n{rows}\n  ;\nend;\n")
    return path


def run_batch(name: str, workdir: str, ngen: int = 20000, device=None,
              log=print, samplefreq: int = 100, diagnfreq: int = 2000,
              nruns: int = 2, **switches):
    """Run the batch file of ``name`` through
    ``cli.Interpreter.execute_file``, with the kernel-path switches given
    (``multiwalk=``, ``wavefront=``, ``stacked=``).  Returns (interpreter,
    statistics dict, log lines)."""
    from .cli import Interpreter
    lines: list[str] = []

    def keep(msg):
        lines.append(str(msg))
        log(msg)

    it = Interpreter(log=keep, device=device, **switches)
    t0 = time.time()
    it.execute_file(write_batch(name, workdir, ngen, samplefreq, diagnfreq,
                                nruns))
    wall = time.time() - t0
    stats = test1_stats(os.path.join(workdir, name), lines, nruns)
    runner = it._last_runner
    stats.update(wall_s=wall, run_s=runner.wall_seconds,
                 gens_per_s=runner.generations / runner.wall_seconds,
                 ngen=ngen)
    return it, stats, lines


def test1_stats(prefix: str, lines: list[str], nruns: int = 2) -> dict:
    """Best lnL, posterior mean TL (summed over unlinked trees), average
    PSRF (after 25% burn-in; None for one run) from the runs' .p files,
    and the last ASDSF the log printed."""
    best_lnl = -np.inf
    tl_all, runs_cols = [], []
    for r in range(1, nruns + 1):
        with open(f"{prefix}.run{r}.p") as f:
            f.readline()
            header = f.readline().rstrip("\n").split("\t")
            rows = np.array([[float(x) for x in ln.split("\t")]
                             for ln in f if ln.strip()])
        burn = len(rows) // 4
        cols = {h.strip(): rows[:, i] for i, h in enumerate(header)}
        runs_cols.append({h: v[burn:] for h, v in cols.items()})
        best_lnl = max(best_lnl, float(cols["lnLike"].max()))
        tl_all.append(sum(v for h, v in cols.items()
                          if h.startswith("TL"))[burn:])
    vals = []
    for name in runs_cols[0] if nruns > 1 else ():
        if name in ("Gen", "lnLike", "lnPrior") \
                or name.startswith(("gtrsubmodel", "aamodel")):
            continue
        p = psrf(np.stack([rc[name] for rc in runs_cols]))
        if np.isfinite(p) and p <= 10.0:
            vals.append(float(p))
    asdsf = None
    for ln in reversed(lines):
        if "standard deviation of split frequencies" in ln:
            asdsf = float(ln.replace("=", ":").split(":")[-1])
            break
    return {"best_lnl": best_lnl,
            "tl_mean": float(np.mean(np.concatenate(tl_all))),
            "asdsf": asdsf,
            "avg_psrf": float(np.mean(vals)) if vals else None}


def envelope_errors(stats: dict) -> list[str]:
    errors = []
    if not -5715 <= stats["best_lnl"] <= -5700:
        errors.append(f"best lnL {stats['best_lnl']:.2f} outside "
                      f"[-5715, -5700]")
    if not 2.2 <= stats["tl_mean"] <= 4.5:
        errors.append(f"TL mean {stats['tl_mean']:.3f} outside [2.2, 4.5]")
    if stats["asdsf"] is None or stats["asdsf"] >= 0.05:
        errors.append(f"ASDSF {stats['asdsf']} not < 0.05")
    if not 0.95 <= stats["avg_psrf"] <= 1.2:
        errors.append(f"average PSRF {stats['avg_psrf']:.3f} outside "
                      f"[0.95, 1.2]")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mrbayes_tpu_torch.envelope")
    ap.add_argument("--config", choices=("test1", "test2"),
                    default="test1")
    ap.add_argument("--ngen", type=int, default=20000)
    ap.add_argument("--workdir", default=os.path.join("runs", "envelope"))
    ap.add_argument("--device", default=None)
    ap.add_argument("--multiwalk", action="store_true",
                    help="group the divisions into one multiwalk launch")
    args = ap.parse_args(argv)
    _, stats, _ = run_batch(args.config, args.workdir, args.ngen,
                            args.device,
                            multiwalk=True if args.multiwalk else None)
    errors = envelope_errors(stats)
    print("ENVELOPE " + json.dumps({**stats, "errors": errors}), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
