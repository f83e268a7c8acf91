"""Typed analysis settings — the structured equivalent of lset/prset/mcmc
NEXUS commands (reference: src/model.c:3104 DoLset, :4595 DoPrset,
src/mcmc.c:2270 DoMcmc parameter tables).  The NEXUS front end (cli.py)
parses command files into these dataclasses.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Prior:
    kind: str                 # dirichlet|beta|exponential|uniform|gamma|fixed|lognormal|normal
    params: tuple = ()


@dataclass
class DivisionSettings:
    """Per-division model settings (lset + prset)."""
    # lset
    nst: str = "1"                    # "1" | "2" | "6" | "mixed"
    rates: str = "equal"   # equal|gamma|propinv|invgamma|lnorm|adgamma|
                           # kmixture
    ngammacat: int = 4
    nlnormcat: int = 4                # rates=lnorm category count
                                      # (reference Nlnormcat, param 276)
    nmixtcat: int = 4                 # rates=kmixture components
    nbetacat: int = 5                 # symdirihyperpr beta categories
    parsmodel: bool = False           # Tuffley-Steel parsimony model
    nucmodel: str = "4by4"            # 4by4|doublet|codon|protein
    code: str = "universal"
    covarion: bool = False
    pairs: tuple = ()                 # doublet model: ((i,j), ...) 0-based
                                      # absolute columns (reference: pairs
                                      # command, src/command.c:5599)
    coding: str = ""   # ascertainment bias; "" = datatype default,
                       # resolved at Engine build (reference
                       # SetModelDefaults src/model.c:18562-18576:
                       # standard -> variable, restriction ->
                       # noabsencesites, else all)
    # prset
    statefreqpr: Prior = field(default_factory=lambda: Prior("dirichlet", (1.0,)))
    revmatpr: Prior = field(default_factory=lambda: Prior("dirichlet", (1.0,)))
    tratiopr: Prior = field(default_factory=lambda: Prior("beta", (1.0, 1.0)))
    shapepr: Prior = field(default_factory=lambda: Prior("exponential", (1.0,)))
    pinvarpr: Prior = field(default_factory=lambda: Prior("uniform", (0.0, 1.0)))
    adgammacorpr: Prior = field(default_factory=lambda: Prior(
        "uniform", (-1.0, 1.0)))     # adgamma rho (bayes.c:777 "Uniform")
    omegavar: str = "equal"           # codon: equal (M0) | ny98 | m3 | m10
    omegapr: Prior = field(default_factory=lambda: Prior("dirichlet",
                                                         (1.0, 1.0)))
    ny98omega1pr: Prior = field(default_factory=lambda: Prior(
        "beta", (1.0, 1.0)))
    ny98omega3pr: Prior = field(default_factory=lambda: Prior(
        "exponential", (1.0,)))
    codoncatfreqpr: Prior = field(default_factory=lambda: Prior(
        "dirichlet", (1.0, 1.0, 1.0)))
    # M10 codon model (reference defaults src/bayes.c:739-752):
    # omega ~ p0*Beta(a_b,b_b) + p1*(1+Gamma(a_g,b_g)), discretized into
    # nm10betacat + nm10gammacat classes
    nm10betacat: int = 4
    nm10gammacat: int = 4
    m10betapr: Prior = field(default_factory=lambda: Prior(
        "uniform", (0.0, 20.0)))
    m10gammapr: Prior = field(default_factory=lambda: Prior(
        "uniform", (0.0, 20.0)))
    covswitchpr: Prior = field(default_factory=lambda: Prior(
        "uniform", (0.0, 100.0)))     # covarion s01,s10 (bayes.c:784-785)
    aamodel: str = "poisson"          # protein: poisson|jones|dayhoff|mtrev|...
    aamodelpr: Prior = field(default_factory=lambda: Prior("fixed", ()))
    # protein GTR: prior on the 190 sampled exchangeabilities under
    # aamodelpr=fixed(gtr) (reference aaRevMatPr/aaRevMatDir,
    # src/model.c:4992-5160)
    aarevmatpr: Prior = field(default_factory=lambda: Prior(
        "dirichlet", (1.0,)))
    symdirihyperpr: Prior = field(default_factory=lambda: Prior("fixed", (-1.0,)))
    ratepr: str = "fixed"             # fixed | variable
    # non-stationary root frequencies (restriction data only in the
    # reference too: lset statefrmod, src/model.c:3950-3978; root freqs
    # sampled under rootFreqPr, likelihood root-weighted with them,
    # src/likelihood.c:7155-7165)
    statefreqmodel: str = "stationary"   # stationary|directional|mixed
    rootfreqpr: Prior = field(default_factory=lambda: Prior(
        "dirichlet", (1.0, 1.0)))
    # BEST: per-gene rate multipliers (reference generatePr,
    # src/model.c:6675; Move_GeneRate_Dir src/proposal.c:5537)
    generatepr: str = "fixed"         # fixed | variable
    # continuous (Brownian-motion) characters.  NOTE: the reference's own
    # Likelihood_Cont is an empty stub returning lnL=0
    # (src/likelihood.c:7554 "//chi TODO"); here the PIC/REML likelihood
    # is actually computed (ops/brownian.py)
    brownscalepr: Prior = field(default_factory=lambda: Prior(
        "gamma", (1.0, 10.0)))
    browncorrpr: Prior = field(default_factory=lambda: Prior(
        "fixed", (0.0,)))


@dataclass
class TreeSettings:
    """Tree model settings shared across divisions (round 1: one tree)."""
    brlenspr: Prior = field(default_factory=lambda: Prior(
        "gammadir", (1.0, 0.1, 1.0, 1.0)))    # reference default, bayes.c:820
    topologypr: Prior = field(default_factory=lambda: Prior("uniform", ()))
    clock: bool = False
    # clock settings (reference defaults, src/bayes.c:820-905)
    clockpr: str = "uniform"          # uniform|birthdeath|coalescence
    treeagepr: Prior = field(default_factory=lambda: Prior("gamma",
                                                           (1.0, 1.0)))
    clockratepr: Prior = field(default_factory=lambda: Prior("fixed",
                                                             (1.0,)))
    clockvarpr: str = "strict"        # strict|igr|iln|tk02|wn|cpp|mixed
    # CPP relaxed clock (reference defaults src/bayes.c:880-885)
    cppratepr: Prior = field(default_factory=lambda: Prior("exponential",
                                                           (0.1,)))
    cppmultdevpr: Prior = field(default_factory=lambda: Prior("fixed",
                                                              (0.4,)))
    # mixed (IGR<->ILN rjMCMC) variance prior (src/bayes.c:905-909)
    mixedvarpr: Prior = field(default_factory=lambda: Prior("exponential",
                                                            (1.0,)))
    igrvarpr: Prior = field(default_factory=lambda: Prior("exponential",
                                                          (1.0,)))
    ilnvarpr: Prior = field(default_factory=lambda: Prior("exponential",
                                                          (1.0,)))
    tk02varpr: Prior = field(default_factory=lambda: Prior("exponential",
                                                           (1.0,)))
    wnvarpr: Prior = field(default_factory=lambda: Prior("exponential",
                                                         (10.0,)))
    speciationpr: Prior = field(default_factory=lambda: Prior(
        "exponential", (10.0,)))
    extinctionpr: Prior = field(default_factory=lambda: Prior(
        "beta", (1.0, 1.0)))
    popsizepr: Prior = field(default_factory=lambda: Prior("gamma",
                                                           (1.0, 10.0)))
    growthpr: Prior = field(default_factory=lambda: Prior("fixed", (0.0,)))
    sampleprob: float = 1.0
    samplestrat: str = "random"       # random|diversity|fossiltip
    fossilizationpr: Prior = field(default_factory=lambda: Prior(
        "beta", (1.0, 1.0)))          # reference default, src/bayes.c:849-853
    nodeagepr: str = "unconstrained"  # unconstrained|calibrated
    # BEST / multispecies coalescent (reference src/best.c; enabled by
    # prset topologypr=speciestree after a speciespartition command)
    speciestree: bool = False
    ploidy: str = "diploid"           # diploid|haploid|zlinked
    popvarpr: str = "equal"           # equal|variable (theta per population)
    species_partition: list = field(default_factory=list)
    # [(species name, [taxon indices])]
    # tip-date calibrations: taxon index -> Prior; "fixed" pins the age,
    # anything else samples it (reference DoCalibrate, src/command.c:1161)
    tip_calibrations: dict = field(default_factory=dict)
    # topology constraints: list of (name, bool taxon mask); with
    # nodeagepr=calibrated a constraint may carry an age prior on its MRCA
    # (reference DoConstraint src/command.c:2419 + calibrate <node>)
    constraints: list = field(default_factory=list)   # [(name, mask, Prior|None)]
    treeage_calibrated: bool = False  # root calibration supplied via calibrate

    def clockvar_prior(self) -> Prior:
        return {"igr": self.igrvarpr, "iln": self.ilnvarpr,
                "tk02": self.tk02varpr, "wn": self.wnvarpr,
                "mixed": self.mixedvarpr}.get(
                    self.clockvarpr, Prior("fixed", (1.0,)))


@dataclass
class McmcSettings:
    ngen: int = 1_000_000
    nruns: int = 2
    nchains: int = 4
    temp: float = 0.1
    swapfreq: int = 1
    nswaps: int = 1
    samplefreq: int = 500
    printfreq: int = 1000
    diagnfreq: int = 5000
    diagnstat: str = "avgstddev"
    minpartfreq: float = 0.10
    relburnin: bool = True
    burninfrac: float = 0.25
    stoprule: bool = False
    stopval: float = 0.05
    seed: int = 1
    swapseed: int = 2
    filename: str = "out.nex"
    checkfreq: int = 100000
    append: bool = False
    tune: bool = True
    tunefreq: int = 100
    # mcmc data=no: sample from the prior only (reference
    # src/command.c Data parameter; LogLike short-circuits)
    use_data: bool = True
    # per-chain move selection (the reference's PickProposal draws a move
    # independently per chain, src/mcmc.c:10094).  Default False: one
    # shared random move index per generation keeps the lax.switch scalar
    # under vmap so exactly one branch executes (measured A/B in
    # BASELINE.md); the invariant distribution per chain is identical.
    per_chain_moves: bool = False
    # mcmc starttree=random|current|user|parsimony|nj (reference
    # chainParams.startTree, src/command.c:14520; default Current =
    # user trees when defined, else random).  "parsimony" builds
    # random-addition-order greedy Fitch trees, "nj" neighbor joining.
    starttree: str = "current"
    # mcmc nperts=N: N random NNI perturbations applied to every
    # starting tree (reference RandPerturb, src/mcmc.c:2569-2576)
    nperts: int = 0
    # mcmc startparams=reset|current (reference src/command.c:14695);
    # a fresh run always fills default starting values, so both are
    # honored by construction (append=yes restores from the .ckp)
    startparams: str = "current"

    @property
    def n_chains_total(self) -> int:
        return self.nruns * self.nchains
