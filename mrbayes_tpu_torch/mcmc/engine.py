"""The MC3 engine on PyTorch: state assembly, likelihood/prior
composition, and the generation loop with Metropolis-coupled chain swaps.

Counterpart of ``mrbayes_tpu/mcmc/engine.py`` (reference RunChain loop,
src/mcmc.c:15988).  Every chain of every run is one row of a chain-state
dict of ``[C, ...]`` tensors; a generation applies ONE move type, drawn on
the host for the whole block, to all chains at once (the JAX package's
shared move index per generation), recomputes lnL and the prior component
the move can change, and accepts per chain with ``torch.where``.  Heated-
chain swaps permute a temperature-id vector (states never move, as in the
reference's MPI design, src/mcmc.c:826-842).  With
``McmcSettings.per_chain_moves`` each chain draws its own move instead
(``_per_chain_step``: each distinct drawn move proposes once for the
batch and each chain keeps its own move's proposal).

``run_block`` never synchronises with the host: move indices come from a
host generator, every other random number from a device generator, and
acceptance, swaps and autotuning stay tensor math on the device.

The port carries nucleotide data under nst 1/2/6/mixed, RNA stem pairs
under the 16-state doublet model (``nucmodel=doublet`` with ``pairs``),
codon models M0, NY98, M3 and M10 (``nucmodel=codon``,
``omegavar=equal|ny98|m3|m10``), protein data
under the empirical amino-acid models, Poisson, equalin, protein GTR and
``aamodelpr=mixed``, and standard (morphology) data under the plain
unordered Mk model with its ascertainment coding (``coding=variable`` by
default), restriction (binary) data with its coding (``noabsencesites``
by default) and stationary, directional or mixed root frequencies
(``statefreqmodel``: the last two force a rooted non-clock tree), each
with equal, gamma, propinv or invgamma rates (a codon division has none:
its category axis holds the omega classes), nucleotide and protein data
under the Tuffley-Steel covarion model (``covarion=yes``: a doubled state
space, one eigensystem a rate category, no propinv), lognormal
(``rates=lnorm``), sampled k-category mixture (``rates=kmixture``) and
autocorrelated gamma rates (``rates=adgamma``: the category HMM along the
sites, with a sampled correlation), standard data under a symmetric
Dirichlet on its state frequencies (``symdirihyperpr``: beta categories on
the category axis of a binary character, sampled frequencies of a
multistate one), the Tuffley-Steel parsimony model (``parsmodel=yes``)
and continuous characters under Brownian motion (``datatype=continuous``:
the independent-contrasts REML density, a sampled variance rate); any
number of divisions (partitions)
with linked or unlinked parameters and fixed or variable rate
multipliers, one unrooted non-clock tree with the default priors (or one
such tree per link group of ``unlink topology brlens``) or one
clock tree (``mcmc/clock.py``: uniform, birth-death, coalescent or
fossilized birth-death node ages, dated tips and sampled ancestors;
strict, IGR, ILN, WN, TK02, CPP or mixed branch rates; a fixed or sampled
clock rate), hard, negative and partial topology constraints with
calibrated clade ages, ordered and unordered standard characters, and any
number of runs and chains, from random, user (``start_tree``), parsimony
or neighbor-joining starting trees with ``nperts`` random NNIs, with
propset's ``move_overrides``, and the multispecies coalescent (BEST,
``topologypr=speciestree``; ``mcmc/best.py``): one dated clock tree a
division (gene), ``left``, ``right``, ``parent`` and ``age`` [C, G,
n_nodes], inside a species tree ``s_left``, ``s_right``, ``s_parent`` and
``s_age`` [C, 2S-1] with population sizes ``popsize``.  When every gene
has one plain nucleotide model shape, a likelihood is one P(t) assembly
over the [G * C] gene trees and one ``stacked.cu`` launch with a tree a
member (``ops/stacked_cuda.py:PruningCudaGeneStack``, the counterpart of
the JAX engine's vmapped gene pass); otherwise each gene takes its own
``pruning.cu`` launch.  The route is chosen when the engine is built and
recorded in ``notes``.

With one tree the tree fields ``left``, ``right``, ``parent`` and
``blen`` are ``[C, n_nodes]``; with ``n_trees > 1`` (unlinked topologies)
they are ``[C, n_trees, n_nodes]``, each division prunes its own tree
(``div_tree``), a tree move changes one tree a chain drawn on the device,
and no multiwalk or stacked group is formed (as in the JAX package).

A clock state has no ``blen``: its branch lengths are derived from the
ages and rates, and ``branch_lengths`` is the one place the likelihood,
the pruners and the outputs read them from.

Divisions that share the tree can go through one multiwalk kernel launch
(``ops/multiwalk_cuda.py``) instead of one launch each.  The switch keeps
the JAX package's meaning and default: off unless ``Engine(multiwalk=
True)`` or ``MB_TPU_MULTIWALK=1``, read once when the engine is built.
The grouping differs on purpose: the JAX engine buckets divisions by
their pattern count padded to the TPU's 128-lane tile
(mrbayes_tpu/mcmc/engine.py:1025-1041), so test1's two divisions (199 and
258 patterns, padded to 256 and 384) form no group there.  The CUDA
kernel needs no lane padding, so here divisions are grouped by what that
kernel takes: one state count per launch, supported (S, K) pairs, at most
65,535 walks and a bounded scratch buffer.  A division's lnL is the same
function of its partials either way.

Two more kernel paths keep the JAX package's switches and defaults (off),
read once when the engine is built: ``wavefront`` (``MB_TPU_WAVEFRONT``)
gives a division of a tree with at least 24 tips and K·S <= 32 the
level-batched pruner (``ops/wavefront_cuda.py``), and ``stacked``
(``MB_TPU_STACKED``) puts divisions of at most 256 patterns into one
launch of the stacked kernel, one block per (division, chain, pattern
tile) (``ops/stacked_cuda.py``, grouped by ``_build_stacked_pruners``).
The likelihood takes multiwalk groups first, then stacked groups, and
every remaining division through its own pruner.  Only the generic
family groups (``_grouped``, the JAX engine's ``_is_generic_div``): an
adgamma, symdirihyperpr, codon or covarion division keeps its own pruner,
and a parsimony-model or continuous division has none (its likelihood is
a Fitch count or the contrasts' density, never a pruning pass).

Under a ``sites`` mesh (``parallel/mesh.py:shard_engine_data``, the JAX
engine's ``_site_sharded`` routing) each division's pattern data is cut
into one slice per shard and goes through a ``PruningCudaSharded``: one
``pruning.cu`` launch per shard, the root reduction on each shard's
device, the [C] partial sums added on the engine's device.  A coded
division's dummy patterns take a pass of their own inside that pruner,
and the multiwalk and stacked groups are cleared.

Under a ``chains`` mesh over N processes (``parallel/mesh.py:
shard_chains``) this process's engine holds chains ``chain_slice`` of
the flat runs × chains axis: its states, tuning and move counters are
that slice, its multiwalk groups are sized by it, and ``run_block``
reads the heats from that slice of the whole ``temp_id``.  ``bk["rng"]``
is the rank's own generator (``mesh.rank_seed``); the move draws and the
swap draws come from generators seeded alike on every rank and are drawn
whole on every rank, so each chain's move and every swap are the
one-process draws.  A swap needs E of every chain of a run: where this
process holds whole runs it swaps them alone, otherwise E is gathered
from every rank (``mesh.all_gather``, one collective a swap generation)
and every rank computes the same swaps.
"""
from __future__ import annotations

import math
import os
from collections import Counter
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from .. import resolve_device
from ..data import DataSet, Division
from ..models.aa_models import AA_MODELS
from ..models.codes import CodonCode
from ..models.rates import (AdgammaTransition, GammaRateTable,
                            LognormalRates, beta_quantile_breaks)
from ..models.special import beta_category_freqs
from ..models.substitution import (DOUBLET_CLS, binary_q, codon_q,
                                   covarion_q, doublet_q, mk_q, nuc_q_gtr,
                                   nuc_q_nst1, nuc_q_nst2, ordered_mk_q,
                                   protein_q)
from ..nexus.datatypes import DataType
from ..ops.brownian import pic_logpdf
from ..ops.multiwalk_cuda import PruningCudaMultiwalk
from ..ops.pruning import (adgamma_loglik_from_cats, branch_tiprobs,
                           coding_tips, coding_total, constant_state_mask,
                           division_loglik, make_pruner, pinvar_mix,
                           root_clv, site_loglik_from_root)
from ..ops.pruning_cuda import check_kernel_shape
from ..ops.sharded_cuda import PruningCudaSharded
from ..ops.stacked_cuda import PruningCudaGeneStack, PruningCudaStacked
from ..ops.traversal import ancestor_matrix, postorder_internal
from ..ops.tiprobs import eigh_reversible
from ..spans import SPANS
from ..trees import (Tree, neighbor_joining, parsimony_stepwise,
                     pdistance_matrix, perturb_nni, random_clock_tree,
                     random_clock_tree_constrained, random_unrooted,
                     random_unrooted_constrained)
from . import best as B
from . import clock as CL
from . import mixed_gtr as MG
from . import moves as M
from .priors import (beta_lpdf, brlens_exponential_lpdf, brlens_gammadir_lpdf,
                     brlens_uniform_lpdf, dirichlet_lpdf, exponential_lpdf,
                     gamma_lpdf, lognormal_lpdf, normal_lpdf, uniform_lpdf)
from .settings import DivisionSettings, McmcSettings, Prior, TreeSettings

NEG_INF = -1e30
SCORE_KEYS = ("lnL", "lnP", "lnP_tree", "lnP_par")
# cap on one multiwalk launch's scratch (floats) when forming groups
MULTIWALK_SCRATCH_CAP = 1 << 28
# stacked groups: members of at most this many patterns (coding dummies
# counted), union state width K·S at most this (mrbayes_tpu/mcmc/
# engine.py:941-963)
STACK_MAX_PATTERNS = 256
STACK_MAX_WIDTH = 96
# ascertainment coding names of the settings -> division_loglik's
# (reference SetModelDefaults defaults standard data to variable,
# src/model.c:18562-18576)
_CODING = {"all": "all", "variable": "variable",
           "noabsencesites": "noabsence", "nopresencesites": "nopresence"}
# aamodelpr=mixed: the reference's model-index order (src/bayes.c
# modelElementNames), the index the aamodel column prints
AA_MIXED_ORDER = ("poisson", "jones", "dayhoff", "mtrev", "mtmam", "wag",
                  "rtrev", "cprev", "vt", "blosum", "lg")
# state-frequency fields: the Dirichlet-sampled frequencies of nucleotide,
# protein, codon, doublet and restriction divisions
PI_FIELDS = ("pi", "pi20", "pi61", "pi16", "pi2")
# a Q move's name before its last "_" -> the group whose one row a chain
# it draws (the frequency and sympi fields name their own field)
_ROW_GROUPS = {"revmat": "revmat_group", "aarevmat": "aarevmat_group",
               "tratio": "tratio_group", "omega": "omega_group",
               "omega1": "ny98_group", "omega3": "ny98_group",
               "omegaprobs": "ny98_group", "m3omega": "m3_group",
               "m3probs": "m3_group", "m10beta": "m10_group",
               "m10gamma": "m10_group", "m10probs": "m10_group",
               "aamodel": "aamodel_group", "shape": "shape_group",
               "covswitch": "covswitch_group", "symbeta": "symbeta_group"}
# the tree fields a non-clock tree move changes; [C, n_trees, n_nodes]
# with unlinked trees
TREE_FIELDS = ("left", "right", "parent", "blen")
# a BEST gene tree's fields, [C, G, n_nodes]
GENE_FIELDS = ("left", "right", "parent", "age")


@dataclass
class MoveSpec:
    name: str
    fn: object
    weight: float
    tuning0: float
    target: float = 0.25
    direction: int = 1        # +1: larger tuning bolder; -1: larger = timid
    tmin: float = 1e-3
    tmax: float = 1e3
    tunable: bool = True
    updates_q: bool = False   # move changes a Q matrix -> re-eigendecompose
                              # (reference upDateCijk, src/likelihood.c:7864)
    eig_divs: tuple | None = None   # the divisions whose eigensystems it
                              # changes (None: every division)
    prior_scope: str | None = None  # carried prior component the move can
                              # change: "tree", "params" or "both"; None is
                              # filled by registration position


@dataclass
class DivCfg:
    """Static per-division wiring resolved at build time."""
    div: Division
    settings: DivisionSettings
    pi_group: int = -1          # -1: fixed (not sampled)
    pi_field: str = "pi"        # "pi", "pi20" (protein), "pi61" (codon)
                                # or "pi16" (doublet)
    revmat_group: int = -1
    tratio_group: int = -1
    shape_group: int = -1
    pinvar_group: int = -1
    n_cats: int = 1             # the category axis K: rate categories, or
                                # a codon division's omega classes
    fixed_pi: np.ndarray | None = None
    coding: str = "all"         # resolved ascertainment coding
    codon: CodonCode | None = None   # nucmodel=codon
    codon_site_pattern: np.ndarray | None = None  # codon site -> pattern
    omega_group: int = -1       # omegavar=equal (M0)
    ny98_group: int = -1        # omegavar=ny98
    m3_group: int = -1          # omegavar=m3 (three ordered omegas)
    m10_group: int = -1         # omegavar=m10 (beta + 1+gamma mixture)
    doublet: bool = False       # nucmodel=doublet (16-state stem pairs)
    aamodel_group: int = -1     # aamodelpr=mixed
    aarevmat_group: int = -1    # protein GTR, sampled exchangeabilities
    fixed_aarevmat: np.ndarray | None = None   # aarevmatpr=fixed(...)
    rootpi_group: int = -1      # statefreqmodel=directional|mixed
    fixed_rootpi: np.ndarray | None = None     # rootfreqpr=fixed(...)
    dirpi_mix: bool = False     # statefreqmodel=mixed (the RJ indicator)
    covswitch_group: int = -1   # covarion=yes, sampled switch rates
    fixed_covswitch: np.ndarray | None = None  # covswitchpr=fixed(s01,s10)
    n_rate_cats: int = 1        # the rate categories alone (n_cats folds a
                                # binary symdiri character's beta ones in)
    mixt_group: int = -1        # rates=kmixture, the sampled mixture rates
    ratecorr_group: int = -1    # rates=adgamma, the sampled correlation
    symbeta_group: int = -1     # symdirihyperpr, the sampled beta
    fixed_symbeta: float = -1.0  # symdirihyperpr=fixed(beta), beta > 0
    sympi_field: str = ""       # "sympi<k>": a multistate character's
    sympi_group: int = -1       # sampled frequencies under symdirihyperpr
    parsimony: bool = False     # parsmodel=yes (Tuffley-Steel)
    brownscale_group: int = -1  # continuous data, the variance rate

    @property
    def covarion(self) -> bool:
        return self.covswitch_group >= 0 or self.fixed_covswitch is not None

    @property
    def symdiri(self) -> bool:
        """symdirihyperpr on: beta categories (binary) or sampled
        frequencies (multistate)."""
        return (self.sympi_group >= 0 or self.symbeta_group >= 0
                or self.fixed_symbeta > 0.0)

    @property
    def continuous(self) -> bool:
        return self.div.dtype is DataType.CONTINUOUS

    @property
    def prunes(self) -> bool:
        """False where the likelihood is no pruning pass (parsimony model,
        continuous data): no pruner, eigensystem or group."""
        return not (self.parsimony or self.continuous)

    @property
    def directional(self) -> bool:
        return self.rootpi_group >= 0 or self.fixed_rootpi is not None


def _scalar_prior_lpdf(prior: Prior, x):
    k = prior.kind
    p = prior.params
    if k == "exponential":
        return exponential_lpdf(x, p[0])
    if k == "uniform":
        return uniform_lpdf(x, p[0], p[1])
    if k == "gamma":
        return gamma_lpdf(x, p[0], p[1])
    if k == "lognormal":
        return lognormal_lpdf(x, p[0], p[1])
    if k == "normal":
        return normal_lpdf(x, p[0], p[1])
    if k == "beta":
        return beta_lpdf(x, p[0], p[1])
    if k == "offsetexp":
        # params (offset, mean) — reference
        # LnPriorProbOffsetExponential_Param_Offset_Mean, src/utils.c:12787
        off, mean = p[0], p[1]
        rate = 1.0 / (mean - off)
        return torch.where(x >= off, math.log(rate) - rate * (x - off),
                           NEG_INF)
    if k == "truncatednormal":
        # params (min, mean, sd); unnormalized, as in the reference
        lo, mu, sd = p[0], p[1], p[2]
        return torch.where(x >= lo, normal_lpdf(x, mu, sd), NEG_INF)
    if k == "fixed":
        return torch.zeros_like(x)
    raise ValueError(f"unsupported scalar prior {k}")


def _switch(env: str, value: bool | None) -> bool:
    """A kernel-path switch: ``value``, or the environment when None."""
    return os.environ.get(env, "0") == "1" if value is None else bool(value)


class Engine:
    """Builds and runs one analysis (the analog of SetUpAnalysis + DoMcmc,
    reference src/model.c:21386 / src/mcmc.c:2270).  ``device=None`` means
    CUDA and raises when there is none; tests pass ``device="cpu"``."""

    def __init__(self, dataset: DataSet,
                 div_settings: list[DivisionSettings],
                 tree_settings: TreeSettings | None = None,
                 mcmc: McmcSettings | None = None,
                 links: dict[str, list[int]] | None = None,
                 device=None, multiwalk: bool | None = None,
                 wavefront: bool | None = None, stacked: bool | None = None,
                 move_overrides: dict | None = None,
                 start_tree: Tree | None = None):
        self.device = resolve_device(device)
        # the kernel-path switches are read once, here (the JAX package
        # reads its MB_TPU_* flags at trace time, which made a JAX test
        # depend on test order)
        self.multiwalk = _switch("MB_TPU_MULTIWALK", multiwalk)
        self.wavefront = _switch("MB_TPU_WAVEFRONT", wavefront)
        self.stacked = _switch("MB_TPU_STACKED", stacked)
        # fp32 throughout, no TF32: the JAX package pins matmul precision
        # to HIGHEST (mrbayes_tpu/__init__.py) because reduced-precision
        # passes bias per-pattern lnL by about 1e-2, and TF32 keeps only
        # about three decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.data = dataset
        self.tree_settings = tree_settings or TreeSettings()
        self.mcmc = mcmc or McmcSettings()
        self.n_tips = dataset.ntax
        self.n_nodes = 2 * self.n_tips - 1
        # startvals tau=<tree>: every chain's starting tree
        self.start_tree = start_tree
        # CPP relaxed clock: event slots per branch (the fixed-capacity
        # stand-in for the reference's variable-length event arrays,
        # bayes.h:711-714)
        self.cpp_cap = 8
        if len(div_settings) != len(dataset.divisions):
            raise ValueError("one DivisionSettings per division required")
        # setup messages for the caller to print (the CLI logs them)
        self.notes: list[str] = []
        # the chains this process holds (set_chain_slice); None: all
        self._chain_slice = None
        self._check_slice(div_settings, links)
        self._build_species()
        self._build_dating()
        self._build_groups(div_settings, links)
        self._build_tree_groups(links)
        self._build_data_tensors()
        self._build_moves()
        self._apply_move_overrides(move_overrides or {})
        self._build_constants()
        # refresh plans a set of divisions and eigensystem counts a Q
        # move, built at first use; the device tally of changed
        # eigensystems (``take_eig_tally``)
        self._eig_plans: dict = {}
        self._eig_changes: dict = {}
        self._eig_tally = None

    # ------------------------------------------------------------------
    # static wiring

    def _check_slice(self, div_settings, links):
        """Raise for every setting this slice of the port does not carry."""
        ts = self.tree_settings
        if ts.clock:
            if ts.clockpr not in ("uniform", "birthdeath", "coalescence",
                                  "fossilization"):
                raise ValueError(f"clockpr {ts.clockpr} not supported")
            if ts.clockvarpr not in ("strict", "cpp") + CL.BRATE_CLOCKS:
                raise ValueError(f"clockvarpr {ts.clockvarpr} not supported")
        elif ts.brlenspr.kind not in ("gammadir", "exponential", "uniform"):
            raise ValueError(f"brlenspr {ts.brlenspr.kind} not supported")
        for div, s in zip(self.data.divisions, div_settings):
            if div.dtype is DataType.STANDARD:
                if div.ctype not in ("unordered", "ordered"):
                    # the reference rejects irreversible characters at
                    # model setup (src/model.c:16527-16531)
                    raise ValueError(f"ctype {div.ctype} is not supported")
            elif div.dtype is DataType.PROTEIN:
                if s.aamodelpr.kind not in ("fixed", "mixed"):
                    raise ValueError(f"aamodelpr={s.aamodelpr.kind}: "
                                     f"fixed(<model>) or mixed")
            elif div.dtype in (DataType.RESTRICTION, DataType.CONTINUOUS):
                pass
            elif div.dtype not in (DataType.DNA, DataType.RNA):
                raise ValueError(f"{div.dtype.value} data is not a "
                                 f"division datatype")
            elif s.nucmodel == "codon":
                if s.omegavar not in ("equal", "ny98", "m3", "m10"):
                    raise ValueError(f"omegavar={s.omegavar}")
                if s.nst not in ("1", "2"):
                    raise ValueError(f"nucmodel=codon takes nst=1 or 2, "
                                     f"got nst={s.nst}")
            elif s.nucmodel not in ("4by4", "doublet"):
                raise ValueError(f"nucmodel={s.nucmodel}")
            elif s.nst not in ("1", "2", "6", "mixed"):
                raise ValueError(f"nst={s.nst} is not a nucleotide model")
            if s.rates not in ("equal", "gamma", "propinv", "invgamma",
                               "lnorm", "adgamma", "kmixture"):
                raise ValueError(f"rates={s.rates}")

    def _build_species(self):
        """BEST's static wiring (mrbayes_tpu engine.py:169-181): the
        species names and each tip's species, on the host and the
        device."""
        ts = self.tree_settings
        self.best = bool(ts.speciestree)
        if not self.best:
            return
        if not ts.species_partition:
            raise ValueError("topologypr=speciestree requires a "
                             "speciespartition")
        self.n_species = len(ts.species_partition)
        self.species_names = [nm for nm, _ in ts.species_partition]
        tip_sp = np.full(self.n_tips, -1, np.int64)
        for si, (_, idxs) in enumerate(ts.species_partition):
            tip_sp[list(idxs)] = si
        if (tip_sp < 0).any():
            raise ValueError("speciespartition must cover every taxon")
        self.tip_species_host = tip_sp
        self.tip_species = torch.as_tensor(tip_sp, device=self.device)

    def _build_dating(self):
        """Static dating and constraint wiring (mrbayes_tpu engine.py:234):
        tip calibration ages, the fossil-tip mask and the constraint taxon
        masks (reference calibrate src/command.c:1161, constraint
        src/command.c:2419), with their copies on the device."""
        ts = self.tree_settings
        n = self.n_tips
        dev = self.device
        self.tip_dates = np.zeros(n)
        self.sampled_tip_ages: list[tuple[int, Prior]] = []
        for ti, pr in (ts.tip_calibrations or {}).items():
            if pr.kind == "fixed":
                self.tip_dates[ti] = pr.params[0]
            elif pr.kind == "uniform":
                self.tip_dates[ti] = 0.5 * (pr.params[0] + pr.params[1])
                self.sampled_tip_ages.append((ti, pr))
            elif pr.kind == "offsetexp":
                self.tip_dates[ti] = pr.params[1]   # the mean
                self.sampled_tip_ages.append((ti, pr))
            else:
                raise ValueError(f"tip calibration {pr.kind} unsupported")
        self.fossil_tips = self.tip_dates > 0.0
        self.has_dated_tips = bool(self.fossil_tips.any())
        self._fossil = torch.as_tensor(self.fossil_tips, device=dev)
        # constraints: [M, n_tips] bool + optional age priors on MRCAs.  A
        # constraint covering every taxon is a root calibration: its prior
        # replaces treeagepr (a dated root skips treeAgePr,
        # src/mcmc.c:9476-9484)
        self._root_calib: Prior | None = None
        cons, negs, partials = [], [], []
        for entry in (ts.constraints or []):
            # a 3-tuple is hard; a 5-tuple carries the constraint type
            # (hard|negative|partial) and the partial second taxon set
            # (reference ConstraintType, src/bayes.h:517-521)
            if len(entry) == 3:
                nm, m, p = entry
                ctype, m2 = "hard", None
            else:
                nm, ctype, m, m2, p = entry
            if ctype == "negative":
                negs.append(m)
            elif ctype == "partial":
                partials.append((m, m2))
            elif m.all():
                if p is not None:
                    self._root_calib = p
            else:
                cons.append((nm, m, p))
        self.constraint_masks = (np.stack([m for (_, m, _) in cons])
                                 if cons else None)
        self.constraint_names = [nm for (nm, _, _) in cons]
        self.constraint_priors = [p for (_, _, p) in cons]
        self.negative_masks = np.stack(negs) if negs else None
        self.partial_masks = (
            (np.stack([a for a, _ in partials]),
             np.stack([b for _, b in partials])) if partials else None)

        def on_device(m):
            return None if m is None else torch.as_tensor(
                np.asarray(m, np.float32), device=dev)

        self._cons_dev = on_device(self.constraint_masks)
        self._neg_dev = on_device(self.negative_masks)
        self._partial_dev = (None if self.partial_masks is None else
                             tuple(on_device(m) for m in self.partial_masks))
        if self.sampled_tip_ages:
            tips, los, his = zip(*[
                (t, p.params[0], p.params[1] if p.kind == "uniform"
                 else np.inf) for t, p in self.sampled_tip_ages])
            self._tip_date_bounds = (
                torch.as_tensor(tips, dtype=torch.long, device=dev),
                torch.as_tensor(los, dtype=torch.float32, device=dev),
                torch.as_tensor(np.minimum(his, 1e30), dtype=torch.float32,
                                device=dev))

    def _constraint_terms(self, state):
        """[C]: NEG_INF where a hard, negative or partial constraint is
        broken, plus the calibration densities of the constrained clades'
        MRCA ages on a clock tree (mrbayes_tpu engine.py:290; reference
        DoesTreeSatisfyConstraints src/model.c:12660-12737, the
        calibration priors of LogPrior)."""
        lp = self._zeros(state)
        if self._cons_dev is None and self._neg_dev is None \
                and self._partial_dev is None:
            return lp
        rooted = self.tree_settings.clock
        n = self.n_tips
        tipA = ancestor_matrix(state["parent"])[:, :n]   # [C, n_tips, nodes]
        sizes = tipA.sum(1)[:, None, :]                 # [C, 1, nodes]

        def clade_counts(m):
            # [C, M, nodes] and [1, M, 1]
            return m @ tipA, m.sum(1)[None, :, None]

        def splits(m):
            counts, totals = clade_counts(m)
            is_clade = (counts == totals) & (sizes == totals)
            # unrooted: the complement side is the same split
            comp = (counts == 0.0) & (sizes == n - totals)
            return is_clade, is_clade if rooted else is_clade | comp

        if self._cons_dev is not None:
            is_clade, split = splits(self._cons_dev)
            lp = torch.where(split.any(-1).all(-1), lp, NEG_INF)
            if rooted:
                for c, pr in enumerate(self.constraint_priors):
                    if pr is None or pr.kind == "fixed":
                        continue
                    mrca = is_clade[:, c].long().argmax(-1)
                    lp = lp + _scalar_prior_lpdf(
                        pr, M._take(state["age"], mrca))
        if self._neg_dev is not None:
            # a banned clade rejects the tree wherever it appears
            _, split = splits(self._neg_dev)
            lp = torch.where(split.any(-1).any(-1), NEG_INF, lp)
        if self._partial_dev is not None:
            # partial (backbone) set1:set2: some node holds all of set1 and
            # none of set2 (unrooted: or the mirrored direction)
            c1, t1 = clade_counts(self._partial_dev[0])
            c2, t2 = clade_counts(self._partial_dev[1])
            ok = (c1 == t1) & (c2 == 0.0)
            if not rooted:
                ok = ok | ((c2 == t2) & (c1 == 0.0))
            lp = torch.where(ok.any(-1).all(-1), lp, NEG_INF)
        return lp

    def _build_groups(self, div_settings, links):
        """Assign each sampled parameter of each division to a link group.
        By default divisions with identical settings share a group (the
        reference links parameters when IsModelSame holds,
        src/model.c:13827); ``links[param][d]`` overrides (link/unlink)."""
        self.div_cfg: list[DivCfg] = []
        self._mixed_rev: set[int] = set()
        counters: dict = {}

        def group_of(param, d, signature):
            if links and param in links:
                key = (param, links[param][d])
            else:
                # default linking needs the same datatype class (DNA and
                # RNA are one), and for state-sized parameters the same
                # state count (reference IsModelSame, src/model.c:13827)
                dv = self.data.divisions[d]
                dclass = ("nuc" if dv.dtype in (DataType.DNA, DataType.RNA)
                          else dv.dtype.value)
                dim = (dv.n_states if param in PI_FIELDS
                       or param.startswith("sympi") else 0)
                key = (param, dclass, dim, signature)
            store = counters.setdefault(param, {})
            if key not in store:
                store[key] = len(store)
            return store[key]

        for d, (div, s) in enumerate(zip(self.data.divisions, div_settings)):
            cfg = DivCfg(div=div, settings=s)
            if s.parsmodel:
                # Tuffley-Steel parsimony model: no substitution
                # parameters (reference lset parsmodel=yes, Likelihood_Pars
                # src/likelihood.c:7593; mrbayes_tpu engine.py:421-427)
                cfg.parsimony = True
                cfg.fixed_pi = np.full(div.n_states, 1.0 / div.n_states)
                self.div_cfg.append(cfg)
                continue
            if div.dtype is DataType.CONTINUOUS:
                self.div_cfg.append(self._continuous_cfg(cfg, d, group_of))
                continue
            fixed_params = (s.statefreqpr.kind == "fixed"
                            and s.statefreqpr.params)
            nuc = div.dtype in (DataType.DNA, DataType.RNA)
            prot = div.dtype is DataType.PROTEIN
            if nuc and s.nucmodel == "codon":
                self.div_cfg.append(self._codon_cfg(cfg, d, group_of))
                continue
            if nuc and s.nucmodel == "doublet":
                self.div_cfg.append(self._doublet_cfg(cfg, d, group_of))
                continue
            if prot:
                cfg.pi_field = "pi20"
            if s.statefreqmodel != "stationary" \
                    and div.dtype is not DataType.RESTRICTION:
                # the reference: "non-stationary models only implemented
                # for data type RESTRICTION" (src/model.c:3973-3977)
                raise ValueError(
                    "statefreqmodel=directional|mixed is only available "
                    "for restriction data (reference parity)")
            if div.dtype is DataType.RESTRICTION:
                self._restriction_cfg(cfg, d, group_of)
            elif div.dtype is DataType.STANDARD:
                # plain Mk: equal, fixed state frequencies and the
                # ascertainment coding (variable unless set)
                cfg.fixed_pi = np.full(div.n_states, 1.0 / div.n_states)
                cfg.coding = _CODING.get(s.coding or "variable", "all")
            elif prot and s.aamodelpr.kind == "mixed":
                # rjMCMC over the 10 empirical models and Poisson, each
                # with its own frequencies (reference Move_Aamodel,
                # src/proposal.c:66)
                cfg.aamodel_group = group_of("aamodel", d, "mixed")
            elif prot and s.aamodel not in ("poisson", "equalin", "gtr") \
                    and s.aamodel not in AA_MODELS:
                raise ValueError(
                    f"unsupported amino-acid model {s.aamodel!r}; valid: "
                    f"{', '.join(sorted(AA_MODELS))}, equalin, gtr")
            elif prot and s.aamodel not in ("poisson", "equalin", "gtr"):
                # an empirical model's frequencies are part of it and never
                # sampled (reference: no pi columns in .p)
                cfg.fixed_pi = AA_MODELS[s.aamodel][1]
            elif s.statefreqpr.kind == "dirichlet":
                cfg.pi_group = group_of(cfg.pi_field, d, repr(s.statefreqpr))
            elif fixed_params and s.statefreqpr.params[0] == "empirical":
                cfg.fixed_pi = self._empirical_freqs(div)
            elif fixed_params and not isinstance(s.statefreqpr.params[0],
                                                 str):
                cfg.fixed_pi = np.asarray(s.statefreqpr.params)
            else:
                cfg.fixed_pi = np.full(div.n_states, 1.0 / div.n_states)
            if prot and s.aamodelpr.kind != "mixed" and s.aamodel == "gtr":
                # protein GTR: 190 sampled (or fixed) exchangeabilities
                # under aarevmatpr (reference REVMAT_DIR with nValues=190,
                # src/model.c:19240,19262; prior src/model.c:4992)
                if s.aarevmatpr.kind == "fixed":
                    p = np.asarray([float(x) for x in s.aarevmatpr.params],
                                   np.float64)
                    cfg.fixed_aarevmat = (np.full(190, p[0]) if p.size == 1
                                          else p)
                    if cfg.fixed_aarevmat.size != 190:
                        raise ValueError(
                            "aarevmatpr=fixed needs 1 or 190 values")
                else:
                    cfg.aarevmat_group = group_of("aarevmat", d,
                                                  repr(s.aarevmatpr))
            if nuc and s.nst in ("6", "mixed"):
                cfg.revmat_group = group_of("revmat", d,
                                            repr(s.revmatpr) + s.nst)
                if s.nst == "mixed":
                    self._mixed_rev.add(cfg.revmat_group)
            if nuc and s.nst == "2":
                cfg.tratio_group = group_of("tratio", d, repr(s.tratiopr))
            if s.rates in ("gamma", "invgamma", "lnorm", "adgamma"):
                # lnorm's sigma is the shape parameter's group too
                cfg.shape_group = group_of("shape", d, repr(s.shapepr))
                cfg.n_cats = (s.nlnormcat if s.rates == "lnorm"
                              else s.ngammacat)
            if s.rates in ("propinv", "invgamma"):
                cfg.pinvar_group = group_of("pinvar", d, repr(s.pinvarpr))
            if s.rates == "adgamma":
                # autocorrelated gamma: the category HMM along the sites
                # with a sampled correlation (reference rates=adgamma,
                # ratecorrpr; mrbayes_tpu engine.py:583-591)
                if s.covarion:
                    raise ValueError("adgamma+covarion not supported")
                cfg.ratecorr_group = group_of("ratecorr", d,
                                              repr(s.adgammacorpr))
            if s.rates == "kmixture":
                # the sampled k-component site-rate mixture, kept as a
                # simplex times k (reference P_MIXTURE_RATES,
                # src/model.c:19813; mrbayes_tpu engine.py:592-601)
                cfg.mixt_group = group_of("mixtrates", d,
                                          repr(("kmix", s.nmixtcat)))
                cfg.n_cats = s.nmixtcat
            cfg.n_rate_cats = cfg.n_cats
            if div.dtype is DataType.STANDARD:
                self._symdiri_cfg(cfg, d, group_of)
            if s.covarion and (prot or (nuc and s.nucmodel == "4by4")):
                # Tuffley-Steel covarion: the doubled state space with
                # sampled (or fixed) switching rates (reference lset
                # covarion=yes, prset covswitchpr, src/likelihood.c:8269)
                if s.rates in ("propinv", "invgamma"):
                    raise ValueError(
                        "covarion cannot combine with propinv/invgamma "
                        "(the reference forbids pinvar under covarion)")
                if s.covswitchpr.kind == "fixed":
                    cfg.fixed_covswitch = np.asarray(
                        s.covswitchpr.params or (1.0, 1.0), np.float64)
                else:
                    cfg.covswitch_group = group_of(
                        "covswitch", d, repr(s.covswitchpr))
                if cfg.shape_group < 0:
                    # the covarion path takes gamma or lognormal categories
                    # only (a kmixture group is sampled but unread, as in
                    # mrbayes_tpu engine.py:1162-1163, :2690-2697)
                    cfg.n_cats = cfg.n_rate_cats = 1
            self.div_cfg.append(cfg)
        self.n_groups = {p: len(v) for p, v in counters.items()}
        self.n_div = len(div_settings)
        # directional root frequencies force a rooted non-clock tree
        # (TOPOLOGY_RNCL_*, src/model.c:20126; mrbayes_tpu engine.py:649)
        self.rooted_nonclock = any(c.directional for c in self.div_cfg)
        # per-division rate multipliers (reference ratepr=variable); BEST's
        # generatepr=variable gives each gene one through the same
        # machinery, printed as g_m{i} (mrbayes_tpu engine.py:654-662;
        # reference Move_GeneRate_Dir, src/proposal.c:5537)
        self.generate_on = self.best and any(s.generatepr == "variable"
                                             for s in div_settings)
        self.ratemult_on = (any(s.ratepr == "variable" for s in div_settings)
                            or self.generate_on)
        # priors per group: use the first division that defined the group
        self.group_priors: dict[tuple, Prior] = {}
        for cfg in self.div_cfg:
            s = cfg.settings
            for param, gid, pr in [(cfg.pi_field, cfg.pi_group,
                                    s.statefreqpr),
                                   ("revmat", cfg.revmat_group, s.revmatpr),
                                   ("aarevmat", cfg.aarevmat_group,
                                    s.aarevmatpr),
                                   ("tratio", cfg.tratio_group, s.tratiopr),
                                   ("shape", cfg.shape_group, s.shapepr),
                                   ("pinvar", cfg.pinvar_group, s.pinvarpr),
                                   ("omega", cfg.omega_group, s.omegapr),
                                   ("omega1", cfg.ny98_group,
                                    s.ny98omega1pr),
                                   ("omega3", cfg.ny98_group,
                                    s.ny98omega3pr),
                                   ("omegaprobs", cfg.ny98_group,
                                    s.codoncatfreqpr),
                                   # M3's omegas take the order-statistic
                                   # prior (mrbayes_tpu engine.py:704-708)
                                   ("m3omega", cfg.m3_group,
                                    Prior("m3orderstat", ())),
                                   ("m3probs", cfg.m3_group,
                                    s.codoncatfreqpr),
                                   ("m10beta", cfg.m10_group, s.m10betapr),
                                   ("m10gamma", cfg.m10_group, s.m10gammapr),
                                   ("m10catprobs", cfg.m10_group,
                                    Prior("dirichlet", (1.0, 1.0))),
                                   ("covswitch", cfg.covswitch_group,
                                    s.covswitchpr),
                                   ("ratecorr", cfg.ratecorr_group,
                                    s.adgammacorpr),
                                   ("mixtrates", cfg.mixt_group,
                                    Prior("dirichlet", (1.0,))),
                                   ("symbeta", cfg.symbeta_group,
                                    s.symdirihyperpr),
                                   ("brownscale", cfg.brownscale_group,
                                    s.brownscalepr)]:
                if gid >= 0:
                    self.group_priors.setdefault((param, gid), pr)

    def _continuous_cfg(self, cfg, d, group_of):
        """A continuous division's wiring (mrbayes_tpu engine.py:431-440):
        Brownian-motion characters with one sampled variance rate sigma^2
        a link group (reference brownscalepr, src/command.c:14605), the
        characters independent (browncorrpr fixed(0), the only value
        carried)."""
        s = cfg.settings
        cfg.brownscale_group = group_of("brownscale", d, repr(s.brownscalepr))
        bc = s.browncorrpr
        if bc.kind != "fixed" or (bc.params and float(bc.params[0]) != 0.0):
            raise ValueError("browncorrpr: only fixed(0) (independent "
                             "characters) is supported")
        return cfg

    def _symdiri_cfg(self, cfg, d, group_of):
        """symdirihyperpr on a standard division (mrbayes_tpu
        engine.py:603-629; reference symPiPr, src/model.c:6911): fixed(b)
        with b > 0 or a prior on b turns it on, except on ordered
        characters, which keep uniform frequencies.  A binary character
        integrates over ``nbetacat`` beta categories folded into the
        category axis (K = rate categories x nbetacat, reference
        BetaBreaks, src/model.c:12290); a multistate one samples its
        frequencies ``sympi<k>`` under a symmetric Dirichlet(b)."""
        s = cfg.settings
        sp = s.symdirihyperpr
        fixed_b = (float(sp.params[0]) if sp.kind == "fixed" and sp.params
                   else -1.0)
        if not (sp.kind != "fixed" or fixed_b > 0.0) \
                or cfg.div.ctype == "ordered":
            return
        if sp.kind != "fixed":
            cfg.symbeta_group = group_of("symbeta", d, repr(sp))
        else:
            cfg.fixed_symbeta = fixed_b
        k = cfg.div.n_states
        if k == 2:
            cfg.n_cats = cfg.n_rate_cats * s.nbetacat
        else:
            cfg.sympi_field = f"sympi{k}"
            cfg.sympi_group = group_of(cfg.sympi_field, d, repr(sp) + str(k))

    def _restriction_cfg(self, cfg, d, group_of):
        """A restriction division's wiring (mrbayes_tpu/mcmc/engine.py:
        501-527): the two state frequencies ``pi2`` (sampled under a
        Dirichlet statefreqpr, else fixed at 1/2), the ascertainment coding
        (noabsencesites unless set, reference SetModelDefaults,
        src/model.c:18562-18576), and under statefreqmodel=directional or
        mixed the root frequencies ``rootpi2`` (DIRPI paramIds,
        src/model.c:11756-11817), whose model needs a rooted non-clock
        tree."""
        s = cfg.settings
        cfg.pi_field = "pi2"
        cfg.coding = _CODING.get(s.coding or "noabsencesites", "all")
        if s.statefreqpr.kind == "dirichlet":
            cfg.pi_group = group_of("pi2", d, repr(s.statefreqpr))
        else:
            cfg.fixed_pi = np.full(2, 0.5)
        if s.statefreqmodel == "stationary":
            return
        if self.tree_settings.clock:
            raise ValueError("statefreqmodel=directional is a rooted "
                             "NON-clock model; unset brlenspr=clock")
        cfg.dirpi_mix = s.statefreqmodel == "mixed"
        if s.rootfreqpr.kind == "fixed":
            if cfg.dirpi_mix:
                raise ValueError("statefreqmodel=mixed needs a sampled "
                                 "rootfreqpr (dirichlet)")
            cfg.fixed_rootpi = np.asarray(s.rootfreqpr.params, np.float64)
        else:
            cfg.rootpi_group = group_of("rootpi2", d, repr(s.rootfreqpr))

    def _build_tree_groups(self, links):
        """``unlink topology brlens`` gives each link group its own tree
        (mrbayes_tpu engine.py:356-385; reference SetModelParams, one tree
        parameter per unlinked group, src/model.c:19026): the tree groups
        are the refinement of the two link vectors.  With one group the
        state keeps the flat [C, n_nodes] layout.  BEST's gene trees are
        its own fields: ``unlink topology`` is implied there (finch.nex
        states it) and forms no groups (mrbayes_tpu engine.py:366)."""
        self.n_trees = 1
        self.div_tree = [0] * self.n_div
        if self.best:
            return
        tlink = (links or {}).get("topology")
        blink = (links or {}).get("brlens")
        if tlink is None and blink is None:
            return
        store: dict = {}
        for d in range(self.n_div):
            key = (tlink[d] if tlink else 0, blink[d] if blink else 0)
            self.div_tree[d] = store.setdefault(key, len(store))
        self.n_trees = len(store)
        if self.n_trees > 1 and self.tree_settings.clock:
            raise NotImplementedError(
                "unlinked topologies are supported for non-clock trees "
                "(clock analyses share one dated tree; use BEST/"
                "speciestree for multi-gene clock models)")

    def _codon_cfg(self, cfg, d, group_of):
        """A codon division's wiring (mrbayes_tpu/mcmc/engine.py:446-470):
        the 61 (or the code's) sense codons, their frequencies, omega (M0),
        the NY98 or M3 classes or M10's B + G classes, and kappa under
        nst=2.  Its category axis K holds the omega classes."""
        s = cfg.settings
        cfg.codon = CodonCode(s.code)
        cfg.pi_field = "pi61"
        if s.statefreqpr.kind == "dirichlet":
            cfg.pi_group = group_of("pi61", d, repr(s.statefreqpr))
        else:
            cfg.fixed_pi = np.full(cfg.codon.n_states,
                                   1.0 / cfg.codon.n_states)
        if s.omegavar == "ny98":
            cfg.ny98_group = group_of("ny98", d, "ny98")
            cfg.n_cats = 3
        elif s.omegavar == "m3":
            cfg.m3_group = group_of("m3", d, "m3")
            cfg.n_cats = 3
        elif s.omegavar == "m10":
            # omega ~ p0 Beta(ab, bb) + p1 (1 + Gamma(ag, bg)), discretized
            # into B + G classes (reference OMEGA_10* ids, src/model.c:19371)
            cfg.m10_group = group_of(
                "m10", d, repr((s.nm10betacat, s.nm10gammacat)))
            cfg.n_cats = s.nm10betacat + s.nm10gammacat
        else:
            cfg.omega_group = group_of("omega", d, repr(s.omegapr))
        if s.nst == "2":
            cfg.tratio_group = group_of("tratio", d, repr(s.tratiopr))
        return cfg

    def _doublet_cfg(self, cfg, d, group_of):
        """A doublet division's wiring (mrbayes_tpu/mcmc/engine.py:472-
        491): 16 pair states with their frequencies (``pi16``), GTR, HKY or
        F81 exchangeabilities shared with the nucleotide groups, and the
        rate categories."""
        s = cfg.settings
        cfg.doublet = True
        cfg.pi_field = "pi16"
        if s.statefreqpr.kind == "dirichlet":
            cfg.pi_group = group_of("pi16", d, repr(s.statefreqpr))
        else:
            cfg.fixed_pi = np.full(16, 1.0 / 16)
        if s.nst in ("6", "mixed"):
            cfg.revmat_group = group_of("revmat", d, repr(s.revmatpr) + s.nst)
        elif s.nst == "2":
            cfg.tratio_group = group_of("tratio", d, repr(s.tratiopr))
        if s.rates in ("gamma", "invgamma", "lnorm"):
            # a doublet division's lognormal categories number ngammacat
            # (mrbayes_tpu engine.py:486-488)
            cfg.shape_group = group_of("shape", d, repr(s.shapepr))
            cfg.n_cats = cfg.n_rate_cats = s.ngammacat
        if s.rates in ("propinv", "invgamma"):
            cfg.pinvar_group = group_of("pinvar", d, repr(s.pinvarpr))
        return cfg

    def _empirical_freqs(self, div) -> np.ndarray:
        """Observed state frequencies (ambiguity split uniformly)."""
        bits = (div.patterns[..., None] >> np.arange(div.n_states)) & 1
        w = bits / np.maximum(bits.sum(-1, keepdims=True), 1)
        freq = (w * div.weights[None, :, None]).sum((0, 1))
        return freq / freq.sum()

    def _build_data_tensors(self):
        dev = self.device
        self._gamma_tables, self._lnorm_tables, self._adg_trans = {}, {}, {}
        self._adg_maps, self._cont_values = {}, {}
        for i, cfg in enumerate(self.div_cfg):
            # M10's gamma classes read the table of their own count
            k = (cfg.settings.nm10gammacat if cfg.m10_group >= 0
                 else cfg.n_rate_cats if cfg.shape_group >= 0 else None)
            tables, make = (
                (self._lnorm_tables, LognormalRates)
                if cfg.settings.rates == "lnorm" and cfg.m10_group < 0
                else (self._gamma_tables, GammaRateTable))
            if k is not None and k not in tables:
                tables[k] = make(k, device=dev)
            if cfg.ratecorr_group >= 0:
                if k not in self._adg_trans:
                    self._adg_trans[k] = AdgammaTransition(k, device=dev)
                self._adg_maps[i] = self._adgamma_maps(cfg.div)
        self.tip_partials, self.weights, self.const_masks = [], [], []
        self._fixed_pi, self._fixed_rootpi, self._fixed_covswitch = [], [], []
        self._pruners: list = []
        # each division's tip partials under its model [n, P, S]: codon
        # divisions' over codon sites and sense codons
        self._model_tips: list[np.ndarray] = []
        masks, factors = [], []
        v_typ = 0.03    # reference default tuningParam[2] (model.c:22598)
        for i, cfg in enumerate(self.div_cfg):
            d = cfg.div
            if cfg.continuous:
                # no tip partials, pruner or coding (mrbayes_tpu
                # engine.py:838-845): the trait values, and placeholders
                self._cont_values[i] = torch.as_tensor(
                    np.asarray(d.cont, np.float32), device=dev)
                tp = np.zeros((d.ntax, 1, 1), np.float32)
                cmask = np.zeros((1, 1), np.float32)
                wts = np.ones(1, np.float32)
            elif cfg.codon is not None:
                tp, wts = self._codon_tensors(cfg)
                # no pinvar on a codon division: the mask is never read
                cmask = np.all(tp > 0, axis=0).astype(np.float32)
            elif cfg.doublet:
                tp, wts, cmask = self._doublet_tensors(cfg)
            else:
                tp = d.tip_partials()
                cmask = constant_state_mask(d.patterns, d.n_states)
                wts = np.asarray(d.weights, np.float32).copy()
                if cfg.covarion:
                    # an observed state is compatible with its on- and its
                    # off-copy (mrbayes_tpu/mcmc/engine.py:861-864)
                    tp = np.concatenate([tp, tp], axis=-1)
            self._model_tips.append(tp)
            if cfg.coding != "all":
                # the reference excludes characters the coding rules out
                # (CheckCharCodingType + AddDummyChars, src/model.c:314-
                # 400); a zero weight excludes the pattern exactly
                # (mrbayes_tpu/mcmc/engine.py:866-884)
                bad = {"variable": cmask.any(axis=1),
                       "noabsence": cmask[:, 0] > 0,
                       "nopresence": cmask[:, 1] > 0}[cfg.coding]
                wts[bad] = 0.0
            self.tip_partials.append(torch.as_tensor(tp, device=dev))
            self.weights.append(torch.as_tensor(wts, device=dev))
            self.const_masks.append(torch.as_tensor(cmask, device=dev))
            self._fixed_pi.append(
                None if cfg.fixed_pi is None else torch.as_tensor(
                    np.asarray(cfg.fixed_pi, np.float32)[None], device=dev))
            self._fixed_rootpi.append(
                None if cfg.fixed_rootpi is None else torch.as_tensor(
                    np.asarray(cfg.fixed_rootpi, np.float32)[None],
                    device=dev))
            self._fixed_covswitch.append(
                None if cfg.fixed_covswitch is None else torch.as_tensor(
                    np.asarray(cfg.fixed_covswitch, np.float32)[None],
                    device=dev))
            self._pruners.append(
                make_pruner(tp, cfg.n_cats, dev, cfg.coding, self.wavefront)
                if cfg.prunes else None)
            # bit-coded state sets for parsimony-guided proposals
            # (reference InitParsSets src/mcmc.c:6834); a continuous
            # division's weigh nothing (mrbayes_tpu engine.py:1191-1194)
            S = max(2, min(d.n_states, 32))
            divf = 0.0 if cfg.continuous else -np.log(max(
                1e-10, 1.0 / S - np.exp(-S / (S - 1.0) * v_typ) / S))
            masks.append(d.patterns.astype(np.int64))
            factors.append(d.weights * divf)
        self._pars_per_div = list(zip(masks, factors))
        self._build_pars_lnl()
        self._pars_masks, self._pars_factors = self._pars_tensors(
            range(self.n_div))
        w = np.array([float(c.div.weights.sum()) for c in self.div_cfg])
        self.div_char_frac = w / w.sum()   # ratemult weighting
        self._build_multiwalk_pruners()
        self._build_stacked_pruners()
        self._build_gene_stack()

    def _build_gene_stack(self):
        """BEST's likelihood route (mrbayes_tpu engine.py:1055-1091): when
        every gene runs one plain nucleotide model shape (JAX's condition),
        one ``PruningCudaGeneStack`` over the genes' tips, with each gene's
        weights (and constant-pattern masks under pinvar) padded to the
        longest gene with weight 0; otherwise each gene through its own
        pruner.  Chosen here, from the static shapes, and noted."""
        self._gene_stack = None
        if not self.best:
            return
        c0 = self.div_cfg[0]
        same = self.n_div >= 2 and all(
            c.div.dtype in (DataType.DNA, DataType.RNA)
            and c.codon is None and not c.doublet and not c.parsimony
            and not c.covarion and c.ratecorr_group < 0
            and c.mixt_group < 0 and c.coding == "all"
            and c.div.n_states == c0.div.n_states
            and c.n_cats == c0.n_cats
            and c.settings.rates == c0.settings.rates
            and (c.pinvar_group >= 0) == (c0.pinvar_group >= 0)
            for c in self.div_cfg)
        if not same:
            self.notes.append(f"BEST likelihood: {self.n_div} gene(s), one "
                              f"pruning.cu launch a gene (their model "
                              f"shapes differ)")
            return
        G = self.n_div
        tips = [self._model_tips[i] for i in range(G)]
        self._gene_stack = PruningCudaGeneStack(tips, c0.n_cats, self.device)
        Pm = self._gene_stack.P_max

        def pad(x):
            x = np.asarray(x, np.float32)
            return np.pad(x, [(0, Pm - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

        dev = self.device
        self._gene_wpad = torch.as_tensor(np.stack(
            [pad(self.weights[i].cpu()) for i in range(G)]), device=dev)
        self._gene_cmask = (torch.as_tensor(np.stack(
            [pad(self.const_masks[i].cpu()) for i in range(G)]), device=dev)
            if c0.pinvar_group >= 0 else None)
        self._gene_frac = torch.as_tensor(
            self.div_char_frac.astype(np.float32), device=dev)
        self.notes.append(f"BEST likelihood: {G} gene trees in one "
                          f"stacked.cu launch a likelihood (patterns "
                          f"{sum(self._gene_stack.layout.ps)}, K "
                          f"{c0.n_cats}, S {c0.div.n_states})")

    def _adgamma_maps(self, div):
        """The adgamma HMM's static site-order maps (mrbayes_tpu
        engine.py:821-833): each site's pattern in site order ``poc`` [n]
        and the index ``jump_idx`` [n] of the distance from the previous
        site among the distinct distances ``jumps`` (entry 0 unused), on
        the device."""
        order = np.argsort(div.char_ids)
        poc = div.pattern_of_char[order]
        gaps = np.diff(np.asarray(div.char_ids)[order])
        jumps = sorted({int(j) for j in gaps}) or [1]
        lut = {j: k for k, j in enumerate(jumps)}
        jump_idx = np.zeros(len(poc), np.int64)
        jump_idx[1:] = [lut[int(j)] for j in gaps]
        return (torch.as_tensor(poc, dtype=torch.long, device=self.device),
                torch.as_tensor(jump_idx, device=self.device), tuple(jumps))

    def _build_pars_lnl(self):
        """The parsimony-model divisions' Fitch wiring: per tree, their
        bit-coded state sets side by side [n_tips, P] on the device, and
        each one's (division, pattern slice, weights, character count,
        log of its state count)."""
        self._pars_lnl = []
        for t in range(self.n_trees):
            divs = [i for i, c in enumerate(self.div_cfg)
                    if c.parsimony and self.div_tree[i] == t]
            if not divs:
                continue
            members, lo = [], 0
            for i in divs:
                d = self.div_cfg[i].div
                w = torch.as_tensor(np.asarray(d.weights, np.float32),
                                    device=self.device)
                members.append((i, lo, lo + d.npat, w, float(d.weights.sum()),
                                math.log(max(2, d.n_states))))
                lo += d.npat
            masks = torch.as_tensor(np.concatenate(
                [self._pars_per_div[i][0] for i in divs], axis=1),
                device=self.device)
            self._pars_lnl.append((t, masks, members))

    def _pars_tensors(self, divs):
        """The parsimony proposals' bit-coded state sets and pattern
        factors over divisions ``divs``, on the device."""
        masks, factors = zip(*[self._pars_per_div[i] for i in divs])
        return (torch.as_tensor(np.concatenate(masks, axis=1),
                                device=self.device),
                torch.as_tensor(np.concatenate(factors).astype(np.float32),
                                device=self.device))

    def _doublet_tensors(self, cfg: DivCfg):
        """A nucleotide division recoded as 16-state doublet patterns from
        the ``pairs`` statement (mrbayes_tpu/mcmc/engine.py:773-808;
        reference CompressData's two-characters-a-column compression,
        src/model.c:2466, pairs src/command.c:5599): tip partials
        [n, P, 16] (first position major), one pattern per distinct pair in
        the order ``np.unique`` gives their keys, their counts, and the
        constant-state mask [P, 16].  Every character of the division must
        be in one pair."""
        d = cfg.div
        pairs = cfg.settings.pairs
        if not pairs:
            raise ValueError("nucmodel=doublet requires a pairs statement")
        local = {int(c): k for k, c in enumerate(d.char_ids)}
        pl = [(local[a], local[b]) for (a, b) in pairs
              if a in local and b in local]
        if len({x for ab in pl for x in ab}) != len(d.char_ids):
            raise ValueError(
                "doublet model: every character of the division must "
                "belong to exactly one pair")
        cols = d.patterns[:, d.pattern_of_char]          # [ntax, nchar]
        bits = ((cols[..., None] >> np.arange(4)) & 1).astype(bool)
        first = bits[:, [a for a, _ in pl]]
        second = bits[:, [b for _, b in pl]]
        compat = (first[..., :, None] & second[..., None, :]).reshape(
            cols.shape[0], len(pl), 16)                  # [ntax, sites, 16]
        key = np.ascontiguousarray(
            np.packbits(compat, axis=-1).transpose(1, 0, 2).reshape(
                len(pl), -1))
        _, first_site, counts = np.unique(key, axis=0, return_index=True,
                                          return_counts=True)
        tp = compat[:, first_site, :].astype(np.float32)
        cmask = np.all(tp > 0, axis=0).astype(np.float32)
        return tp, counts.astype(np.float32), cmask

    def _codon_tensors(self, cfg: DivCfg):
        """A nucleotide division recoded as codon-site patterns
        (mrbayes_tpu/mcmc/engine.py:733-771; reference CompressData's
        three-characters-a-column compression, src/model.c:2466): tip
        partials [n, P, n_sense], one pattern per distinct codon site in
        the order ``np.unique`` gives their keys (the JAX package's
        order), and their counts."""
        d = cfg.div
        code = cfg.codon
        cols = d.patterns[:, d.pattern_of_char]      # [ntax, nchar] masks
        nchar = cols.shape[1]
        if nchar % 3:
            raise ValueError(
                f"codon model needs a multiple of 3 sites, got {nchar}")
        trip = cols.reshape(cols.shape[0], nchar // 3, 3)
        b = code.bases                               # [S, 3]
        compat = np.ones((cols.shape[0], nchar // 3, code.n_states), bool)
        for pos in range(3):
            compat &= ((trip[:, :, pos:pos + 1]
                        >> b[None, None, :, pos]) & 1).astype(bool)
        if np.any(~compat.any(-1)):
            raise ValueError("stop codon observed in data (check code= "
                             "and reading frame)")
        packed = np.packbits(compat, axis=-1)        # [ntax, sites, bytes]
        key = np.ascontiguousarray(
            packed.transpose(1, 0, 2).reshape(packed.shape[1], -1))
        _, first, inverse, counts = np.unique(
            key, axis=0, return_index=True, return_inverse=True,
            return_counts=True)
        # each codon site's pattern, for posterior reporting (report
        # possel/siteomega/ancstates columns are per codon site)
        cfg.codon_site_pattern = inverse.reshape(-1).astype(np.int64)
        return (compat[:, first, :].astype(np.float32),
                counts.astype(np.float32))

    def _coded_tips(self, i) -> np.ndarray:
        """Division i's tip partials [n, P_d, S] with its coding dummies:
        the operand every pruner of the division is built from."""
        return coding_tips(self._model_tips[i], self.div_cfg[i].coding)

    def _grouped(self, i) -> bool:
        """True where division i may join a multiwalk or stacked group: the
        JAX engine groups only its generic-path divisions
        (``_is_generic_div``, mrbayes_tpu/mcmc/engine.py:2476-2486), which
        excludes continuous, parsimony-model, symdirihyperpr, codon,
        covarion and adgamma ones; lnorm and kmixture divisions are
        generic."""
        cfg = self.div_cfg[i]
        return (cfg.prunes and not cfg.symdiri and cfg.codon is None
                and not cfg.covarion and cfg.ratecorr_group < 0)

    def _ungrouped_trees(self, switch: str) -> bool:
        """True with unlinked trees: no multiwalk or stacked group is
        formed (the JAX package's rule, engine.py:946-948, :1023), every
        division takes its own ``pruning.cu`` launch on its own tree, and
        ``notes`` says so for a switch that was asked for."""
        if self.best:
            self.notes.append(f"{switch} path off: BEST gene trees (see "
                              f"the BEST likelihood route)")
            return True
        if self.n_trees == 1:
            return False
        self.notes.append(f"{switch} path off: {self.n_trees} unlinked "
                          f"trees, one pruning.cu launch a division")
        return True

    def _build_multiwalk_pruners(self):
        """Group the divisions into multiwalk launches when the switch is
        on (port of mrbayes_tpu/mcmc/engine.py:988-1053 with the grouping
        this kernel needs, see the module docstring): divisions of one
        state count form a group, in order, while every (S, K_d) is one
        the kernel takes, the walks stay within 65,535 and the scratch
        within ``MULTIWALK_SCRATCH_CAP`` floats.  Groups of one division
        keep their single-division launch."""
        self._multiwalk_pruners: list = []
        if not self.multiwalk or self._ungrouped_trees("multiwalk"):
            return
        lo, hi = self.chain_slice
        C = hi - lo
        n_int = self.n_tips - 1
        by_states: dict = {}
        for i, cfg in enumerate(self.div_cfg):
            S = self._model_tips[i].shape[2]
            if not self._grouped(i):
                continue
            try:
                check_kernel_shape(S, cfg.n_cats, "multiwalk")
            except ValueError:
                continue
            by_states.setdefault(S, []).append(i)
        groups = []
        for S, idxs in by_states.items():
            cur, scratch = [], 0
            for i in idxs:
                cfg = self.div_cfg[i]
                need = (C * n_int * cfg.n_cats * S
                        * self._coded_tips(i).shape[1])
                if cur and (scratch + need > MULTIWALK_SCRATCH_CAP
                            or (len(cur) + 1) * C > 65535):
                    groups.append(cur)
                    cur, scratch = [], 0
                cur.append(i)
                scratch += need
            groups.append(cur)
        for g in groups:
            if len(g) < 2:
                continue
            specs = [(self._coded_tips(i), self.div_cfg[i].n_cats)
                     for i in g]
            self._multiwalk_pruners.append(
                (g, PruningCudaMultiwalk(specs, self.device)))

    @property
    def chain_slice(self) -> tuple[int, int]:
        """(lo, hi): the chains of the flat runs × chains axis this
        process holds; all of them unless ``set_chain_slice`` was called."""
        if self._chain_slice is None:
            return 0, self.mcmc.n_chains_total
        return self._chain_slice

    def set_chain_slice(self, lo: int, hi: int) -> None:
        """Hold chains [lo, hi) only (``parallel/mesh.py:shard_chains``):
        the multiwalk groups are formed again for that many chains (unless
        the data is sharded over sites, which clears them)."""
        self._chain_slice = (lo, hi)
        if not any(isinstance(p, PruningCudaSharded) for p in self._pruners):
            self._build_multiwalk_pruners()

    def _build_stacked_pruners(self):
        """Group divisions into stacked launches when the switch is on
        (port of mrbayes_tpu/mcmc/engine.py:903-986): divisions of at most
        ``STACK_MAX_PATTERNS`` patterns (coding dummies counted), in order,
        split greedily where the union width K·S would pass
        ``STACK_MAX_WIDTH``; groups of one division keep their own
        pruner.  The JAX package also splits where its TPU kernel's VMEM
        estimate (``kernel_vmem_bytes``) would overflow; that test has no
        meaning for the CUDA kernel, which sizes each member's shared
        memory by itself and gives a member that does not fit the
        global-scratch walk."""
        self._stacked_pruners: list = []
        if not self.stacked or self._ungrouped_trees("stacked"):
            return
        groups, cur, width = [], [], 0
        for i, cfg in enumerate(self.div_cfg):
            if self._coded_tips(i).shape[1] > STACK_MAX_PATTERNS \
                    or not self._grouped(i):
                continue
            ks = cfg.n_cats * self._model_tips[i].shape[2]
            if cur and width + ks > STACK_MAX_WIDTH:
                groups.append(cur)
                cur, width = [], 0
            cur.append(i)
            width += ks
        groups.append(cur)
        for g in groups:
            if len(g) < 2:
                continue
            specs = [(self._coded_tips(i), self.div_cfg[i].n_cats)
                     for i in g]
            self._stacked_pruners.append(
                (g, PruningCudaStacked(specs, self.device)))

    def _build_moves(self):
        """The unrooted non-clock move set (mrbayes_tpu engine.py:1479-
        1540) or the clock move set, then the substitution-parameter
        moves."""
        n = self.n_tips

        def wrap(base):
            return partial(base, n_tips=n)

        if self.best:
            self._finish_moves(self._best_moves())
            return
        if self.tree_settings.clock:
            self._finish_moves(self._clock_moves(
                self._pinned(wrap) if self._samples_ancestors() else wrap))
            return
        T = self.n_trees
        if self.rooted_nonclock:
            self._finish_moves(self._rooted_nonclock_moves(wrap))
            return
        if T > 1:
            def wrap(base):
                return self._tree_move(partial(base, n_tips=n))
        mk = []
        mk.append(MoveSpec("nni", wrap(M.move_nni), 5.0, 0.0,
                           tunable=False))
        mk.append(MoveSpec("spr", wrap(M.move_spr), 5.0, 0.0,
                           tunable=False))
        # the reference's workhorse topology moves: extending SPR
        # (Move_ExtSPR) and the subtree swapper (Move_ExtSS)
        mk.append(MoveSpec("ext_spr", wrap(M.move_ext_spr),
                           10.0, 0.8, 0.25, 1, 0.05, 0.95))
        if n > 3:
            # bisection moves need a true internal edge
            mk.append(MoveSpec("ext_tbr", wrap(M.move_ext_tbr),
                               5.0, 0.8, 0.25, 1, 0.05, 0.95))
            mk.append(MoveSpec("local", wrap(M.move_local),
                               2.0, 2.0 * np.log(1.6), 0.25, 1, 1e-3, 20.0))
        mk.append(MoveSpec("subtree_swap", wrap(M.move_subtree_swap),
                           2.0, 0.0, tunable=False))
        if T > 1:
            # one parsimony SPR a tree, biased by that tree's divisions, and
            # no parsimony TBR (mrbayes_tpu engine.py:1498-1517)
            for t in range(T):
                base = M.make_pars_spr_move(*self._pars_tensors(
                    [i for i in range(self.n_div) if self.div_tree[i] == t]))
                mk.append(MoveSpec(
                    f"pars_spr_t{t + 1}",
                    self._tree_move(partial(base, n_tips=n), t),
                    5.0 / T, 0.1, 0.25, -1, 0.01, 1.0))
        else:
            mk.append(MoveSpec(
                "pars_spr", wrap(M.make_pars_spr_move(self._pars_masks,
                                                      self._pars_factors)),
                5.0, 0.1, 0.25, -1, 0.01, 1.0))
            mk.append(MoveSpec(
                "pars_tbr", wrap(M.make_pars_tbr_move(self._pars_masks,
                                                      self._pars_factors)),
                3.0, 0.1, 0.25, -1, 0.01, 1.0))
        mk.append(MoveSpec("blen_mult", wrap(M.move_blen_multiplier),
                           15.0, 2.0 * np.log(1.6), 0.25, 1, 1e-3, 20.0))
        mk.append(MoveSpec("node_slider", wrap(M.move_node_slider),
                           5.0, 0.0, tunable=False))
        mk.append(MoveSpec("treelen_mult", wrap(M.move_treelen_multiplier),
                           2.0, 2.0 * np.log(1.6), 0.25, 1, 1e-3, 10.0))
        self._finish_moves(mk)

    # the reference's move types that it ships with weight 0 (disabled,
    # src/model.c SetUpMoveTypes relProposalProb=0): not carried, and
    # propset names them as such (mrbayes_tpu engine.py:195-202)
    UNCARRIED_MOVES = frozenset((
        "extss", "extssclock", "lspr", "parseraser1", "parsspr1",
        "parsspr2", "parstbr1_leaf", "parstbr2", "extspr1", "extspr2",
        "extspr3", "exttbr1", "exttbr2", "exttbr3", "exttbr4"))

    def _apply_move_overrides(self, overrides: dict):
        """propset's per-move control: name -> {prob|tuning|target|tunable:
        value} (reference ``propset ExtSPR$prob=0``, src/model.c
        DoPropset:4282; mrbayes_tpu engine.py:189-233).  A move whose
        probability becomes 0 leaves the move set."""
        if not overrides:
            return
        known = {m.name: m for m in self.moves}
        for name, kv in overrides.items():
            if name.lower() in self.UNCARRIED_MOVES:
                raise ValueError(
                    f"propset: move {name!r} is a reference move type "
                    f"shipped with default weight 0 (disabled; "
                    f"src/model.c SetUpMoveTypes) and is intentionally "
                    f"not carried — every default-active reference move "
                    f"has a counterpart (COVERAGE.md)")
            if name not in known:
                raise ValueError(
                    f"propset: unknown move {name!r}; active moves: "
                    f"{sorted(known)}")
            m = known[name]
            for k, v in kv.items():
                if k == "prob":
                    m.weight = float(v)
                elif k in ("tuning", "tuningparam"):
                    m.tuning0 = float(v)
                elif k in ("target", "targetrate"):
                    m.target = float(v)
                elif k == "tunable":
                    m.tunable = bool(v)
                else:
                    raise ValueError(f"propset: unknown setting {k!r}")
        self.moves = [m for m in self.moves if m.weight > 0.0]
        if not self.moves:
            raise ValueError("propset removed every move")

    def _rooted_nonclock_moves(self, wrap):
        """The rooted non-clock tree's moves that directional root
        frequencies force (mrbayes_tpu engine.py:1451-1480; the reference
        applies its NNI/ExtSPR/ExtTBR to TOPOLOGY_RNCL_*,
        src/model.c:21868, :22023, :22258): rooted NNI, rooted SPR (whose
        regraft targets include the root's child edges, so the root itself
        moves), and the branch-length moves over every non-root branch,
        tip 0's included."""
        if self.n_trees > 1:
            raise ValueError("unlinked topologies with a directional model "
                             "not supported")
        n = self.n_tips
        lam = 2.0 * np.log(1.6)

        def rooted(base):
            return partial(base, n_tips=n, rooted=True)

        return [MoveSpec("rooted_nni", wrap(M.move_rooted_nni), 8.0, 0.0,
                         tunable=False),
                MoveSpec("rooted_spr", wrap(M.move_rooted_spr), 10.0, 0.0,
                         tunable=False),
                MoveSpec("blen_mult", rooted(M.move_blen_multiplier), 15.0,
                         lam, 0.25, 1, 1e-3, 20.0),
                MoveSpec("node_slider", rooted(M.move_node_slider), 5.0, 0.0,
                         tunable=False),
                MoveSpec("treelen_mult", rooted(M.move_treelen_multiplier),
                         2.0, lam, 0.25, 1, 1e-3, 10.0)]

    def _tree_move(self, base, tree: int | None = None, fields=TREE_FIELDS,
                   n_trees: int | None = None):
        """A tree move on unlinked trees (mrbayes_tpu engine.py:1430-1450)
        or on BEST's gene trees (``fields`` GENE_FIELDS, ``n_trees`` the
        genes; engine.py:1215-1230): each chain applies ``base`` to one of
        its trees, ``tree`` or one drawn uniformly on the device, and its
        other trees stay as they were.  A field the move leaves unchanged
        keeps its tensor."""
        T = n_trees or self.n_trees

        def mv(gen, state, tuning):
            parent = state["parent"]
            rows = torch.arange(parent.shape[0], device=parent.device)
            g = (M.pick_group(gen, parent, T) if tree is None
                 else torch.full_like(rows, tree))
            old = {f: state[f][rows, g] for f in fields}
            sub, lnH = base(gen, old, tuning)
            out = dict(state)
            for f in fields:
                if sub[f] is not old[f]:
                    out[f] = state[f].index_put((rows, g), sub[f])
            return out, lnH
        return mv

    def _best_moves(self):
        """BEST's moves with the JAX package's weights, tunings and bounds
        (mrbayes_tpu engine.py:1210-1290): the clock moves on one gene tree
        a chain drawn on the device (reference Move_GeneTree1-3 and
        Move_NodeSliderGeneTree, src/best.c:1113-1714; the MSC prior
        rejects an inconsistent gene tree), the depth-matrix species-tree
        move (Move_SpeciesTree, src/best.c:1715), the clock moves on the
        species tree, the population sizes' multiplier and, under
        birthdeath, its parameters' moves.  Registered before
        ``_finish_moves``' split, they all take the tree scope: each
        changes only inputs of ``log_prior_tree``."""
        n, S = self.n_tips, self.n_species
        lam = 2.0 * np.log(1.6)

        def gene(base):
            return self._tree_move(partial(base, n_tips=n),
                                   fields=GENE_FIELDS, n_trees=self.n_div)

        def species(base):
            names = {"left": "s_left", "right": "s_right",
                     "parent": "s_parent", "age": "s_age"}

            def mv(gen, state, tuning):
                sub, lnH = base(gen, {k: state[v] for k, v in names.items()},
                                tuning, n_tips=S)
                return {**state, **{v: sub[k] for k, v in names.items()}}, lnH
            return mv

        def param(base):
            return partial(base, n_tips=n)

        mk = [MoveSpec("gene_nni", gene(CL.move_nni_clock), 5.0, 0.0,
                       tunable=False),
              MoveSpec("gene_spr", gene(CL.move_spr_clock), 5.0, 0.0,
                       tunable=False),
              MoveSpec("gene_age_slider", gene(CL.move_age_slider), 15.0,
                       0.0, tunable=False),
              MoveSpec("gene_root_age", gene(CL.move_root_age), 3.0,
                       2.0 * np.log(1.2), 0.25, 1, 1e-4, 10.0),
              MoveSpec("gene_tree_stretch", gene(CL.move_tree_stretch), 3.0,
                       2.0 * np.log(1.1), 0.25, 1, 1e-4, 5.0),
              MoveSpec("sp_distmatrix", B.make_species_tree_move(
                  S, self.tip_species, n), 10.0, 1.2, 0.25, 1, 1e-4, 20.0),
              MoveSpec("sp_nni", species(CL.move_nni_clock), 3.0, 0.0,
                       tunable=False),
              MoveSpec("sp_spr", species(CL.move_spr_clock), 2.0, 0.0,
                       tunable=False),
              MoveSpec("sp_age_slider", species(CL.move_age_slider), 6.0,
                       0.0, tunable=False),
              MoveSpec("sp_root_age", species(CL.move_root_age), 2.0,
                       2.0 * np.log(1.2), 0.25, 1, 1e-4, 10.0),
              MoveSpec("popsize_mult", param(M.make_multiplier_move(
                  "popsize", 1e-8, 1e8)), 3.0, lam, 0.25, 1, 1e-3, 20.0)]
        if self.tree_settings.clockpr == "birthdeath":
            mk += [MoveSpec("speciation_mult", param(M.make_multiplier_move(
                       "speciation", 1e-6, 1e4)), 1.5, lam, 0.25, 1, 1e-3,
                       20.0),
                   MoveSpec("extinction_slider", param(M.make_slider_move(
                       "extinction", 0.0, 1.0)), 1.5, 0.2, 0.25, 1, 1e-3,
                       1.0)]
        return mk

    def _clock_moves(self, wrap):
        """The clock tree's moves with the JAX package's weights, tunings
        and bounds (mrbayes_tpu engine.py:1292-1430), then the clock rate,
        the branch rates (CPP events, or per-branch rates with their
        variance and the mixed model's jump), the tree-process parameters,
        the sampled ancestors' add/delete-branch pair and the tip-date
        slider.  Every one of them changes only inputs of
        ``log_prior_tree``: registered before ``_finish_moves``' split,
        they take the tree scope.  Where fossils may be sampled ancestors,
        ``_build_moves`` passes the pinning ``wrap`` (``_pinned``)."""
        ts = self.tree_settings
        lam = 2.0 * np.log(1.6)
        mk = [
            MoveSpec("nni_clock", wrap(CL.move_nni_clock), 5.0, 0.0,
                     tunable=False),
            MoveSpec("subtree_swap_clock", wrap(CL.move_subtree_swap_clock),
                     3.0, 0.0, tunable=False),
            MoveSpec("node_slider_clock", wrap(CL.move_node_slider_clock),
                     5.0, 0.05, 0.25, 1, 1e-5, 10.0),
            MoveSpec("local_clock", wrap(CL.move_local_clock), 3.0, 0.0,
                     tunable=False),
            MoveSpec("pars_spr_clock", wrap(CL.make_pars_spr_clock_move(
                self._pars_masks, self._pars_factors)),
                5.0, 0.1, 0.25, -1, 0.01, 1.0),
            MoveSpec("spr_clock", wrap(CL.move_spr_clock), 5.0, 0.0,
                     tunable=False),
            MoveSpec("age_slider", wrap(CL.move_age_slider), 15.0, 0.0,
                     tunable=False),
            MoveSpec("tree_stretch", wrap(CL.move_tree_stretch), 3.0,
                     2.0 * np.log(1.1), 0.25, 1, 1e-4, 5.0),
            MoveSpec("root_age", wrap(CL.move_root_age), 3.0,
                     2.0 * np.log(1.2), 0.25, 1, 1e-4, 10.0)]
        if ts.clockratepr.kind != "fixed":
            mk.append(MoveSpec(
                "clockrate_mult",
                wrap(M.make_multiplier_move("clockrate", 1e-10, 1e6)), 3.0,
                2.0 * np.log(1.5), 0.25, 1, 1e-4, 10.0))
        if ts.clockvarpr == "cpp":
            sigma = float((ts.cppmultdevpr.params or (0.4,))[0])
            mk += [MoveSpec("cpp_adddelete",
                            wrap(CL.make_cpp_adddelete(sigma)), 6.0, 0.0,
                            tunable=False),
                   MoveSpec("cpp_position", wrap(CL.move_cpp_position), 2.0,
                            0.0, tunable=False),
                   MoveSpec("cpp_multiplier", wrap(CL.move_cpp_multiplier),
                            4.0, 2.0 * np.log(1.5), 0.25, 1, 1e-3, 20.0)]
            if ts.cppratepr.kind != "fixed":
                mk.append(MoveSpec(
                    "cpprate_mult",
                    wrap(M.make_multiplier_move("cpprate", 1e-6, 1e4)), 2.0,
                    lam, 0.25, 1, 1e-3, 20.0))
        elif ts.clockvarpr != "strict":
            mk.append(MoveSpec("brate_mult",
                               wrap(CL.make_brate_multiplier(self.n_tips)),
                               10.0, lam, 0.25, 1, 1e-3, 20.0))
            mk.append(MoveSpec(
                "clockvar_mult",
                wrap(M.make_multiplier_move("clockvar", 1e-6, 1e4)), 2.0,
                lam, 0.25, 1, 1e-3, 20.0))
            if ts.clockvarpr == "mixed":
                mk.append(MoveSpec("rcl_jump", wrap(CL.move_rcl_jump), 2.0,
                                   0.0, tunable=False))
        if ts.clockpr == "birthdeath":
            mk.append(MoveSpec(
                "speciation_mult",
                wrap(M.make_multiplier_move("speciation", 1e-6, 1e4)), 1.5,
                lam, 0.25, 1, 1e-3, 20.0))
            mk.append(MoveSpec(
                "extinction_slider",
                wrap(M.make_slider_move("extinction", 0.0, 1.0)), 1.5, 0.2,
                0.25, 1, 1e-3, 1.0))
        if ts.clockpr == "coalescence":
            mk.append(MoveSpec(
                "popsize_mult",
                wrap(M.make_multiplier_move("popsize", 1e-6, 1e8)), 1.5,
                lam, 0.25, 1, 1e-3, 20.0))
            if ts.growthpr.kind != "fixed":
                # the sampled exponential-growth rate (reference
                # Move_Growth, src/proposal.c:5650)
                mk.append(MoveSpec(
                    "growth_slider",
                    wrap(M.make_slider_move("growth", -1e3, 1e3)), 1.5,
                    1.0, 0.25, 1, 1e-3, 100.0))
        if ts.clockpr == "fossilization":
            # the (d, r, s) parameters (reference Move_Speciation
            # src/proposal.c:15961, Move_Extinction :1800,
            # Move_Fossilization :1923)
            mk += [MoveSpec(
                "speciation_mult",
                wrap(M.make_multiplier_move("speciation", 1e-6, 1e4)), 1.5,
                lam, 0.25, 1, 1e-3, 20.0),
                MoveSpec("extinction_slider",
                         wrap(M.make_slider_move("extinction", 0.0, 1.0)),
                         1.5, 0.2, 0.25, 1, 1e-3, 1.0),
                MoveSpec("fossilization_slider",
                         wrap(M.make_slider_move("fossilization", 0.0, 1.0)),
                         1.5, 0.2, 0.25, 1, 1e-3, 1.0)]
            # under wn and tk02 a branch rate's prior depends on the
            # branch's length, which has no proper density on a sampled
            # ancestor's zero-length branch: no fossil becomes one there
            if (self._samples_ancestors()
                    and ts.clockvarpr not in CL.LENGTH_RATE_CLOCKS):
                mk += [MoveSpec(name, wrap(CL.make_add_del_branch(
                    self._fossil, add)), 2.0, 0.0, tunable=False)
                    for name, add in (("add_branch", True),
                                      ("del_branch", False))]
        if self.sampled_tip_ages:
            mk.append(MoveSpec("tip_date_slider", wrap(CL.make_tip_date_move(
                *self._tip_date_bounds)), 3.0, 0.0, tunable=False))
        return mk

    def _pinned(self, wrap):
        """``wrap`` whose moves return pinned proposals: a proposal that
        changes the ages, the topology or the ``sa`` flags gets
        ``clock.pin_sa_ages``, so the state the chain keeps never holds a
        pinned parent's age apart from its fossil's (the port differs from
        the JAX package here on purpose: ROADMAP Queue 3)."""
        n = self.n_tips

        def pinned_wrap(base):
            fn = wrap(base)

            def move(gen, state, tuning):
                new, lnH = fn(gen, state, tuning)
                if all(new[k] is state[k] for k in ("age", "parent", "sa")):
                    return new, lnH
                return CL.pin_sa_ages(new, n), lnH
            return move
        return pinned_wrap

    def _samples_ancestors(self) -> bool:
        """True where fossils may be sampled ancestors (the ``sa`` flags):
        dated tips under the FBD prior with samplestrat other than
        fossiltip."""
        ts = self.tree_settings
        return (ts.clockpr == "fossilization" and self.has_dated_tips
                and ts.samplestrat != "fossiltip")

    def _finish_moves(self, mk):
        """Append the substitution-parameter moves and finalize weights
        (tail of reference SetUpMoveTypes, src/model.c:21618)."""
        n = self.n_tips
        # every move registered before this point touches only tree-
        # component prior inputs; every move appended below touches only
        # group_priors fields.  The split drives the carried-prior
        # recomputation in _chain_step.
        n_tree_moves = len(mk)
        if self.n_groups.get("pi"):
            mk.append(MoveSpec("pi_dir",
                               partial(M.make_simplex_move("pi"), n_tips=n),
                               2.0, 100.0, 0.25, -1, 1.0, 1e5))
        mk += self._protein_codon_moves()
        plain_rev = [g for g in range(self.n_groups.get("revmat", 0))
                     if g not in self._mixed_rev]
        if plain_rev:
            mk.append(MoveSpec(
                "revmat_dir",
                partial(M.make_simplex_move(
                    "revmat", None if len(plain_rev) == self.n_groups[
                        "revmat"] else self._rows(plain_rev)), n_tips=n),
                2.0, 200.0, 0.25, -1, 1.0, 1e5))
        if self.n_groups.get("aarevmat"):
            # protein GTR exchangeabilities: the Dirichlet proposal the
            # reference applies to REVMAT_DIR parameters of any size
            # (Move_Revmat_Dir, src/model.c:22913); its tuning alphaPi=100
            # is per rate, this concentration total: 100 x 190
            mk.append(MoveSpec(
                "aarevmat_dir",
                partial(M.make_simplex_move("aarevmat"), n_tips=n),
                2.0, 19000.0, 0.25, -1, 1.0, 1e7))
        if self._mixed_rev:
            mk += self._mixed_gtr_moves()
        mk += self._family_moves()
        if self.n_groups.get("covswitch"):
            mk.append(MoveSpec(
                "covswitch_mult",
                partial(M.make_multiplier_move("covswitch", 1e-3, 1e3),
                        n_tips=n), 1.5, 2.0 * np.log(1.5), 0.25, 1,
                1e-3, 20.0))
        if self.n_groups.get("brownscale"):
            mk.append(MoveSpec(
                "brownscale_mult",
                partial(M.make_multiplier_move("brownscale", 1e-6, 1e6),
                        n_tips=n), 1.5, 2.0 * np.log(1.5), 0.25, 1,
                1e-3, 20.0))
        if self.n_groups.get("tratio"):
            mk.append(MoveSpec(
                "tratio_mult",
                partial(M.make_multiplier_move("tratio", 1e-4, 1e4),
                        n_tips=n), 1.0, 1.0, 0.25, 1, 1e-3, 20.0))
        if self.n_groups.get("shape"):
            mk.append(MoveSpec(
                "shape_mult",
                partial(M.make_multiplier_move("shape", 1e-4, 200.0),
                        n_tips=n), 1.5, 2.0 * np.log(1.6), 0.25, 1,
                1e-3, 20.0))
        if self.n_groups.get("pinvar"):
            mk.append(MoveSpec(
                "pinvar_slider",
                partial(M.make_slider_move("pinvar", 0.0, 1.0), n_tips=n),
                1.5, 0.2, 0.25, 1, 1e-3, 1.0))
        if self.ratemult_on:
            mk.append(MoveSpec(
                "ratemult_dir",
                partial(M.make_simplex_move("ratemult"), n_tips=n),
                1.5, 300.0, 0.25, -1, 1.0, 1e5))
        # omegaprobs_dir, m3probs_dir and m10probs_dir change Q because the
        # NY98, M3 and M10 classes are normalised jointly
        # (src/likelihood.c:10702); aamodel_jump gathers the precomputed
        # eigensystem of the new model
        q_moves = {"pi_dir", "pi20_dir", "pi61_dir", "pi16_dir", "pi2_dir",
                   "dirpi_switch", "omega_mult", "omega1_slider",
                   "omega3_mult", "omegaprobs_dir", "m3omega_slider", "m3probs_dir",
                   "m10beta_mult", "m10gamma_mult", "m10probs_dir",
                   "aamodel_jump", "revmat_dir", "aarevmat_dir",
                   "revmat_splitmerge", "revmat_dirmix", "tratio_mult"}
        # a covarion division's eigensystem also depends on its rate
        # categories, switch rates and rate multiplier (the JAX engine
        # rebuilds it inline in every likelihood, mrbayes_tpu
        # engine.py:2331-2334): the moves of those refresh it, and only it
        covarion = tuple(i for i, c in enumerate(self.div_cfg)
                         if c.covarion)
        # a symdirihyperpr division's eigensystems depend on its own
        # frequencies or beta alone: the moves of those refresh it, and no
        # other Q move does (the JAX engine rebuilds them inline in every
        # likelihood, mrbayes_tpu engine.py:2340-2342, :2646-2666)
        own = {**{f"{f}_dir": tuple(i for i, c in enumerate(self.div_cfg)
                                    if c.sympi_field == f)
                  for f in self.n_groups if f.startswith("sympi")},
               "symbeta_mult": tuple(i for i, c in enumerate(self.div_cfg)
                                     if c.symbeta_group >= 0
                                     and c.sympi_group < 0)}
        plain = None if not any(c.symdiri for c in self.div_cfg) else tuple(
            i for i, c in enumerate(self.div_cfg) if not c.symdiri)
        for i, m in enumerate(mk):
            m.updates_q = m.name in q_moves
            if m.updates_q:
                m.eig_divs = plain
            if covarion and not m.updates_q and m.name in (
                    "shape_mult", "covswitch_mult", "ratemult_dir"):
                m.updates_q, m.eig_divs = True, covarion
            if own.get(m.name):
                m.updates_q, m.eig_divs = True, own[m.name]
            if m.prior_scope is None:
                m.prior_scope = "tree" if i < n_tree_moves else "params"
        self.moves = mk

    def _family_moves(self):
        """The symdirihyperpr, kmixture and adgamma moves with the JAX
        package's weights, tunings and bounds, in its order (mrbayes_tpu
        engine.py:1798-1819): the beta multiplier, one Dirichlet move a
        multistate frequency field, the mixture rates' Dirichlet move and
        the correlation's slider."""
        n = self.n_tips
        g = self.n_groups
        mk = []
        if g.get("symbeta"):
            mk.append(MoveSpec(
                "symbeta_mult",
                partial(M.make_multiplier_move("symbeta", 1e-2, 1e4),
                        n_tips=n), 1.0, 2.0 * np.log(1.5), 0.25, 1,
                1e-3, 20.0))
        for field in sorted(g):
            if field.startswith("sympi"):
                mk.append(MoveSpec(
                    f"{field}_dir",
                    partial(M.make_simplex_move(field), n_tips=n),
                    1.5, 100.0, 0.25, -1, 1.0, 1e5))
        if g.get("mixtrates"):
            mk.append(MoveSpec(
                "mixtrates_dir",
                partial(M.make_simplex_move("mixtrates"), n_tips=n),
                1.5, 100.0, 0.25, -1, 1.0, 1e5))
        if g.get("ratecorr"):
            mk.append(MoveSpec(
                "ratecorr_slider",
                partial(M.make_slider_move("ratecorr", -1.0, 1.0),
                        n_tips=n), 1.5, 0.3, 0.25, 1, 1e-3, 2.0))
        return mk

    def _protein_codon_moves(self):
        """The protein, codon and doublet parameter moves with the JAX
        package's weights, tunings and bounds, in its order
        (mrbayes_tpu/mcmc/engine.py:1559-1563, 1667-1753)."""
        n = self.n_tips
        g = self.n_groups
        lam = 2.0 * np.log(1.5)
        mk = []
        if g.get("pi20"):
            mk.append(MoveSpec("pi20_dir",
                               partial(M.make_simplex_move("pi20"), n_tips=n),
                               2.0, 500.0, 0.25, -1, 1.0, 1e6))
        if g.get("pi2"):
            mk.append(MoveSpec("pi2_dir",
                               partial(M.make_simplex_move("pi2"), n_tips=n),
                               1.5, 100.0, 0.25, -1, 1.0, 1e5))
        if g.get("rootpi2"):
            mk += self._root_freq_moves()
        if g.get("pi61"):
            mk.append(MoveSpec("pi61_dir",
                               partial(M.make_simplex_move("pi61"), n_tips=n),
                               2.0, 2000.0, 0.25, -1, 10.0, 1e7))
        if g.get("pi16"):
            mk.append(MoveSpec("pi16_dir",
                               partial(M.make_simplex_move("pi16"), n_tips=n),
                               2.0, 500.0, 0.25, -1, 1.0, 1e6))
        if g.get("omega"):
            mk.append(MoveSpec(
                "omega_mult",
                partial(M.make_multiplier_move("omega", 1e-4, 1e3), n_tips=n),
                2.0, lam, 0.25, 1, 1e-3, 20.0))
        if g.get("ny98"):
            mk.append(MoveSpec(
                "omega1_slider",
                partial(M.make_slider_move("omega1", 0.0, 1.0), n_tips=n),
                1.5, 0.1, 0.25, 1, 1e-3, 1.0))
            mk.append(MoveSpec(
                "omega3_mult",
                partial(M.make_multiplier_move("omega3", 1.0, 1e3), n_tips=n),
                1.5, lam, 0.25, 1, 1e-3, 20.0))
            mk.append(MoveSpec(
                "omegaprobs_dir",
                partial(M.make_simplex_move("omegaprobs"), n_tips=n),
                1.5, 100.0, 0.25, -1, 1.0, 1e5))
        if g.get("m3"):
            mk.append(MoveSpec(
                "m3omega_slider", partial(M.move_m3omega_slider, n_tips=n),
                2.0, 0.5, 0.25, 1, 1e-3, 50.0))
            mk.append(MoveSpec(
                "m3probs_dir",
                partial(M.make_simplex_move("m3probs"), n_tips=n),
                1.5, 100.0, 0.25, -1, 1.0, 1e5))
        if g.get("m10"):
            for field in ("m10beta", "m10gamma"):
                mk.append(MoveSpec(
                    f"{field}_mult",
                    partial(M.make_multiplier_move(field, 1e-3, 20.0),
                            n_tips=n), 1.0, lam, 0.25, 1, 1e-3, 20.0))
            mk.append(MoveSpec(
                "m10probs_dir",
                partial(M.make_simplex_move("m10catprobs"), n_tips=n),
                1.0, 100.0, 0.25, -1, 1.0, 1e5))
        if g.get("aamodel"):
            mk.append(MoveSpec(
                "aamodel_jump",
                partial(M.make_jump_move("aamodel_idx", len(AA_MIXED_ORDER)),
                        n_tips=n), 2.0, 0.0, tunable=False))
        return mk

    def _root_freq_moves(self):
        """The root-frequency moves (mrbayes_tpu engine.py:1568-1668;
        reference Move_StatefreqsRoot and Move_StatefreqsRoot_Slider, 0.5
        each for DIRPI_*, src/model.c:23111-23152) and, under
        statefreqmodel=mixed, the stationary <-> directional reversible
        jump (Move_Statefreqs_SplitMerge, src/model.c:23153-23170,
        src/proposal.c:16528).  Each chain picks one root-frequency group
        on the device; a mixed group's root moves are rejected while it is
        stationary (it has no root frequencies then)."""
        pairs, seen = [], set()
        for cfg in self.div_cfg:
            if cfg.rootpi_group >= 0 and cfg.rootpi_group not in seen:
                seen.add(cfg.rootpi_group)
                if cfg.dirpi_mix and cfg.pi_group < 0:
                    raise ValueError("statefreqmodel=mixed needs a sampled "
                                     "statefreqpr (dirichlet)")
                pairs.append((cfg.pi_group, cfg.rootpi_group, cfg.dirpi_mix))
        mix_on = any(m for _, _, m in pairs)
        pi_ids = self._rows(p for p, _, _ in pairs)
        root_ids = self._rows(r for _, r, _ in pairs)
        mixed = torch.as_tensor([m for _, _, m in pairs], device=self.device)

        def chosen(gen, state):
            i = M.pick_group(gen, state["rootpi2"], len(pairs))
            rows = torch.arange(i.shape[0], device=i.device)
            g = root_ids[i]
            ok = ~mixed[i]
            if mix_on:
                ok = ok | (state["dirpi_on"][rows, g] > 0)
            return i, rows, g, ok

        def put(arr, rows, g, new):
            return arr.index_put((rows, g), new)

        def mv_rootpi_dir(gen, state, tuning):
            _, rows, g, ok = chosen(gen, state)
            new, lnH = M._dirichlet_proposal(gen, state["rootpi2"][rows, g],
                                             tuning)
            return ({**state, "rootpi2": put(state["rootpi2"], rows, g, new)},
                    torch.where(ok, lnH, NEG_INF))

        def mv_rootpi_slider(gen, state, tuning):
            _, rows, g, ok = chosen(gen, state)
            u = torch.rand(tuning.shape, generator=gen, device=tuning.device)
            # reflect into (0, 1)
            x = (state["rootpi2"][rows, g, 0] + (u - 0.5) * tuning).abs()
            x = torch.where(x > 1.0, 2.0 - x, x)
            new = torch.stack([x, 1.0 - x], -1)
            return ({**state, "rootpi2": put(state["rootpi2"], rows, g, new)},
                    torch.where(ok, 0.0, NEG_INF))

        def lndir(alpha, x):
            return dirichlet_lpdf(x, alpha.clamp_min(1e-4))

        def gamma_draw(gen, alpha):
            g = torch._standard_gamma(alpha, generator=gen) + 1e-10
            return g / g.sum(-1, keepdim=True)

        def mv_dirpi_switch(gen, state, tuning):
            # split (stationary -> directional): the new stationary and
            # root frequencies from Dir(a old_pi); merge (directional ->
            # stationary): the new stationary from Dir(a (old_pi +
            # old_root) / 2)
            i, rows, gr, _ = chosen(gen, state)
            gp = pi_ids[i]
            on = state["dirpi_on"][rows, gr] > 0
            a = tuning[:, None]
            old_pi = state["pi2"][rows, gp]
            old_root = state["rootpi2"][rows, gr]
            pi_s = gamma_draw(gen, a * old_pi)
            root_s = gamma_draw(gen, a * old_pi)
            mid = a * (old_pi + old_root) / 2.0
            pi_m = gamma_draw(gen, mid)
            lnH_split = (lndir(a * (pi_s + root_s) / 2.0, old_pi)
                         - lndir(a * old_pi, pi_s) - lndir(a * old_pi, root_s))
            lnH_merge = (lndir(a * pi_m, old_pi) + lndir(a * pi_m, old_root)
                         - lndir(mid, pi_m))
            new_pi = torch.where(on[:, None], pi_m, pi_s)
            new_root = torch.where(on[:, None], old_root, root_s)
            return ({**state,
                     "pi2": put(state["pi2"], rows, gp, new_pi),
                     "rootpi2": put(state["rootpi2"], rows, gr, new_root),
                     "dirpi_on": put(state["dirpi_on"], rows, gr,
                                     (~on).to(state["dirpi_on"].dtype))},
                    torch.where(on, lnH_merge, lnH_split))

        mk = [MoveSpec("rootpi_dir", mv_rootpi_dir, 0.5, 200.0,
                       0.25, -1, 1.0, 1e5),
              MoveSpec("rootpi_slider", mv_rootpi_slider, 0.5, 0.15,
                       0.25, 1, 1e-5, 1.0)]
        if mix_on:
            mk.append(MoveSpec("dirpi_switch", mv_dirpi_switch, 0.5,
                               200.0, 0.25, -1, 1.0, 1e4))
        return mk

    def _simplex_width(self, param, gid) -> int:
        """The length of a Dirichlet-sampled group's simplex."""
        if param == "pi61":
            return next(c.codon.n_states for c in self.div_cfg
                        if c.pi_field == "pi61" and c.pi_group == gid)
        if param == "mixtrates":
            return next(c.settings.nmixtcat for c in self.div_cfg
                        if c.mixt_group == gid)
        return {"pi": 4, "pi20": 20, "pi16": 16, "pi2": 2, "revmat": 6,
                "aarevmat": 190}[param]

    def _rows(self, values):
        return torch.as_tensor(list(values), dtype=torch.long,
                               device=self.device)

    def _mixed_gtr_moves(self):
        """The nst=mixed rjMCMC moves (mrbayes_tpu/mcmc/engine.py:1773-
        1797): each chain picks one mixed revmat group on the device."""
        gids = self._rows(sorted(self._mixed_rev))

        def rows_of(gen, state):
            gi = M.pick_group(gen, state["revmat"], 0, gids)
            rows = torch.arange(gi.shape[0], device=gi.device)
            return rows, gi

        def put(arr, rows, gi, new):
            out = arr.clone()
            out[rows, gi] = new
            return out

        def mv_splitmerge(gen, state, tuning):
            rows, gi = rows_of(gen, state)
            z2, v2, lnH = MG.splitmerge(gen, state["gtr_class"][rows, gi],
                                        state["revmat"][rows, gi], tuning)
            return ({**state,
                     "gtr_class": put(state["gtr_class"], rows, gi, z2),
                     "revmat": put(state["revmat"], rows, gi, v2)}, lnH)

        def mv_dirmix(gen, state, tuning):
            rows, gi = rows_of(gen, state)
            v2, lnH = MG.dirichlet_mixed(gen, state["gtr_class"][rows, gi],
                                         state["revmat"][rows, gi], tuning)
            return ({**state,
                     "revmat": put(state["revmat"], rows, gi, v2)}, lnH)

        return [MoveSpec("revmat_splitmerge", mv_splitmerge,
                         2.0, 10.0, 0.25, -1, 0.5, 1e4),
                MoveSpec("revmat_dirmix", mv_dirmix,
                         2.0, 200.0, 0.25, -1, 1.0, 1e5)]

    def _build_constants(self):
        """Every constant tensor the generation loop reads, built once (a
        tensor made from host data inside the loop would synchronise)."""
        dev = self.device
        mv = self.moves
        w = np.array([m.weight for m in mv], np.float64)
        self._move_probs = torch.as_tensor(w / w.sum())        # host

        def per_move(values):
            return torch.tensor([float(x) for x in values],
                                dtype=torch.float32, device=dev)

        self._tune_target = per_move(m.target for m in mv)
        self._tune_dir = per_move(m.direction for m in mv)
        self._tune_on = per_move(m.tunable for m in mv)
        self._tune_min = per_move(m.tmin for m in mv)
        self._tune_max = per_move(m.tmax for m in mv)
        idx = np.arange(self.n_nodes)
        # the sampled branch lengths: every non-root branch, tip 0's only
        # on a rooted non-clock tree (mrbayes_tpu engine.py:2806-2812)
        self._blen_mask = torch.as_tensor(
            (idx != self.n_nodes - 1) & ((idx != 0) | self.rooted_nonclock),
            device=dev)
        self._interior = torch.as_tensor(idx >= self.n_tips, device=dev)
        self._unit_rates = torch.ones((1, 1), device=dev)
        self._prior_alpha = {}
        for (param, gid), pr in self.group_priors.items():
            if param in ("omegaprobs", "m3probs", "m10catprobs"):
                self._prior_alpha[(param, gid)] = torch.tensor(
                    [float(x) for x in pr.params], device=dev)
            elif param in PI_FIELDS + ("revmat", "aarevmat", "mixtrates"):
                a = pr.params[0] if pr.params else 1.0
                self._prior_alpha[(param, gid)] = torch.full(
                    (self._simplex_width(param, gid),), float(a), device=dev)
        if self.ratemult_on:
            self._ratemult_alpha = torch.ones(self.n_div, device=dev)
        # a multistate frequency group's symmetric Dirichlet(beta) prior:
        # (field, group, the symbeta group or -1, the fixed beta), once a
        # group (mrbayes_tpu engine.py:2845-2860)
        self._sympi_priors = list(dict.fromkeys(
            (c.sympi_field, c.sympi_group, c.symbeta_group, c.fixed_symbeta)
            for c in self.div_cfg if c.sympi_group >= 0))
        # the root frequencies' Dirichlet prior a group, and whether a mixed
        # run's RJ indicator gates it (mrbayes_tpu engine.py:2858-2875)
        self._rootpi_priors = {}
        for c in self.div_cfg:
            if c.rootpi_group >= 0 and c.rootpi_group not in \
                    self._rootpi_priors:
                ps = tuple(float(x)
                           for x in (c.settings.rootfreqpr.params or (1.0,)))
                self._rootpi_priors[c.rootpi_group] = (torch.tensor(
                    ps if len(ps) == 2 else (ps[0], ps[0]), device=dev),
                    c.dirpi_mix)
        self._doublet_cls = torch.as_tensor(DOUBLET_CLS, device=dev)
        # the codon pair classes (single change, transition,
        # nonsynonymous) [S, S] of each codon division
        self._codon_classes = {
            i: tuple(torch.as_tensor(m, device=dev)
                     for m in c.codon.pair_classes())
            for i, c in enumerate(self.div_cfg) if c.codon is not None}
        # a protein division's fixed exchangeabilities [190]
        self._aa_exch = {}
        for i, c in enumerate(self.div_cfg):
            if c.div.dtype is DataType.PROTEIN and c.aamodel_group < 0 \
                    and c.aarevmat_group < 0:
                ex = (c.fixed_aarevmat if c.fixed_aarevmat is not None
                      else AA_MODELS["poisson" if c.settings.aamodel in (
                          "poisson", "equalin") else c.settings.aamodel][0])
                self._aa_exch[i] = torch.as_tensor(
                    np.asarray(ex, np.float32), device=dev)
        # eigensystems of fixed Q matrices are computed once here, in
        # float64, and never refreshed, where the JAX engine recomputes
        # them in float32 with every refresh: a standard division's (Mk,
        # equal frequencies; its eigenvalue repeated S - 1 times costs the
        # float32 Jacobi up to 2e-6 in P(t) at S = 8) and a protein
        # division's whose exchangeabilities and frequencies are both
        # fixed (an empirical model, or Poisson or fixed GTR rates under
        # fixed frequencies)
        self._const_eigs = {}
        for i, c in enumerate(self.div_cfg):
            if not c.prunes or c.sympi_group >= 0 or c.symbeta_group >= 0:
                continue
            if c.symdiri:
                # symdirihyperpr=fixed(beta) on a binary character: its
                # beta categories' eigensystems never change
                self._const_eigs[i] = self._symdiri_eig(
                    torch.tensor([c.fixed_symbeta], device=dev), i)
            elif c.div.dtype is DataType.STANDARD:
                pi = self._fixed_pi[i].double()                 # [1, S]
                self._const_eigs[i] = tuple(
                    x.float() for x in eigh_reversible(
                        self._standard_q(c, pi), pi))
            elif i in self._aa_exch and c.pi_group < 0 and not c.covarion:
                self._const_eigs[i] = _fixed_eig(
                    self._aa_exch[i][None], self._fixed_pi[i])
        # aamodelpr=mixed: every model's exchangeabilities [11, 190],
        # frequencies [11, 20] and eigensystem, in the reference's model
        # order, gathered on the device by each chain's aamodel_idx
        if self.n_groups.get("aamodel"):
            ex = torch.as_tensor(np.stack(
                [AA_MODELS[m][0] for m in AA_MIXED_ORDER]).astype(np.float32),
                device=dev)
            pi = torch.as_tensor(np.stack(
                [AA_MODELS[m][1] for m in AA_MIXED_ORDER]).astype(np.float32),
                device=dev)
            self._aa_stack = (ex, pi) + _fixed_eig(ex, pi)

    # ------------------------------------------------------------------
    # state

    def init_state(self, rng: np.random.Generator, tree: Tree | None = None):
        """One chain's starting state (host numpy values): ``tree``, the
        user's starting tree (startvals), a tree built from the data
        (``mcmc starttree=parsimony|nj``), or a random unrooted tree drawn
        from ``rng``, then ``nperts`` random NNIs (the same draws as the
        JAX package's init_state, mrbayes_tpu engine.py:2013-2044), plus
        the substitution-parameter defaults.  A clock model starts from a
        random clock tree instead, and BEST from its species and gene
        trees."""
        if self.best:
            return self._init_substitution_state(self._init_best_state(rng))
        if self.tree_settings.clock:
            return self._init_substitution_state(self._init_clock_state(rng))

        def draw():
            # mcmc starttree=/nperts= (reference chainParams startTree/
            # numStartPerts, src/command.c:14520-14521; RandPerturb
            # src/mcmc.c:2569).  A constrained run keeps the constrained
            # random builder: a built or perturbed tree could break a
            # constraint.
            constrained = bool(self._start_clade_masks()
                               or self.negative_masks is not None)
            mode = self.mcmc.starttree
            t = tree or self.start_tree
            if mode == "random":
                t = tree                # the user's starting tree ignored
            elif mode in ("parsimony", "nj") and tree is None \
                    and not constrained:
                t = self._built_start_tree(mode, rng)
            if t is None:
                if constrained:
                    # a random tree holding the constrained clades
                    t = self._retry_negative(
                        lambda: random_unrooted_constrained(
                            self.n_tips, rng, self._start_clade_masks(),
                            mean_blen=0.1), lambda x: x)
                else:
                    t = random_unrooted(self.n_tips, rng, mean_blen=0.1)
            if self.mcmc.nperts > 0 and tree is None and not constrained:
                t = perturb_nni(t, self.mcmc.nperts, rng)
            return t

        def arrays(t):
            blen = np.clip(t.blen, 0.0, M.BRLEN_MAX).astype(np.float32)
            if self.rooted_nonclock and blen[0] == 0.0:
                # the root starts on tip 0's pendant edge: split the basal
                # branch so both root children have a length (mrbayes_tpu
                # engine.py:2048-2054)
                basal = int(t.left[self.n_nodes - 1])
                blen[0] = blen[basal] / 2.0
                blen[basal] = blen[basal] / 2.0
            return {"left": np.asarray(t.left, np.int64),
                    "right": np.asarray(t.right, np.int64),
                    "parent": np.asarray(t.parent, np.int64), "blen": blen}

        if self.n_trees > 1:
            # one random tree a tree group, [n_trees, n_nodes] each
            per = [arrays(draw()) for _ in range(self.n_trees)]
            st = {k: np.stack([p[k] for p in per]) for k in TREE_FIELDS}
        else:
            st = arrays(draw())
        return self._init_substitution_state(st)

    def _built_start_tree(self, mode: str, rng):
        """starttree=parsimony|nj: a starting tree built from the data
        (reference BuildParsTrees stepwise addition, or neighbor joining;
        mrbayes_tpu engine.py:2070-2096).  A parsimony tree takes a fresh
        random addition order from ``rng`` each call; the NJ tree is
        deterministic and cached (chains differ by their nperts)."""
        ms, ws = [], []
        for d in self.data.divisions:
            if d.cont is not None or d.patterns.size == 0:
                continue
            ms.append(d.patterns.astype(np.uint32))
            ws.append(np.asarray(d.weights, np.float64))
        if not ms:
            return None
        masks = np.concatenate(ms, axis=1)
        wts = np.concatenate(ws)
        if mode == "nj":
            if not hasattr(self, "_nj_tree"):
                self._nj_tree = neighbor_joining(pdistance_matrix(masks, wts))
            return self._nj_tree
        return parsimony_stepwise(masks, wts, rng)

    def _start_clade_masks(self) -> list:
        """Clades the starting tree must hold: the hard constraints and the
        partial constraints' first sets (making set1 a clade keeps set2
        out of it, which satisfies the backbone)."""
        masks = []
        if self.constraint_masks is not None:
            masks += list(self.constraint_masks)
        if self.partial_masks is not None:
            masks += list(self.partial_masks[0])
        return masks

    def _retry_negative(self, build, tree_of, tries: int = 100):
        """Draw starting trees until none holds a negative constraint's
        clade (rejection: a random tree rarely holds a given split)."""
        for _ in range(tries):
            out = build()
            if self.negative_masks is None:
                return out
            t = tree_of(out)
            tipsets = np.zeros((t.n_nodes, self.n_tips), bool)
            tipsets[np.arange(self.n_tips), np.arange(self.n_tips)] = True
            for v in t.postorder():
                tipsets[v] = tipsets[t.left[v]] | tipsets[t.right[v]]
            bad = False
            for m in self.negative_masks:
                eq = (tipsets == m[None, :]).all(1)
                if not t.rooted:
                    eq |= (tipsets == ~m[None, :]).all(1)
                if eq.any():
                    bad = True
                    break
            if not bad:
                return out
        raise ValueError("could not draw a starting tree satisfying the "
                         "negative constraints")

    def _init_clock_state(self, rng):
        """A random clock tree (constrained, with its dated tips) with its
        ages, and the clock's starting values (mrbayes_tpu
        engine.py:1959-2041, the same rng draws)."""
        ts = self.tree_settings
        mean_age = 0.1
        tip_ages = None
        if self.has_dated_tips:
            mean_age = max(0.1, 1.2 * float(self.tip_dates.max()))
            tip_ages = self.tip_dates
        smasks = self._start_clade_masks()
        if smasks:
            t, ages = self._retry_negative(
                lambda: random_clock_tree_constrained(
                    self.n_tips, rng, smasks, mean_age=mean_age,
                    tip_ages=tip_ages), lambda pair: pair[0])
        else:
            t, ages = random_clock_tree(self.n_tips, rng, mean_age=mean_age,
                                        tip_ages=tip_ages)
        st = {"left": np.asarray(t.left, np.int64),
              "right": np.asarray(t.right, np.int64),
              "parent": np.asarray(t.parent, np.int64),
              "age": np.asarray(ages, np.float32)}

        def one(x):
            return np.asarray([x], np.float32)

        if ts.clockratepr.kind != "fixed":
            p = ts.clockratepr.params
            st["clockrate"] = one({
                "normal": lambda: p[0],
                "lognormal": lambda: float(np.exp(p[0])),
                "gamma": lambda: p[0] / p[1],
                "exponential": lambda: 1.0 / p[0],
                "uniform": lambda: 0.5 * (p[0] + p[1])}[
                    ts.clockratepr.kind]())
        if ts.clockvarpr == "cpp":
            K = self.cpp_cap
            st["cpp_n"] = np.zeros(self.n_nodes, np.int64)
            st["cpp_pos"] = np.full((self.n_nodes, K), 0.5, np.float32)
            st["cpp_mult"] = np.ones((self.n_nodes, K), np.float32)
            p = ts.cppratepr.params
            st["cpprate"] = one(1.0 / p[0] if ts.cppratepr.kind ==
                                "exponential" else (p or (1.0,))[0])
        elif ts.clockvarpr != "strict":
            st["brate"] = np.ones(self.n_nodes, np.float32)
            st["clockvar"] = one(0.1)
            if ts.clockvarpr == "mixed":
                st["rcl_model"] = np.zeros(1, np.int64)
        if ts.clockpr in ("birthdeath", "fossilization"):
            st["speciation"] = one(0.1)
            st["extinction"] = one(0.5)
        if ts.clockpr == "coalescence":
            st["popsize"] = one(1.0)
            if ts.growthpr.kind != "fixed":
                st["growth"] = one(0.0)
        if ts.clockpr == "fossilization":
            st["fossilization"] = one(0.1)
            if self._samples_ancestors():
                # the ancestral-fossil flags: every fossil starts as a tip
                st["sa"] = np.zeros(self.n_tips, np.int64)
        return st

    def _init_best_state(self, rng):
        """BEST's starting trees (``best.init_compatible_trees``, the same
        numpy draws as the JAX package), the population sizes at their
        prior's centre (a gamma's mean, a lognormal's exp(mu), a uniform's
        midpoint, an exponential's mean 1/rate) and, under birthdeath, its
        parameters (mrbayes_tpu engine.py:1918-1952)."""
        ts = self.tree_settings
        (st_sp, s_ages), genes = B.init_compatible_trees(
            self.n_tips, self.n_species, self.tip_species_host, rng,
            self.n_div)

        def stacked(attr):
            return np.stack([np.asarray(getattr(t, attr), np.int64)
                             for t, _ in genes])

        st = {"left": stacked("left"), "right": stacked("right"),
              "parent": stacked("parent"),
              "age": np.stack([np.asarray(a, np.float32) for _, a in genes]),
              "s_left": np.asarray(st_sp.left, np.int64),
              "s_right": np.asarray(st_sp.right, np.int64),
              "s_parent": np.asarray(st_sp.parent, np.int64),
              "s_age": np.asarray(s_ages, np.float32)}
        m = 2 * self.n_species - 1 if ts.popvarpr == "variable" else 1
        p = ts.popsizepr.params
        n0 = {"gamma": lambda: p[0] / p[1],
              "lognormal": lambda: float(np.exp(p[0])),
              "uniform": lambda: 0.5 * (p[0] + p[1]),
              "exponential": lambda: 1.0 / p[0]}.get(
                  ts.popsizepr.kind, lambda: p[0] if p else 1.0)()
        st["popsize"] = np.full(m, n0, np.float32)
        if ts.clockpr == "birthdeath":
            st["speciation"] = np.asarray([0.1], np.float32)
            st["extinction"] = np.asarray([0.5], np.float32)
        return st

    def _init_substitution_state(self, st):
        """Starting values for the sampled substitution parameters (role
        of reference FillNormalParams, src/model.c:11444)."""
        g = self.n_groups
        if g.get("pi"):
            st["pi"] = np.full((g["pi"], 4), 0.25, np.float32)
        if g.get("pi20"):
            st["pi20"] = np.full((g["pi20"], 20), 0.05, np.float32)
        if g.get("pi61"):
            n61 = self._simplex_width("pi61", 0)
            st["pi61"] = np.full((g["pi61"], n61), 1.0 / n61, np.float32)
        if g.get("pi16"):
            st["pi16"] = np.full((g["pi16"], 16), 1.0 / 16, np.float32)
        if g.get("pi2"):
            st["pi2"] = np.full((g["pi2"], 2), 0.5, np.float32)
        if g.get("rootpi2"):
            st["rootpi2"] = np.full((g["rootpi2"], 2), 0.5, np.float32)
            if any(c.dirpi_mix for c in self.div_cfg):
                # a mixed run starts directional (the reference's .p prints
                # statefrmod=1 with its root frequencies at generation 0)
                st["dirpi_on"] = np.ones(g["rootpi2"], np.int64)
        if g.get("covswitch"):
            st["covswitch"] = np.ones((g["covswitch"], 2), np.float32)
        # the new families' starts (mrbayes_tpu engine.py:2141-2157)
        if g.get("ratecorr"):
            st["ratecorr"] = np.zeros((g["ratecorr"],), np.float32)
        if g.get("symbeta"):
            st["symbeta"] = np.ones((g["symbeta"],), np.float32)
        if g.get("brownscale"):
            st["brownscale"] = np.ones((g["brownscale"],), np.float32)
        for field, ng in g.items():
            if field.startswith("sympi"):
                k = int(field[5:])
                st[field] = np.full((ng, k), 1.0 / k, np.float32)
        if g.get("mixtrates"):
            ks = {c.settings.nmixtcat for c in self.div_cfg
                  if c.mixt_group >= 0}
            if len(ks) > 1:
                raise ValueError("kmixture groups must share nmixtcat")
            k = ks.pop()
            st["mixtrates"] = np.full((g["mixtrates"], k), 1.0 / k,
                                      np.float32)
        if g.get("omega"):
            st["omega"] = np.ones((g["omega"],), np.float32)
        if g.get("ny98"):
            st["omega1"] = np.full((g["ny98"],), 0.1, np.float32)
            st["omega3"] = np.full((g["ny98"],), 2.0, np.float32)
            st["omegaprobs"] = np.full((g["ny98"], 3), 1.0 / 3, np.float32)
        if g.get("m10"):
            st["m10beta"] = np.ones((g["m10"], 2), np.float32)
            st["m10gamma"] = np.ones((g["m10"], 2), np.float32)
            st["m10catprobs"] = np.full((g["m10"], 2), 0.5, np.float32)
        if g.get("m3"):
            st["m3omega"] = np.tile(np.asarray([0.1, 1.0, 3.0], np.float32),
                                    (g["m3"], 1))
            st["m3probs"] = np.full((g["m3"], 3), 1.0 / 3, np.float32)
        if g.get("aamodel"):
            st["aamodel_idx"] = np.zeros((g["aamodel"],), np.int64)
        if g.get("aarevmat"):
            st["aarevmat"] = np.full((g["aarevmat"], 190), 1.0 / 190,
                                     np.float32)
        if g.get("revmat"):
            st["revmat"] = np.full((g["revmat"], 6), 1.0 / 6, np.float32)
            if self._mixed_rev:
                # every submodel starts as full GTR (reference
                # FillNormalParams: gtr submodel 123456)
                st["gtr_class"] = np.tile(np.arange(6, dtype=np.int64),
                                          (g["revmat"], 1))
        if g.get("tratio"):
            st["tratio"] = np.ones((g["tratio"],), np.float32)
        if g.get("shape"):
            st["shape"] = np.full((g["shape"],), 0.5, np.float32)
        if g.get("pinvar"):
            st["pinvar"] = np.full((g["pinvar"],), 0.1, np.float32)
        if self.ratemult_on:
            st["ratemult"] = self.div_char_frac.astype(np.float32)
        return st

    def init_chains(self, seed: int | None = None):
        """Starting states for all runs × chains, on the engine's device,
        plus the bookkeeping dict.  Every process of a ``chains`` mesh
        draws and scores all of them alike and keeps its slice in
        ``parallel/mesh.py:shard_chains``."""
        seed = self.mcmc.seed if seed is None else seed
        rng = np.random.default_rng(seed)
        per = [self.init_state(rng) for _ in range(self.mcmc.n_chains_total)]
        states = {k: torch.as_tensor(np.stack([p[k] for p in per]),
                                     device=self.device) for k in per[0]}
        states = self.score(self.refresh_eigs(states))
        return states, self.init_bookkeeping(seed)

    def init_bookkeeping(self, seed: int, swapseed: int | None = None):
        """Generators, temperatures, tuning and move/swap counters.
        ``rng`` (proposals, acceptance) is this process's own: seeded with
        ``mesh.rank_seed(seed, rank)``, ``seed`` itself without a process
        group and on rank 0; ``rng_host`` (the move sequence) and
        ``rng_swap`` are seeded alike on every rank."""
        from ..parallel.mesh import process_index, rank_seed
        dev = self.device
        mc = self.mcmc
        nt, nm = mc.n_chains_total, len(self.moves)
        swapseed = mc.swapseed if swapseed is None else swapseed

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        return {
            "rng": torch.Generator(device=dev).manual_seed(
                rank_seed(seed, process_index())),
            "rng_host": torch.Generator().manual_seed(seed),
            "rng_swap": torch.Generator(device=dev).manual_seed(swapseed),
            "temp_id": torch.arange(mc.nchains, device=dev).repeat(
                mc.nruns),
            "tuning": torch.tensor([float(m.tuning0) for m in self.moves],
                                   dtype=torch.float32,
                                   device=dev).repeat(nt, 1),
            "tries": zeros(nt, nm),
            "accepts": zeros(nt, nm),
            "tries_total": zeros(nt, nm),
            "accepts_total": zeros(nt, nm),
            "swap_tries": zeros(mc.nruns, mc.nchains, mc.nchains),
            "swap_accepts": zeros(mc.nruns, mc.nchains, mc.nchains),
            "batch": 0,
            "gen": 0,
            "power": 1.0,
        }

    def score(self, states):
        """States with lnL, lnP_tree, lnP_par and lnP recomputed exactly."""
        lnL = self.log_likelihood(states)
        lnP_tree = self.log_prior_tree(states)
        lnP_par = self.log_prior_params(states)
        return {**states, "lnL": lnL, "lnP": lnP_tree + lnP_par,
                "lnP_tree": lnP_tree, "lnP_par": lnP_par}

    # ------------------------------------------------------------------
    # densities

    def _division_pi(self, state, i):
        cfg = self.div_cfg[i]
        if cfg.pi_group >= 0:
            return state[cfg.pi_field][:, cfg.pi_group]
        if cfg.aamodel_group >= 0:
            return self._aa_stack[1][state["aamodel_idx"][:, cfg.aamodel_group]]
        return self._fixed_pi[i].expand(state["parent"].shape[0], -1)

    def _division_q_pi(self, state, i):
        """(Q, pi) of division i for every chain (reference SetNucQMatrix
        inputs, src/likelihood.c:8166): Q [C, S, S], or [C, K, S, S] for a
        codon division, one generator per omega class."""
        cfg = self.div_cfg[i]
        pi = self._division_pi(state, i)
        nst = cfg.settings.nst
        if cfg.codon is not None:
            Q = self._codon_q(state, i, pi)
        elif cfg.doublet:
            Q = doublet_q(self._doublet_rates(state, cfg, pi), pi,
                          self._doublet_cls)
        elif cfg.div.dtype is DataType.PROTEIN:
            if cfg.aamodel_group >= 0:
                exch = self._aa_stack[0][
                    state["aamodel_idx"][:, cfg.aamodel_group]]
            elif cfg.aarevmat_group >= 0:
                exch = state["aarevmat"][:, cfg.aarevmat_group]
            else:
                exch = self._aa_exch[i]
            Q = protein_q(exch, pi)
        elif cfg.div.dtype is DataType.STANDARD:
            Q = self._standard_q(cfg, pi)
        elif cfg.div.dtype is DataType.RESTRICTION:
            Q = binary_q(pi)
        elif nst == "1":
            Q = nuc_q_nst1(pi)
        elif nst == "2":
            Q = nuc_q_nst2(state["tratio"][:, cfg.tratio_group], pi)
        else:
            Q = nuc_q_gtr(state["revmat"][:, cfg.revmat_group], pi)
        return Q, pi

    @staticmethod
    def _doublet_rates(state, cfg, pi):
        """A doublet division's GTR 6-vector [C, 6] (mrbayes_tpu engine
        :2270-2279): the sampled revmat, (1, k, 1, 1, k, 1) under nst=2,
        ones under nst=1."""
        if cfg.revmat_group >= 0:
            return state["revmat"][:, cfg.revmat_group]
        r6 = pi.new_ones(pi.shape[:-1] + (6,))
        if cfg.tratio_group >= 0:
            kap = state["tratio"][:, cfg.tratio_group, None]
            r6 = torch.cat([r6[:, :1], kap, r6[:, 2:4], kap, r6[:, 5:]], -1)
        return r6

    @staticmethod
    def _standard_q(cfg, pi):
        """A standard bucket's Mk generator: ordered (adjacent states only,
        ``ctype ordered``) or unordered (mrbayes_tpu engine.py:2309-2311)."""
        q = ordered_mk_q if cfg.div.ctype == "ordered" else mk_q
        return q(cfg.div.n_states, pi)

    def _codon_q(self, state, i, pi):
        """A codon division's generators [C, K, S, S] (mrbayes_tpu engine
        :2248-2267): M0's one omega, or NY98's omega1 < 1, 1 and
        omega3 > 1, M3's three ordered omegas or M10's B + G class omegas,
        normalised together under the class frequencies, with kappa under
        nst=2."""
        cfg = self.div_cfg[i]
        kappa = (state["tratio"][:, cfg.tratio_group]
                 if cfg.tratio_group >= 0 else 1.0)
        omegas, weights = self._codon_omegas(state, cfg)
        return codon_q(omegas, kappa, pi, *self._codon_classes[i],
                       cat_weights=weights)

    def _codon_omegas(self, state, cfg):
        """A codon division's class omegas [C, K] and class weights [C, K]
        (None for M0's one class): NY98's omega1, 1 and omega3, M3's three
        ordered omegas or M10's B + G classes."""
        if cfg.ny98_group >= 0:
            g = cfg.ny98_group
            w1 = state["omega1"][:, g]
            return (torch.stack([w1, torch.ones_like(w1),
                                 state["omega3"][:, g]], -1),
                    state["omegaprobs"][:, g])
        if cfg.m3_group >= 0:
            return (state["m3omega"][:, cfg.m3_group],
                    state["m3probs"][:, cfg.m3_group])
        if cfg.m10_group >= 0:
            return self._m10_omegas_weights(state, cfg)
        return state["omega"][:, cfg.omega_group][:, None], None

    def _codon_cat_weights(self, state, cfg):
        """The omega classes' weights [C, K] of a codon division (None for
        M0's one class)."""
        if cfg.ny98_group >= 0:
            return state["omegaprobs"][:, cfg.ny98_group]
        if cfg.m3_group >= 0:
            return state["m3probs"][:, cfg.m3_group]
        if cfg.m10_group >= 0:
            return self._m10_weights(state, cfg)
        return None

    @staticmethod
    def _m10_weights(state, cfg):
        """M10's class weights [C, B + G]: p_k / n_k (reference
        src/model.c:11608-11611), without the class omegas' bisection."""
        B, G = cfg.settings.nm10betacat, cfg.settings.nm10gammacat
        p = state["m10catprobs"][:, cfg.m10_group]
        return torch.cat([p[:, :1].expand(-1, B) / B,
                          p[:, 1:].expand(-1, G) / G], -1)

    def _m10_omegas_weights(self, state, cfg):
        """M10's class omegas and weights [C, B + G] (mrbayes_tpu engine
        :2218-2238; reference BetaBreaks and DiscreteGamma + 1,
        src/model.c:11637-11643, weights p_k / n_k :11608-11611): the
        median-of-class quantiles of Beta(ab, bb), then 1 plus the class
        means of Gamma(ag, bg), which are the mean-1 table's at ag times
        ag / bg."""
        g = cfg.m10_group
        B = cfg.settings.nm10betacat
        G = cfg.settings.nm10gammacat
        ab, bb = state["m10beta"][:, g].unbind(-1)
        ag, bg = state["m10gamma"][:, g].unbind(-1)
        w_beta = beta_quantile_breaks(ab, bb, B)
        w_gamma = 1.0 + self._gamma_tables[G](ag) \
            * (ag / bg.clamp_min(1e-6))[:, None]
        return (torch.cat([w_beta.to(w_gamma.dtype), w_gamma], -1),
                self._m10_weights(state, cfg))

    def _division_eig(self, state, i):
        """Division i's eigensystem for every chain: lam [C, S] with U,
        Uinv [C, S, S], or lam [C, K, S] with [C, K, S, S] for a codon
        division.  Under aamodelpr=mixed, each chain's model's precomputed
        eigensystem; a binary symdirihyperpr character's (``_symdiri_eig``)
        has its category frequencies as a fourth element."""
        cfg = self.div_cfg[i]
        if cfg.symdiri and cfg.sympi_group < 0:
            return self._symdiri_eig(self._symdiri_beta(state, i), i)
        if cfg.aamodel_group >= 0:
            idx = state["aamodel_idx"][:, cfg.aamodel_group]
            return tuple(x[idx] for x in self._aa_stack[2:])
        if cfg.covarion:
            return eigh_reversible(*self._covarion_q_pi(state, i))
        if cfg.sympi_group >= 0:
            pi = state[cfg.sympi_field][:, cfg.sympi_group]
            return eigh_reversible(mk_q(cfg.div.n_states, pi), pi)
        Q, pi = self._division_q_pi(state, i)
        return eigh_reversible(Q, pi if Q.ndim == 3 else pi[:, None])

    def _symdiri_eig(self, beta, i):
        """A binary symdirihyperpr character's beta categories (mrbayes_tpu
        engine.py:2659-2666): the frequencies [C, B, 2] of the symmetric
        Beta(beta, beta)'s B category quantiles q as [q, 1 - q] and their
        F81 eigensystems lam [C, B, 2], U, Uinv [C, B, 2, 2]."""
        q = beta_category_freqs(beta, self.div_cfg[i].settings.nbetacat)
        q = q.to(torch.float32)
        pis = torch.stack([q, 1.0 - q], -1)
        return (*eigh_reversible(binary_q(pis), pis), pis)

    def _symdiri_beta(self, state, i):
        cfg = self.div_cfg[i]
        return state["symbeta"][:, cfg.symbeta_group]

    def _covswitch(self, state, i):
        """Division i's covarion switch rates (s01, s10) [C|1, 2]."""
        cfg = self.div_cfg[i]
        if cfg.covswitch_group >= 0:
            return state["covswitch"][:, cfg.covswitch_group]
        return self._fixed_covswitch[i]

    def _covarion_q_pi(self, state, i):
        """A covarion division's generators [C, K, 2S, 2S], one a rate
        category, and the doubled frequencies [C, 1, 2S]
        (``_covarion_loglik``, mrbayes_tpu engine.py:2679-2709; reference
        TiProbs_GenCov src/likelihood.c:9568, UpDateCijk :10511-10522):
        the category rate times the rate multiplier scales the
        substitution block only, the switch rates stay as they are."""
        cfg = self.div_cfg[i]
        Q, pi = self._division_q_pi(state, i)
        rates = self._category_rates(state, cfg)
        if self.ratemult_on:
            rates = rates * self._rate_mult(state, i)[:, None]
        sw = self._covswitch(state, i)
        return covarion_q(Q[:, None], pi[:, None], sw[:, :1], sw[:, 1:],
                          rates)

    def _covarion_pi(self, state, i):
        """A covarion division's doubled stationary frequencies [C, 2S]:
        pi times probOn, then pi times 1 - probOn."""
        pi = self._division_pi(state, i)
        sw = self._covswitch(state, i)
        on = sw[:, :1] / (sw[:, :1] + sw[:, 1:])
        return torch.cat([pi * on, pi * (1.0 - on)], -1)

    def _eig_plan(self, divs):
        """(plan, keys) of ``refresh_eigs(state, divs)``: [(division,
        key)] of every division it refreshes, keyed by what its
        eigensystem depends on, and the number of distinct keys, the
        eigensystems it computes a chain; built once a ``divs``."""
        got = self._eig_plans.get(divs)
        if got is None:
            plan = []
            for i in range(self.n_div) if divs is None else divs:
                cfg = self.div_cfg[i]
                if i in self._const_eigs or not cfg.prunes:
                    continue
                plain = (cfg.div.dtype in (DataType.DNA, DataType.RNA)
                         and cfg.codon is None and not cfg.doublet
                         and not cfg.covarion)
                plan.append((i, self._eig_key(i) if plain else ("own", i)))
            got = self._eig_plans[divs] = (plan, len({k for _, k in plan}))
        return got

    def refresh_eigs(self, state, divs=None):
        """(Re)compute the cached eigensystems of divisions ``divs`` (every
        division when None).  The cache lives in the chain state so it
        rides accept/reject; only moves that change an eigensystem call
        this (reference upDateCijk, src/likelihood.c:10476).  Plain
        nucleotide divisions whose Q has the same inputs (``_eig_key``:
        BEST's genes under one linked model) share one computation."""
        out, done = dict(state), {}
        plan, _ = self._eig_plan(None if divs is None else tuple(divs))
        for i, key in plan:
            if key not in done:
                done[key] = self._division_eig(state, i)
            # eigL, eigU, eigV and a binary symdiri character's category
            # frequencies eigP
            for k, x in zip("LUVP", done[key]):
                out[f"eig{k}{i}"] = x
        return out

    def _row_of(self, name: str):
        """Division i -> the row of the group a Q move named ``name``
        draws (-1: none of its rows), or None where the move draws no
        group row (it changes every division it refreshes)."""
        field = name.rsplit("_", 1)[0]
        if field in PI_FIELDS:
            return lambda i: (self.div_cfg[i].pi_group
                              if self.div_cfg[i].pi_field == field else -1)
        if field.startswith("sympi"):
            return lambda i: (self.div_cfg[i].sympi_group
                              if self.div_cfg[i].sympi_field == field
                              else -1)
        attr = _ROW_GROUPS.get(field)
        if attr is None:
            return None
        return lambda i: getattr(self.div_cfg[i], attr)

    def _eig_rows_changed(self, m: int):
        """The eigensystems a chain's proposal of Q move ``m`` changes
        among those its refresh computes: a move that draws one row of a
        group changes those of the divisions linked to the row, any other
        all of them.  An int where every row is linked to as many; else
        [rows] long counts a row, for the device tally."""
        got = self._eig_changes.get(m)
        if got is None:
            spec = self.moves[m]
            plan, n_keys = self._eig_plan(spec.eig_divs)
            row = self._row_of(spec.name)
            got = n_keys
            if row is not None:
                linked: dict = {}
                for i, key in plan:
                    linked.setdefault(row(i), set()).add(key)
                n_rows = 1 + max(row(i) for i in range(self.n_div))
                counts = [len(linked.get(r, ())) for r in range(n_rows)]
                if counts:
                    got = (counts[0] if len(set(counts)) == 1 else
                           torch.tensor(counts, device=self.device))
            self._eig_changes[m] = got
        return got

    def _count_eig_rows(self, divs, cur, tried):
        """Count a generation's refresh of ``divs``: ``eig_rows``, the
        (eigensystem, chain) pairs it computes, and ``eig_rows_changed``,
        those whose inputs the proposing move changed in that chain.
        ``tried``: (Q move, its proposal, the number of chains that made
        it and their mask [C], both None for all).  Counted on the host,
        except where a move's rows are linked to unequal numbers of
        eigensystems: there the rows its proposal changed are tallied on
        the device."""
        C = cur["parent"].shape[0]
        SPANS.add("eig_rows", C * self._eig_plan(divs)[1])
        for m, new, n, mask in tried:
            changed = self._eig_rows_changed(m)
            if not torch.is_tensor(changed):
                SPANS.add("eig_rows_changed", changed * (C if n is None
                                                         else n))
                continue
            G = changed.shape[0]
            rows = None
            for k, old in cur.items():
                nv = new[k]
                if nv is not old and nv.ndim >= 2 and nv.shape[1] == G:
                    d = (nv != old).reshape(C, G, -1).any(-1)
                    rows = d if rows is None else rows | d
            if rows is None:
                continue
            if mask is not None:
                rows = rows & mask[:, None]
            t = (rows.to(torch.int64) * changed).sum()
            self._eig_tally = t if self._eig_tally is None \
                else self._eig_tally + t

    def take_eig_tally(self) -> int:
        """The device tally of changed eigensystems since the last take (0
        where none was kept), to read once the device has finished: the
        run driver adds it to ``eig_rows_changed`` after a block's
        gather."""
        t, self._eig_tally = self._eig_tally, None
        return 0 if t is None else int(t)

    def _division_eig_cached(self, state, i):
        """``_division_eig`` from the state's cache, the constant one, or
        computed."""
        if f"eigL{i}" in state:
            return tuple(state[f"eig{k}{i}"] for k in "LUVP"
                         if f"eig{k}{i}" in state)
        if i in self._const_eigs:
            C = state["parent"].shape[0]
            return tuple(x.expand(C, *x.shape[1:])
                         for x in self._const_eigs[i])
        return self._division_eig(state, i)

    def log_likelihood(self, state):
        """lnL [C] of every chain."""
        if not self.mcmc.use_data:
            # mcmc data=no: prior-only sampling
            return self._zeros(state)
        if self.best:
            return self._gene_lnls(state, self.weights).sum(0)
        total = 0.0
        for term in self._division_terms(state, self.weights):
            total = total + term
        return total

    def division_lnls(self, state):
        """lnL [C, n_div] float64 of every chain and data division, each
        division through the path ``log_likelihood`` takes for it.  The
        weighted sums over patterns are taken in float64 (float64 weights
        promote them), so two paths compare below float32's spacing of a
        large division's total."""
        weights = [w.double() for w in self.weights]
        if self.best:
            return self._gene_lnls(state, weights).transpose(0, 1)
        return torch.stack(self._division_terms(state, weights), -1)

    def gene_blens(self, state):
        """BEST's gene-tree branch lengths [C, G, n_nodes] from their ages,
        with no clock rate (mrbayes_tpu engine.py:2366-2368)."""
        par, age = state["parent"], state["age"]
        return torch.where(par >= 0, age.gather(-1, par.clamp_min(0)) - age,
                           0.0)

    def gene_view(self, state, g: int):
        """``state`` with gene g's tree fields [C, n_nodes]."""
        return {**state, **{f: state[f][:, g] for f in GENE_FIELDS}}

    def _gene_lnls(self, state, weights):
        """Each gene's lnL [G, C] under the pattern ``weights``: through the
        gene stack, or each gene through its own pruner (mrbayes_tpu
        engine.py:2359-2373)."""
        if self._gene_stack is None:
            blen = self.gene_blens(state)
            return torch.stack([self._division_lnL(
                self.gene_view(state, i), i, blen[:, i], weights[i])
                for i in range(self.n_div)])
        return self._gene_stack_lnls(state, weights)

    def _per_gene(self, state, key, value):
        """[G, C, ...]: ``value(i)`` ([C|1, ...]) of every gene i, computed
        once per distinct ``key(i)`` (the genes of one link group share
        it)."""
        C = state["parent"].shape[0]
        cache, rows = {}, []
        for i in range(self.n_div):
            k = key(i)
            if k not in cache:
                x = value(i)
                cache[k] = x.expand(C, *x.shape[1:])
            rows.append(cache[k])
        if len(cache) == 1:
            return rows[0][None].expand(self.n_div, *rows[0].shape)
        return torch.stack(rows)

    def _eig_key(self, i):
        """What division i's eigensystem depends on, a plain nucleotide
        division being the gene stack's: its frequencies and rates."""
        c = self.div_cfg[i]
        return (c.pi_field, c.pi_group if c.pi_group >= 0 else ("fixed", i),
                c.revmat_group, c.tratio_group, c.settings.nst)

    def gene_stack_operands(self, state):
        """The gene stack's inputs at ``state``: the G * C gene trees'
        postorder, left and right [G * C, ...] (gene-major) and their
        transition matrices P [G * C, n_nodes, K, S, S] in one
        ``branch_tiprobs`` (the counterpart of the JAX engine's vmapped
        P(t), engine.py:1093-1140), then each gene's root frequencies
        [G, C, S] and pinvar ([G * C] or 0.0)."""
        G, C = self.n_div, state["parent"].shape[0]
        cfg = self.div_cfg

        def flat(x):
            return x.reshape(G * C, *x.shape[2:])

        def trees(x):
            return flat(x.transpose(0, 1))

        lam, U, Uinv = (flat(self._per_gene(
            state, self._eig_key,
            lambda i, j=j: self._division_eig_cached(state, i)[j]))
            for j in range(3))
        pi = self._per_gene(state, lambda i: (cfg[i].pi_field,
                                              cfg[i].pi_group
                                              if cfg[i].pi_group >= 0 else i),
                            lambda i: self._division_pi(state, i))
        rates = flat(self._per_gene(
            state, lambda i: cfg[i].shape_group,
            lambda i: self._category_rates(state, cfg[i])))
        pinv = 0.0
        if self._gene_cmask is not None:
            pinv = flat(self._per_gene(
                state, lambda i: cfg[i].pinvar_group,
                lambda i: state["pinvar"][:, cfg[i].pinvar_group]))
        mult = (flat((state["ratemult"] / self._gene_frac).transpose(0, 1))
                if self.ratemult_on else 1.0)
        P = branch_tiprobs(trees(self.gene_blens(state)), lam, U, Uinv,
                           rates, pinv, mult)
        parent = trees(state["parent"])
        return (postorder_internal(parent, self.n_tips), trees(state["left"]),
                trees(state["right"]), P, pi, pinv)

    def _gene_stack_lnls(self, state, weights):
        """Every gene's lnL [G, C] in one pass: ``gene_stack_operands``,
        one ``stacked.cu`` launch with a tree a member
        (``PruningCudaGeneStack``) and one root reduction over the genes
        padded to the longest, pad weight 0."""
        G, C = self.n_div, state["parent"].shape[0]
        gs = self._gene_stack
        with SPANS("gen.lnl.operands"):
            order, left, right, P, pi, pinv = self.gene_stack_operands(state)
            out = gs(order, left, right, P)
        root, ls = gs.padded(*out)
        pi_f = pi.reshape(G * C, -1)
        ln_site = site_loglik_from_root(root, ls, pi_f, pinv, None)
        if self._gene_cmask is not None:
            const_l = torch.einsum("gps,gcs->gcp", self._gene_cmask, pi)
            ln_site = pinvar_mix(ln_site, const_l.reshape(G * C, -1), pinv)
        if weights is self.weights:
            w = self._gene_wpad
        else:
            w = torch.stack([torch.nn.functional.pad(
                x, (0, gs.P_max - x.shape[0])) for x in weights])
        return (ln_site.view(G, C, -1) * w[:, None, :]).sum(-1)

    def _division_terms(self, state, weights):
        """Each data division's lnL [C] under the pattern ``weights``, in
        division order: multiwalk groups first, then stacked groups that
        share no division with them (mrbayes_tpu/mcmc/engine.py:2394-2406),
        then every other division through its own pruner."""
        if self.n_trees > 1:
            # unlinked trees: each division prunes its own tree
            views = [self.tree_view(state, t) for t in range(self.n_trees)]
            blens = [v["blen"] for v in views]
        else:
            views, blens = [state], [self.branch_lengths(state)]
        pars = self._pars_lnls(views)
        terms = [pars.get(i) for i in range(self.n_div)]
        for idxs, gpruner in self._multiwalk_pruners + self._stacked_pruners:
            if any(terms[i] is not None for i in idxs):
                continue
            for i, term in zip(idxs, self._group_lnl(state, blens[0], idxs,
                                                     gpruner, weights)):
                terms[i] = term
        for i, t in enumerate(self.div_tree):
            if terms[i] is None:
                terms[i] = self._division_lnL(views[t], i, blens[t],
                                              weights[i])
        return terms

    def _group_lnl(self, state, blen, idxs, gpruner, weights):
        """One launch for a group of divisions sharing the tree (multiwalk
        or stacked), then each division's root reduction with its coding
        correction (mrbayes_tpu/mcmc/engine.py:2413-2474), with each
        division's own K_d, S_d and P_d: the members' lnL [C] in group
        order."""
        P_list, metas = [], []
        with SPANS("gen.lnl.operands"):
            for i in idxs:
                pi, coding, lam, U, Uinv, rates, pinv, cmask, mult = \
                    self._generic_div_params(state, i)
                P_list.append(branch_tiprobs(
                    blen, lam, U, Uinv, rates,
                    pinv if cmask is not None else 0.0, mult))
                metas.append((pi, coding, pinv, cmask))
            order = postorder_internal(state["parent"], self.n_tips)
            root, ls = gpruner(order, state["left"], state["right"], P_list)
        terms = []
        for gi, i in enumerate(idxs):
            pi, coding, pinv, cmask = metas[gi]
            r, ls_d = gpruner.div_view(root, ls, gi)      # [C,K,S,P], [C,P]
            S = r.shape[2]
            if coding != "all" and cmask is not None:
                # the dummy patterns are constant, one per state
                cmask = torch.cat([cmask, torch.eye(
                    S, dtype=cmask.dtype, device=cmask.device)], 0)
            ln_site = site_loglik_from_root(r, ls_d, pi, pinv, cmask)
            if coding == "all":
                terms.append((weights[i] * ln_site).sum(-1))
            else:
                terms.append(coding_total(ln_site[:, :-S], ln_site[:, -S:],
                                          weights[i], coding))
        return terms

    def _root_pi(self, state, i):
        """The frequencies division i's root reduction (and coding-dummy
        sum) weights with [C, S]: the stationary ones, or under
        statefreqmodel=directional the root frequencies, and under mixed
        those of the chains in the directional state (mrbayes_tpu
        engine.py:2501-2513; reference Likelihood_Res,
        src/likelihood.c:7155-7165).  Q and P(t) stay built from the
        stationary frequencies."""
        cfg = self.div_cfg[i]
        pi = self._division_pi(state, i)
        if not cfg.directional:
            return pi
        rpi = (state["rootpi2"][:, cfg.rootpi_group]
               if cfg.rootpi_group >= 0
               else self._fixed_rootpi[i].expand_as(pi))
        if cfg.dirpi_mix:
            on = state["dirpi_on"][:, cfg.rootpi_group, None] > 0
            return torch.where(on, rpi, pi)
        return rpi

    def _generic_div_params(self, state, i):
        """(pi, coding, lam, U, Uinv, rates, pinv, cmask, mult) of a
        division — the inputs division_loglik needs beyond the tree, with
        the division's resolved ascertainment coding."""
        cfg = self.div_cfg[i]
        pi = self._root_pi(state, i)
        lam, U, Uinv = self._division_eig_cached(state, i)
        rates = self._category_rates(state, cfg)
        if cfg.pinvar_group >= 0:
            # gamma rates describe the variable fraction
            pinv = state["pinvar"][:, cfg.pinvar_group]
            cmask = self.const_masks[i]
        else:
            pinv, cmask = 0.0, None
        # a doublet site spans two nucleotide columns while branch lengths
        # stay in substitutions per nucleotide (reference TiProbs_Gen
        # correctionFactor 2, src/likelihood.c:9437-9443)
        mult = (2.0 if cfg.doublet else 1.0) * self._rate_mult(state, i)
        return pi, cfg.coding, lam, U, Uinv, rates, pinv, cmask, mult

    def _rate_mult(self, state, i):
        """Division i's rate multiplier [C] (1.0 when fixed): the stored
        simplex is weighted by the character fractions, the branch-length
        multiplier has mean 1 over characters."""
        if not self.ratemult_on:
            return 1.0
        return state["ratemult"][:, i] / float(self.div_char_frac[i])

    def _category_rates(self, state, cfg):
        """The rate categories [C|1, K] of a division (mrbayes_tpu
        engine.py:2518-2529): discrete gamma (gamma, invgamma, adgamma) or
        lognormal (lnorm) on the shape group, the kmixture simplex times K
        (not under covarion), else one unit rate."""
        if cfg.mixt_group >= 0 and not cfg.covarion:
            return state["mixtrates"][:, cfg.mixt_group] * cfg.n_rate_cats
        if cfg.shape_group < 0:
            return self._unit_rates
        tables = (self._lnorm_tables if cfg.settings.rates == "lnorm"
                  else self._gamma_tables)
        return tables[cfg.n_rate_cats](state["shape"][:, cfg.shape_group])

    def _division_lnL(self, state, i, blen, weights):
        cfg = self.div_cfg[i]
        if cfg.continuous:
            return self._brownian_lnL(state, i, blen)
        if cfg.symdiri:
            return self._symdiri_lnL(state, i, blen, weights)
        if cfg.codon is not None:
            return self._codon_lnL(state, i, blen, weights)
        if cfg.covarion:
            return self._covarion_lnL(state, i, blen, weights)
        if cfg.ratecorr_group >= 0:
            return self._adgamma_lnL(state, i, blen)
        pi, coding, lam, U, Uinv, rates, pinv, cmask, mult = \
            self._generic_div_params(state, i)
        return division_loglik(
            state["left"], state["right"], state["parent"], blen,
            self.tip_partials[i], weights, lam, U, Uinv, pi, rates,
            pinv, cmask, self.n_tips, rate_mult=mult, coding=coding,
            pruner=self._pruners[i])

    def _codon_lnL(self, state, i, blen, weights):
        """A codon division's lnL [C] (mrbayes_tpu engine :2752-2777): the
        omega classes on the category axis with unit rates, weighted by
        the NY98, M3 or M10 class weights (equal for M0's one class),
        branch lengths scaled by 3 (they are per nucleotide and a codon
        site evolves three times as fast), no pinvar."""
        cfg = self.div_cfg[i]
        lam, U, Uinv = self._division_eig_cached(state, i)
        cat_w = self._codon_cat_weights(state, cfg)
        mult = 3.0 * self._rate_mult(state, i)
        return division_loglik(
            state["left"], state["right"], state["parent"], blen,
            self.tip_partials[i], weights, lam, U, Uinv,
            self._division_pi(state, i), self._unit_rates.expand(
                1, cfg.n_cats), 0.0, None, self.n_tips, rate_mult=mult,
            cat_weights=cat_w, pruner=self._pruners[i])

    def _covarion_lnL(self, state, i, blen, weights):
        """A covarion division's lnL [C] (mrbayes_tpu engine :2679-2709):
        the per-category eigensystems (their rates and the rate multiplier
        inside) with unit category rates, no pinvar, the doubled
        stationary frequencies at the root."""
        K = self.div_cfg[i].n_cats
        lam, U, Uinv = self._division_eig_cached(state, i)
        return division_loglik(
            state["left"], state["right"], state["parent"], blen,
            self.tip_partials[i], weights, lam, U, Uinv,
            self._covarion_pi(state, i), self._unit_rates.expand(1, K), 0.0,
            None, self.n_tips, pruner=self._pruners[i])

    def _symdiri_lnL(self, state, i, blen, weights):
        """A standard division's lnL [C] under symdirihyperpr
        (``_std_symdiri_loglik``, mrbayes_tpu engine.py:2619-2677): a
        multistate character's sampled frequencies in its Mk generator and
        at the root; a binary one's B beta categories folded into the
        category axis next to its K rate categories (category b K + k: the
        b-th eigensystem, the k-th rate), each weighted at the root (and in
        the coding dummies' sum) by its own [q_b, 1 - q_b].  Gamma, invgamma
        or lnorm rates give the categories' rates (pinvar unread), other
        rates K unit ones."""
        lam, U, Uinv, pi, rates = self._symdiri_operands(state, i)
        return division_loglik(
            state["left"], state["right"], state["parent"], blen,
            self.tip_partials[i], weights, lam, U, Uinv, pi, rates, 0.0,
            None, self.n_tips, rate_mult=self._rate_mult(state, i),
            coding=self.div_cfg[i].coding, pruner=self._pruners[i])

    def _symdiri_operands(self, state, i):
        """(lam, U, Uinv, pi, rates) of a symdirihyperpr division: its
        eigensystem(s), root frequencies and category rates, a binary
        character's B beta categories repeated over its K rate categories
        (category b K + k)."""
        cfg = self.div_cfg[i]
        K = cfg.n_rate_cats
        rates = (self._category_rates(state, cfg) if cfg.settings.rates in
                 ("gamma", "invgamma", "lnorm")
                 else self._unit_rates.expand(1, K))
        eig = self._division_eig_cached(state, i)
        if cfg.sympi_group >= 0:
            return (*eig, state[cfg.sympi_field][:, cfg.sympi_group], rates)
        # a binary character's eigensystems and frequencies per beta
        # category, repeated over the rate categories
        lam, U, Uinv, pi = (x.repeat_interleave(K, 1) for x in eig)
        return (lam, U, Uinv, pi.expand(lam.shape[0], -1, -1),
                rates.repeat(1, cfg.settings.nbetacat))

    def pruner_operands(self, state, i):
        """(P, pi): the per-branch, per-category transition matrices [C,
        n_nodes, K, S, S] division i's pruner takes at ``state`` and the
        frequencies of its root reduction, as its likelihood builds them
        (a generic, lnorm, kmixture, adgamma or symdirihyperpr division),
        for measuring the kernel at the engine's own operands."""
        blen = self.branch_lengths(state)
        if self.div_cfg[i].symdiri:
            lam, U, Uinv, pi, rates = self._symdiri_operands(state, i)
            return branch_tiprobs(blen, lam, U, Uinv, rates, 0.0,
                                  self._rate_mult(state, i)), pi
        pi, _, lam, U, Uinv, rates, pinv, cmask, mult = \
            self._generic_div_params(state, i)
        return branch_tiprobs(blen, lam, U, Uinv, rates,
                              pinv if cmask is not None else 0.0, mult), pi

    def _adgamma_lnL(self, state, i, blen):
        """An autocorrelated-gamma division's lnL [C] (``_adgamma_loglik``,
        mrbayes_tpu engine.py:2711-2750; reference Likelihood_Adgamma
        src/likelihood.c:5692, CalcLikeAdgamma src/mcmc.c:1575): one
        pruning pass for the per-pattern category likelihoods at the root,
        then the category HMM along the sites in their original order
        (``adgamma_loglik_from_cats``), its transition matrix's powers
        M^j for the distinct site distances j by repeated squaring."""
        cfg = self.div_cfg[i]
        lam, U, Uinv = self._division_eig_cached(state, i)
        rates = self._category_rates(state, cfg)
        out = root_clv(state["left"], state["right"], state["parent"], blen,
                       self.tip_partials[i], lam, U, Uinv, rates, 0.0,
                       self.n_tips, self._rate_mult(state, i),
                       pruner=self._pruners[i])
        if isinstance(out, list):
            # a site-sharded pruner's (root, logscale) per shard, in
            # pattern order: the HMM needs every site
            out = tuple(torch.cat([x[j].to(self.device, non_blocking=True)
                                   for x in out], -1) for j in (0, 1))
        return self._adgamma_from_root(state, i, *out)

    def _adgamma_from_root(self, state, i, root, ls):
        """The adgamma HMM of division i [C] from its root partials [C, K,
        S, P] and log scalers [C, P]."""
        cfg = self.div_cfg[i]
        pi = self._division_pi(state, i)
        rP = torch.matmul(pi[:, None, None, :], root)[:, :, 0]   # [C, K, P]
        poc, jump_idx, jumps = self._adg_maps[i]
        M = self._adg_trans[cfg.n_rate_cats](
            state["ratecorr"][:, cfg.ratecorr_group])
        cache = {1: M}

        def mpow(j):
            if j not in cache:
                h = mpow(j // 2)
                cache[j] = h @ h if j % 2 == 0 else h @ h @ M
            return cache[j]

        pows = torch.stack([mpow(j) for j in jumps], 1)   # [C, U, K, K]
        return adgamma_loglik_from_cats(rP[:, :, poc].transpose(1, 2),
                                        ls[:, poc], pows, jump_idx)

    def _brownian_lnL(self, state, i, blen):
        """A continuous division's lnL [C] (``_brownian_lnL``, mrbayes_tpu
        engine.py:2607-2617): the REML density of independent contrasts
        (``ops/brownian.py``) with the sampled variance rate sigma^2; no
        rate multiplier (sigma^2 absorbs the scale)."""
        sigma2 = state["brownscale"][:, self.div_cfg[i].brownscale_group]
        return pic_logpdf(state["left"], state["right"], state["parent"],
                          blen, self._cont_values[i], sigma2, self.n_tips)

    def _pars_lnls(self, views):
        """The parsimony-model divisions' lnL [C] by division (``_pars_lnL``,
        mrbayes_tpu engine.py:2577-2605; reference Likelihood_Pars,
        src/likelihood.c:7593): -(T + n) log k with T the division's
        weighted Fitch length and n its character count.  One Fitch pass a
        tree covers all of its parsimony-model divisions' patterns side by
        side (``moves._fitch``, int64 state sets), the root's step (tip 0
        against the basal node of the rooted-at-tip-0 layout) included;
        the changes are counted per pattern and weighted per division."""
        out = {}
        for t, masks, members in self._pars_lnl:
            st = views[t]
            _, changes = M._fitch(masks, st["parent"], st["left"],
                                  st["right"], self.n_tips, count=True)
            for i, lo, hi, w, n_chars, log_k in members:
                out[i] = -(changes[:, lo:hi] @ w + n_chars) * log_k
        return out

    def log_prior(self, state):
        """Full log prior [C] = tree component + parameter component."""
        return self.log_prior_tree(state) + self.log_prior_params(state)

    def log_prior_params(self, state):
        """Prior over the substitution-model parameter groups."""
        return self._grouped_params_prior(state)

    def _zeros(self, state):
        """float32 zeros [C], one per chain of ``state``."""
        return torch.zeros(state["parent"].shape[0],
                           device=state["parent"].device)

    def branch_lengths(self, state):
        """Substitution-unit branch lengths [C, n_nodes]: the sampled
        ``blen``, or on a clock tree the lengths its ages and rates give
        (mrbayes_tpu engine.py:2374-2378); under BEST the gene trees'
        [C, G, n_nodes]."""
        ts = self.tree_settings
        if self.best:
            return self.gene_blens(state)
        if ts.clock:
            return CL.clock_blens(CL.pin_sa_ages(state, self.n_tips),
                                  self.n_tips, ts.clockvarpr)
        return state["blen"]

    def tree_view(self, state, t: int):
        """``state`` with tree ``t``'s fields [C, n_nodes] in place of the
        unlinked trees' [C, n_trees, n_nodes]."""
        return {**state, **{f: state[f][:, t] for f in TREE_FIELDS}}

    def log_prior_tree(self, state):
        """Prior over the branch lengths of the unrooted tree (the
        uniform topology prior is a constant and dropped), summed over
        unlinked trees, or over a clock tree's ages, rates and
        tree-process parameters (under BEST the joint gene-tree/species-
        tree prior)."""
        if self.best:
            return self._log_prior_best(state)
        if self.tree_settings.clock:
            return self._log_prior_clock(state)
        if self.n_trees > 1:
            return sum(self._log_prior_unrooted(self.tree_view(state, t))
                       for t in range(self.n_trees))
        return self._log_prior_unrooted(state)

    def _log_prior_unrooted(self, state):
        """One unrooted tree's branch-length prior and constraint terms."""
        bp = self.tree_settings.brlenspr
        blen = state["blen"]
        if bp.kind == "gammadir":
            a_t, b_t, a_f, c_i = bp.params
            lp = brlens_gammadir_lpdf(
                blen, self._blen_mask, a_t, b_t, a_f, c_i,
                self._interior if c_i != 1.0 else None)
        elif bp.kind == "exponential":
            lp = brlens_exponential_lpdf(blen, self._blen_mask,
                                         bp.params[0])
        else:
            lp = brlens_uniform_lpdf(blen, self._blen_mask, bp.params[0],
                                     bp.params[1])
        return lp + self._constraint_terms(state)

    def _log_prior_best(self, state):
        """The joint gene-tree/species-tree prior (mrbayes_tpu
        engine.py:2929-2975; reference LnJointGeneTreeSpeciesTreePr,
        src/best.c:775): the MSC density of every gene in one batched call,
        the species tree's clock prior (uniform or birth-death) with its
        parameters' priors, the population sizes' prior, and -inf where a
        parent is not older than its child in the species tree or any gene
        tree."""
        ts = self.tree_settings
        S = self.n_species
        M_sp = 2 * S - 1
        pop = state["popsize"]
        theta = B.ploidy_factor(ts.ploidy) * (
            pop if ts.popvarpr == "variable" else pop[:, :1].expand(-1, M_sp))
        lp = B.msc_gene_log_prior(state["parent"], state["age"],
                                  self.tip_species, state["s_parent"],
                                  state["s_age"], theta, self.n_tips,
                                  S).sum(-1)

        def treeage_lpdf(t1):
            return _scalar_prior_lpdf(ts.treeagepr, t1)

        if ts.clockpr == "birthdeath":
            sp, ex = state["speciation"][:, 0], state["extinction"][:, 0]
            lp = (lp + CL.ln_birthdeath(state["s_age"], S, sp, ex,
                                        ts.sampleprob, treeage_lpdf)
                  + _scalar_prior_lpdf(ts.speciationpr, sp)
                  + _scalar_prior_lpdf(ts.extinctionpr, ex))
        else:
            lp = lp + CL.ln_uniform_clock(state["s_age"], S, treeage_lpdf)
        lp = lp + _scalar_prior_lpdf(ts.popsizepr, pop).sum(-1)
        ok = CL.ages_ordered({"age": state["s_age"],
                              "parent": state["s_parent"]})
        gene = CL.ages_ordered({"age": state["age"].flatten(0, 1),
                                "parent": state["parent"].flatten(0, 1)})
        ok = ok & gene.view(-1, self.n_div).all(1)
        return torch.where(ok, lp, NEG_INF)

    def _log_prior_clock(self, state):
        """A clock tree's prior (mrbayes_tpu engine.py:2977-3050) on its
        pinned ages: the tree prior on the ages (uniform, with dated tips
        or not; birth-death; coalescent; fossilized birth-death) with its
        parameters' priors, the clock rate's, the branch rates' (CPP
        events, or per-branch rates with their variance's), the sampled
        tip ages', the constraint and calibration terms, and -inf where a
        parent is not older than its child."""
        ts = self.tree_settings
        n = self.n_tips
        state = CL.pin_sa_ages(state, n)
        age = state["age"]
        treeage = self._root_calib or ts.treeagepr

        def treeage_lpdf(t1):
            return _scalar_prior_lpdf(treeage, t1)

        cr = state["clockrate"][:, 0] if "clockrate" in state else 1.0
        if ts.clockpr == "fossilization":
            sp, ex, fo = (state[k][:, 0] for k in (
                "speciation", "extinction", "fossilization"))
            lp = (CL.ln_fbd(age, n, sp, ex, fo, ts.sampleprob,
                            self.fossil_tips, treeage_lpdf,
                            strategy=ts.samplestrat, sa=state.get("sa"),
                            parent=state["parent"], fossil=self._fossil)
                  + _scalar_prior_lpdf(ts.speciationpr, sp)
                  + _scalar_prior_lpdf(ts.extinctionpr, ex)
                  + _scalar_prior_lpdf(ts.fossilizationpr, fo))
        elif ts.clockpr == "uniform" and self.has_dated_tips:
            lp = CL.ln_uniform_clock_dated(age, n, self.fossil_tips,
                                           treeage_lpdf, root_dated=False)
        elif ts.clockpr == "uniform":
            lp = CL.ln_uniform_clock(age, n, treeage_lpdf)
        elif ts.clockpr == "birthdeath":
            strat = (ts.samplestrat if ts.samplestrat in
                     ("random", "diversity", "cluster") else "random")
            sp, ex = state["speciation"][:, 0], state["extinction"][:, 0]
            lp = (CL.ln_birthdeath_strat(age, n, sp, ex, ts.sampleprob,
                                         treeage_lpdf, strategy=strat)
                  + _scalar_prior_lpdf(ts.speciationpr, sp)
                  + _scalar_prior_lpdf(ts.extinctionpr, ex))
        else:
            theta = state["popsize"][:, 0]
            if "growth" in state:
                growth = state["growth"][:, 0]
                lp = _scalar_prior_lpdf(ts.growthpr, growth)
            else:
                growth = ts.growthpr.params[0] if ts.growthpr.params else 0.0
                lp = self._zeros(state)
            lp = (lp + CL.ln_coalescence(age, n, theta, growth, cr)
                  + _scalar_prior_lpdf(ts.popsizepr, theta))
        if "clockrate" in state:
            lp = lp + _scalar_prior_lpdf(ts.clockratepr, cr)
        if ts.clockvarpr == "cpp":
            sigma = float((ts.cppmultdevpr.params or (0.4,))[0])
            lam = state["cpprate"][:, 0]
            lp = (lp + CL.ln_cpp_prior(state, n, lam, sigma)
                  + _scalar_prior_lpdf(ts.cppratepr, lam))
        elif ts.clockvarpr != "strict":
            var = state["clockvar"][:, 0]
            lp = (lp + CL.ln_branch_rates_prior(state, n, ts.clockvarpr, var)
                  + _scalar_prior_lpdf(ts.clockvar_prior(), var))
        for ti, pr in self.sampled_tip_ages:
            lp = lp + _scalar_prior_lpdf(pr, age[:, ti])
        lp = lp + self._constraint_terms(state)
        return torch.where(CL.ages_ordered(state), lp, NEG_INF)

    def _grouped_params_prior(self, state):
        lp = self._zeros(state)
        for (param, gid), pr in self.group_priors.items():
            x = state[param][:, gid]
            if param == "revmat" and gid in self._mixed_rev:
                symdir = pr.params[0] if pr.params else 1.0
                lp = lp + MG.ln_prior_mixed(state["gtr_class"][:, gid], x,
                                            symdir)
            elif (param, gid) in self._prior_alpha:
                lp = lp + dirichlet_lpdf(x, self._prior_alpha[(param, gid)])
            elif param in ("tratio", "omega"):
                # Beta prior on x/(x+1) with Jacobian 1/(1+x)^2
                # (reference tRatioDir / omegaDir)
                a, b = (pr.params + (1.0, 1.0))[:2]
                lp = lp + beta_lpdf(x / (1.0 + x), a, b) \
                    - 2.0 * torch.log1p(x)
            elif param == "omega1":
                # as the JAX package: the prior's parameters as a Beta's
                lp = lp + beta_lpdf(x, *pr.params)
            elif param == "m3omega":
                # order statistics of iid exponential dN over a shared dS
                # (reference LogOmegaPrior, src/mcmc.c:7498)
                ordered = (x[:, 0] < x[:, 1]) & (x[:, 1] < x[:, 2]) \
                    & (x[:, 0] > 0)
                lp = lp + torch.where(
                    ordered, math.log(36.0) - 4.0 * torch.log1p(x.sum(-1)),
                    NEG_INF)
            elif param in ("m10beta", "m10gamma", "covswitch"):
                # both shapes (both switch rates) iid under the prior
                # (reference m10betapr, src/bayes.c:741-748; the switch
                # rates src/model.c:11891-11897)
                lp = lp + _scalar_prior_lpdf(pr, x).sum(-1)
            else:
                lp = lp + _scalar_prior_lpdf(pr, x)
        for field, g, bg, fixed_b in self._sympi_priors:
            # a multistate character's frequencies under a symmetric
            # Dirichlet(beta), beta sampled or fixed
            x = state[field][:, g]
            beta = (state["symbeta"][:, bg, None] if bg >= 0
                    else x.new_full((1, 1), fixed_b))
            lp = lp + dirichlet_lpdf(x, beta.expand_as(x))
        for g, (alpha, mixed) in self._rootpi_priors.items():
            # a mixed run's stationary state has no root frequencies
            # (reference Move_Statefreqs_SplitMerge, src/proposal.c:16646)
            term = dirichlet_lpdf(state["rootpi2"][:, g], alpha)
            if mixed:
                term = torch.where(state["dirpi_on"][:, g] > 0, term, 0.0)
            lp = lp + term
        if self.ratemult_on:
            lp = lp + dirichlet_lpdf(state["ratemult"], self._ratemult_alpha)
        return lp

    # ------------------------------------------------------------------
    # generation loop

    def _chain_step(self, gen, state, heat, tuning, power, move_idx, u_acc):
        """One generation of move ``move_idx`` for every chain.  Returns
        (state, accepted [C]).  ``power`` raises the likelihood for
        power-posterior sampling; 1.0 for ordinary MCMC."""
        spec = self.moves[move_idx]
        cur = {k: v for k, v in state.items() if k not in SCORE_KEYS}
        with SPANS(f"gen.propose.{spec.name}"):
            new, lnH = spec.fn(gen, cur, tuning)
        if spec.updates_q:
            with SPANS("gen.eigs"):
                self._count_eig_rows(spec.eig_divs, cur,
                                     ((move_idx, new, None, None),))
                new = self.refresh_eigs(new, spec.eig_divs)
        with SPANS("gen.lnl"):
            lnL = self.log_likelihood(new)
        # recompute only the prior component the move can touch; carry
        # the other (exact: a "params" move leaves every tree-prior input
        # unchanged, and vice versa)
        with SPANS("gen.prior"):
            lnP_tree = (self.log_prior_tree(new)
                        if spec.prior_scope != "params"
                        else state["lnP_tree"])
            lnP_par = (self.log_prior_params(new)
                       if spec.prior_scope != "tree" else state["lnP_par"])
        with SPANS("gen.accept"):
            return self._metropolis(state, new, lnL, lnP_tree, lnP_par, lnH,
                                    heat, power, u_acc)

    @staticmethod
    def _metropolis(state, new, lnL, lnP_tree, lnP_par, lnH, heat, power,
                    u_acc):
        """Accept each chain's proposal ``new`` (scored lnL, lnP_tree,
        lnP_par; log Hastings ratio lnH) with probability min(1, r) under
        its heat and the likelihood's power.  Returns (state, accepted
        [C]); a field no proposal changed keeps its tensor."""
        lnP = lnP_tree + lnP_par
        ln_r = heat * (power * (lnL - state["lnL"])
                       + lnP - state["lnP"]) + lnH
        ln_r = torch.where(torch.isnan(ln_r), NEG_INF, ln_r)
        accept = torch.log(u_acc) < ln_r
        new.update(lnL=lnL, lnP=lnP, lnP_tree=lnP_tree, lnP_par=lnP_par)
        out = {}
        for k, old in state.items():
            nv = new[k]
            if nv is old:
                out[k] = old
            else:
                a = accept.reshape((-1,) + (1,) * (old.ndim - 1))
                out[k] = torch.where(a, nv, old)
        return out, accept

    def _per_chain_step(self, gen, state, heat, tuning, power, moves,
                        sel, u_acc):
        """One generation in which every chain runs its own move
        (``McmcSettings.per_chain_moves``; the reference's independent
        PickProposal per chain, src/mcmc.c:10094).  ``moves`` maps each
        distinct move index drawn for this generation to the number of
        chains that drew it (host ints), ``sel`` [C] each chain's draw on
        the device.  Each distinct move proposes once for the whole batch
        and each chain keeps its own move's proposal (``torch.where`` on
        ``sel``); the eigensystems the drawn moves change are refreshed
        once, on the merged proposal, and the likelihood and both prior
        components are computed once for it.  Returns (state, accepted
        [C])."""
        cur = {k: v for k, v in state.items() if k not in SCORE_KEYS}
        prop, lnH = dict(cur), None
        q_divs, q_tried = set(), []
        for m, n in moves.items():
            spec = self.moves[m]
            with SPANS(f"gen.propose.{spec.name}"):
                new, lnH_m = spec.fn(gen, cur, tuning[:, m])
                mine = sel == m
                for k, old in cur.items():
                    if new[k] is not old:
                        a = mine.reshape((-1,) + (1,) * (old.ndim - 1))
                        prop[k] = torch.where(a, new[k], prop[k])
                lnH = (torch.where(mine, lnH_m, 0.0) if lnH is None
                       else torch.where(mine, lnH_m, lnH))
            if spec.updates_q:
                q_tried.append((m, new, n, mine))
                q_divs = (None if q_divs is None or spec.eig_divs is None
                          else q_divs | set(spec.eig_divs))
        if q_tried:
            divs = None if q_divs is None else tuple(sorted(q_divs))
            with SPANS("gen.eigs"):
                self._count_eig_rows(divs, cur, q_tried)
                prop = self.refresh_eigs(prop, divs)
        with SPANS("gen.lnl"):
            lnL = self.log_likelihood(prop)
        scopes = {self.moves[m].prior_scope for m in moves}
        with SPANS("gen.prior"):
            lnP_tree = (state["lnP_tree"] if scopes == {"params"}
                        else self.log_prior_tree(prop))
            lnP_par = (state["lnP_par"] if scopes == {"tree"}
                       else self.log_prior_params(prop))
        with SPANS("gen.accept"):
            return self._metropolis(state, prop, lnL, lnP_tree, lnP_par,
                                    lnH, heat, power, u_acc)

    def _swap_step(self, draws, E, temp_id):
        """``nswaps`` swap attempts per run between random chain pairs
        (reference AttemptSwap, src/mcmc.c:591; acceptance math :718), as
        dense vector math over the [runs, chains] layout of R runs (all of
        them, or the whole runs one process holds).  ``E`` [R * nchains]
        is power·lnL + lnP of their chains, ``temp_id`` [R * nchains]
        their temperature ids and ``draws`` (si, sj_off, su) [nswaps, R],
        pregenerated for the block.  Returns (temp_id, (lo, hi, acc) per
        attempt)."""
        si, sj_off, su = draws
        nc = self.mcmc.nchains
        lam = self.mcmc.temp
        E = E.reshape(-1, nc)
        tid = temp_id.reshape(-1, nc)
        idx = torch.arange(nc, device=tid.device)
        los, his, accs = [], [], []
        for a in range(si.shape[0]):
            i = si[a]
            j = (i + sj_off[a]) % nc
            sel_i = idx[None, :] == i[:, None]
            sel_j = idx[None, :] == j[:, None]
            ti = torch.where(sel_i, tid, 0).sum(1)
            tj = torch.where(sel_j, tid, 0).sum(1)
            Ei = torch.where(sel_i, E, 0.0).sum(1)
            Ej = torch.where(sel_j, E, 0.0).sum(1)
            beta_i = 1.0 / (1.0 + lam * ti.float())
            beta_j = 1.0 / (1.0 + lam * tj.float())
            acc = torch.log(su[a]) < (beta_i - beta_j) * (Ej - Ei)
            swapped = torch.where(sel_i, tj[:, None],
                                  torch.where(sel_j, ti[:, None], tid))
            tid = torch.where(acc[:, None], swapped, tid)
            los.append(torch.minimum(ti, tj))
            his.append(torch.maximum(ti, tj))
            accs.append(acc)
        rec = (torch.stack(los), torch.stack(his), torch.stack(accs))
        return tid.reshape(-1), rec

    def _swap_draws(self, gen, n_gens: int):
        """A block's swap draws (si, sj_off, su) [n_gens, nswaps, runs]
        from ``gen``: every run's, on every process alike."""
        mc = self.mcmc
        shape = (n_gens, max(1, mc.nswaps), mc.nruns)
        si = torch.randint(0, mc.nchains, shape, generator=gen,
                           device=self.device)
        sj = torch.randint(1, mc.nchains, shape, generator=gen,
                           device=self.device)
        su = torch.rand(shape, generator=gen, device=self.device)
        return si, sj, su

    def _accumulate_swap_stats(self, swap_tries, swap_accepts, lo, hi, acc,
                               run0: int = 0):
        """Fold a block's swap records ([n, nswaps, R'] lo/hi/acc of runs
        run0 .. run0 + R' - 1) into the [R, nc, nc] swap-rate matrices with
        two scatter-adds."""
        nc = self.mcmc.nchains
        R = self.mcmc.nruns
        r_idx = run0 + torch.arange(lo.shape[-1],
                                    device=lo.device).expand_as(lo)
        flat = ((r_idx * nc + lo) * nc + hi).reshape(-1)
        tries = torch.zeros(R * nc * nc, dtype=swap_tries.dtype,
                            device=lo.device)
        tries.index_add_(0, flat, torch.ones_like(flat, dtype=tries.dtype))
        accs = torch.zeros_like(tries)
        accs.index_add_(0, flat, acc.reshape(-1).to(accs.dtype))
        return (swap_tries + tries.reshape(R, nc, nc),
                swap_accepts + accs.reshape(R, nc, nc))

    def _autotune(self, bk):
        """Batch autotune toward target acceptance (diminishing adaptation;
        reference Autotune* fns, src/mcmc.c:16916-16931)."""
        rate = bk["accepts"] / bk["tries"].clamp_min(1)
        step = min(0.5, 1.0 / math.sqrt(1.0 + bk["batch"]))
        factor = torch.exp(step * self._tune_dir * (rate - self._tune_target)
                           * self._tune_on)
        tuning = bk["tuning"] * torch.where(bk["tries"] > 0, factor, 1.0)
        tuning = torch.clamp(tuning, self._tune_min, self._tune_max)
        return {**bk, "tuning": tuning,
                "tries": torch.zeros_like(bk["tries"]),
                "accepts": torch.zeros_like(bk["accepts"]),
                "batch": bk["batch"] + 1}

    def run_block(self, states, bk, n_gens: int):
        """Advance all chains ``n_gens`` generations on the device.

        The block's move indices are drawn up front from the host
        generator (so the host knows which move to run); acceptance
        uniforms and swap draws come from the device generators in one
        batch each.  Nothing in the loop waits for the device, except the
        gather of E where a run's chains span processes.  Under a
        ``chains`` mesh the move and swap draws are drawn for every chain
        and run and this process keeps its own.

        The host's work is recorded in spans (``spans.py``): the draws
        (``gen.draws``), then a generation's proposal
        (``gen.propose.<move>``), eigensystem refresh (``gen.eigs``, with
        the ``eig_rows`` and ``eig_rows_changed`` counters), likelihood
        (``gen.lnl``; a pruner pass's P(t), traversal order and slot
        tables in ``gen.lnl.operands``, the kernel's call inside it in
        ``gen.lnl.launch``), prior (``gen.prior``), acceptance
        (``gen.accept``), the move counters (``gen.tally``), swaps
        (``gen.swap``, which also recomputes the chains' heats) and
        autotuning (``gen.tune``)."""
        SPANS.watch_profiler()
        mc = self.mcmc
        lo, hi = self.chain_slice
        C = hi - lo
        nc = mc.nchains
        # a process holding whole runs swaps them alone; otherwise every
        # rank gathers E and computes every run's swaps
        local_swap = C % nc == 0
        run0, run1 = (lo // nc, hi // nc) if local_swap else (0, mc.nruns)
        dev = self.device
        bk = {k: (v.clone() if torch.is_tensor(v) else v)
              for k, v in bk.items()}
        gen0 = bk["gen"]
        with SPANS("gen.draws"):
            if mc.per_chain_moves:
                # C draws a generation; the host keeps each generation's
                # distinct moves and how many chains drew each, the device
                # each chain's draw (one non-blocking copy from pinned
                # memory a block)
                drawn = torch.multinomial(
                    self._move_probs, n_gens * mc.n_chains_total,
                    replacement=True, generator=bk["rng_host"]).reshape(
                        n_gens, mc.n_chains_total)[:, lo:hi].contiguous()
                distinct = [dict(sorted(Counter(row).items()))
                            for row in drawn.tolist()]
                if dev.type == "cuda":
                    drawn = drawn.pin_memory()
                sel_all = drawn.to(dev, non_blocking=True)
                nm = len(self.moves)
            else:
                midx = torch.multinomial(self._move_probs, n_gens,
                                         replacement=True,
                                         generator=bk["rng_host"]).tolist()
            u_acc = torch.rand((n_gens, C), generator=bk["rng"], device=dev)
            swapping = mc.nchains > 1
            if swapping:
                si, sj, su = self._swap_draws(bk["rng_swap"], n_gens)
            # the chains' heats change with a swap alone
            heats = 1.0 / (1.0 + mc.temp * bk["temp_id"][lo:hi].float())
        power = bk["power"]
        recs = []
        for g in range(n_gens):
            if mc.per_chain_moves:
                states, accepted = self._per_chain_step(
                    bk["rng"], states, heats, bk["tuning"], power,
                    distinct[g], sel_all[g], u_acc[g])
                # each chain counts its own move (the JAX package's
                # move_per_chain)
                with SPANS("gen.tally"):
                    tried = torch.nn.functional.one_hot(
                        sel_all[g], nm).to(torch.int32)
                    acc = tried * accepted.to(torch.int32)[:, None]
                    for key, add in (("tries", tried),
                                     ("tries_total", tried),
                                     ("accepts", acc),
                                     ("accepts_total", acc)):
                        bk[key] += add
            else:
                m = midx[g]
                states, accepted = self._chain_step(
                    bk["rng"], states, heats, bk["tuning"][:, m], power, m,
                    u_acc[g])
                with SPANS("gen.tally"):
                    acc = accepted.to(torch.int32)
                    bk["tries"][:, m] += 1
                    bk["tries_total"][:, m] += 1
                    bk["accepts"][:, m] += acc
                    bk["accepts_total"][:, m] += acc
            absolute = gen0 + g + 1
            if swapping and absolute % mc.swapfreq == 0:
                with SPANS("gen.swap"):
                    E = power * states["lnL"] + states["lnP"]
                    if not local_swap:
                        from ..parallel.mesh import all_gather
                        E = all_gather(E).reshape(-1)
                    t0, t1 = run0 * nc, run1 * nc
                    tid, rec = self._swap_step(
                        (si[g][:, run0:run1], sj[g][:, run0:run1],
                         su[g][:, run0:run1]), E, bk["temp_id"][t0:t1])
                    bk["temp_id"][t0:t1] = tid
                    recs.append(rec)
                    heats = 1.0 / (1.0 + mc.temp
                                   * bk["temp_id"][lo:hi].float())
            if mc.tune and absolute % mc.tunefreq == 0:
                with SPANS("gen.tune"):
                    bk = self._autotune(bk)
        if recs:
            with SPANS("gen.swap"):
                lo_, hi_, acc = (torch.stack(x) for x in zip(*recs))
                bk["swap_tries"], bk["swap_accepts"] = \
                    self._accumulate_swap_stats(bk["swap_tries"],
                                                bk["swap_accepts"], lo_,
                                                hi_, acc, run0)
        bk["gen"] = gen0 + n_gens
        return states, bk

    # ------------------------------------------------------------------
    # host-side helpers

    def cold_indices(self, bk) -> list[int]:
        """Chain-slot index of the cold chain of each run (``temp_id`` a
        tensor or a host array)."""
        tid = _host(bk["temp_id"])
        nc = self.mcmc.nchains
        return [int(r * nc + np.argmin(tid[r * nc:(r + 1) * nc]))
                for r in range(self.mcmc.nruns)]

    @property
    def tree_taxa_labels(self) -> list[str]:
        """Tip labels of the headline tree: the species names under BEST,
        the taxa otherwise (mrbayes_tpu engine.py:3385-3388)."""
        return self.species_names if self.best else list(self.data.taxa)

    def extract_gene_tree(self, states, slot: int, gene: int) -> Tree:
        """One chain's gene tree ``gene`` under BEST (``states`` tensors or
        host arrays), its lengths the age differences in float64."""
        age = _host(states["age"][slot, gene]).astype(np.float64)
        parent = _host(states["parent"][slot, gene]).astype(np.int32)
        blen = np.where(parent >= 0, age[np.maximum(parent, 0)] - age, 0.0)
        return Tree(parent=parent,
                    left=_host(states["left"][slot, gene]).astype(np.int32),
                    right=_host(states["right"][slot, gene]).astype(np.int32),
                    blen=blen, n_tips=self.n_tips, rooted=True)

    def effective_blens(self, states, slot: int,
                        tree: int = 0) -> np.ndarray:
        """One chain's substitution-unit branch lengths (of unlinked tree
        ``tree``; under BEST the species tree's age differences), float64
        on the host (``states`` tensors or host arrays); a clock tree's are
        computed from its ages and rates in float32, as on the device."""
        if self.best:
            age = _host(states["s_age"][slot]).astype(np.float64)
            parent = _host(states["s_parent"][slot])
            return np.where(parent >= 0, age[np.maximum(parent, 0)] - age,
                            0.0)
        if not self.tree_settings.clock:
            blen = states["blen"][slot]
            return _host(blen[tree] if self.n_trees > 1
                         else blen).astype(np.float64)
        one = {k: torch.as_tensor(_host(states[k][slot]))[None]
               for k in ("parent", "age", "clockrate", "brate", "sa",
                         "cpp_pos", "cpp_mult", "cpp_n") if k in states}
        return self.branch_lengths(one)[0].double().numpy()

    def extract_tree(self, states, slot: int, tree: int = 0) -> Tree:
        """One chain's tree (unlinked tree ``tree``) as a host ``Tree``
        (``states`` tensors or host arrays), rooted for a clock model and
        for the rooted non-clock tree of directional root frequencies; under
        BEST the species tree on the species (mrbayes_tpu
        engine.py:3419-3426)."""
        if self.best:
            return Tree(parent=_host(states["s_parent"][slot]).astype(
                np.int32), left=_host(states["s_left"][slot]).astype(np.int32),
                right=_host(states["s_right"][slot]).astype(np.int32),
                blen=self.effective_blens(states, slot),
                n_tips=self.n_species, rooted=True)

        def host(k):
            a = states[k][slot]
            return _host(a[tree] if self.n_trees > 1 else a).astype(np.int32)

        return Tree(parent=host("parent"), left=host("left"),
                    right=host("right"),
                    blen=self.effective_blens(states, slot, tree),
                    n_tips=self.n_tips,
                    rooted=self.tree_settings.clock or self.rooted_nonclock)


def _fixed_eig(exch, pi):
    """The eigensystems (lam, U, Uinv) of fixed reversible generators from
    exchangeabilities [B, n(n-1)/2] and frequencies [B, n], computed once
    in float64 on their device (on the card one ``csrc/eigh.cu`` launch for
    the batch) and kept in float64 (``ops/tiprobs.py``)."""
    ex, p = exch.double(), pi.double()
    return eigh_reversible(protein_q(ex, p), p)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
