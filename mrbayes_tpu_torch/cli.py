"""``mb``-style command interpreter: runs reference NEXUS batch files on
the GPU.

Counterpart of ``mrbayes_tpu/cli.py``: execute, set, charset, taxset,
partition, exclude/include, delete/restore, outgroup, ctype, constraint,
calibrate, pairs, usertree, speciespartition, lset, prset (the
multispecies coalescent's ``topologypr=speciestree``,
``brlenspr=clock:speciestree``, ``generatepr``, ``popvarpr`` and
``ploidy`` too), propset, startvals, link/unlink, report, mcmc/mcmcp,
ss/ssp, sump (``plot=yes`` too), sumt (one consensus a tree under
``unlink topology brlens``), sumss, plot, comparetree, compareref, the
informational commands (show*, charstat, taxastat, databreaks, citations,
about, acknowledgments, disclaimer, showbeagle, showmcmctrees, version,
log, help, manual) and quit.  Batch
mode: ``python -m mrbayes_tpu_torch.cli file.nex`` (on the GPU; add
``--device cpu`` to run on the CPU, and ``--multiwalk``, ``--wavefront``
or ``--stacked`` to turn on a kernel path, see ``Engine``); interactive
without arguments.  On a host with several CUDA devices, ``MB_AUTOSHARD=1``
shards each mcmc run's patterns over them (``_analysis_mesh``).

Over N processes (the reference's ``mpirun -np N``, src/bayes.c:176-195)
the same command runs on every rank with ``--coordinator host:port
--nprocs N --procid i`` (or ``MB_COORDINATOR``, ``MB_NPROCS``,
``MB_PROCID``): each rank holds a chain shard on its own device, rank 0
prints and writes every file, and the other ranks skip the host-only
commands (``HOST_ONLY``).
"""
from __future__ import annotations

import glob
import os
import sys
from dataclasses import dataclass, field, replace

import numpy as np

from .data import DataSet, make_divisions, parse_char_range
from .mcmc.engine import Engine
from .mcmc.settings import (DivisionSettings, McmcSettings, Prior,
                            TreeSettings)
from .nexus.lexer import tokenize
from .nexus.parser import NexusFile, read_nexus_file
from .spans import SPANS


@dataclass
class Environment:
    nexus: NexusFile | None = None
    data_path: str | None = None
    charsets: dict = field(default_factory=dict)
    taxsets: dict = field(default_factory=dict)     # name -> [taxon index]
    partitions: dict = field(default_factory=dict)  # name -> list[list[int]]
    excluded: set = field(default_factory=set)      # 0-based characters
    ctypes: dict = field(default_factory=dict)      # 0-based char -> ordered
    # name -> (hard|negative|partial, taxon mask, second mask or None)
    constraints: dict = field(default_factory=dict)
    calibrations: dict = field(default_factory=dict)  # taxon/name -> Prior
    # speciespartition name -> [(species name, taxon tokens)], and the
    # active one (set speciespartition=)
    speciespartitions: dict = field(default_factory=dict)
    current_speciespartition: str | None = None
    enforced_constraints: list = field(default_factory=list)  # names
    current_partition: str | None = None
    # settings per user-division (list index = user division)
    div_settings: list = field(default_factory=list)
    tree_settings: TreeSettings = field(default_factory=TreeSettings)
    mcmc: McmcSettings = field(default_factory=McmcSettings)
    links: dict = field(default_factory=dict)   # param -> list[int] per div
    pairs: tuple = ()       # doublet pairs: ((i, j), ...) 0-based columns
    report: dict = field(default_factory=dict)   # key -> (value, divisions)
    # deleted taxa, by their index in the matrix as read (delete/restore)
    deleted: set = field(default_factory=set)
    move_overrides: dict = field(default_factory=dict)  # propset
    start_tree_name: str | None = None          # startvals tau=<tree>
    user_trees: dict = field(default_factory=dict)      # name -> newick
    outgroup: int = 0       # the outgroup's index in the matrix as read
    logfile: object = None  # log start: every message is copied there
    seed: int = 1
    swapseed: int = 2
    autoclose: bool = True
    nowarnings: bool = True
    quit_requested: bool = False

    def n_user_divs(self) -> int:
        if self.current_partition:
            return len(self.partitions[self.current_partition])
        # default partition: one user division per datatype run (the
        # reference's implicit partition for mixed(...) matrices)
        if self.nexus is not None and self.nexus.matrix is not None:
            seen = []
            for dt in self.nexus.matrix.col_datatype:
                if dt not in seen:
                    seen.append(dt)
            return len(seen)
        return 1

    def ensure_div_settings(self):
        n = self.n_user_divs()
        while len(self.div_settings) < n:
            self.div_settings.append(DivisionSettings())
        del self.div_settings[n:]


class CommandError(Exception):
    pass


PARAM_ALIASES = {
    "statefreq": "pi", "revmat": "revmat", "tratio": "tratio",
    "shape": "shape", "pinvar": "pinvar", "ratemultiplier": "ratemult",
    "topology": "topology", "brlens": "brlens", "aamodel": "aamodel",
}


# aamodelpr=fixed(<name>) (mrbayes_tpu cli.py:749-760)
AA_MODEL_NAMES = ("poisson", "jones", "dayhoff", "mtrev", "mtmam", "wag",
                  "rtrev", "cprev", "vt", "blosum", "lg", "equalin", "gtr")


class Interpreter:
    """The command interpreter.  ``device=None`` runs the analyses on
    CUDA and raises when there is none; tests pass ``device="cpu"``.
    ``multiwalk``, ``wavefront`` and ``stacked`` are the engines'
    kernel-path switches (see ``Engine``; None reads the environment)."""

    def __init__(self, log=None, device=None, multiwalk: bool | None = None,
                 wavefront: bool | None = None, stacked: bool | None = None):
        from . import resolve_device
        self.device = resolve_device(device)
        self.switches = {"multiwalk": multiwalk, "wavefront": wavefront,
                         "stacked": stacked}
        self.env = Environment()
        self._log_fn = log or print
        # a rank other than 0 of a launch over processes (main)
        self._worker = False

    def log(self, msg: str):
        self._log_fn(msg)
        if self.env.logfile:
            self.env.logfile.write(msg + "\n")

    # ------------------------------------------------------------------
    def execute_file(self, path: str):
        self.log(f"   Executing file \"{path}\"")
        nf = read_nexus_file(path)
        if nf.matrix is not None:
            self.env.nexus = nf
            self.env.data_path = path
            # outputs go to the working directory, named after the data
            # file (basename only: inputs may sit in read-only places)
            self.env.mcmc.filename = os.path.basename(path)
            self.env.div_settings = [DivisionSettings()]
            self.env.current_partition = None
            self.log(f"   Matrix has {nf.matrix.ntax} taxa and "
                     f"{nf.matrix.nchar} characters")
        # a trees block's trees are user trees (startvals, showusertrees)
        for tr in nf.trees:
            self.env.user_trees[tr.name.lower()] = tr.newick
        if nf.trees:
            self.log(f"   Read {len(nf.trees)} user tree(s): "
                     + ", ".join(t.name for t in nf.trees))
        base = os.path.dirname(os.path.abspath(path))
        for cmd in nf.commands:
            self.run_command(cmd, base_dir=base)
            if self.env.quit_requested:
                break

    def run_line(self, line: str, base_dir: str = "."):
        toks = tokenize(line)
        if toks:
            self.run_command(toks, base_dir)

    # ------------------------------------------------------------------
    # host-side summary and plot commands run on rank 0 only in a launch
    # over processes; the analyses and model commands run on every rank
    # (mrbayes_tpu/cli.py:142-149)
    HOST_ONLY = ("sump", "sumt", "sumss", "comparetree", "compareref",
                 "plot", "log")

    def run_command(self, toks: list[str], base_dir: str = "."):
        name = toks[0].lower()
        args = toks[1:]
        if self._worker and name in self.HOST_ONLY:
            return
        handler = getattr(self, f"do_{name}", None)
        if handler is None:
            handler = self._abbrev_handler(name)
        if handler is None:
            # the reference rejects unknown commands ("Could not find
            # command", src/command.c FindValidCommand)
            self.log(f"   [!] Could not find command \"{name}\"")
            raise CommandError(f"unknown command {name!r}")
        try:
            handler(args, base_dir)
        except CommandError as e:
            self.log(f"   [!] Error in \"{name}\": {e}")
            raise

    def _abbrev_handler(self, name):
        cands = [m for m in dir(self) if m.startswith("do_")
                 and m[3:].startswith(name)]
        if len(cands) == 1:
            return getattr(self, cands[0])
        return None

    # ------------------------------------------------------------------
    @staticmethod
    def _kv_pairs(args: list[str]):
        """Split 'a = b c = (x,y) d = u:v(1,2)' token runs into
        (key, value-token-list) pairs.  A new pair starts wherever a token
        is followed by '='; value tokens (including parens/colons) accrue
        to the current pair until the next such boundary."""
        pairs = []
        i = 0
        cur = None
        depth = 0
        while i < len(args):
            tok = args[i]
            if tok == "(":
                depth += 1
            elif tok == ")":
                depth = max(0, depth - 1)
            starts_pair = (depth == 0 and i + 1 < len(args)
                           and args[i + 1] == "=" and tok not in "()=,:")
            if starts_pair:
                cur = (tok.lower(), [])
                pairs.append(cur)
                i += 2
                continue
            if cur is None:
                pairs.append((tok.lower(), []))
            else:
                cur[1].append(tok)
            i += 1
        return pairs

    @staticmethod
    def _canon(key: str, names: tuple) -> str:
        """Reference-style abbreviation matching: a key may be any
        unambiguous prefix of a parameter name (src/command.c IsSame)."""
        if key in names:
            return key
        hits = [n for n in names if n.startswith(key)]
        return hits[0] if len(hits) == 1 else key

    @staticmethod
    def _canon_strict(key: str, names: tuple, cmd: str) -> str:
        """Like _canon but rejects unmatched keys, as the reference does
        ("Invalid argument")."""
        if key in names:
            return key
        hits = [n for n in names if n.startswith(key)]
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise CommandError(
                f"ambiguous {cmd} argument {key!r} (matches {hits})")
        raise CommandError(f"invalid {cmd} argument {key!r}")

    @staticmethod
    def _parse_prior(tokens: list[str]) -> Prior:
        """Parse 'exponential(10.0)' or 'dirichlet(1,1,1,1)' or
        'fixed(equal)', possibly split across tokens."""
        text = "".join(tokens).lower()
        # the reference accepts abbreviated distribution names
        aliases = {"exp": "exponential", "unif": "uniform",
                   "lognorm": "lognormal", "lognormal": "lognormal",
                   "offsetexponential": "offsetexp",
                   "offsetexp": "offsetexp", "norm": "normal",
                   "gaussian": "normal", "truncatednormal": "truncatednormal"}
        if "(" in text:
            kind, rest = text.split("(", 1)
            kind = aliases.get(kind, kind)
            rest = rest.rstrip(")")
            params = []
            for p in rest.split(","):
                p = p.strip()
                if not p:
                    continue
                try:
                    params.append(float(p))
                except ValueError:
                    params.append(p)
            return Prior(kind, tuple(params))
        return Prior(text, ())

    def _applyto(self, pairs) -> list[int]:
        """Divisions targeted by an applyto=() clause (0-based)."""
        self.env.ensure_div_settings()
        n = self.env.n_user_divs()
        for key, val in pairs:
            if self._canon(key, ("applyto",)) == "applyto":
                inner = [t for t in val if t not in "(),"]
                if any(t.lower() == "all" for t in inner):
                    return list(range(n))
                return [int(t) - 1 for t in inner if t.isdigit()]
        return list(range(n))

    # ------------------------------------------------------------------
    # commands

    def do_execute(self, args, base_dir):
        path = args[0].strip('"')
        if not os.path.isabs(path):
            cand = os.path.join(base_dir, path)
            path = cand if os.path.exists(cand) else path
        self.execute_file(path)

    SET_KEYS = ("autoclose", "nowarn", "nowarnings", "seed", "swapseed",
                "partition", "speciespartition", "dir", "quitonerror",
                "scientific", "precision", "ordertaxa",
                # BEAGLE resource selection: accepted for drive-file
                # compatibility (reference set usebeagle...,
                # src/command.c:7202)
                "usebeagle", "beagledevice", "beagleprecision",
                "beagleresource", "beaglescaling", "beaglesse",
                "beagleopenmp", "beaglefreq", "beaglethreads")

    def do_set(self, args, base_dir):
        for key, val in self._kv_pairs(args):
            key = self._canon_strict(key, self.SET_KEYS, "set")
            v = val[0].lower() if val else ""
            if key == "autoclose":
                self.env.autoclose = v.startswith("y")
            elif key in ("nowarn", "nowarnings"):
                self.env.nowarnings = v.startswith("y")
            elif key == "seed":
                self.env.seed = int(val[0])
                self.env.mcmc.seed = int(val[0])
            elif key == "swapseed":
                self.env.swapseed = int(val[0])
                self.env.mcmc.swapseed = int(val[0])
            elif key == "partition":
                name = val[0]
                matches = [p for p in self.env.partitions
                           if p.lower() == name.lower()]
                if not matches:
                    raise CommandError(f"unknown partition {name!r}")
                self.env.current_partition = matches[0]
                self.env.ensure_div_settings()
                self.log(f"   Setting partition to {matches[0]} "
                         f"({self.env.n_user_divs()} divisions)")
            elif key == "speciespartition":
                matches = [p for p in self.env.speciespartitions
                           if p.lower() == val[0].lower()]
                if not matches:
                    raise CommandError(
                        f"unknown speciespartition {val[0]!r}")
                self.env.current_speciespartition = matches[0]
                self.log(f"   Setting speciespartition to {matches[0]}")
            # the remaining keys are accepted with no effect

    def do_charset(self, args, base_dir):
        name = args[0]
        rest = args[1:]
        if rest and rest[0] == "=":
            rest = rest[1:]
        nchar = self.env.nexus.matrix.nchar
        self.env.charsets[name] = self._expand_sets(rest, nchar)

    def _expand_sets(self, toks, nchar):
        """Expand tokens that may name charsets or give ranges (with
        ``\\3``-style strides)."""
        out = []
        plain = []
        for t in toks:
            if t in self.env.charsets:
                if plain:
                    out.extend(parse_char_range(plain, nchar))
                    plain = []
                out.extend(self.env.charsets[t])
            else:
                plain.append(t)
        if plain:
            out.extend(parse_char_range(plain, nchar))
        return out

    def do_taxset(self, args, base_dir):
        """taxset <name> = <taxa> (reference DoTaxset): names or 1-based
        numbers (mrbayes_tpu cli.py:348)."""
        name = args[0]
        taxa = self.env.nexus.taxa
        ids = []
        for t in (t for t in args[1:] if t != "="):
            if t in taxa:
                ids.append(taxa.index(t))
            elif t.isdigit():
                ids.append(int(t) - 1)
        self.env.taxsets[name] = ids

    def do_exclude(self, args, base_dir):
        nchar = self.env.nexus.matrix.nchar
        self.env.excluded |= set(self._expand_sets(args, nchar))

    def do_include(self, args, base_dir):
        nchar = self.env.nexus.matrix.nchar
        self.env.excluded -= set(self._expand_sets(args, nchar))

    def do_ctype(self, args, base_dir):
        """ctype ordered|unordered: chars (reference DoCtype,
        src/command.c:3009): ordered standard characters take the
        adjacent-state Mk generator (src/likelihood.c:9257)."""
        kind = args[0].lower().rstrip(":")
        nchar = self.env.nexus.matrix.nchar
        cols = self._expand_sets([t for t in args[1:] if t != ":"], nchar)
        if kind == "unordered":
            for c in cols:
                self.env.ctypes.pop(c, None)
        elif kind == "irreversible":
            # the reference rejects it at model setup ("Irreversible model
            # not yet supported", src/model.c:16527-16531)
            raise CommandError("irreversible model not supported (the "
                               "reference rejects it too, "
                               "src/model.c:16529)")
        else:
            for c in cols:
                self.env.ctypes[c] = kind
        self.log(f"   Set ctype {kind} for {len(cols)} characters")

    def _expand_taxa(self, toks) -> list[int]:
        """Taxon tokens to sorted 0-based indices: names, numbers, ranges
        (3-114, 1-.) and taxset names."""
        taxa = self.env.nexus.taxa
        lower = {t.lower(): i for i, t in enumerate(taxa)}
        out: list[int] = []
        plain: list[str] = []

        def flush():
            if plain:
                out.extend(parse_char_range(plain, len(taxa)))
                plain.clear()

        for t in toks:
            if t.lower() in lower:
                flush()
                out.append(lower[t.lower()])
            elif t in self.env.taxsets:
                flush()
                out.extend(self.env.taxsets[t])
            else:
                plain.append(t)
        flush()
        return sorted(set(out))

    def do_constraint(self, args, base_dir):
        """constraint <name> [hard|negative|partial] = <taxa> [: <taxa2>]
        (reference DoConstraint, src/command.c:2419; a partial constraint
        carries a second taxon set after ':').  Enforced only when named
        in prset topologypr=constraints(...)."""
        name = args[0]
        rest = [t for t in args[1:] if t != "="]
        ctype = "hard"
        if rest and rest[0].lower() in ("hard", "negative", "partial"):
            ctype = rest[0].lower()
            rest = rest[1:]
        ntax = len(self.env.nexus.taxa)
        mask2 = None
        if ctype == "partial":
            if ":" not in rest:
                raise CommandError(
                    f"partial constraint {name} needs two taxon sets "
                    "separated by ':'")
            cut = rest.index(":")
            mask2 = np.zeros(ntax, bool)
            mask2[self._expand_taxa(rest[cut + 1:])] = True
            rest = rest[:cut]
        mask = np.zeros(ntax, bool)
        mask[self._expand_taxa(rest)] = True
        if ctype == "partial":
            if (mask & mask2).any():
                raise CommandError(
                    f"partial constraint {name}: the two taxon sets "
                    "intersect (reference src/command.c:2482)")
            if not mask2.any():
                raise CommandError(
                    f"partial constraint {name}: empty second set")
        if ctype in ("negative", "partial") and mask.sum() < 2:
            raise CommandError(
                f"{ctype} constraint {name} needs at least two taxa")
        self.env.constraints[name.lower()] = (ctype, mask, mask2)

    def do_calibrate(self, args, base_dir):
        """calibrate <taxon|constraint|root> = fixed(age)|uniform(a,b)|
        offsetexp(offset,mean) (reference DoCalibrate,
        src/command.c:1161)."""
        for key, val in self._kv_pairs(args):
            self.env.calibrations[key.lower()] = self._parse_prior(val)

    def do_speciespartition(self, args, base_dir):
        """speciespartition <name> = <species>: <taxa>, ... assigns the
        taxa to species for a BEST analysis (reference
        DoSpeciespartition, src/command.c; mrbayes_tpu cli.py:422-453)."""
        name = args[0]
        rest = args[1:]
        if rest and rest[0] == "=":
            rest = rest[1:]
        groups: list[tuple[str, list[str]]] = []
        i = 0
        while i < len(rest):
            if i + 1 < len(rest) and rest[i + 1] == ":":
                groups.append((rest[i], []))
                i += 2
                continue
            if rest[i] != "," and groups:
                groups[-1][1].append(rest[i])
            i += 1
        if not groups:
            raise CommandError("expected 'speciespartition name = "
                               "Species: taxa, ...'")
        self.env.speciespartitions[name] = groups
        self.log(f"   Defined speciespartition \"{name}\" with "
                 f"{len(groups)} species")

    def do_partition(self, args, base_dir):
        # partition name = N: ranges, ranges, ...
        name = args[0]
        rest = args[1:]
        if rest and rest[0] == "=":
            rest = rest[1:]
        try:
            colon = rest.index(":")
        except ValueError:
            raise CommandError("expected 'partition name = N: ...'")
        n_sub = int(rest[colon - 1])
        groups_toks = []
        cur = []
        for t in rest[colon + 1:]:
            if t == ",":
                groups_toks.append(cur)
                cur = []
            else:
                cur.append(t)
        if cur:
            groups_toks.append(cur)
        if len(groups_toks) != n_sub:
            raise CommandError(
                f"partition {name}: declared {n_sub} subsets, "
                f"found {len(groups_toks)}")
        nchar = self.env.nexus.matrix.nchar
        self.env.partitions[name] = [self._expand_sets(g, nchar)
                                     for g in groups_toks]
        self.log(f"   Defined partition \"{name}\" with {n_sub} subsets")

    LSET_KEYS = ("applyto", "nst", "rates", "ngammacat", "nucmodel", "code",
                 "covarion", "coding", "omegavar", "parsmodel", "nbetacat",
                 "nmixtcat", "usegibbs", "gibbsfreq", "nlnormcat",
                 "numm10betacats", "numm10gammacats",
                 "statefreqmodel", "statefrmod")

    def do_lset(self, args, base_dir):
        """Model settings per division; the engine raises for settings
        the port does not carry yet."""
        pairs = self._kv_pairs(args)
        targets = self._applyto(pairs)
        for key, val in pairs:
            key = self._canon_strict(key, self.LSET_KEYS, "lset")
            if key == "applyto" or not val:
                continue
            v = "".join(val).lower()
            if key == "usegibbs":
                if v.startswith("y"):
                    raise CommandError(
                        "usegibbs=yes is not supported: rate categories "
                        "are always integrated densely")
                continue
            if key == "gibbsfreq":
                continue
            for d in targets:
                s = self.env.div_settings[d]
                if key in ("nst", "rates", "nucmodel", "code", "coding",
                           "omegavar"):
                    setattr(s, key, v)
                elif key in ("ngammacat", "nlnormcat", "nmixtcat",
                             "nbetacat"):
                    setattr(s, key, int(v))
                elif key == "numm10betacats":
                    s.nm10betacat = int(v)
                elif key == "numm10gammacats":
                    s.nm10gammacat = int(v)
                elif key in ("covarion", "parsmodel"):
                    setattr(s, key, v.startswith("y"))
                elif key in ("statefreqmodel", "statefrmod"):
                    if v not in ("stationary", "directional", "mixed"):
                        raise CommandError(
                            "statefreqmodel must be "
                            "stationary|directional|mixed")
                    s.statefreqmodel = v

    # the clock's prset keys (mrbayes_tpu cli.py:686, :780-787), which
    # set TreeSettings fields of the same name
    CLOCK_KEYS = ("clockvarpr", "clockratepr", "treeagepr", "igrvarpr",
                  "ilnvarpr", "tk02varpr", "wnvarpr", "mixedvarpr",
                  "cppratepr", "cppmultdevpr", "speciationpr",
                  "extinctionpr", "popsizepr", "growthpr", "sampleprob",
                  "samplestrat", "fossilizationpr", "nodeagepr")
    # the amino-acid and codon prset keys (mrbayes_tpu cli.py:723-762),
    # which set DivisionSettings fields of the same name
    AA_CODON_KEYS = ("aamodelpr", "aarevmatpr", "omegapr", "ny98omega1pr",
                     "ny98omega3pr", "codoncatfreqpr", "m3omegapr",
                     "m10betapr", "m10gammapr")
    # the covarion switch rates' and the directional root frequencies'
    # prset keys (mrbayes_tpu cli.py:717-720, :763-764)
    COVARION_ROOT_KEYS = ("covswitchpr", "rootfreqpr")
    # the adgamma correlation's, symdirihyperpr's and continuous data's
    # prset keys (mrbayes_tpu cli.py:715, :739-748, :815)
    FAMILY_KEYS = ("ratecorrpr", "symdirihyperpr", "browncorrpr",
                   "brownscalepr")
    PRSET_KEYS = ("applyto", "statefreqpr", "revmatpr", "tratiopr",
                  "shapepr", "pinvarpr", "ratepr", "brlenspr", "topologypr",
                  *CLOCK_KEYS, *AA_CODON_KEYS, *COVARION_ROOT_KEYS,
                  *FAMILY_KEYS, "generatepr", "popvarpr", "ploidy")

    def do_prset(self, args, base_dir):
        pairs = self._kv_pairs(args)
        targets = self._applyto(pairs)
        for key, val in pairs:
            key = self._canon_strict(key, self.PRSET_KEYS, "prset")
            if key == "applyto" or not val:
                continue
            if key == "brlenspr":
                self._set_brlenspr(val)
                continue
            prior = self._parse_prior(val)
            if key == "topologypr":
                self._set_topologypr(prior)
                continue
            if key in self.CLOCK_KEYS:
                self._set_clock_key(key, prior)
                continue
            if key in ("popvarpr", "ploidy"):
                # BEST's theta per population or shared, and the ploidy
                # factor (mrbayes_tpu cli.py:776-779)
                setattr(self.env.tree_settings, key, prior.kind)
                continue
            for d in targets:
                s = self.env.div_settings[d]
                if key in ("ratepr", "generatepr"):
                    # generatepr: BEST's per-gene rate multipliers
                    # (mrbayes_tpu cli.py:734-738)
                    setattr(s, key, "variable" if prior.kind.startswith(
                        "var") or prior.kind == "dirichlet" else "fixed")
                elif key == "aamodelpr":
                    if prior.kind == "fixed" and prior.params:
                        name = str(prior.params[0]).lower()
                        if name not in AA_MODEL_NAMES:
                            raise CommandError(
                                f"unknown amino-acid model '{name}' (valid: "
                                f"{', '.join(AA_MODEL_NAMES)})")
                        s.aamodel = name
                    s.aamodelpr = prior
                elif key == "ratecorrpr":
                    s.adgammacorpr = prior
                elif key == "symdirihyperpr":
                    # fixed(infinity), the default, is equal frequencies;
                    # fixed(b), uniform(a,b) or exponential(r) turns the
                    # symmetric Dirichlet on
                    if prior.kind == "fixed" and prior.params \
                            and isinstance(prior.params[0], str):
                        prior = Prior("fixed", (-1.0,))
                    s.symdirihyperpr = prior
                elif key == "m3omegapr":
                    # M3's omegas always take the reference's default
                    # exponential order-statistic prior (src/command.c:
                    # 10819); fixed(w1,w2,w3) is not wired, as in
                    # mrbayes_tpu cli.py:821-827
                    if prior.kind not in ("exponential", "exp"):
                        raise CommandError(
                            "m3omegapr supports only 'exponential' "
                            "(order-statistic prior)")
                else:
                    setattr(s, key, prior)

    def _set_brlenspr(self, val):
        text = "".join(val).lower()
        # unconstrained:gammadir(...) | unconstrained:exp(10) | clock:...
        ts = self.env.tree_settings
        if text.startswith("unconstrained"):
            ts.clock = False
            sub = text.split(":", 1)[1] if ":" in text else "gammadir"
            pr = self._parse_prior([sub])
            if pr.kind in ("exponential", "exp"):
                ts.brlenspr = Prior("exponential", pr.params or (10.0,))
            elif pr.kind == "uniform":
                ts.brlenspr = Prior("uniform", pr.params or (1e-6, 100.0))
            elif pr.kind == "gammadir":
                ts.brlenspr = Prior("gammadir",
                                    pr.params or (1.0, 0.1, 1.0, 1.0))
            else:
                raise CommandError(f"brlenspr {text!r} not supported")
        elif text.startswith("clock"):
            sub = text.split(":", 1)[1] if ":" in text else "uniform"
            kind = sub.split("(")[0]
            if kind in ("speciestree", "speciestreecoalescence"):
                # BEST: gene trees under the multispecies coalescent in a
                # species tree (mrbayes_tpu cli.py:855-859)
                ts.speciestree = True
                kind = "uniform"
            elif kind not in ("uniform", "birthdeath", "coalescence",
                              "fossilization"):
                raise CommandError(f"unknown clock prior {kind!r}")
            ts.clock = True
            ts.clockpr = kind
        else:
            raise CommandError(f"brlenspr {text!r} not supported")

    def _set_clock_key(self, key, prior):
        """A clock prset key (mrbayes_tpu cli.py:780-812)."""
        ts = self.env.tree_settings
        if key in ("clockvarpr", "samplestrat", "nodeagepr"):
            setattr(ts, key, prior.kind)
        elif key == "sampleprob":
            ts.sampleprob = float(prior.params[0] if prior.params
                                  else prior.kind)
        else:
            setattr(ts, key, prior)

    def _set_topologypr(self, prior):
        """topologypr=uniform|constraints(<names>)|speciestree
        (mrbayes_tpu cli.py:765-775)."""
        if prior.kind == "speciestree":
            self.env.tree_settings.speciestree = True
        self.env.enforced_constraints = (
            [str(p).lower() for p in prior.params]
            if prior.kind == "constraints" else [])
        self.env.tree_settings.topologypr = prior

    def do_link(self, args, base_dir):
        self._link_unlink(args, link=True)

    def do_unlink(self, args, base_dir):
        self._link_unlink(args, link=False)

    def _link_unlink(self, args, link: bool):
        self.env.ensure_div_settings()
        n = self.env.n_user_divs()
        for key, val in self._kv_pairs(args):
            # abbreviation matching ("statefr" -> statefreq -> pi)
            key = self._canon(key, tuple(PARAM_ALIASES))
            param = PARAM_ALIASES.get(key, key)
            inner = [t for t in val if t not in "(),"]
            if any(t.lower() == "all" for t in inner):
                targets = list(range(n))
            else:
                targets = [int(t) - 1 for t in inner if t.isdigit()]
            cur = self.env.links.get(param, [0] * n)
            cur = (cur + [0] * n)[:n]
            for d in targets:
                cur[d] = 0 if link else d + 1
            self.env.links[param] = cur

    def do_pairs(self, args, base_dir):
        """pairs 1:20, 2:19, ...: the nucleotide pairs of the doublet model,
        1-based (reference DoPairs, src/command.c:5599; mrbayes_tpu
        cli.py:537-548)."""
        pairs = []
        for piece in "".join(args).replace(" ", "").split(","):
            if piece:
                a, b = piece.split(":")
                pairs.append((int(a) - 1, int(b) - 1))
        self.env.pairs = tuple(pairs)
        self.log(f"   Defined {len(pairs)} nucleotide pairs")

    REPORT_KEYS = ("applyto", "ancstates", "siterates", "possel",
                   "siteomega", "tree", "brlens", "apetree")

    def do_report(self, args, base_dir):
        """report [applyto=(..)] ancstates|siterates|possel|siteomega=yes
        — posterior reporting options (reference DoReport,
        src/command.c).  Stored as key -> (value, divisions); the runner
        appends the matching p(state)/r(i)/pr+/omega columns to the .p
        samples (mcmc/report.py)."""
        pairs = self._kv_pairs(args)
        targets = self._applyto(pairs)
        for key, val in pairs:
            key = self._canon_strict(key, self.REPORT_KEYS, "report")
            if key == "applyto" or not val:
                continue
            self.env.report[key] = ("".join(val).lower(), tuple(targets))
        self.log("   Set report options: "
                 + " ".join(f"{k}={v}" for k, (v, _)
                            in self.env.report.items()))

    def do_propset(self, args, base_dir):
        """propset <move>$<setting>=<value> ... — adjust proposal
        probabilities/tuning (reference DoPropset, src/model.c:4282).
        Move names are this engine's (see the acceptance-rate table)."""
        toks = [t for t in args if t != ","]
        i = 0
        while i < len(toks):
            piece = toks[i]
            if i + 2 < len(toks) and toks[i + 1] == "=":
                piece = piece + "=" + toks[i + 2]
                i += 3
            else:
                i += 1
            if "$" not in piece or "=" not in piece:
                raise CommandError(f"propset: bad syntax {piece!r} "
                                   "(want move$setting=value)")
            mv, rest = piece.split("$", 1)
            setting, val = rest.split("=", 1)
            self.env.move_overrides.setdefault(mv.lower(), {})[
                setting.lower()] = float(val)
        self.log(f"   Set proposal parameters for "
                 f"{len(self.env.move_overrides)} moves")

    def do_startvals(self, args, base_dir):
        """startvals tau=<treename> — user starting tree (reference
        DoStartvals, src/model.c:10624; scalar params start at defaults)."""
        for key, val in self._kv_pairs(args):
            if key in ("tau", "topology", "tree"):
                self.env.start_tree_name = val[0]
            else:
                self.log(f"   startvals: parameter {key!r} ignored "
                         "(only tau=<tree> supported)")

    def do_usertree(self, args, base_dir):
        """usertree: accepted; user trees come from a file's trees block,
        registered when the file is executed."""

    def do_delete(self, args, base_dir):
        """delete <taxa|taxset|all> — exclude taxa from the analysis
        (reference DoDelete, src/command.c)."""
        if args and args[0].lower() == "all":
            self.env.deleted = set(range(len(self.env.nexus.taxa)))
        else:
            self.env.deleted |= set(self._expand_taxa(args))

    def do_restore(self, args, base_dir):
        """restore <taxa|taxset|all> — bring deleted taxa back (reference
        DoRestore, src/command.c)."""
        if args and args[0].lower() == "all":
            self.env.deleted = set()
        else:
            self.env.deleted -= set(self._expand_taxa(args))

    def do_outgroup(self, args, base_dir):
        """outgroup <taxon> — the outgroup taxon, by name or number
        (reference DoOutgroup, src/command.c)."""
        t = args[0]
        taxa = self.env.nexus.taxa
        self.env.outgroup = (taxa.index(t) if t in taxa else int(t) - 1)

    def do_quit(self, args, base_dir):
        self.env.quit_requested = True

    # ------------------------------------------------------------------
    def build_engine(self, **switches) -> Engine:
        """The engine for the current data and settings (reference
        SetUpAnalysis).  ``multiwalk=``, ``wavefront=`` and ``stacked=``
        override the interpreter's switches."""
        env = self.env
        if env.nexus is None or env.nexus.matrix is None:
            raise CommandError("no data matrix read in")
        env.ensure_div_settings()
        matrix = env.nexus.matrix
        taxa = list(env.nexus.taxa)
        # deleted taxa leave the matrix; every taxon index stored against
        # the matrix as read (constraints, taxsets) is remapped with keep
        keep = np.array([i not in env.deleted for i in range(len(taxa))])
        remap = np.cumsum(keep) - 1
        if env.deleted:
            taxa = [t for i, t in enumerate(taxa) if keep[i]]
            matrix = replace(matrix, codes=matrix.codes[keep], taxa=taxa)
        subsets = ([env.partitions[env.current_partition]]
                   if env.current_partition else [])
        divisions = make_divisions(matrix, *subsets, excluded=env.excluded,
                                   ctype=env.ctypes)
        taxsets = {nm: [int(remap[i]) for i in ids if keep[i]]
                   for nm, ids in env.taxsets.items()}
        ds = DataSet(taxa=taxa, nchar=matrix.nchar, divisions=divisions,
                     charsets=env.charsets, taxsets=taxsets)
        self._wire_dating(taxa, keep)
        self._wire_species_partition(keep)
        div_settings = [replace(env.div_settings[d.user_index])
                        for d in divisions]
        for s in div_settings:
            if s.nucmodel == "doublet":
                s.pairs = env.pairs
        links = None
        if env.links:
            links = {p: [groups[d.user_index] for d in divisions]
                     for p, groups in env.links.items()}
        for d, s in zip(divisions, div_settings):
            self.log(f"   Division {d.index + 1} ({d.name}): "
                     f"{d.npat} unique site patterns, nst={s.nst} "
                     f"rates={s.rates}")
        eng = Engine(ds, div_settings, env.tree_settings, env.mcmc,
                     links=links, device=self.device,
                     move_overrides=env.move_overrides,
                     start_tree=self._start_tree(taxa),
                     **{**self.switches, **switches})
        for note in eng.notes:
            self.log(f"   [{note}]")
        return eng

    def _wire_species_partition(self, keep: np.ndarray):
        """The active speciespartition on the analysis's taxa (after
        ``delete``: ``keep`` masks the matrix's taxa) into TreeSettings
        when topologypr=speciestree (mrbayes_tpu cli.py:952-973)."""
        env = self.env
        ts = env.tree_settings
        if not ts.speciestree:
            return
        if not env.current_speciespartition:
            raise CommandError(
                "topologypr=speciestree requires 'speciespartition <name> "
                "= ...' and 'set speciespartition=<name>'")
        remap = np.cumsum(keep) - 1
        parts = []
        for spname, toks in env.speciespartitions[
                env.current_speciespartition]:
            kept = [int(remap[i]) for i in self._expand_taxa(toks)
                    if keep[i]]
            if kept:
                parts.append((spname, kept))
        ts.species_partition = parts

    def _start_tree(self, taxa: list[str]):
        """The user tree that ``startvals tau=`` names, on the analysis's
        taxa, with the reference's starting length 0.1 on branches the
        tree gives none (mrbayes_tpu cli.py:931-946); None without one or
        on a clock model."""
        env = self.env
        if not env.start_tree_name:
            return None
        nm = env.start_tree_name.lower()
        if nm not in env.user_trees:
            raise CommandError(f"startvals: no user tree {nm!r}")
        if env.tree_settings.clock:
            self.log("   [startvals tau: clock starting trees not "
                     "supported yet; using a random calibrated tree]")
            return None
        from .trees import parse_newick
        t = parse_newick(env.user_trees[nm], taxa)
        free = np.ones(t.n_nodes, bool)
        free[[0, t.root]] = False
        t.blen[free & (t.blen <= 1e-9)] = 0.1
        return t

    def _wire_dating(self, taxa: list[str], keep: np.ndarray):
        """Resolve the calibrate and constraint declarations against the
        analysis's taxa (after ``delete``: ``keep`` masks the matrix's
        taxa) into TreeSettings (mrbayes_tpu cli.py:975-1014; calibrations
        count only under nodeagepr=calibrated, cli.py:984-987)."""
        env = self.env
        ts = env.tree_settings
        lower = {t.lower(): i for i, t in enumerate(taxa)}
        ts.tip_calibrations = {}
        cons: list = []
        calibs = env.calibrations if ts.nodeagepr == "calibrated" else {}
        if env.calibrations and ts.nodeagepr != "calibrated":
            self.log("   [calibrations ignored: nodeagepr=unconstrained "
                     "(set prset nodeagepr=calibrated)]")
        for name, pr in calibs.items():
            if name == "root":
                cons.append(("root", np.ones(len(taxa), bool), pr))
            elif name in lower:
                ts.tip_calibrations[lower[name]] = pr
            elif name not in env.constraints:
                self.log(f"   [calibrate {name}: no such taxon or "
                         "constraint in the current taxon set]")
        for name in env.enforced_constraints:
            if name == "root":
                if "root" not in calibs:
                    cons.append(("root", np.ones(len(taxa), bool), None))
                continue
            if name not in env.constraints:
                raise CommandError(f"constraint {name!r} not defined")
            ctype, mask, mask2 = env.constraints[name]
            mask = mask[keep]
            if ctype == "hard":
                cons.append((name, mask, calibs.get(name)))
            else:
                cons.append((name, ctype, mask,
                             None if mask2 is None else mask2[keep],
                             calibs.get(name)))
        ts.constraints = cons

    MCMC_KEYS = ("ngen", "nruns", "nchains", "temp", "samplefreq",
                 "printfreq", "diagnfreq", "swapfreq", "nswaps",
                 "burninfrac", "relburnin", "stoprule", "stopval",
                 "filename", "checkfreq", "append", "seed", "swapseed",
                 "minpartfreq", "tune", "tunefreq", "nsteps", "alpha",
                 "burninss", "reheat", "diagnstat", "mcmcdiagn",
                 "printall", "printmax", "savebrlens", "checkpoint",
                 "autotune", "ordertaxa", "data",
                 "starttree", "startingtrees", "nperts", "startparams",
                 "reweight", "allchains", "allcomps", "savetrees")
    _MCMC_INT = {"ngen": "ngen", "n": "ngen", "nruns": "nruns",
                 "nchains": "nchains", "samplefreq": "samplefreq",
                 "printfreq": "printfreq", "diagnfreq": "diagnfreq",
                 "swapfreq": "swapfreq", "nswaps": "nswaps",
                 "checkfreq": "checkfreq", "seed": "seed",
                 "swapseed": "swapseed", "tunefreq": "tunefreq",
                 "nperts": "nperts"}
    _MCMC_FLOAT = ("temp", "burninfrac", "stopval", "minpartfreq")
    _MCMC_BOOL = {"relburnin": "relburnin", "stoprule": "stoprule",
                  "append": "append", "tune": "tune", "autotune": "tune",
                  "data": "use_data"}

    def _set_mcmc_params(self, args):
        mc = self.env.mcmc
        for key, val in self._kv_pairs(args):
            if not val:
                continue
            key = self._canon_strict(key, self.MCMC_KEYS, "mcmc")
            v = "".join(val)
            vl = v.lower()
            if key in self._MCMC_INT:
                setattr(mc, self._MCMC_INT[key], int(float(v)))
            elif key in self._MCMC_FLOAT:
                setattr(mc, key, float(v))
            elif key in self._MCMC_BOOL:
                setattr(mc, self._MCMC_BOOL[key], vl.startswith("y"))
            elif key in ("filename", "file"):
                mc.filename = v
            elif key == "savebrlens":
                if not vl.startswith("y"):
                    raise CommandError(
                        "savebrlens=no not supported: .t samples always "
                        "carry branch lengths")
            elif key == "checkpoint":
                if not vl.startswith("y"):
                    mc.checkfreq = 1 << 62   # effectively off
            elif key in ("starttree", "startingtrees"):
                if vl not in ("random", "current", "user", "parsimony",
                              "nj"):
                    raise CommandError(
                        f"starttree={v}: expected random, current, "
                        f"user, parsimony or nj")
                mc.starttree = vl
            elif key == "startparams":
                if vl not in ("reset", "current"):
                    raise CommandError(
                        f"startparams={v}: expected reset or current")
                mc.startparams = vl
            elif key in ("reweight", "allchains", "allcomps",
                         "savetrees"):
                # the reference's diagnostics and output toggles
                # (src/command.c:14644-14695), accepted with no effect
                self.log(f"   [mcmc {key}={v} accepted (no effect)]")
            # the rest are the reference's cosmetic options or the ss
            # keys do_ss reads, accepted with no effect here

    def do_mcmcp(self, args, base_dir):
        self._set_mcmc_params(args)

    def _analysis_mesh(self):
        """Device mesh for a run (mrbayes_tpu/cli.py:1123-1135): over
        several processes always ``auto_mesh`` (one chain shard a process,
        its device on ``sites``); in one process on a host with more than
        one CUDA device and ``MB_AUTOSHARD=1``, ``auto_mesh`` over every
        CUDA device (one chain shard, the devices on ``sites``); otherwise
        none."""
        import torch
        from .parallel.mesh import auto_mesh, process_count
        if process_count() > 1:
            try:
                return auto_mesh(self.env.mcmc.n_chains_total)
            except ValueError as e:
                raise CommandError(str(e)) from e
        if self.device.type != "cuda" or torch.cuda.device_count() <= 1 \
                or os.environ.get("MB_AUTOSHARD", "0") != "1":
            return None
        return auto_mesh(self.env.mcmc.n_chains_total)

    def _sharded(self, eng):
        """The mesh of a run on ``eng``, its data sharded over ``sites``
        (None without a mesh)."""
        mesh = self._analysis_mesh()
        if mesh is not None:
            from .parallel.mesh import shard_engine_data
            shard_engine_data(eng, mesh)
        return mesh

    def _timed_build(self):
        """(engine, spans mark): the engine of an analysis built inside the
        ``mcmc.engine_build`` span, and the spans' totals from just
        before it, so the run's ``phase_times`` include its build."""
        mark = SPANS.mark()
        SPANS.watch_profiler()
        with SPANS("mcmc.engine_build"):
            return self.build_engine(), mark

    def do_mcmc(self, args, base_dir):
        from .mcmc.run import McmcRunner
        self._set_mcmc_params(args)
        eng, mark = self._timed_build()
        mc = self.env.mcmc
        if eng.tree_settings.clock and (
                mc.starttree in ("random", "parsimony", "nj") or mc.nperts):
            self.log("   [starttree/nperts apply to non-clock trees; "
                     "clock runs keep their standard starting trees]")
        runner = McmcRunner(eng, log=self.log, report=self.env.report,
                            mesh=self._sharded(eng), span_mark=mark)
        runner.run()
        self._last_runner = runner

    def do_ss(self, args, base_dir):
        """ss [mcmc keys] nsteps=N alpha=a burninss=N — steppingstone
        sampling of the marginal likelihood (reference DoSs,
        src/mcmc.c:4057; mcmc/steppingstone.py)."""
        from .mcmc.steppingstone import SsRunner
        self._set_mcmc_params(args)
        nsteps, alpha, burninss = 50, 0.4, -1
        for key, val in self._kv_pairs(args):
            if key == "nsteps":
                nsteps = int(val[0])
            elif key == "alpha":
                alpha = float(val[0])
            elif key == "burninss":
                burninss = int(val[0])
        eng, _ = self._timed_build()
        runner = SsRunner(eng, nsteps=nsteps, alpha=alpha,
                          burninss=burninss, log=self.log,
                          mesh=self._sharded(eng))
        runner.run_ss()
        self._last_runner = runner

    def do_ssp(self, args, base_dir):
        """ssp — set steppingstone (mcmc) parameters without running."""
        self._set_mcmc_params(args)

    def do_sumss(self, args, base_dir):
        """sumss [filename=<prefix>] — summarize a .ss file (reference
        DoSumSs, src/sumpt.c:534)."""
        from .mcmc.steppingstone import sumss
        prefix = self.env.mcmc.filename
        for key, val in self._kv_pairs(args):
            if key in ("filename", "file"):
                prefix = val[0]
        sumss(prefix, log=self.log)

    COMPARETREE_KEYS = ("filename1", "filename2", "outputname", "burnin",
                        "burninfrac", "relburnin", "minpartfreq")
    COMPARETREE_NOOP = ("minpartfreq",)
    COMPAREREF_KEYS = ("filename1", "filename2", "outputname", "burnin",
                       "burninfrac", "relburnin", "minpartfreq", "nruns",
                       "diagnstat")
    PLOT_KEYS = ("filename", "file", "parameter", "match", "burnin",
                 "burninfrac", "relburnin")

    def do_comparetree(self, args, base_dir):
        """comparetree filename1=<.t> filename2=<.t> [outputname=] —
        split-frequency comparison of two tree samples (reference
        DoCompareTree, src/sumpt.c:3686)."""
        from .summarize.compare import comparetree
        kv = {}
        for key, val in self._kv_pairs(args):
            key = self._canon_strict(key, self.COMPARETREE_KEYS,
                                     "comparetree")
            if key in self.COMPARETREE_NOOP:
                self.log(f"   [comparetree option '{key}' accepted but "
                         f"has no effect here (ignored)]")
                continue
            kv[key] = val
        f1 = kv.get("filename1", [None])[0]
        f2 = kv.get("filename2", [None])[0]
        if not f1 or not f2:
            raise CommandError("comparetree needs filename1 and filename2")
        comparetree(f1, f2, outputname=kv.get("outputname", [None])[0],
                    burninfrac=self._burnin_frac(kv), log=self.log)

    def do_compareref(self, args, base_dir):
        """compareref: running SDSF of a tree-sample file against
        reference tree samples (reference DoCompRefTree,
        src/command.c:359, src/sumpt.c:4609; hidden command)."""
        from .summarize.compare import compareref
        kv = {}
        for key, val in self._kv_pairs(args):
            key = self._canon_strict(key, self.COMPAREREF_KEYS,
                                     "compareref")
            kv[key] = val
        f1 = kv.get("filename1", [None])[0]
        f2 = kv.get("filename2", [None])[0]
        if not f1 or not f2:
            raise CommandError("compareref needs filename1 and filename2")
        stat = "maxstddev" if kv.get("diagnstat", ["a"])[0].lower() \
            .startswith("m") else "avgstddev"
        compareref(f1, f2, outputname=kv.get("outputname", [f1])[0],
                   nruns=int(kv.get("nruns", [self.env.mcmc.nruns])[0]),
                   burninfrac=self._burnin_frac(kv),
                   minpartfreq=float(kv.get("minpartfreq", [0.1])[0]),
                   stat=stat, log=self.log)

    def do_plot(self, args, base_dir):
        """plot [filename=<prefix>] [parameter=<column>] — ASCII trace of
        a sampled parameter (reference DoPlot, src/sumpt.c)."""
        from .summarize.compare import plot
        kv = {}
        for key, val in self._kv_pairs(args):
            key = self._canon_strict(key, self.PLOT_KEYS, "plot")
            kv[key] = val
        prefix = self.env.mcmc.filename
        if "filename" in kv or "file" in kv:
            prefix = kv.get("filename", kv.get("file"))[0]
        if "match" in kv and kv["match"][0].lower() not in (
                "perfect", "consistentwith", "all"):
            raise CommandError("plot match must be "
                               "perfect|consistentwith|all")
        plot(prefix, parameter=kv.get("parameter", ["LnL"])[0],
             burninfrac=self._burnin_frac(kv), log=self.log)

    SUMP_KEYS = ("filename", "file", "outputname", "burnin", "burninfrac",
                 "relburnin", "nruns", "hpd", "printtofile", "plot",
                 "table", "minprob")
    SUMP_NOOP = ("table", "minprob")
    SUMT_KEYS = ("filename", "file", "outputname", "burnin", "burninfrac",
                 "relburnin", "nruns", "ntrees", "contype", "conformat",
                 "minpartfreq", "calctreeprobs", "showtreeprobs", "hpd",
                 "savebrparams", "minbrparamfreq", "ordertaxa", "table",
                 "summary", "consensus")
    SUMT_NOOP = ("showtreeprobs", "hpd", "savebrparams", "minbrparamfreq",
                 "ordertaxa", "table", "summary", "consensus")

    def _burnin_frac(self, kv):
        """Resolve the relburnin/burninfrac/burnin triplet into a
        fraction; an absolute ``burnin=N`` is taken relative to
        ngen/samplefreq samples, as the reference's default display
        does."""
        rel = kv.get("relburnin")
        frac = self.env.mcmc.burninfrac
        if "burninfrac" in kv:
            frac = float(kv["burninfrac"][0])
        if "burnin" in kv and (rel is None or
                               rel[0].lower().startswith("n")):
            n = int(kv["burnin"][0])
            total = max(1, self.env.mcmc.ngen // max(
                1, self.env.mcmc.samplefreq))
            frac = min(0.99, n / total)
        return frac

    def _summary_kv(self, args, keys, noop, cmd):
        kv = {}
        for key, val in self._kv_pairs(args):
            key = self._canon_strict(key, keys, cmd)
            if key in noop:
                self.log(f"   [{cmd} option '{key}' accepted but has no "
                         f"effect here (ignored)]")
                continue
            kv[key] = val
        prefix = self.env.mcmc.filename
        if "filename" in kv or "file" in kv:
            prefix = kv.get("filename", kv.get("file"))[0]
        return kv, prefix

    def do_sump(self, args, base_dir):
        from .summarize.compare import plot as trace_plot
        from .summarize.sump import sump
        kv, prefix = self._summary_kv(args, self.SUMP_KEYS, self.SUMP_NOOP,
                                      "sump")
        yes = lambda v: v[0].lower().startswith("y")  # noqa: E731
        burn = self._burnin_frac(kv)
        sump(prefix, burninfrac=burn, log=self.log,
             hpd=yes(kv["hpd"]) if "hpd" in kv else True,
             write_files=(yes(kv["printtofile"])
                          if "printtofile" in kv else True),
             outputname=kv.get("outputname", [None])[0],
             nruns=int(kv["nruns"][0]) if "nruns" in kv else None)
        if "plot" in kv and yes(kv["plot"]):
            trace_plot(prefix, parameter="LnL", burninfrac=burn,
                       log=self.log)

    def do_sumt(self, args, base_dir):
        from .summarize.sumt import sumt
        kv, prefix = self._summary_kv(args, self.SUMT_KEYS, self.SUMT_NOOP,
                                      "sumt")
        yes = lambda v: v[0].lower().startswith("y")  # noqa: E731
        allcompat = ("contype" in kv
                     and "allcompat" in kv["contype"][0].lower())
        conformat = "figtree"
        if "conformat" in kv:
            cf = kv["conformat"][0].lower()
            if not ("figtree".startswith(cf) or "simple".startswith(cf)):
                raise CommandError("sumt conformat must be "
                                   "figtree|simple")
            conformat = "simple" if "simple".startswith(cf) else "figtree"
        opts = dict(
            burninfrac=self._burnin_frac(kv), log=self.log,
            allcompat=allcompat, conformat=conformat,
            minpartfreq=(float(kv["minpartfreq"][0])
                         if "minpartfreq" in kv else 0.10),
            calctreeprobs=(yes(kv["calctreeprobs"])
                           if "calctreeprobs" in kv else True),
            outputname=kv.get("outputname", [None])[0],
            nruns=int(kv["nruns"][0]) if "nruns" in kv else None)
        # unlinked trees: one summary a tree parameter, from its
        # <prefix>.tree<t>.run<r>.t files (reference sumt loops numTrees,
        # src/sumpt.c:4899; mrbayes_tpu cli.py:1351-1375)
        tree_pfx = sorted({p.rsplit(".run", 1)[0] for p in
                           glob.glob(f"{prefix}.tree*.run*.t")})
        n_trees = len(tree_pfx) or 1
        if "ntrees" in kv and int(kv["ntrees"][0]) != n_trees:
            raise CommandError(f"sumt ntrees={kv['ntrees'][0]} but the "
                               f"analysis has {n_trees} tree parameters")
        for tp in tree_pfx or [prefix]:
            topts = dict(opts)
            if tree_pfx:
                self.log(f"   Summarizing tree parameter "
                         f"\"{tp[len(prefix) + 1:]}\"")
                if topts["outputname"]:
                    topts["outputname"] += tp[len(prefix):]
            sumt(tp, **topts)
            self.log("   Consensus tree written to "
                     f"\"{(topts['outputname'] or tp)}.con.tre\"")

    # ------------------------------------------------------------------
    # informational commands (mrbayes_tpu cli.py:1376-1580): a reference
    # drive file may call them, and they print what the JAX package's
    # print, except for the lines that name the framework or the device

    def do_showmodel(self, args, base_dir):
        """showmodel — each division's model and the branch-length prior
        (reference DoShowModel, src/command.c)."""
        self.env.ensure_div_settings()
        for i, s in enumerate(self.env.div_settings):
            self.log(f"   Division {i + 1}: nst={s.nst} rates={s.rates} "
                     f"ngammacat={s.ngammacat} statefreqpr="
                     f"{s.statefreqpr.kind}{s.statefreqpr.params}")
        ts = self.env.tree_settings
        self.log(f"   Brlens: {ts.brlenspr.kind}{ts.brlenspr.params} "
                 f"clock={ts.clock}")

    def do_showmatrix(self, args, base_dir):
        """showmatrix — the data matrix's size and datatype."""
        m = self.env.nexus.matrix
        self.log(f"   Matrix: {m.ntax} x {m.nchar} ({m.fmt.datatype.value})")

    def do_showmoves(self, args, base_dir):
        """showmoves — every move the sampler will use, with its weight,
        tuning parameter and autotune target (reference ShowMoves,
        src/command.c:271; the registry is Engine.moves)."""
        eng = self.build_engine()
        total = sum(m.weight for m in eng.moves)
        self.log("   Moves that will be used by the MCMC sampler:")
        self.log(f"   {'move':<22}{'rel.prob':>9}{'prob(%)':>9}"
                 f"{'tuning':>10}{'target':>8}{'autotune':>9}")
        for m in eng.moves:
            self.log(f"   {m.name:<22}{m.weight:>9.2f}"
                     f"{100.0 * m.weight / total:>9.1f}"
                     f"{m.tuning0:>10.4g}{m.target:>8.2f}"
                     f"{'yes' if m.tunable else 'no':>9}")
        self.log(f"   {len(eng.moves)} moves registered")

    def do_showparams(self, args, base_dir):
        """showparams — the model and prior settings of each division and
        the chain and run settings (reference 'showparams', src/command.c)."""
        self.env.ensure_div_settings()
        for i, s in enumerate(self.env.div_settings):
            self.log(f"   Division {i + 1}:")
            self.log(f"      lset: nst={s.nst} rates={s.rates} "
                     f"ngammacat={s.ngammacat} nucmodel={s.nucmodel} "
                     f"covarion={s.covarion} coding={s.coding} "
                     f"omegavar={s.omegavar} parsmodel={s.parsmodel}")
            for fld in ("statefreqpr", "revmatpr", "tratiopr", "shapepr",
                        "pinvarpr", "omegapr", "symdirihyperpr",
                        "aamodelpr"):
                pr = getattr(s, fld)
                self.log(f"      {fld} = {pr.kind}{pr.params}")
        ts = self.env.tree_settings
        self.log(f"   Tree: brlenspr={ts.brlenspr.kind}{ts.brlenspr.params}"
                 f" clock={ts.clock} clockpr={ts.clockpr} "
                 f"clockvarpr={ts.clockvarpr} "
                 f"topologypr={ts.topologypr.kind}")
        mc = self.env.mcmc
        self.log(f"   MCMC: ngen={mc.ngen} nruns={mc.nruns} "
                 f"nchains={mc.nchains} temp={mc.temp} "
                 f"samplefreq={mc.samplefreq} seed={mc.seed}")

    def do_charstat(self, args, base_dir):
        """charstat — included and excluded characters by datatype
        (reference DoCharStat, src/command.c)."""
        if self.env.nexus is None or self.env.nexus.matrix is None:
            raise CommandError("no data matrix read in")
        m = self.env.nexus.matrix
        n_excl = len(self.env.excluded)
        self.log(f"   Number of characters: {m.nchar}")
        self.log(f"   Included characters:  {m.nchar - n_excl}")
        self.log(f"   Excluded characters:  {n_excl}")
        by_dt: dict = {}
        for c in range(m.nchar):
            by_dt[m.col_datatype[c]] = by_dt.get(m.col_datatype[c], 0) + 1
        for dt, n in by_dt.items():
            self.log(f"      {dt.value}: {n}")
        if self.env.ctypes:
            n_ord = sum(1 for v in self.env.ctypes.values()
                        if v == "ordered")
            self.log(f"   Ordered characters:   {n_ord}")

    def do_taxastat(self, args, base_dir):
        """taxastat — each taxon, deleted or included (reference
        DoTaxaStat, src/command.c)."""
        if self.env.nexus is None:
            raise CommandError("no data matrix read in")
        taxa = self.env.nexus.taxa
        self.log(f"   Number of taxa: {len(taxa)}")
        for i, t in enumerate(taxa):
            mark = "deleted" if i in self.env.deleted else "included"
            self.log(f"   {i + 1:>4}  {t:<30} {mark}")

    def do_showusertrees(self, args, base_dir):
        """showusertrees — the user trees read from trees blocks
        (reference DoShowUserTrees, src/command.c)."""
        if not self.env.user_trees:
            self.log("   No user trees have been defined")
            return
        for name, nwk in self.env.user_trees.items():
            short = nwk if len(nwk) < 60 else nwk[:57] + "..."
            self.log(f"   Tree \"{name}\": {short}")

    def do_databreaks(self, args, base_dir):
        """databreaks — the datatype boundaries of a mixed matrix
        (reference DoDatabreaks, src/command.c)."""
        m = self.env.nexus.matrix
        breaks = [c for c in range(1, m.nchar)
                  if m.col_datatype[c] != m.col_datatype[c - 1]]
        if breaks:
            self.log("   Data breaks after characters: "
                     + " ".join(str(b) for b in breaks))
        else:
            self.log("   No data breaks (single datatype)")

    def do_citations(self, args, base_dir):
        """citations — what to cite."""
        self.log("   Ronquist F. et al. (2012) MrBayes 3.2: efficient "
                 "Bayesian phylogenetic inference and model choice across "
                 "a large model space. Syst. Biol. 61:539-542.")
        self.log("   This reimplementation: mrbayes_tpu_torch (PyTorch "
                 "and CUDA, with the MrBayes 3.2.8 capability surface).")

    def do_about(self, args, base_dir):
        """about — what this program is."""
        self.log("   mrbayes_tpu_torch — Bayesian phylogenetics on PyTorch "
                 "and CUDA (MrBayes 3.2 capability set)")

    def do_acknowledgments(self, args, base_dir):
        """acknowledgments — the authors of the original program."""
        self.log("   MrBayes was originally written by John Huelsenbeck "
                 "and Fredrik Ronquist;")
        self.log("   this reimplementation follows the 3.2 capability "
                 "surface.")

    def do_disclaimer(self, args, base_dir):
        """disclaimer — the warranty disclaimer."""
        self.log("   This software is distributed WITHOUT ANY WARRANTY, "
                 "express or implied.")

    def do_showbeagle(self, args, base_dir):
        """showbeagle — the likelihood library in use."""
        self.log("   BEAGLE is not used: likelihood evaluation runs on "
                 "the built-in CUDA kernels (the role BEAGLE plays in the "
                 "reference).")

    def do_showmcmctrees(self, args, base_dir):
        """showmcmctrees — where the chains' trees are kept."""
        self.log("   No MCMC trees are held between commands: chain "
                 "state lives on-device during mcmc and in the .ckp "
                 "checkpoint between runs (see 'mcmc append=yes').")

    def do_version(self, args, base_dir):
        """version — the program's version."""
        from . import __version__
        self.log(f"   Version {__version__}")

    def do_log(self, args, base_dir):
        """log start [filename=<file>] | stop — copy every message to a
        file (reference DoLog, src/command.c)."""
        kv = dict(self._kv_pairs(args))
        fname = (kv.get("filename") or kv.get("file") or [None])[0]
        if "stop" in kv or "start" in kv or fname:
            self._close_log()
        if "start" in kv or fname:
            self.env.logfile = open(fname or "log.out", "a")

    def _close_log(self):
        if self.env.logfile:
            self.env.logfile.close()
            self.env.logfile = None

    def do_help(self, args, base_dir):
        """help [command] — list commands, or show one command's
        documentation (reference autogenerated help, src/command.c)."""
        if args:
            name = args[0].lower()
            handler = getattr(self, f"do_{name}", None) \
                or self._abbrev_handler(name)
            if handler is None:
                raise CommandError(f"no such command {name!r}")
            doc = handler.__doc__ or "(no documentation)"
            for line in doc.splitlines():
                self.log("   " + line.strip())
            return
        cmds = sorted(m[3:] for m in dir(self) if m.startswith("do_"))
        self.log("   Available commands: " + " ".join(cmds))
        self.log("   'help <command>' shows details; full dump: 'manual'")

    def do_manual(self, args, base_dir):
        """manual [filename] — write the full command reference to a
        text file (reference DoManual, src/command.c:4991; its content is
        each handler's documentation)."""
        fname = args[0] if args else "commref.mbtpu.txt"
        with open(fname, "w") as f:
            f.write("mrbayes_tpu_torch command reference\n"
                    "===================================\n\n")
            for m in sorted(dir(self)):
                if not m.startswith("do_"):
                    continue
                doc = getattr(self, m).__doc__ or "(no documentation)"
                f.write(m[3:] + "\n" + "-" * len(m[3:]) + "\n")
                for line in doc.splitlines():
                    f.write(line.strip() + "\n")
                f.write("\n")
        self.log(f"   Command reference written to \"{fname}\"")


BANNER = """
                     mrbayes_tpu_torch v{version}
      Bayesian inference of phylogeny on PyTorch and CUDA
      (capability set of MrBayes 3.2.8, ported from mrbayes_tpu)
"""


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        prog="mrbayes_tpu_torch",
        description="Bayesian phylogenetics on a CUDA GPU (MrBayes 3.2 "
                    "capability set)")
    parser.add_argument("files", nargs="*", help="NEXUS batch files")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' to run "
                             "on the CPU, every rank with gloo)")
    # a launch over processes (replaces the reference's mpirun,
    # src/bayes.c:176-195): the same command on every rank with
    # --nprocs N --procid <i> --coordinator host:port
    parser.add_argument("--coordinator",
                        default=os.environ.get("MB_COORDINATOR"),
                        help="host:port of rank 0's store "
                             "(torch.distributed)")
    parser.add_argument("--nprocs", type=int,
                        default=int(os.environ.get("MB_NPROCS", 0)) or None)
    parser.add_argument("--procid", type=int,
                        default=(int(os.environ["MB_PROCID"])
                                 if "MB_PROCID" in os.environ else None))
    for name, env in (("multiwalk", "MB_TPU_MULTIWALK"),
                      ("wavefront", "MB_TPU_WAVEFRONT"),
                      ("stacked", "MB_TPU_STACKED")):
        parser.add_argument(f"--{name}", action="store_true", default=None,
                            help=f"turn the {name} kernel path on "
                                 f"(default: {env}, else off)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    from . import __version__
    device, is_main, note = args.device, True, None
    if args.coordinator:
        from .parallel.mesh import init_distributed
        if args.nprocs is None or args.procid is None:
            parser.error("--coordinator needs --nprocs and --procid")
        w = init_distributed(args.coordinator, args.nprocs, args.procid,
                             device=args.device)
        device, is_main = w.device, w.rank == 0
        note = (f"   Process group: {w.size} processes, backend "
                f"{w.backend}, rank 0 on {w.device}")
    interp = Interpreter(device=device, multiwalk=args.multiwalk,
                         wavefront=args.wavefront, stacked=args.stacked)
    if not is_main:
        # rank 0 prints, and the host-only commands run there only
        # (reference MrBayesPrint gating, src/utils.c:1136)
        interp._log_fn = lambda msg: None
        interp._worker = True
    else:
        print(BANNER.format(version=__version__))
        if note:
            print(note)
    if args.files:
        for path in args.files:
            interp.execute_file(path)
        if args.coordinator:
            from .parallel.mesh import shutdown_distributed
            shutdown_distributed()
        return 0
    # interactive REPL
    while not interp.env.quit_requested:
        try:
            line = input("mrbayes_tpu_torch > ")
        except EOFError:
            break
        line = line.strip().rstrip(";")
        if not line:
            continue
        try:
            interp.run_line(line)
        except Exception as e:  # the REPL keeps going
            print(f"   [!] {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
