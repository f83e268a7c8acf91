"""``mb``-style command interpreter: runs reference NEXUS batch files on
the GPU.

Counterpart of ``mrbayes_tpu/cli.py`` for the commands the port carries:
execute, set, charset, taxset, partition, exclude/include, ctype,
constraint, calibrate, pairs, lset, prset, link/unlink, mcmc/mcmcp, sump,
sumt (one consensus a tree under ``unlink topology brlens``), quit.
Every other command of the reference interpreter raises ``CommandError``
naming the ROADMAP item that brings it.  Batch
mode: ``python -m mrbayes_tpu_torch.cli file.nex`` (on the GPU; add
``--device cpu`` to run on the CPU, and ``--multiwalk``, ``--wavefront``
or ``--stacked`` to turn on a kernel path, see ``Engine``); interactive
without arguments.  On a host with several CUDA devices, ``MB_AUTOSHARD=1``
shards each mcmc run's patterns over them (``_analysis_mesh``).
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
    enforced_constraints: list = field(default_factory=list)  # names
    current_partition: str | None = None
    # settings per user-division (list index = user division)
    div_settings: list = field(default_factory=list)
    tree_settings: TreeSettings = field(default_factory=TreeSettings)
    mcmc: McmcSettings = field(default_factory=McmcSettings)
    links: dict = field(default_factory=dict)   # param -> list[int] per div
    pairs: tuple = ()       # doublet pairs: ((i, j), ...) 0-based columns
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

# commands of mrbayes_tpu/cli.py not carried yet -> their ROADMAP item
NOT_PORTED = {
    **dict.fromkeys(("report", "ss", "ssp", "sumss", "comparetree",
                     "compareref", "plot", "propset", "startvals",
                     "speciespartition"), "Queue 1 item 14"),
    **dict.fromkeys(("delete", "restore", "outgroup", "usertree",
                     "showmodel",
                     "showmatrix", "showmoves", "showparams", "charstat",
                     "taxastat", "showusertrees", "databreaks",
                     "citations", "about", "acknowledgments", "disclaimer",
                     "showbeagle", "showmcmctrees", "version", "log",
                     "help", "manual"), "Queue 1 item 15"),
}
# prset parameters not carried yet -> their ROADMAP item
PRSET_NOT_PORTED = dict.fromkeys(("generatepr", "popvarpr", "ploidy"),
                                 "Queue 1 item 14")


# aamodelpr=fixed(<name>) (mrbayes_tpu cli.py:749-760)
AA_MODEL_NAMES = ("poisson", "jones", "dayhoff", "mtrev", "mtmam", "wag",
                  "rtrev", "cprev", "vt", "blosum", "lg", "equalin", "gtr")


def _not_ported(what: str, item: str) -> CommandError:
    return CommandError(f"{what} is not ported to mrbayes_tpu_torch yet "
                        f"(ROADMAP {item})")


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

    def log(self, msg: str):
        self._log_fn(msg)

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
    def run_command(self, toks: list[str], base_dir: str = "."):
        name = toks[0].lower()
        args = toks[1:]
        handler = getattr(self, f"do_{name}", None)
        if handler is None:
            handler = self._abbrev_handler(name)
        if handler is None:
            item = NOT_PORTED.get(name) or next(
                (v for k, v in NOT_PORTED.items() if k.startswith(name)),
                None)
            if item is not None:
                self.log(f"   [!] Command \"{name}\" is not ported yet")
                raise _not_ported(f"command {name!r}", item)
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
                raise _not_ported("set speciespartition", NOT_PORTED[key])
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
                  *FAMILY_KEYS, *PRSET_NOT_PORTED)

    def do_prset(self, args, base_dir):
        pairs = self._kv_pairs(args)
        targets = self._applyto(pairs)
        for key, val in pairs:
            key = self._canon_strict(key, self.PRSET_KEYS, "prset")
            if key == "applyto" or not val:
                continue
            if key in PRSET_NOT_PORTED:
                raise _not_ported(f"prset {key}", PRSET_NOT_PORTED[key])
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
            for d in targets:
                s = self.env.div_settings[d]
                if key == "ratepr":
                    s.ratepr = ("variable" if prior.kind.startswith("var")
                                or prior.kind == "dirichlet" else "fixed")
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
                raise _not_ported(f"brlenspr=clock:{kind}",
                                  "Queue 1 item 14")
            if kind not in ("uniform", "birthdeath", "coalescence",
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
        """topologypr=uniform|constraints(<names>) (mrbayes_tpu
        cli.py:765-773); speciestree is item 14's."""
        if prior.kind == "speciestree":
            raise _not_ported("topologypr=speciestree", "Queue 1 item 14")
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
        subsets = ([env.partitions[env.current_partition]]
                   if env.current_partition else [])
        divisions = make_divisions(matrix, *subsets, excluded=env.excluded,
                                   ctype=env.ctypes)
        ds = DataSet(taxa=taxa, nchar=matrix.nchar, divisions=divisions,
                     charsets=env.charsets, taxsets=env.taxsets)
        self._wire_dating(taxa)
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
                     **{**self.switches, **switches})
        for note in eng.notes:
            self.log(f"   [{note}]")
        return eng

    def _wire_dating(self, taxa: list[str]):
        """Resolve the calibrate and constraint declarations into
        TreeSettings (mrbayes_tpu cli.py:1105-1150; calibrations count only
        under nodeagepr=calibrated, cli.py:984-987)."""
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
            if ctype == "hard":
                cons.append((name, mask, calibs.get(name)))
            else:
                cons.append((name, ctype, mask, mask2, calibs.get(name)))
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
            # the rest are the reference's cosmetic or diagnostics-only
            # options, accepted with no effect

    def do_mcmcp(self, args, base_dir):
        self._set_mcmc_params(args)

    def _analysis_mesh(self):
        """Device mesh for a run (mrbayes_tpu/cli.py:1123-1135): on a host
        with more than one CUDA device and ``MB_AUTOSHARD=1``, ``auto_mesh``
        over every CUDA device; otherwise none.  A mesh of more than one
        chain shard is not ported yet (ROADMAP Queue 1 item 11b)."""
        import torch
        if self.device.type != "cuda" or torch.cuda.device_count() <= 1 \
                or os.environ.get("MB_AUTOSHARD", "0") != "1":
            return None
        from .parallel.mesh import auto_mesh
        try:
            return auto_mesh(self.env.mcmc.n_chains_total)
        except NotImplementedError as e:
            raise CommandError(f"MB_AUTOSHARD=1: {e}") from e

    def do_mcmc(self, args, base_dir):
        from .mcmc.run import McmcRunner
        self._set_mcmc_params(args)
        eng = self.build_engine()
        mesh = self._analysis_mesh()
        if mesh is not None:
            from .parallel.mesh import shard_engine_data
            shard_engine_data(eng, mesh)
        runner = McmcRunner(eng, log=self.log, mesh=mesh)
        runner.run()
        self._last_runner = runner

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
        from .summarize.sump import sump
        kv, prefix = self._summary_kv(args, self.SUMP_KEYS, self.SUMP_NOOP,
                                      "sump")
        yes = lambda v: v[0].lower().startswith("y")  # noqa: E731
        if "plot" in kv and yes(kv["plot"]):
            raise _not_ported("sump plot=yes", "Queue 1 item 14")
        sump(prefix, burninfrac=self._burnin_frac(kv), log=self.log,
             hpd=yes(kv["hpd"]) if "hpd" in kv else True,
             write_files=(yes(kv["printtofile"])
                          if "printtofile" in kv else True),
             outputname=kv.get("outputname", [None])[0],
             nruns=int(kv["nruns"][0]) if "nruns" in kv else None)

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
                             "on the CPU)")
    for name, env in (("multiwalk", "MB_TPU_MULTIWALK"),
                      ("wavefront", "MB_TPU_WAVEFRONT"),
                      ("stacked", "MB_TPU_STACKED")):
        parser.add_argument(f"--{name}", action="store_true", default=None,
                            help=f"turn the {name} kernel path on "
                                 f"(default: {env}, else off)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    from . import __version__
    interp = Interpreter(device=args.device, multiwalk=args.multiwalk,
                         wavefront=args.wavefront, stacked=args.stacked)
    print(BANNER.format(version=__version__))
    if args.files:
        for path in args.files:
            interp.execute_file(path)
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
