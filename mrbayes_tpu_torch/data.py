"""Alignment → divisions → compressed site patterns.

The engine consumes, per *division* (partition subset), a dense tensor of
unique site patterns with integer weights — the reference's CompressData
(src/model.c:2466) produces the same information into bit-coded C arrays.
Here compression is a vectorized ``np.unique`` over columns.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from .nexus.datatypes import DataType
from .nexus.parser import CharacterMatrix


def parse_char_range(spec_tokens: list[str], nchar: int) -> list[int]:
    """Parse NEXUS character-range tokens like ``1-400`` ``401-.`` ``1-.\\3``
    ``5`` into a 0-based column list (reference: src/command.c range syntax).
    Accepts a token list (from the lexer) or raw strings containing ranges.
    """
    # glue standalone "-" tokens to their neighbors ("7", "-", "." → "7-.")
    merged: list[str] = []
    for tok in spec_tokens:
        if merged and (tok == "-" or merged[-1].endswith("-")
                       or merged[-1].endswith("\\")
                       or tok.startswith("\\")):
            merged[-1] += tok
        else:
            merged.append(tok)
    text = " ".join(merged)
    cols: list[int] = []
    for piece in text.replace(",", " ").split():
        m = re.fullmatch(r"(\d+|\.)(?:\s*-\s*(\d+|\.))?(?:\\(\d+))?", piece)
        if not m:
            raise ValueError(f"bad character range {piece!r}")
        lo = nchar if m.group(1) == "." else int(m.group(1))
        hi = lo if m.group(2) is None else (
            nchar if m.group(2) == "." else int(m.group(2)))
        step = int(m.group(3) or 1)
        cols.extend(range(lo - 1, hi, step))
    return cols


@dataclass
class Division:
    """One data subset with homogeneous datatype, pattern-compressed."""
    index: int
    dtype: DataType
    n_states: int
    patterns: np.ndarray        # [ntax, npat] uint32 state bitmasks
    weights: np.ndarray         # [npat] float64 pattern counts
    char_ids: np.ndarray        # original 0-based columns in this division
    pattern_of_char: np.ndarray  # [n_division_chars] -> pattern index
    # standard data: per-pattern number of observed states (for k-state split)
    name: str = ""
    user_index: int = 0          # index of the user-visible partition subset
    ctype: str = "unordered"     # standard data: unordered|ordered|irreversible
                                 # (reference ctype command, src/command.c:3009)
    cont: np.ndarray | None = None   # continuous chars [ntax, nchar_div]
                                     # (NaN = missing); patterns unused

    @property
    def ntax(self) -> int:
        return self.patterns.shape[0]

    @property
    def npat(self) -> int:
        return self.patterns.shape[1]

    def tip_partials(self, dtype=np.float32) -> np.ndarray:
        """Expand bitmasks to dense tip conditional likelihoods
        [ntax, npat, n_states] (1.0 for each compatible state)."""
        bits = (self.patterns[..., None] >> np.arange(self.n_states)) & 1
        return bits.astype(dtype)


def compress_columns(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse identical columns. Returns (patterns[ntax,npat],
    weights[npat], pattern_of_char[nchar])."""
    cols = np.ascontiguousarray(codes.T)  # [nchar, ntax]
    uniq, inverse, counts = np.unique(
        cols, axis=0, return_inverse=True, return_counts=True)
    return uniq.T, counts.astype(np.float64), inverse.astype(np.int64)


_NSTATES = {DataType.DNA: 4, DataType.RNA: 4, DataType.PROTEIN: 20,
            DataType.RESTRICTION: 2}


def make_divisions(matrix: CharacterMatrix,
                   partition: list[list[int]] | None = None,
                   names: list[str] | None = None,
                   excluded: set[int] | None = None,
                   ctype: dict[int, str] | None = None) -> list[Division]:
    """Build divisions from a partition (list of 0-based column lists).
    Without a partition, divisions follow datatype runs (one per datatype).
    Standard-data subsets are further split by observed state count so each
    division has a uniform state space (reference handles per-char state
    counts inside one division, src/model.c ProcessStdChars:16435 — we
    bucket instead to keep tensor shapes uniform).  ``ctype`` maps 0-based
    columns to "ordered"/"irreversible"; ordered standard characters bucket
    separately and get the ordered Mk Q (reference ctype,
    src/command.c:3009 + SetStdQMatrix src/likelihood.c:9257)."""
    nchar = matrix.nchar
    excluded = excluded or set()
    ctype = ctype or {}
    if partition is None:
        groups: dict[DataType, list[int]] = {}
        for c in range(nchar):
            groups.setdefault(matrix.col_datatype[c], []).append(c)
        partition = list(groups.values())
        names = [dt.value for dt in groups]
    divisions: list[Division] = []
    for gi, cols in enumerate(partition):
        cols = [c for c in cols if c not in excluded]
        if not cols:
            continue
        dts = {matrix.col_datatype[c] for c in cols}
        if len(dts) > 1:
            raise ValueError(f"partition subset {gi} mixes datatypes {dts}")
        dt = dts.pop()
        sub = matrix.codes[:, cols]
        if dt is DataType.CONTINUOUS:
            vals = matrix.cont_values[:, cols]
            if np.isnan(vals).any():
                raise ValueError(
                    "missing continuous values are not supported yet "
                    "(the PIC likelihood needs complete tip data)")
            divisions.append(Division(
                index=len(divisions), dtype=dt, n_states=0,
                patterns=np.zeros((matrix.ntax, 1), np.uint32),
                weights=np.ones(1), char_ids=np.array(cols),
                pattern_of_char=np.zeros(len(cols), np.int64),
                name=(names[gi] if names and gi < len(names)
                      else str(gi + 1)),
                user_index=gi, cont=vals))
            continue
        if dt is DataType.STANDARD:
            divisions.extend(_standard_subdivisions(sub, np.array(cols),
                                                    gi, names, matrix,
                                                    ctype))
            continue
        pats, w, inv = compress_columns(sub)
        divisions.append(Division(
            index=len(divisions), dtype=dt, n_states=_NSTATES[dt],
            patterns=pats, weights=w, char_ids=np.array(cols),
            pattern_of_char=inv,
            name=(names[gi] if names and gi < len(names) else str(gi + 1)),
            user_index=gi))
    for i, d in enumerate(divisions):
        d.index = i
    return divisions


def _standard_subdivisions(sub: np.ndarray, cols: np.ndarray, gi: int,
                           names: list[str] | None,
                           matrix: CharacterMatrix,
                           ctype: dict[int, str] | None = None
                           ) -> list[Division]:
    """Bucket standard (morphology) characters by (state-space size, ctype).
    A character's state space is 0..max observed symbol (reference counts
    observed states, src/model.c:16435).  Ordered characters with 2 states
    degrade to unordered (reference src/model.c:16525)."""
    ctype = ctype or {}
    full_mask = (1 << len(matrix.fmt.symbols)) - 1
    ncols = sub.shape[1]
    nstates_per_char = np.zeros(ncols, dtype=np.int64)
    for j in range(ncols):
        observed = 0
        for ti in range(sub.shape[0]):
            v = int(sub[ti, j])
            if v != full_mask:  # ignore missing
                observed |= v
        nstates_per_char[j] = max(2, observed.bit_length())
    # a wide enough string type: where every character is ordered, numpy
    # would size it to "ordered" and cut the "unordered" written below to
    # "unorder" (as the JAX package's copy does)
    ct_per_char = np.array([ctype.get(int(c), "unordered") for c in cols],
                           dtype="<U9")
    ct_per_char[(nstates_per_char == 2) & (ct_per_char == "ordered")] = \
        "unordered"
    out = []
    for k in sorted(set(nstates_per_char.tolist())):
        for ct in sorted(set(ct_per_char.tolist())):
            pick = np.where((nstates_per_char == k)
                            & (ct_per_char == ct))[0]
            if pick.size == 0:
                continue
            pats, w, inv = compress_columns(sub[:, pick])
            # clip missing masks to k states
            pats = pats & np.uint32((1 << k) - 1)
            tag = "" if ct == "unordered" else f".{ct[:3]}"
            out.append(Division(
                index=0, dtype=DataType.STANDARD, n_states=k,
                patterns=pats, weights=w, char_ids=cols[pick],
                pattern_of_char=inv,
                name=(names[gi] if names and gi < len(names)
                      else str(gi + 1)) + f".k{k}{tag}",
                user_index=gi, ctype=ct))
    return out


@dataclass
class DataSet:
    """Everything the model layer needs about the data."""
    taxa: list[str]
    nchar: int
    divisions: list[Division]
    charsets: dict[str, list[int]] = field(default_factory=dict)
    taxsets: dict[str, list[int]] = field(default_factory=dict)

    @property
    def ntax(self) -> int:
        return len(self.taxa)
