"""Character-state coding for NEXUS data types.

States are bit-coded: state i is represented by bit (1 << i); ambiguity and
polymorphism are unions of bits; missing is the all-ones mask. This mirrors
the reference engine's bit coding of the compressed matrix (reference:
src/model.c:2466 CompressData, src/command.c:5143 DoMatrix) but is an
independent design: we keep one uint32 bitmask per (taxon, site) cell and
expand to dense tip partials on device later.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class DataType(enum.Enum):
    DNA = "dna"
    RNA = "rna"
    PROTEIN = "protein"
    RESTRICTION = "restriction"
    STANDARD = "standard"
    CONTINUOUS = "continuous"
    MIXED = "mixed"


# --- nucleotides -----------------------------------------------------------
# order A, C, G, T (reference order; src/bayes.h state order)
_NUC_BITS = {"a": 1, "c": 2, "g": 4, "t": 8, "u": 8}
_NUC_AMBIG = {
    "r": 1 | 4,           # A/G
    "y": 2 | 8,           # C/T
    "m": 1 | 2,           # A/C
    "k": 4 | 8,           # G/T
    "s": 2 | 4,           # C/G
    "w": 1 | 8,           # A/T
    "h": 1 | 2 | 8,       # A/C/T
    "b": 2 | 4 | 8,       # C/G/T
    "v": 1 | 2 | 4,       # A/C/G
    "d": 1 | 4 | 8,       # A/G/T
    "n": 15,
    "x": 15,
    "?": 15,
    "-": 15,              # gaps treated as missing for likelihood
}

# --- amino acids -----------------------------------------------------------
# order: A R N D C Q E G H I L K M F P S T W Y V  (reference src/model.c aa order)
AA_ORDER = "arndcqeghilkmfpstwyv"
_AA_BITS = {ch: 1 << i for i, ch in enumerate(AA_ORDER)}
_AA_ALL = (1 << 20) - 1
_AA_AMBIG = {
    "b": _AA_BITS["n"] | _AA_BITS["d"],
    "z": _AA_BITS["q"] | _AA_BITS["e"],
    "x": _AA_ALL,
    "?": _AA_ALL,
    "-": _AA_ALL,
}

# --- restriction (binary) --------------------------------------------------
_RES_BITS = {"0": 1, "1": 2, "?": 3, "-": 3}

# --- standard (morphology): up to 10 numbered states + letters -------------
_STD_SYMBOLS = "0123456789"


@dataclass
class FormatInfo:
    datatype: DataType = DataType.DNA
    gap: str = "-"
    missing: str = "?"
    matchchar: str | None = None
    interleave: bool = False
    symbols: str = _STD_SYMBOLS
    # for mixed datatypes: list of (datatype, first_col, last_col) 1-based inclusive
    mixed_ranges: list | None = None

    def datatype_for_col(self, col0: int) -> DataType:
        if self.datatype is not DataType.MIXED:
            return self.datatype
        for dt, lo, hi in self.mixed_ranges or []:
            if lo - 1 <= col0 <= hi - 1:
                return dt
        raise ValueError(f"column {col0 + 1} not covered by mixed() ranges")


def n_states(dt: DataType) -> int:
    return {
        DataType.DNA: 4,
        DataType.RNA: 4,
        DataType.PROTEIN: 20,
        DataType.RESTRICTION: 2,
        DataType.STANDARD: 10,  # max; per-character counts derived from data
    }[dt]


def encode_char(ch: str, dt: DataType, fmt: FormatInfo) -> int:
    """Encode a single data-matrix character into a state bitmask."""
    c = ch.lower()
    if c == fmt.gap.lower() or c == fmt.missing.lower():
        if dt in (DataType.DNA, DataType.RNA):
            return 15
        if dt is DataType.PROTEIN:
            return _AA_ALL
        if dt is DataType.RESTRICTION:
            return 3
        if dt is DataType.STANDARD:
            return (1 << len(fmt.symbols)) - 1
    if dt in (DataType.DNA, DataType.RNA):
        if c in _NUC_BITS:
            return _NUC_BITS[c]
        if c in _NUC_AMBIG:
            return _NUC_AMBIG[c]
        raise ValueError(f"bad nucleotide character {ch!r}")
    if dt is DataType.PROTEIN:
        if c in _AA_BITS:
            return _AA_BITS[c]
        if c in _AA_AMBIG:
            return _AA_AMBIG[c]
        raise ValueError(f"bad protein character {ch!r}")
    if dt is DataType.RESTRICTION:
        if c in _RES_BITS:
            return _RES_BITS[c]
        raise ValueError(f"bad restriction character {ch!r}")
    if dt is DataType.STANDARD:
        idx = fmt.symbols.lower().find(c)
        if idx >= 0:
            return 1 << idx
        raise ValueError(f"bad standard character {ch!r} (symbols={fmt.symbols})")
    raise ValueError(f"cannot encode for datatype {dt}")


def bits_to_states(mask: int, ns: int) -> list[int]:
    return [i for i in range(ns) if mask & (1 << i)]
