"""Genetic codes and codon state spaces.

Codons are indexed 0..63 in (first, second, third) base order with bases
A=0, C=1, G=2, T=3 (so AAA=0, AAC=1, ..., TTT=63 — the reference's codon
ordering, src/model.c:18296 SetCode).  A code maps codons to amino acids
(standard one-letter) with '*' for stop; sense codons form the model's
state space (61 for the universal code).
"""
from __future__ import annotations

import numpy as np

BASES = "ACGT"

# universal code, codon index order AAA..TTT
_UNIVERSAL = (
    "KNKN" "TTTT" "RSRS" "IIMI"      # AA- AC- AG- AT-
    "QHQH" "PPPP" "RRRR" "LLLL"      # CA- CC- CG- CT-
    "EDED" "AAAA" "GGGG" "VVVV"      # GA- GC- GG- GT-
    "*Y*Y" "SSSS" "*CWC" "LFLF"      # TA- TC- TG- TT-
)


def _with(base: str, changes: dict[str, str]) -> str:
    s = list(base)
    for codon, aa in changes.items():
        i = BASES.index(codon[0]) * 16 + BASES.index(codon[1]) * 4 \
            + BASES.index(codon[2])
        s[i] = aa
    return "".join(s)


# reference code variants (src/model.c SetCode; NCBI translation tables)
GENETIC_CODES: dict[str, str] = {
    "universal": _UNIVERSAL,
    "vertmt": _with(_UNIVERSAL, {"AGA": "*", "AGG": "*", "ATA": "M",
                                 "TGA": "W"}),
    "invermt": _with(_UNIVERSAL, {"AGA": "S", "AGG": "S", "ATA": "M",
                                  "TGA": "W"}),
    "mycoplasma": _with(_UNIVERSAL, {"TGA": "W"}),
    "yeast": _with(_UNIVERSAL, {"ATA": "M", "CTA": "T", "CTC": "T",
                                "CTG": "T", "CTT": "T", "TGA": "W"}),
    "ciliate": _with(_UNIVERSAL, {"TAA": "Q", "TAG": "Q"}),
    "echinoderm": _with(_UNIVERSAL, {"AAA": "N", "AGA": "S", "AGG": "S",
                                     "TGA": "W"}),
    "euplotid": _with(_UNIVERSAL, {"TGA": "C"}),
}
GENETIC_CODES["metmt"] = GENETIC_CODES["invermt"]
GENETIC_CODES["ciliates"] = GENETIC_CODES["ciliate"]


class CodonCode:
    def __init__(self, name: str = "universal"):
        name = name.lower()
        if name not in GENETIC_CODES:
            raise ValueError(f"unknown genetic code {name!r}")
        self.name = name
        self.aa64 = GENETIC_CODES[name]
        self.sense = np.array([i for i, a in enumerate(self.aa64)
                               if a != "*"], dtype=np.int64)
        self.n_states = len(self.sense)
        self.aa = np.array([ord(self.aa64[i]) for i in self.sense])
        # base composition of each sense codon: [n_states, 3]
        self.bases = np.stack([self.sense // 16, (self.sense // 4) % 4,
                               self.sense % 4], axis=1)

    def pair_classes(self):
        """For each sense-codon pair (i<j): (is_single_change, is_transition,
        is_nonsynonymous) — the NY98 rate structure (reference
        src/likelihood.c SetNucQMatrix codon branch)."""
        n = self.n_states
        b = self.bases
        diff = (b[:, None, :] != b[None, :, :])
        ndiff = diff.sum(-1)
        single = ndiff == 1
        # the changed position's bases
        pos = np.argmax(diff, axis=-1)
        from_b = np.take_along_axis(b[:, None, :].repeat(n, 1),
                                    pos[..., None], axis=-1)[..., 0]
        to_b = np.take_along_axis(b[None, :, :].repeat(n, 0),
                                  pos[..., None], axis=-1)[..., 0]
        transition = ((from_b == 0) & (to_b == 2)) | \
                     ((from_b == 2) & (to_b == 0)) | \
                     ((from_b == 1) & (to_b == 3)) | \
                     ((from_b == 3) & (to_b == 1))
        nonsyn = self.aa[:, None] != self.aa[None, :]
        return single, transition & single, nonsyn & single
