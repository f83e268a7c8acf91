"""NEXUS file parser: data/taxa/characters/trees/mrbayes blocks.

Produces a :class:`NexusFile` with the character matrix (bit-coded), taxa,
any trees (with translate table), and the raw command list from ``mrbayes``
blocks for the execution layer.  Behavioral model: the reference interpreter
(src/command.c DoMatrix:5143, DoFormat:4061, DoTranslate, DoTreeParm:8165);
the implementation is original.  Commands are split at the raw-text level
(respecting comments/quotes) because ``matrix`` bodies are line-structured
when interleaved.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from .datatypes import DataType, FormatInfo, encode_char
from .lexer import TokenStream, tokenize


@dataclass
class CharacterMatrix:
    taxa: list[str]
    nchar: int
    fmt: FormatInfo
    codes: np.ndarray             # [ntax, nchar] uint32 state bitmasks
    col_datatype: list[DataType]  # per-column datatype (mixed support)
    # continuous (Brownian-motion) characters: real values, NaN =
    # missing; codes entries for continuous columns are 0 (reference
    # reads continuous cells as reals, src/command.c DoMatrixParm
    # CONTINUOUS branch — its likelihood is an unimplemented stub,
    # src/likelihood.c:7554; ours is real, ops/brownian.py)
    cont_values: np.ndarray | None = None

    @property
    def ntax(self) -> int:
        return len(self.taxa)


@dataclass
class NexusTree:
    name: str
    newick: str
    rooted: bool | None = None


@dataclass
class NexusFile:
    matrix: CharacterMatrix | None = None
    taxa: list[str] = field(default_factory=list)
    translate: dict[str, str] = field(default_factory=dict)
    trees: list[NexusTree] = field(default_factory=list)
    commands: list[list[str]] = field(default_factory=list)  # mrbayes-block cmds


# ---------------------------------------------------------------------------
# raw-text splitting (comment/quote aware)

def _strip_comments(text: str, keep_tree_hints: bool = False) -> str:
    """Remove [...] comments (nested). Newlines inside comments are kept so
    line structure survives."""
    out = []
    i, n, depth = 0, len(text), 0
    while i < n:
        c = text[i]
        if c == "[":
            depth += 1
        elif c == "]" and depth:
            depth -= 1
        elif depth == 0:
            out.append(c)
        elif c == "\n":
            out.append("\n")
        i += 1
    return "".join(out)


def _split_semicolons(text: str) -> list[str]:
    """Split on ';' outside single quotes."""
    parts, buf, inq = [], [], False
    for c in text:
        if c == "'":
            inq = not inq
            buf.append(c)
        elif c == ";" and not inq:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(c)
    if "".join(buf).strip():
        parts.append("".join(buf))
    return parts


# ---------------------------------------------------------------------------
# matrix parsing (line-based; interleave-safe)

_LABEL_RE = re.compile(r"^\s*(\'[^\']*\'|\S+)\s*(.*)$", re.S)


def _parse_matrix_text(body: str, ntax: int, nchar: int,
                       fmt: FormatInfo) -> CharacterMatrix:
    col_dt = [fmt.datatype_for_col(c) if fmt.datatype is DataType.MIXED
              else fmt.datatype for c in range(nchar)]
    if fmt.datatype is DataType.CONTINUOUS:
        return _parse_continuous_matrix(body, ntax, nchar, fmt)
    if DataType.CONTINUOUS in col_dt:
        raise ValueError(
            "continuous characters inside a mixed() matrix are not "
            "supported; put them in their own data/characters block")
    codes = np.zeros((ntax, nchar), dtype=np.uint32)
    taxa: list[str] = []
    filled = np.zeros(ntax, dtype=np.int64)

    def taxon_index(name: str) -> int:
        if name.startswith("'"):
            name = name.strip("'").replace(" ", "_")
        if name in taxa:
            return taxa.index(name)
        taxa.append(name)
        return len(taxa) - 1

    for line in body.splitlines():
        line = line.strip()
        if not line:
            continue
        m = _LABEL_RE.match(line)
        if not m:
            continue
        label, seq = m.group(1), m.group(2)
        ti = taxon_index(label)
        col = int(filled[ti])
        i = 0
        while i < len(seq):
            ch = seq[i]
            if ch.isspace():
                i += 1
                continue
            if ch in "({":
                close = ")" if ch == "(" else "}"
                j = seq.index(close, i)
                mask = 0
                for g in seq[i + 1:j]:
                    if not g.isspace() and g != ",":
                        mask |= encode_char(g, col_dt[col], fmt)
                codes[ti, col] = mask
                col += 1
                i = j + 1
                continue
            if col >= nchar:
                raise ValueError(f"too many characters for taxon {taxa[ti]!r}")
            if fmt.matchchar and ch == fmt.matchchar:
                codes[ti, col] = codes[0, col]
            else:
                codes[ti, col] = encode_char(ch, col_dt[col], fmt)
            col += 1
            i += 1
        filled[ti] = col
    if len(taxa) != ntax:
        raise ValueError(f"expected {ntax} taxa, found {len(taxa)}: {taxa}")
    if not np.all(filled == nchar):
        bad = {taxa[i]: int(filled[i]) for i in range(ntax) if filled[i] != nchar}
        raise ValueError(f"matrix rows incomplete (want {nchar}): {bad}")
    return CharacterMatrix(taxa=taxa, nchar=nchar, fmt=fmt, codes=codes,
                           col_datatype=col_dt)


def _parse_continuous_matrix(body: str, ntax: int, nchar: int,
                             fmt: FormatInfo) -> CharacterMatrix:
    """Continuous matrix: whitespace-separated reals per taxon row;
    '?' / gap = missing (NaN).  Interleave-safe like the discrete
    reader."""
    vals = np.full((ntax, nchar), np.nan)
    taxa: list[str] = []
    filled = np.zeros(ntax, dtype=np.int64)

    def taxon_index(name: str) -> int:
        if name.startswith("'"):
            name = name.strip("'").replace(" ", "_")
        if name in taxa:
            return taxa.index(name)
        taxa.append(name)
        return len(taxa) - 1

    for line in body.splitlines():
        line = line.strip()
        if not line:
            continue
        m = _LABEL_RE.match(line)
        if not m:
            continue
        ti = taxon_index(m.group(1))
        col = int(filled[ti])
        for tok in m.group(2).split():
            if col >= nchar:
                raise ValueError(
                    f"too many continuous values for taxon {taxa[ti]!r}")
            if tok in (fmt.missing, fmt.gap):
                vals[ti, col] = np.nan
            else:
                vals[ti, col] = float(tok)
            col += 1
        filled[ti] = col
    if len(taxa) != ntax:
        raise ValueError(f"expected {ntax} taxa, found {len(taxa)}")
    if not np.all(filled == nchar):
        bad = {taxa[i]: int(filled[i]) for i in range(ntax)
               if filled[i] != nchar}
        raise ValueError(f"matrix rows incomplete (want {nchar}): {bad}")
    return CharacterMatrix(
        taxa=taxa, nchar=nchar, fmt=fmt,
        codes=np.zeros((ntax, nchar), np.uint32),
        col_datatype=[DataType.CONTINUOUS] * nchar, cont_values=vals)


# ---------------------------------------------------------------------------
# format command

def _parse_format(tokens: list[str]) -> FormatInfo:
    fmt = FormatInfo()
    ts = TokenStream(tokens)
    while not ts.eof():
        key = ts.next().lower()
        if ts.peek() == "=":
            ts.next()
            if key == "datatype":
                val = ts.next().lower()
                if val == "mixed":
                    ranges = []
                    ts.expect("(")
                    while True:
                        dt = DataType(ts.next().lower())
                        ts.expect(":")
                        # range may come as one token ("1-516", "517-.") or
                        # split across tokens ("1", "-", "516")
                        rtok = ts.next()
                        while ts.peek() not in (",", ")"):
                            rtok += ts.next()
                        m = re.fullmatch(r"(\d+)(?:-(\d+|\.))?", rtok)
                        if not m:
                            raise ValueError(f"bad mixed() range {rtok!r}")
                        lo = int(m.group(1))
                        hi = lo if m.group(2) is None else (
                            10 ** 9 if m.group(2) == "." else int(m.group(2)))
                        ranges.append((dt, lo, hi))
                        nxt = ts.next()
                        if nxt == ")":
                            break
                        assert nxt == ",", f"bad mixed() syntax near {nxt}"
                    fmt.datatype = DataType.MIXED
                    fmt.mixed_ranges = ranges
                else:
                    fmt.datatype = DataType(val)
            elif key == "gap":
                fmt.gap = ts.next()
            elif key == "missing":
                fmt.missing = ts.next()
            elif key == "matchchar":
                fmt.matchchar = ts.next()
            elif key == "symbols":
                sym = ts.next()
                fmt.symbols = sym.replace('"', "").replace(" ", "")
            elif key == "interleave":
                fmt.interleave = ts.next().lower() in ("yes", "y", "true")
            else:
                ts.next()
        elif key == "interleave":
            fmt.interleave = True
    return fmt


# ---------------------------------------------------------------------------
# top-level parse

_BEGIN_RE = re.compile(r"begin\s+(\w+)\s*;", re.I)
_END_RE = re.compile(r"(?:^|\W)end(?:block)?\s*;", re.I)


def parse_nexus(text: str, path: str | None = None,
                out: NexusFile | None = None) -> NexusFile:
    nf = out or NexusFile()
    if not text.lstrip().lower().startswith("#nexus"):
        raise ValueError("not a NEXUS file (missing #NEXUS header)")
    clean = _strip_comments(text)
    pos = 0
    while True:
        m = _BEGIN_RE.search(clean, pos)
        if not m:
            break
        block = m.group(1).lower()
        e = _END_RE.search(clean, m.end())
        body = clean[m.end(): e.start() if e else len(clean)]
        pos = e.end() if e else len(clean)
        cmd_texts = [c for c in _split_semicolons(body) if c.strip()]
        if block in ("data", "characters"):
            _handle_data_block(cmd_texts, nf)
        elif block == "taxa":
            _handle_taxa_block(cmd_texts, nf)
        elif block == "trees":
            _handle_trees_block(cmd_texts, nf)
        elif block == "mrbayes":
            nf.commands.extend(tokenize(c) for c in cmd_texts)
    return nf


def _handle_data_block(cmd_texts: list[str], nf: NexusFile) -> None:
    ntax = len(nf.taxa) or None
    nchar = None
    fmt = FormatInfo()
    for ctext in cmd_texts:
        toks = ctext.split(None, 1)
        name = toks[0].lower() if toks else ""
        if name == "dimensions":
            s = ctext.lower().replace(" ", "")
            m = re.search(r"ntax=(\d+)", s)
            if m:
                ntax = int(m.group(1))
            m = re.search(r"nchar=(\d+)", s)
            if m:
                nchar = int(m.group(1))
        elif name == "format":
            fmt = _parse_format(tokenize(ctext)[1:])
        elif name == "matrix":
            if ntax is None or nchar is None:
                raise ValueError("matrix before dimensions")
            body = ctext.split(None, 1)[1] if len(toks) > 1 else ""
            nf.matrix = _parse_matrix_text(body, ntax, nchar, fmt)
            nf.taxa = nf.matrix.taxa


def _handle_taxa_block(cmd_texts: list[str], nf: NexusFile) -> None:
    for ctext in cmd_texts:
        toks = tokenize(ctext)
        if toks and toks[0].lower() == "taxlabels":
            nf.taxa = toks[1:]


def _handle_trees_block(cmd_texts: list[str], nf: NexusFile) -> None:
    for ctext in cmd_texts:
        toks = tokenize(ctext)
        if not toks:
            continue
        name = toks[0].lower()
        if name == "translate":
            items = [t for t in toks[1:] if t != ","]
            for i in range(0, len(items) - 1, 2):
                nf.translate[items[i]] = items[i + 1]
        elif name == "tree":
            tname = toks[1] if len(toks) > 1 else "tree"
            try:
                i = toks.index("=")
            except ValueError:
                i = 1
            newick = "".join(toks[i + 1:])
            for num, label in nf.translate.items():
                newick = re.sub(rf"(?<=[(,]){re.escape(num)}(?=[:,)])",
                                label, newick)
            nf.trees.append(NexusTree(name=tname, newick=newick))


def read_nexus_file(path: str, out: NexusFile | None = None) -> NexusFile:
    with open(path) as f:
        return parse_nexus(f.read(), path=path, out=out)
