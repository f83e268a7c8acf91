"""NEXUS tokenizer.

Token rules follow the NEXUS standard as implemented by the reference
interpreter (reference: src/command.c:9399 GetToken): whitespace separates
tokens; the punctuation characters ``=;,:()[]{}<>/\\`` are single-character
tokens; square-bracket comments nest and are skipped; single-quoted tokens
may contain anything (with '' as an escaped quote); an unquoted token is a
maximal run of non-whitespace, non-punctuation characters.  ``-`` is NOT
punctuation here (it appears inside sequences and negative numbers); range
dashes are handled by the parser.
"""
from __future__ import annotations

PUNCT = set("=;,:(){}[]<>")


def tokenize(text: str) -> list[str]:
    toks: list[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if c == "[":
            depth = 1
            i += 1
            while i < n and depth:
                if text[i] == "[":
                    depth += 1
                elif text[i] == "]":
                    depth -= 1
                i += 1
            continue
        if c == "'":
            i += 1
            buf = []
            while i < n:
                if text[i] == "'":
                    if i + 1 < n and text[i + 1] == "'":
                        buf.append("'")
                        i += 2
                        continue
                    i += 1
                    break
                buf.append(text[i])
                i += 1
            toks.append("".join(buf).replace(" ", "_"))
            continue
        if c in PUNCT:
            toks.append(c)
            i += 1
            continue
        j = i
        while j < n and not text[j].isspace() and text[j] not in PUNCT and text[j] not in "['":
            j += 1
        toks.append(text[i:j])
        i = j
    return toks


class TokenStream:
    def __init__(self, tokens: list[str]):
        self.toks = tokens
        self.pos = 0

    def peek(self) -> str | None:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of input")
        self.pos += 1
        return t

    def expect(self, tok: str) -> str:
        t = self.next()
        if t.lower() != tok.lower():
            raise ValueError(f"expected {tok!r}, got {t!r}")
        return t

    def eof(self) -> bool:
        return self.pos >= len(self.toks)

    def until(self, stop: str) -> list[str]:
        """Collect tokens up to (and consuming) the stop token."""
        out = []
        while True:
            t = self.next()
            if t == stop:
                return out
            out.append(t)
