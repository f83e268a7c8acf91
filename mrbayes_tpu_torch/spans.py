"""Host spans and work counters: where a run's host time goes, layer by
layer, with no profiler running.

A span is a named stretch of host time on ``time.perf_counter_ns()``:

    from mrbayes_tpu_torch.spans import SPANS
    with SPANS("gen.lnl"):
        lnL = eng.log_likelihood(state)

Its parent is the span open when it began.  The recorder keeps, per
name, the count, the inclusive nanoseconds and the self nanoseconds (the
inclusive time less its children's), and per counter name a running
total; it keeps no list of events.  A span reads no device value, makes
no synchronisation and allocates nothing on a device: in a card-paced
run the host blocks inside launch calls once the launch queue is full,
and a span around such calls absorbs that wait like any other host time.

``watch_profiler`` reads whether ``torch.profiler`` is recording (the
engine asks once a block, the run driver and the CLI once a command).
While it is, each span also opens a ``torch.profiler.record_function``
range of its name, so the spans sit in a device trace on the profiler's
own clock; while it is not, no range is made.

Readers take a ``mark()`` before the work and ``since(mark)`` after it:
the totals of that stretch alone (``McmcRunner.phase_times`` is the view
of its own ``mcmc`` command, the CLI's engine build included).
"""
from __future__ import annotations

import time

import torch

_clock = time.perf_counter_ns


class Recorder:
    """Per-name span totals and counters of one process."""

    def __init__(self):
        self.stats: dict[str, list[int]] = {}   # name -> [count, incl, self]
        self.counters: dict[str, int] = {}
        self._open: list[list] = []   # [name, range, start ns, children ns]
        self._name = ""
        self.profiling = False

    def watch_profiler(self) -> None:
        """Read whether ``torch.profiler`` records now: spans opened from
        here on open a range of their name while it does."""
        self.profiling = bool(torch._C._autograd._profiler_enabled())

    def __call__(self, name: str) -> "Recorder":
        self._name = name
        return self

    def __enter__(self):
        rf = None
        if self.profiling:
            rf = torch.profiler.record_function(self._name)
            rf.__enter__()
        self._open.append([self._name, rf, _clock(), 0])

    def __exit__(self, *exc):
        end = _clock()
        name, rf, start, children = self._open.pop()
        if rf is not None:
            rf.__exit__(*exc)
        dur = end - start
        if self._open:
            self._open[-1][3] += dur
        s = self.stats.get(name)
        if s is None:
            s = self.stats[name] = [0, 0, 0]
        s[0] += 1
        s[1] += dur
        s[2] += dur - children
        return False

    def add(self, counter: str, n: int) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def mark(self):
        """The totals now, for ``since``."""
        return ({k: tuple(v) for k, v in self.stats.items()},
                dict(self.counters))

    def since(self, mark) -> dict:
        """The spans and counters of the stretch after ``mark`` as plain
        numbers: ``<span>.count``, ``<span>.incl_s`` and ``<span>.self_s``
        for every span closed in it, and each counter under its name."""
        stats0, counters0 = mark
        out: dict = {}
        for name, (n, incl, own) in self.stats.items():
            n0, incl0, own0 = stats0.get(name, (0, 0, 0))
            if n > n0:
                out[f"{name}.count"] = n - n0
                out[f"{name}.incl_s"] = (incl - incl0) / 1e9
                out[f"{name}.self_s"] = (own - own0) / 1e9
        for name, v in self.counters.items():
            out[name] = v - counters0.get(name, 0)
        return out


SPANS = Recorder()


def self_seconds(view: dict) -> dict[str, float]:
    """{span: self seconds} of a ``since`` view, largest first."""
    out = {k[:-len(".self_s")]: v for k, v in view.items()
           if k.endswith(".self_s")}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
