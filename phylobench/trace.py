"""Spans around the program's layers, and the traced window's reduction.

The spans are the benchmark's own: ``instrument`` replaces an engine
instance's ``log_likelihood`` and ``refresh_eigs`` by wrappers that open
a ``torch.profiler.record_function`` range and count the calls; nothing
inside the program changes.  ``Window`` runs ``torch.profiler`` with CPU
and CUDA activities over one stretch of the run and reduces its raw
events (kineto's, without building the profiler's Python event tree) to
the numbers the per-layer metrics read:

* every device operation's interval, hence the busy time (the union of
  the intervals), the idle gaps between them and the kernels' count;
* the host time inside each range;
* the device time of the kernels launched inside the ``log_likelihood``
  ranges: a kernel belongs to the range in which the host launched it.
  Each device operation shares its correlation id with the CUDA runtime
  call that launched it (``cudaLaunchKernel`` and the like, also for the
  port's own libraries, which no ATen operator encloses); that call's
  start tells whether it lies inside a range.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

LOGLIK = "phylobench.log_likelihood"
EIGS = "phylobench.refresh_eigs"
RANGES = (LOGLIK, EIGS)


def instrument(eng, counts: dict):
    """Wrap ``eng``'s likelihood and eigensystem refresh in ranges."""
    from torch.profiler import record_function

    def wrap(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    eng.log_likelihood = wrap(LOGLIK, eng.log_likelihood)
    eng.refresh_eigs = wrap(EIGS, eng.refresh_eigs)


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


def _activity(e) -> str:
    try:
        return str(e.activity_type())
    except AttributeError:
        # a profiler without it (torch 2.11): the CUDA runtime and driver
        # calls are the host events named cuda*/cu*
        return "cuda_runtime" if e.name().startswith("cu") else "cpu_op"


def _merge(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


class Window:
    """One traced stretch: ``start`` and ``stop`` around it, then
    ``reduce``."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def _acts(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self):
        """Start and stop the profiler once: its first start takes
        seconds, which belong to set-up."""
        from torch.profiler import profile
        with profile(activities=self._acts()):
            torch.ones(1, device=self.device).add_(1)
            self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import profile
        self._sync()
        self.prof = profile(activities=self._acts())
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def reduce(self, top: int = 10) -> dict:
        events = self.prof.profiler.kineto_results.events()
        launched = {}            # runtime call's correlation id -> start
        ranges = {n: [] for n in RANGES}
        host = []                # (start, end, name) of host ops
        device = []              # (start, end, name) of device ops
        for e in events:
            name = e.name()
            s = e.start_ns()
            t = s + e.duration_ns()
            if _is_device(e):
                if e.is_user_annotation():
                    continue
                device.append((s, t, name, e.correlation_id()))
            elif _activity(e) in ("cuda_runtime", "cuda_driver"):
                launched[e.correlation_id()] = s
            elif name in ranges:
                ranges[name].append((s, t))
            else:
                host.append((s, t, name))
        kernels = [d for d in device
                   if not d[2].startswith(("Memcpy", "Memset"))]
        busy = _merge((s, t) for s, t, _, _ in device)
        busy_ns = sum(t - s for s, t in busy)
        # kernels launched inside the likelihood's ranges
        ll = sorted(ranges[LOGLIK])
        ll_starts = [s for s, _ in ll]
        ll_ns, unmatched = 0, 0
        for s, t, _, corr in kernels:
            at = launched.get(corr)
            if at is None:
                unmatched += 1
                continue
            i = bisect.bisect_right(ll_starts, at) - 1
            if i >= 0 and at <= ll[i][1]:
                ll_ns += t - s
        by_name = defaultdict(float)
        for s, t, name, _ in device:
            by_name[name[:120]] += (t - s) / 1e9
        try:
            t_lo = self.prof.profiler.kineto_results.trace_start_ns()
        except AttributeError:
            t_lo = min([s for s, _ in busy] + [s for s, _, _ in host] or [0])
        t_hi = t_lo + int(self.window_s * 1e9)
        return {
            "window_s": self.window_s,
            "busy_s": busy_ns / 1e9,
            "kernels": len(kernels),
            "unmatched_kernels": unmatched,
            "loglik_kernel_s": ll_ns / 1e9,
            "range_host_s": {n: sum(t - s for s, t in v) / 1e9
                             for n, v in ranges.items()},
            "device_ops": sorted(by_name.items(),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": _idle_by_host(busy, host, ranges, t_lo, t_hi,
                                       top),
        }


def _idle_by_host(busy, host, ranges, t_lo, t_hi, top):
    """The device's idle time between its busy intervals, summed by what
    the host was doing at each gap's middle: the benchmark's range, if
    any, and the innermost host operation."""
    gaps, prev = [], t_lo
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if t_hi > prev:
        gaps.append((prev, t_hi))
    host = sorted(host)
    starts = [h[0] for h in host]
    spans = sorted((s, t, n) for n, v in ranges.items() for s, t in v)
    span_starts = [s for s, _, _ in spans]
    out = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        op = "no host op"
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                op = host[j][2]
                break
        k = bisect.bisect_right(span_starts, mid) - 1
        where = (spans[k][2] if k >= 0 and spans[k][1] >= mid
                 else "outside the ranges")
        out[f"{where} / {op[:80]}"] += (b - a) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]
