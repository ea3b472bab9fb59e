"""The traced stretch of a run: ``torch.profiler`` over whole units of work
(batches, or a span of a serving window), reduced to what the per-layer
readers need.

Kept from the profile: every device operation (kernels, copies, fills) as
(name, start, end); every ``whisper.*`` or ``portbench.*`` range as its
host intervals and as the device intervals the profiler gives it (first to
last operation it launched). The busy time is the union of the device
operations' intervals, so two streams that overlap count once.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

RANGE_PREFIXES = ("whisper.", "portbench.")
TOP = 10  # entries of each list in the result's breakdown


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


@dataclass
class Trace:
    window_s: float                       # the profiler's interval, start to stop
    ops: List[Tuple[str, float, float]]   # device operations (name, start us, end us)
    host: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    device: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    units: int = 1                        # whole units of work the stretch held
    clipped_s: float = 0.0                # device time outside the interval, left out
    edges_s: float = 0.0                  # idle before the first operation and after the last

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in _union([(a, b) for _, a, b in self.ops])) / 1e6

    def idle_share(self):
        """Percent of the stretch with no device operation (the union of
        their intervals, so overlapping streams count once); None without
        any operation."""
        return 100.0 * (1.0 - self.busy_s / self.window_s) if self.ops else None

    def kernel_seconds(self, names: Tuple[str, ...]) -> Tuple[float, int]:
        """Summed seconds and count of the operations whose name holds one of
        ``names``."""
        hits = [b - a for n, a, b in self.ops if any(k in n for k in names)]
        return sum(hits) / 1e6, len(hits)

    def device_span_s(self, name: str) -> float:
        """Summed device intervals of range ``name`` (0.0 where it launched
        nothing)."""
        return sum(hi - lo for lo, hi in self.device.get(name, ())) / 1e6

    def host_s(self, name: str) -> float:
        return sum(hi - lo for lo, hi in self.host.get(name, ())) / 1e6

    def top_ops(self) -> List[list]:
        by = defaultdict(float)
        for n, a, b in self.ops:
            by[n] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """The longest stretches with no device operation, each named by the
        innermost range the host was in when it began."""
        busy = _union([(a, b) for _, a, b in self.ops])
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:]) if a1 > b0]
        ranges = sorted(((hi - lo, lo, hi, n) for n, iv in self.host.items() for lo, hi in iv))
        out = []
        for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
            name = next((n for _, a, b, n in ranges if a <= lo < b), "outside any range")
            out.append([name, (hi - lo) / 1e6])
        return out


def warm() -> None:
    """Start the profiler once in set-up: its first start in a process
    attaches CUPTI, seconds that would otherwise fall into the window
    (CUPTI stays attached after, under ``TEARDOWN_CUPTI=0``)."""
    profile(lambda: 0)


class Profiler:
    """``torch.profiler`` started and stopped by hand, each synchronised
    with the card, so that both can happen on the thread that launches the
    work (a stop beside another thread's CUDA graph replay did not return);
    ``host=False`` records the card's activity alone, without the host's
    operations and ranges. Its raw kineto events are read as they are,
    without the per-event objects ``profile.events()`` would build
    (seconds for every thousand launches of a large-v3 batch)."""

    def __init__(self, host: bool = True):
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        self.card = torch.cuda.is_available()
        activities = ([ProfilerActivity.CPU] if host or not self.card else []) + \
            ([ProfilerActivity.CUDA] if self.card else [])
        self.prof = torch_profile(activities=activities)

    def _sync(self):
        if self.card:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self.prof.__enter__()

    def stop(self) -> None:
        self._sync()
        self._stop_ns = time.time_ns()  # the clock of the profiler's events
        self.prof.__exit__(None, None, None)

    def trace(self, units: int) -> Trace:
        from torch.autograd import DeviceType

        results = self.prof.profiler.kineto_results
        # the profiler's interval: another thread may launch work between the
        # synchronise and the profiler's start or stop, and what of it ran
        # outside the interval is not the stretch's
        first, last = results.trace_start_ns() / 1e3, self._stop_ns / 1e3
        ops, host, device = [], defaultdict(list), defaultdict(list)
        clipped = 0.0
        for e in results.events():
            name, lo = e.name(), e.start_ns() / 1e3
            iv = (lo, lo + e.duration_ns() / 1e3)
            on_card = e.device_type() == DeviceType.CUDA
            if name.startswith(RANGE_PREFIXES):
                (device if on_card else host)[name].append(iv)
            elif on_card and not getattr(e, "is_user_annotation", lambda: False)():
                a, b = max(iv[0], first), min(iv[1], last)
                clipped += (iv[1] - iv[0]) - max(b - a, 0.0)
                if b > a:
                    ops.append((name, a, b))
        edges = (min(a for _, a, _ in ops) - first) + (last - max(b for _, _, b in ops)) \
            if ops else last - first
        return Trace(window_s=(last - first) / 1e6, ops=ops, host=dict(host),
                     device=dict(device), units=units, clipped_s=clipped / 1e6,
                     edges_s=edges / 1e6)


def profile(fn: Callable[[], int], host: bool = True) -> Trace:
    """Run ``fn`` (which returns the whole units of work it did) under a
    :class:`Profiler` on this thread and keep its trace."""
    p = Profiler(host)
    p.start()
    units = fn()
    p.stop()
    return p.trace(units)
