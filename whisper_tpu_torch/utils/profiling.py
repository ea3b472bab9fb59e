"""Profiling: stage timers with RTF accounting, and a profiler trace.

Port of ``whisper_tpu/utils/profiling.py``. :class:`StageTimer` is the same
host-clock stage timer (the same ``report()`` keys and rounding);
:func:`profiler_trace` is the counterpart of ``xla_trace``: a
``torch.profiler`` window over the host and, where there is one, the card,
written as a Chrome trace that Perfetto and TensorBoard's profiler plugin
read.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import torch


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float):
        self.calls += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)


class StageTimer:
    """Named stage timing on the host clock, with audio-seconds accounting
    for RTF. A stage that launches work on the card returns when the launches
    are queued: synchronize inside the stage to time the card's work."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = defaultdict(StageStats)
        self.audio_seconds: float = 0.0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name].add(time.perf_counter() - t0)

    def add_audio(self, seconds: float):
        self.audio_seconds += seconds

    def report(self) -> dict:
        total = sum(s.total_s for s in self.stages.values())
        return {
            "total_s": total,
            "audio_seconds": self.audio_seconds,
            "rtf": total / self.audio_seconds if self.audio_seconds else None,
            "audio_seconds_per_second": self.audio_seconds / total if total else None,
            "stages": {
                k: {
                    "calls": v.calls,
                    "total_s": round(v.total_s, 4),
                    "mean_ms": round(1e3 * v.total_s / max(v.calls, 1), 3),
                    "min_ms": round(1e3 * v.min_s, 3) if v.calls else None,
                    "max_ms": round(1e3 * v.max_s, 3),
                    "share": round(v.total_s / total, 4) if total else None,
                }
                for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1].total_s)
            },
        }

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.report(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str] = None) -> Iterator[str]:
    """Profile the block with ``torch.profiler`` (the host's ranges and
    operations on every thread, so a started engine's decode, encode and aux
    threads too, and the card's kernels where CUDA is available) and write
    it, when the block ends, as
    ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``: a Chrome trace that
    Perfetto opens and TensorBoard's profiler plugin finds in ``logdir``.
    Yields that path. ``logdir`` defaults to ``whisper_tpu_torch_trace``
    under the temporary directory. A torch whose profiler cannot follow
    every thread (``profile_all_threads``, torch 2.11 and later) profiles
    the calling thread's host work alone, and the card's as before."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "whisper_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{int(time.time() * 1000)}.pt.trace.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = {"experimental_config":
                  torch.profiler._ExperimentalConfig(profile_all_threads=True)}
    except (AttributeError, TypeError):
        config = {}
    with torch.profiler.profile(activities=activities, **config) as prof:
        yield path
    prof.export_chrome_trace(path)
