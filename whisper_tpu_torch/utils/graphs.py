"""CUDA graphs: the port's counterpart of a jitted program.

The JAX package compiles each decode loop into one device program
(``jax.jit`` over a ``lax.while_loop`` or a ``lax.scan``), so the host
launches it once. The port captures a round of such a loop, a callable that
never reads the device from the host, as a ``torch.cuda.CUDAGraph``, and
replays it: one launch from the host for every kernel of the round.
:class:`GraphSet` holds the graphs of one owner (a model's greedy, sampled
and beam loops, an engine's step rounds) by key, all in one memory pool.

The first run of a key is the warm-up that ``torch.cuda.graphs`` asks for:
the callable runs eagerly on the set's side stream, and this run is its
real work (the state it writes advances once). The callable is then
captured on the same stream in ``thread_local`` mode, so that other threads
launching on the card meanwhile (the engine's encode thread and aux worker)
neither break the capture nor are refused by it. Every later run of the key
replays. A capture that fails raises; nothing falls back to eager.

Python's cyclic garbage collector is held off during a capture: a
collection there can free a graph of an earlier owner caught in a reference
cycle, and destroying a graph while another is being captured voids that
capture with no error of its own (the error shows at the capture's next
launch, as ``operation failed due to a previous error during capture``).

Launch accounting: every kernel wrapper counts ``.launches`` in Python
where it launches its kernel (``ops._build.count``), and a replay runs no
Python. So the capture counts the wrappers' launches on a tally of its own
thread (``ops._build.tally``; a capture launches nothing, and other
threads launching meanwhile, such as the engine's encode thread during an
aux worker's capture, keep counting on ``.launches``) and every replay
adds the tally: the counts stay what eager runs of the same rounds would
give.

A graph bakes in every pointer it reads, the current stream's kernel
arguments included: a captured callable reads and writes only tensors that
outlive its graph, and writes them in place.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from ..ops import _build

# CUDA allows one capture at a time in a process
_CAPTURE_LOCK = threading.Lock()


def kernel_wrappers() -> tuple:
    """Every hand-written kernel's wrapper; each counts ``.launches`` where
    it launches its CUDA kernel, and nowhere else."""
    from ..ops import decode_attention as da
    from ..ops import flash_attention as fa
    from ..ops.int8_gemm import int8_gemm
    from ..ops.log10_mel import log10_mel
    from ..ops.quantize_rows import quantize_rows

    return (log10_mel, fa.flash_attention_btd, fa.flash_attention_btd_sharded,
            fa.flash_attention, int8_gemm, quantize_rows, da.cross_attention_decode_fd,
            da.cross_attention_decode, da.cross_attention_decode_dense,
            da.self_attention_decode, da.self_attention_decode_int8)


@contextlib.contextmanager
def _no_collection():
    """The cyclic garbage collector off (and back on if it was on): no
    graph is destroyed by a collection inside a capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


class GraphSet:
    """The CUDA graphs of one owner on ``device``, by key, sharing one
    memory pool and one side stream. :meth:`run` warms and captures a key's
    callable at its first run and replays it at every later one."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, Tuple[object, List[Tuple[Callable, int]]]] = {}
        self.capture_seconds: Dict[Hashable, float] = {}  # per key: the capture alone
        self.captures = 0  # every capture, a key captured again after forget() included
        self.replays = 0
        self._pool = None
        self._stream = None

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """Replay ``key``'s graph; at the key's first run, run ``fn`` on the
        side stream (its real work) and capture it."""
        entry = self._graphs.get(key)
        if entry is not None:
            graph, deltas = entry
            graph.replay()
            for wrapper, n in deltas:
                _build.count(wrapper, n)
            self.replays += 1
            return
        self._warm(fn)
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, _no_collection(), _build.tally() as launched:
            graph = self._capture(fn)
        self.capture_seconds[key] = time.perf_counter() - t0
        self.captures += 1
        self._graphs[key] = (graph, list(launched.counts.items()))

    def forget(self, stale: Callable[[Hashable], bool]) -> None:
        """Drop the graphs whose key is ``stale`` (their pool's blocks go to
        later captures)."""
        for key in [k for k in self._graphs if stale(k)]:
            del self._graphs[key]
            self.capture_seconds.pop(key, None)

    def _side(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _warm(self, fn: Callable[[], None]) -> None:
        stream = self._side()
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            fn()
        current.wait_stream(stream)

    def _capture(self, fn: Callable[[], None]):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._side()):
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):  # the capture is void: raise fn's error
                    graph.capture_end()
                raise
            graph.capture_end()
        return graph

    def pool_bytes(self) -> Optional[int]:
        """Bytes the caching allocator holds in this set's pool (None before
        the first capture)."""
        if self._pool is None:
            return None
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == pool)

    def stats(self) -> dict:
        return {"keys": len(self._graphs), "captures": self.captures, "replays": self.replays,
                "capture_s": {str(k): s for k, s in self.capture_seconds.items()},
                "pool_bytes": self.pool_bytes()}
