"""Probe of what voids a CUDA graph capture made in ``thread_local`` mode,
the mode of ``whisper_tpu_torch.utils.graphs.GraphSet``, on one card.

    python3 chip_capture_probe.py

Each case runs in a process of its own: a chain of eight 256 x 256 fp32
products and tanh is captured on a side stream while something else happens
in the capturing thread or in another thread, then replayed. One JSON line a
case: the capture's error (None: it held), the other thread's error, and
whether the replay gave finite values. Cases:

- ``control``: nothing else happens;
- ``gc_graph``: a collection inside the capture frees an earlier graph held
  only by a reference cycle; ``gc_event``: the same for a CUDA event;
- ``auto_gc_raw``: the same graph in a cycle, collected by the automatic
  collector (thresholds at 1) during a bare capture; ``auto_gc_graphset``:
  the same, captured through ``GraphSet.run``;
- ``*_other_thread``: another thread meanwhile destroys an earlier graph,
  calls ``torch.cuda.synchronize()``, allocates pinned memory, launches
  a kernel not loaded yet on the default generator, or empties the
  allocator's cache.

Needs a CUDA card.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import threading

CASES = ("control", "gc_graph", "gc_event", "auto_gc_raw", "auto_gc_graphset",
         "del_graph_other_thread", "sync_other_thread", "pin_other_thread",
         "new_kernel_other_thread", "empty_cache_other_thread")


class _Cycle:
    def __init__(self, payload):
        self.me, self.payload = self, payload


def _other_work(case: str, dev):
    import torch

    if case == "del_graph_other_thread":
        gc.collect()
    elif case == "sync_other_thread":
        torch.cuda.synchronize()
    elif case == "pin_other_thread":
        t = torch.empty(12_345_679, pin_memory=True).fill_(1.0)
        t.to(dev, non_blocking=True)
        torch.cuda.current_stream().synchronize()
    elif case == "new_kernel_other_thread":
        torch.special.zeta(torch.rand(100, device=dev) + 2, torch.rand(100, device=dev) + 1)
        torch.cuda.current_stream().synchronize()
    elif case == "empty_cache_other_thread":
        z = torch.empty(1 << 28, device=dev)
        del z
        torch.cuda.empty_cache()


def run(case: str) -> dict:
    import torch

    from whisper_tpu_torch.utils.graphs import GraphSet

    dev = torch.device("cuda")
    x, w = torch.randn(256, 256, device=dev), torch.randn(256, 256, device=dev)
    side = torch.cuda.Stream(dev)
    out = {}

    def body():
        y = x
        for _ in range(8):
            y = torch.tanh(y @ w)
        out["y"] = y

    olds = []  # earlier graphs, each dropped into a reference cycle when a run asks
    if case in ("gc_graph", "auto_gc_raw", "auto_gc_graphset", "del_graph_other_thread"):
        for _ in range(2):
            old = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                body()
                old.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                  capture_error_mode="thread_local")
                body()
                old.capture_end()
            old.replay()
            olds.append(old)
            del old
    if case == "gc_event":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        olds.append(event)
        del event
    torch.cuda.synchronize()
    if case.startswith("auto_gc"):
        gc.set_threshold(1, 1, 1)
    other_errors = []

    def guarded():
        try:
            _other_work(case, dev)
        except Exception as e:  # noqa: BLE001
            other_errors.append(repr(e)[:300])

    def captured():
        body()
        if olds and not case.endswith("other_thread"):
            _Cycle(olds.pop())
        if case in ("gc_graph", "gc_event"):
            gc.collect()
        if case.endswith("other_thread"):
            if olds:
                _Cycle(olds.pop())
            t = threading.Thread(target=guarded)
            t.start()
            t.join()
        for _ in range(100):  # Python allocations: the automatic collector runs
            [object() for _ in range(10)]
        body()

    error = None
    try:
        if case == "auto_gc_graphset":
            gs = GraphSet(dev)
            gs.run("k", captured)  # the warm run, then the capture
            gs.run("k", captured)  # a replay
        else:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                body()
                graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                    capture_error_mode="thread_local")
                try:
                    captured()
                finally:
                    graph.capture_end()
            graph.replay()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001
        error = repr(e)[:400]
    finite = None if error else bool(torch.isfinite(out["y"]).all())
    return {"case": case, "capture_error": error, "other_thread_error": other_errors,
            "replay_finite": finite}


def main() -> int:
    if len(sys.argv) > 1:
        print(json.dumps(run(sys.argv[1])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_capture_probe: no CUDA card available", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    for case in CASES:
        p = subprocess.run([sys.executable, __file__, case], capture_output=True, text=True,
                           timeout=120)
        print(p.stdout.strip() or json.dumps({"case": case, "rc": p.returncode,
                                              "stderr": p.stderr[-1500:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
