"""One run of one cell: set-up, the measured window, the judgement, the line.

The cell's traffic mix names its driver (``drivers/<kind>.py``), which
builds the port from this benchmark's weights, warms every shape the mix
uses, runs the window and hands back what the window served. Once the
window has closed and the peak memory is read, the program's state is
freed and the plain reference judges a sample of the served requests
(``judge.py``) against the cell's limits (``limits/<cell>.json``).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from . import drivers, generate, judge, spec
from .weights import Dims

NOT_FINITE = 1e30  # a gap that is not finite (a forbidden token, nothing judged), as a number
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "whisper_tpu"})  # whole top-level names


@dataclass
class Context:
    """What a driver is given."""

    cell: spec.Cell
    dims: Dims
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # the process's start, by the host's clock

    @property
    def weight_seed(self) -> int:
        return generate.stream_seed(self.seed, generate.WEIGHTS)


@dataclass
class Outcome:
    """What a driver hands back once its window has closed."""

    setup_s: float
    end_to_end: dict                 # {metric: value} by the host's clock
    attempted: int
    failed: int                      # requests due in the window that never came
    finished: List[judge.Served]     # what the window served, for the judge
    trace: Optional[object] = None   # tracing.Trace of the traced stretch
    facts: dict = field(default_factory=dict)    # counts the readers need
    earlier: dict = field(default_factory=dict)  # the traced run's earlier line
    release: Callable[[], None] = lambda: None   # frees the program's state


@dataclass
class Run:
    """What a per-layer reader reads."""

    dims: Dims
    traffic: dict
    trace: object
    facts: dict


def _finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def checks_of(limits: dict, widest: float, logprob_error: float, missing: int) -> dict:
    """The numbers ``correct`` compares, each beside its limit from the
    cell's ``limits``: the widest logit gap, the widest mean log-probability
    error, the requests that never came."""
    return {"max_logit_gap": {"value": _finite(widest),
                              "limit": limits["max_logit_gap"]["limit"]},
            "max_logprob_error": {"value": _finite(logprob_error),
                                  "limit": limits["max_logprob_error"]["limit"]},
            "missing_requests": {"value": missing, "limit": 0}}


def is_correct(checks: dict, tokens: int) -> bool:
    """``correct``: some tokens judged, and every number within its limit."""
    return tokens > 0 and all(c["value"] <= c["limit"] for c in checks.values())


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"not read: {exc}"}
    return {"nvidia_smi": out.splitlines()}


def parse_args(argv):
    p = argparse.ArgumentParser("portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root: str, t0: float, device: Optional[torch.device] = None,
         cell: Optional[spec.Cell] = None) -> int:
    """Run the cell; 0 once the result line is printed. ``device`` and
    ``cell`` are for tests on the CPU: given, the look for cards is skipped."""
    args = parse_args(argv)
    cell = cell or spec.load_cell(root, args.workload)
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
                  f"this machine has {have}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    # set-up, and so ``setup_s``, holds the build of any kernel the checkout
    # lacks; the line gives that build's seconds apart
    build = drivers.build() if on_card else {"kernels_built": 0, "build_s": 0.0}
    dims = Dims.from_config(cell.config)
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    ctx = Context(cell=cell, dims=dims, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, t0=t0)
    out = driver.run(ctx)

    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    picked = judge.sample(out.finished, cell.traffic["judge_requests"],
                          generate.stream_seed(args.seed, generate.SAMPLE))
    trace = out.trace
    out.release()
    del out.finished
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    gaps = judge.judge(dims, ctx.weight_seed, picked, device)
    judge_s = time.perf_counter() - t_judge

    checks = checks_of(cell.limits, gaps.widest, gaps.logprob_error, out.failed)
    correct = is_correct(checks, gaps.tokens)

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed}
    if args.trace:
        run = Run(dims=dims, traffic=cell.traffic, trace=trace, facts=out.facts)
        result["metrics"] = spec.read_metrics(cell.per_layer, run)
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["device"] = dev
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    else:
        values = {**out.end_to_end, "setup_s": out.setup_s}
        result["metrics"] = {m.name: {"value": float(values[m.name]), "unit": m.unit}
                             for m in cell.end_to_end}
        result["device"] = dev
    result["build"] = build
    result["judge"] = {"tokens": gaps.tokens, "requests": len(picked),
                       "mean_gap": _finite(gaps.mean), "seconds": judge_s}
    result["checks"] = checks

    forbidden = loaded_forbidden()
    if forbidden:
        print(f"portbench: modules loaded that the port must not use: {forbidden}",
              file=sys.stderr)
        return 3
    if args.trace:
        print(json.dumps({"earlier": {**out.earlier, "card": card(),
                                      "profiled_window_s": trace.window_s,
                                      "profiled_clipped_s": trace.clipped_s,
                                      "profiled_edges_idle_s": trace.edges_s,
                                      "profiled_units": trace.units}}))
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0
