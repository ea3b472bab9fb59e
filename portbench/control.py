"""The readings that set a cell's limits: for each seed, one short run of the
cell's timed path (its driver, at the cell's own sizes and load), then the
plain reference's readings of the served sample (the program's) and the
control's (the reference in int4 where the configuration serves int8,
``reference.Reference(quant="int4")``) at the same positions. Each side's
numbers go through the harness's own checks and ``correct``
(``harness.checks_of``, ``harness.is_correct``) against the cell's limits.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 5

prints one JSON line a seed and a last line with the largest program
readings (the lower ends of the limits), the smallest control readings
(the upper ends) and each side's verdicts. The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import sys
import time

import torch


def _number(x) -> float:
    return math.inf if x is None else x


def readings(cell, seeds, seconds: float, device, root: str) -> list:
    from portbench import generate, judge
    from portbench.harness import Context, checks_of, is_correct
    from portbench.weights import Dims

    dims = Dims.from_config(cell.config)
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    out = []
    for seed in seeds:
        ctx = Context(cell=cell, dims=dims, seed=seed, seconds=seconds, trace=False,
                      device=device, t0=time.perf_counter())
        run = driver.run(ctx)
        picked = judge.sample(run.finished, cell.traffic["judge_requests"],
                              generate.stream_seed(seed, generate.SAMPLE))
        missing = run.failed
        run.release()
        del run
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        gaps = judge.judge(dims, ctx.weight_seed, picked, device, control="int4")
        program = checks_of(cell.limits, gaps.widest, gaps.logprob_error, missing)
        ctl = checks_of(cell.limits, _number(gaps.control), _number(gaps.control_logprob_error),
                        missing)
        out.append({"seed": seed, "program_correct": is_correct(program, gaps.tokens),
                    "control_correct": is_correct(ctl, gaps.tokens),
                    "program_checks": program, "control_checks": ctl,
                    "program": gaps.widest, "control": gaps.control,
                    "program_logprob": gaps.logprob_error,
                    "control_logprob": gaps.control_logprob_error, "fault": gaps.fault,
                    "tokens": gaps.tokens, "mean": gaps.mean,
                    "allocated_after": torch.cuda.memory_allocated(device)
                    if device.type == "cuda" else 0})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["TEARDOWN_CUPTI"] = "0"
    sys.path[0] = root
    from portbench import spec

    p = argparse.ArgumentParser("portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    cell = spec.load_cell(root, args.workload)
    rows = readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds,
                    torch.device("cuda", 0), root)
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "gap_lower": max(r["program"] for r in rows),
                      "gap_upper": min(r["control"] for r in rows),
                      "logprob_lower": max(r["program_logprob"] for r in rows),
                      "logprob_upper": min(r["control_logprob"] for r in rows),
                      "fault_gap_least": min(r["fault"] for r in rows),
                      "program_correct": [r["program_correct"] for r in rows],
                      "control_correct": [r["control_correct"] for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
