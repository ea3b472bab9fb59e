"""Find the knee of a serving mix: run its driver at each of several
arrival rates (the mix's own file with ``rate_per_s`` replaced) and print,
for each, the requests sent, how many came back, the completions a second
over the window, p50 and p95, and whether the backlog grew (the median
latency of the window's last fifth of requests against its first fifth).

    python3 portbench/sweep.py --workload <serving cell> --rates 10,20,40 --seconds 20

The knee is the highest rate whose backlog does not grow; the cell runs
at about four fifths of it, a number fixed in its mix's file.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["TEARDOWN_CUPTI"] = "0"
    sys.path[0] = root
    from portbench import generate, spec
    from portbench.drivers import serve
    from portbench.harness import Context
    from portbench.weights import Dims

    p = argparse.ArgumentParser("portbench/sweep.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True, help="comma-separated requests a second")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    cell = spec.load_cell(root, args.workload)
    dims = Dims.from_config(cell.config)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic = dict(cell.traffic, rate_per_s=rate)
        ctx = Context(cell=cell, dims=dims, seed=args.seed, seconds=args.seconds, trace=False,
                      device=torch.device("cuda", 0), t0=time.perf_counter())
        t = time.perf_counter()
        out = serve.run(ctx)
        schedule = generate.arrivals(cell.traffic, args.seconds, args.seed)
        lat = np.array(out.facts["latencies"])
        fifth = max(1, len(lat) // 5)
        print(json.dumps({
            "rate_per_s": rate, "sent": out.attempted, "failed": out.failed,
            "completed_per_s": (out.attempted - out.failed) / out.facts["drain_s"],
            "p50_s": out.end_to_end["req_p50_s"], "p95_s": out.end_to_end["req_p95_s"],
            "first_fifth_median_s": float(np.median(lat[:fifth])),
            "last_fifth_median_s": float(np.median(lat[-fifth:])),
            "audio_s": sum(a.samples for a in schedule) / generate.SAMPLE_RATE,
            "setup_s": out.setup_s, "run_s": time.perf_counter() - t}), flush=True)
        out.release()
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
