"""Run one benchmark cell once: ``python3 portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Prints earlier lines (traced runs: graph stats, launch counts, the card,
the profiled window) and, as its last line on standard output, one JSON
object with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and with ``--trace 1`` ``breakdown``), then the numbers compared beside
their limits. Exits non-zero, printing no result, without enough CUDA
cards, without the port, or when JAX was loaded.
"""

import faulthandler
import os
import sys
import time

T0 = time.perf_counter()  # set-up is timed from here


def main() -> int:
    faulthandler.enable()  # a crash names each thread's stack on standard error
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # CUPTI stays attached between profiler windows; torn down, it can
    # leave a later window without the card's activity
    os.environ["TEARDOWN_CUPTI"] = "0"
    # kernel caches at fixed paths inside the checkout (the port's nvcc
    # libraries already live in build/whisper_tpu_torch/)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["USE_FLAX"] = "0"  # keeps transformers, if anything loads it, off JAX
    sys.path[0] = root  # the checkout, not this folder: nothing here shadows a module
    from portbench.harness import main as harness_main

    return harness_main(sys.argv[1:], root=root, t0=T0)


if __name__ == "__main__":
    sys.exit(main())
