"""Probe of the W8A8 kernels on one NVIDIA card: K8 (int8 GEMM) and K8q (row
quantization).

    python3 chip_k8_probe.py

Builds the two kernels, prints their ptxas report and the counts of the
SASS instructions that show wgmma and TMA (IGMMA, HGMMA, UTMALDG, ...), then
at the turbo encoder's offline batch (M = 96,000 rows) checks K8's int32
product and bf16 scaled epilogue against their plain versions and times
both beside ``torch._int_mm`` (column-major weight), and checks and times
K8q at D and 4 D. One JSON line per shape. A quick first look at a new
kernel design; ``chip_smoke.py``'s ``kernel_k8`` and ``kernel_k8q`` phases
(also through ``chip_walls.py --phases``) are the full checks. Needs a CUDA
card.

    python3 chip_k8_probe.py --small-m [--sweep]

K8 at few rows, the omni decode's products (M = 64): the split-K
schedule's cluster slots at every tile width and split, its outputs
against the plain version and the persistent schedule at M 1, 7, 33, 64,
128 (every plan with ``--sweep``), and each product's time by CUDA events
over CUDA-graph replays (weights rotated through more than the 50 MB L2)
under the persistent schedule, the rule's plan and, with ``--sweep``,
every plan; then one language-model block's twelve products in a row.
"""

from __future__ import annotations

import faulthandler
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

M = 96000  # turbo encoder rows at batch 64: 64 x 1500
SHAPES = ((1280, 1280), (1280, 5120), (5120, 1280))  # a layer's (K, N)
SASS_OPS = ("IGMMA", "HGMMA", "UTMALDG", "WARPGROUP", "SYNCS")


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the omni decode's (K, N, output dtype, bias) of K8: q|k|v, o, the fixed
# experts' gate|up and down, a routed expert's gate|up and down, the head
DECODE = ((3584, 4608, torch.float32, True), (3584, 3584, torch.float32, False),
          (3584, 9472, torch.bfloat16, False), (4736, 3584, torch.float32, False),
          (3584, 37888, torch.bfloat16, False), (18944, 3584, torch.float32, False),
          (3584, 152064, torch.float32, False))
BLOCK = (1, 1, 1, 1, 4, 4)  # launches of each of the first six in a block
L2_BYTES = 50 << 20


def graph_us(fns, reps: int = 20) -> float:
    """Microseconds a call of ``fns``, one CUDA graph of them all replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / (reps * len(fns))


def small_m(sweep: bool) -> int:
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops import int8_gemm as k8

    _build.build_all(("int8_gemm",))
    log = _build.build_log("int8_gemm")
    print("=== ptxas int8_gemm\n" + log[-6000:])
    tool = str(Path(_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(_build.library_path("int8_gemm"))],
                          capture_output=True, text=True, check=True).stdout
    per_fn = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        per_fn[name] = {op: len(re.findall(r"\b" + op + r"\b", chunk)) for op in SASS_OPS}
    print(json.dumps({"sass": per_fn, "serialized": bool(re.search(r"C751[35]", log))}))
    dev = torch.device("cuda")
    lib = _build.load("int8_gemm")
    import ctypes
    slots = {}
    for bn in k8.SPLIT_WIDTHS:
        for split in range(1, k8.SPLIT_MAX + 1):
            n = ctypes.c_int(0)
            err = lib.int8_gemm_splitk_slots(bn, split, 0, ctypes.byref(n))
            slots[f"{bn}x{split}"] = n.value * split if err == 0 else f"error {err}"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps({"sms": sms, "cluster_ctas_at_once": slots}), flush=True)

    rule = k8._plan
    waves = k8._waves(0)
    print(json.dumps({"waves": waves}), flush=True)

    def forced(plan):
        k8._plan = lambda *shape: plan

    def plan_of(bn, split, M, N):
        tiles = -(-M // 64) * -(-N // bn)
        return k8.SplitPlan(bn, split, split * min(tiles, waves[split - 1] // split))

    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for K, N, out, has_bias in DECODE:
        b = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8).t()
        ws = torch.rand((1, N), generator=gen, device=dev) * 1e-2
        bias = torch.randn(N, generator=gen, device=dev) if has_bias else None
        plans = [(bn, sp) for bn in k8.SPLIT_WIDTHS for sp in range(1, 9)
                 if sp <= max(1, -(-K // 128) // k8.MIN_SLICE)] if sweep else []
        for M in (1, 7, 33, 64, 128):
            a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
            sx = torch.rand((M, 1), generator=gen, device=dev) * 1e-2
            k8._plan = rule
            chosen = rule(M, K, N, 0)
            want32 = k8.int8_gemm_plain(a, b)
            want = k8.int8_gemm_scaled_plain(a, b, sx, ws, bias, out)
            forced(None)
            old = k8.int8_gemm_scaled(a, b, sx, ws, bias, out)
            res = {"M": M, "K": K, "N": N, "plan": chosen, "persistent_equal": torch.equal(old, want)}
            fails = []
            for plan in [chosen] + ([plan_of(bn, sp, M, N) for bn, sp in plans] if M == 64 else []):
                if plan is None:
                    continue
                forced(plan)
                ok = (torch.equal(k8.int8_gemm(a, b), want32)
                      and torch.equal(k8.int8_gemm_scaled(a, b, sx, ws, bias, out), want)
                      and torch.equal(k8.int8_gemm_scaled(a, b, sx, ws, None, torch.bfloat16),
                                      k8.int8_gemm_scaled_plain(a, b, sx, ws, None, torch.bfloat16)))
                if not ok:
                    fails.append(plan[:2])
            res["split_fails"] = fails
            bad += len(fails) + (not res["persistent_equal"])
            print(json.dumps(res), flush=True)
        del b
    torch.cuda.synchronize()
    if bad:
        print(json.dumps({"ok": False, "bad": bad}))
        return 1

    big = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    print(json.dumps({"sum_1GiB_TBps": round(
        big.numel() / graph_us([lambda: big.view(torch.float32).sum()], 5) / 1e6, 3)}), flush=True)
    del big
    M = 64
    block_fns = {"persistent": [], "rule": []}
    for i, (K, N, out, has_bias) in enumerate(DECODE):
        copies = max(1, min(16, -(-3 * L2_BYTES // (K * N))))
        bs = [torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                            dtype=torch.int8).t() for _ in range(copies)]
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        sx = torch.rand((M, 1), generator=gen, device=dev) * 1e-2
        ws = torch.rand((1, N), generator=gen, device=dev) * 1e-2
        bias = torch.randn(N, generator=gen, device=dev).to(out) if has_bias else None
        nbytes = M * K + K * N + out.itemsize * M * N + 4 * (M + N) + (out.itemsize * N if has_bias else 0)
        fns = [lambda a=a, b=b, sx=sx, ws=ws, bias=bias, out=out:
               k8.int8_gemm_scaled(a, b, sx, ws, bias, out) for b in bs]
        fns = fns * max(1, 24 // len(fns))
        chosen = rule(M, K, N, 0)
        times = {}
        for name, plan in [("persistent", None), ("rule", chosen)] + (
                [(f"{bn}x{sp}", plan_of(bn, sp, M, N)) for bn in k8.SPLIT_WIDTHS
                 for sp in range(1, 9) if sp <= max(1, -(-K // 128) // k8.MIN_SLICE)]
                if sweep else []):
            forced(plan)
            times[name] = round(graph_us(fns), 2)
        print(json.dumps({"M": M, "K": K, "N": N, "plan": chosen, "bound_us": round(1e6 * nbytes / 3.35e12, 2),
                          "us": times}), flush=True)
        if i < len(BLOCK):
            for key in block_fns:
                block_fns[key] += [fns[0]] * BLOCK[i]
    for key, plan_of in (("persistent", None), ("rule", "rule")):
        if plan_of is None:
            forced(None)
        else:
            k8._plan = rule
        us = graph_us(block_fns[key], reps=10) * len(block_fns[key])
        print(json.dumps({"block": key, "us": round(us, 1), "launches": len(block_fns[key])}))
    k8._plan = rule
    print(json.dumps({"ok": True, "card": torch.cuda.get_device_name(0)}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_k8_probe: no CUDA card available", file=sys.stderr)
        return 1
    if "--small-m" in sys.argv:
        # a kernel that never ends ends the process, not the machine's time
        faulthandler.dump_traceback_later(600, exit=True)
        return small_m("--sweep" in sys.argv)
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops.int8_gemm import (
        int8_gemm, int8_gemm_plain, int8_gemm_scaled, int8_gemm_scaled_plain)
    from whisper_tpu_torch.ops.quantize_rows import quantize_rows, quantize_rows_plain

    names = ("int8_gemm", "quantize_rows")
    try:
        _build.build_all(names)
    finally:
        for n in names:
            print(f"=== ptxas {n}\n{_build.build_log(n)[-4000:]}")
    tool = str(Path(_build.nvcc()).with_name("cuobjdump"))
    for n in names:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(n))],
                              capture_output=True, text=True, check=True).stdout
        ops = {}
        for m in re.finditer(r"\b(" + "|".join(SASS_OPS) + r")(\.[A-Z0-9_.x]+)?\b", sass):
            ops[m.group(0)] = ops.get(m.group(0), 0) + 1
        print(json.dumps({"library": n, "sass": ops,
                          "functions": re.findall(r"Function : (\S+)", sass)}))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for K, N in SHAPES:
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        b_k = b.t().contiguous().t()
        sx = torch.rand((M, 1), generator=gen, device=dev) * 0.01
        ws = torch.rand((1, N), generator=gen, device=dev) * 0.01
        bias = torch.randn(N, generator=gen, device=dev).bfloat16()
        print(json.dumps({
            "K": K, "N": N, "exact": torch.equal(int8_gemm(a, b_k), int8_gemm_plain(a, b)),
            "scaled_equal": torch.equal(int8_gemm_scaled(a, b_k, sx, ws, bias),
                                        int8_gemm_scaled_plain(a, b, sx, ws, bias,
                                                               torch.bfloat16)),
            "int32_ms": cuda_ms(lambda: int8_gemm(a, b_k)),
            "bf16_ms": cuda_ms(lambda: int8_gemm_scaled(a, b_k, sx, ws, bias)),
            "int_mm_ms": cuda_ms(lambda: torch._int_mm(a, b_k))}), flush=True)
        del a
    for K in (1280, 5120):
        x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
        (q, s), (qp, sp) = quantize_rows(x), quantize_rows_plain(x)
        print(json.dumps({
            "K": K, "q_equal": torch.equal(q, qp), "s_equal": torch.equal(s, sp),
            "k8q_ms": cuda_ms(lambda: quantize_rows(x)),
            "plain_ms": cuda_ms(lambda: quantize_rows_plain(x), reps=3),
            "bound_ms": 1e3 * (3.0 * x.numel() + 4 * M) / 3.35e12}), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
