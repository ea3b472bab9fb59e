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
"""

from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_k8_probe: no CUDA card available", file=sys.stderr)
        return 1
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
