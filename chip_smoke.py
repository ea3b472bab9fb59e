"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's five CUDA kernels from ``whisper_tpu_torch/csrc/`` (nvcc,
sm_90a, one process per source, in parallel), holds each against its plain
PyTorch version at the shapes of the three paths below, and drives each path
while counting kernel launches:

- the offline path, ``WhisperPipeline.transcribe_batch``: turbo at full
  width, batch 64, 64 new tokens, bf16, int8 weights + W8A8 encoder + int8
  cross- and self-KV, seeded random weights;
- the serving path: the port's HTTP server in-process on 127.0.0.1 under the
  server's zero-flag defaults (turbo, 8 slots, 32 steps per sync, 224-token
  budget, W8A8 + int8 cross- and self-KV, bf16), answering 24 seeded noise
  clips of 2-30 s from 24 client threads;
- the long-form path, through the CLI entry point in-process
  (``whisper_tpu_torch.cli.main``: turbo, bf16, int8 weights + W8A8 + int8
  cross- and self-KV, 64 tokens a window, seek-based ``--longform
  --timestamps -f json``, condition-on-previous-text on) over four seeded
  noise WAVs of 60-120 s.

Then it checks small fp32 runs of the three paths on the card against the
CPU. Prints JSON lines; the last is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
Needs a CUDA card: without one it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# NVIDIA H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 without
# tensor cores, HBM3 bandwidth. Rates at the full 700 W power limit.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

# main-path shapes: turbo encoder attention and decode cross-attention at B64
B, T_AUDIO, D_AUDIO, H_AUDIO, L_AUDIO = 64, 1500, 1280, 20, 32
H_TEXT, DH = 20, 64
N_TOKENS = 64

# kernel-vs-plain tolerances (max |kernel - plain|) and why:
#  K1 bf16: p is rounded to bf16 before p.v unnormalised (plain rounds the
#    normalised weights) and outputs are bf16: one bf16 ulp at |out| < 2 is
#    2^-7 = 7.8e-3;
#  K1 fp32: fp32 summation order only;
#  K2 bf16: both compute in fp32 and round to bf16; one bf16 ulp at |out|<1
#    is <= 2^-8 = 3.9e-3;
#  K2 fp32: fp32 summation order only;
#  K3 bf16 (|V| <= 1): both compute in fp32 and round to bf16, at most one
#    bf16 ulp apart below 1 (<= 2^-8 = 3.9e-3);
#  K3 fp32: fp32 summation order only;
#  K7: the raw log10 mel in fp32, sums in another order than cuBLAS's; the
#    JAX package's golden tolerance for its fused mel kernel
#    (tests/test_pallas.py);
#  K8: int32 sums of int8 products are exact: equality.
TOL = {"flash_attention_btd/bf16": 8e-3, "flash_attention_btd/fp32": 1e-4,
       "cross_attention_decode_fd/bf16": 4e-3, "cross_attention_decode_fd/fp32": 1e-4,
       "self_attention_decode/bf16": 4e-3, "self_attention_decode/fp32": 1e-5,
       "log10_mel": 5e-4, "int8_gemm": 0.0}
# K3's shapes: (batch, self-KV positions, offsets drawn from [lo, hi], pads
# drawn from [0, max]) of the offline path (prompt of 4, 64 new tokens,
# cache bucketed to 128), the serving path (8 slots, 224-token budget, cache
# bucketed to 256) and the long-form path (prompts of up to 1 + 223 + 3
# previous-text and sot tokens, left-padded by up to 60, 64 new tokens,
# cache bucketed to 384)
K3_SHAPES = {"offline": (B, 128, 4, 4 + N_TOKENS - 1, None),
             "serving": (8, 256, 4, 4 + 224 - 1, None),
             "longform": (8, 384, 226, 226 + N_TOKENS - 1, 60)}
# K8's shapes: the turbo encoder's (K, N) per layer (q, k, v, o; mlp w1;
# mlp w2) at the offline batch (M = 1500 x 64) and at ragged admission sizes
K8_KN = ((1280, 1280, 4), (1280, 5120, 1), (5120, 1280, 1))
K8_M = (T_AUDIO * B, 1500, 4500)
L2_BYTES = 50e6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean time on the card per call of ``fn``: the summed durations of the
    kernels it launches (CUPTI, through torch.profiler), without the gaps
    between launches. For a kernel of a few microseconds a loop timed by
    CUDA events measures the host's launch rate instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the process's first profiled window can come back without the card's
    # activity (CUPTI starting up), so an empty window is taken again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        if total > 0:
            return total / 1e3 / reps
    raise AssertionError("torch.profiler recorded no time on the card in three windows")


def check(name: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    rel = float(torch.linalg.vector_norm(got.float() - ref.float())
                / torch.linalg.vector_norm(ref.float()))
    out = {"max_abs_err": float(err.max()), "rel_l2_err": rel, "tol_abs": TOL[name]}
    if not torch.isfinite(got).all() or out["max_abs_err"] > TOL[name]:
        raise AssertionError(f"{name} disagrees with its plain version: {out}")
    return out


def kernel_k1(dev, gen) -> dict:
    from whisper_tpu_torch.ops.flash_attention import (
        flash_attention_btd, flash_attention_btd_plain)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v = (rand(B, T_AUDIO, D_AUDIO) for _ in range(3))
    got = flash_attention_btd(q, k, v, H_AUDIO)
    chunk = 8  # the plain version's fp32 scores are 1.4 GB per 8 rows
    ref = torch.cat([flash_attention_btd_plain(q[i:i + chunk], k[i:i + chunk],
                                               v[i:i + chunk], H_AUDIO)
                     for i in range(0, B, chunk)])
    res = check("flash_attention_btd/bf16", got, ref)
    del ref
    ms = cuda_ms(lambda: flash_attention_btd(q, k, v, H_AUDIO), reps=10)
    plain_ms = cuda_ms(lambda: [flash_attention_btd_plain(q[i:i + chunk], k[i:i + chunk],
                                                          v[i:i + chunk], H_AUDIO)
                                for i in range(0, B, chunk)], reps=2, warmup=1)
    qh, kh, vh = (t.reshape(B, T_AUDIO, H_AUDIO, DH).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qh, kh, vh), reps=10)
    del qh, kh, vh
    # fp32 path at a small batch
    qf, kf, vf = (rand(2, T_AUDIO, D_AUDIO, dtype=torch.float32) for _ in range(3))
    res32 = check("flash_attention_btd/fp32", flash_attention_btd(qf, kf, vf, H_AUDIO),
                  flash_attention_btd_plain(qf, kf, vf, H_AUDIO))
    flops = 4.0 * B * H_AUDIO * T_AUDIO * T_AUDIO * DH
    nbytes = 4.0 * B * T_AUDIO * D_AUDIO * 2
    return {"name": "flash_attention_btd", "route": "cuda",
            "source": "whisper_tpu_torch/csrc/flash_attention_btd.cu",
            "replaces": "whisper_tpu/ops/flash_attention.py:146",
            "shape": f"q,k,v,o ({B},{T_AUDIO},{D_AUDIO}) bf16, H={H_AUDIO}",
            **res, "fp32_check": res32, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BYTES),
            "bound_by": "operations" if flops / PEAK_BF16 > nbytes / PEAK_BYTES else "bytes",
            "bound_peaks": "989 TFLOP/s bf16, 3.35 TB/s",
            "library_ms": library_ms, "library": "F.scaled_dot_product_attention (B,H,T,dh)"}


def kernel_k2(dev, gen) -> dict:
    from whisper_tpu_torch.models.model import attention_int8kv, quantize_cross_kv
    from whisper_tpu_torch.ops.decode_attention import (
        cross_attention_decode_fd, cross_attention_decode_fd_plain)

    ck, cv = (torch.randn((1, B, H_TEXT, T_AUDIO, DH), generator=gen, device=dev)
              for _ in range(2))
    k_q, k_s, v_q, v_s = (t[0] for t in quantize_cross_kv((ck, cv)))
    del ck, cv
    out = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        q = torch.randn((B, H_TEXT, 1, DH), generator=gen, device=dev).to(dtype)
        got = cross_attention_decode_fd(q, k_q, k_s, v_q, v_s)
        res = check(f"cross_attention_decode_fd/{tag}", got,
                    cross_attention_decode_fd_plain(q, k_q, k_s, v_q, v_s))
        if tag == "fp32":
            # the plain fd semantics agree with the model's attention_int8kv
            ref = attention_int8kv(q, k_q, k_s, v_q, v_s)
            res["vs_attention_int8kv"] = float((got - ref).abs().max())
            out["fp32_check"] = res
        else:
            out.update(res)
            out["ms"] = cuda_ms(lambda: cross_attention_decode_fd(q, k_q, k_s, v_q, v_s), 50)
            out["plain_ms"] = cuda_ms(
                lambda: cross_attention_decode_fd_plain(q, k_q, k_s, v_q, v_s), 20)
    # int8 K and V, fp32 k_s and v_s, bf16 q and output
    nbytes = 2.0 * B * H_TEXT * DH * T_AUDIO + 2 * 4.0 * B * H_TEXT * DH + 2 * 2.0 * B * H_TEXT * DH
    flops = 4.0 * B * H_TEXT * DH * T_AUDIO
    return {"name": "cross_attention_decode_fd", "route": "cuda",
            "source": "whisper_tpu_torch/csrc/cross_attention_decode.cu",
            "replaces": "whisper_tpu/ops/decode_attention.py:212",
            "shape": f"q ({B},{H_TEXT},1,{DH}) bf16, k_q/v_q ({B},{H_TEXT},{DH},{T_AUDIO}) int8",
            **out, "bound_ms": 1e3 * max(flops / PEAK_FP32, nbytes / PEAK_BYTES),
            "bound_by": "bytes" if nbytes / PEAK_BYTES > flops / PEAK_FP32 else "operations",
            "bound_peaks": "3.35 TB/s, 67 TFLOP/s fp32",
            "library_ms": None, "library": "none: no single PyTorch call computes it"}


def kernel_k3(dev, gen) -> dict:
    """K3 on both cache layouts at both paths' shapes, against its plain
    version; times cycle through enough cache copies to exceed the 50 MB L2,
    as the decode step finds its layer view cold. The bound counts the bytes
    of each row's visible window (what the kernel must read), not all of T."""
    from whisper_tpu_torch.models.model import quantize_kv_heads
    from whisper_tpu_torch.ops.decode_attention import (
        self_attention_decode, self_attention_decode_int8, self_attention_decode_int8_plain,
        self_attention_decode_plain)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(5)
    out = {}
    for path, (b, T, lo, hi, max_pad) in K3_SHAPES.items():
        offsets = torch.from_numpy(rng.integers(lo, hi + 1, b)).to(dev)
        pads = None if max_pad is None else torch.from_numpy(rng.integers(0, max_pad + 1, b)).to(dev)
        first = 0 if pads is None else pads
        n_vis = float((offsets.clamp(max=T - 1) + 1 - first).sum()) * H_TEXT  # visible keys
        q = torch.randn((b, H_TEXT, 1, DH), generator=gen, device=dev)
        k = torch.randn((b, H_TEXT, T, DH), generator=gen, device=dev)
        v = torch.rand((b, H_TEXT, T, DH), generator=gen, device=dev) * 2 - 1  # |V| <= 1
        kv_q, kv_s = (t.contiguous() for t in quantize_kv_heads(k, v))
        layouts = {
            "int8": (self_attention_decode_int8, self_attention_decode_int8_plain,
                     lambda dt: (kv_q, kv_s), 2.0 * DH + 2 * 4.0),
            "float": (self_attention_decode, self_attention_decode_plain,
                      lambda dt: (k.transpose(-1, -2).contiguous().to(dt),
                                  v.transpose(-1, -2).contiguous().to(dt)), 2.0 * DH * 2),
        }
        for layout, (fn, plain, cache, bytes_per_key) in layouts.items():
            res = {}
            for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                qd, c = q.to(dt), cache(dt)
                res[tag] = check(f"self_attention_decode/{tag}", fn(qd, *c, offsets, pads),
                                 plain(qd, *c, offsets, pads))
            qd, c = q.to(torch.bfloat16), cache(torch.bfloat16)
            full = sum(t.numel() * t.element_size() for t in c)
            sets = [c] + [tuple(t.clone() for t in c)
                          for _ in range(max(1, math.ceil(2 * L2_BYTES / full)) - 1)]
            calls = {"ms": lambda: [fn(qd, *cs, offsets, pads) for cs in sets],
                     "plain_ms": lambda: [plain(qd, *cs, offsets, pads) for cs in sets]}
            if layout == "float":
                key = torch.arange(T, device=dev)[None, :]
                vis = (key <= offsets[:, None]) & (key >= (0 if pads is None else pads[:, None]))
                vis = vis[:, None, None, :]
                calls["library_ms"] = lambda: [sdpa(qd, cs[0].transpose(-1, -2),
                                                    cs[1].transpose(-1, -2), attn_mask=vis)
                                               for cs in sets]
            times = {key: device_ms(call, reps=10) / len(sets) for key, call in calls.items()}
            times["events_ms"] = {key: cuda_ms(call, reps=10) / len(sets)
                                  for key, call in calls.items()}
            times.setdefault("library_ms", None)
            nbytes = n_vis * bytes_per_key + 2 * 2.0 * b * H_TEXT * DH + 8.0 * b
            flops = n_vis * 4.0 * DH
            del sets
            out[f"{path}/{layout}"] = {
                "shape": f"q ({b},{H_TEXT},1,{DH}) bf16, cache T={T} {layout}, offsets "
                         f"{lo}..{hi}, pads {'none' if max_pad is None else f'0..{max_pad}'} "
                         f"(mean {n_vis / b / H_TEXT:.1f} visible keys)",
                "max_abs_err": res["bf16"]["max_abs_err"], "tol_abs": res["bf16"]["tol_abs"],
                "fp32_check": res["fp32"], **times, "times": "ms, plain_ms, library_ms: "
                "kernel time on the card (torch.profiler); events_ms: CUDA events around a "
                "loop of calls, host launch gaps included",
                "bound_ms": 1e3 * max(flops / PEAK_FP32, nbytes / PEAK_BYTES),
                "bound_by": "bytes" if nbytes / PEAK_BYTES > flops / PEAK_FP32 else "operations",
                "bound_count": "visible window",
                "library": ("F.scaled_dot_product_attention(q, k^T, v^T, attn_mask=vis)"
                            if layout == "float" else "none: no single PyTorch call computes it")}
    main = out["offline/int8"]
    return {"name": "self_attention_decode_int8", "route": "cuda",
            "source": "whisper_tpu_torch/csrc/self_attention_decode.cu",
            "replaces": "whisper_tpu/ops/decode_attention.py:60",
            **{k: main[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "bound_peaks": "3.35 TB/s, 67 TFLOP/s fp32", "cases": out}


def kernel_k7(dev, gen) -> dict:
    """K7 at the offline path's shape (B 64, turbo's 128 mels) and at tiny's
    (B 8, 80 mels), on reflect-padded seeded noise. The bound counts the
    operations the function needs, not those of the TPU kernel's dense DFT
    matmul: per frame the Hann window, a real FFT of 400 points at the usual
    2.5 n log2 n, the power of 201 bins, the mel projection over each
    filter's nonzero bins and the log. The dense algorithm's bound is kept
    beside it as ``dft_matmul_bound_ms``."""
    from whisper_tpu_torch.ops.log10_mel import log10_mel, log10_mel_plain
    from whisper_tpu_torch.ops.mel import mel_filterbank

    out = {}
    for b, n_mels in ((B, 128), (8, 80)):
        audio = torch.randn((b, 480000), generator=gen, device=dev) * 0.1
        x = torch.nn.functional.pad(audio[:, None], (200, 200), mode="reflect")[:, 0].contiguous()
        got = log10_mel(x, n_mels, 400, 160, 3000)
        res = check("log10_mel", got, log10_mel_plain(x, n_mels, 400, 160, 3000))
        nnz = int(np.count_nonzero(mel_filterbank(n_mels, 400)))
        flops = b * 3000 * (400 + 2.5 * 400 * math.log2(400) + 3 * 201 + 2 * nnz + 2 * n_mels)
        dft_flops = 2.0 * b * 3000 * 400 * 402 + 2.0 * b * 3000 * 201 * n_mels
        nbytes = 4.0 * x.numel() + 4.0 * b * n_mels * 3000
        out[f"B{b}/{n_mels}"] = {
            **res, "ms": cuda_ms(lambda: log10_mel(x, n_mels, 400, 160, 3000), reps=20),
            "plain_ms": cuda_ms(lambda: log10_mel_plain(x, n_mels, 400, 160, 3000), reps=5),
            "bound_ms": 1e3 * max(flops / PEAK_FP32, nbytes / PEAK_BYTES),
            "bound_by": "operations" if flops / PEAK_FP32 > nbytes / PEAK_BYTES else "bytes",
            "ops_ms": 1e3 * flops / PEAK_FP32, "bytes_ms": 1e3 * nbytes / PEAK_BYTES,
            "dft_matmul_bound_ms": 1e3 * max(dft_flops / PEAK_FP32, nbytes / PEAK_BYTES)}
    main = out[f"B{B}/128"]
    return {"name": "log10_mel", "route": "cuda", "source": "whisper_tpu_torch/csrc/log10_mel.cu",
            "replaces": "whisper_tpu/ops/mel_pallas.py:75",
            "shape": f"audio ({B}, 480400) fp32 -> ({B}, 128, 3000) fp32",
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "dft_matmul_bound_ms")},
            "bound_peaks": "67 TFLOP/s fp32, 3.35 TB/s", "cases": out,
            "library_ms": None, "library": "none: no single PyTorch call computes it"}


def kernel_k8(dev, gen) -> dict:
    """K8 at every turbo encoder shape: exact against its plain version at
    the offline batch's M and at ragged admission sizes, timed at the
    offline batch's M beside torch._int_mm with a column-major weight (the
    transpose of a contiguous (N, K), the layout K8 reads; ``library_ms``)
    and with the (K, N) row-major one (the path before K8;
    ``library_rowmajor_ms``)."""
    from whisper_tpu_torch.ops.int8_gemm import int8_gemm, int8_gemm_plain

    def rand8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    cases, layer = {}, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                        "library_rowmajor_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
    for K, N, per_layer in K8_KN:
        b = rand8(K, N)
        b_k = b.t().contiguous().t()  # K-major storage, as QTensor.k_major lays it out
        for M in K8_M:
            a = rand8(M, K)
            got = int8_gemm(a, b_k)
            torch.cuda.synchronize()
            if not torch.equal(got, int8_gemm_plain(a, b)):
                raise AssertionError(f"int8_gemm differs from its plain version at "
                                     f"M={M}, K={K}, N={N}")
            del got
            if M != T_AUDIO * B:
                continue
            ops, nbytes = 2.0 * M * K * N, M * K + K * N + 4.0 * M * N
            case = {"ms": cuda_ms(lambda: int8_gemm(a, b_k), reps=10),
                    "plain_ms": cuda_ms(lambda: int8_gemm_plain(a, b), reps=2, warmup=1),
                    "library_ms": cuda_ms(lambda: torch._int_mm(a, b_k), reps=10),
                    "library_rowmajor_ms": cuda_ms(lambda: torch._int_mm(a, b), reps=10),
                    "ops_ms": 1e3 * ops / PEAK_INT8, "bytes_ms": 1e3 * nbytes / PEAK_BYTES}
            case["bound_ms"] = max(case["ops_ms"], case["bytes_ms"])
            case["bound_by"] = "operations" if case["ops_ms"] > case["bytes_ms"] else "bytes"
            cases[f"M{M}/K{K}/N{N}"] = case
            for key in layer:
                layer[key] += per_layer * case[key]
            del a
            torch.cuda.empty_cache()
    n = sum(p for _, _, p in K8_KN)
    per_launch = {key: v / n for key, v in layer.items()}
    return {"name": "int8_gemm", "route": "cuda", "source": "whisper_tpu_torch/csrc/int8_gemm.cu",
            "replaces": "benchmarks/int8_gemm_probe.py:43",
            "shape": f"a ({T_AUDIO * B}, K) int8 @ b (K, N) int8, (K, N) in "
                     f"{[(k, n) for k, n, _ in K8_KN]}; times are the mean per launch of a turbo "
                     f"encoder layer's {n} GEMMs", "max_abs_err": 0.0, "exact_at_M": list(K8_M),
            **{k: per_launch[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                          "library_rowmajor_ms")},
            "bound_by": "operations" if layer["ops_ms"] > layer["bytes_ms"] else "bytes",
            "per_batch_ms": {k: L_AUDIO * v for k, v in layer.items()},
            "bound_peaks": "1,979 TOP/s int8, 3.35 TB/s", "cases": cases,
            "library": "torch._int_mm(a, b) with b column-major; library_rowmajor_ms with b "
                       "(K, N) row-major, the path before K8"}


def w8a8_card_vs_cpu(dev) -> dict:
    """The W8A8 activation quantization at turbo's width, on the card
    against the CPU: how many row scales ``amax / 127.0`` (a Python-scalar
    divisor, which CUDA turns into a product with the reciprocal) puts off
    the CPU's quotient and how many int8 activations flip as a result; and
    the port's ``_linear_a8`` (tensor divisor, K8) against the CPU's, which
    must be equal bit for bit."""
    from whisper_tpu_torch.models.model import _linear_a8
    from whisper_tpu_torch.ops.quant import quantize_weight

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, T_AUDIO, D_AUDIO)).astype(np.float32))
    amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8)
    scale_cpu, scale_card = amax / 127.0, (amax.to(dev) / 127.0).cpu()

    def quant(s):
        return torch.clamp(torch.round(x / s), -127, 127).to(torch.int32)

    ulps = (scale_card.view(torch.int32) - scale_cpu.view(torch.int32)).abs()
    flips = (quant(scale_card) - quant(scale_cpu)).abs()
    w = quantize_weight(torch.from_numpy(
        rng.standard_normal((D_AUDIO, D_AUDIO)).astype(np.float32) * 0.03))
    xs = x[:, :150]
    got = _linear_a8(xs.to(dev), w.to(dev), None, torch.float32).cpu()
    want = _linear_a8(xs, w, None, torch.float32)
    if not torch.equal(got, want):
        raise AssertionError(f"_linear_a8 on the card differs from the CPU by "
                             f"{float((got - want).abs().max())}")
    return {"phase": "w8a8_vs_cpu", "rows": int(amax.numel()),
            "scalar_divisor_rows_off": int((ulps > 0).sum()),
            "scalar_divisor_max_ulps": int(ulps.max()),
            "scalar_divisor_int8_flipped": int((flips > 0).sum()),
            "scalar_divisor_int8_max_diff": int(flips.max()),
            "int8_values": int(x.numel()),
            "linear_a8_card_equals_cpu": True, "linear_a8_shape": f"(2, 150, {D_AUDIO}) @ "
            f"({D_AUDIO}, {D_AUDIO})"}


def _launches(counters) -> dict:
    return {fn.__name__: fn.launches for fn in counters}


def _expect(path: str, launches: dict, want: dict) -> None:
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{path}: {name} ran {launches[name]} times, expected {n}")


def end_to_end(counters) -> dict:
    """The main path: turbo B64 / 64 tokens / kvq+skvq+w8a8 / bf16."""
    from whisper_tpu_torch.config import N_SAMPLES
    from whisper_tpu_torch.pipeline import WhisperPipeline

    t0 = time.perf_counter()
    pipe = WhisperPipeline(model="turbo", device="cuda", compute_dtype="bfloat16",
                           quantize=True, w8a8=True, kv_quant=True, self_kv_quant=True,
                           max_tokens=N_TOKENS, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((B, N_SAMPLES)).astype(np.float32) * 0.1
    clips = list(audio)

    t0 = time.perf_counter()
    pipe.transcribe_batch(clips)  # warm: kernel libraries loaded, allocator filled
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = pipe.transcribe_batch(clips)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(counters)

    dec = pipe.last_decode
    cfg = pipe.cfg
    lens = dec.lengths.cpu().numpy()
    P = len(cfg.sot_sequence(pipe.language, pipe.task))
    toks = dec.tokens.cpu().numpy()
    if len(results) != B or not all(isinstance(r.text, str) for r in results):
        raise AssertionError("transcribe_batch did not return one text per clip")
    if not ((lens >= P) & (lens <= min(cfg.n_text_ctx, P + N_TOKENS))).all():
        raise AssertionError(f"generated lengths out of range: {lens.tolist()}")
    if not ((toks >= 0) & (toks < cfg.n_vocab)).all():
        raise AssertionError("token ids out of the vocabulary")
    if not (torch.isfinite(dec.avg_logprob).all() and torch.isfinite(dec.no_speech_prob).all()):
        raise AssertionError("non-finite log-probabilities")
    _expect("offline", launches, {
        "log10_mel": 1, "flash_attention_btd": cfg.n_audio_layer,
        "int8_gemm": 6 * cfg.n_audio_layer,  # q, k, v, o, mlp1, mlp2 per layer
        "cross_attention_decode_fd": cfg.n_text_layer * dec.steps,
        "self_attention_decode_int8": cfg.n_text_layer * dec.steps})
    audio_s = B * N_SAMPLES / 16000
    stages = breakdown(pipe, clips, dec.steps)
    return {"phase": "end_to_end", "model": "turbo", "batch": B, "max_tokens": N_TOKENS,
            "dtype": "bfloat16", "quant": "int8 weights + w8a8 encoder + kvq + skvq",
            "init_s": init_s, "warm_s": warm_s, "wall_s": wall, "rtf": wall / audio_s,
            "audio_s_per_s": audio_s / wall, "generated": (lens - P).tolist(),
            "decode_steps": dec.steps, "host_syncs": dec.host_syncs,
            "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}, stages


def breakdown(pipe, clips, steps: int) -> dict:
    """Where the main path's time goes, from one profiled run of the real
    ``transcribe_batch``: per stage (the pipeline's ``whisper.*`` profiler
    ranges) the host span, the span the card gave the range (first kernel to
    last) and the kernel time inside that span, and the busiest kernels of
    the whole run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.transcribe_batch(clips)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages, spans, runs, kernels = {}, {}, [], {}
    for e in prof.events():
        on_card = e.device_type == DeviceType.CUDA
        if e.name.startswith("whisper."):
            st = stages.setdefault(e.name, {"host_ms": 0.0, "device_span_ms": 0.0,
                                            "kernel_ms": 0.0})
            if on_card:
                spans[e.name] = (e.time_range.start, e.time_range.end)
                st["device_span_ms"] += e.time_range.elapsed_us() / 1e3
            else:
                st["host_ms"] += e.cpu_time_total / 1e3
        elif on_card and not e.is_user_annotation:
            runs.append((e.time_range.start, e.time_range.end))
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    # one stream: a kernel belongs to the stage whose span on the card holds it
    for name, (lo, hi) in spans.items():
        stages[name]["kernel_ms"] = sum(b - a for a, b in runs if lo <= a and b <= hi) / 1e3
    missing = {"whisper.audio", "whisper.mel", "whisper.encoder", "whisper.cross_kv",
               "whisper.decode", "whisper.texts"} - set(stages)
    if missing:
        raise AssertionError(f"profile of transcribe_batch lacks the ranges {sorted(missing)}")
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {"phase": "breakdown", "source": "torch.profiler over pipe.transcribe_batch",
            "profiled_wall_s": wall, "stages": stages,
            "decode_device_ms_per_step": stages["whisper.decode"]["device_span_ms"] / (steps + 1),
            "device_busy_ms": busy, "device_busy_share": busy / 1e3 / wall,
            "kernel_launches": sum(n for _, n in kernels.values()),
            "top_kernels_ms": [[name[:90], ms, n] for name, (ms, n) in top]}


def _wav(x: np.ndarray) -> bytes:
    """16-bit PCM WAV bytes of mono 16 kHz audio."""
    pcm = np.round(np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def _post(url: str, clip: np.ndarray, multipart: bool) -> tuple:
    """(status, reply, seconds) of one POST /asr."""
    if multipart:
        body = (b"--B\r\nContent-Disposition: form-data; name=\"wav\"; filename=\"a.wav\"\r\n"
                b"Content-Type: audio/wav\r\n\r\n" + _wav(clip) + b"\r\n--B--\r\n")
        headers = {"Content-Type": "multipart/form-data; boundary=B"}
    else:
        body, headers = clip.astype("<f4").tobytes(), {"Content-Type": "application/octet-stream"}
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, headers=headers),
                                    timeout=600) as r:
            return r.status, json.load(r), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode()}, time.perf_counter() - t0


N_REQUESTS, N_MULTIPART = 24, 4


def serving(counters) -> dict:
    """The serving path: ``python -m whisper_tpu_torch.serving``'s engine
    under the server's zero-flag defaults, in-process on 127.0.0.1, one warm
    request, then 24 seeded noise clips of 2-30 s from 24 client threads
    (every sixth as multipart WAV, the rest as f32 PCM)."""
    from whisper_tpu_torch.serving.__main__ import build_engine, parse_args
    from whisper_tpu_torch.serving.server import make_server

    args = parse_args(["--model_type", "turbo", "--host", "127.0.0.1", "--port", "0"])
    t0 = time.perf_counter()
    engine, phases = build_engine(args)
    engine.start()
    srv = make_server(engine, args.host, args.port, request_timeout_s=600)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/asr"
    try:
        rng = np.random.default_rng(2)
        clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
                 for s in rng.uniform(2.0, 30.0, N_REQUESTS)]
        code, reply, _ = _post(url, clips[0][:16000 * 3], False)  # warm: cuBLAS, allocator
        if code != 200:
            raise AssertionError(f"warm request answered {code}: {reply}")
        startup_s = time.perf_counter() - t0
        st0 = engine.stats.snapshot()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_REQUESTS) as pool:
            replies = list(pool.map(lambda i: _post(url, clips[i], i % 6 == 0),
                                    range(N_REQUESTS)))
        wall = time.perf_counter() - t0
        launches = _launches(counters)
        st1 = engine.stats.snapshot()
        with urllib.request.urlopen(url.replace("/asr", "/metrics"), timeout=30) as r:
            metrics = json.load(r)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
        server.join(timeout=30)
    bad = [(code, reply) for code, reply, _ in replies
           if code != 200 or not reply.get("success") or not isinstance(reply.get("text"), str)
           or not 0 <= reply.get("tokens", -1) <= args.max_tokens]
    if bad:
        raise AssertionError(f"{len(bad)} of {N_REQUESTS} replies failed: {bad[:3]}")
    cfg = engine.cfg
    steps = st1["steps_total"] - st0["steps_total"]
    batches = st1["encode_batches_total"] - st0["encode_batches_total"]
    _expect(f"serving ({steps} steps, {batches} admission batches)", launches, {
        "log10_mel": batches, "flash_attention_btd": cfg.n_audio_layer * batches,
        "int8_gemm": 6 * cfg.n_audio_layer * batches,
        "cross_attention_decode_fd": cfg.n_text_layer * steps,
        "self_attention_decode_int8": cfg.n_text_layer * steps})
    lat = np.array([sec for _, _, sec in replies])
    audio_s = sum(len(c) for c in clips) / 16000
    return {"phase": "serving", "model": "turbo", "flags": "server defaults: "
            "--slots 8 --steps_per_sync 32 --max_tokens 224, w8a8 + kv_quant + "
            "self_kv_quant, bfloat16", "requests": N_REQUESTS, "multipart": N_MULTIPART,
            "answered_200": N_REQUESTS - len(bad), "startup_s": startup_s,
            "startup_phases": phases, "kernel_build_s": engine.stats.warmup_seconds,
            "wall_s": wall, "requests_per_s": N_REQUESTS / wall,
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p95_s": float(np.percentile(lat, 95)),
            "audio_s": audio_s, "audio_s_per_s": audio_s / wall,
            "tokens": [reply["tokens"] for _, reply, _ in replies],
            "ticks": st1["ticks_total"] - st0["ticks_total"], "steps": steps,
            "admission_batches": batches, "launches": launches, "metrics": metrics}


def serving_reference_check() -> dict:
    """A small fp32 engine (tiny, kvq + skvq) on the card, rounds driven one
    tick at a time through its kernels, must give the CPU pipeline's tokens
    (plain versions) for the same clips."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    from whisper_tpu_torch.tokenizer import get_tokenizer

    class IdText:
        """The real tokenizer's suppressed set; decodes to the ids, so a
        reply carries its tokens."""
        non_speech_tokens = get_tokenizer(num_languages=99).non_speech_tokens

        def decode(self, ids):
            return " ".join(str(int(t)) for t in ids)

    rng = np.random.default_rng(4)
    clips = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (4, 9, 2)]
    # the same CPU-drawn weights on both sides (CPU and CUDA generators differ)
    params = init_params(get_config("tiny"), seed=3, device="cpu")
    engine = ContinuousBatchingEngine(
        init_params(get_config("tiny"), seed=3, device="cpu").to_device("cuda"), IdText(),
        max_slots=4, compute_dtype=torch.float32, steps_per_sync=4, max_tokens=12,
        kv_quant=True, self_kv_quant=True, no_speech_threshold=None, logprob_threshold=None,
        compression_ratio_threshold=None)
    futs = [engine.submit(Request(audio=c)) for c in clips]
    for _ in range(50):
        if all(f.done() for f in futs):
            break
        engine._tick()
    got = [[int(t) for t in f.result(0)["text"].split()] for f in futs]
    pipe = WhisperPipeline(device="cpu", compute_dtype="float32", kv_quant=True,
                           self_kv_quant=True, max_tokens=12, params=params)
    want = [r.tokens.tolist() for r in pipe.transcribe_batch(clips)]
    if got != want:
        raise AssertionError(f"engine tokens on the card differ from the CPU pipeline's: "
                             f"{got} vs {want}")
    return {"phase": "serving_reference", "model": "tiny", "dtype": "float32",
            "tokens_equal_cpu_pipeline": True, "tokens": got}


def reference_check() -> dict:
    """A small fp32 transcription (tiny, kvq + skvq) on the card through both
    kernels must give the CPU pipeline's tokens (plain versions)."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.pipeline import WhisperPipeline

    rng = np.random.default_rng(1)
    clips = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (4, 9)]
    toks = {}
    for dev in ("cuda", "cpu"):
        # the same CPU-drawn weights on both sides (CPU and CUDA generators differ)
        params = init_params(get_config("tiny"), seed=3, device="cpu").to_device(dev)
        pipe = WhisperPipeline(device=dev, compute_dtype="float32", kv_quant=True,
                               self_kv_quant=True, max_tokens=12, params=params)
        toks[dev] = [r.tokens.tolist() for r in pipe.transcribe_batch(clips)]
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError(f"card and CPU tokens differ: {toks}")
    return {"phase": "reference", "model": "tiny", "dtype": "float32",
            "tokens_equal_cpu": True, "tokens": toks["cuda"]}


N_LONGFORM = 4
LONGFORM_ARGS = ["--model_type", "turbo", "--dtype", "bfloat16", "--quantize", "--w8a8",
                 "--kv_quant", "--self_kv_quant", "--max_tokens", str(N_TOKENS), "--longform",
                 "--timestamps", "-f", "json"]


def _n_samples(seconds: float) -> int:
    return int(16000 * seconds)


def _write_wavs(folder, seconds, seed: int) -> list:
    rng = np.random.default_rng(seed)
    paths = []
    for i, sec in enumerate(seconds):
        path = f"{folder}/clip{i}.wav"
        with open(path, "wb") as f:
            f.write(_wav(rng.standard_normal(_n_samples(sec)) * 0.1))
        paths.append(path)
    return paths


def longform(counters) -> dict:
    """The long-form path through the CLI entry point, in-process: four
    seeded noise WAVs of 60-120 s to json files. Reads the pipeline's round,
    window and step counts, checks every file and the kernels' launches."""
    import tempfile

    from whisper_tpu_torch import cli

    rng = np.random.default_rng(6)
    seconds = [float(s) for s in rng.uniform(60.0, 120.0, N_LONGFORM)]
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_wavs(tmp, seconds, seed=7)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["--wav", *paths, *LONGFORM_ARGS, "-o", f"{tmp}/out"], report=report)
        cli_wall = time.perf_counter() - t0
        launches = _launches(counters)
        docs = []
        for path in paths:
            stem = path.rsplit("/", 1)[1][:-4]
            with open(f"{tmp}/out/{stem}.json") as f:
                docs.append(json.load(f))
    if rc != 0 or report["pipeline"].last_seek is None:
        raise AssertionError(f"cli.main returned {rc}, long-form counts "
                             f"{report['pipeline'].last_seek}")
    n_segments, past_end, open_ends = 0, 0, 0
    for doc, sec in zip(docs, seconds):
        segs = doc["segments"]
        starts = [sg["start"] for sg in segs]
        if abs(doc["audio_seconds"] - _n_samples(sec) / 16000) > 1e-6:
            raise AssertionError(f"audio_seconds {doc['audio_seconds']} for a {sec} s clip")
        if starts != sorted(starts) or any(not 0 <= st <= sec + 30 for st in starts):
            raise AssertionError(f"segment starts out of order or range: {starts}")
        if any(sg["end"] is not None and sg["end"] < sg["start"] for sg in segs):
            raise AssertionError("a segment ends before it starts")
        if not all(isinstance(sg["text"], str) for sg in segs) or not isinstance(doc["text"], str):
            raise AssertionError("non-string text in the json")
        n_segments += len(segs)
        past_end += sum(st > sec for st in starts)
        open_ends += sum(sg["end"] is None for sg in segs)
    cfg, stats, wall = report["pipeline"].cfg, report["pipeline"].last_seek, report["transcribe_s"]
    _expect("longform", launches, {
        "log10_mel": stats["rounds"], "flash_attention_btd": cfg.n_audio_layer * stats["rounds"],
        "int8_gemm": 6 * cfg.n_audio_layer * stats["rounds"],
        "cross_attention_decode_fd": cfg.n_text_layer * stats["steps"],
        "self_attention_decode_int8": cfg.n_text_layer * stats["steps"]})
    audio_s = sum(_n_samples(s) / 16000 for s in seconds)
    return {"phase": "longform", "entry": "whisper_tpu_torch.cli.main",
            "args": LONGFORM_ARGS + ["-o", "<tmp>"], "clips_s": seconds, "audio_s": audio_s,
            **stats, "cli_wall_s": cli_wall, "transcribe_wall_s": wall,
            "rtf": wall / audio_s, "audio_s_per_s": audio_s / wall,
            "segments": n_segments, "segments_open": open_ends,
            "segments_starting_past_clip_end": past_end, "launches": launches}


def longform_reference_check() -> dict:
    """Tiny fp32 (kvq + skvq, 12 tokens a window) seek-based long-form of a
    40 s and a 70 s clip: the card's segments and texts equal the CPU's."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.pipeline import WhisperPipeline

    rng = np.random.default_rng(8)
    clips = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (40, 70)]
    out = {}
    for dev in ("cuda", "cpu"):
        # the same CPU-drawn weights on both sides (CPU and CUDA generators differ)
        params = init_params(get_config("tiny"), seed=3, device="cpu").to_device(dev)
        pipe = WhisperPipeline(device=dev, compute_dtype="float32", kv_quant=True,
                               self_kv_quant=True, max_tokens=12, language="en", params=params)
        out[dev] = [(r.text, r.segments) for r in pipe.transcribe_longform(clips)]
        out[dev + "_seek"] = pipe.last_seek
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"long-form on the card differs from the CPU: {out}")
    return {"phase": "longform_reference", "model": "tiny", "dtype": "float32",
            "segments_and_texts_equal_cpu": True, "seek": out["cuda_seek"],
            "segments": [len(segs) for _, segs in out["cuda"]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops.decode_attention import (
        cross_attention_decode_fd, self_attention_decode, self_attention_decode_int8)
    from whisper_tpu_torch.ops.flash_attention import flash_attention_btd
    from whisper_tpu_torch.ops.int8_gemm import int8_gemm
    from whisper_tpu_torch.ops.log10_mel import log10_mel

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 checks run in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    build = _build.build_all()
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in _build.KERNELS}
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build["build_s"], "ptxas": ptxas})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = []
    for phase in (kernel_k1, kernel_k2, kernel_k3, kernel_k7, kernel_k8):
        kernels.append(phase(dev, gen))
        emit({"phase": "kernel", **kernels[-1]})
        torch.cuda.empty_cache()
    emit(w8a8_card_vs_cpu(dev))

    counters = (log10_mel, flash_attention_btd, int8_gemm, cross_attention_decode_fd,
                self_attention_decode_int8, self_attention_decode)
    e2e, stages = end_to_end(counters)
    emit(e2e)
    emit(stages)
    torch.cuda.empty_cache()
    served = serving(counters)
    emit(served)
    torch.cuda.empty_cache()
    long = longform(counters)
    emit(long)
    torch.cuda.empty_cache()
    emit(reference_check())
    emit(serving_reference_check())
    emit(longform_reference_check())

    for k in kernels:
        k["launches"] = e2e["launches"][k["name"]]
        k["serving_launches"] = served["launches"][k["name"]]
        k["longform_launches"] = long["launches"][k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "serving_launches",
            "longform_launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(smi)
    emit({"kernels": [{key: k[key] for key in keys} for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
