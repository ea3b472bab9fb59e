"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``whisper_tpu_torch/csrc/`` (nvcc,
sm_90a), holds each against its plain PyTorch version at the main path's
shapes, drives the main path (``WhisperPipeline.transcribe_batch``, turbo at
full width, batch 64, 64 new tokens, bf16, int8 weights + W8A8 encoder + int8
cross- and self-KV, seeded random weights) while counting kernel launches,
and checks a small fp32 transcription on the card against the same pipeline
on the CPU. Prints JSON lines; the last is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
Needs a CUDA card: without one it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# NVIDIA H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 without
# tensor cores, HBM3 bandwidth. Rates at the full 700 W power limit.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# main-path shapes: turbo encoder attention and decode cross-attention at B64
B, T_AUDIO, D_AUDIO, H_AUDIO = 64, 1500, 1280, 20
H_TEXT, DH = 20, 64
N_TOKENS = 64

# kernel-vs-plain tolerances (max |kernel - plain|) and why:
#  K1 bf16: p is rounded to bf16 before p.v unnormalised (plain rounds the
#    normalised weights) and outputs are bf16: one bf16 ulp at |out| < 2 is
#    2^-7 = 7.8e-3;
#  K1 fp32: fp32 summation order only;
#  K2 bf16: both compute in fp32 and round to bf16; one bf16 ulp at |out|<1
#    is <= 2^-8 = 3.9e-3;
#  K2 fp32: fp32 summation order only.
TOL = {"flash_attention_btd/bf16": 8e-3, "flash_attention_btd/fp32": 1e-4,
       "cross_attention_decode_fd/bf16": 4e-3, "cross_attention_decode_fd/fp32": 1e-4}


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
    launches = {fn.__name__: fn.launches for fn in counters}

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
    if launches["flash_attention_btd"] != cfg.n_audio_layer:
        raise AssertionError(f"K1 ran {launches['flash_attention_btd']} times, "
                             f"expected {cfg.n_audio_layer} per encoder pass")
    if launches["cross_attention_decode_fd"] != cfg.n_text_layer * dec.steps:
        raise AssertionError(f"K2 ran {launches['cross_attention_decode_fd']} times over "
                             f"{dec.steps} steps, expected {cfg.n_text_layer} per step")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops.decode_attention import cross_attention_decode_fd
    from whisper_tpu_torch.ops.flash_attention import flash_attention_btd

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
    kernels = [kernel_k1(dev, gen), kernel_k2(dev, gen)]
    for k in kernels:
        emit({"phase": "kernel", **k})
    torch.cuda.empty_cache()

    counters = (flash_attention_btd, cross_attention_decode_fd)
    e2e, stages = end_to_end(counters)
    emit(e2e)
    emit(stages)
    emit(reference_check())

    for k in kernels:
        k["launches"] = e2e["launches"][k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    emit({"kernels": [{key: k[key] for key in keys} for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
