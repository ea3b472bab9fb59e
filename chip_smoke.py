"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's nine CUDA kernels from ``whisper_tpu_torch/csrc/`` (nvcc,
sm_90a, one process per source, in parallel), holds each against its plain
PyTorch version at the shapes of the paths below (and a turbo layer's six
W8A8 linears as one chain, K8q + K8 against the PyTorch composition they
replace; K2 at the offline, serving, long-form and tp 2 rank batches, K3 at
the paths' windows on both caches, K5 at the offline and serving
batches, K7 at the offline and admission batches beside ``torch.stft``),
checks what the binaries hold (the wgmma kernels' HGMMA/IGMMA and TMA
loads, K2's and K5's bulk copies, K5's mma.sync, K3's cp.async, no I2F
conversion in K2, K3 or K5, no register spill in K2, K3, K5 or K7), and
drives each path while counting kernel launches:

- the offline path, ``WhisperPipeline.transcribe_batch``: turbo at full
  width, batch 64, 64 new tokens, bf16, int8 weights + W8A8 encoder + int8
  cross- and self-KV, seeded random weights;
- the decode loops as CUDA graphs (``decode_graph``): that path's greedy
  decode under each ``cross_decode`` selection, replayed as graphs, held
  bit for bit against the same rounds uncaptured and against the
  step-by-step loop they replaced, with the host's launch calls, the
  cross-KV copy, the capture seconds, the graph pool's bytes and the
  round length swept in turns; the same decode sampled at 0.6 (a ladder
  rung) under each selection, graphed against its rounds uncaptured under
  one seed's draws, with the noise fill of a round; and the pipeline with
  its ladder on over three batches whose rungs re-decode shrinking subsets
  of the rows, the main decode's graphs kept and replayed throughout (every
  single-device greedy, sampled and beam decode and engine round below
  replays its graphs too, the aux worker's included, launches counted
  through the replays);
- the serving path: the port's HTTP server in-process on 127.0.0.1 under the
  server's zero-flag defaults (turbo, 8 slots, 32 steps per sync, 224-token
  budget, W8A8 + int8 cross- and self-KV, bf16), answering 24 seeded noise
  clips of 2-30 s from 24 client threads;
- the long-form path, through the CLI entry point in-process
  (``whisper_tpu_torch.cli.main``: turbo, bf16, int8 weights + W8A8 + int8
  cross- and self-KV, 64 tokens a window, seek-based ``--longform
  --timestamps -f json``, condition-on-previous-text on) over four seeded
  noise WAVs of 60-120 s;
- the kernel selections (the JAX package's ``WHISPER_TPU_FLASH=bhtd`` and
  ``WHISPER_TPU_DECODE_FLASH=legacy|dense``): the offline path again with
  ``encoder_attention="bhtd"`` and ``cross_decode="legacy"``, then
  ``"dense"``, and a burst of 8 clips to a server built from
  ``--encoder_attention bhtd --cross_decode dense``;
- the temperature ladder: 8 clips to a turbo server at its true zero-flag
  defaults (ladder 0.2 ... 1.0 on), so every request climbs the ladder
  through the aux worker (the serving bursts above pass
  ``--temperature_fallback ''``: the greedy core, as before the ladder);
- tensor-parallel serving: the turbo server's defaults (ladder off) on a
  (1, 2) mesh whose two ranks share the card, 8 clips over HTTP, its W8A8
  encoder held bit-equal to the one-rank engine's and its texts beside
  that engine's;
- the real-weights path: the seeded turbo weights written as an OpenAI
  fp16 ``.pt``, ``WhisperPipeline(checkpoint=..., language=None)`` at the
  offline configuration (ladder off) run from it over 64 clips and held
  token for token and language for language against a pipeline built from
  the same weights in memory, the loaded int8 model's snapshot round trip
  (bit-equal), language detection with the kernels against their plain
  versions on the same cross-KV, the WER entry point
  (``whisper_tpu_torch.eval``) over 8 synthetic AIShell-format clips with
  that ``.pt``, the quantization gate at turbo (its fp32 control at zero),
  and 8 ``language=auto`` clips to the turbo server;
- the server's greedy options (ladder off): one burst of short clips,
  clips of 60-90 s fanned out into windows and decoded window by window
  under ``condition_on_previous``, ``initial_prompt`` contexts up to the cap
  (slots behind per-slot pads), ``stream=1`` and ``format=txt``; 8 clips to
  a server started with ``--timestamps``; and the 24-clip burst again with
  ``--encode_chunks 4 --adaptive_sync`` (the segmented cross-KV held
  bit-equal to the monolithic one);
- beam search: ``WhisperPipeline(beam_size=5)`` over 16 seeded 30 s noise
  clips at the offline configuration (64 tokens, ladder off), its wall
  beside greedy on the same clips, its loop graphed against the same
  rounds uncaptured and the per-step loop they replaced (bit for bit, with
  the host's launch calls), the step's reorder and top-k, and one
  layer-step's folded cross-attention beside K2 on expanded cross-KV; then
  a burst of 24 clips to the turbo server (ladder off), 8 of them at
  ``beam=5`` (multipart field and ``X-Beam``), on its aux worker;
- word timestamps: ``WhisperPipeline(word_timestamps=True)`` at the
  offline configuration on its 64 clips, its wall beside the same pipeline
  without words, the alignment pass's card time and the host's DTW; then a
  burst of 12 requests to the turbo server (ladder off) with words: short
  clips, ``format=srt``, ``vtt`` and ``tsv``, a clip of 60-90 s, a
  ``beam=5`` and a ``temperature=0.4`` one (the align worker behind the
  slots and the aux worker);
- speculative decoding: ``WhisperPipeline(spec_draft="distil-large-v3")``
  over 16 seeded 30 s noise clips (turbo target at the offline
  configuration, a random draft, 64 tokens, gamma 4), its wall beside
  greedy's, the target as its own draft, and the costs of a round (the
  target's step and window, the draft's step) at turbo and at large-v3;
- data parallelism: ``python -m whisper_tpu_torch.serving --dp 2`` at turbo
  (ladder off) as a process of its own, both workers on this card, answering
  the 24-clip burst, a 75 s request the router splits over both workers and
  the same request streamed (the workers' launches read from their
  ``/metrics``), then SIGTERM, after which no worker may live; meshes with
  data rows on the card (tiny greedy, beam and speculative decodes against
  the unsharded model, the turbo W8A8 encoder bit for bit, and the offline
  path with its model at (2, 1) beside the unsharded one);
- the utils: ``StageTimer`` around the offline run's stages,
  ``profiler_trace`` around a decode step, the native IO library where
  cmake can build it;
- the engine's knobs: the turbo server's engine warmed (``warmup()``,
  what its default ``--warm_start`` runs: launches exact, the slot
  bookkeeping and cross-KV bit-equal across it) and then the 24-clip burst
  with no warm request and no cold key; two fresh server processes, with
  and without ``--no-warm_start``, timed from spawn to ``/health`` and over
  their first and second 30 s clip; 8 clips to an engine with
  ``apply_filters=False`` and 12 to one with ``prefill_buckets=(1, 8)``
  (its admissions at those buckets); and the weights-day dry run
  (``python -m whisper_tpu_torch.weights_day --dry-run --device cuda``,
  tiny, its ``--dp 2`` fleet on this card).

Then it checks small fp32 runs of the paths on the card against the CPU
(the offline one under each selection, the TP engine against the one-rank
engine on the CPU, a sampled decode with the same noise on both and beam
searches, graphed on the card and uncaptured on the CPU, language
detection, the engine's ``language=auto`` replies, prompted rows,
timestamps and a long clip through the engine, the alignment
matrix and words of teacher-forced text and the same pass on a mesh,
speculative decodes and a verify window across the cache's end, a
``--dp 2`` fleet of tiny fp32 workers against the single-engine server,
and engines with ``apply_filters=False``; the TP engine warmed on each
rank first). Prints
JSON lines; the last is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without it. Needs a CUDA card: without one it exits 1 and prints
no result. ``chip_tp.py`` runs the tensor-parallel phases over distinct
cards.
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# CUPTI stays attached between torch.profiler windows: torn down after each
# window and attached again at the next, it can leave whole windows without
# the card's activity
os.environ.setdefault("TEARDOWN_CUPTI", "0")

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
N_LONGFORM = 4  # the long-form path's clips, so its window batch

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
#  K7 f64: against the same function in float64 (``_log10_mel_f64``): the
#    kernel's FFT is float64, so only its fp32 power, mel sums and log2
#    remain (6e-7 measured); an fp32 FFT reads 1.4e-4 to 4.2e-4 there
#    (PERF.md), so 1e-5 holds the kernel's own error, which the check
#    against the fp32 plain version (up to 7e-4 off itself) cannot;
#  K8: int32 sums of int8 products are exact: equality; its scaled epilogue
#    rounds each step as the PyTorch epilogue does: equality;
#  K8q: the same roundings as the plain version (IEEE division, round half
#    to even): equality;
#  K6: K1's kernel on split heads, K1's tolerances and reasons;
#  K4 bf16: the scaled query and (MXU form) the normalised weights are
#    rounded to bf16 on both sides; a weight rounded the other way after
#    another sum order moves an output far less than one bf16 ulp below 2
#    (2^-7 = 7.8e-3), which bounds the output rounding; fp32: sum order only;
#  K5 bf16: as K4 bf16; fp32: the operands are bf16 for an fp32 query too,
#    so a weight rounded the other way moves an output by ~w * 2^-8 * |v s|,
#    below 1e-3.
TOL = {"flash_attention_btd/bf16": 8e-3, "flash_attention_btd/fp32": 1e-4,
       "cross_attention_decode_fd/bf16": 4e-3, "cross_attention_decode_fd/fp32": 1e-4,
       "self_attention_decode/bf16": 4e-3, "self_attention_decode/fp32": 1e-5,
       "log10_mel": 5e-4, "int8_gemm": 0.0, "quantize_rows": 0.0,
       "flash_attention/bf16": 8e-3, "flash_attention/fp32": 1e-4,
       "cross_attention_decode/bf16": 8e-3, "cross_attention_decode/fp32": 1e-4,
       "cross_attention_decode_dense/bf16": 8e-3, "cross_attention_decode_dense/fp32": 1e-3,
       "log10_mel/f64": 1e-5}
# K3's shapes: (batch, self-KV positions, offsets drawn from [lo, hi], pads
# drawn from [0, max]) of the offline path (prompt of 4, 64 new tokens,
# cache bucketed to 128), the serving path (8 slots, 224-token budget, cache
# bucketed to 256), its prompted slots (initial_prompt contexts of up to the
# cap of 223 tokens: prompts of 1 + 223 + 4, offsets 229..255, a row's pad
# 0..224, 224 for a row without context beside a capped one) and the
# long-form path (prompts of up to 1 + 223 + 3
# previous-text and sot tokens, left-padded by up to 60, 64 new tokens,
# cache bucketed to 384); and the language-detection step, float cache only
# (one [sot] at offset 0 in a cache of 128, the offline batch)
K3_SHAPES = {"offline": (B, 128, 4, 4 + N_TOKENS - 1, None),
             "serving": (8, 256, 4, 4 + 224 - 1, None),
             "longform": (8, 384, 226, 226 + N_TOKENS - 1, 60),
             "detect": (B, 128, 0, 0, None),
             "prompted": (8, 256, 229, 255, 224),
             "beam": (16 * 5, 128, 4, 4 + N_TOKENS - 1, None)}
# the shapes added after others: drawn from generators of their own, so the
# inputs of every other K3 case and of the phases after K3 stay as they were
# (beam: the beam phase's 16 clips x 5 beams, one row a beam)
K3_OWN_SEED = {"prompted": 29, "beam": 31}
# K8's shapes: the turbo encoder's (K, N) per layer (q, k, v, o; mlp w1;
# mlp w2) at the offline batch (M = 1500 x 64) and at ragged admission sizes
K8_KN = ((1280, 1280, 4), (1280, 5120, 1), (5120, 1280, 1))
K8_M = (T_AUDIO * B, 1500, 4500)
# the same products per rank at tp 2 (q/k/v and w1 split their columns, o
# and w2 their rows), at the admission sizes
K8_TP_KN = ((1280, 640), (640, 1280), (1280, 2560), (2560, 1280))
K8_TP_M = (1500, 4500)
# K8q's rows: the inputs of q/k/v, o and w1 (D = 1280) and of w2 (4 D)
K8Q_K = (D_AUDIO, 4 * D_AUDIO)
L2_BYTES = 50e6


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "elapsed_s": round(time.perf_counter() - T0, 1)}), flush=True)


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
    return sum(device_kernels_ms(fn, reps).values())


def launch_ms(fn, reps: int, launches: int) -> float:
    """Mean time on the card of one kernel launch of ``fn``, a loop of
    ``launches`` calls that each launch one kernel: the profiled kernels'
    summed time over their count, so a launch the profiler's window missed
    biases nothing."""
    split = device_kernels(fn, reps)
    if EVENTS in split:
        return split[EVENTS][0] / launches
    return sum(ms for ms, _ in split.values()) / sum(n for _, n in split.values())


def device_kernels_ms(fn, reps: int) -> dict:
    """``device_ms`` split by the kernels' names: mean ms per call of each."""
    return {name: ms for name, (ms, _) in device_kernels(fn, reps).items()}


# the key of ``device_kernels``' answer when no profiled window held the
# card's activity; ``PROFILER_MISSES`` counts such windows, reported in the
# ``profiler`` record
EVENTS = "(cuda events: no profiled window held the card's activity)"
PROFILER_MISSES = {"empty_windows": 0, "events_fallbacks": 0}


def device_kernels(fn, reps: int = 1, fallback: bool = True) -> dict:
    """{kernel name: (mean ms, launches) per call of ``fn``} on the card
    (CUPTI, through torch.profiler). Where five windows in a row come back
    without the card's activity, ``{EVENTS: (ms, None)}`` from CUDA events
    around the same loop, which adds the gaps between launches; without
    ``fallback`` that raises instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the process's first profiled window can come back without the card's
    # activity (CUPTI starting up), so an empty window is taken again
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                ms, n = split.get(e.name, (0.0, 0))
                split[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / reps, n + 1 / reps)
        if sum(ms for ms, _ in split.values()) > 0:
            return split
        PROFILER_MISSES["empty_windows"] += 1
    if not fallback:
        raise AssertionError("torch.profiler recorded no time on the card in five windows")
    PROFILER_MISSES["events_fallbacks"] += 1
    return {EVENTS: (cuda_ms(fn, reps, warmup=0), None)}


def check(name: str, got: torch.Tensor, ref: torch.Tensor, **extra) -> dict:
    """max |got - ref| against TOL[name], in float64 where ``ref`` is, else
    in fp32; ``extra`` is reported beside it."""
    torch.cuda.synchronize()
    dt = torch.float64 if ref.dtype == torch.float64 else torch.float32
    err = (got.to(dt) - ref.to(dt)).abs()
    rel = float(torch.linalg.vector_norm(got.to(dt) - ref.to(dt))
                / torch.linalg.vector_norm(ref.to(dt)))
    out = {"max_abs_err": float(err.max()), "rel_l2_err": rel, "tol_abs": TOL[name], **extra}
    if not torch.isfinite(got).all() or out["max_abs_err"] > TOL[name]:
        raise AssertionError(f"{name} disagrees with its plain version: {out}")
    return out


def _attention_times(b: int, ms: float, library_ms: float) -> dict:
    """K1's and K6's time at batch ``b`` of turbo's encoder attention (T 1500,
    20 heads of 64) beside SDPA's, the bound, the achieved rate and the
    share of the bound reached."""
    flops = 4.0 * b * H_AUDIO * T_AUDIO * T_AUDIO * DH
    nbytes = 4.0 * b * T_AUDIO * D_AUDIO * 2
    bound_ms = 1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BYTES)
    return {"ms": ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_BF16 > nbytes / PEAK_BYTES else "bytes",
            "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}


def kernel_k1(dev, gen) -> dict:
    """K1 at the offline shape (turbo B64), held against its plain version
    and timed beside SDPA on the same tensors split into heads; timed again
    at the serving and long-form batch sizes (B 1 and 8, ``cases``); an fp32
    check at a small batch."""
    from whisper_tpu_torch.ops.flash_attention import (
        flash_attention_btd, flash_attention_btd_plain)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (rand(B, T_AUDIO, D_AUDIO) for _ in range(3))
    got = flash_attention_btd(q, k, v, H_AUDIO)
    chunk = 8  # the plain version's fp32 scores are 1.4 GB per 8 rows
    ref = torch.cat([flash_attention_btd_plain(q[i:i + chunk], k[i:i + chunk],
                                               v[i:i + chunk], H_AUDIO)
                     for i in range(0, B, chunk)])
    res = check("flash_attention_btd/bf16", got, ref)
    del ref
    plain_ms = cuda_ms(lambda: [flash_attention_btd_plain(q[i:i + chunk], k[i:i + chunk],
                                                          v[i:i + chunk], H_AUDIO)
                                for i in range(0, B, chunk)], reps=2, warmup=1)
    times = {}
    for b in (B, 8, 1):
        qb, kb, vb = q[:b], k[:b], v[:b]
        qh, kh, vh = (t.reshape(b, T_AUDIO, H_AUDIO, DH).transpose(1, 2).contiguous()
                      for t in (qb, kb, vb))
        reps = 10 if b == B else 50
        times[b] = _attention_times(
            b, cuda_ms(lambda: flash_attention_btd(qb, kb, vb, H_AUDIO), reps=reps),
            cuda_ms(lambda: sdpa(qh, kh, vh), reps=reps))
        del qh, kh, vh
    # fp32 path at a small batch
    qf, kf, vf = (rand(2, T_AUDIO, D_AUDIO, dtype=torch.float32) for _ in range(3))
    res32 = check("flash_attention_btd/fp32", flash_attention_btd(qf, kf, vf, H_AUDIO),
                  flash_attention_btd_plain(qf, kf, vf, H_AUDIO))
    return {"name": "flash_attention_btd", "route": "cuda",
            "source": "whisper_tpu_torch/csrc/flash_attention_btd.cu",
            "kernel_source": "whisper_tpu_torch/csrc/flash_attention_sm90.cuh",
            "replaces": "whisper_tpu/ops/flash_attention.py:146",
            "shape": f"q,k,v,o ({B},{T_AUDIO},{D_AUDIO}) bf16, H={H_AUDIO}",
            **res, "fp32_check": res32, **times[B], "plain_ms": plain_ms,
            "cases": {f"B{b}": times[b] for b in (8, 1)},
            "bound_peaks": "989 TFLOP/s bf16, 3.35 TB/s",
            "library": "F.scaled_dot_product_attention (B,H,T,dh)"}


def kernel_k1_sharded(dev, gen) -> dict:
    """K1s, the sharded entry (``flash_attention_btd_sharded``) on (1, tp)
    meshes whose ranks share the card, at the offline shape (turbo B64):
    its output beside the full K1's (attention is per head, so equality is
    expected) at tp 2 and 4; one rank's local launch at tp 2 (10 heads,
    (B, 1500, 640)) held against its plain version and timed beside it and
    beside SDPA on the same local heads; and the whole entry's time
    (column split, launches, concatenation)."""
    from whisper_tpu_torch.ops.flash_attention import (
        flash_attention_btd, flash_attention_btd_plain, flash_attention_btd_sharded)
    from whisper_tpu_torch.parallel.sharding import make_mesh

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (torch.randn((B, T_AUDIO, D_AUDIO), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    full = flash_attention_btd(q, k, v, H_AUDIO)
    meshes, cases = {}, {}
    for tp in (2, 4):
        meshes[tp] = make_mesh(1, tp, devices=[dev] * tp)
        got = flash_attention_btd_sharded(q, k, v, H_AUDIO, meshes[tp])
        torch.cuda.synchronize()
        cases[f"tp{tp}"] = {"local_heads": H_AUDIO // tp,
                            "max_abs_diff_vs_full_k1": float((got.float() - full.float())
                                                             .abs().max()),
                            "equal_to_full_k1": bool(torch.equal(got, full))}
        del got
    del full
    tp, width, heads = 2, D_AUDIO // 2, H_AUDIO // 2
    ql, kl, vl = (t[..., :width].contiguous() for t in (q, k, v))
    chunk = 8
    ref = torch.cat([flash_attention_btd_plain(ql[i:i + chunk], kl[i:i + chunk],
                                               vl[i:i + chunk], heads)
                     for i in range(0, B, chunk)])
    res = check("flash_attention_btd/bf16", flash_attention_btd(ql, kl, vl, heads), ref)
    del ref
    plain_ms = cuda_ms(lambda: [flash_attention_btd_plain(ql[i:i + chunk], kl[i:i + chunk],
                                                          vl[i:i + chunk], heads)
                                for i in range(0, B, chunk)], reps=2, warmup=1)
    qh, kh, vh = (t.reshape(B, T_AUDIO, heads, DH).transpose(1, 2).contiguous()
                  for t in (ql, kl, vl))
    flops = 4.0 * B * heads * T_AUDIO * T_AUDIO * DH
    nbytes = 4.0 * B * T_AUDIO * width * 2
    times = {"ms": cuda_ms(lambda: flash_attention_btd(ql, kl, vl, heads), reps=10),
             "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh), reps=10),
             "bound_ms": 1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BYTES),
             "bound_by": "operations" if flops / PEAK_BF16 > nbytes / PEAK_BYTES else "bytes"}
    times["bound_share"] = times["bound_ms"] / times["ms"]
    for n in (2, 4):
        cases[f"tp{n}"]["entry_ms"] = cuda_ms(
            lambda: flash_attention_btd_sharded(q, k, v, H_AUDIO, meshes[n]), reps=5)
    return {"name": "flash_attention_btd_sharded", "route": "cuda",
            "source": "whisper_tpu_torch/ops/flash_attention.py",
            "kernel_source": "whisper_tpu_torch/csrc/flash_attention_btd.cu",
            "replaces": "whisper_tpu/ops/flash_attention.py:199",
            "shape": f"one rank at tp 2: q,k,v,o ({B},{T_AUDIO},{width}) bf16, H={heads}",
            **res, "plain_ms": plain_ms, **times, "cases": cases,
            "bound_peaks": "989 TFLOP/s bf16, 3.35 TB/s",
            "library": "F.scaled_dot_product_attention on the rank's (B,H/tp,T,dh) heads"}


def _int8_cross_kv(dev, gen, b: int = B, heads: int = H_TEXT):
    """One layer of turbo's int8 cross-KV at batch ``b`` (the offline batch by
    default), quantized from seeded noise as ``quantize_cross_kv`` quantizes
    the encoder's."""
    from whisper_tpu_torch.models.model import quantize_cross_kv

    ck, cv = (torch.randn((1, b, heads, T_AUDIO, DH), generator=gen, device=dev)
              for _ in range(2))
    return tuple(t[0] for t in quantize_cross_kv((ck, cv)))


def _cross_bound(b: int = B, heads: int = H_TEXT) -> dict:
    """K2's, K4's and K5's bound: int8 K and V, fp32 k_s and v_s, bf16 q and
    output; the fp32 work of the function (two products of dh x T per head)."""
    n = b * heads
    nbytes = 2.0 * n * DH * T_AUDIO + 2 * 4.0 * n * DH + 2 * 2.0 * n * DH
    flops = 4.0 * n * DH * T_AUDIO
    return {"bound_ms": 1e3 * max(flops / PEAK_FP32, nbytes / PEAK_BYTES),
            "bound_by": "bytes" if nbytes / PEAK_BYTES > flops / PEAK_FP32 else "operations",
            "bound_peaks": "3.35 TB/s, 67 TFLOP/s fp32"}


# K2's batches: the offline batch, the serving slots, the long-form window
# batch (four clips), and the serving slots on a tp 2 rank (10 heads)
K2_SHAPES = {"offline": (B, H_TEXT), "serving": (8, H_TEXT), "longform": (N_LONGFORM, H_TEXT),
             "tp2_rank": (8, H_TEXT // 2)}


def kernel_k2(dev, gen) -> dict:
    """K2 at each of ``K2_SHAPES``: bf16 and fp32 queries against the plain
    version, the bf16 query timed beside its bound. Below the offline batch a
    layer's K and V fit the 50 MB L2, so the times cycle through enough
    copies to exceed it, as the decode step finds its layer cold. ``ms`` is
    CUDA events over a loop of calls; ``device_ms`` the kernel time alone
    (torch.profiler): at B 8 a loop of calls measures the host's rate."""
    from whisper_tpu_torch.models.model import attention_int8kv
    from whisper_tpu_torch.ops.decode_attention import (
        cross_attention_decode_fd, cross_attention_decode_fd_plain)

    cases = {}
    for path, (b, heads) in K2_SHAPES.items():
        kv = _int8_cross_kv(dev, gen, b, heads)
        case = {}
        for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q = torch.randn((b, heads, 1, DH), generator=gen, device=dev).to(dtype)
            got = cross_attention_decode_fd(q, *kv)
            res = check(f"cross_attention_decode_fd/{tag}", got,
                        cross_attention_decode_fd_plain(q, *kv))
            if tag == "fp32":
                # the plain fd semantics agree with the model's attention_int8kv
                res["vs_attention_int8kv"] = float((got - attention_int8kv(q, *kv)).abs().max())
                case["fp32_check"] = res
                continue
            case.update(res)
            full = sum(t.numel() * t.element_size() for t in kv)
            sets = [kv] + [tuple(t.clone() for t in kv)
                           for _ in range(max(1, math.ceil(2 * L2_BYTES / full)) - 1)]
            calls = {"ms": lambda: [cross_attention_decode_fd(q, *c) for c in sets],
                     "plain_ms": lambda: [cross_attention_decode_fd_plain(q, *c) for c in sets]}
            case.update({key: cuda_ms(call, 50 if key == "ms" else 10) / len(sets)
                         for key, call in calls.items()})
            case["device_ms"] = launch_ms(calls["ms"], 10, len(sets))
            case["plain_device_ms"] = device_ms(calls["plain_ms"], 5) / len(sets)
            del sets
        cases[path] = {"shape": f"q ({b},{heads},1,{DH}) bf16, k_q/v_q ({b},{heads},{DH},"
                                f"{T_AUDIO}) int8", **case, **_cross_bound(b, heads)}
        del kv
    main = cases["offline"]
    return {"name": "cross_attention_decode_fd", "route": "cuda",
            "source": "whisper_tpu_torch/csrc/cross_attention_decode.cu",
            "replaces": "whisper_tpu/ops/decode_attention.py:212",
            **{k: main[k] for k in ("shape", "max_abs_err", "rel_l2_err", "tol_abs", "ms",
                                    "plain_ms", "device_ms", "fp32_check", "bound_ms",
                                    "bound_by", "bound_peaks")},
            "cases": cases, **_kernel_build("cross_attention_decode"),
            "library_ms": None, "library": "none: no single PyTorch call computes it"}


def kernel_k6(dev, gen) -> dict:
    """K6 at the bhtd encoder's shape (turbo B64, split heads), held against
    its plain version and timed beside SDPA on the same tensors; an fp32
    check and Tq != Tk cases (bf16 and fp32) at a small batch."""
    from whisper_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v = (rand(B, H_AUDIO, T_AUDIO, DH) for _ in range(3))
    chunk = 8  # the plain version's fp32 scores are 1.4 GB per 8 rows

    def plain():
        return torch.cat([flash_attention_plain(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])
                          for i in range(0, B, chunk)])

    res = check("flash_attention/bf16", flash_attention(q, k, v), plain())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = _attention_times(B, cuda_ms(lambda: flash_attention(q, k, v), reps=10),
                             cuda_ms(lambda: sdpa(q, k, v), reps=10))
    plain_ms = cuda_ms(plain, reps=2, warmup=1)
    del q, k, v
    extra = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for tq, tk in ((T_AUDIO, T_AUDIO), (300, T_AUDIO), (T_AUDIO, 448), (1, T_AUDIO)):
            if dtype == torch.bfloat16 and tq == tk:
                continue
            qs, ks, vs = rand(2, H_AUDIO, tq, DH, dtype=dtype), *(
                rand(2, H_AUDIO, tk, DH, dtype=dtype) for _ in range(2))
            extra[f"{tag}/Tq{tq}/Tk{tk}"] = check(f"flash_attention/{tag}",
                                                 flash_attention(qs, ks, vs),
                                                 flash_attention_plain(qs, ks, vs))
    return {"name": "flash_attention", "route": "cuda",
            "source": "whisper_tpu_torch/csrc/flash_attention.cu",
            "kernel_source": "whisper_tpu_torch/csrc/flash_attention_sm90.cuh",
            "replaces": "whisper_tpu/ops/flash_attention.py:79",
            "shape": f"q,k,v,o ({B},{H_AUDIO},{T_AUDIO},{DH}) bf16",
            **res, "small_checks": extra, **times, "plain_ms": plain_ms,
            "bound_peaks": "989 TFLOP/s bf16, 3.35 TB/s",
            "library": "F.scaled_dot_product_attention (B,H,T,dh)"}


def _cross_variant(name: str, fn, plain, dev, gen, variants: dict) -> dict:
    """A decode cross-attention kernel at the offline shape, in each of its
    ``variants`` (keyword arguments): bf16 and fp32 queries against the plain
    version, the bf16 query timed. The first variant is the one the model
    runs. ``ms`` and ``plain_ms`` are kernel time on the card (torch.profiler):
    a loop timed by CUDA events (``events_ms``) measures the host's rate of
    calls at this size."""
    k_q, k_s, v_q, v_s = _int8_cross_kv(dev, gen)
    cases = {}
    for variant, kw in variants.items():
        case = {}
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            q = torch.randn((B, H_TEXT, 1, DH), generator=gen, device=dev).to(dtype)
            case[tag] = check(f"{name}/{tag}", fn(q, k_q, k_s, v_q, v_s, **kw),
                              plain(q, k_q, k_s, v_q, v_s, **kw))
        calls = {"ms": lambda: fn(q, k_q, k_s, v_q, v_s, **kw),
                 "plain_ms": lambda: plain(q, k_q, k_s, v_q, v_s, **kw)}
        case.update({key: device_ms(call, 20) for key, call in calls.items()})
        case["events_ms"] = {key: cuda_ms(call, 50) for key, call in calls.items()}
        cases[variant] = case
    main = cases[next(iter(variants))]
    return {"max_abs_err": main["bf16"]["max_abs_err"], "tol_abs": main["bf16"]["tol_abs"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "cases": cases,
            "shape": f"q ({B},{H_TEXT},1,{DH}) bf16, k_q/v_q ({B},{H_TEXT},{DH},{T_AUDIO}) int8",
            **_cross_bound(), "library_ms": None,
            "library": "none: no single PyTorch call computes it"}


def kernel_k4(dev, gen) -> dict:
    """K4 in both forms: ``use_vpu=False`` (the model's) and ``True``."""
    from whisper_tpu_torch.ops.decode_attention import (
        cross_attention_decode, cross_attention_decode_plain)

    return {"name": "cross_attention_decode", "route": "cuda",
            "source": "whisper_tpu_torch/csrc/cross_attention_decode_legacy.cu",
            "replaces": "whisper_tpu/ops/decode_attention.py:339",
            **_cross_variant("cross_attention_decode", cross_attention_decode,
                             cross_attention_decode_plain, dev, gen,
                             {"use_vpu=False": {"use_vpu": False},
                              "use_vpu=True": {"use_vpu": True}})}


def _dense_times(fn, q, kv) -> dict:
    """K5's kernel time and its plain version's per call on the card
    (torch.profiler), cycling through enough copies of K and V to exceed the
    L2 where one layer's fit it, as the decode step finds its layer cold;
    ``events_ms`` CUDA events around the same loop."""
    from whisper_tpu_torch.ops.decode_attention import cross_attention_decode_dense_plain

    full = sum(t.numel() * t.element_size() for t in kv)
    sets = [kv] + [tuple(t.clone() for t in kv)
                   for _ in range(max(1, math.ceil(2 * L2_BYTES / full)) - 1)]
    calls = {"ms": lambda: [fn(q, *c) for c in sets],
             "plain_ms": lambda: [cross_attention_decode_dense_plain(q, *c) for c in sets]}
    out = {key: device_ms(call, 20 if key == "ms" else 5) / len(sets)
           for key, call in calls.items()}
    out["events_ms"] = cuda_ms(calls["ms"], 20) / len(sets)
    return out


# K5's batches: the offline batch and the flagged serving burst's slots
K5_SHAPES = {"offline": B, "serving": 8}


def kernel_k5(dev, gen) -> dict:
    """K5 at each of ``K5_SHAPES``: bf16 and fp32 queries against the plain
    version, the bf16 query timed beside its bound (``_dense_times``), and
    its dense form's redundant multiply-adds (H-fold: 9.8e9 operations at
    B64) over the bf16 tensor-core peak."""
    from whisper_tpu_torch.ops.decode_attention import (
        cross_attention_decode_dense, cross_attention_decode_dense_plain)

    cases = {}
    for path, b in K5_SHAPES.items():
        kv = _int8_cross_kv(dev, gen, b)
        case = {}
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            q = torch.randn((b, H_TEXT, 1, DH), generator=gen, device=dev).to(dtype)
            res = check(f"cross_attention_decode_dense/{tag}",
                        cross_attention_decode_dense(q, *kv),
                        cross_attention_decode_dense_plain(q, *kv))
            if tag == "fp32":
                case["fp32_check"] = res
            else:
                case.update(res)
        case.update(_dense_times(cross_attention_decode_dense, q, kv))
        dense_ops = 2 * 2.0 * b * H_TEXT * (H_TEXT * DH) * T_AUDIO
        cases[path] = {"shape": f"q ({b},{H_TEXT},1,{DH}) bf16, k_q/v_q ({b},{H_TEXT},{DH},"
                                f"{T_AUDIO}) int8", **case, **_cross_bound(b),
                       "dense_ops": dense_ops, "dense_ops_ms": 1e3 * dense_ops / PEAK_BF16}
        del kv
    main = cases["offline"]
    return {"name": "cross_attention_decode_dense", "route": "cuda",
            "source": "whisper_tpu_torch/csrc/cross_attention_decode_dense.cu",
            "replaces": "whisper_tpu/ops/decode_attention.py:295",
            **{k: main[k] for k in ("shape", "max_abs_err", "rel_l2_err", "tol_abs", "ms",
                                    "plain_ms", "fp32_check", "bound_ms", "bound_by",
                                    "bound_peaks")},
            "cases": cases, **_kernel_build("cross_attention_decode_dense"),
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
        r, g = rng, gen
        if path in K3_OWN_SEED:
            r = np.random.default_rng(K3_OWN_SEED[path])
            g = torch.Generator(device=dev).manual_seed(K3_OWN_SEED[path])
        offsets = torch.from_numpy(r.integers(lo, hi + 1, b)).to(dev)
        pads = None if max_pad is None else torch.from_numpy(r.integers(0, max_pad + 1, b)).to(dev)
        first = 0 if pads is None else pads
        n_vis = float((offsets.clamp(max=T - 1) + 1 - first).sum()) * H_TEXT  # visible keys
        q = torch.randn((b, H_TEXT, 1, DH), generator=g, device=dev)
        k = torch.randn((b, H_TEXT, T, DH), generator=g, device=dev)
        v = torch.rand((b, H_TEXT, T, DH), generator=g, device=dev) * 2 - 1  # |V| <= 1
        kv_q, kv_s = (t.contiguous() for t in quantize_kv_heads(k, v))
        layouts = {
            "int8": (self_attention_decode_int8, self_attention_decode_int8_plain,
                     lambda dt: (kv_q, kv_s), 2.0 * DH + 2 * 4.0),
            "float": (self_attention_decode, self_attention_decode_plain,
                      lambda dt: (k.transpose(-1, -2).contiguous().to(dt),
                                  v.transpose(-1, -2).contiguous().to(dt)), 2.0 * DH * 2),
        }
        for layout, (fn, plain, cache, bytes_per_key) in layouts.items():
            if path == "detect" and layout == "int8":
                continue
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
            times = {key: launch_ms(call, 10, len(sets)) if key == "ms" else
                     device_ms(call, reps=10) / len(sets) for key, call in calls.items()}
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
            "bound_peaks": "3.35 TB/s, 67 TFLOP/s fp32", "cases": out,
            **_kernel_build("self_attention_decode")}


def _log10_mel_f64(x: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The raw log10 mel of reflect-padded audio ``x`` computed in float64
    (``torch.fft.rfft``): the yardstick beside which K7's and its plain
    version's fp32 errors are reported (``kernel_vs_f64``, ``plain_vs_f64``)."""
    from whisper_tpu_torch.ops.mel import _frame, mel_filterbank

    hann = torch.hann_window(400, periodic=True, dtype=torch.float64, device=x.device)
    fb = torch.from_numpy(mel_filterbank(n_mels, 400)).to(x.device, torch.float64)
    out = []
    for i in range(0, x.shape[0], 16):  # 16 rows of frames in float64: 0.6 GB
        spec = torch.fft.rfft(_frame(x[i:i + 16].double(), 3000, 400, 160) * hann, dim=-1)
        out.append(torch.log10(torch.clamp(fb @ (spec.abs() ** 2).transpose(1, 2), min=1e-10)))
    return torch.cat(out)


def kernel_k7(dev, gen) -> dict:
    """K7 at the offline path's shape (B 64, turbo's 128 mels), the serving
    admission batch (B 8, 128 mels) and tiny's (B 8, 80 mels), on
    reflect-padded seeded noise. The bound counts the operations the
    function needs, not those of the TPU kernel's dense DFT matmul: per
    frame the Hann window, a real FFT of 400 points at the usual 2.5 n log2
    n, the power of 201 bins, the mel projection over each filter's nonzero
    bins and the log. The dense algorithm's bound is kept beside it as
    ``dft_matmul_bound_ms``. ``stft_ms`` times ``torch.stft``'s power
    spectrum of the same audio (cuFFT): a part of K7's function only, so it
    is no ``library_ms``."""
    from whisper_tpu_torch.ops.log10_mel import log10_mel, log10_mel_plain
    from whisper_tpu_torch.ops.mel import mel_filterbank

    out = {}
    for b, n_mels in ((B, 128), (8, 128), (8, 80)):
        audio = torch.randn((b, 480000), generator=gen, device=dev) * 0.1
        x = torch.nn.functional.pad(audio[:, None], (200, 200), mode="reflect")[:, 0].contiguous()
        got = log10_mel(x, n_mels, 400, 160, 3000)
        plain = log10_mel_plain(x, n_mels, 400, 160, 3000)
        exact = _log10_mel_f64(x, n_mels)
        f64 = check("log10_mel/f64", got, exact)
        res = check("log10_mel", got, plain, kernel_vs_f64=f64["max_abs_err"],
                    plain_vs_f64=float((plain.double() - exact).abs().max()), f64_check=f64)
        del exact
        nnz = int(np.count_nonzero(mel_filterbank(n_mels, 400)))
        flops = b * 3000 * (400 + 2.5 * 400 * math.log2(400) + 3 * 201 + 2 * nnz + 2 * n_mels)
        dft_flops = 2.0 * b * 3000 * 400 * 402 + 2.0 * b * 3000 * 201 * n_mels
        nbytes = 4.0 * x.numel() + 4.0 * b * n_mels * 3000
        window = torch.hann_window(400, periodic=True, device=dev)

        def stft_power():
            s = torch.stft(audio, 400, 160, window=window, center=True, pad_mode="reflect",
                           return_complex=True)
            return s.real * s.real + s.imag * s.imag

        out[f"B{b}/{n_mels}"] = {
            **res, "ms": cuda_ms(lambda: log10_mel(x, n_mels, 400, 160, 3000), reps=20),
            "device_ms": device_ms(lambda: log10_mel(x, n_mels, 400, 160, 3000), reps=10),
            "plain_ms": cuda_ms(lambda: log10_mel_plain(x, n_mels, 400, 160, 3000), reps=5),
            "stft_ms": cuda_ms(stft_power, reps=20),
            "bound_ms": 1e3 * max(flops / PEAK_FP32, nbytes / PEAK_BYTES),
            "bound_by": "operations" if flops / PEAK_FP32 > nbytes / PEAK_BYTES else "bytes",
            "ops_ms": 1e3 * flops / PEAK_FP32, "bytes_ms": 1e3 * nbytes / PEAK_BYTES,
            "dft_matmul_bound_ms": 1e3 * max(dft_flops / PEAK_FP32, nbytes / PEAK_BYTES)}
    main = out[f"B{B}/128"]
    return {"name": "log10_mel", "route": "cuda", "source": "whisper_tpu_torch/csrc/log10_mel.cu",
            "replaces": "whisper_tpu/ops/mel_pallas.py:75",
            "shape": f"audio ({B}, 480400) fp32 -> ({B}, 128, 3000) fp32",
            **{k: main[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "stft_ms",
                                    "bound_ms", "bound_by", "dft_matmul_bound_ms")},
            "bound_peaks": "67 TFLOP/s fp32, 3.35 TB/s", "cases": out,
            **_kernel_build("log10_mel"),
            "library_ms": None, "library": "none: no single PyTorch call computes it "
            "(stft_ms: torch.stft's power spectrum alone)"}


def _k8_bounds(M: int, K: int, N: int) -> dict:
    """K8's bounds at (M, K, N): operations at the int8 peak against the
    bytes of A and B in and C out, C as int32 (``int32``) or as bf16 with
    the fp32 row and channel scales and the bf16 bias in (``scaled``)."""
    ops_ms = 1e3 * 2.0 * M * K * N / PEAK_INT8
    out = {}
    for mode, nbytes in (("int32", M * K + K * N + 4.0 * M * N),
                         ("scaled", M * K + K * N + 2.0 * M * N + 4.0 * M + 6.0 * N)):
        bytes_ms = 1e3 * nbytes / PEAK_BYTES
        out[mode] = {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                     "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}
    return out


def kernel_k8(dev, gen) -> dict:
    """K8 in both epilogues at every turbo encoder shape: the int32 product
    exact against its plain version, and the scaled epilogue (bf16 out with
    a bias, the path's; fp32 out without one) bit-equal to the PyTorch
    epilogue of the plain product, at the offline batch's M, the admission
    sizes and the tp 2 rank shapes. Timed at the offline batch's M: the
    scaled mode (the path's: ``ms``, ``plain_ms``, ``bound_ms``, bf16 out)
    and the int32 mode (``int32_ms``, ``int32_bound_ms``) beside
    torch._int_mm, which computes the int32 product alone, with a
    column-major weight (the layout K8 reads; ``library_ms``) and with the
    (K, N) row-major one (``library_rowmajor_ms``)."""
    from whisper_tpu_torch.ops.int8_gemm import (
        int8_gemm, int8_gemm_plain, int8_gemm_scaled, int8_gemm_scaled_plain)

    def rand8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def check_both(a, b, b_k):
        M, N = a.shape[0], b.shape[1]
        if not torch.equal(int8_gemm(a, b_k), int8_gemm_plain(a, b)):
            raise AssertionError(f"int8_gemm differs from its plain version at {tuple(a.shape)} "
                                 f"@ {tuple(b.shape)}")
        sx = torch.rand((M, 1), generator=gen, device=dev) * 0.05 + 1e-4
        ws = torch.rand((1, N), generator=gen, device=dev) * 0.01 + 1e-5
        bias = torch.randn(N, generator=gen, device=dev) * 4
        for dtype, bb in ((torch.bfloat16, bias.bfloat16()), (torch.float32, None)):
            if not torch.equal(int8_gemm_scaled(a, b_k, sx, ws, bb, dtype),
                               int8_gemm_scaled_plain(a, b, sx, ws, bb, dtype)):
                raise AssertionError(f"int8_gemm_scaled ({dtype}) differs from the PyTorch "
                                     f"epilogue at {tuple(a.shape)} @ {tuple(b.shape)}")
        torch.cuda.synchronize()
        return sx, ws, bias.bfloat16()

    keys = ("ms", "plain_ms", "bound_ms", "int32_ms", "int32_plain_ms", "int32_bound_ms",
            "library_ms", "library_rowmajor_ms", "ops_ms", "bytes_ms")
    cases, layer, tp_checked = {}, {key: 0.0 for key in keys}, []
    for K, N in K8_TP_KN:
        b = rand8(K, N)
        for M in K8_TP_M:
            check_both(rand8(M, K), b, b.t().contiguous().t())
            tp_checked.append((M, K, N))
    for K, N, per_layer in K8_KN:
        b = rand8(K, N)
        b_k = b.t().contiguous().t()  # K-major storage, as QTensor.k_major lays it out
        for M in K8_M:
            a = rand8(M, K)
            sx, ws, bias = check_both(a, b, b_k)
            if M != T_AUDIO * B:
                continue
            bounds = _k8_bounds(M, K, N)
            case = {
                "ms": cuda_ms(lambda: int8_gemm_scaled(a, b_k, sx, ws, bias), reps=10),
                "plain_ms": cuda_ms(lambda: int8_gemm_scaled_plain(a, b, sx, ws, bias,
                                                                   torch.bfloat16),
                                    reps=2, warmup=1),
                "int32_ms": cuda_ms(lambda: int8_gemm(a, b_k), reps=10),
                "int32_plain_ms": cuda_ms(lambda: int8_gemm_plain(a, b), reps=2, warmup=1),
                "library_ms": cuda_ms(lambda: torch._int_mm(a, b_k), reps=10),
                "library_rowmajor_ms": cuda_ms(lambda: torch._int_mm(a, b), reps=10),
                "bound_ms": bounds["scaled"]["bound_ms"], "bound_by": bounds["scaled"]["bound_by"],
                "int32_bound_ms": bounds["int32"]["bound_ms"],
                "int32_bound_by": bounds["int32"]["bound_by"],
                "ops_ms": bounds["scaled"]["ops_ms"], "bytes_ms": bounds["scaled"]["bytes_ms"],
                "int32_bytes_ms": bounds["int32"]["bytes_ms"]}
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
                     f"encoder layer's {n} GEMMs; ms/plain_ms/bound_ms: the scaled epilogue, "
                     f"bf16 out with a bias (the path's); int32_*: the int32 product",
            "max_abs_err": 0.0, "exact_at_M": list(K8_M), "exact_at_tp2_shapes": tp_checked,
            **per_launch,
            "bound_by": "operations" if layer["ops_ms"] > layer["bytes_ms"] else "bytes",
            "int32_share_of_library": per_launch["library_ms"] / per_launch["int32_ms"],
            "bound_share": per_launch["bound_ms"] / per_launch["ms"],
            "int32_bound_share": per_launch["int32_bound_ms"] / per_launch["int32_ms"],
            "per_batch_ms": {k: L_AUDIO * v for k, v in layer.items()},
            "bound_peaks": "1,979 TOP/s int8, 3.35 TB/s", "cases": cases,
            "library": "torch._int_mm(a, b) with b column-major: the int32 product alone (compare "
                       "with int32_ms; no PyTorch call computes the scaled epilogue); "
                       "library_rowmajor_ms with b (K, N) row-major, cuBLAS's path before K8"}


def _tie_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (M, K) rewritten in place so that x / sx lands exactly
    on .5 ties (amax 127: sx = 1, half-integers; amax 254: sx = 2, odd
    integers), and every 97th row all zero. Returns the rows with ties."""
    K = x.shape[1]
    half = torch.arange(K, device=x.device, dtype=torch.float32) % 64 - 31.5
    x[::97] = 0.0
    x[1::89], x[2::89] = half, 2 * half
    x[1::89, 0], x[2::89, 0] = 127.0, 254.0
    return torch.cat([torch.arange(1, x.shape[0], 89), torch.arange(2, x.shape[0], 89)])


def kernel_k8q(dev, gen) -> dict:
    """K8q at the offline batch's rows (M = 96,000) of both widths the
    encoder quantizes (D for q/k/v, o and w1; 4 D for w2), bf16, on seeded
    noise with rows built to land on .5 ties after the division and all-zero
    rows: bit-equal to its plain version (int8 rows and fp32 scales), timed
    beside it; fp32 rows and the given-scale entry checked at an admission
    size. ``ms`` is the mean per launch of a layer's four (three at D, one
    at 4 D)."""
    from whisper_tpu_torch.ops.quantize_rows import quantize_rows, quantize_rows_plain

    M, cases = T_AUDIO * B, {}
    for K in K8Q_K:
        x = torch.randn((M, K), generator=gen, device=dev) * 2
        tie_rows = _tie_rows(x)
        x = x.bfloat16()
        q, sx = quantize_rows(x)
        want_q, want_sx = quantize_rows_plain(x)
        if not (torch.equal(q, want_q) and torch.equal(sx, want_sx)):
            raise AssertionError(f"quantize_rows differs from its plain version at ({M}, {K})")
        # the built ties are there: a .5 quotient, rounded to even
        xt = x[tie_rows].float() / sx[tie_rows]
        ties = int(((xt - xt.floor()) == 0.5).sum())
        if ties == 0 or not torch.equal(q[tie_rows].float(), torch.round(xt)):
            raise AssertionError("the tie rows did not round half to even")
        nbytes = 3.0 * M * K + 4.0 * M
        cases[f"M{M}/K{K}"] = {
            "ms": cuda_ms(lambda: quantize_rows(x), reps=20),
            "plain_ms": cuda_ms(lambda: quantize_rows_plain(x), reps=3, warmup=1),
            "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
            "ties": ties, "zero_rows": int((x.abs().amax(-1) == 0).sum())}
        cases[f"M{M}/K{K}"]["bound_share"] = (cases[f"M{M}/K{K}"]["bound_ms"]
                                              / cases[f"M{M}/K{K}"]["ms"])
        del x, q, want_q
        torch.cuda.empty_cache()
    x = torch.randn((4500, D_AUDIO), generator=gen, device=dev)
    _tie_rows(x)
    given = torch.rand((4500, 1), generator=gen, device=dev) * 0.05 + 1e-3
    for args in ((x,), (x, given), (x.bfloat16(), given)):
        got, want = quantize_rows(*args), quantize_rows_plain(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"quantize_rows differs from its plain version: {len(args)} "
                                 f"arguments, {args[0].dtype}")
    per_layer = {K: n for K, n in zip(K8Q_K, (3, 1))}
    mean = {key: sum(n * cases[f"M{M}/K{K}"][key] for K, n in per_layer.items()) / 4
            for key in ("ms", "plain_ms", "bound_ms")}
    return {"name": "quantize_rows", "route": "cuda",
            "source": "whisper_tpu_torch/csrc/quantize_rows.cu",
            "replaces": "whisper_tpu/models/model.py:103",
            "replaces_note": "the activation quantization of _linear_a8 (lines 103-105), an XLA "
                             "fusion: no pallas_call",
            "shape": f"x ({M}, K) bf16 -> int8 (M, K) + fp32 (M, 1), K in {list(K8Q_K)}; times "
                     f"are the mean per launch of a turbo layer's four (3 at K {D_AUDIO}, 1 at "
                     f"{4 * D_AUDIO})",
            "max_abs_err": 0.0, **mean, "bound_by": "bytes",
            "bound_share": mean["bound_ms"] / mean["ms"], "cases": cases,
            "bound_peaks": "3.35 TB/s", "library_ms": None,
            "library": "none: no single PyTorch call computes it"}


def w8a8_chain(dev, gen) -> dict:
    """A turbo layer's six W8A8 linears at the offline batch (M = 96,000,
    bf16, the biases of q, v, o, w1 and w2; k has none), two ways on the
    same inputs and weights:
    - ``before``: the PyTorch composition the port ran until K8's epilogue
      and K8q: activations in the conv stem's transposed layout; per linear
      an fp32 cast, abs, row max, clamp, divide, round, clamp and int8
      cast, a contiguous copy of the flattened rows, K8's int32 product,
      then the int32 -> fp32 cast, two products, the cast and the bias add;
      q, k and v each quantize the same input;
    - ``after``: contiguous activations, one K8q per input (q, k and v
      share one) and K8's scaled epilogue: ten launches, no other kernel.
    Both must give the same bits. Times by CUDA events (``*_ms``) and as
    kernel time on the card (``*_device_ms``, torch.profiler), kernel
    launches counted by the profiler (``*_launches``; a window of the
    profiler can miss a launch late in a long run). ``after`` must launch
    ten kernels by the wrappers' counters and only K8q and K8 by the
    profiler's names."""
    from whisper_tpu_torch.ops.int8_gemm import int8_gemm, int8_gemm_scaled, scale_epilogue
    from whisper_tpu_torch.ops.quantize_rows import quantize_rows, row_scale

    M = T_AUDIO * B
    D, F = D_AUDIO, 4 * D_AUDIO
    weights = {}
    for name, (K, N, has_bias) in {"q": (D, D, True), "k": (D, D, False), "v": (D, D, True),
                                   "o": (D, D, True), "w1": (D, F, True),
                                   "w2": (F, D, True)}.items():
        wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8).t()
        ws = torch.rand((1, N), generator=gen, device=dev) * 1e-3 + 1e-5
        bias = torch.randn(N, generator=gen, device=dev).bfloat16() if has_bias else None
        weights[name] = (wq, ws, bias)
    acts = {name: torch.randn((M, K), generator=gen, device=dev).bfloat16()
            for name, K in (("h", D), ("attn", D), ("h2", D), ("g", F))}
    # the conv stem's transposed layout: (B, T, K) viewed from a (B, K, T) buffer
    strided = {name: x.view(B, T_AUDIO, -1).transpose(1, 2).contiguous().transpose(1, 2)
               for name, x in acts.items()}
    uses = (("h", "q"), ("h", "k"), ("h", "v"), ("attn", "o"), ("h2", "w1"), ("g", "w2"))

    def before():
        out = []
        for act, name in uses:
            wq, ws, bias = weights[name]
            x = strided[act]
            xf = x.to(torch.float32)
            sx = row_scale(xf.abs().amax(dim=-1, keepdim=True))
            x8 = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
            del xf
            y = int8_gemm(x8.reshape(-1, x8.shape[-1]).contiguous(), wq)
            out.append(scale_epilogue(y.reshape(B, T_AUDIO, -1), sx, ws, bias, torch.bfloat16))
        return out

    def after():
        out, quantized = [], {}
        for act, name in uses:
            wq, ws, bias = weights[name]
            if act not in quantized:
                quantized = {act: quantize_rows(acts[act])}  # q, k, v share one
            x8, sx = quantized[act]
            out.append(int8_gemm_scaled(x8, wq, sx, ws, bias))
        return out

    equal = all(torch.equal(a.reshape(M, -1), b) for a, b in zip(before(), after()))
    if not equal:
        raise AssertionError("the fused W8A8 chain differs from the PyTorch composition")
    rec = {"phase": "w8a8_chain", "M": M, "linears": [name for _, name in uses],
           "bit_equal": equal}
    for tag, fn in (("before", before), ("after", after)):
        split = device_kernels(fn, fallback=False)  # its kernels' names are checked
        rec[f"{tag}_ms"] = cuda_ms(fn, reps=3, warmup=1)
        rec[f"{tag}_device_ms"] = sum(ms for ms, _ in split.values())
        rec[f"{tag}_launches"] = round(sum(n for _, n in split.values()))
        rec[f"{tag}_kernels"] = {name[:90]: [ms, round(n)] for name, (ms, n) in
                                 sorted(split.items(), key=lambda kv: -kv[1][0])[:8]}
        if tag == "after":
            kinds = set(split)
    counted = quantize_rows.launches + int8_gemm.launches
    after()
    torch.cuda.synchronize()
    rec["after_counted_launches"] = quantize_rows.launches + int8_gemm.launches - counted
    if rec["after_counted_launches"] != 10 or not all(
            "int8_gemm_sm90" in n or "quantize_rows_kernel" in n for n in kinds):
        raise AssertionError(f"the fused chain ran other kernels or another count than 10 "
                             f"({rec['after_counted_launches']}): {sorted(kinds)}")
    # what the chain must move at least: each input read once (the shared
    # h once), int8 rows, scales and weights, each output written once
    nbytes = sum(2.0 * x.numel() for x in acts.values()) + 2.0 * M * (5 * D + F)
    ops = sum(2.0 * M * w.shape[0] * w.shape[1] for w, _, _ in weights.values())
    rec["bound_ms"] = 1e3 * max(nbytes / PEAK_BYTES, ops / PEAK_INT8)
    rec["per_batch_before_ms"] = L_AUDIO * rec["before_ms"]
    rec["per_batch_after_ms"] = L_AUDIO * rec["after_ms"]
    return rec


def w8a8_card_vs_cpu(dev) -> dict:
    """The W8A8 activation quantization at turbo's width, on the card
    against the CPU: how many row scales ``amax / 127.0`` (a Python-scalar
    divisor, which CUDA turns into a product with the reciprocal) puts off
    the CPU's quotient and how many int8 activations flip as a result; and
    the port's ``_linear_a8`` (K8q, IEEE division, then K8's scaled
    epilogue) against the CPU's, which must be equal bit for bit."""
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


def _function_name(mangled: str) -> str:
    """The innermost name of a mangled C++ function (``_ZN7fa_sm9011attn_kernelE...``
    -> ``attn_kernel``)."""
    names, i = [], mangled.find("_Z") + 2
    if mangled[i:i + 1] == "N":
        i += 1
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    return names[-1] if names else mangled


# kernels whose Hopper body must hold an instruction of its design, and
# none of some others: library -> (function, instructions it must hold,
# instructions it must not hold). K1, K6 and K8: wgmma (HGMMA on bf16,
# IGMMA on int8) and TMA loads (UTMALDG); K2: 1-D bulk copies (UBLKCP) and
# no I2F conversion; K3: cp.async (LDGSTS) and no I2F; K5: bulk copies,
# mma.sync (HMMA) and no I2F
SM90_KERNELS = {"flash_attention_btd": ("attn_kernel", ("HGMMA", "UTMALDG"), ()),
                "flash_attention": ("attn_kernel", ("HGMMA", "UTMALDG"), ()),
                "int8_gemm": ("int8_gemm_sm90", ("IGMMA", "UTMALDG"), ()),
                "cross_attention_decode": ("fd_kernel", ("UBLKCP",), ("I2F",)),
                "self_attention_decode": ("self_decode_kernel", ("LDGSTS",), ("I2F",)),
                "cross_attention_decode_dense": ("dense_kernel", ("UBLKCP", "HMMA"), ("I2F",))}
# I2F counts the int -> float conversions; I2F.RP, the reciprocal estimate
# of an integer division by a variable (I2F.RP, I2F.U32.RP, ...), apart
SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "UTMALDG", "UBLKCP", "LDGSTS", "I2F", "I2F.RP", "I2FP",
            "PRMT")
WGMMA_KERNELS = ("flash_attention_btd", "flash_attention", "int8_gemm")


def serialized_wgmma(ptxas: dict) -> dict:
    """The ptxas warnings of the wgmma kernels' libraries that say their
    wgmma were serialized (C7513, C7515): none may appear."""
    return {name: [ln for ln in lines if "C7513" in ln or "C7515" in ln]
            for name, lines in ptxas.items() if name in WGMMA_KERNELS}


def ptxas_report(name: str) -> list:
    """The register, shared-memory, spill and warning lines of ptxas's
    report (``-Xptxas -v``) from the last build of library ``name``."""
    from whisper_tpu_torch.ops import _build

    return [ln.strip() for ln in _build.build_log(name).splitlines()
            if "registers" in ln or "spill" in ln or "warning" in ln]


def spills(lines) -> list:
    """The ptxas lines that report spill stores or loads."""
    return [ln for ln in lines
            if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]


def _sass(name: str) -> dict:
    """``SASS_OPS`` counts per function (template instances summed) of the
    built library ``name`` (``cuobjdump -sass``)."""
    from pathlib import Path

    from whisper_tpu_torch.ops import _build

    tool = str(Path(_build.nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        counts = out.setdefault(_function_name(part.split("\n", 1)[0].strip()),
                                dict.fromkeys(SASS_OPS, 0))
        for op in SASS_OPS:
            if op.startswith("I2F"):
                forms = re.findall(r"\bI2F(?!\w)(?:\.\w+)*", part)
                counts[op] += sum(f.endswith(".RP") == (op == "I2F.RP") for f in forms)
            else:
                counts[op] += len(re.findall(rf"\b{op}\b", part))
    return out


def _kernel_build(name: str) -> dict:
    """What a kernel phase reports of its library's build: ptxas's lines
    and the SASS counts."""
    return {"ptxas": ptxas_report(name), "sass": _sass(name)}


def sass_counts(names) -> dict:
    """``SASS_OPS`` per function of each built library, so the run itself
    shows what the binaries hold; fails if a kernel of ``SM90_KERNELS``
    lacks an instruction it must hold or holds one it must not."""
    out = {name: _sass(name) for name in names}
    for name, (fn, need, banned) in SM90_KERNELS.items():
        counts = out[name].get(fn, {})
        if not all(counts.get(op) for op in need) or any(counts.get(op) for op in banned):
            raise AssertionError(f"{name}: {fn} must hold {need} and no {banned}: {out[name]}")
    return out


def _launches(counters) -> dict:
    return {fn.__name__: fn.launches for fn in counters}


# the kernel each selection runs (models/model.py), by the wrapper's name
ENCODER_KERNEL = {"btd": "flash_attention_btd", "bhtd": "flash_attention"}
DECODE_KERNEL = {"fd": "cross_attention_decode_fd", "legacy": "cross_attention_decode",
                 "dense": "cross_attention_decode_dense"}


def _expect(path: str, launches: dict, cfg, encodes: int, steps: int,
            encoder_attention: str = "btd", cross_decode: str = "fd", tp: int = 1,
            detects: int = 0, beam_steps: int = 0, draft=None) -> None:
    """Exact launch counts of a W8A8 + int8 cross- and self-KV path that ran
    ``encodes`` encoder passes (one log-mel each), ``steps`` decoder steps,
    ``detects`` language-detection steps and ``beam_steps`` beam steps on
    ``tp`` ranks: the selected encoder and decode kernels once a layer on
    every rank, the kernels of the other selections not at all; with tp > 1
    every K1 launch is also the sharded entry's. A detection step is one S=1
    decoder step over a float self-KV cache: the decode kernel and the
    float K3 once a layer. A beam step runs the int8 K3 once a layer and no
    decode kernel (its cross-attention is the folded plain product, as the
    JAX package's einsum under ``beam_k``). ``draft`` = (the draft's
    config, its 1-wide steps) adds a speculative draft: an encode of its
    own with each of the target's (its log-mel only where its mel bank
    differs from ``cfg``'s) and its steps, each the decode kernel and the
    int8 K3 once a draft layer; the verify windows and both prefills are
    plain products."""
    dcfg, dsteps = draft if draft else (None, 0)
    d_layers = dcfg.n_audio_layer * encodes if dcfg else 0  # the draft's encoder layers
    d_step_layers = dcfg.n_text_layer * dsteps if dcfg else 0
    enc_layers = cfg.n_audio_layer * encodes + d_layers
    want = {"log10_mel": encodes * (1 + int(bool(dcfg) and dcfg.n_mels != cfg.n_mels)),
            "int8_gemm": 6 * enc_layers * tp,  # q, k, v, o, mlp1, mlp2
            "quantize_rows": 4 * enc_layers * tp,  # qkv once, o, mlp1, mlp2
            "self_attention_decode_int8": (cfg.n_text_layer * (steps + beam_steps)
                                           + d_step_layers) * tp,
            "self_attention_decode": cfg.n_text_layer * detects * tp,
            "flash_attention_btd_sharded": (enc_layers * tp
                                            if tp > 1 and encoder_attention == "btd" else 0)}
    for sel, name in ENCODER_KERNEL.items():
        want[name] = enc_layers * tp if sel == encoder_attention else 0
    for sel, name in DECODE_KERNEL.items():
        want[name] = ((cfg.n_text_layer * (steps + detects) + d_step_layers) * tp
                      if sel == cross_decode else 0)
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{path}: {name} ran {launches[name]} times, expected {n}")


def offline(counters, encoder_attention: str = "btd", cross_decode: str = "fd"):
    """turbo B64 / 64 tokens / kvq+skvq+w8a8 / bf16 through
    ``transcribe_batch`` under the given kernel selections: built, warmed,
    run once with the counts at 0 and checked. Returns (record, pipeline,
    clips)."""
    from whisper_tpu_torch.config import N_SAMPLES
    from whisper_tpu_torch.decode import graph_stats
    from whisper_tpu_torch.pipeline import WhisperPipeline

    t0 = time.perf_counter()
    pipe = WhisperPipeline(model="turbo", device="cuda", compute_dtype="bfloat16",
                           quantize=True, w8a8=True, kv_quant=True, self_kv_quant=True,
                           max_tokens=N_TOKENS, seed=0, encoder_attention=encoder_attention,
                           cross_decode=cross_decode)
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
    _expect(f"offline ({encoder_attention}, {cross_decode})", launches, cfg, 1,
            dec.device_steps, encoder_attention, cross_decode)
    audio_s = B * N_SAMPLES / 16000
    return {"model": "turbo", "batch": B, "max_tokens": N_TOKENS,
            "dtype": "bfloat16", "quant": "int8 weights + w8a8 encoder + kvq + skvq",
            "encoder_attention": encoder_attention, "cross_decode": cross_decode,
            "init_s": init_s, "warm_s": warm_s, "wall_s": wall, "rtf": wall / audio_s,
            "audio_s_per_s": audio_s / wall, "generated": (lens - P).tolist(),
            "decode_steps": dec.steps, "device_steps": dec.device_steps,
            "host_syncs": dec.host_syncs, "decode_graphs": graph_stats(pipe.model),
            "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}, pipe, clips


def end_to_end(counters):
    """The main path under the default selections, and its breakdown."""
    rec, pipe, clips = offline(counters)
    return {"phase": "end_to_end", **rec}, breakdown(pipe, clips, rec["device_steps"])


def variants(counters) -> list:
    """The offline path under the JAX package's other kernel selections:
    split-head encoder attention with the head-batched (legacy) and with the
    dense decode cross-attention."""
    out = []
    for cross_decode in ("legacy", "dense"):
        rec, pipe, _ = offline(counters, "bhtd", cross_decode)
        out.append({"phase": "variant", **rec})
        del pipe
        torch.cuda.empty_cache()
    return out


def _host_launches(prof, within: str | None = None) -> dict:
    """The CUDA API calls that launch work (``cudaLaunchKernel``,
    ``cudaLaunchKernelExC``, ``cudaGraphLaunch``, ``cuLaunchKernel``, ...)
    the host made in a profile, by name, with ``within`` only those inside
    the host span of that range."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in events if e.name == within]
    out = {}
    for e in events:
        if not (e.name.startswith("cu") and "Launch" in e.name):
            continue
        if within is None or any(lo <= e.time_range.start <= hi for lo, hi in spans):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def _greedy_args(pipe, clips, entry: str = "greedy_decode_kv") -> tuple:
    """(model, cross-KV, prompt, dtype, keywords) of the decode that
    ``pipe.transcribe_batch(clips)`` runs through the pipeline's ``entry``
    (``greedy_decode_kv`` or ``beam_search_kv``), caught at its call."""
    import whisper_tpu_torch.pipeline as pipeline_module

    real, seen = getattr(pipeline_module, entry), []

    def catch(model, cross_kv, prompt, dt, **kw):
        seen.append((model, cross_kv, prompt, dt, kw))
        return real(model, cross_kv, prompt, dt, **kw)

    setattr(pipeline_module, entry, catch)
    try:
        pipe.transcribe_batch(clips)
    finally:
        setattr(pipeline_module, entry, real)
    if len(seen) != 1:
        raise AssertionError(f"transcribe_batch ran {len(seen)} calls of {entry}, not 1")
    return seen[0]


def _stepwise_decode(model, cross_kv, prompt, dt, max_tokens=None, suppress_ids=None,
                     apply_filters=False, self_kv_quant=False, gelu="erf", timestamps=False,
                     prompt_pad=None, sot_index=0, cross_decode="fd", temperature=0.0):
    """The greedy loop before its rounds: one ``decoder_forward`` of S=1 at
    an int offset a step, the all-done flag read before each (the port's
    earlier ``greedy_decode_kv`` at temperature 0). ``decode_graph`` holds
    the rounds bit-equal to it."""
    from whisper_tpu_torch.decode import GreedyResult
    from whisper_tpu_torch.models.model import decoder_forward, new_kv_cache
    from whisper_tpu_torch.sampling import RuleState, apply_rules

    if temperature:
        raise ValueError("the stepwise reference is greedy")
    cfg, device = model.cfg, prompt.device
    (B, P), T, eot, ts0 = prompt.shape, cfg.n_text_ctx, cfg.eot, cfg.timestamp_begin
    limit = min(T, P + max_tokens) if max_tokens else T
    use_rules = apply_filters or timestamps or suppress_ids is not None

    def pick(logits, rs):
        if use_rules:
            logits = apply_rules(logits, rs, cfg, suppress_ids=suppress_ids,
                                 timestamps=timestamps)
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        tok = torch.argmax(lp, dim=-1)
        return tok, torch.gather(lp, 1, tok[:, None])[:, 0]

    kw = dict(pad=prompt_pad, gelu=gelu, cross_decode=cross_decode)
    kv = new_kv_cache(model, B, dt, min(T, -(-limit // 128) * 128), quant=self_kv_quant)
    tokens = torch.full((B, T), eot, dtype=torch.int64, device=device)
    tokens[:, :P] = prompt
    logits, kv = decoder_forward(model, prompt, 0, kv, cross_kv, dt, **kw)
    nsp = torch.softmax(logits[:, sot_index], dim=-1)[:, cfg.no_speech]
    rs = RuleState.create(B, device=device)
    first, sum_lp = pick(logits[:, -1], rs)
    rs = rs.advance(first, ts0)
    tokens[:, P] = first
    done = first == eot
    n_lp = torch.ones((B,), dtype=torch.float32, device=device)
    i, steps = P, 0
    while i < limit - 1 and not bool(done.all()):
        logits, kv = decoder_forward(model, tokens[:, i:i + 1], i, kv, cross_kv, dt, **kw)
        nxt, lp = pick(logits[:, 0], rs)
        nxt = torch.where(done, torch.full_like(nxt, eot), nxt)
        alive = ~done
        done = done | (nxt == eot)
        sum_lp = sum_lp + torch.where(alive, lp, torch.zeros_like(lp))
        n_lp = n_lp + alive.to(torch.float32)
        tokens[:, i + 1] = nxt
        if use_rules:
            rs = rs.advance(nxt, ts0)
        i += 1
        steps += 1
    pos = torch.arange(T, device=device)[None, :]
    lengths = torch.where((tokens == eot) & (pos >= P), pos, torch.full_like(pos, T)).amin(1)
    return GreedyResult(tokens=tokens, lengths=lengths, no_speech_prob=nsp,
                        avg_logprob=sum_lp / torch.clamp(n_lp, min=1.0), steps=steps,
                        host_syncs=steps + 1, device_steps=steps)


def _stepwise_beam(model, cross_kv, prompt, dt, beam_size=5, max_tokens=None,
                   suppress_ids=None, timestamps=False, apply_filters=True, length_penalty=None,
                   prompt_pad=None, sot_index=0, self_kv_quant=False, gelu="erf"):
    """The beam loop before its rounds: one ``decoder_forward(beam_k=K)`` of
    S=1 at an int offset a step, the loop condition read before each, the
    cache, tokens and rule state reordered into new tensors (the port's
    earlier ``beam_search_kv``). ``beam_phase`` holds the rounds bit-equal
    to it."""
    from whisper_tpu_torch.beam import BeamResult, _norm_score, _top_k
    from whisper_tpu_torch.decode import _nested_map
    from whisper_tpu_torch.models.model import decoder_forward, new_kv_cache
    from whisper_tpu_torch.sampling import NEG_INF, RuleState, apply_rules

    cfg, device = model.cfg, prompt.device
    (B, P), K, T, V = prompt.shape, beam_size, cfg.n_text_ctx, cfg.n_vocab
    N, eot, ts0, half = B * K, cfg.eot, cfg.timestamp_begin, NEG_INF / 2
    limit = min(T, P + max_tokens) if max_tokens else T
    use_rules = apply_filters or timestamps or suppress_ids is not None
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)

    def filt(logits, state):
        if not use_rules:
            return logits
        return apply_rules(logits, state, cfg, suppress_ids=suppress_ids, timestamps=timestamps)

    kv = new_kv_cache(model, B, dt, min(T, -(-limit // 128) * 128), quant=self_kv_quant)
    logits, kv = decoder_forward(model, prompt, 0, kv, cross_kv, dt, pad=prompt_pad, gelu=gelu)
    nsp = torch.softmax(logits[:, sot_index].to(torch.float32), dim=-1)[:, cfg.no_speech]
    kv = _nested_map(kv, lambda t: t.repeat_interleave(K, dim=1))
    pad_n = None if prompt_pad is None else prompt_pad.repeat_interleave(K)
    tokens = torch.full((N, T), eot, dtype=torch.int64, device=device)
    tokens[:, :P] = prompt.repeat_interleave(K, dim=0)
    rs = RuleState.create(N, device=device)
    lp0 = torch.log_softmax(filt(logits[:, -1].repeat_interleave(K, dim=0), rs)
                            .to(torch.float32), dim=-1)
    beam0 = (torch.arange(N, device=device) % K == 0)[:, None]
    scores, flat_idx = _top_k(torch.where(beam0, lp0, neg).reshape(B, K * V), K)
    first = flat_idx % V
    tokens[:, P] = first.reshape(N)
    rs = rs.advance(first.reshape(N), ts0)
    opened = first == eot
    fin_scores = torch.where(opened, _norm_score(scores, torch.ones_like(scores),
                                                 length_penalty), neg)
    fin_tokens = tokens.reshape(B, K, T).clone()
    fin_lens = torch.full((B, K), P, dtype=torch.int64, device=device)
    scores = torch.where(opened, neg, scores)
    n_gen = torch.ones((B, K), dtype=torch.int64, device=device)
    parent_base = (torch.arange(B, device=device) * K)[:, None]
    i, steps, syncs = P, 0, 0
    while i < limit - 1:
        syncs += 1
        live = (scores > half).any(dim=1)
        unfinished = (fin_scores <= half).any(dim=1)
        if not bool((live & unfinished).any()):
            break
        logits, kv = decoder_forward(model, tokens[:, i:i + 1], i, kv, cross_kv, dt, pad=pad_n,
                                     gelu=gelu, beam_k=K)
        lp = torch.log_softmax(filt(logits[:, 0], rs).to(torch.float32), dim=-1)
        cand = torch.where((scores.reshape(N) > half)[:, None], scores.reshape(N, 1) + lp, neg)
        cand2k, idx2k = _top_k(cand.reshape(B, K * V), 2 * K)
        tok2k, src2k = idx2k % V, idx2k // V
        is_eot = tok2k == eot
        ngen_src = torch.gather(n_gen, 1, src2k)
        n_gen2k = ngen_src + 1
        eot_norm = torch.where(is_eot, _norm_score(cand2k, n_gen2k, length_penalty), neg)
        merged_tokens = torch.cat([fin_tokens, torch.gather(
            tokens.reshape(B, K, T), 1, src2k[..., None].expand(B, 2 * K, T))], dim=1)
        merged_lens = torch.cat([fin_lens, P + ngen_src], dim=1)
        fin_scores, fin_idx = _top_k(torch.cat([fin_scores, eot_norm], dim=1), K)
        fin_tokens = torch.gather(merged_tokens, 1, fin_idx[..., None].expand(B, K, T))
        fin_lens = torch.gather(merged_lens, 1, fin_idx)
        scores, pick = _top_k(torch.where(is_eot, neg, cand2k), K)
        new_tok = torch.gather(tok2k, 1, pick).reshape(N)
        n_gen = torch.gather(n_gen2k, 1, pick)
        flat = (parent_base + torch.gather(src2k, 1, pick)).reshape(N)
        tokens = tokens.index_select(0, flat)
        tokens[:, i + 1] = new_tok
        kv = _nested_map(kv, lambda t: t.index_select(1, flat))
        rs = RuleState(*(f.index_select(0, flat) for f in rs)).advance(new_tok, ts0)
        i += 1
        steps += 1
    run_norm = _norm_score(scores, n_gen, length_penalty)
    no_fin = (fin_scores <= half).all(dim=1, keepdim=True)
    rows = torch.arange(B, device=device)
    best_run = torch.argmax(run_norm, dim=1)
    fin_or_run = torch.where(no_fin, torch.gather(run_norm, 1, best_run[:, None]), fin_scores)
    best = torch.argmax(fin_or_run, dim=1)
    best_tokens = torch.where(no_fin, tokens.reshape(B, K, T)[rows, best_run],
                              fin_tokens[rows, best])
    best_lens = torch.where(no_fin[:, 0], torch.full_like(fin_lens[:, 0], i + 1),
                            torch.gather(fin_lens, 1, best[:, None])[:, 0])
    best_scores = torch.gather(fin_or_run, 1, best[:, None])[:, 0]
    pos = torch.arange(T, device=device)[None, :]
    best_tokens = torch.where(pos >= best_lens[:, None], torch.full_like(best_tokens, eot),
                              best_tokens)
    return BeamResult(tokens=best_tokens, lengths=best_lens, scores=best_scores,
                      all_tokens=fin_tokens, all_scores=fin_scores, no_speech_prob=nsp,
                      avg_logprob=best_scores, steps=steps, host_syncs=syncs,
                      device_steps=steps)


def _walls(fn, reps: int) -> list:
    """Host seconds of ``reps`` calls of ``fn``, each ended by a sync."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


GRAPH_SWEEP = (4, 8, 16, 16, 8, 4)  # ROUND_STEPS values decode_graph times, in turns
DECODE_FIELDS = ("tokens", "lengths", "avg_logprob", "no_speech_prob")
SAMPLED_T = 0.6  # decode_graph's sampled decode: a rung of the ladder
SAMPLED_SEED = 600  # the pipeline's seed for that rung, int(t * 1000)
LADDER_KEEP = 0.6  # the share of a rung's rows _shrinking_gate fails again
LADDER_BATCHES = 3  # transcribe_batch calls of decode_graph's ladder
LADDER_WALL_BATCHES = 5  # and of chip_walls.py --ladder, the first a warm-up


def _bit_equal(what: str, a, b, fields) -> None:
    """Every field of two decode results equal bit for bit, and their trip
    counts."""
    for name in fields:
        x, y = getattr(a, name), getattr(b, name)
        if not torch.equal(x, y):
            rows = (x != y).reshape(x.shape[0], -1).any(1).nonzero()[:, 0].tolist()
            raise AssertionError(f"{what}: {name} differs on rows {rows}")
    if a.steps != b.steps:
        raise AssertionError(f"{what}: {a.steps} steps against {b.steps}")


def _three_ways(what: str, ways: dict, counters, expect, profiled=(), again=None) -> tuple:
    """The graphed way of one decode run once to warm (it captures its keys
    here), then each way once timed with the counts at 0 (``expect(what,
    launches, result)`` holds them) and ``again[way]`` more walls (2 for
    the graphed way by default; an uncaptured way takes about a second a
    run, so it runs once); the host's CUDA launch calls in one run of
    each way in ``profiled`` (torch.profiler). Returns (records, results)
    by way."""
    again = {"graphed": 2} if again is None else again
    from torch.profiler import ProfilerActivity, profile

    rec, results = {}, {}
    for way, fn in ways.items():
        first_s = None
        if way == "graphed":
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches(counters)
        expect(f"{what} {way}", launches, res)
        results[way] = res
        rec[way] = {"first_call_s": first_s, "wall_s": wall,
                    "walls_s": [wall] + _walls(fn, again.get(way, 0)),
                    "steps": res.steps, "device_steps": res.device_steps,
                    "host_syncs": res.host_syncs,
                    "launches": {k: n for k, n in launches.items() if n}}
        if way in profiled:
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            calls = _host_launches(prof)
            rec[way].update(host_launch_calls=calls, host_launch_calls_total=sum(calls.values()),
                            profile_s=time.perf_counter() - t0)
    return rec, results


def decode_graph(counters, smi: str) -> dict:
    """The offline configuration's greedy decode (turbo, B64, 64 tokens,
    bf16, W8A8, int8 cross- and self-KV; its inputs caught from
    ``transcribe_batch``) under each ``cross_decode`` selection, three ways
    on the same cross-KV: the graphed ``greedy_decode_kv``, the same rounds
    uncaptured (``decode._greedy_rounds(graphed=False)``) and the loop the
    rounds replaced (:func:`_stepwise_decode`). Tokens, lengths,
    avg_logprob and no_speech_prob bit-equal across all three; launches
    exact for each (``_expect``, the graphed ones counted through
    replays). Walls, rounds and host reads; the host's CUDA launch calls
    during one graphed decode under fd (torch.profiler; the selections
    launch alike; an uncaptured decode's profile took 13-20 s of the
    smoke on an H100 and counted the same 31,892 calls in six runs, so it
    is no longer taken); the copy of the cross-KV into the graph's buffer
    (CUDA events), the capture seconds per key and
    the graph pool's bytes; the graphed wall at each ``GRAPH_SWEEP``
    round length, in turns (fd). Then the same decode sampled at
    ``SAMPLED_T`` (a ladder rung) under each selection, graphed against
    its rounds uncaptured under one hook's draws (``gumbel_noise`` of
    ``SAMPLED_SEED``, made anew for each decode), bit-equal, launches
    exact, the graphed way's host launch calls under fd, and the noise fill
    of one round (CUDA events); and the pipeline with its ladder on, its
    rungs at shrinking batches (:func:`_ladder_graphs`)."""
    from whisper_tpu_torch import decode
    from whisper_tpu_torch.config import N_SAMPLES
    from whisper_tpu_torch.pipeline import WhisperPipeline

    pipe = WhisperPipeline(model="turbo", device="cuda", compute_dtype="bfloat16",
                           quantize=True, w8a8=True, kv_quant=True, self_kv_quant=True,
                           max_tokens=N_TOKENS, seed=0)
    rng = np.random.default_rng(0)
    clips = list(rng.standard_normal((B, N_SAMPLES)).astype(np.float32) * 0.1)
    model, cross, prompt, dt, kw = _greedy_args(pipe, clips)
    cfg = model.cfg
    args = (model, cross, prompt, dt, kw["max_tokens"], kw["suppress_ids"],
            kw["apply_filters"], kw["self_kv_quant"], kw["gelu"], kw["timestamps"],
            kw.get("prompt_pad"), kw["sot_index"])
    out = {"phase": "decode_graph", "nvidia_smi": smi, "model": "turbo", "batch": B,
           "max_tokens": N_TOKENS, "dtype": "bfloat16",
           "quant": "int8 weights + w8a8 encoder + kvq + skvq", "round_steps": decode.ROUND_STEPS,
           "selections": {}}
    for sel in ("fd", "legacy", "dense"):
        ways = {"graphed": lambda: decode.greedy_decode_kv(
                    model, cross, prompt, dt, **{**kw, "cross_decode": sel}),
                "uncaptured": lambda: decode._greedy_rounds(
                    *args, sel, 0.0, 0, None, False),
                "stepwise": lambda: _stepwise_decode(
                    model, cross, prompt, dt, **{**kw, "cross_decode": sel})}
        # the selections launch alike: the host's calls under fd
        rec, results = _three_ways(
            f"decode_graph {sel}", ways, counters,
            lambda what, launches, res: _expect(what, launches, cfg, 0, res.device_steps,
                                                cross_decode=sel),
            profiled=("graphed",) if sel == "fd" else ())
        for way in ("uncaptured", "stepwise"):
            _bit_equal(f"decode_graph {sel}: graphed against {way}", results["graphed"],
                       results[way], DECODE_FIELDS)
        rec["bit_equal"] = {"uncaptured": list(DECODE_FIELDS), "stepwise": list(DECODE_FIELDS)}
        out["selections"][sel] = rec
        if sel == "fd":
            fd_tokens = results["graphed"].tokens
    bufs = [torch.empty_like(t) for t in cross]
    out["cross_kv_bytes"] = sum(t.numel() * t.element_size() for t in cross)
    out["cross_kv_copy_ms"] = cuda_ms(lambda: [d.copy_(t) for d, t in zip(bufs, cross)], 20)
    del bufs
    graphed = lambda: decode.greedy_decode_kv(model, cross, prompt, dt, **kw)  # noqa: E731
    sweep = {}
    try:
        for r in GRAPH_SWEEP:
            decode.ROUND_STEPS = r
            res = graphed()  # its key's capture at the first visit
            if not torch.equal(res.tokens, fd_tokens):
                raise AssertionError(f"decode_graph: tokens at ROUND_STEPS {r} differ")
            entry = sweep.setdefault(str(r), {"walls_s": [], "host_syncs": res.host_syncs,
                                              "device_steps": res.device_steps})
            entry["walls_s"] += _walls(graphed, 3)
    finally:
        decode.ROUND_STEPS = out["round_steps"]
    for entry in sweep.values():
        entry["median_s"] = float(np.median(entry["walls_s"]))
    out["round_steps_sweep"] = sweep
    out["sampled"] = _sampled_graphs(counters, model, cross, prompt, dt, kw, args)
    out["ladder"] = _ladder_graphs(counters, pipe, clips)
    out["graphs"] = decode.graph_stats(model)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _sampled_graphs(counters, model, cross, prompt, dt, kw, args) -> dict:
    """``decode_graph``'s sampled decodes (see there)."""
    from types import SimpleNamespace

    from whisper_tpu_torch import decode

    cfg = model.cfg
    rec = {"temperature": SAMPLED_T, "seed": SAMPLED_SEED, "selections": {}}
    for sel in ("fd", "legacy", "dense"):
        skw = {**kw, "cross_decode": sel, "temperature": SAMPLED_T, "seed": SAMPLED_SEED}
        ways = {"graphed": lambda: decode.greedy_decode_kv(model, cross, prompt, dt, **skw),
                "uncaptured": lambda: decode._greedy_rounds(
                    *args, sel, SAMPLED_T, SAMPLED_SEED, None, False)}
        srec, results = _three_ways(
            f"decode_graph sampled {sel}", ways, counters,
            lambda what, launches, res: _expect(what, launches, cfg, 0, res.device_steps,
                                                cross_decode=sel),
            profiled=("graphed",) if sel == "fd" else ())
        _bit_equal(f"decode_graph sampled {sel}", results["graphed"], results["uncaptured"],
                   DECODE_FIELDS)
        srec["bit_equal"] = {"uncaptured": list(DECODE_FIELDS)}
        rec["selections"][sel] = srec
    R, V = decode.ROUND_STEPS, cfg.n_vocab
    loop = SimpleNamespace(noise=torch.empty((R, B, V), dtype=torch.float32, device="cuda"))
    hook = decode.gumbel_noise(SAMPLED_SEED, "cuda")
    rec["noise_fill_ms"] = cuda_ms(lambda: decode._fill_noise(loop, hook, 0, R), reps=20)
    rec["noise_fill_bytes"] = loop.noise.numel() * 4
    rec["noise_fill"] = (f"one round's draws: {R} x gumbel_noise(step, ({B}, {V})) copied "
                         "into the loop's buffer, CUDA events over 20 rounds")
    return rec


def _shrinking_gate(batch: int, n: int) -> tuple:
    """(a ``_needs_retry`` for a pipeline of ``n`` rows, the failing rows
    of each of its calls): each call fails a seeded ``LADDER_KEEP`` of the
    rows the call before failed (all rows before the first), so each rung
    re-decodes a smaller batch, as real audio makes it, at sizes that
    differ from batch to batch."""
    rng = np.random.default_rng(1000 + batch)
    bad, sizes = np.ones(n, dtype=bool), []

    def gate(result, prompts):
        nonlocal bad
        bad = bad & (rng.random(n) < LADDER_KEEP)
        sizes.append(int(bad.sum()))
        return bad.copy()

    return gate, sizes


def _ladder_graphs(counters, pipe, clips) -> dict:
    """``decode_graph``'s pipeline ladder (see there): ``LADDER_BATCHES``
    calls of ``transcribe_batch``, each through :func:`_shrinking_gate`
    (its rungs at batches of their own); walls, launches exact (one
    encode, the decodes' steps on the card), the graph counts of each
    call, and the main decode's loop and graphs kept throughout: every
    graph of the batch's shape stays the one captured before the first
    call, and every round but a new key's first replays."""
    from whisper_tpu_torch import decode

    n = len(clips)
    owner = decode._GRAPHS[pipe.model]
    main = {k: g for k, g in owner.graphs._graphs.items() if k[0] == n}
    pipe.temperature_fallback = True
    rec = {"keep": LADDER_KEEP, "batches": []}
    try:
        for batch in range(LADDER_BATCHES):
            pipe._needs_retry, sizes = _shrinking_gate(batch, n)
            before = decode.graph_stats(pipe.model)
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            pipe.transcribe_batch(clips)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches(counters)
            dec = pipe.last_decode
            _expect(f"decode_graph ladder {batch}", launches, pipe.cfg, 1, dec.device_steps)
            after = decode.graph_stats(pipe.model)
            rec["batches"].append({
                "wall_s": wall, "rung_rows": sizes, "steps": dec.steps,
                "device_steps": dec.device_steps, "host_syncs": dec.host_syncs,
                "captures": after["captures"] - before["captures"],
                "replays": after["replays"] - before["replays"], "keys": after["keys"],
                "loops": len(owner.loops),
                "capture_s": sum(v for k, v in after["capture_s"].items()
                                 if before["capture_s"].get(k) != v)})
            kept = {k: g for k, g in owner.graphs._graphs.items() if k in main}
            b = rec["batches"][-1]
            if kept != main or b["replays"] != b["host_syncs"] - b["captures"]:
                raise AssertionError(f"the ladder dropped or recaptured the main decode's "
                                     f"graphs, or ran rounds uncaptured: {b}")
    finally:
        pipe.temperature_fallback = False
        del pipe._needs_retry
    return rec


def shrinking_ladder_walls() -> dict:
    """``chip_walls.py --ladder``: the offline configuration (as
    ``decode_graph``) with its ladder on, ``LADDER_WALL_BATCHES`` calls of
    ``transcribe_batch`` over the same clips, each through
    :func:`_shrinking_gate`; the first call warms (the main decode's
    capture), the walls of the others. Uses only what every checkout of
    the port has."""
    from whisper_tpu_torch.config import N_SAMPLES
    from whisper_tpu_torch.pipeline import WhisperPipeline

    pipe = WhisperPipeline(model="turbo", device="cuda", compute_dtype="bfloat16",
                           quantize=True, w8a8=True, kv_quant=True, self_kv_quant=True,
                           max_tokens=N_TOKENS, seed=0, temperature_fallback=True)
    rng = np.random.default_rng(0)
    clips = list(rng.standard_normal((B, N_SAMPLES)).astype(np.float32) * 0.1)
    walls, rows = [], []
    for batch in range(LADDER_WALL_BATCHES):
        pipe._needs_retry, sizes = _shrinking_gate(batch, B)
        t0 = time.perf_counter()
        pipe.transcribe_batch(clips)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        rows.append(sizes)
    return {"walls_s": walls, "rung_rows": rows, "device_steps": pipe.last_decode.device_steps}


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
    decode_calls = _host_launches(prof, "whisper.decode")
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
            "decode_host_launch_calls": decode_calls,
            "top_kernels_ms": [[name[:90], ms, n] for name, (ms, n) in top]}


def _wav(x: np.ndarray) -> bytes:
    """16-bit PCM WAV bytes of mono 16 kHz audio."""
    pcm = np.round(np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def _ask(url: str, clip: np.ndarray, query=None, headers=None, multipart: bool = False,
         fields=None) -> tuple:
    """(status, reply, seconds) of one POST of ``clip`` to ``url`` with the
    ``query`` options and extra ``headers``: f32 PCM, or with ``multipart``
    a 16-bit WAV form field and the form fields ``fields``. The reply is the
    JSON body, the NDJSON lines of a stream, or the text of another
    format."""
    from urllib.parse import quote

    if query:
        url += ("&" if "?" in url else "?") + "&".join(f"{k}={quote(str(v))}"
                                                    for k, v in query.items())
    if multipart:
        body = (b"--B\r\nContent-Disposition: form-data; name=\"wav\"; filename=\"a.wav\"\r\n"
                b"Content-Type: audio/wav\r\n\r\n" + _wav(clip) + b"\r\n"
                + b"".join(f"--B\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n"
                           f"{v}\r\n".encode() for k, v in (fields or {}).items())
                + b"--B--\r\n")
        ctype = "multipart/form-data; boundary=B"
    else:
        body, ctype = clip.astype("<f4").tobytes(), "application/octet-stream"
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype,
                                                          **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            text, kind = r.read().decode(), r.headers.get("Content-Type", "")
            seconds = time.perf_counter() - t0
            if "ndjson" in kind:
                return r.status, [json.loads(x) for x in text.splitlines() if x], seconds
            return r.status, json.loads(text) if "json" in kind else text, seconds
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode()}, time.perf_counter() - t0


def _started(flags, mesh=None, built=None, warm_request: bool = True):
    """The turbo server of ``python -m whisper_tpu_torch.serving`` with
    ``flags`` (on ``mesh`` if given), started in-process on 127.0.0.1 (its
    engine's warm start on, as the server's default) and warmed by one
    request (cuBLAS, the allocator) unless not ``warm_request``; ``built``
    is an (engine, startup phases) the caller built and warmed from the
    same flags: (engine, base URL, args, server, its thread, startup
    phases, startup seconds)."""
    from whisper_tpu_torch.serving.__main__ import build_engine, parse_args
    from whisper_tpu_torch.serving.server import make_server

    args = parse_args(["--model_type", "turbo", "--host", "127.0.0.1", "--port", "0", *flags])
    t0 = time.perf_counter()
    if built is None:
        engine, phases = build_engine(args, mesh=mesh)
        engine.start()
    else:
        engine, phases = built
        engine.start(warm=False)
    srv = make_server(engine, args.host, args.port, request_timeout_s=900)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    if warm_request:
        warm = np.random.default_rng(9).standard_normal(16000 * 3).astype(np.float32) * 0.1
        code, reply, _ = _ask(f"{base}/asr", warm)
        if code != 200:
            raise AssertionError(f"warm request answered {code}: {reply}")
    return engine, base, args, srv, thread, phases, time.perf_counter() - t0


def _stopped(engine, srv, thread):
    srv.shutdown()
    srv.server_close()
    engine.stop()
    thread.join(timeout=30)


N_REQUESTS = 24
N_VARIANT_REQUESTS = 8
N_LADDER_REQUESTS = 8
N_TP_REQUESTS = 8
VARIANT_FLAGS = ("--encoder_attention", "bhtd", "--cross_decode", "dense")
# the greedy core: the serving bursts measured before the ladder was ported
GREEDY = ("--temperature_fallback", "")


def serving(counters, flags=(), n_requests: int = N_REQUESTS, mesh=None, phase="serving",
            keep_engine: bool = False, language: str = "", built=None,
            warm_request: bool = True):
    """The serving path: ``python -m whisper_tpu_torch.serving``'s engine
    under the server's zero-flag defaults plus ``flags`` (on ``mesh`` if
    given), in-process on 127.0.0.1, one warm request, then ``n_requests``
    seeded noise clips of 2-30 s from as many client threads (every sixth as
    multipart WAV, the rest as f32 PCM), each with ``?language=`` the given
    one if any (the server's default otherwise). Counts slot and aux
    (ladder) launches alike, detection steps included. Returns the record,
    and with ``keep_engine`` also the stopped engine and the clips.
    ``built`` and ``warm_request`` go to :func:`_started`."""
    from whisper_tpu_torch.decode import graph_stats

    engine, base, args, srv, thread, phases, startup_s = _started(flags, mesh, built,
                                                                  warm_request)
    url = f"{base}/asr"
    try:
        rng = np.random.default_rng(2)
        clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
                 for s in rng.uniform(2.0, 30.0, N_REQUESTS)][:n_requests]
        query = {"language": language} if language else None
        st0 = engine.stats.snapshot()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_requests) as pool:
            replies = list(pool.map(lambda i: _ask(url, clips[i], query, multipart=i % 6 == 0),
                                    range(n_requests)))
        wall = time.perf_counter() - t0
        launches = _launches(counters)
        st1 = engine.stats.snapshot()
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            metrics = json.load(r)
    finally:
        _stopped(engine, srv, thread)
    bad = [(code, reply) for code, reply, _ in replies
           if code != 200 or not reply.get("success") or not isinstance(reply.get("text"), str)
           or not 0 <= reply.get("tokens", -1) <= args.max_tokens]
    if bad:
        raise AssertionError(f"{len(bad)} of {n_requests} replies failed: {bad[:3]}")
    delta = _served_counts(engine, args, st0, st1, launches, f"{phase} {list(flags)}")
    steps, batches = delta["steps_total"], delta["encode_batches_total"]
    aux_batches, aux_steps = delta["aux_batches_total"], delta["aux_steps_total"]
    lat = np.array([sec for _, _, sec in replies])
    audio_s = sum(len(c) for c in clips) / 16000
    rec = {"phase": phase, "model": "turbo", "flags": "server defaults: "
           "--slots 8 --steps_per_sync 32 --max_tokens 224, w8a8 + kv_quant + "
           "self_kv_quant, bfloat16" + "".join(f" {f}" for f in flags),
           "mesh": None if mesh is None else repr(mesh),
           "requests": n_requests, "multipart": len(range(0, n_requests, 6)),
           "answered_200": n_requests - len(bad), "startup_s": startup_s,
           "startup_phases": phases, "warmup_s": engine.stats.warmup_seconds,
           "wall_s": wall, "requests_per_s": n_requests / wall,
           "latency_p50_s": float(np.percentile(lat, 50)),
           "latency_p95_s": float(np.percentile(lat, 95)),
           "audio_s": audio_s, "audio_s_per_s": audio_s / wall,
           "tokens": [reply["tokens"] for _, reply, _ in replies],
           "attempts": [reply["attempts"] for _, reply, _ in replies],
           "temperatures": [reply["temperature"] for _, reply, _ in replies],
           "ticks": delta["ticks_total"], "steps": steps, "admission_batches": batches,
           "step_seconds": delta["step_seconds_total"],
           "aux_batches": aux_batches, "aux_steps": aux_steps,
           "retries": delta["retries_total"], "detect_batches": delta["detect_batches_total"],
           "languages": [reply.get("language") for _, reply, _ in replies],
           "round_sizes": delta["round_sizes"], "launches": launches, "metrics": metrics,
           "step_graphs": None if engine._graphs is None else engine._graphs.stats(),
           "aux_graphs": graph_stats(engine.model)}
    if engine.encode_chunks > 1:
        rec["encode_group_s"] = {str(b): t for b, t in engine._encode_seg_est.items()}
    if keep_engine:
        return rec, engine, clips[:n_requests], [reply for _, reply, _ in replies]
    return rec


def _served_counts(engine, args, st0: dict, st1: dict, launches: dict, path: str,
                   aux_beams: bool = False) -> dict:
    """The engine counters' change over a burst (stats snapshots ``st0`` and
    ``st1``), and the check that ``launches`` are exactly what its encodes,
    steps and detection steps launch (slot and aux work alike; with
    ``aux_beams`` every aux step is a beam step)."""
    from whisper_tpu_torch.models.model import model_shards

    delta = {key: st1[key] - st0[key] for key in (
        "steps_total", "encode_batches_total", "aux_batches_total", "aux_steps_total",
        "retries_total", "ticks_total", "detect_batches_total", "partials_total",
        "beam_requests_total", "step_seconds_total")}
    delta["round_sizes"] = {k: n - st0["round_sizes"].get(k, 0)
                            for k, n in st1["round_sizes"].items()
                            if n > st0["round_sizes"].get(k, 0)}
    steps, batches = delta["steps_total"], delta["encode_batches_total"]
    aux_batches, aux_steps = delta["aux_batches_total"], delta["aux_steps_total"]
    _expect(f"{path} ({steps} + {aux_steps} aux steps, {batches} + {aux_batches} aux encodes)",
            launches, engine.cfg, batches + aux_batches, steps + (0 if aux_beams else aux_steps),
            args.encoder_attention, args.cross_decode, tp=len(model_shards(engine.model)),
            detects=delta["detect_batches_total"], beam_steps=aux_steps if aux_beams else 0)
    return delta


def serving_ladder(counters) -> dict:
    """The server at its true zero-flag defaults (the JAX server's ladder
    0.2 ... 1.0 on): with random weights every request fails the logprob
    gate and climbs every rung on the aux worker, so each resolves at its
    sixth attempt, at temperature 1.0. Reports the aux worker's share of
    the kernels' launches; its sampled rounds replay CUDA graphs (the
    model's, ``aux_graphs``: captures, keys and replays)."""
    rec = serving(counters, (), N_LADDER_REQUESTS, phase="serving_ladder")
    rungs = 5
    if rec["attempts"] != [rungs + 1] * N_LADDER_REQUESTS or set(rec["temperatures"]) != {1.0}:
        raise AssertionError(f"ladder replies: attempts {rec['attempts']}, "
                             f"temperatures {rec['temperatures']}")
    if rec["retries"] != rungs * N_LADDER_REQUESTS:
        raise AssertionError(f"{rec['retries']} retries for {N_LADDER_REQUESTS} requests")
    if not (rec["aux_graphs"] and rec["aux_graphs"]["replays"]):
        raise AssertionError(f"the aux worker's sampled rounds replayed no graph: "
                             f"{rec['aux_graphs']}")
    L_text = 4
    rec["aux_launches"] = {"log10_mel": rec["aux_batches"],
                           "flash_attention_btd": L_AUDIO * rec["aux_batches"],
                           "int8_gemm": 6 * L_AUDIO * rec["aux_batches"],
                           "quantize_rows": 4 * L_AUDIO * rec["aux_batches"],
                           "cross_attention_decode_fd": L_text * rec["aux_steps"],
                           "self_attention_decode_int8": L_text * rec["aux_steps"]}
    return rec


def tensor_parallel(counters, mesh=None, flags=(), phase: str = "tp") -> dict:
    """TP serving: the turbo server's defaults with the ladder off, split
    over ``mesh`` (by default (1, 2) with both ranks on the card) or, with
    ``flags`` ``--tp N``, over N distinct cards as the server's flag places
    it; 8 clips over HTTP (exact launch counts: every rank launches K1 per
    layer, K8 per product, K2 and K3 per layer-step). On one card the step
    rounds replay CUDA graphs (``step_graphs`` holds their captures and
    replays, and must); the same burst then runs on an engine of the same
    flags whose rounds are uncaptured (``_graphs`` None, warmed by
    ``warmup()``, no warm request), its wall and the burst's step seconds
    beside the graphed ones. Then the W8A8 encoder output of one admission
    batch (the 8 clips' mel) against the one-rank engine's on the first
    card, which must be bit-equal, and the texts beside the one-rank
    engine's for the same clips."""
    from whisper_tpu_torch.decode import capturable
    from whisper_tpu_torch.models.model import encoder_forward
    from whisper_tpu_torch.ops.mel import log_mel_batch
    from whisper_tpu_torch.parallel.sharding import make_mesh
    from whisper_tpu_torch.serving.__main__ import build_engine, parse_args
    from whisper_tpu_torch.serving.engine import Request

    dev = torch.device("cuda", 0)
    if mesh is None and not flags:
        mesh = make_mesh(1, 2, devices=[dev, dev])
    rec, eng2, clips, replies = serving(counters, GREEDY + tuple(flags), N_TP_REQUESTS,
                                        mesh=mesh, phase=phase, keep_engine=True)
    if capturable(eng2.model, eng2.device):
        graphs = rec["step_graphs"]
        if not graphs or not graphs["captures"] or not graphs["replays"]:
            raise AssertionError(f"{phase}: the one-card mesh's step rounds were not "
                                 f"replayed: {graphs}")
        args = parse_args(["--model_type", "turbo", *GREEDY, *flags])
        t0 = time.perf_counter()
        eager, phases = build_engine(args, mesh=mesh)
        eager._graphs = None
        eager.warmup()
        phases = {**phases, "build_and_warm_s": time.perf_counter() - t0}
        plain, _, _, plain_replies = serving(counters, GREEDY + tuple(flags), N_TP_REQUESTS,
                                             mesh=mesh, phase=f"{phase} uncaptured",
                                             keep_engine=True, built=(eager, phases),
                                             warm_request=False)
        if plain["step_graphs"] is not None:
            raise AssertionError(f"{phase}: the uncaptured engine captured its rounds")
        rec["uncaptured"] = {key: plain[key] for key in (
            "wall_s", "latency_p50_s", "latency_p95_s", "audio_s_per_s", "ticks", "steps",
            "step_seconds", "round_sizes", "launches", "tokens")}
        rec["uncaptured"]["texts_equal_graphed"] = int(sum(
            a["text"] == b["text"] for a, b in zip(replies, plain_replies)))
        rec["wall_ratio_uncaptured"] = plain["wall_s"] / rec["wall_s"]
        rec["step_seconds_ratio_uncaptured"] = plain["step_seconds"] / rec["step_seconds"]
        del eager
    eng1, _ = build_engine(parse_args(["--model_type", "turbo", *GREEDY]))
    eng1.start()
    try:
        futs = [eng1.submit(Request(audio=c)) for c in clips]
        one = [f.result(timeout=600) for f in futs]
    finally:
        eng1.stop()
    cfg = eng1.cfg
    audio = np.zeros((len(clips), 480000), np.float32)
    for i, c in enumerate(clips):
        audio[i, : len(c)] = c[:480000]
    mel = log_mel_batch(torch.from_numpy(audio).to(dev),
                        torch.tensor([min(len(c), 480000) for c in clips], device=dev),
                        n_mels=cfg.n_mels)[..., : 2 * cfg.n_audio_ctx]
    enc = [encoder_forward(e.model, mel, torch.bfloat16, w8a8=True) for e in (eng1, eng2)]
    torch.cuda.synchronize()
    if not torch.equal(enc[0], enc[1]):
        raise AssertionError(f"the tp 2 W8A8 encoder differs from tp 1 by "
                             f"{float((enc[0] - enc[1]).abs().max())}")
    same = [a["text"] == b["text"] for a, b in zip(replies, one)]
    rec.update({"w8a8_encoder_bit_equal_tp1": True, "encoder_batch": len(clips),
                "texts_equal_tp1": int(sum(same)), "texts_compared": len(same),
                "tokens_tp1": [r["tokens"] for r in one]})
    return rec


def serving_reference_check() -> dict:
    """A small fp32 engine (tiny, kvq + skvq) on the card, rounds driven one
    tick at a time through its kernels and replayed as CUDA graphs, must
    give the CPU pipeline's tokens (plain versions, uncaptured rounds) for
    the same clips."""
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
    if engine._graphs is None or ("step", 4) not in engine._graphs:
        raise AssertionError("the card engine's round was not captured")
    pipe = WhisperPipeline(device="cpu", compute_dtype="float32", kv_quant=True,
                           self_kv_quant=True, max_tokens=12, params=params)
    want = [r.tokens.tolist() for r in pipe.transcribe_batch(clips)]
    if got != want:
        raise AssertionError(f"engine tokens on the card differ from the CPU pipeline's: "
                             f"{got} vs {want}")
    return {"phase": "serving_reference", "model": "tiny", "dtype": "float32",
            "tokens_equal_cpu_pipeline": True, "tokens": got}


def tp_reference_check(devices=("cuda:0", "cuda:0"), model: str = "tiny") -> dict:
    """A small fp32 engine (``model``, kvq + skvq) on a (1, len(devices))
    mesh of ``devices`` (by default two ranks on the card, 3 local heads of
    tiny's 6 each), rounds driven one tick at a time through the kernels on
    each rank's local heads, must give the one-rank engine's tokens on the
    CPU (plain versions) for the same clips. Before the clips the card's
    engine is warmed (``warmup()``): every rank's shard runs the round and
    each bucket's encode and detection step (the launches held exact), and
    the slot bookkeeping and cross-KV stay bit-equal. Where every rank is
    on one card the rounds replay a CUDA graph (the warm captures it), and
    the same engine with its rounds uncaptured must give the same
    tokens."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.ops.decode_attention import (
        cross_attention_decode_fd, self_attention_decode, self_attention_decode_int8)
    from whisper_tpu_torch.ops.flash_attention import flash_attention_btd
    from whisper_tpu_torch.ops.log10_mel import log10_mel
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.parallel.sharding import make_mesh
    from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    from whisper_tpu_torch.tokenizer import get_tokenizer

    class IdText:
        non_speech_tokens = get_tokenizer(num_languages=99).non_speech_tokens

        def decode(self, ids):
            return " ".join(str(int(t)) for t in ids)

    rng = np.random.default_rng(10)
    clips = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (4, 9, 2)]
    one_card = len({torch.device(d) for d in devices}) == 1
    out, graphs = {}, None
    runs = [("cuda_tp", make_mesh(1, len(devices), devices=list(devices))), ("cpu_tp1", None)]
    if one_card:
        runs.insert(1, ("cuda_tp_uncaptured", runs[0][1]))
    for where, mesh in runs:
        # the same CPU-drawn weights on both sides (CPU and CUDA generators differ)
        params = init_params(get_config(model), seed=3, device="cpu")
        if mesh is not None:
            params = params.to_device(devices[0])
        engine = ContinuousBatchingEngine(
            params, IdText(), max_slots=4, compute_dtype=torch.float32, steps_per_sync=4,
            max_tokens=12, kv_quant=True, self_kv_quant=True, no_speech_threshold=None,
            logprob_threshold=None, compression_ratio_threshold=None, mesh=mesh)
        if where == "cuda_tp_uncaptured":
            engine._graphs = None
        elif mesh is not None:
            kernels = (flash_attention_btd, log10_mel, cross_attention_decode_fd,
                       self_attention_decode_int8, self_attention_decode)
            before = _slot_state(engine)
            kv0 = [t.clone() for t in _cache_parts(engine.kv)]
            cross0 = [t.clone() for t in _cache_parts(engine.cross)]
            for fn in kernels:
                fn.launches = 0
            engine.warmup()
            warm = _warm_diff(engine, before, kv0, cross0)
            cfg, tp, nb, steps = engine.cfg, len(devices), len(engine.prefill_buckets), 4
            want = {"flash_attention_btd": cfg.n_audio_layer * nb * tp, "log10_mel": nb,
                    "cross_attention_decode_fd": cfg.n_text_layer * (steps + nb) * tp,
                    "self_attention_decode_int8": cfg.n_text_layer * steps * tp,
                    "self_attention_decode": cfg.n_text_layer * nb * tp}
            warm["warmup_launches"] = _launches(kernels)
            if warm["warmup_launches"] != want:
                raise AssertionError(f"tp warmup launches {warm['warmup_launches']}, "
                                     f"expected {want}")
        futs = [engine.submit(Request(audio=c)) for c in clips]
        for _ in range(50):
            if all(f.done() for f in futs):
                break
            engine._tick()
        out[where] = [f.result(0)["text"] for f in futs]
        if where == "cuda_tp":
            graphs = None if engine._graphs is None else engine._graphs.stats()
            if one_card and not (graphs and graphs["captures"] and graphs["replays"]):
                raise AssertionError(f"the one-card tp engine's rounds were not replayed: "
                                     f"{graphs}")
    for where in out:
        if out[where] != out["cpu_tp1"]:
            raise AssertionError(f"the tp {len(devices)} engine on {devices} ({where}) "
                                 f"differs from tp 1 on the CPU: {out}")
    return {"phase": "tp_reference", "model": model, "dtype": "float32",
            "mesh": f"(1, {len(devices)}) on {list(devices)}",
            "texts_equal_cpu_tp1": [w for w in out if w != "cpu_tp1"],
            "step_graphs": graphs,
            "tokens": [t.split() for t in out["cpu_tp1"]], "warmup": warm}


def ladder_reference_check() -> dict:
    """A small fp32 sampled decode (tiny, kvq + skvq, temperature 0.6) on
    the card (its rounds replayed as CUDA graphs) against the CPU
    (uncaptured), the same Gumbel draws handed to both through
    ``greedy_decode_kv``'s ``noise`` hook: equal tokens."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.decode import graph_stats, greedy_decode
    from whisper_tpu_torch.params import init_params

    rng = np.random.default_rng(11)
    cfg = get_config("tiny")
    mel = rng.standard_normal((3, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    prompt = np.tile(np.asarray([cfg.sot_sequence("en")], np.int64), (3, 1))
    draws = [np.random.default_rng(100 + i).gumbel(size=(3, cfg.n_vocab)).astype(np.float32)
             for i in range(16)]
    toks, graphs = {}, {}
    for dev in ("cuda", "cpu"):
        params = init_params(cfg, seed=3, device="cpu").to_device(dev)
        for _ in range(2):  # the second decode replays the first's graphs
            res = greedy_decode(params, torch.from_numpy(mel).to(dev),
                                torch.from_numpy(prompt).to(dev), kv_quant=True,
                                self_kv_quant=True, max_tokens=12, temperature=0.6,
                                noise=lambda step, shape, d=dev: torch.from_numpy(
                                    draws[step]).to(d))
        toks[dev], graphs[dev] = res.tokens.cpu().tolist(), graph_stats(params)
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError(f"sampled tokens on the card differ from the CPU: {toks}")
    if graphs["cpu"] is not None or not (graphs["cuda"] and graphs["cuda"]["replays"]):
        raise AssertionError(f"the card's sampled rounds replayed no graph: {graphs}")
    return {"phase": "ladder_reference", "model": "tiny", "dtype": "float32", "temperature": 0.6,
            "tokens_equal_cpu": True, "tokens": [t[4:] for t in toks["cuda"]],
            "card_graphs": graphs["cuda"]}


SELECTIONS = (("btd", "fd"), ("bhtd", "legacy"), ("bhtd", "dense"))


def reference_check() -> dict:
    """A small fp32 transcription (tiny, kvq + skvq) on the card through the
    kernels of each selection, its rounds replayed as CUDA graphs, must give
    the CPU pipeline's tokens (plain versions, uncaptured rounds) under the
    same selection."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.decode import graph_stats
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.pipeline import WhisperPipeline

    rng = np.random.default_rng(1)
    clips = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (4, 9)]
    out = {}
    for enc, dec in SELECTIONS:
        toks = {}
        for dev in ("cuda", "cpu"):
            # the same CPU-drawn weights on both sides (CPU and CUDA generators differ)
            params = init_params(get_config("tiny"), seed=3, device="cpu").to_device(dev)
            pipe = WhisperPipeline(device=dev, compute_dtype="float32", kv_quant=True,
                                   self_kv_quant=True, max_tokens=12, params=params,
                                   encoder_attention=enc, cross_decode=dec)
            toks[dev] = [r.tokens.tolist() for r in pipe.transcribe_batch(clips)]
            if (graph_stats(pipe.model) is None) != (dev == "cpu"):
                raise AssertionError(f"the {dev} decode's rounds: {graph_stats(pipe.model)}")
        if toks["cuda"] != toks["cpu"]:
            raise AssertionError(f"card and CPU tokens differ under ({enc}, {dec}): {toks}")
        out[f"{enc}+{dec}"] = toks["cuda"]
    return {"phase": "reference", "model": "tiny", "dtype": "float32",
            "card_rounds": "graphed", "tokens_equal_cpu": True, "tokens": out}


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
    _expect("longform", launches, cfg, stats["rounds"], stats["device_steps"])
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


# ------------------------------------------------------------- real weights
N_AUTO_REQUESTS = 8
N_EVAL_CLIPS = 8
GATE_ARGS = ["--model", "turbo", "--batch", "4", "--max_tokens", "16", "--device", "cuda"]
# the offline configuration, its ladder off: random weights would send every
# row up it five times
CHECKPOINT_PIPELINE = dict(model="turbo", device="cuda", compute_dtype="bfloat16", quantize=True,
                           w8a8=True, kv_quant=True, self_kv_quant=True, max_tokens=N_TOKENS,
                           language=None, temperature_fallback=False)
# detection, the kernels against their plain versions on the card (bf16
# activations and cache, fp32 logits), as log-probabilities and
# probabilities over the languages. The limits sit between the readings of a
# right kernel (outputs within a bf16 ulp of the plain versions': K2's and
# K3's bf16 TOL above) and a control, the plain versions with their outputs
# rounded to DETECT_CONTROL_BITS significant bits (16 bf16 ulps), which the
# check must catch (on an H100 at turbo B64, random weights: the kernels
# 0.026 nats and 6.4e-4, the control 0.117 nats and 3.7e-3). Ids must agree
# on every row whose top-2 margin exceeds twice the log-probability limit:
# no difference within it can swap them.
DETECT_LOGPROB_TOL = 6e-2
DETECT_PROB_TOL = 2e-3
DETECT_CONTROL_BITS = 4


def _write_openai_pt(model, path: str) -> int:
    """``model``'s weights as an OpenAI-layout checkpoint in fp16,
    ``{"dims", "model_state_dict"}`` (torch Linear (out, in), Conv1d (out,
    in, k)); returns the file's size in bytes."""
    cfg = model.cfg

    def h(t):
        return t.detach().to(torch.float16).contiguous().cpu()

    enc, dec = model.encoder, model.decoder
    sd = {"encoder.conv1.weight": h(enc.conv1["w"]), "encoder.conv1.bias": h(enc.conv1["b"]),
          "encoder.conv2.weight": h(enc.conv2["w"]), "encoder.conv2.bias": h(enc.conv2["b"]),
          "encoder.positional_embedding": h(enc.pos_emb),
          "encoder.ln_post.weight": h(enc.ln_post["g"]),
          "encoder.ln_post.bias": h(enc.ln_post["b"]),
          "decoder.token_embedding.weight": h(dec.tok_emb),
          "decoder.positional_embedding": h(dec.pos_emb),
          "decoder.ln.weight": h(dec.ln["g"]), "decoder.ln.bias": h(dec.ln["b"])}
    stems = {"attn": "attn", "cross": "cross_attn", "attn_ln": "attn_ln",
             "cross_ln": "cross_attn_ln", "mlp_ln": "mlp_ln"}
    proj = {"q": "query", "k": "key", "v": "value", "o": "out"}
    for part, blocks in (("encoder", enc.blocks), ("decoder", dec.blocks)):
        for i, blk in enumerate(blocks):
            pre = f"{part}.blocks.{i}"
            for sub, p in blk.sublayers().items():
                if sub.endswith("_ln"):
                    sd[f"{pre}.{stems[sub]}.weight"], sd[f"{pre}.{stems[sub]}.bias"] = \
                        h(p["g"]), h(p["b"])
                elif sub == "mlp":
                    for j, n in ((0, "1"), (2, "2")):
                        sd[f"{pre}.mlp.{j}.weight"] = h(p["w" + n].t())
                        sd[f"{pre}.mlp.{j}.bias"] = h(p["b" + n])
                else:
                    for key, val in p.items():
                        kind = "weight" if key[0] == "w" else "bias"
                        sd[f"{pre}.{stems[sub]}.{proj[key[1]]}.{kind}"] = h(
                            val.t() if kind == "weight" else val)
    dims = {k: getattr(cfg, k) for k in ("n_mels", "n_audio_ctx", "n_audio_state",
                                         "n_audio_head", "n_audio_layer", "n_vocab",
                                         "n_text_ctx", "n_text_state", "n_text_head",
                                         "n_text_layer")}
    torch.save({"dims": dims, "model_state_dict": sd}, path)
    return os.path.getsize(path)


def _round_fp16(model) -> None:
    """Every floating weight of ``model`` rounded to fp16 and back, in place:
    the numbers an fp16 checkpoint of it holds, without the loader."""
    for owner, key, val in model.leaves():
        val = val.half().float()
        if isinstance(owner, dict):
            owner[key] = val
        else:
            setattr(owner, key, val)


def _flat(tree, prefix: str = "") -> dict:
    """{dotted path: numpy array} of a JAX-layout tree (QTensors as their
    ``__q`` and ``__s`` parts)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if hasattr(tree, "q"):
        return {prefix + "__q": tree.q, prefix + "__s": tree.s}
    return {prefix.rstrip("."): tree}


def _snapshot_round_trip(model, folder: str) -> dict:
    """``save_params`` -> ``load_params`` of a pipeline's model (int8 QTensor
    leaves, bf16 floats, K-major payloads): bit-equal, weight by weight,
    once cast back to the model's float dtype (the snapshot holds bf16 as
    fp32)."""
    from whisper_tpu_torch.models.checkpoint import load_params, save_params
    from whisper_tpu_torch.models.model import cast_floating
    from whisper_tpu_torch.params import to_jax_params

    path = f"{folder}/snapshot.safetensors"
    t0 = time.perf_counter()
    save_params(path, model)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, cfg = load_params(path, device=model.device)
    cast_floating(back, model.decoder.tok_emb.dtype)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if cfg != model.cfg:
        raise AssertionError(f"snapshot config {cfg} is not the model's")
    # bf16 -> fp32 on the host is exact: equal arrays are bit-equal weights
    want, got = _flat(to_jax_params(model)), _flat(to_jax_params(back))
    changed = sorted(k for k in want if k not in got or got[k].dtype != want[k].dtype
                     or not np.array_equal(got[k], want[k]))
    if changed or got.keys() != want.keys():
        raise AssertionError(f"snapshot round trip changed {changed[:5]}")
    return {"bit_equal": True, "tensors": len(want), "bytes": os.path.getsize(path),
            "save_s": save_s, "load_s": load_s}


def checkpoint_phase(counters, folder: str):
    """The real-weights path at turbo's full width: the seeded turbo weights
    written as an OpenAI fp16 ``.pt``, ``WhisperPipeline(checkpoint=...,
    language=None)`` at the offline configuration built from it, warmed and
    run once over 64 clips with the counts at 0 (one encode, one detection
    step, the decode), and held against a pipeline built with ``params=``
    from the same weights rounded to fp16 in torch: equal languages and
    tokens. Then the snapshot round trip of the loaded, quantized model.
    Returns (record, the pipeline, the clips, the .pt's path)."""
    from whisper_tpu_torch.config import LANGUAGES, N_SAMPLES, get_config
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.pipeline import WhisperPipeline

    cfg = get_config(CHECKPOINT_PIPELINE["model"])
    path = f"{folder}/{cfg.name}.pt"
    model = init_params(cfg, seed=0, device=CHECKPOINT_PIPELINE["device"])
    t0 = time.perf_counter()
    nbytes = _write_openai_pt(model, path)
    write_s = time.perf_counter() - t0
    _round_fp16(model)
    t0 = time.perf_counter()
    pipe = WhisperPipeline(checkpoint=path, **CHECKPOINT_PIPELINE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mem = WhisperPipeline(params=model, **CHECKPOINT_PIPELINE)
    del model
    rng = np.random.default_rng(12)
    clips = list(rng.standard_normal((B, N_SAMPLES)).astype(np.float32) * 0.1)
    pipe.transcribe_batch(clips)  # warm
    mem.transcribe_batch(clips)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    results = pipe.transcribe_batch(clips)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(counters)
    dec = pipe.last_decode
    want = mem.transcribe_batch(clips)
    langs = [r.language for r in results]
    if langs != [r.language for r in want] or not set(langs) <= set(LANGUAGES):
        raise AssertionError(f"languages from the .pt {langs} differ from the in-memory "
                             f"weights' {[r.language for r in want]}")
    if not torch.equal(dec.tokens, mem.last_decode.tokens):
        rows = (dec.tokens != mem.last_decode.tokens).any(dim=1).nonzero()[:, 0].tolist()
        raise AssertionError(f"tokens from the .pt differ from the in-memory weights' on "
                             f"rows {rows}")
    del mem
    torch.cuda.empty_cache()
    _expect("checkpoint", launches, pipe.cfg, 1, dec.device_steps, detects=1)
    snapshot = _snapshot_round_trip(pipe.model, folder)
    audio_s = B * N_SAMPLES / 16000
    rec = {"phase": "checkpoint", "model": cfg.name, "file": "OpenAI .pt, fp16, with dims",
           "file_bytes": nbytes, "write_s": write_s, "load_s": load_s,
           "batch": B, "max_tokens": N_TOKENS, "dtype": "bfloat16",
           "quant": "int8 weights + w8a8 encoder + kvq + skvq", "language": "auto",
           "wall_s": wall, "audio_s_per_s": audio_s / wall, "decode_steps": dec.steps,
           "languages": sorted(set(langs)), "tokens_equal_in_memory": True,
           "languages_equal_in_memory": True, "launches": launches, "snapshot": snapshot}
    return rec, pipe, clips, path


def _round_significand(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded to ``bits`` significant bits (bf16 keeps 8)."""
    m, e = torch.frexp(x.float())
    return torch.ldexp(torch.round(m * 2 ** bits) / 2 ** bits, e).to(x.dtype)


class _PlainDecodeKernels:
    """Within the block the model's decode step calls the plain versions of
    K2 and the float K3 (on CUDA tensors too), their outputs rounded to
    ``bits`` significant bits where given (the control)."""

    def __init__(self, bits: int | None = None):
        self.bits = bits

    def __enter__(self):
        from whisper_tpu_torch.models import model as mm
        from whisper_tpu_torch.ops import decode_attention as da

        def coarse(fn):
            return fn if self.bits is None else (
                lambda *a, **kw: _round_significand(fn(*a, **kw), self.bits))

        self.mm = mm
        self.saved = (mm.cross_attention_decode_fd, mm.self_attention_decode)
        mm.cross_attention_decode_fd = coarse(da.cross_attention_decode_fd_plain)
        mm.self_attention_decode = coarse(da.self_attention_decode_plain)
        return self

    def __exit__(self, *exc):
        self.mm.cross_attention_decode_fd, self.mm.self_attention_decode = self.saved


def _detect_errors(idx, p, idx_ref, p_ref) -> dict:
    """How far a detection's (ids, probabilities) lie from the plain
    versions': the largest log-probability and probability differences, and
    the ids on the rows clear of a tie at the log-probability limit."""
    lp, lp_ref = (torch.log(q.clamp_min(1e-30)) for q in (p, p_ref))
    top2 = torch.topk(lp_ref, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    equal = (idx == idx_ref).cpu().numpy()
    clear = margin > 2 * DETECT_LOGPROB_TOL
    return {"log_prob_max_abs_err": float((lp - lp_ref).abs().max()),
            "prob_max_abs_err": float((p - p_ref).abs().max()),
            "rows_clear_of_ties": int(clear.sum()),
            "ids_differ_on_clear_rows": np.nonzero(clear & ~equal)[0].tolist(),
            "near_tie_rows": [{"row": int(r), "margin": float(margin[r]), "equal": bool(equal[r])}
                              for r in np.nonzero(~clear)[0]]}


def _within(err: dict) -> bool:
    return (err["log_prob_max_abs_err"] <= DETECT_LOGPROB_TOL
            and err["prob_max_abs_err"] <= DETECT_PROB_TOL and not err["ids_differ_on_clear_rows"])


def language_detect(pipe, clips) -> dict:
    """``detect_language_kv`` on the int8 cross-KV of the 64 clips, with the
    kernels (K2, the float K3), with their plain versions, and with the
    control (the plain versions' outputs rounded to
    ``DETECT_CONTROL_BITS`` significant bits), on the card: the kernels'
    log-probabilities within ``DETECT_LOGPROB_TOL`` of the plain versions',
    probabilities within ``DETECT_PROB_TOL``, ids equal on every row clear
    of a tie (the others reported with their margins: the near-tie hazard,
    ROADMAP section 3); the control must break a limit, or the check could
    not tell a wrong kernel from a right one."""
    from whisper_tpu_torch.decode import detect_language_kv, encode_cross_kv
    from whisper_tpu_torch.ops.mel import log_mel_batch

    cfg = pipe.cfg
    batch, lengths = pipe._prepare_batch(clips)
    mel = log_mel_batch(batch, lengths, n_mels=cfg.n_mels)[..., : 2 * cfg.n_audio_ctx]
    cross = encode_cross_kv(pipe.model, mel, torch.bfloat16, kv_quant=True, w8a8=True)

    def detect():
        return detect_language_kv(pipe.model, cross, torch.bfloat16)

    idx_k, p_k = detect()
    ms = cuda_ms(detect, reps=10)
    with _PlainDecodeKernels():
        idx_p, p_p = detect()
        plain_ms = cuda_ms(detect, reps=10)
    with _PlainDecodeKernels(DETECT_CONTROL_BITS):
        control = _detect_errors(*detect(), idx_p, p_p)
    err = _detect_errors(idx_k, p_k, idx_p, p_p)
    if not _within(err):
        raise AssertionError(f"language detection with the kernels differs from the plain "
                             f"versions: {err}")
    if _within(control):
        raise AssertionError(f"the control ({DETECT_CONTROL_BITS} significant bits) passes "
                             f"the detection check, which cannot fail: {control}")
    return {"phase": "language_detect", "model": cfg.name, "batch": B, "dtype": "bfloat16",
            "cross_kv": "int8", **err, "log_prob_tol_abs": DETECT_LOGPROB_TOL,
            "prob_tol_abs": DETECT_PROB_TOL, "ids_equal_on_clear_rows": True,
            "control": {"significant_bits": DETECT_CONTROL_BITS,
                        **{k: v for k, v in control.items() if k != "near_tie_rows"}},
            "step_ms": ms, "step_plain_ms": plain_ms,
            "times": "ms: CUDA events around one detection step (K2 + float K3 once a layer, "
                     "4 layers, logits); plain_ms: the same with their plain versions"}


def eval_phase(pt_path: str, folder: str) -> list:
    """The WER entry point at turbo, in-process, with the ``.pt`` and
    ``--language zh`` over a synthetic AIShell-format set of 8 seeded noise
    WAVs (random weights: the WER means nothing, a finite one is the check);
    then the quantization gate at turbo, B4, 16 steps, every variant, whose
    fp32 control must read zero."""
    import contextlib
    import io

    from whisper_tpu_torch.eval import quant_gate
    from whisper_tpu_torch.eval.__main__ import main as eval_main

    wav_dir = f"{folder}/aishell_S0764"
    os.makedirs(wav_dir)
    rng = np.random.default_rng(13)
    lines = []
    for i, sec in enumerate(rng.uniform(2.0, 10.0, N_EVAL_CLIPS)):
        with open(f"{wav_dir}/BAC{i:05d}.wav", "wb") as f:
            f.write(_wav(rng.standard_normal(_n_samples(sec)) * 0.1))
        lines.append(f"BAC{i:05d} 测试句子{i}")
    with open(f"{folder}/ground_truth.txt", "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    argv = ["--dataset", "aishell", "--gt_path", f"{folder}/ground_truth.txt",
            "--model_type", CHECKPOINT_PIPELINE["model"], "--checkpoint", pt_path,
            "--language", "zh", "--device", CHECKPOINT_PIPELINE["device"],
            "--batch", str(N_EVAL_CLIPS),
            "--log", f"{folder}/test_wer.log", "--out", f"{folder}/wer.txt"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its per-utterance log lines
        rc = eval_main(argv)
    wall = time.perf_counter() - t0
    with open(f"{folder}/wer.txt") as f:
        wer = float(f.read())
    if rc != 0 or not math.isfinite(wer):
        raise AssertionError(f"whisper_tpu_torch.eval returned {rc}, WER {wer}")
    torch.cuda.empty_cache()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        gate_rc = quant_gate.main(GATE_ARGS)
    gate_s = time.perf_counter() - t0
    gate = json.loads(out.getvalue().strip().splitlines()[-1])
    fp32 = gate["fp32"]
    if not (fp32["kl_mean_nats"] < 1e-6 and fp32["top1_agreement"] == 1.0):
        raise AssertionError(f"the gate's fp32 control is not zero on the card: {fp32}")
    return [{"phase": "eval", "entry": "whisper_tpu_torch.eval.__main__.main",
             "args": [a.replace(folder, "<tmp>") for a in argv], "clips": N_EVAL_CLIPS,
             "wer": wer, "wall_s": wall,
             "note": "random weights: the WER value means nothing"},
            {"phase": "quant_gate", "entry": "whisper_tpu_torch.eval.quant_gate.main",
             "args": GATE_ARGS, "rc": gate_rc, "wall_s": gate_s, **gate}]


def serving_auto(counters) -> dict:
    """8 clips with ``language=auto`` to the in-process turbo server (greedy
    core): every reply names a language of the table, and each admission
    batch ran one detection step (the float K3 and the decode kernel once a
    layer, counted exactly by ``_expect``)."""
    from whisper_tpu_torch.config import LANGUAGES

    rec = serving(counters, GREEDY, N_AUTO_REQUESTS, phase="serving_auto", language="auto")
    if not set(rec["languages"]) <= set(LANGUAGES):
        raise AssertionError(f"replies name languages outside the table: {rec['languages']}")
    if rec["detect_batches"] != rec["admission_batches"]:
        raise AssertionError(f"{rec['detect_batches']} detection steps for "
                             f"{rec['admission_batches']} admission batches of auto rows")
    return rec


def language_reference_check() -> dict:
    """Tiny fp32 detection against the int8 cross-KV (K2 and the float K3 on
    the card, their plain versions on the CPU): equal ids, probabilities
    within 1e-4 (fp32, another summation order)."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.decode import detect_language_kv, encode_cross_kv
    from whisper_tpu_torch.params import init_params

    cfg = get_config("tiny")
    mel = np.random.default_rng(14).standard_normal(
        (4, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        # the same CPU-drawn weights on both sides (CPU and CUDA generators differ)
        model = init_params(cfg, seed=3, device="cpu").to_device(dev)
        cross = encode_cross_kv(model, torch.from_numpy(mel).to(dev), kv_quant=True)
        out[dev] = [t.cpu() for t in detect_language_kv(model, cross)]
    err = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    if not torch.equal(out["cuda"][0], out["cpu"][0]) or err > 1e-4:
        raise AssertionError(f"detection on the card differs from the CPU: ids "
                             f"{out['cuda'][0].tolist()} vs {out['cpu'][0].tolist()}, "
                             f"probabilities by {err}")
    return {"phase": "language_reference", "model": "tiny", "dtype": "float32",
            "ids_equal_cpu": True, "prob_max_abs_err": err, "tol_abs": 1e-4,
            "ids": out["cuda"][0].tolist()}


def serving_auto_reference_check() -> dict:
    """A tiny fp32 engine (kvq + skvq) given ``language="auto"`` requests on
    the card and on the CPU, rounds driven one tick at a time: equal
    languages and texts."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    from whisper_tpu_torch.tokenizer import get_tokenizer

    class IdText:
        non_speech_tokens = get_tokenizer(num_languages=99).non_speech_tokens

        def decode(self, ids):
            return " ".join(str(int(t)) for t in ids)

    rng = np.random.default_rng(15)
    clips = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (4, 9, 2)]
    out = {}
    for dev in ("cuda", "cpu"):
        engine = ContinuousBatchingEngine(
            init_params(get_config("tiny"), seed=3, device="cpu").to_device(dev), IdText(),
            max_slots=4, compute_dtype=torch.float32, steps_per_sync=4, max_tokens=12,
            kv_quant=True, self_kv_quant=True, no_speech_threshold=None,
            logprob_threshold=None, compression_ratio_threshold=None)
        futs = [engine.submit(Request(audio=c, language="auto")) for c in clips]
        for _ in range(50):
            if all(f.done() for f in futs):
                break
            engine._tick()
        out[dev] = [(f.result(0)["language"], f.result(0)["text"]) for f in futs]
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"language=auto replies on the card differ from the CPU: {out}")
    return {"phase": "serving_auto_reference", "model": "tiny", "dtype": "float32",
            "languages_and_texts_equal_cpu": True, "replies": out["cuda"]}


N_OPTION_SHORT = 8
PACED_FLAGS = ("--encode_chunks", "4", "--adaptive_sync")
N_TIMESTAMP_REQUESTS = 8
# initial_prompt texts of about 4, 30 and 90 tokens, and one far past the
# turbo server's context cap (min(n_text_ctx // 2 - 1, kv_ctx - 13) = 223)
PROMPTS = tuple(" ".join(f"word{i}" for i in range(n)) for n in (2, 15, 45, 400))


def serving_options(counters) -> dict:
    """The server's greedy options at turbo (its defaults, the ladder off):
    one burst from client threads of 8 clips of 2-30 s, 2 of 60-90 s fanned
    out into windows, 2 of 60-90 s with ``condition_on_previous=1``, 4 with
    ``initial_prompt`` of about 4, 30, 90 and (capped) 223 tokens, 2 with
    ``stream=1`` (one of 60-90 s) and 2 with ``format=txt``; exact launches
    (every window is an admission row; the prompted rows decode behind
    per-slot pads). Then, alone on the idle server, a short clip streamed
    and the same clip as JSON: the final NDJSON line must equal the reply
    (one admission of one row each, so the same shapes on the card)."""
    from whisper_tpu_torch.longform import plan_chunks
    from whisper_tpu_torch.serving.engine import Request

    rng = np.random.default_rng(11)

    def noise(lo, hi):
        return (rng.standard_normal(int(16000 * rng.uniform(lo, hi))) * 0.1).astype(np.float32)

    jobs = [("short", noise(2, 30), {}) for _ in range(N_OPTION_SHORT)]
    jobs += [("long", noise(60, 90), {}) for _ in range(2)]
    jobs += [("conditioned", noise(60, 90), {"condition_on_previous": 1}) for _ in range(2)]
    jobs += [("prompted", noise(2, 30), {"initial_prompt": text}) for text in PROMPTS]
    jobs += [("stream", noise(2, 30), {"stream": 1}), ("stream", noise(60, 90), {"stream": 1})]
    jobs += [("txt", noise(2, 30), {"format": "txt"}) for _ in range(2)]
    engine, base, args, srv, thread, _, startup_s = _started(GREEDY)
    url = f"{base}/asr"
    try:
        st0 = engine.stats.snapshot()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs)) as pool:
            replies = list(pool.map(lambda job: _ask(url, job[1], job[2]), jobs))
        wall = time.perf_counter() - t0
        launches = _launches(counters)
        st1 = engine.stats.snapshot()
        twin = noise(2, 30)
        alone = [_ask(url, twin, {"stream": 1}), _ask(url, twin)]
    finally:
        _stopped(engine, srv, thread)
    bad = [(kind, code, str(reply)[:300]) for (kind, _, _), (code, reply, _) in zip(jobs, replies)
           if code != 200]
    if bad:
        raise AssertionError(f"{len(bad)} of {len(jobs)} option requests failed: {bad[:3]}")
    delta = _served_counts(engine, args, st0, st1, launches, "serving_options")
    out = {"short": [], "long": [], "conditioned": [], "prompted": [], "stream": [], "txt": []}
    for (kind, clip, _), (_, reply, sec) in zip(jobs, replies):
        out[kind].append((clip, reply, sec))
    windows = {}
    for kind in ("long", "conditioned"):
        windows[kind] = [r["windows"] for _, r, _ in out[kind]]
        want = [len(plan_chunks(len(c), 480000, engine.longform_overlap))
                for c, _, _ in out[kind]]
        if windows[kind] != want or any(bool(r.get("conditioned")) != (kind == "conditioned")
                                        for _, r, _ in out[kind]):
            raise AssertionError(f"{kind} replies: windows {windows[kind]}, expected {want}")
    partials, stream_tokens = [], []
    spr = engine.steps_per_sync
    for clip, lines, _ in out["stream"]:
        *parts, final = lines
        # a window's first harvest follows its prefill token and one round of
        # steps_per_sync steps, so a window that ends within that round
        # streams no partial (as in the JAX engine): a reply of more tokens
        # than a round per window must have partials, and one of at most a
        # round's tokens must have none
        n_tok, n_win = final.get("tokens", 0), final.get("windows", 1)
        if any("partial" not in p for p in parts) or not final.get("success") \
                or ("windows" in final) != (len(clip) > 480000) \
                or (n_tok > spr * n_win and not parts) or (parts and n_tok <= spr):
            raise AssertionError(f"a streamed reply is malformed ({spr} steps a round): "
                                 f"{str(lines)[:300]}")
        partials.append(len(parts))
        stream_tokens.append(n_tok)
    if not all(isinstance(t, str) and t.endswith("\n") for _, t, _ in out["txt"]):
        raise AssertionError(f"format=txt bodies: {[t for _, t, _ in out['txt']]}")
    (code_s, lines, _), (code_j, reply, _) = alone
    drop = ("wall_seconds", "rtf")
    final = {k: v for k, v in lines[-1].items() if k not in drop}
    if code_s != 200 or code_j != 200 or final != {k: v for k, v in reply.items()
                                                   if k not in drop}:
        raise AssertionError(f"the streamed reply's final line differs from the JSON reply: "
                             f"{lines[-1]} vs {reply}")
    lat = np.array([sec for _, _, sec in replies])
    return {"phase": "serving_options", "model": "turbo",
            "flags": "server defaults, --temperature_fallback ''",
            "requests": {k: len(v) for k, v in out.items()}, "startup_s": startup_s,
            "wall_s": wall, "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p95_s": float(np.percentile(lat, 95)),
            "latency_by_kind_s": {k: [sec for _, _, sec in v] for k, v in out.items()},
            "audio_s": sum(len(c) for _, c, _ in jobs) / 16000, "windows": windows,
            "partials_per_stream": partials, "tokens_per_stream": stream_tokens,
            "stream_final_equals_json": True,
            "prompt_tokens": [len(engine._context_ids(Request(audio=twin, initial_prompt=text)))
                              for text in PROMPTS],
            "ticks": delta["ticks_total"], "steps": delta["steps_total"],
            "admission_batches": delta["encode_batches_total"],
            "round_sizes": delta["round_sizes"], "partials": delta["partials_total"],
            "launches": launches}


def serving_timestamps(counters) -> dict:
    """8 clips of 2-30 s to the turbo server started with ``--timestamps``
    (ladder off): exact launches, and every text opens with a timestamp
    token, as the grammar forces (unless the silence gate emptied it)."""
    rec = serving(counters, GREEDY + ("--timestamps",), N_TIMESTAMP_REQUESTS,
                  phase="serving_timestamps", keep_engine=True)
    rec, _, _, replies = rec
    off = [r for r in replies if not r["text"].startswith("<|")
           and not (r["text"] == "" and r["no_speech_prob"] > 0.6)]
    if off:
        raise AssertionError(f"timestamp-mode texts without a leading timestamp: {off[:2]}")
    rec["texts_head"] = [r["text"][:40] for r in replies]
    return rec


def serving_paced(counters) -> dict:
    """The 24-clip burst of ``serving`` with the encode thread pacing a
    4-group admission encode (``--encode_chunks 4``) and adaptive rounds
    (``--adaptive_sync``): wall, latencies, the round sizes used and the
    group times measured; then one bucket of 8 clips encoded by the stopped
    engine both ways, whose int8 cross-KV must be bit-equal."""
    from whisper_tpu_torch.serving.engine import Request

    rec, engine, clips, _ = serving(counters, GREEDY + PACED_FLAGS, phase="serving_paced",
                                    keep_engine=True)
    reqs = [Request(audio=c) for c in clips[:8]]
    seg = engine._encode(reqs, 8)
    engine.encode_chunks = 1
    mono = engine._encode(reqs, 8)
    torch.cuda.synchronize()
    differ = [i for i, (a, b) in enumerate(zip(seg, mono)) if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"segmented encode differs from the monolithic one in parts {differ}")
    rec.update({"segmented_cross_kv_bit_equal": True, "encode_groups": 4,
                "encode_group_layers": [round(i * L_AUDIO / 4) for i in range(5)]})
    return rec


def serving_options_reference_check() -> dict:
    """A tiny fp32 engine (kvq + skvq, timestamps on) on the card and on the
    CPU, rounds driven one tick at a time: two prompted rows (one at the
    context cap, so pads > 0 in K3), an unprompted one and a 40 s clip fanned
    out into two windows; equal tokens."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    from whisper_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(num_languages=99)

    class IdText:
        non_speech_tokens = tok.non_speech_tokens
        encode = staticmethod(tok.encode)

        def decode(self, ids):
            return " ".join(str(int(t)) for t in ids)

        decode_with_timestamps = decode

    rng = np.random.default_rng(17)
    clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in (4, 9, 2, 40)]
    prompts = ["hello there", " ".join(f"word{i}" for i in range(300)), None, None]
    out, pads = {}, {}
    for dev in ("cuda", "cpu"):
        engine = ContinuousBatchingEngine(
            init_params(get_config("tiny"), seed=3, device="cpu").to_device(dev), IdText(),
            max_slots=4, compute_dtype=torch.float32, steps_per_sync=4, max_tokens=12,
            kv_quant=True, self_kv_quant=True, timestamps=True, no_speech_threshold=None,
            logprob_threshold=None, compression_ratio_threshold=None)
        futs = [engine.submit(Request(audio=c, initial_prompt=p)) for c, p in zip(clips, prompts)]
        pads[dev] = set()
        for _ in range(80):
            if all(f.done() for f in futs):
                break
            engine._tick()
            pads[dev] |= set(engine._slot_pad)
        out[dev] = [f.result(0)["text"] for f in futs]
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"option replies on the card differ from the CPU: {out}")
    if max(pads["cuda"]) == 0:
        raise AssertionError("no prompted row decoded behind a pad")
    return {"phase": "serving_options_reference", "model": "tiny", "dtype": "float32",
            "tokens_equal_cpu": True, "pads_seen": sorted(pads["cuda"]), "texts": out["cuda"]}

# ------------------------------------------------------------------ beams
N_BEAM_CLIPS = 16
BEAM_SIZE = 5
N_BEAM_REQUESTS = 8
# the beam path's pipeline: the offline configuration with the ladder off,
# as benchmarks/beam_bench.py documents it (--model turbo --batch 16 --beam 5
# --kv_quant), with the offline path's int8 self-KV and W8A8 encoder
BEAM_PIPELINE = dict(model="turbo", device="cuda", compute_dtype="bfloat16", quantize=True,
                     w8a8=True, kv_quant=True, self_kv_quant=True, max_tokens=N_TOKENS, seed=0,
                     temperature_fallback=False)


def _beam_step_parts(pipe, dev) -> dict:
    """The beam step's own work beside its kernels, each timed alone at the
    beam phase's shapes (CUDA events): the reorder (``_gather_cache``: the
    int8 self-KV of 80 beams gathered at their parents into the loop's
    second cache, the cache read once and written once: its bytes bound)
    and the step's three top-k sorts (16 rows of 5 x 51,866 candidates,
    then the finished and the running sets). Then
    one layer-step's cross-attention two ways: the path's folded plain
    ``attention_int8kv`` (16 utterances x 5 query rows against the shared
    int8 cross-KV) and K2 over the same 80 query rows on cross-KV expanded
    per beam (``index_cross_kv``'s layout, 5 x the bytes), held against
    each other at K2's bf16 tolerance."""
    from whisper_tpu_torch.beam import _gather_cache, _top_k
    from whisper_tpu_torch.models.model import _fold_beams, _unfold_beams, attention_int8kv
    from whisper_tpu_torch.models.model import new_kv_cache
    from whisper_tpu_torch.ops.decode_attention import cross_attention_decode_fd

    cfg = pipe.cfg
    Bu, K = N_BEAM_CLIPS, BEAM_SIZE
    N = Bu * K
    gen = torch.Generator(device=dev).manual_seed(37)
    P = len(cfg.sot_sequence(pipe.language, pipe.task))
    kv_ctx = min(cfg.n_text_ctx, -(-(P + N_TOKENS) // 128) * 128)
    kv = new_kv_cache(pipe.model, N, pipe.compute_dtype, kv_ctx, quant=True)
    parents = torch.randint(0, K, (Bu, K), generator=gen, device=dev)
    flat = (torch.arange(Bu, device=dev)[:, None] * K + parents).reshape(N)
    spare = type(kv)(*(torch.empty_like(t) for t in kv))
    kv_bytes = sum(t.numel() * t.element_size() for t in kv)
    reorder_ms = cuda_ms(lambda: _gather_cache(kv, spare, flat), reps=20)
    cand = torch.randn((Bu, K * cfg.n_vocab), generator=gen, device=dev)
    fin = torch.randn((Bu, 3 * K), generator=gen, device=dev)
    run = torch.randn((Bu, 2 * K), generator=gen, device=dev)
    topk_ms = cuda_ms(lambda: (_top_k(cand, 2 * K), _top_k(fin, K), _top_k(run, K)), reps=20)
    del kv, spare

    k_q, k_s, v_q, v_s = _int8_cross_kv(dev, gen, Bu, H_TEXT)
    q = torch.randn((N, H_TEXT, 1, DH), generator=gen, device=dev).to(torch.bfloat16)
    idx = torch.arange(Bu, device=dev).repeat_interleave(K)
    expanded = tuple(t.index_select(0, idx) for t in (k_q, k_s, v_q, v_s))

    def folded():
        return _unfold_beams(attention_int8kv(_fold_beams(q, K), k_q, k_s, v_q, v_s), K)

    agree = check("cross_attention_decode_fd/bf16", cross_attention_decode_fd(q, *expanded),
                  folded())
    fold_ms = cuda_ms(folded, reps=20)
    k2_ms = cuda_ms(lambda: cross_attention_decode_fd(q, *expanded), reps=20)
    fold_bytes = sum(t.numel() * t.element_size() for t in (k_q, k_s, v_q, v_s))
    expanded_bytes = sum(t.numel() * t.element_size() for t in expanded)
    del expanded
    return {"reorder_ms": reorder_ms, "reorder_bytes": 2 * kv_bytes,
            "reorder_bound_ms": 1e3 * 2 * kv_bytes / PEAK_BYTES,
            "topk_ms": topk_ms, "topk_shape": f"({Bu}, {K * cfg.n_vocab}) fp32 + two small",
            "fold_ms": fold_ms, "k2_expanded_ms": k2_ms,
            "fold_vs_k2_max_abs_err": agree["max_abs_err"],
            "fold_shape": f"q ({Bu},{H_TEXT},{K},{DH}) bf16 vs k_q/v_q ({Bu},{H_TEXT},{DH},"
                          f"{T_AUDIO}) int8", "cross_kv_bytes_per_layer": fold_bytes,
            "expanded_cross_kv_bytes_per_layer": expanded_bytes,
            "timing": "CUDA events over 20 calls each, one layer-step for the cross-attention"}


def beam_phase(counters) -> dict:
    """The beam path: 16 seeded 30 s noise clips through
    ``WhisperPipeline(beam_size=5).transcribe_batch`` (``BEAM_PIPELINE``):
    built, warmed, run once with the counts at 0 and checked (exact
    launches: the encoder's as offline, the int8 K3 once a layer a beam
    step the card ran, no cross-attention kernel), its wall beside the
    greedy wall of the same clips in the same process, then
    :func:`_beam_loops` and :func:`_beam_step_parts`."""
    from whisper_tpu_torch.beam import BeamResult
    from whisper_tpu_torch.config import N_SAMPLES
    from whisper_tpu_torch.pipeline import WhisperPipeline

    t0 = time.perf_counter()
    pipe = WhisperPipeline(beam_size=BEAM_SIZE, **BEAM_PIPELINE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(17)
    clips = list(rng.standard_normal((N_BEAM_CLIPS, N_SAMPLES)).astype(np.float32) * 0.1)
    pipe.transcribe_batch(clips)  # warm
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = pipe.transcribe_batch(clips)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dec, cfg = pipe.last_decode, pipe.cfg
    P = len(cfg.sot_sequence(pipe.language, pipe.task))
    lens, toks = dec.lengths.cpu().numpy(), dec.all_tokens.cpu().numpy()
    if not isinstance(dec, BeamResult) or len(results) != N_BEAM_CLIPS:
        raise AssertionError(f"the beam path returned {type(dec).__name__}, {len(results)} texts")
    if toks.shape != (N_BEAM_CLIPS, BEAM_SIZE, cfg.n_text_ctx):
        raise AssertionError(f"finished set of shape {toks.shape}")
    if not ((lens >= P) & (lens <= P + N_TOKENS)).all():
        raise AssertionError(f"beam lengths out of range: {lens.tolist()}")
    if not ((toks >= 0) & (toks < cfg.n_vocab)).all():
        raise AssertionError("beam token ids out of the vocabulary")
    if not (torch.isfinite(dec.scores).all() and torch.isfinite(dec.no_speech_prob).all()):
        raise AssertionError("non-finite beam scores")
    _expect("beam", launches, cfg, 1, 0, beam_steps=dec.device_steps)

    pipe.beam_size = 0  # greedy on the same clips, the same process
    pipe.transcribe_batch(clips)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.transcribe_batch(clips)
    torch.cuda.synchronize()
    greedy_wall = time.perf_counter() - t0
    greedy = pipe.last_decode
    pipe.beam_size = BEAM_SIZE
    loops = _beam_loops(counters, pipe, clips)
    parts = _beam_step_parts(pipe, pipe.device)
    finished = (dec.all_scores > -5e29).sum(dim=1).cpu().tolist()
    del pipe
    return {"phase": "beam", "model": "turbo", "batch": N_BEAM_CLIPS, "beam_size": BEAM_SIZE,
            "max_tokens": N_TOKENS, "dtype": "bfloat16",
            "quant": "int8 weights + w8a8 encoder + kvq + skvq", "ladder": False,
            "init_s": init_s, "wall_s": wall, "steps": dec.steps, "host_syncs": dec.host_syncs,
            "device_steps": dec.device_steps, "loops": loops,
            "greedy_wall_s": greedy_wall, "greedy_steps": greedy.steps,
            "beam_over_greedy": wall / greedy_wall, "generated": (lens - P).tolist(),
            "finished_per_clip": finished, "launches": launches, "peak_mem_gb": peak_gb,
            **parts}


BEAM_FIELDS = ("tokens", "lengths", "scores", "all_tokens", "all_scores", "no_speech_prob")


def _beam_loops(counters, pipe, clips) -> dict:
    """The beam path's loop on its own (its inputs caught from
    ``transcribe_batch``), three ways on the same cross-KV: the graphed
    ``beam_search_kv``, the same rounds uncaptured (``beam._beam_rounds(
    graphed=False)``) and the loop the rounds replaced
    (:func:`_stepwise_beam`). Every result tensor bit-equal across the
    three, the trip counts equal, launches exact (K3 once a layer a step
    the card ran), walls, the host's CUDA launch calls of the graphed
    decode (torch.profiler; profiling an uncaptured one costs 15-20 s
    for ~38,000 calls), and the model's graphs (captures, replays)."""
    from whisper_tpu_torch import beam
    from whisper_tpu_torch.decode import graph_stats

    model, cross, prompt, dt, kw = _greedy_args(pipe, clips, "beam_search_kv")
    cfg = model.cfg
    rounds_args = (model, cross, prompt, dt, kw["beam_size"], kw.get("max_tokens"),
                   kw.get("suppress_ids"), kw.get("timestamps", False),
                   kw.get("apply_filters", True), kw.get("length_penalty"),
                   kw.get("prompt_pad"), kw.get("sot_index", 0), kw.get("self_kv_quant", False),
                   kw.get("gelu", "erf"))
    ways = {"graphed": lambda: beam.beam_search_kv(model, cross, prompt, dt, **kw),
            "uncaptured": lambda: beam._beam_rounds(*rounds_args, False),
            "stepwise": lambda: _stepwise_beam(model, cross, prompt, dt, **kw)}
    rec, results = _three_ways(
        "beam loop", ways, counters,
        lambda what, launches, res: _expect(what, launches, cfg, 0, 0,
                                            beam_steps=res.device_steps),
        profiled=("graphed",))
    for way in ("uncaptured", "stepwise"):
        _bit_equal(f"beam loop: graphed against {way}", results["graphed"], results[way],
                   BEAM_FIELDS)
    rec["bit_equal"] = {"uncaptured": list(BEAM_FIELDS), "stepwise": list(BEAM_FIELDS)}
    rec["graphs"] = graph_stats(model)
    if not rec["graphs"]["replays"]:
        raise AssertionError(f"the beam loop replayed no graph: {rec['graphs']}")
    return rec


def serving_beam(counters) -> dict:
    """The turbo server at its defaults with the ladder off (the greedy
    core), one burst from client threads of 8 noise clips of 2-30 s at
    ``beam=5`` (half as a multipart field, half as ``X-Beam``) among 16
    greedy ones: every beam reply names ``beam_size`` 5 and no greedy one
    does, ``beam_requests_total`` grows by 8, and the launches are exact
    (slot steps run K2 and K3, the aux worker's beam steps K3 alone); the
    aux worker's beam rounds replay CUDA graphs (``aux_graphs``)."""
    from whisper_tpu_torch.decode import graph_stats

    rng = np.random.default_rng(23)
    clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in rng.uniform(2.0, 30.0, N_REQUESTS)]
    beam = set(range(0, 3 * N_BEAM_REQUESTS, 3))  # every third request

    def ask(i):
        if i not in beam:
            return _ask(url, clips[i])
        if i % 2:
            return _ask(url, clips[i], headers={"X-Beam": str(BEAM_SIZE)})
        return _ask(url, clips[i], multipart=True, fields={"beam": BEAM_SIZE})

    engine, base, args, srv, thread, _, startup_s = _started(GREEDY)
    url = f"{base}/asr"
    try:
        st0 = engine.stats.snapshot()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_REQUESTS) as pool:
            replies = list(pool.map(ask, range(N_REQUESTS)))
        wall = time.perf_counter() - t0
        launches = _launches(counters)
        st1 = engine.stats.snapshot()
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            metrics = json.load(r)
    finally:
        _stopped(engine, srv, thread)
    bad = [(i, code, str(reply)[:300]) for i, (code, reply, _) in enumerate(replies)
           if code != 200 or not reply.get("success")
           or reply.get("beam_size") != (BEAM_SIZE if i in beam else None)]
    if bad:
        raise AssertionError(f"{len(bad)} of {N_REQUESTS} replies failed: {bad[:3]}")
    delta = _served_counts(engine, args, st0, st1, launches, "serving_beam", aux_beams=True)
    aux_graphs = graph_stats(engine.model)
    if not (aux_graphs and aux_graphs["replays"]):
        raise AssertionError(f"the aux worker's beam rounds replayed no graph: {aux_graphs}")
    if delta["beam_requests_total"] != N_BEAM_REQUESTS or delta["retries_total"]:
        raise AssertionError(f"beam_requests_total grew by {delta['beam_requests_total']}, "
                             f"{delta['retries_total']} retries")
    lat = {kind: np.array([sec for i, (_, _, sec) in enumerate(replies)
                           if (i in beam) == (kind == "beam")]) for kind in ("beam", "greedy")}
    return {"phase": "serving_beam", "model": "turbo",
            "flags": "server defaults, --temperature_fallback ''",
            "requests": {"beam": len(beam), "greedy": N_REQUESTS - len(beam)},
            "beam_size": BEAM_SIZE, "startup_s": startup_s, "wall_s": wall,
            **{f"latency_{kind}_p{q}_s": float(np.percentile(v, q))
               for kind, v in lat.items() for q in (50, 95)},
            "audio_s": sum(len(c) for c in clips) / 16000,
            "tokens": [reply["tokens"] for _, reply, _ in replies],
            "beam_requests": delta["beam_requests_total"],
            "metrics_beam_requests_total": metrics["beam_requests_total"],
            "ticks": delta["ticks_total"], "steps": delta["steps_total"],
            "admission_batches": delta["encode_batches_total"],
            "aux_batches": delta["aux_batches_total"], "aux_steps": delta["aux_steps_total"],
            "launches": launches, "aux_graphs": aux_graphs}


def beam_reference_check() -> dict:
    """Small fp32 beam searches (tiny, 3 beams) on the card through its
    kernels against the CPU with the same weights: tokens, lengths and
    finished sets equal. With float KV (the float K3) the scores agree
    within 1e-4. With int8 cross- and self-KV (the int8 K3) they are
    reported, not bounded: a value the card computes in another summation
    order can round to the next int8 level, and on the CPU alone a 1e-6
    relative change of the mel moves the int8 scores by 5e-4 and the float
    scores by 5e-7. Each on the random weights, whose beams run to the cap
    (the fallback to the best running beam), and on weights leaning towards
    eot (the final LayerNorm's bias a seeded u, eot's embedding 0.03 u),
    whose beams all finish (the finished set). The card's beam rounds
    replay CUDA graphs; the CPU's run uncaptured."""
    from whisper_tpu_torch.beam import beam_search
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.decode import graph_stats
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.sampling import build_suppress_ids

    rng = np.random.default_rng(12)
    cfg = get_config("tiny")
    mel = rng.standard_normal((3, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    prompt = np.tile(np.asarray([cfg.sot_sequence("en")], np.int64), (3, 1))
    u = torch.from_numpy(np.random.default_rng(0).standard_normal(cfg.n_text_state)
                         .astype(np.float32))
    rec = {"phase": "beam_reference", "model": "tiny", "dtype": "float32", "beam_size": 3}
    for quant in (False, True):
        for lean in (None, 0.03):
            out, graphs = {}, {}
            for dev in ("cuda", "cpu"):
                params = init_params(cfg, seed=3, device="cpu")
                if lean:
                    params.decoder.ln["b"] = 0.5 * u
                    params.decoder.tok_emb[cfg.eot] = lean * u
                params = params.to_device(dev)
                supp = torch.from_numpy(build_suppress_ids(cfg)).long().to(dev)
                out[dev] = beam_search(params, torch.from_numpy(mel).to(dev),
                                       torch.from_numpy(prompt).to(dev), kv_quant=quant,
                                       self_kv_quant=quant, beam_size=3, max_tokens=12,
                                       suppress_ids=supp)
                graphs[dev] = graph_stats(params)
            card, cpu = out["cuda"], out["cpu"]
            if graphs["cpu"] is not None or not (graphs["cuda"] and graphs["cuda"]["keys"]):
                raise AssertionError(f"the card's beam rounds were not captured: {graphs}")
            case = f"{'int8' if quant else 'float'} KV, {'eot-leaning' if lean else 'random'}"
            for field in ("tokens", "lengths", "all_tokens"):
                if not torch.equal(getattr(card, field).cpu(), getattr(cpu, field)):
                    raise AssertionError(f"beam {field} on the card differ from the CPU ({case}): "
                                         f"{getattr(card, field).cpu().tolist()} vs "
                                         f"{getattr(cpu, field).tolist()}")
            err = float((card.scores.cpu() - cpu.scores).abs().max())
            if not quant and err > 1e-4:
                raise AssertionError(f"beam scores on the card differ from the CPU by {err} "
                                     f"({case})")
            rec[case] = {
                "tokens_equal_cpu": True, "scores_max_abs_err": err,
                "scores_tol": None if quant else 1e-4, "steps": card.steps,
                "device_steps": card.device_steps, "card_graphs": graphs["cuda"],
                "finished": (card.all_scores > -5e29).sum(dim=1).cpu().tolist(),
                "tokens": [t[4:int(n)] for t, n in zip(card.tokens.cpu().tolist(),
                                                        card.lengths.cpu().tolist())]}
    return rec


# ------------------------------------------------------------------ words
N_WORDS_SHORT = 6
WORDS_TOL = 1e-4  # the alignment matrix, card vs CPU: fp32 sums in another order
WORDS_MESH_TOL = 1e-5  # two ranks' head sums added on the lead device
WORDS_TEXTS = {"en": " The quick brown fox, jumps over the lazy dog. Then it naps in the sun, "
                     "dreaming of fields, rivers and the long road home.",
               "zh": "我们今天去公园散步，天气很好。晚上回家做饭，然后看书。"}


def _check_words(words, audio_s: float, where: str) -> None:
    """A reply's words: a list whose words lie in [0, audio_s + 0.5] with
    start <= end, starts sorted."""
    if not isinstance(words, list):
        raise AssertionError(f"{where}: words {words!r} is no list")
    starts = [w["start"] for w in words]
    if starts != sorted(starts) or not all(0 <= w["start"] <= w["end"] <= audio_s + 0.5
                                           for w in words):
        raise AssertionError(f"{where}: word times out of order or range: {words[:4]}")


def words_phase(counters) -> dict:
    """``WhisperPipeline(word_timestamps=True)`` at the offline
    configuration (turbo B64 / 64 tokens / kvq + skvq + W8A8 / bf16, ladder
    off) on the offline phase's 64 clips: warmed, the same pipeline without
    words timed, then the run with words with the counts at 0. Launches are
    exactly the decode's (the alignment pass is plain PyTorch); every row
    has a word list of ordered words inside its clip. Reports the
    alignment pass's card time (CUDA events) and the host's DTW and word
    grouping."""
    from whisper_tpu_torch import pipeline as pipeline_module
    from whisper_tpu_torch.config import N_SAMPLES
    from whisper_tpu_torch.pipeline import WhisperPipeline

    clock = {"pass_events": [], "dtw_s": 0.0}
    real_pass, real_words = pipeline_module.alignment_matrix, pipeline_module.row_words

    def timed_pass(*args, **kw):  # CUDA events around each sub-batch's pass
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_pass(*args, **kw)
        end.record()
        clock["pass_events"].append((start, end))
        return out

    def timed_words(*args, **kw):  # the host's DTW and grouping of one row
        t0 = time.perf_counter()
        out = real_words(*args, **kw)
        clock["dtw_s"] += time.perf_counter() - t0
        return out

    pipe = WhisperPipeline(model="turbo", device="cuda", compute_dtype="bfloat16",
                           quantize=True, w8a8=True, kv_quant=True, self_kv_quant=True,
                           max_tokens=N_TOKENS, seed=0, temperature_fallback=False,
                           word_timestamps=True)
    rng = np.random.default_rng(0)  # the offline phase's clips
    clips = list(rng.standard_normal((B, N_SAMPLES)).astype(np.float32) * 0.1)
    pipe.transcribe_batch(clips)  # warm
    pipe.word_timestamps = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = pipe.transcribe_batch(clips)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    pipe.word_timestamps = True
    pipeline_module.alignment_matrix, pipeline_module.row_words = timed_pass, timed_words
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        results = pipe.transcribe_batch(clips)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline_module.alignment_matrix, pipeline_module.row_words = real_pass, real_words
    launches = _launches(counters)
    dec = pipe.last_decode
    _expect("words", launches, pipe.cfg, 1, dec.device_steps)
    for i, r in enumerate(results):
        _check_words(r.words, r.audio_seconds, f"words row {i}")
    if [r.text for r in results] != [r.text for r in plain]:
        raise AssertionError("the texts with words differ from the texts without")
    counts = [len(r.words) for r in results]
    if not any(counts):
        raise AssertionError("no row has a word")
    P = len(pipe.cfg.sot_sequence(pipe.language, pipe.task))
    S = min(max(32, 32 * math.ceil((int(dec.lengths.max()) + 1) / 32)), pipe.cfg.n_text_ctx)
    rec = {"phase": "words", "model": "turbo", "batch": B, "max_tokens": N_TOKENS,
           "dtype": "bfloat16", "quant": "int8 weights + w8a8 encoder + kvq + skvq",
           "ladder": False, "wall_s": wall, "plain_wall_s": plain_wall,
           "words_over_plain": wall / plain_wall,
           "align_pass_s": sum(a.elapsed_time(b) for a, b in clock["pass_events"]) / 1e3,
           "align_pass_timing": "CUDA events around each sub-batch's alignment_matrix",
           "dtw_and_grouping_s": clock["dtw_s"], "align_batches": len(clock["pass_events"]),
           "align_S": S, "generated_mean": float((dec.lengths.cpu().numpy() - P).mean()),
           "words": sum(counts), "rows_with_words": sum(c > 0 for c in counts),
           "words_head": [(w["word"], w["start"], w["end"]) for w in results[0].words[:3]],
           "decode_steps": dec.steps, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del pipe
    return rec


_SRT_TIME = r"\d\d:\d\d:\d\d,\d{3}"
_VTT_TIME = r"\d\d:\d\d:\d\d\.\d{3}"


def _parse_subtitles(fmt: str, body: str) -> int:
    """The number of cues of an srt, vtt or tsv body; raises where the body
    does not parse: srt numbered 1, 2, ... with ``start --> end``, vtt
    opening ``WEBVTT`` with ``start --> end`` cues, tsv a ``start end text``
    header and integer milliseconds, start <= end."""
    if fmt == "tsv":
        head, *rows = body.rstrip("\n").split("\n")
        if head != "start\tend\ttext":
            raise AssertionError(f"tsv header {head!r}")
        for row in rows:
            start, end, _ = row.split("\t", 2)
            if not (start.isdigit() and end.isdigit() and int(start) <= int(end)):
                raise AssertionError(f"tsv row {row!r}")
        return len(rows)
    if fmt == "vtt":
        if not body.startswith("WEBVTT\n\n"):
            raise AssertionError(f"vtt body opens {body[:20]!r}")
        body = body[len("WEBVTT\n\n"):]
    cues = [c for c in body.split("\n\n") if c.strip()]
    for i, cue in enumerate(cues, 1):
        lines = cue.split("\n")
        if fmt == "srt":
            if lines[0] != str(i):
                raise AssertionError(f"srt cue {i} numbered {lines[0]!r}")
            lines = lines[1:]
        time_re = _SRT_TIME if fmt == "srt" else _VTT_TIME
        if not re.fullmatch(f"{time_re} --> {time_re}", lines[0]) or len(lines) < 2:
            raise AssertionError(f"{fmt} cue {i}: {cue!r}")
    return len(cues)


def serving_words(counters) -> dict:
    """The turbo server at its defaults with the ladder off (the greedy
    core), one burst from client threads of 12 requests: 6 clips of 2-30 s
    with ``word_timestamps=1``, one each of ``format=srt``, ``vtt`` and
    ``tsv``, one of 60-90 s with words (its windows' words merged), and one
    ``beam=5`` and one ``temperature=0.4`` request with words (the aux
    worker). No reply has ``align_error``, every reply asked for words has
    a list, the subtitle bodies parse, and the launches are exactly the
    decode's (the aux worker's beam steps K3 alone, its sampled steps K2
    and K3, counted through its graphs' replays; the align worker launches
    none)."""
    from whisper_tpu_torch.decode import graph_stats

    rng = np.random.default_rng(43)

    def noise(lo, hi):
        return (rng.standard_normal(int(16000 * rng.uniform(lo, hi))) * 0.1).astype(np.float32)

    words = {"word_timestamps": 1}
    jobs = [("words", noise(2, 30), words) for _ in range(N_WORDS_SHORT)]
    jobs += [(fmt, noise(2, 30), {"format": fmt}) for fmt in ("srt", "vtt", "tsv")]
    jobs += [("long", noise(60, 90), words), ("beam", noise(2, 30), {**words, "beam": BEAM_SIZE}),
             ("sampled", noise(2, 30), {**words, "temperature": 0.4})]
    engine, base, args, srv, thread, _, startup_s = _started(GREEDY)
    url = f"{base}/asr"
    aux_steps = {"beam": 0, "sampled": 0}
    run_aux = engine._run_aux_batch

    def counted(reqs):  # the aux steps by kind: beam steps launch K3 alone
        before = engine.stats.aux_steps_total
        run_aux(reqs)
        kind = "beam" if reqs[0].temperature == 0 and reqs[0].beam_size > 1 else "sampled"
        aux_steps[kind] += engine.stats.aux_steps_total - before

    engine._run_aux_batch = counted
    try:
        st0 = engine.stats.snapshot()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs)) as pool:
            replies = list(pool.map(lambda job: _ask(url, job[1], job[2]), jobs))
        wall = time.perf_counter() - t0
        launches = _launches(counters)
        st1 = engine.stats.snapshot()
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            metrics = json.load(r)
    finally:
        _stopped(engine, srv, thread)
    bad = [(kind, code, str(reply)[:300]) for (kind, _, _), (code, reply, _) in zip(jobs, replies)
           if code != 200 or (isinstance(reply, dict) and "align_error" in reply)]
    if bad:
        raise AssertionError(f"{len(bad)} of {len(jobs)} word requests failed: {bad[:3]}")
    cues = {}
    for (kind, clip, _), (_, reply, _) in zip(jobs, replies):
        if kind in ("srt", "vtt", "tsv"):
            cues[kind] = _parse_subtitles(kind, reply)
            continue
        _check_words(reply.get("words"), len(clip) / 16000, f"serving_words {kind}")
    by_kind = {kind: reply for (kind, _, _), (_, reply, _) in zip(jobs, replies)}
    if (by_kind["beam"].get("beam_size") != BEAM_SIZE or by_kind["sampled"]["temperature"] != 0.4
            or by_kind["long"].get("windows", 1) < 2):
        raise AssertionError(f"aux or long replies: {str(by_kind)[:400]}")
    delta = {key: st1[key] - st0[key] for key in (
        "steps_total", "encode_batches_total", "aux_batches_total", "aux_steps_total",
        "detect_batches_total", "align_total", "align_batches_total", "ticks_total")}
    if sum(aux_steps.values()) != delta["aux_steps_total"]:
        raise AssertionError(f"aux steps by kind {aux_steps} != {delta['aux_steps_total']}")
    _expect(f"serving_words ({delta['steps_total']} slot steps, aux {aux_steps})", launches,
            engine.cfg, delta["encode_batches_total"] + delta["aux_batches_total"],
            delta["steps_total"] + aux_steps["sampled"], args.encoder_attention,
            args.cross_decode, detects=delta["detect_batches_total"],
            beam_steps=aux_steps["beam"])
    lat = np.array([sec for _, _, sec in replies])
    return {"phase": "serving_words", "model": "turbo",
            "flags": "server defaults, --temperature_fallback ''",
            "requests": {k: sum(1 for j in jobs if j[0] == k) for k in dict.fromkeys(
                j[0] for j in jobs)}, "startup_s": startup_s, "wall_s": wall,
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p95_s": float(np.percentile(lat, 95)),
            "latency_by_kind_s": {kind: sec for (kind, _, _), (_, _, sec) in zip(jobs, replies)},
            "audio_s": sum(len(c) for _, c, _ in jobs) / 16000,
            "align_total": delta["align_total"], "align_batches_total": delta["align_batches_total"],
            "metrics_align_total": metrics["align_total"],
            "words_per_reply": [len(r["words"]) for (k, _, _), (_, r, _) in zip(jobs, replies)
                                if k not in cues], "cues": cues,
            "long_windows": by_kind["long"]["windows"], "ticks": delta["ticks_total"],
            "steps": delta["steps_total"], "admission_batches": delta["encode_batches_total"],
            "aux_batches": delta["aux_batches_total"], "aux_steps": aux_steps,
            "launches": launches, "aux_graphs": graph_stats(engine.model)}


def _dtw_parting(m_a: np.ndarray, m_b: np.ndarray) -> dict:
    """Where the DTW paths over two alignment matrices part: the first
    divergent cell and the margin between ``m_a``'s best and second-best
    moves into it (its accumulated costs), beside the two matrices' summed
    difference, which bounds how far the costs can move."""
    from whisper_tpu_torch.align import dtw_path

    a, b = dtw_path(-m_a.astype(np.float64)), dtw_path(-m_b.astype(np.float64))
    n = next((k for k in range(min(len(a[0]), len(b[0])))
              if (a[0][k], a[1][k]) != (b[0][k], b[1][k])), None)
    if n is None:
        return {"cell": None}
    cost = -m_a.astype(np.float64)
    N, M = cost.shape
    D = np.full((N + 1, M + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, N + 1):
        for j in range(1, M + 1):
            D[i, j] = cost[i - 1, j - 1] + min(D[i - 1, j - 1], D[i - 1, j], D[i, j - 1])
    i, j = int(a[0][n - 1]) + 1, int(a[1][n - 1]) + 1
    moves = sorted([D[i, j], D[i - 1, j + 1] if j + 1 <= M else np.inf,
                    D[i + 1, j] if i + 1 <= N else np.inf])
    return {"cell": [i, j], "margin": float(moves[1] - moves[0]),
            "drift": float(np.abs(m_a - m_b).sum())}


def words_reference_check(device: str = "cuda") -> dict:
    """tiny, fp32 (TF32 off): a word-heavy teacher-forced English row and a
    zh row over the cross-KV of two seeded clips (computed once on the CPU,
    int8, then dequantized on each side), through ``alignment_matrix`` on
    the card and on the CPU with the same weights: within WORDS_TOL on the
    rows and frames the host reads, and the same words (where a DTW near-tie
    parts the paths, the first divergent cell and its margin are reported,
    and the margin must lie within the matrices' difference). The same pass
    on a (1, 2) mesh of two ranks on the card equals the unsharded one
    within WORDS_MESH_TOL. ``device`` is the card's side."""
    from whisper_tpu_torch.align import (alignment_head_mask, alignment_matrix,
                                         dequantize_cross_kv, row_words)
    from whisper_tpu_torch.config import N_SAMPLES, get_config
    from whisper_tpu_torch.decode import encode_cross_kv
    from whisper_tpu_torch.models.model import Shards
    from whisper_tpu_torch.ops.mel import log_mel_batch
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.parallel.sharding import make_mesh, shard_params
    from whisper_tpu_torch.tokenizer import get_tokenizer

    cfg = get_config("tiny")
    tok = get_tokenizer(num_languages=cfg.num_languages, task="transcribe")
    rng = np.random.default_rng(19)
    seconds = (12.0, 25.0)
    audio = np.zeros((2, N_SAMPLES), np.float32)
    for i, s in enumerate(seconds):
        audio[i, :int(16000 * s)] = rng.standard_normal(int(16000 * s)) * 0.1
    lengths = torch.tensor([int(16000 * s) for s in seconds])
    cpu_model = init_params(cfg, seed=3, device="cpu")
    mel = log_mel_batch(torch.from_numpy(audio), lengths, n_mels=cfg.n_mels)
    cross_q = encode_cross_kv(cpu_model, mel, torch.float32, kv_quant=True)
    langs = list(WORDS_TEXTS)
    prompts = [list(cfg.sot_sequence(lang)) for lang in langs]
    seqs = [p + tok.encode(WORDS_TEXTS[lang]) + [cfg.eot] for p, lang in zip(prompts, langs)]
    S = 32 * math.ceil(max(map(len, seqs)) / 32)
    tokens = np.full((2, S), cfg.eot, np.int64)
    row_mask = np.zeros((2, S), bool)
    for i, seq in enumerate(seqs):
        tokens[i, :len(seq)] = seq
        row_mask[i, len(prompts[i]):len(seq)] = True
    frames = np.array([min(math.ceil(16000 * s / 320), cfg.n_audio_ctx) for s in seconds])
    hm = torch.from_numpy(alignment_head_mask(cfg).astype(np.float32))
    out = {}
    for dev in (device, "cpu"):
        model = init_params(cfg, seed=3, device="cpu").to_device(dev)
        fp = dequantize_cross_kv(tuple(t.to(dev) for t in cross_q))
        args = [torch.from_numpy(a).to(dev) for a in (tokens, row_mask, frames)]
        matrix, tlp = alignment_matrix(model, args[0], fp, hm.to(dev), *args[1:])
        out[dev] = (matrix.cpu().numpy(), tlp.cpu().numpy())
        if dev == device:
            halves = Shards([tuple(t[:, :, h * 3:(h + 1) * 3] for t in fp) for h in range(2)])
            sharded = shard_params(init_params(cfg, seed=3, device="cpu").to_device(dev),
                                   make_mesh(1, 2, devices=[dev, dev]))
            mesh_m, _ = alignment_matrix(sharded, args[0], halves, hm.to(dev), *args[1:])
            mesh_m = mesh_m.cpu().numpy()
    rec = {"phase": "words_reference", "model": "tiny", "dtype": "float32",
           "cross_kv": "int8 from the CPU, dequantized on each side", "rows": {}}
    for i, (lang, seq) in enumerate(zip(langs, seqs)):
        pl, L, F = len(prompts[i]), len(seq), int(frames[i])
        (card, card_lp), (cpu, cpu_lp) = out[device], out["cpu"]
        err = float(np.abs(card[i, pl:L, :F] - cpu[i, pl:L, :F]).max())
        lp_err = float(np.abs(card_lp[i, :L - 1] - cpu_lp[i, :L - 1]).max())
        mesh_err = float(np.abs(mesh_m[i, pl:L, :F] - card[i, pl:L, :F]).max())
        if err > WORDS_TOL or lp_err > WORDS_TOL or mesh_err > WORDS_MESH_TOL:
            raise AssertionError(f"words_reference {lang}: matrix {err}, log-probs {lp_err} "
                                 f"(tol {WORDS_TOL}), mesh {mesh_err} (tol {WORDS_MESH_TOL})")
        got, want = (row_words(m, lp, tokens[i], pl, L, F, lang, tok)
                     for m, lp in ((card[i], card_lp[i]), (cpu[i], cpu_lp[i])))
        key = [(w["word"], w["start"], w["end"]) for w in got]
        parting = None
        if key != [(w["word"], w["start"], w["end"]) for w in want]:
            parting = _dtw_parting(card[i, pl:L - 1, :F], cpu[i, pl:L - 1, :F])
            if parting["cell"] is None or parting["margin"] > parting["drift"]:
                raise AssertionError(f"words_reference {lang}: words differ without a DTW "
                                     f"near-tie: {parting}; {key} vs {want}")
        rec["rows"][lang] = {"matrix_max_abs_err": err, "tol": WORDS_TOL,
                             "logprob_max_abs_err": lp_err, "mesh_max_abs_err": mesh_err,
                             "mesh_tol": WORDS_MESH_TOL, "words_equal": parting is None,
                             "dtw_parting": parting, "words": len(got), "frames": F,
                             "words_head": key[:4]}
    return rec


# ------------------------------------------------------------------ speculative decoding
N_SPEC_CLIPS = 16
SPEC_GAMMA = 4
SPEC_DRAFT = "distil-large-v3"
SPEC_TOL = 1e-5  # card vs CPU, tiny fp32: the window, avg_logprob, no_speech_prob
# the speculative path: benchmarks/spec_bench.py's defaults (--model turbo
# --draft distil-large-v3 --batch 16 --tokens 64 --gamma 4) at the offline
# configuration's quantization; the suppression filters off (greedy argmax
# only, as the spec path requires)
SPEC_PIPELINE = dict(model="turbo", device="cuda", compute_dtype="bfloat16", quantize=True,
                     w8a8=True, kv_quant=True, self_kv_quant=True, max_tokens=N_TOKENS, seed=0,
                     apply_filters=False, spec_gamma=SPEC_GAMMA)


SPEC_SWEEP = (4, 2, 1, 1, 2, 4)  # SPEC_ROUNDS values the spec phase times, in turns
SPEC_FIELDS = DECODE_FIELDS + ("accepted", "drafted")


def _alpha_star(step_ms: float, round_ms: float, gamma: int):
    """The least acceptance alpha on a grid of 2,001 at which a round of
    ``round_ms`` pays: it emits sum_{j<=gamma} alpha^j tokens, each worth
    one target step of ``step_ms`` (None: none does)."""
    alphas = np.linspace(0, 1, 2001)
    ok = sum(alphas ** j for j in range(gamma + 1)) * step_ms >= round_ms
    return float(alphas[ok][0]) if ok.any() else None


def _break_even(step_ms: float, draft_ms: float, verify_ms: float, gamma: int) -> dict:
    """``benchmarks/spec_bench.py``'s economics on the eager yardstick: a
    round costs ``gamma`` draft steps and one verify window."""
    round_ms = gamma * draft_ms + verify_ms
    return {"target_step_ms": step_ms, "draft_step_ms": draft_ms,
            f"verify_w{gamma + 1}_ms": verify_ms, "draft_over_step": draft_ms / step_ms,
            "verify_over_step": verify_ms / step_ms, "round_ms": round_ms,
            "tokens_per_round_needed": round_ms / step_ms,
            "break_even_alpha": _alpha_star(step_ms, round_ms, gamma)}


def _graphed_break_even(greedy, greedy_s: float, spec, spec_s: float, gamma: int) -> dict:
    """The economics on the graphed yardstick, from the same timed calls: a
    graphed greedy decode's wall over its device steps, a graphed spec
    decode's over its device rounds (each with its prefills)."""
    step_ms = 1e3 * greedy_s / greedy.device_steps
    round_ms = 1e3 * spec_s / spec.device_rounds
    return {"greedy_step_ms": step_ms, "spec_round_ms": round_ms,
            "round_over_step": round_ms / step_ms,
            "break_even_alpha": _alpha_star(step_ms, round_ms, gamma)}


def _spec_graphs(model) -> dict:
    """``decode.graph_stats(model)`` with each key's capture seconds under a
    short name: a speculative key holds its draft's decoder-weight pointers
    (named here by their hash) and its group length."""
    from whisper_tpu_torch import decode

    stats = decode.graph_stats(model)
    short = {}
    for i, (k, sec) in enumerate(decode._GRAPHS[model].graphs.capture_seconds.items()):
        name = (f"spec draft {hash(k[2]) & 0xffff:04x} rounds {k[-5]}" if k[0] == "spec"
                else f"{k[0] if isinstance(k[0], str) else 'greedy'} {i}")
        short[name] = sec
    return {**stats, "capture_s": short}


def _spec_equal(what: str, a, b, counts: bool = True) -> None:
    """Two speculative results equal bit for bit, with their counts (with
    ``counts``, the host's reads and the device's rounds too)."""
    for name in SPEC_FIELDS:
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what}: {name} differs")
    if (a[6:] if counts else a.rounds) != (b[6:] if counts else b.rounds):
        raise AssertionError(f"{what}: rounds, host reads, device rounds {a[6:]} against "
                             f"{b[6:]}")


def _spec_costs(target, cross_t, draft, cross_d, gamma: int, dt) -> dict:
    """The three costs of a round at the spec batch, each by CUDA events
    over 20 calls (the host's launches included, as the decode loop pays
    them): the target's 1-wide step (``decoder_step_multipos``: K2 and the
    int8 K3 once a layer), its window of ``gamma + 1`` and the draft's
    step, all at the offset after a prompt of 4 in caches of 128."""
    from whisper_tpu_torch.models.model import (
        decoder_step_multipos, decoder_window_multipos, new_kv_cache)

    B = cross_t[0].shape[1]
    dev = cross_t[0].device
    offs = torch.full((B,), 5, dtype=torch.int64, device=dev)
    tok = torch.full((B,), 123, dtype=torch.int64, device=dev)
    win = torch.full((B, gamma + 1), 123, dtype=torch.int64, device=dev)
    kv_t = new_kv_cache(target, B, dt, 128, quant=True)
    kv_d = new_kv_cache(draft, B, dt, 128, quant=True)
    step = cuda_ms(lambda: decoder_step_multipos(target, tok, offs, kv_t, cross_t, dt), reps=20)
    verify = cuda_ms(lambda: decoder_window_multipos(target, win, offs, kv_t, cross_t, dt),
                     reps=20)
    dstep = cuda_ms(lambda: decoder_step_multipos(draft, tok, offs, kv_d, cross_d, dt), reps=20)
    return {"target": target.cfg.name, "draft": draft.cfg.name, "batch": B,
            **_break_even(step, dstep, verify, gamma)}


def _first_divergences(pipe, cross_kv, spec, greedy, P: int) -> list:
    """Per row: whether the speculative tokens equal greedy's and, where
    not, the first position that differs (counted from the first new token)
    and the target's top-2 log-prob margin there, teacher-forced on
    greedy's shared prefix (one bf16 prefill, int8 self-KV)."""
    from whisper_tpu_torch.decode import index_cross_kv
    from whisper_tpu_torch.models.model import decoder_forward, new_kv_cache

    st, gt = spec.tokens.cpu(), greedy.tokens.cpu()
    rows = []
    for b in range(st.shape[0]):
        diff = torch.nonzero(st[b] != gt[b])
        if not len(diff):
            rows.append({"row": b, "equal": True})
            continue
        d = int(diff[0])
        idx = torch.tensor([b], device=pipe.device)
        kv = new_kv_cache(pipe.model, 1, pipe.compute_dtype, 128, quant=True)
        logits, _ = decoder_forward(pipe.model, gt[b:b + 1, :d].to(pipe.device), 0, kv,
                                    index_cross_kv(cross_kv, idx), pipe.compute_dtype)
        top2 = torch.topk(torch.log_softmax(logits[0, -1].float(), dim=-1), 2).values
        rows.append({"row": b, "equal": False, "first_divergence": d - P,
                     "top2_margin": float(top2[0] - top2[1])})
    return rows


def spec_phase(counters) -> dict:
    """The speculative path: 16 seeded 30 s noise clips through
    ``WhisperPipeline(spec_draft="distil-large-v3").transcribe_batch``
    (``SPEC_PIPELINE``: turbo target, a random distil-large-v3 draft of
    seed 1, 64 tokens, gamma 4): built, warmed, run once with the counts at
    0 and checked (its rounds captured; exact launches: K7 once, both
    encoders' K1, K8 and K8q, K2 and the int8 K3 for the draft's 2 layers
    x (gamma - 1) steps a device round, nothing for the windows and the
    prefills), its wall beside the same pipeline without its draft
    (greedy) on the same clips, the tokens against greedy's row by row
    (reported, not asserted: bf16 windows sum in another order). Then the
    decode alone on one cross-KV of each model: graphed and uncaptured
    (``spec_decode._spec_rounds``), bit-equal with every count, launches
    exact through the replays, both walls and the host's CUDA launch calls
    of one graphed decode (torch.profiler); the graphed wall at each
    ``SPEC_SWEEP`` group length, in turns, with the random draft and the
    self draft (bit-equal across lengths, masked rounds and all); the
    target as its own draft (the alpha ~ 1 ceiling, graphed; at most
    ceil(63 / (gamma + 1)) + 1 rounds); the wall's split (each encode and the decodes); the graph
    stats; and the economics at turbo (the eager yardstick of
    ``_spec_costs`` beside the graphed one of ``_graphed_break_even``) and
    at a large-v3 target (its 32 decoder layers; eager steps only)."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch import spec_decode as sd
    from whisper_tpu_torch.config import N_SAMPLES, get_config
    from whisper_tpu_torch.decode import encode_cross_kv, greedy_decode_kv
    from whisper_tpu_torch.models.model import cast_floating
    from whisper_tpu_torch.ops.mel import log_mel_batch
    from whisper_tpu_torch.ops.quant import quantize_params
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.spec_decode import SpecResult, speculative_decode_kv

    t0 = time.perf_counter()
    pipe = WhisperPipeline(spec_draft=SPEC_DRAFT, **SPEC_PIPELINE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(43)
    clips = list(rng.standard_normal((N_SPEC_CLIPS, N_SAMPLES)).astype(np.float32) * 0.1)
    pipe.transcribe_batch(clips)  # warm: its rounds captured
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = pipe.transcribe_batch(clips)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    spec, cfg, dcfg, dev = pipe.last_decode, pipe.cfg, pipe.draft.cfg, pipe.device
    stats = dict(pipe.last_spec_stats)
    R = sd.SPEC_ROUNDS
    P = len(cfg.sot_sequence(pipe.language, pipe.task))
    lens, toks = spec.lengths.cpu().numpy(), spec.tokens.cpu().numpy()
    if not isinstance(spec, SpecResult) or len(results) != N_SPEC_CLIPS:
        raise AssertionError(f"the spec path returned {type(spec).__name__}, {len(results)} texts")
    if not ((lens >= P) & (lens <= P + N_TOKENS)).all():
        raise AssertionError(f"spec lengths out of range: {lens.tolist()}")
    if not ((toks >= 0) & (toks < cfg.n_vocab)).all():
        raise AssertionError("spec token ids out of the vocabulary")
    if not (torch.isfinite(spec.avg_logprob).all() and torch.isfinite(spec.no_speech_prob).all()):
        raise AssertionError("non-finite spec log-probabilities")
    if (spec.host_syncs != max(1, -(-spec.rounds // R))
            or spec.device_rounds != spec.host_syncs * R or stats["drafted"] <= 0):
        raise AssertionError(f"spec counts: {stats}")
    pipe_graphs = _spec_graphs(pipe.model)
    if not any(k.startswith("spec") for k in pipe_graphs["capture_s"]):
        raise AssertionError(f"the pipeline's spec decode ran uncaptured: {pipe_graphs}")
    _expect("spec", launches, cfg, 1, 0, draft=(dcfg, (SPEC_GAMMA - 1) * spec.device_rounds))

    draft, pipe.draft = pipe.draft, None  # greedy on the same clips, the same process
    pipe.transcribe_batch(clips)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.transcribe_batch(clips)
    torch.cuda.synchronize()
    greedy_wall = time.perf_counter() - t0
    greedy = pipe.last_decode
    pipe.draft = draft

    # the decodes alone on one cross-KV of each model
    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    batch, lengths = pipe._prepare_batch(clips)
    mel = log_mel_batch(batch, lengths, n_mels=cfg.n_mels)[..., : 2 * cfg.n_audio_ctx]
    cross, encode_s = timed(lambda: encode_cross_kv(pipe.model, mel, pipe.compute_dtype,
                                                    kv_quant=True, w8a8=True))
    cross_d, draft_encode_s = timed(lambda: pipe._draft_cross_kv(batch, lengths, mel))
    prompt = torch.tensor([cfg.sot_sequence(pipe.language, pipe.task)] * N_SPEC_CLIPS,
                          device=pipe.device)
    rows = _first_divergences(pipe, cross, spec, greedy, P)
    dt = pipe.compute_dtype
    decode_kw = dict(compute_dtype=dt, max_tokens=N_TOKENS, self_kv_quant=True)

    def rounds_of(graphed, d=draft, cd=cross_d):
        return sd._spec_rounds(pipe.model, cross, d, cd, prompt, SPEC_GAMMA, dt, N_TOKENS,
                               True, 0, pipe.gelu, pipe.cross_decode, graphed)

    decodes, ways = {}, {}
    for way, graphed in (("graphed", True), ("uncaptured", False)):
        if graphed:
            rounds_of(True)  # its capture
            torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        res = rounds_of(graphed)
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        got = _launches(counters)
        _expect(f"spec decode {way}", got, cfg, 0, 0,
                draft=(dcfg, (SPEC_GAMMA - 1) * res.device_rounds))
        ways[way] = res
        decodes[way] = {"wall_s": w, "rounds": res.rounds, "device_rounds": res.device_rounds,
                        "host_syncs": res.host_syncs,
                        "launches": {k: n for k, n in got.items() if n}}
    _spec_equal("spec decode graphed against uncaptured", ways["graphed"], ways["uncaptured"])
    decodes["bit_equal"] = list(SPEC_FIELDS) + ["rounds", "host_syncs", "device_rounds"]
    decodes["graphed"]["walls_s"] = [decodes["graphed"]["wall_s"]] + _walls(
        lambda: rounds_of(True), 2)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rounds_of(True)
        torch.cuda.synchronize()
    calls = _host_launches(prof)
    decodes["graphed"].update(host_launch_calls=calls,
                              host_launch_calls_total=sum(calls.values()),
                              profile_s=time.perf_counter() - t0)
    spec_decode_s = decodes["graphed"]["wall_s"]

    def self_draft():
        return speculative_decode_kv(pipe.model, cross, pipe.model, cross, prompt,
                                     gamma=SPEC_GAMMA, **decode_kw)

    # each group length on the random draft (acceptance 0) and the self
    # draft (acceptance ~1: fewer rounds, so a masked tail weighs more)
    sweep, refs = {}, {"random": ways["graphed"]}
    try:
        for r in SPEC_SWEEP:
            sd.SPEC_ROUNDS = r
            for name, fn in (("random", lambda: rounds_of(True)), ("self", self_draft)):
                res = fn()  # its key's capture at the first visit
                _spec_equal(f"{name} draft at SPEC_ROUNDS {r}", res, refs.setdefault(name, res),
                            counts=False)
                entry = sweep.setdefault(f"{name} {r}", {"walls_s": [],
                                                         "host_syncs": res.host_syncs,
                                                         "rounds": res.rounds,
                                                         "device_rounds": res.device_rounds})
                entry["walls_s"] += _walls(fn, 2)
    finally:
        sd.SPEC_ROUNDS = R
    for entry in sweep.values():
        entry["median_s"] = float(np.median(entry["walls_s"]))

    ceiling, self_s = timed(self_draft)
    plain, greedy_decode_s = timed(lambda: greedy_decode_kv(pipe.model, cross, prompt,
                                                             **decode_kw))
    max_rounds = math.ceil((N_TOKENS - 1) / (SPEC_GAMMA + 1)) + 1
    if ceiling.rounds > max_rounds:
        raise AssertionError(f"the self-draft ran {ceiling.rounds} rounds, more than "
                             f"{max_rounds}")
    graphs = _spec_graphs(pipe.model)
    economics = [{**_spec_costs(pipe.model, cross, draft, cross_d, SPEC_GAMMA, dt),
                  "graphed": _graphed_break_even(plain, greedy_decode_s, ways["graphed"],
                                                 spec_decode_s, SPEC_GAMMA)}]
    del pipe, cross
    torch.cuda.empty_cache()
    # large-v3: turbo's encoder and 32 decoder layers, the target
    # distil-large-v3 is distilled from; random, seed 0, quantized as turbo
    large = init_params(get_config("large-v3"), 0, device=dev)
    quantize_params(large)
    large = cast_floating(large, torch.bfloat16)
    cross_l = encode_cross_kv(large, mel, torch.bfloat16, kv_quant=True, w8a8=True)
    economics.append(_spec_costs(large, cross_l, draft, cross_d, SPEC_GAMMA, torch.bfloat16))
    del large, cross_l, draft, cross_d
    equal = sum(r["equal"] for r in rows)
    return {"phase": "spec", "model": "turbo", "draft": SPEC_DRAFT, "batch": N_SPEC_CLIPS,
            "gamma": SPEC_GAMMA, "max_tokens": N_TOKENS, "dtype": "bfloat16",
            "quant": "int8 weights + w8a8 encoders + kvq + skvq", "apply_filters": False,
            "spec_rounds": R, "init_s": init_s, "wall_s": wall, "greedy_wall_s": greedy_wall,
            "spec_over_greedy": wall / greedy_wall, "rounds": spec.rounds,
            "device_rounds": spec.device_rounds, "host_syncs": spec.host_syncs,
            "greedy_steps": greedy.steps, **stats,
            "generated": (lens - P).tolist(), "rows_equal_greedy": equal,
            "rows": [r for r in rows if not r["equal"]],
            "decode": decodes, "spec_rounds_sweep": sweep,
            "split_s": {"target_encode": encode_s, "draft_encode": draft_encode_s,
                        "spec_decode": spec_decode_s,
                        "spec_decode_uncaptured": decodes["uncaptured"]["wall_s"],
                        "greedy_decode": greedy_decode_s,
                        "spec_decode_per_round_ms": 1e3 * spec_decode_s / spec.rounds},
            "self_draft": {"rounds": ceiling.rounds, "device_rounds": ceiling.device_rounds,
                           "max_rounds": max_rounds,
                           "accepted": int(ceiling.accepted), "drafted": int(ceiling.drafted),
                           "acceptance": int(ceiling.accepted) / max(int(ceiling.drafted), 1),
                           "decode_s": self_s, "greedy_decode_s": greedy_decode_s,
                           "over_greedy": self_s / greedy_decode_s,
                           "rows_equal_greedy": int((ceiling.tokens == plain.tokens)
                                                    .all(dim=1).sum())},
            "graphs": graphs, "pipeline_graphs": pipe_graphs,
            "economics": economics, "launches": launches, "peak_mem_gb": peak_gb,
            "timing": "walls by the host clock around synchronized calls; the eager "
                      "economics by CUDA events over 20 calls each, the graphed from the "
                      "decode walls"}


def spec_reference_check(device: str = "cuda") -> dict:
    """Small fp32 speculative decodes (tiny, gamma 3, 12 tokens, a tiny
    draft of another seed and the target as its own draft; float caches and
    int8 cross- and self-KV) on the card, in captured rounds through its
    kernels, against the same runs on the CPU (uncaptured): tokens, lengths
    and the counts equal, and equal to greedy's on each device;
    avg_logprob and no_speech_prob within 1e-5 with float caches (int8:
    reported, a value the card computes in another order can round to the
    next int8 level). Then the self draft with no token budget, so that its
    windows cross the end of the 448-position caches (some row must reach
    it): graphed on the card, bit-equal to its uncaptured rounds there and
    equal to the CPU's. Then one window of 5 at offsets 0, 60, 124 and 126
    of a 128-position cache (the last two rows cross its end) from the same
    seeded cache on both: logits and the float cache within 1e-5, the
    dropped positions untouched. ``device`` is the card's side."""
    from whisper_tpu_torch import decode
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.decode import encode_cross_kv, greedy_decode_kv
    from whisper_tpu_torch.models.model import KVCache, decoder_window_multipos
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.spec_decode import _spec_rounds, speculative_decode_kv

    def spec_keys(model) -> int:
        owner = decode._GRAPHS.get(model)
        return 0 if owner is None else sum(
            k[0] == "spec" for k in owner.graphs.capture_seconds)

    rng = np.random.default_rng(13)
    cfg = get_config("tiny")
    mel = rng.standard_normal((3, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    prompt = np.tile(np.asarray([cfg.sot_sequence("en")], np.int64), (3, 1))
    rec = {"phase": "spec_reference", "model": "tiny", "dtype": "float32", "gamma": 3,
           "tol": SPEC_TOL}
    for quant in (False, True):
        for draft_seed in (5, 3):
            out = {}
            for dev in (device, "cpu"):
                # the same CPU-drawn weights on both sides
                target = init_params(cfg, seed=3, device="cpu").to_device(dev)
                draft = init_params(cfg, seed=draft_seed, device="cpu").to_device(dev)
                m, p = torch.from_numpy(mel).to(dev), torch.from_numpy(prompt).to(dev)
                ct = encode_cross_kv(target, m, kv_quant=quant)
                cd = encode_cross_kv(draft, m, kv_quant=quant)
                spec = speculative_decode_kv(target, ct, draft, cd, p, gamma=3, max_tokens=12,
                                             self_kv_quant=quant)
                if spec_keys(target) != int(dev != "cpu"):
                    raise AssertionError(f"the {dev} spec decode's rounds: "
                                         f"{decode.graph_stats(target)}")
                greedy = greedy_decode_kv(target, ct, p, max_tokens=12, self_kv_quant=quant)
                if not torch.equal(spec.tokens, greedy.tokens):
                    raise AssertionError(f"spec tokens differ from greedy's on {dev}: "
                                         f"{spec.tokens.tolist()} vs {greedy.tokens.tolist()}")
                out[dev] = spec
            card, cpu = out[device], out["cpu"]
            case = (f"{'int8' if quant else 'float'} KV, "
                    f"{'self draft' if draft_seed == 3 else 'draft of seed 5'}")
            counts = {w: (int(r.accepted), int(r.drafted), r.rounds) for w, r in out.items()}
            if (not torch.equal(card.tokens.cpu(), cpu.tokens)
                    or not torch.equal(card.lengths.cpu(), cpu.lengths)
                    or counts[device] != counts["cpu"]):
                raise AssertionError(f"spec on the card differs from the CPU ({case}): "
                                     f"{card.tokens.cpu().tolist()} vs {cpu.tokens.tolist()}, "
                                     f"{counts}")
            errs = {f: float((getattr(card, f).cpu() - getattr(cpu, f)).abs().max())
                    for f in ("avg_logprob", "no_speech_prob")}
            if not quant and max(errs.values()) > SPEC_TOL:
                raise AssertionError(f"spec log-probs on the card differ from the CPU ({case}): "
                                     f"{errs}")
            rec[case] = {"tokens_equal_cpu_and_greedy": True, "graphed_on_card": True,
                         "accepted_drafted_rounds": counts[device],
                         **{f"{f}_max_abs_err": e for f, e in errs.items()},
                         "tokens": [t[4:int(n)] for t, n in zip(card.tokens.cpu().tolist(),
                                                                 card.lengths.cpu().tolist())]}

    out = {}
    for dev in (device, "cpu"):
        target = init_params(cfg, seed=3, device="cpu").to_device(dev)
        m, p = torch.from_numpy(mel).to(dev), torch.from_numpy(prompt).to(dev)
        ct = encode_cross_kv(target, m)
        out[dev] = speculative_decode_kv(target, ct, target, ct, p, gamma=3)
        if dev != "cpu":
            if spec_keys(target) != 1:
                raise AssertionError(f"the card's decode to the end: {decode.graph_stats(target)}")
            _spec_equal("spec to the context's end, graphed against uncaptured", out[dev],
                        _spec_rounds(target, ct, target, ct, p, 3, torch.float32, None, False, 0,
                                     "erf", "fd", False))
    card, cpu = out[device], out["cpu"]
    counts = {w: (int(r.accepted), int(r.drafted), r.rounds) for w, r in out.items()}
    if (not torch.equal(card.tokens.cpu(), cpu.tokens)
            or not torch.equal(card.lengths.cpu(), cpu.lengths)
            or counts[device] != counts["cpu"]):
        raise AssertionError(f"spec to the context's end differs on the card from the CPU: "
                             f"{card.lengths.tolist()} vs {cpu.lengths.tolist()}, {counts}")
    errs = {f: float((getattr(card, f).cpu() - getattr(cpu, f)).abs().max())
            for f in ("avg_logprob", "no_speech_prob")}
    if max(errs.values()) > SPEC_TOL:
        raise AssertionError(f"spec log-probs to the context's end: {errs}")
    reached = int((cpu.lengths == cfg.n_text_ctx).sum())
    if not reached:
        raise AssertionError(f"no row reached the context's end: {cpu.lengths.tolist()}")
    rec["to the context's end, self draft"] = {
        "graphed_bit_equal_uncaptured": True, "accepted_drafted_rounds": counts[device],
        "device_rounds": card.device_rounds, "rows_at_the_end": reached,
        **{f"{f}_max_abs_err": e for f, e in errs.items()}}

    offsets = np.array([0, 60, 124, 126])
    toks = rng.integers(0, 50000, (4, 5))
    L, H, dh = cfg.n_text_layer, cfg.n_text_head, cfg.head_dim_text
    k0, v0 = (rng.standard_normal((L, 4, H, dh, 128)).astype(np.float32) for _ in range(2))
    out = {}
    for dev in (device, "cpu"):
        target = init_params(cfg, seed=3, device="cpu").to_device(dev)
        cross = encode_cross_kv(target, torch.from_numpy(mel[[0, 1, 2, 0]]).to(dev))
        kv = KVCache(torch.from_numpy(k0.copy()).to(dev), torch.from_numpy(v0.copy()).to(dev))
        logits, kv = decoder_window_multipos(target, torch.from_numpy(toks).to(dev),
                                             torch.from_numpy(offsets).to(dev), kv, cross)
        out[dev] = (logits.cpu(), kv.k.cpu(), kv.v.cpu())
    written = np.zeros((4, 128), bool)
    for b, o in enumerate(offsets):
        written[b, o:min(o + 5, 128)] = True
    for a, init in zip(out[device][1:], (k0, v0)):
        if not np.array_equal(np.moveaxis(a.numpy(), -1, 2)[:, ~written],
                              np.moveaxis(init, -1, 2)[:, ~written]):
            raise AssertionError("the window wrote a position outside its rows' windows")
    errs = {name: float((c - h).abs().max())
            for name, c, h in zip(("logits", "k", "v"), out[device], out["cpu"])}
    if max(errs.values()) > SPEC_TOL:
        raise AssertionError(f"the window on the card differs from the CPU: {errs}")
    rec["window"] = {"offsets": offsets.tolist(), "cache": 128, "W": 5,
                     **{f"{n}_max_abs_err": e for n, e in errs.items()}}
    return rec


# ------------------------------------------------------------- data parallelism
DP_LONG_S = 75  # a request the router splits into 3 windows over the fleet
DP_FLAGS = ("--dp", "2", "--model_type", "turbo", *GREEDY)
REF_LONG_S = 45  # the reference's request over 30 s: 2 windows
N_REF_CLIPS = 6
REF_FLAGS = ("--model_type", "tiny", "--dtype", "float32", "--no-w8a8", "--max_tokens", "24",
             *GREEDY)
DATA_MESHES = ((2, 1), (2, 2), (4, 1))
MESH_PIPELINE = dict(model="turbo", device="cuda", compute_dtype="bfloat16", quantize=True,
                     w8a8=True, kv_quant=True, self_kv_quant=True, max_tokens=N_TOKENS, seed=0)


def _free_ports(n: int) -> int:
    """A base port p with p .. p + n - 1 free on 127.0.0.1 (a fleet's router
    and its workers)."""
    rng = np.random.default_rng()
    for _ in range(200):
        base = int(rng.integers(20000, 60000))
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports")


def _alive(pid: int) -> bool:
    """Whether process ``pid`` still runs (a zombie has ended)."""
    try:
        os.kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (ProcessLookupError, FileNotFoundError):
        return False


class _Served:
    """``python -m whisper_tpu_torch.serving`` with ``flags`` as a process
    of its own on 127.0.0.1 (its own session, so its workers can be found
    and killed as one group), every replica on this card
    (``CUDA_VISIBLE_DEVICES``): up once it prints its ready line; its
    standard error (and its workers') is kept in ``lines``."""

    def __init__(self, flags, workers: int = 0, timeout_s: float = 600):
        port = _free_ports(1 + workers)
        card = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
        self.url = f"http://127.0.0.1:{port}"
        self.lines = []
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "whisper_tpu_torch.serving", "--host", "127.0.0.1",
             "--port", str(port), *flags],
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=card), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        threading.Thread(target=self._read, daemon=True).start()
        self.t0 = t0  # the spawn
        ready = "router on" if workers else "server on"
        while not any(ready in line for line in self.lines):
            if self.proc.poll() is not None or time.perf_counter() - t0 > timeout_s:
                self.kill()
                raise AssertionError(f"{flags} did not come up: " + "\n".join(self.lines[-20:]))
            time.sleep(0.2)
        self.startup_s = time.perf_counter() - t0

    def _read(self):
        for line in self.proc.stderr:
            self.lines.append(line.rstrip())

    def worker_pids(self) -> list:
        line = next(x for x in self.lines if "router on" in x)
        return [int(p) for p in re.search(r"pids \[([\d, ]+)\]", line).group(1).split(",")]

    def metrics(self) -> dict:
        with urllib.request.urlopen(f"{self.url}/metrics", timeout=60) as r:
            return json.load(r)

    def terminate(self) -> int:
        """SIGTERM, as a service manager stops it; its exit code."""
        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(timeout=60)

    def kill(self):
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait(timeout=60)


def _fleet_counts(m0: dict, m1: dict, cfg, path: str) -> dict:
    """Each worker's kernel launches and engine counters between the router
    ``/metrics`` reads ``m0`` and ``m1`` (the workers' own ``/metrics``
    rows), each worker's launches held to exactly what its encodes, steps
    and detection steps launch (``_expect``; ladder off, so no aux work);
    returns the launches summed over the fleet."""
    total = {}
    for b0, b1 in zip(m0["backends"], m1["backends"]):
        for k, n in _worker_counts(b0, b1, cfg, f"{path} {b1['url']}").items():
            total[k] = total.get(k, 0) + n
    return total


def _worker_counts(b0: dict, b1: dict, cfg, path: str) -> dict:
    """One server process's kernel launches between its ``/metrics`` reads
    ``b0`` and ``b1``, held to exactly what its encodes, steps and
    detection steps launch (``_expect``; no aux work)."""
    launches = {k: n - b0["kernel_launches"][k] for k, n in b1["kernel_launches"].items()}
    d = {k: b1[k] - b0[k] for k in ("encode_batches_total", "aux_batches_total", "steps_total",
                                    "aux_steps_total", "detect_batches_total")}
    _expect(f"{path} ({d})", launches, cfg, d["encode_batches_total"] + d["aux_batches_total"],
            d["steps_total"] + d["aux_steps_total"], detects=d["detect_batches_total"])
    return launches


def dp_router(counters) -> dict:
    """The data-parallel fleet: ``python -m whisper_tpu_torch.serving --dp 2``
    at turbo (the server's defaults, ladder off) as a process of its own,
    both workers on this card. The 24-clip burst of the serving phase, one
    75 s request (split by the router into 3 windows over both workers) and
    the same request streamed (window partials relayed in window order),
    through the router; the workers' launches read from their ``/metrics``
    and held exact; then SIGTERM, after which no worker may be alive."""
    from whisper_tpu_torch.config import get_config

    rng = np.random.default_rng(2)
    clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in rng.uniform(2.0, 30.0, N_REQUESTS)]
    long = (np.random.default_rng(12).standard_normal(16000 * DP_LONG_S) * 0.1).astype(np.float32)
    fleet = _Served(DP_FLAGS, workers=2)
    try:
        url = f"{fleet.url}/asr"
        pids = fleet.worker_pids()
        # one warm request each (least-in-flight sends two at once apart)
        with ThreadPoolExecutor(2) as pool:
            warm = list(pool.map(lambda i: _ask(url, clips[i][:16000 * 3]), range(2)))
        m0 = fleet.metrics()
        if [b["router_requests"] for b in m0["backends"]] != [1, 1] or any(
                code != 200 for code, _, _ in warm):
            raise AssertionError(f"warm requests: {warm}, {m0['backends']}")
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_REQUESTS) as pool:
            replies = list(pool.map(lambda i: _ask(url, clips[i], multipart=i % 6 == 0),
                                    range(N_REQUESTS)))
        wall = time.perf_counter() - t0
        m_burst = fleet.metrics()
        code, split, split_s = _ask(url, long)
        scode, lines, stream_s = _ask(url, long, {"stream": "1"})
        m1 = fleet.metrics()
        if any(fn.launches for fn in counters):
            raise AssertionError("the fleet's kernels ran in this process")
    except BaseException:
        fleet.kill()
        raise
    rc = fleet.terminate()
    alive = [p for p in pids if _alive(p)]
    fleet.kill()  # nothing should be left in its group: a no-op then
    if rc != 0 or alive:
        raise AssertionError(f"after SIGTERM: exit {rc}, workers alive {alive}")
    bad = [(c, r) for c, r, _ in replies if c != 200 or not r.get("success")]
    if bad:
        raise AssertionError(f"{len(bad)} of {N_REQUESTS} replies failed: {bad[:3]}")
    if code != 200 or split.get("split") != "router" or split.get("windows") != 3:
        raise AssertionError(f"the {DP_LONG_S} s request: {code} {split}")
    final, partials = lines[-1], [x for x in lines[:-1] if "partial" in x]
    windows = [p["window"] for p in partials]
    if (scode != 200 or not final.get("success") or final.get("split") != "router"
            or final.get("windows") != 3 or not partials or windows != sorted(windows)):
        raise AssertionError(f"the streamed {DP_LONG_S} s request: {scode} {lines[-3:]}")
    per = [b["router_requests"] - a["router_requests"]
           for a, b in zip(m0["backends"], m1["backends"])]
    if min(per) < 1 or m1["router_split_requests"] - m0["router_split_requests"] != 2:
        raise AssertionError(f"fan-out {per}, splits {m1['router_split_requests']}")
    cfg = get_config("turbo")
    burst = _fleet_counts(m0, m_burst, cfg, "dp_router burst")
    launches = _fleet_counts(m0, m1, cfg, "dp_router")
    lat = np.array([sec for _, _, sec in replies])
    audio_s = sum(len(c) for c in clips) / 16000
    up = next(x for x in fleet.lines if "router on" in x)
    return {"phase": "dp_router", "model": "turbo", "dp": 2,
            "flags": "--dp 2, server defaults, --temperature_fallback '' "
                     "(both workers on this card: CUDA_VISIBLE_DEVICES)",
            "startup_s": fleet.startup_s,
            "workers_up_s": float(re.search(r"workers up in ([\d.]+)s", up).group(1)),
            "requests": N_REQUESTS, "wall_s": wall, "requests_per_s": N_REQUESTS / wall,
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p95_s": float(np.percentile(lat, 95)),
            "audio_s_per_s": audio_s / wall,
            "burst_router_requests": [b["router_requests"] - a["router_requests"]
                                      for a, b in zip(m0["backends"], m_burst["backends"])],
            "router_requests": [b["router_requests"] for b in m1["backends"]],
            "router_split_requests": m1["router_split_requests"],
            "split_windows": split["windows"], "split_s": split_s,
            "split_tokens": split["tokens"], "stream_s": stream_s,
            "stream_partial_windows": windows, "stream_windows": final["windows"],
            "worker_pids": pids, "sigterm_exit": rc, "workers_alive_after": alive,
            "burst_launches": burst, "launches": launches}


def router_reference_check() -> dict:
    """tiny, fp32, int8 cross- and self-KV, ladder off, the seeded weights
    of the other reference phases (written as a ``.pt`` both servers load):
    six clips one at a time and one 45 s request (2 windows, split by the
    router over both workers) to a ``--dp 2`` fleet on the card, and the
    same to the single-engine server on the card (which windows the long
    one itself): the texts must be equal."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.params import init_params

    rng = np.random.default_rng(14)
    clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in rng.uniform(2.0, 12.0, N_REF_CLIPS)]
    clips.append((rng.standard_normal(16000 * REF_LONG_S) * 0.1).astype(np.float32))
    texts, replies = {}, {}
    served = {}
    folder = tempfile.TemporaryDirectory()
    pt = os.path.join(folder.name, "tiny.pt")
    _write_openai_pt(init_params(get_config("tiny"), seed=3, device="cpu"), pt)
    try:
        for name, extra, workers in (("fleet", ["--dp", "2"], 2), ("single", [], 0)):
            served[name] = _Served([*extra, *REF_FLAGS, "--checkpoint", pt], workers=workers)
        for name, srv in served.items():
            out = [_ask(f"{srv.url}/asr", c) for c in clips]
            if any(code != 200 for code, _, _ in out):
                raise AssertionError(f"{name}: {[r for _, r, _ in out]}")
            replies[name] = [r for _, r, _ in out]
            texts[name] = [r["text"] for r in replies[name]]
        m = served["fleet"].metrics()
    finally:
        for srv in served.values():
            srv.kill()
        folder.cleanup()
    if texts["fleet"] != texts["single"]:
        raise AssertionError(f"fleet texts differ from the single server's: {texts}")
    long_fleet, long_single = replies["fleet"][-1], replies["single"][-1]
    if long_fleet.get("split") != "router" or long_fleet["windows"] != long_single["windows"]:
        raise AssertionError(f"the {REF_LONG_S} s request: {long_fleet} vs {long_single}")
    per = [b["router_requests"] for b in m["backends"]]
    if min(per) < 1:
        raise AssertionError(f"the fleet's backends served {per}")
    return {"phase": "router_reference", "model": "tiny", "dtype": "float32",
            "texts_equal_single_server": True, "windows": long_fleet["windows"],
            "router_requests": per, "texts": texts["fleet"]}


def _replayed(what: str, model, results) -> dict:
    """The captured rounds of ``model`` (``decode.graph_stats``) after its
    decodes ``results``, each of a key of its own: every round a replay but
    each key's first, which captured it."""
    from whisper_tpu_torch.decode import graph_stats

    stats = graph_stats(model)
    syncs = sum(r.host_syncs for r in results)
    if not stats or stats["captures"] != len(results) or \
            stats["replays"] != syncs - len(results):
        raise AssertionError(f"{what}: {len(results)} decodes of {syncs} rounds left the "
                             f"graphs {stats}")
    return {"captures": stats["captures"], "replays": stats["replays"],
            "capture_s": sum(stats["capture_s"].values()), "pool_bytes": stats["pool_bytes"]}


def data_mesh(counters, device: str = "cuda") -> dict:
    """Meshes with data rows on the card (every block of a mesh on it):
    tiny fp32 greedy (int8 cross- and self-KV) at (2, 1), (2, 2) and
    (4, 1), beam 2 and the self-draft speculative decode (gamma 2) at
    (2, 2), each equal to the unsharded model's tokens and, on the card,
    replayed as CUDA graphs (every round but a key's first); the turbo
    W8A8 encoder at (2, 1) and (2, 2) bit-equal to the unsharded one; then
    the offline path (turbo B64 / 64 tokens / kvq+skvq+w8a8 / bf16,
    ``transcribe_batch``) with its model placed at (2, 1), its rounds
    captured, timed beside the unsharded model and beside the same
    placement with its rounds uncaptured (``decode.capturable`` off) in
    the same process, its launches exact (every block a K1 launch a layer,
    each also K1s's: 32 layers x 2 data rows x 1 rank); and its decode, on
    the inputs ``transcribe_batch`` gave it, graphed against its rounds
    uncaptured (``_three_ways``): bit-equal, launches exact, the graphed
    decode's capture seconds and pool bytes. Returns the record and the
    unsharded offline pipeline and clips. ``device`` (and
    ``MESH_PIPELINE``) let it rehearse on the CPU."""
    from whisper_tpu_torch import decode
    from whisper_tpu_torch.beam import beam_search
    from whisper_tpu_torch.config import N_SAMPLES, get_config
    from whisper_tpu_torch.decode import encode_cross_kv, greedy_decode
    from whisper_tpu_torch.models.model import DataParallelWhisper, encoder_forward
    from whisper_tpu_torch.ops.mel import log_mel_batch
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.parallel.sharding import make_mesh, shard_params
    from whisper_tpu_torch.pipeline import WhisperPipeline
    from whisper_tpu_torch.spec_decode import speculative_decode_kv

    dev = torch.device(device)

    def mesh(n_data, tp):
        return make_mesh(n_data, tp, devices=[dev] * (n_data * tp))

    rec = {"phase": "data_mesh", "meshes_tiny": [list(s) for s in DATA_MESHES]}
    cfg = get_config("tiny")
    tiny = init_params(cfg, seed=3, device="cpu").to_device(dev)
    rng = np.random.default_rng(13)
    mel = torch.from_numpy(rng.standard_normal((4, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(
        np.float32)).to(dev)
    prompt = torch.tensor([cfg.sot_sequence("en")] * 4, device=dev)
    kw = dict(max_tokens=12, kv_quant=True, self_kv_quant=True)
    graphed = decode.capturable(tiny, dev)
    ref = greedy_decode(tiny, mel, prompt, **kw).tokens
    rec["tiny_graphs"] = {}
    for shape in DATA_MESHES:
        m = shard_params(tiny, mesh(*shape))
        got = greedy_decode(m, mel, prompt, **kw)
        if not torch.equal(got.tokens, ref):
            raise AssertionError(f"tiny greedy at {shape} differs from unsharded")
        if graphed:
            rec["tiny_graphs"][f"greedy {shape}"] = _replayed(f"tiny greedy at {shape}", m,
                                                              [got])
    m22 = shard_params(tiny, mesh(2, 2))
    beams = [beam_search(m, mel, prompt, beam_size=2, **kw) for m in (tiny, m22)]
    if not torch.equal(beams[0].tokens, beams[1].tokens):
        raise AssertionError("tiny beam 2 at (2, 2) differs from unsharded")
    spec = []
    for m in (tiny, m22):
        cross = encode_cross_kv(m, mel, kv_quant=True)
        spec.append(speculative_decode_kv(m, cross, m, cross, prompt, gamma=2, max_tokens=12,
                                          self_kv_quant=True))
    if not torch.equal(spec[0].tokens, spec[1].tokens):
        raise AssertionError("tiny self-draft spec at (2, 2) differs from unsharded")
    if graphed:
        rec["tiny_graphs"]["beam and spec (2, 2)"] = _replayed(
            "tiny beam and spec at (2, 2)", m22, [beams[1], spec[1]])
        if not sum(g["replays"] for g in rec["tiny_graphs"].values()):
            raise AssertionError("no tiny mesh decode replayed a round")
    rec.update({"tiny_greedy_equal": True, "tiny_beam_equal": True, "tiny_spec_equal": True,
                "tiny_spec_equals_greedy": bool(torch.equal(spec[0].tokens, ref))})
    del tiny, m22

    # the offline path, unsharded then at (2, 1), in turns of warm + timed
    pipe = WhisperPipeline(**MESH_PIPELINE)
    audio = np.random.default_rng(0).standard_normal((B, N_SAMPLES)).astype(np.float32) * 0.1
    clips = list(audio)
    one = pipe.model
    m21 = shard_params(one, mesh(2, 1))
    walls, toks = {}, {}
    for name, model, captured in (("unsharded", one, True), ("(2, 1)", m21, True),
                                  ("(2, 1) uncaptured", m21, False)):
        pipe.model = model
        if name == "(2, 1)":  # its warm call gives the decode's inputs
            caught = _greedy_args(pipe, clips)
        elif captured:
            pipe.transcribe_batch(clips)  # warm
        torch.cuda.synchronize()
        real = decode.capturable
        decode.capturable = real if captured else (lambda model, device: False)
        try:
            for fn in counters:
                fn.launches = 0
            t0 = time.perf_counter()
            pipe.transcribe_batch(clips)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        finally:
            decode.capturable = real
        launches = _launches(counters)
        blocks = 2 if isinstance(model, DataParallelWhisper) else 1
        _expect(f"data_mesh offline {name}", launches, pipe.cfg, 1,
                pipe.last_decode.device_steps, tp=blocks)
        toks[name] = pipe.last_decode.tokens
        if name == "(2, 1)":
            rec["launches"] = launches
            if launches["flash_attention_btd_sharded"] != pipe.cfg.n_audio_layer * 2:
                raise AssertionError(f"K1s ran {launches['flash_attention_btd_sharded']} times")
    pipe.model = one
    if not torch.equal(toks["(2, 1)"], toks["(2, 1) uncaptured"]):
        raise AssertionError("data_mesh offline (2, 1): graphed and uncaptured tokens differ")
    rec.update({"offline": f"{pipe.cfg.name} B{B} / {N_TOKENS} tokens / kvq+skvq+w8a8 / "
                           f"{MESH_PIPELINE['compute_dtype']}, transcribe_batch",
                "wall_s": walls["(2, 1)"], "unsharded_wall_s": walls["unsharded"],
                "uncaptured_wall_s": walls["(2, 1) uncaptured"],
                "wall_ratio": walls["(2, 1)"] / walls["unsharded"],
                "uncaptured_wall_ratio": walls["(2, 1) uncaptured"] / walls["unsharded"],
                "tokens_equal_unsharded_rows": int((toks["(2, 1)"] == toks["unsharded"])
                                                   .all(dim=1).sum()),
                "k1s_launches": rec["launches"]["flash_attention_btd_sharded"]})
    # the (2, 1) decode alone: graphed against its rounds uncaptured
    model, cross, prompt, dt, kw = caught
    args = (model, cross, prompt, dt, kw["max_tokens"], kw["suppress_ids"],
            kw["apply_filters"], kw["self_kv_quant"], kw["gelu"], kw["timestamps"],
            kw.get("prompt_pad"), kw["sot_index"], kw.get("cross_decode", "fd"))
    ways = {"graphed": lambda: decode.greedy_decode_kv(model, cross, prompt, dt, **kw),
            "uncaptured": lambda: decode._greedy_rounds(*args, 0.0, 0, None, False)}
    loops, results = _three_ways(
        "data_mesh (2, 1) decode", ways, counters,
        lambda what, launches, res: _expect(what, launches, pipe.cfg, 0, res.device_steps,
                                            tp=2))
    _bit_equal("data_mesh (2, 1) decode: graphed against uncaptured", results["graphed"],
               results["uncaptured"], DECODE_FIELDS)
    loops["bit_equal"] = list(DECODE_FIELDS)
    loops["graphs"] = decode.graph_stats(m21) if decode.capturable(m21, dev) else None
    rec["decode_2x1"] = loops
    del model, cross, caught, m21
    # the W8A8 encoder over 4 clips' mel, bit for bit
    enc_clips = np.zeros((4, N_SAMPLES), np.float32)
    enc_clips[:] = audio[:4]
    mel4 = log_mel_batch(torch.from_numpy(enc_clips).to(dev),
                         torch.full((4,), N_SAMPLES, device=dev),
                         n_mels=pipe.cfg.n_mels)[..., : 2 * pipe.cfg.n_audio_ctx]
    dt = pipe.compute_dtype
    want = encoder_forward(one, mel4, dt, w8a8=True)
    for shape in ((2, 1), (2, 2)):
        got = encoder_forward(shard_params(one, mesh(*shape)), mel4, dt, w8a8=True)
        if not torch.equal(got, want):
            raise AssertionError(f"the W8A8 encoder at {shape} differs from unsharded by "
                                 f"{float((got - want).abs().max())}")
    rec["w8a8_encoder_bit_equal"] = ["(2, 1)", "(2, 2)"]
    return rec, pipe, clips


def utils_phase(pipe, clips) -> dict:
    """The port's utils on the card: a ``StageTimer`` around the offline
    run's stages (the pipeline's mel, encode, decode and text calls, each
    synchronized), ``profiler_trace`` around one turbo decode step (the
    trace file's bytes and its kernels of the card), and the native IO
    library where cmake can build it (its WAV parse and edit distance
    against the numpy and Python versions)."""
    import shutil

    import whisper_tpu_torch.pipeline as pl
    from whisper_tpu_torch.decode import encode_cross_kv
    from whisper_tpu_torch.eval import wer
    from whisper_tpu_torch.models.model import decoder_forward, new_kv_cache
    from whisper_tpu_torch.ops import audio as au
    from whisper_tpu_torch.utils import native
    from whisper_tpu_torch.utils.profiling import StageTimer, profiler_trace

    timer = StageTimer()
    stages = ("log_mel_batch", "encode_cross_kv", "greedy_decode_kv", "extract_texts")
    saved = {name: getattr(pl, name) for name in stages}

    def timed(name, fn):
        def run(*a, **kw):
            with timer.stage(name):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            return out
        return run

    for name, fn in saved.items():
        setattr(pl, name, timed(name, fn))
    try:
        t0 = time.perf_counter()
        pipe.transcribe_batch(clips)
        wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(pl, name, fn)
    timer.add_audio(len(clips) * 30.0)
    report = timer.report()
    if set(report["stages"]) != set(stages):
        raise AssertionError(f"stages timed: {list(report['stages'])}")

    # one decode step of the offline model at 8 rows, traced
    dt, dev, cfg, n = pipe.compute_dtype, pipe.device, pipe.cfg, min(8, len(clips))
    mel = pl.log_mel_batch(torch.from_numpy(np.stack(clips[:n])).to(dev),
                           torch.full((n,), 480000, device=dev),
                           n_mels=cfg.n_mels)[..., : 2 * cfg.n_audio_ctx]
    cross = encode_cross_kv(pipe.model, mel, dt, kv_quant=True, w8a8=True)
    kv = new_kv_cache(pipe.model, n, dt, 128, quant=True)
    prompt = torch.tensor([cfg.sot_sequence("zh")] * n, device=dev)
    logits, kv = decoder_forward(pipe.model, prompt, 0, kv, cross, dt)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with profiler_trace(logdir) as path:
            decoder_forward(pipe.model, nxt, prompt.shape[1], kv, cross, dt)
            torch.cuda.synchronize()
        trace_bytes = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})

    rec = {"phase": "utils", "stage_timer": report, "timed_wall_s": wall,
           "trace_bytes": trace_bytes, "trace_kernels": len(kernels),
           "trace_kernel_names": kernels[:12]}
    with tempfile.TemporaryDirectory() as build:
        if shutil.which("cmake"):
            cpp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
            made = subprocess.run(f"cmake -S {cpp} -B {build} -DCMAKE_BUILD_TYPE=Release "
                                  f"&& make -C {build} -j8 whisper_tpu", shell=True,
                                  capture_output=True, text=True)
            if made.returncode == 0:
                os.environ["WHISPER_TPU_NATIVE_LIB"] = os.path.join(build, "libwhisper_tpu.so")
        native.load_native.cache_clear()
        try:
            rec["native"] = "loaded" if native.native_available() else "absent"
            if rec["native"] == "loaded":
                x = np.random.default_rng(15).standard_normal(16000 * 2) * 0.2
                data = _wav(x)
                got, rate = native.load_wav_native(data, 16000)
                want = au.to_mono(au.parse_wav(data)[0])
                err = float(np.abs(got - want).max())
                pairs = [("kitten", "sitting"), ("今天天气", "今天天汽"), ("", "abc")]
                dist = [native.edit_distance_native(a, b) for a, b in pairs]
                if rate != 16000 or err > 1e-7 or dist != [wer._levenshtein(a, b)
                                                            for a, b in pairs]:
                    raise AssertionError(f"native: rate {rate}, wav err {err}, distances {dist}")
                rec.update({"native_wav_max_abs_err": err, "native_edit_distances": dist})
        finally:
            os.environ.pop("WHISPER_TPU_NATIVE_LIB", None)
            native.load_native.cache_clear()
    return rec


# ------------------------------------- the engine's knobs and weights day
N_FILTER_REQUESTS = 8
N_BUCKET_REQUESTS = 12
BUCKETS = (1, 8)  # the buckets phase's prefill_buckets
COLD_CLIP_S = 30  # cold_start's clips
# the slot bookkeeping warmup() must leave bit-equal
BOOKKEEPING = ("tokens", "offsets", "active", "done", "limit", "fstate", "nsp", "pads")
WEIGHTS_DAY_KEYS = ("dry_run", "sizes", "device", "fetch", "golden", "quant_gate", "wer",
                    "silence_gate", "longform", "merge_sweep", "serving_golden",
                    "serving_spots", "wall_seconds")


def _slot_state(engine) -> dict:
    """Copies of an engine's slot bookkeeping, its rule state included."""
    state = {name: getattr(engine, name).clone() for name in BOOKKEEPING}
    state.update({f"rs.{k}": v.clone() for k, v in engine.rs._asdict().items()})
    return state


def _cache_parts(x) -> list:
    from whisper_tpu_torch.models.model import shard_values

    return [t for part in shard_values(x) for t in part]


def _warm_diff(engine, before: dict, kv0: list, cross0: list) -> dict:
    """What a warm changed: the bookkeeping must be bit-equal and the
    cross-KV too; of the self-KV, the bytes at each slot's step position
    ``clamp(offset - 1, 0)`` (rewritten by the step of an empty slot, and
    overwritten whole by admission before a slot reads them) are counted,
    and any other byte fails."""
    after = _slot_state(engine)
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    if changed:
        raise AssertionError(f"warmup() changed the slot bookkeeping: {changed}")
    if not all(torch.equal(a, b) for a, b in zip(cross0, _cache_parts(engine.cross))):
        raise AssertionError("warmup() wrote the cross-KV")
    pos = torch.clamp(before["offsets"] - 1, min=0)
    at_pos = elsewhere = 0
    for a, b in zip(kv0, _cache_parts(engine.kv)):
        a, b = a.movedim(-1, 2), b.movedim(-1, 2)  # (L, slot, position, ...)
        mask = torch.zeros(a.shape[1:3], dtype=torch.bool, device=a.device)
        mask[torch.arange(a.shape[1], device=a.device), pos.to(a.device)] = True
        diff = a != b
        at_pos += int(diff[:, mask].sum()) * a.element_size()
        elsewhere += int(diff[:, ~mask].sum()) * a.element_size()
    if elsewhere:
        raise AssertionError(f"warmup() wrote {elsewhere} self-KV bytes off the step positions")
    return {"bookkeeping_bit_equal": True, "cross_kv_bit_equal": True,
            "self_kv_bytes_written_at_step_position": at_pos,
            "self_kv_step_positions": sorted(set(pos.tolist()))}


def serving_warm(counters) -> dict:
    """The turbo server's engine at its defaults (ladder off) and its warm
    start (``warmup()``, what ``start()`` runs under ``--warm_start``):
    its seconds, the keys it ran and its launches (held exact: one encode
    and one detection step a bucket, one round of ``steps_per_sync``
    steps); the slot bookkeeping and the cross-KV bit-equal across it;
    then the 24-clip burst of ``serving`` with no warm request, during
    which ``cold_compiles_total`` must not move, its launches exact."""
    from whisper_tpu_torch.serving.__main__ import build_engine, parse_args

    args = parse_args(["--model_type", "turbo", *GREEDY])
    t0 = time.perf_counter()
    engine, phases = build_engine(args)
    before = _slot_state(engine)
    kv0 = [t.clone() for t in _cache_parts(engine.kv)]
    cross0 = [t.clone() for t in _cache_parts(engine.cross)]
    for fn in counters:
        fn.launches = 0
    engine.warmup()
    warm_launches = _launches(counters)
    build_warm_s = time.perf_counter() - t0
    _expect("serving_warm warmup()", warm_launches, engine.cfg, len(engine.prefill_buckets),
            engine.steps_per_sync, detects=len(engine.prefill_buckets))
    state = _warm_diff(engine, before, kv0, cross0)
    cold0, keys = engine.stats.cold_compiles_total, sorted(engine._warm_keys)
    if engine._graphs is None or ("step", engine.steps_per_sync) not in engine._graphs:
        raise AssertionError("warmup() did not capture the step round")
    graphs_warm = engine._graphs.stats()
    rec = serving(counters, GREEDY, phase="serving_warm", built=(engine, phases),
                  warm_request=False)
    if engine.stats.cold_compiles_total != cold0:
        raise AssertionError(f"the burst ran cold keys: {sorted(engine._warm_keys - set(keys))}")
    rec.update({"build_and_warm_s": build_warm_s, "warm_keys": [list(k) for k in keys],
                "cold_compiles_total": cold0, "cold_compiles_in_burst": 0,
                "step_graphs_after_warmup": graphs_warm,
                "step_graphs_after_burst": engine._graphs.stats(),
                "warmup_launches": warm_launches, **state})
    return rec


def _health_s(url: str, t0: float, timeout_s: float = 600) -> float:
    """Seconds from ``t0`` to the first ``/health`` 200 of ``url``."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        try:
            with urllib.request.urlopen(f"{url}/health", timeout=5) as r:
                if r.status == 200:
                    return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.05)
    raise AssertionError(f"{url} never answered /health")


def cold_start(counters) -> dict:
    """Two fresh ``python -m whisper_tpu_torch.serving`` processes at turbo
    (the server's defaults, ladder off), one with the default warm start and
    one with ``--no-warm_start``, one after the other: the seconds from
    spawn to the first ``/health`` 200, then the latency of a first and a
    second 30 s clip, each server's launches over the two held exact (from
    its ``/metrics``), then SIGTERM, after which no process may be left."""
    from whisper_tpu_torch.config import get_config

    for fn in counters:
        fn.launches = 0
    rng = np.random.default_rng(17)
    clips = [(rng.standard_normal(16000 * COLD_CLIP_S) * 0.1).astype(np.float32)
             for _ in range(2)]
    cfg = get_config("turbo")
    out = {"phase": "cold_start", "model": "turbo",
           "flags": "server defaults, --temperature_fallback ''", "clip_s": COLD_CLIP_S}
    total = {}
    for name, extra in (("warm_start", ()), ("no_warm_start", ("--no-warm_start",))):
        srv = _Served(("--model_type", "turbo", *GREEDY, *extra))
        try:
            health_s = _health_s(srv.url, srv.t0)
            m0 = srv.metrics()
            replies = [_ask(f"{srv.url}/asr", c) for c in clips]
            m1 = srv.metrics()
            if any(code != 200 or not r.get("success") for code, r, _ in replies):
                raise AssertionError(f"cold_start {name}: {[r for _, r, _ in replies]}")
            launches = _worker_counts(m0, m1, cfg, f"cold_start {name}")
        except BaseException:
            srv.kill()
            raise
        pid = srv.proc.pid
        rc = srv.terminate()
        alive = _alive(pid)
        srv.kill()  # nothing should be left in its group: a no-op then
        if rc not in (0, -signal.SIGTERM) or alive:
            raise AssertionError(f"cold_start {name} after SIGTERM: exit {rc}, alive {alive}")
        up = next(x for x in srv.lines if "server on" in x)
        out[name] = {"health_s": health_s, "ready_line_s": srv.startup_s,
                     "warmup_s": float(re.search(r"warmup ([\d.]+)s", up).group(1)),
                     "first_clip_s": replies[0][2], "second_clip_s": replies[1][2],
                     "tokens": [r["tokens"] for _, r, _ in replies],
                     "texts": [r["text"] for _, r, _ in replies],
                     "cold_compiles_before_clips": m0["cold_compiles_total"],
                     "cold_compiles_during_clips": m1["cold_compiles_total"]
                     - m0["cold_compiles_total"],
                     "sigterm_exit": rc, "alive_after": alive, "launches": launches}
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    if any(fn.launches for fn in counters):
        raise AssertionError("the servers' kernels ran in this process")
    if out["warm_start"]["cold_compiles_during_clips"]:
        raise AssertionError(f"the warmed server ran cold keys: {out['warm_start']}")
    # the cold server captures its step round at its first use, the encode
    # thread live: the same replies
    if any(out["warm_start"][k] != out["no_warm_start"][k] for k in ("tokens", "texts")):
        raise AssertionError("the cold server's replies differ from the warmed server's")
    out["launches"] = total
    return out


def _engine_burst(counters, engine, args, clips, path: str, wrap_encode: bool = False):
    """``clips`` submitted at once to ``engine`` (language default; an
    engine not started yet is started without its warm after the last
    submit, so the first admission takes what the queue holds), their
    replies, the engine counters' change and launches held exact
    (``_served_counts``), then the engine stopped. With ``wrap_encode``,
    also the (rows, bucket) of every admission encode."""
    from whisper_tpu_torch.serving.engine import Request

    encodes = []
    if wrap_encode:
        real = engine._encode

        def encode(reqs, bucket):
            encodes.append((len(reqs), bucket))
            return real(reqs, bucket)

        engine._encode = encode
    try:
        st0 = engine.stats.snapshot()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        futs = [engine.submit(Request(audio=c)) for c in clips]
        if engine._thread is None:
            engine.start(warm=False)
        replies = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = _launches(counters)
        st1 = engine.stats.snapshot()
    finally:
        engine.stop()
    bad = [r for r in replies if not r.get("success") or not 0 <= r["tokens"] <= args.max_tokens]
    if bad:
        raise AssertionError(f"{path}: {len(bad)} of {len(clips)} replies failed: {bad[:3]}")
    delta = _served_counts(engine, args, st0, st1, launches, path)
    return replies, delta, launches, wall, encodes


def _burst_clips(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
            for s in rng.uniform(2.0, 30.0, n)]


def filters_off(counters) -> dict:
    """The turbo server's engine (defaults, ladder off) built with
    ``apply_filters=False`` (no suppress set) answers 8 clips: its steps
    launch what ``_expect`` predicts (the rules launch no kernel)."""
    from whisper_tpu_torch.serving.__main__ import build_engine, parse_args

    args = parse_args(["--model_type", "turbo", *GREEDY])
    engine, _ = build_engine(args, apply_filters=False)
    if engine._suppress is not None or engine._use_rules:
        raise AssertionError("apply_filters=False left the rules on")
    engine.start()
    replies, delta, launches, wall, _ = _engine_burst(
        counters, engine, args, _burst_clips(18, N_FILTER_REQUESTS), "filters_off")
    return {"phase": "filters_off", "model": "turbo", "requests": N_FILTER_REQUESTS,
            "flags": "server defaults, --temperature_fallback '', apply_filters=False",
            "wall_s": wall, "tokens": [r["tokens"] for r in replies],
            "steps": delta["steps_total"], "admission_batches": delta["encode_batches_total"],
            "launches": launches}


def buckets_phase(counters) -> dict:
    """The turbo server's engine (defaults, ladder off) built with
    ``prefill_buckets=(1, 8)``, warmed, answers 12 clips queued before its
    threads start: every admission encode runs at bucket 1 or 8 (the first
    a full 8), one K7 launch each, as many as ``encode_batches_total``
    counts, and every clip is encoded once."""
    from whisper_tpu_torch.serving.__main__ import build_engine, parse_args

    args = parse_args(["--model_type", "turbo", *GREEDY])
    engine, _ = build_engine(args, prefill_buckets=BUCKETS)
    engine.warmup()
    replies, delta, launches, wall, encodes = _engine_burst(
        counters, engine, args, _burst_clips(19, N_BUCKET_REQUESTS), "buckets",
        wrap_encode=True)
    batches = delta["encode_batches_total"]
    if ({b for _, b in encodes} - set(BUCKETS) or len(encodes) != batches
            or encodes[0] != (8, 8) or launches["log10_mel"] != batches
            or sum(n for n, _ in encodes) != N_BUCKET_REQUESTS):
        raise AssertionError(f"admissions {encodes}, {batches} batches, "
                             f"{launches['log10_mel']} K7 launches")
    prepared = sorted({k[1] for k in engine._warm_keys if k[0] == "prepare"})
    if prepared != list(BUCKETS):
        raise AssertionError(f"prepare keys at buckets {prepared}")
    return {"phase": "buckets", "model": "turbo", "prefill_buckets": list(BUCKETS),
            "requests": N_BUCKET_REQUESTS, "wall_s": wall,
            "admissions": [list(e) for e in encodes], "admission_batches": batches,
            "tokens": [r["tokens"] for r in replies], "launches": launches}


def filters_reference_check() -> dict:
    """tiny fp32 engines (kvq + skvq) built with ``apply_filters=False``,
    without and with ``timestamps`` (the grammar on, no suppress set), on
    the card and on the CPU, rounds driven one tick at a time: the tokens
    must be equal; a row that differs fails with its first divergence and
    the CPU's top-2 logit margin there."""
    from whisper_tpu_torch.config import get_config
    from whisper_tpu_torch.decode import encode_cross_kv
    from whisper_tpu_torch.models.model import KVCache, decoder_forward
    from whisper_tpu_torch.ops.mel import log_mel_batch
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request

    class IdText:
        non_speech_tokens = ()

        def decode(self, ids):
            return " ".join(str(int(t)) for t in ids)

        decode_with_timestamps = decode

    cfg = get_config("tiny")
    rng = np.random.default_rng(20)
    clips = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (5, 11, 3)]
    out = {}
    for timestamps in (False, True):
        got = {}
        for device in ("cuda", "cpu"):
            model = init_params(cfg, seed=3, device="cpu")  # the same draws on both
            engine = ContinuousBatchingEngine(
                model.to_device(device), IdText(), max_slots=4, compute_dtype=torch.float32,
                steps_per_sync=4, max_tokens=12, kv_quant=True, self_kv_quant=True,
                no_speech_threshold=None, logprob_threshold=None,
                compression_ratio_threshold=None, apply_filters=False, timestamps=timestamps,
                warm_start=False)
            futs = [engine.submit(Request(audio=c)) for c in clips]
            for _ in range(50):
                if all(f.done() for f in futs):
                    break
                engine._tick()
            got[device] = [[int(t) for t in f.result(0)["text"].split()] for f in futs]
        for i, (a, b) in enumerate(zip(got["cuda"], got["cpu"])):
            if a == b:
                continue
            t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            audio = np.zeros((1, 480000), np.float32)
            audio[0, : len(clips[i])] = clips[i]
            mel = log_mel_batch(torch.from_numpy(audio), torch.tensor([len(clips[i])]),
                                n_mels=cfg.n_mels)[..., : 2 * cfg.n_audio_ctx]
            prefix = list(cfg.sot_sequence("zh", "transcribe"))[: 3 if timestamps else 4] + b[:t]
            logits, _ = decoder_forward(model, torch.tensor([prefix]), 0,
                                        KVCache.create(cfg, 1, device="cpu"),
                                        encode_cross_kv(model, mel))
            top2 = torch.topk(logits[0, -1], 2).values
            raise AssertionError(
                f"apply_filters=False, timestamps={timestamps}: clip {i} on the card differs "
                f"from the CPU at token {t} ({a[t:t + 1]} vs {b[t:t + 1]}); the CPU's top-2 "
                f"margin there {float(top2[0] - top2[1]):.3g}")
        out[f"timestamps_{timestamps}".lower()] = got["cpu"]
    return {"phase": "filters_reference", "model": "tiny", "dtype": "float32",
            "apply_filters": False, "tokens_equal_cpu": True, "tokens": out}


def weights_day_phase(counters) -> dict:
    """``python -m whisper_tpu_torch.weights_day --dry-run --device cuda``
    (its default ``--serving_dp 2``, both workers on this card): its
    report's keys (those ``tests/test_weights_day.py`` holds of the JAX
    script's), the served golden decode's success, and its wall."""
    for fn in counters:
        fn.launches = 0
    card = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "whisper_tpu_torch.weights_day", "--dry-run", "--device",
             "cuda", "--workdir", work], env=dict(os.environ, CUDA_VISIBLE_DEVICES=card),
            capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"weights_day exited {proc.returncode}: "
                                 f"{proc.stdout[-3000:]} {proc.stderr[-3000:]}")
        with open(os.path.join(work, "weights_day_report.json"), encoding="utf-8") as f:
            report = json.load(f)
        with open(os.path.join(work, "weights_day_report.md"), encoding="utf-8") as f:
            md = f.read()
    missing = [k for k in WEIGHTS_DAY_KEYS if k not in report]
    if missing or report["serving_golden"].get("success") is not True or "DRY-RUN" not in md:
        raise AssertionError(f"weights_day report: missing {missing}, "
                             f"serving_golden {report.get('serving_golden')}")
    if any(fn.launches for fn in counters):
        raise AssertionError("the weights day's kernels ran in this process")
    return {"phase": "weights_day", "flags": "--dry-run --device cuda (--serving_dp 2)",
            "wall_s": wall, "report_wall_s": report["wall_seconds"], "keys": sorted(report),
            "wer": report["wer"], "quant_gate_rc": report["quant_gate"]["rc"],
            "golden_rtf": report["golden"]["rtf"],
            "serving_golden_success": report["serving_golden"]["success"],
            "serving_spots": len(report["serving_spots"])}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.utils.graphs import kernel_wrappers

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 checks run in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    build = _build.build_all()
    ptxas = {n: ptxas_report(n) for n in _build.KERNELS}
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build["build_s"], "ptxas": ptxas,
          "sass": sass_counts(_build.KERNELS)})
    serialized = serialized_wgmma(ptxas)
    if any(serialized.values()):
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")
    spilled = {n: spills(ptxas[n]) for n in ("cross_attention_decode", "self_attention_decode",
                                             "cross_attention_decode_dense", "log10_mel")}
    if any(spilled.values()):
        raise AssertionError(f"ptxas spilled registers in a decode or mel kernel: {spilled}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = []
    for phase in (kernel_k1, kernel_k2, kernel_k3, kernel_k7, kernel_k8, kernel_k8q, kernel_k6,
                  kernel_k4, kernel_k5, kernel_k1_sharded):
        kernels.append(phase(dev, gen))
        emit({"phase": "kernel", **kernels[-1]})
        torch.cuda.empty_cache()
    emit(w8a8_card_vs_cpu(dev))
    emit(w8a8_chain(dev, gen))
    torch.cuda.empty_cache()

    counters = kernel_wrappers()
    e2e, stages = end_to_end(counters)
    emit(e2e)
    emit(stages)
    torch.cuda.empty_cache()
    emit(decode_graph(counters, smi))
    torch.cuda.empty_cache()
    served = serving(counters, GREEDY)
    emit(served)
    torch.cuda.empty_cache()
    long = longform(counters)
    emit(long)
    torch.cuda.empty_cache()
    runs = {"btd+fd": e2e}
    for rec in variants(counters):
        emit(rec)
        runs[f"{rec['encoder_attention']}+{rec['cross_decode']}"] = rec
    served_variant = serving(counters, VARIANT_FLAGS + GREEDY, N_VARIANT_REQUESTS)
    emit(served_variant)
    torch.cuda.empty_cache()
    ladder = serving_ladder(counters)
    emit(ladder)
    torch.cuda.empty_cache()
    tp = tensor_parallel(counters)
    emit(tp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as folder:
        ckpt, pipe, clips, pt_path = checkpoint_phase(counters, folder)
        emit(ckpt)
        emit(language_detect(pipe, clips))
        del pipe
        torch.cuda.empty_cache()
        for rec in eval_phase(pt_path, folder):
            emit(rec)
    torch.cuda.empty_cache()
    auto = serving_auto(counters)
    emit(auto)
    torch.cuda.empty_cache()
    options = serving_options(counters)
    emit(options)
    torch.cuda.empty_cache()
    stamped = serving_timestamps(counters)
    emit(stamped)
    torch.cuda.empty_cache()
    paced = serving_paced(counters)
    emit(paced)
    torch.cuda.empty_cache()
    beams = beam_phase(counters)
    emit(beams)
    torch.cuda.empty_cache()
    served_beams = serving_beam(counters)
    emit(served_beams)
    torch.cuda.empty_cache()
    worded = words_phase(counters)
    emit(worded)
    torch.cuda.empty_cache()
    served_words = serving_words(counters)
    emit(served_words)
    torch.cuda.empty_cache()
    speculative = spec_phase(counters)
    emit(speculative)
    torch.cuda.empty_cache()
    fleet = dp_router(counters)
    emit(fleet)
    meshed, pipe, clips = data_mesh(counters)
    emit(meshed)
    emit(utils_phase(pipe, clips))
    del pipe
    torch.cuda.empty_cache()
    warmed = serving_warm(counters)
    emit(warmed)
    torch.cuda.empty_cache()
    cold = cold_start(counters)
    emit(cold)
    unfiltered = filters_off(counters)
    emit(unfiltered)
    torch.cuda.empty_cache()
    bucketed = buckets_phase(counters)
    emit(bucketed)
    torch.cuda.empty_cache()
    emit(weights_day_phase(counters))
    emit(reference_check())
    emit(serving_reference_check())
    emit(longform_reference_check())
    emit(tp_reference_check())
    emit(ladder_reference_check())
    emit(language_reference_check())
    emit(serving_auto_reference_check())
    emit(serving_options_reference_check())
    emit(beam_reference_check())
    emit(words_reference_check())
    emit(spec_reference_check())
    emit(router_reference_check())
    emit(filters_reference_check())
    emit({"phase": "profiler", **PROFILER_MISSES})

    # each kernel's counts from the runs of the path that selects it; the
    # flagged burst selects K6 and K5
    variant_burst = ("flash_attention", "cross_attention_decode_dense")
    own_run = {"flash_attention": "bhtd+legacy", "cross_attention_decode": "bhtd+legacy",
               "cross_attention_decode_dense": "bhtd+dense"}
    for k in kernels:
        name = k["name"]
        # K1s: its TP path's count (its data-mesh count beside it)
        k["launches"] = (tp if name == "flash_attention_btd_sharded" else
                         runs[own_run.get(name, "btd+fd")])["launches"][name]
        k["offline_launches"] = {sel: rec["launches"][name] for sel, rec in runs.items()}
        k["serving_launches"] = (served_variant if name in variant_burst
                                 else served)["launches"][name]
        k["longform_launches"] = long["launches"][name]
        k["ladder_launches"] = ladder["launches"][name]
        k["tp_launches"] = tp["launches"][name]
        k["checkpoint_launches"] = ckpt["launches"][name]
        k["serving_auto_launches"] = auto["launches"][name]
        for path, rec in (("serving_options", options), ("serving_timestamps", stamped),
                          ("serving_paced", paced), ("beam", beams),
                          ("serving_beam", served_beams), ("words", worded),
                          ("serving_words", served_words), ("spec", speculative),
                          ("dp_router", fleet), ("data_mesh", meshed),
                          ("serving_warm", warmed), ("cold_start", cold),
                          ("filters_off", unfiltered), ("buckets", bucketed)):
            k[f"{path}_launches"] = rec["launches"][name]
        if name == "self_attention_decode_int8":  # K3's float variant: the detection step
            k["float_launches"] = {path: rec["launches"]["self_attention_decode"]
                                   for path, rec in (("checkpoint", ckpt), ("serving_auto", auto))}
    keys = ("name", "route", "source", "replaces", "launches", "offline_launches",
            "serving_launches", "longform_launches", "ladder_launches", "tp_launches",
            "checkpoint_launches", "serving_auto_launches", "serving_options_launches",
            "serving_timestamps_launches", "serving_paced_launches", "beam_launches",
            "serving_beam_launches", "words_launches", "serving_words_launches",
            "spec_launches", "dp_router_launches", "data_mesh_launches",
            "serving_warm_launches", "cold_start_launches", "filters_off_launches",
            "buckets_launches", "float_launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k} for k in kernels]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
