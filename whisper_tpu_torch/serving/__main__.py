"""Server entry point: one continuous-batching engine behind the HTTP front
end, or a data-parallel fleet of them behind the router, as
``python -m whisper_tpu.serving``.

    python -m whisper_tpu_torch.serving --model_type turbo --port 8000
    python -m whisper_tpu_torch.serving --model_type turbo --tp 2 --port 8000
    python -m whisper_tpu_torch.serving --model_type turbo --max_beam_size 8 \
        --length_penalty 1.0 --port 8000   # then POST /asr?beam=5
    python -m whisper_tpu_torch.serving --model_type test-nano --device cpu \\
        --dtype float32 --no-w8a8 --port 8000

    # N data-parallel replicas behind one router on --port: worker i is a
    # subprocess on port + 1 + i, pinned to cards i*tp .. i*tp + tp - 1
    python -m whisper_tpu_torch.serving --dp 2 --model_type turbo --port 8000
    # both replicas on one card: a CUDA_VISIBLE_DEVICES set by the caller wins
    CUDA_VISIBLE_DEVICES=0 python -m whisper_tpu_torch.serving --dp 2 --port 8000

    # the router alone, in front of workers started elsewhere
    python -m whisper_tpu_torch.serving --backends http://h0:8001,http://h1:8001

The zero-flag defaults are the JAX server's benched configuration: 8 slots,
32 steps per sync, a 224-token budget, W8A8 + int8 cross- and self-KV,
bf16, on the card, with the default kernels (``--encoder_attention btd
--cross_decode fd``; the flags are the JAX package's ``WHISPER_TPU_FLASH``
and ``WHISPER_TPU_DECODE_FLASH``) and the JAX server's temperature ladder
``--temperature_fallback 0.2,0.4,0.6,0.8,1.0`` ('' turns it off).
``--checkpoint`` loads real weights (``models/checkpoint.load_checkpoint``
with ``--model_type`` as its size); without it the weights are the port's
seeded random init, so every request fails the logprob gate and climbs the
whole ladder. ``--tp N`` splits the model over the first N CUDA cards, as
the JAX server does over N chips, and exits non-zero without them.
``--timestamps`` decodes with timestamp tokens, ``--encode_chunks N`` splits
the admission encoder into N paced layer groups, ``--adaptive_sync`` sizes
rounds at 1, 2 or 4 times ``--steps_per_sync``, and ``--router_overlap_s``
is the overlap of the windows a request over 30 s is split into (the JAX
server passes it to its engines and its router). ``--max_beam_size`` caps a
request's ``beam`` (above it: a 400) and ``--length_penalty`` is the beams'
GoogleNMT alpha (default: mean log-prob). ``--no-warm_start`` skips the
engine's warmup before the server answers (``--warm_start``, the default,
runs every slot-path program once per shape first). A checkpoint that cannot be read
exits non-zero. ``--dp N`` starts N workers and the router
(``serving/router.py``), which splits a request over 30 s across them
unless ``--no_router_split``; ``--backends`` runs the router alone. The
fleet waits ``--worker_startup_timeout`` seconds for each worker's
``/health``, and on SIGTERM terminates, then kills, every worker.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from ..cli import add_kernel_selections


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("whisper_tpu_torch.serving")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--model_type", "-t", default="tiny")
    p.add_argument("--checkpoint", "-p", default=None,
                   help="OpenAI .pt / HF dir / .safetensors weights (random init if omitted)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--slots", type=int, default=8, help="max concurrent decodes")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--steps_per_sync", type=int, default=32)
    p.add_argument("--max_tokens", type=int, default=224,
                   help="per-request generated-token budget; bounds the bucketed "
                        "self-KV cache (0 = unlimited full-context cache)")
    p.add_argument("--timestamps", action="store_true",
                   help="decode with timestamp tokens (<|t.tt|> in the text)")
    p.add_argument("--adaptive_sync", action=argparse.BooleanOptionalAction, default=False,
                   help="grow a round to 2x/4x steps_per_sync while every active slot "
                        "is far from its budget")
    p.add_argument("--kv_quant", action=argparse.BooleanOptionalAction, default=True,
                   help="int8-quantize the cross-attention KV state")
    p.add_argument("--self_kv_quant", action=argparse.BooleanOptionalAction, default=True,
                   help="int8-quantize the self-attention KV slot cache")
    p.add_argument("--w8a8", action=argparse.BooleanOptionalAction, default=True,
                   help="int8 weights + dynamic-int8 encoder activations")
    add_kernel_selections(p)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: split weights/KV over this many CUDA "
                        "cards (heads + MLP over the model mesh axis)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel replicas: spawn this many single-engine workers "
                        "(subprocesses) behind a router")
    p.add_argument("--backends", default=None,
                   help="router-only mode: comma-separated worker URLs")
    p.add_argument("--worker_startup_timeout", type=float, default=900.0,
                   help="seconds a --dp worker may take to answer /health")
    p.add_argument("--no_router_split", action="store_true",
                   help="disable the router's fan-out of requests over 30 s "
                        "(windows then decode on one backend)")
    p.add_argument("--router_overlap_s", type=float, default=2.0,
                   help="overlap of the windows a request over 30 s is split into "
                        "(by the engine and by the router)")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--no_speech_threshold", type=float, default=0.6,
                   help="silence gate: P(<|nospeech|>) above this (and not "
                        "confident) returns '' (-1 disables)")
    p.add_argument("--logprob_threshold", type=float, default=-1.0,
                   help="avg-logprob quality floor (-1e9 disables)")
    p.add_argument("--compression_ratio_threshold", type=float, default=2.4,
                   help="flag repetitive output above this gzip ratio (-1 disables)")
    p.add_argument("--admit_chunk", type=int, default=None,
                   help="max newcomers encoded per sync round while slots are "
                        "active (default slots/4)")
    p.add_argument("--encode_chunks", type=int, default=1,
                   help=">1 splits the admission encoder into that many layer groups so "
                        "decode rounds run between them")
    p.add_argument("--temperature_fallback", default="0.2,0.4,0.6,0.8,1.0",
                   help="comma-separated retry-ladder temperatures for low-quality "
                        "results ('' disables)")
    p.add_argument("--max_beam_size", type=int, default=8,
                   help="per-request beam=K ceiling")
    p.add_argument("--beam_batch_max", type=int, default=8,
                   help="aux worker (beams, sampled decodes, ladder retries) micro-batch size")
    p.add_argument("--length_penalty", type=float, default=None,
                   help="GoogleNMT length-penalty alpha for beam scoring "
                        "(default: mean logprob)")
    p.add_argument("--warm_start", action=argparse.BooleanOptionalAction, default=True,
                   help="run every slot-path program once per shape before serving "
                        "(engine.warmup); --no-warm_start builds kernels at first use")
    return p.parse_args(argv)


def _wait_healthy(url: str, timeout_s: float = 120.0, alive=lambda: True) -> bool:
    """Poll ``url``'s ``/health`` until it answers 200 (True), ``timeout_s``
    passes or ``alive()`` turns false (False)."""
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(url)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and alive():
        try:
            c = http.client.HTTPConnection(u.hostname, u.port, timeout=2)
            c.request("GET", "/health")
            if c.getresponse().status == 200:
                return True
        except OSError:
            pass
        time.sleep(0.25)
    return False


def worker_command(args: argparse.Namespace, port: int) -> list:
    """The command line of one ``--dp`` worker: a single-engine server on
    127.0.0.1:``port`` with every engine flag of ``args``."""
    cmd = [sys.executable, "-m", "whisper_tpu_torch.serving",
           "--host", "127.0.0.1", "--port", str(port),
           "--model_type", args.model_type, "--device", args.device,
           "--slots", str(args.slots), "--dtype", args.dtype,
           "--steps_per_sync", str(args.steps_per_sync),
           "--tp", str(args.tp), "--timeout", str(args.timeout),
           "--max_tokens", str(args.max_tokens),
           # attached values: argparse reads "-1e+20" after a space as a flag
           f"--no_speech_threshold={args.no_speech_threshold}",
           f"--logprob_threshold={args.logprob_threshold}",
           f"--compression_ratio_threshold={args.compression_ratio_threshold}",
           "--encoder_attention", args.encoder_attention,
           "--cross_decode", args.cross_decode,
           "--router_overlap_s", str(args.router_overlap_s),
           "--max_beam_size", str(args.max_beam_size),
           "--beam_batch_max", str(args.beam_batch_max),
           "--temperature_fallback", args.temperature_fallback]
    if args.checkpoint:
        cmd += ["--checkpoint", args.checkpoint]
    if args.admit_chunk:
        cmd += ["--admit_chunk", str(args.admit_chunk)]
    if args.encode_chunks > 1:
        cmd += ["--encode_chunks", str(args.encode_chunks)]
    if args.length_penalty is not None:
        cmd.append(f"--length_penalty={args.length_penalty}")
    if args.timestamps:
        cmd.append("--timestamps")
    for flag in ("kv_quant", "self_kv_quant", "w8a8", "adaptive_sync", "warm_start"):
        cmd.append(f"--{flag}" if getattr(args, flag) else f"--no-{flag}")
    return cmd


def _run_dp(args: argparse.Namespace) -> int:
    """One single-engine worker subprocess per data replica, fronted by the
    router on ``args.port``. Replica i gets the cards i*tp .. i*tp + tp - 1
    (``CUDA_VISIBLE_DEVICES``, unless the caller set it: then every replica
    shares the caller's cards)."""
    from .router import make_router

    # SIGTERM must tear the fleet down with us: the default action would end
    # this process at once, skip the `finally` and leak every worker
    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    ports = [args.port + 1 + i for i in range(args.dp)]
    workers = []
    try:
        for i, port in enumerate(ports):
            env = dict(os.environ)
            env.setdefault("CUDA_VISIBLE_DEVICES",
                           ",".join(str(i * args.tp + j) for j in range(args.tp)))
            workers.append(subprocess.Popen(worker_command(args, port), env=env))
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        t0 = time.perf_counter()
        for u, w in zip(urls, workers):
            if not _wait_healthy(u, args.worker_startup_timeout,
                                 alive=lambda w=w: w.poll() is None):
                print(f"whisper_tpu_torch.serving: worker {u} failed to come up",
                      file=sys.stderr, flush=True)
                return 1
        srv = make_router(urls, args.host, args.port,
                          split_longform=not args.no_router_split,
                          longform_overlap_s=args.router_overlap_s)
        print(f"whisper_tpu_torch router on {args.host}:{args.port} -> {args.dp} replicas "
              f"{urls} (workers up in {time.perf_counter() - t0:.1f}s; pids "
              f"{[w.pid for w in workers]})", file=sys.stderr, flush=True)
        try:
            srv.serve_forever()
        finally:
            srv.server_close()
    except KeyboardInterrupt:
        pass
    finally:
        for w in workers:
            w.terminate()
        for w in workers:
            try:
                w.wait(timeout=10)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
    return 0


def _run_router(args: argparse.Namespace) -> int:
    from .router import make_router

    urls = [u if "//" in u else f"http://{u}" for u in args.backends.split(",") if u]
    srv = make_router(urls, args.host, args.port, split_longform=not args.no_router_split,
                      longform_overlap_s=args.router_overlap_s)
    print(f"whisper_tpu_torch router on {args.host}:{srv.server_address[1]} -> {urls}",
          file=sys.stderr, flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


def build_engine(args: argparse.Namespace, mesh=None, **engine_kw):
    """The engine the flags describe, on ``args.device``, not started;
    ``--tp N`` > 1 places it on ``make_mesh(1, N)`` (the first N CUDA
    cards), unless ``mesh`` is given. ``engine_kw`` are further constructor
    keywords (the knobs without a flag, as ``apply_filters`` and
    ``prefill_buckets``). Returns (engine, startup phase seconds)."""
    import torch

    from ..config import get_config
    from ..models.checkpoint import load_checkpoint
    from ..ops.quant import quantize_params
    from ..params import init_params
    from ..pipeline import resolve_device
    from ..tokenizer import get_tokenizer
    from .engine import ContinuousBatchingEngine

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    if args.checkpoint:
        model, cfg = load_checkpoint(args.checkpoint, size=args.model_type, device=device)
    else:
        cfg = get_config(args.model_type)
        model = init_params(cfg, seed=0, device=device)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    if args.w8a8:
        quantize_params(model)
    t_quant = time.perf_counter() - t0
    if not cfg.is_multilingual:
        raise NotImplementedError("English-only (.en) vocabularies are not ported yet")
    tok = get_tokenizer(num_languages=cfg.num_languages)
    if mesh is None and args.tp > 1:
        from ..parallel.sharding import make_mesh

        if device.type != "cuda":
            raise ValueError(f"--tp {args.tp} splits the model over CUDA cards, not {device}")
        mesh = make_mesh(1, args.tp)
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(
        model, tok,
        max_slots=args.slots,
        compute_dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype],
        steps_per_sync=args.steps_per_sync,
        max_tokens=args.max_tokens if args.max_tokens and args.max_tokens > 0 else None,
        kv_quant=args.kv_quant,
        self_kv_quant=args.self_kv_quant,
        w8a8=args.w8a8,
        encoder_attention=args.encoder_attention,
        cross_decode=args.cross_decode,
        no_speech_threshold=None if args.no_speech_threshold < 0 else args.no_speech_threshold,
        logprob_threshold=None if args.logprob_threshold <= -1e9 else args.logprob_threshold,
        compression_ratio_threshold=(None if args.compression_ratio_threshold < 0
                                     else args.compression_ratio_threshold),
        admit_chunk=args.admit_chunk,
        timestamps=args.timestamps,
        mesh=mesh,
        encode_chunks=args.encode_chunks,
        adaptive_sync=args.adaptive_sync,
        longform_overlap_s=args.router_overlap_s,
        temperature_fallback=tuple(float(x) for x in args.temperature_fallback.split(",") if x),
        beam_batch_max=args.beam_batch_max,
        max_beam_size=args.max_beam_size,
        length_penalty=args.length_penalty,
        warm_start=args.warm_start,
        **engine_kw,
    )
    return engine, {"load_s": t_load, "quantize_s": t_quant,
                    "place_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.backends:
        return _run_router(args)
    if args.dp > 1:
        return _run_dp(args)
    from .server import make_server

    try:
        engine, phases = build_engine(args)
    # cuda without a card, --tp without N cards, a checkpoint that cannot be read
    except (RuntimeError, ValueError, OSError) as e:
        print(f"whisper_tpu_torch.serving: {e}", file=sys.stderr)
        return 1
    engine.start()
    srv = make_server(engine, args.host, args.port, request_timeout_s=args.timeout)
    print(f"whisper_tpu_torch server on {args.host}:{srv.server_address[1]} "
          f"(model={engine.cfg.name}, slots={args.slots}, device={engine.device}, "
          f"tp={args.tp}) startup: "
          f"load {phases['load_s']:.1f}s quantize {phases['quantize_s']:.1f}s "
          f"place {phases['place_s']:.1f}s "
          f"warmup {engine.stats.warmup_seconds:.1f}s", file=sys.stderr, flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        engine.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
