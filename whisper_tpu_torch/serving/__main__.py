"""Server entry point: one continuous-batching engine behind the HTTP front
end, the single-engine path of ``python -m whisper_tpu.serving``.

    python -m whisper_tpu_torch.serving --model_type turbo --port 8000
    python -m whisper_tpu_torch.serving --model_type turbo --tp 2 --port 8000
    python -m whisper_tpu_torch.serving --model_type turbo --max_beam_size 8 \
        --length_penalty 1.0 --port 8000   # then POST /asr?beam=5
    python -m whisper_tpu_torch.serving --model_type test-nano --device cpu \\
        --dtype float32 --no-w8a8 --port 8000

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
GoogleNMT alpha (default: mean log-prob). Flags of features not
ported yet (``--dp`` > 1, ``--backends``) exit non-zero and name the
feature; so does a checkpoint that cannot be read.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--dp", type=int, default=1, help="not ported yet (1 only)")
    p.add_argument("--backends", default=None, help="not ported yet")
    p.add_argument("--router_overlap_s", type=float, default=2.0,
                   help="overlap of the windows a request over 30 s is split into")
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
    return p.parse_args(argv)


def unported_flags(args: argparse.Namespace):
    asked = {"--dp > 1 (data-parallel replicas)": args.dp > 1,
             "--backends (router)": bool(args.backends)}
    return [name for name, on in asked.items() if on]


def build_engine(args: argparse.Namespace, mesh=None):
    """The engine the flags describe, on ``args.device``, not started;
    ``--tp N`` > 1 places it on ``make_mesh(1, N)`` (the first N CUDA
    cards), unless ``mesh`` is given. Returns (engine, startup phase
    seconds)."""
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
    )
    return engine, {"load_s": t_load, "quantize_s": t_quant,
                    "place_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    args = parse_args(argv)
    asked = unported_flags(args)
    if asked:
        print(f"whisper_tpu_torch.serving: not ported yet: {', '.join(asked)}", file=sys.stderr)
        return 2
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
