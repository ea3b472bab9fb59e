"""Command-line front end of the port.

Usage:
    python -m whisper_tpu_torch.cli --wav demo.wav --model_type tiny --language zh --device cuda
    python -m whisper_tpu_torch.cli --wav a.wav b.wav --model_type turbo --dtype bfloat16 \
        --quantize --w8a8 --kv_quant --self_kv_quant --max_tokens 64
    # seek-based long-form with timestamps, one subtitle file per input
    python -m whisper_tpu_torch.cli --wav long.wav --model_type turbo --longform \
        --timestamps --max_tokens 64 -f srt -o out/

Weights are the port's seeded random init (checkpoint loading is not ported
yet), so the text is gibberish; the RTF line shows the path ran end to end.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional


def get_args(argv=None):
    p = argparse.ArgumentParser("whisper_tpu_torch", description="Whisper ASR on PyTorch/CUDA")
    p.add_argument("--wav", "-w", nargs="+", required=True, help="input WAV file(s)")
    p.add_argument("--model_type", "-t", default="tiny",
                   help="tiny|base|small|medium|large-v3|turbo|...")
    p.add_argument("--language", "-l", default="zh", help="language code")
    p.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0, help="seed of the random init")
    p.add_argument("--timestamps", action="store_true", help="emit timestamp tokens")
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize attention/MLP weights")
    p.add_argument("--quantize_logits", action="store_true",
                   help="int8 copy of the logits embedding")
    p.add_argument("--w8a8", action="store_true",
                   help="int8 activations x int8 weights in the encoder (needs --quantize)")
    p.add_argument("--gelu", default="erf", choices=["erf", "tanh"])
    p.add_argument("--kv_quant", action="store_true", help="int8 cross-attention KV")
    p.add_argument("--self_kv_quant", action="store_true", help="int8 self-attention KV cache")
    p.add_argument("--max_tokens", type=int, default=None,
                   help="cap on generated tokens (default: model ctx limit)")
    p.add_argument("--longform", action="store_true",
                   help="seek-based long-form (timestamp-conditioned windows)")
    p.add_argument("--no_condition", action="store_true",
                   help="disable condition-on-previous-text in --longform")
    p.add_argument("--initial_prompt", default=None,
                   help="free text to prime the decoder with (names, jargon, style), "
                        "prepended as [sot_prev, tokens] context")
    p.add_argument("--output_format", "-f", default="txt",
                   choices=["txt", "json", "srt", "vtt", "tsv"],
                   help="transcript format; srt/vtt/tsv need --timestamps for segment times")
    p.add_argument("--output_dir", "-o", default=None,
                   help="write one <input-stem>.<format> per input here (default: stdout)")
    return p.parse_args(argv)


def main(argv=None, report: Optional[dict] = None) -> int:
    """Run the CLI on ``argv``. ``report``, when given, receives what ran:
    ``pipeline`` (with its ``last_seek`` or ``last_decode`` counts) and
    ``transcribe_s``, the wall seconds of the transcription call, so a
    caller that runs the CLI in-process can read them."""
    args = get_args(argv)
    from .formats import write_result
    from .pipeline import WhisperPipeline

    t0 = time.perf_counter()
    pipe = WhisperPipeline(
        model=args.model_type, language=args.language, task=args.task,
        compute_dtype=args.dtype, seed=args.seed, timestamps=args.timestamps,
        max_tokens=args.max_tokens, initial_prompt=args.initial_prompt,
        quantize=args.quantize, quantize_logits=args.quantize_logits, w8a8=args.w8a8,
        gelu=args.gelu, kv_quant=args.kv_quant, self_kv_quant=args.self_kv_quant,
        condition_on_previous_text=not args.no_condition, device=args.device)
    print(f"Init model cost: {time.perf_counter() - t0:.3f}s", file=sys.stderr)
    t0 = time.perf_counter()
    if args.longform:
        results = pipe.transcribe_longform(args.wav)
    else:
        results = pipe.transcribe_batch(args.wav)
    transcribe_s = time.perf_counter() - t0
    print(f"Transcribe cost: {transcribe_s:.3f}s", file=sys.stderr)
    if report is not None:
        report.update(pipeline=pipe, transcribe_s=transcribe_s)
    for path, r in zip(args.wav, results):
        if args.output_dir:
            stem = os.path.splitext(os.path.basename(path))[0]
            dest = os.path.join(args.output_dir, f"{stem}.{args.output_format}")
            os.makedirs(args.output_dir, exist_ok=True)
            with open(dest, "w", encoding="utf-8") as f:
                write_result(r, args.output_format, f)
            print(f"{path} -> {dest}", file=sys.stderr)
        elif args.output_format != "txt":
            write_result(r, args.output_format, sys.stdout)
        else:
            print(f"{path}\t[{r.language}]\t{r.text}")
        print(f"  audio {r.audio_seconds:.2f}s  wall {r.wall_seconds:.2f}s  RTF {r.rtf:.4f}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
