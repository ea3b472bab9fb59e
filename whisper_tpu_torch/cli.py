"""Command-line front end of the port.

Usage:
    python -m whisper_tpu_torch.cli --wav demo.wav --model_type tiny --language zh --device cuda
    python -m whisper_tpu_torch.cli --wav a.wav b.wav --model_type turbo --dtype bfloat16 \
        --quantize --w8a8 --kv_quant --self_kv_quant --max_tokens 64
    # beam search (5 beams an utterance; 0 or 1 decodes greedily)
    python -m whisper_tpu_torch.cli --wav a.wav --model_type turbo --kv_quant --beam 5
    # seek-based long-form with timestamps, one subtitle file per input
    python -m whisper_tpu_torch.cli --wav long.wav --model_type turbo --longform \
        --timestamps --max_tokens 64 -f srt -o out/
    # the JAX package's kernel selections (WHISPER_TPU_FLASH=bhtd,
    # WHISPER_TPU_DECODE_FLASH=dense) as flags
    python -m whisper_tpu_torch.cli --wav a.wav --model_type turbo --kv_quant \
        --encoder_attention bhtd --cross_decode dense

    # word timings (one line a word in txt; srt/vtt/tsv segments from words)
    python -m whisper_tpu_torch.cli --wav a.wav --model_type turbo --kv_quant \
        --word_timestamps -f srt -o out/

    # speculative decoding: a distil-large-v3 draft proposes 4 tokens a round
    # (greedy argmax only: the suppression filters are off)
    python -m whisper_tpu_torch.cli --wav a.wav --model_type turbo --kv_quant \
        --spec_draft distil-large-v3 --spec_gamma 4

    # real weights (an OpenAI .pt, an HF directory or a bare .safetensors
    # with --model_type), the language detected per clip
    python -m whisper_tpu_torch.cli --wav a.wav --model_type turbo --checkpoint turbo.pt \
        --language auto

Without ``--checkpoint`` the weights are the port's seeded random init, so
the text is gibberish; the RTF line shows the path ran end to end.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional


def add_kernel_selections(p: argparse.ArgumentParser) -> None:
    """The two kernel-selection flags the CLI and the server share."""
    from .models.model import CROSS_DECODE, ENCODER_ATTENTION

    p.add_argument("--encoder_attention", default="btd", choices=ENCODER_ATTENTION,
                   help="encoder attention kernel: btd on the (B, T, D) layout, or bhtd on "
                        "split heads (the JAX package's WHISPER_TPU_FLASH=btd|bhtd)")
    p.add_argument("--cross_decode", default="fd", choices=CROSS_DECODE,
                   help="decode-step int8 cross-attention kernel: fd (flash-decode), legacy "
                        "(head-batched, whole-T softmax) or dense (block-diagonal query on "
                        "the tensor cores); the JAX package's WHISPER_TPU_DECODE_FLASH. "
                        "Runs with --kv_quant")


def get_args(argv=None):
    p = argparse.ArgumentParser("whisper_tpu_torch", description="Whisper ASR on PyTorch/CUDA")
    p.add_argument("--wav", "-w", nargs="+", required=True, help="input WAV file(s)")
    p.add_argument("--model_type", "-t", default="tiny",
                   help="tiny|base|small|medium|large-v3|turbo|...")
    p.add_argument("--checkpoint", "-p", default=None,
                   help="OpenAI .pt / HF dir / .safetensors weights (random init if omitted)")
    p.add_argument("--language", "-l", default="zh", help="language code or 'auto'")
    p.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0, help="seed of the random init")
    p.add_argument("--beam", type=int, default=0, help="beam size (0/1 = greedy)")
    p.add_argument("--timestamps", action="store_true", help="emit timestamp tokens")
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize attention/MLP weights")
    p.add_argument("--quantize_logits", action="store_true",
                   help="int8 copy of the logits embedding")
    p.add_argument("--w8a8", action="store_true",
                   help="int8 activations x int8 weights in the encoder (needs --quantize)")
    p.add_argument("--gelu", default="erf", choices=["erf", "tanh"])
    add_kernel_selections(p)
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
    p.add_argument("--word_timestamps", action="store_true",
                   help="per-word timings via cross-attention DTW (align.py)")
    p.add_argument("--alignment_heads", default=None,
                   help="JSON sidecar with per-model alignment-head masks "
                        "(default: last half of the decoder layers)")
    p.add_argument("--output_format", "-f", default="txt",
                   choices=["txt", "json", "srt", "vtt", "tsv"],
                   help="transcript format; srt/vtt/tsv need --timestamps or --word_timestamps "
                        "for segment times")
    p.add_argument("--output_dir", "-o", default=None,
                   help="write one <input-stem>.<format> per input here (default: stdout)")
    p.add_argument("--spec_draft", default=None,
                   help="draft model size for speculative decoding (spec_decode.py; "
                        "greedy-only, implies the OpenAI suppression filters are OFF)")
    p.add_argument("--spec_draft_checkpoint", default=None,
                   help="draft checkpoint path (.pt/safetensors)")
    p.add_argument("--spec_gamma", type=int, default=4,
                   help="draft tokens proposed per verify window")
    return p.parse_args(argv)


def main(argv=None, report: Optional[dict] = None) -> int:
    """Run the CLI on ``argv``. ``report``, when given, receives what ran:
    ``pipeline`` (with its ``last_seek`` or ``last_decode`` counts) and
    ``transcribe_s``, the wall seconds of the transcription call, so a
    caller that runs the CLI in-process can read them."""
    args = get_args(argv)
    from .formats import write_result
    from .pipeline import WhisperPipeline

    speculative = bool(args.spec_draft or args.spec_draft_checkpoint)
    t0 = time.perf_counter()
    pipe = WhisperPipeline(
        model=args.model_type, checkpoint=args.checkpoint,
        language=None if args.language == "auto" else args.language, task=args.task,
        compute_dtype=args.dtype, seed=args.seed, beam_size=args.beam,
        timestamps=args.timestamps,
        max_tokens=args.max_tokens, initial_prompt=args.initial_prompt,
        quantize=args.quantize, quantize_logits=args.quantize_logits, w8a8=args.w8a8,
        gelu=args.gelu, kv_quant=args.kv_quant, self_kv_quant=args.self_kv_quant,
        encoder_attention=args.encoder_attention, cross_decode=args.cross_decode,
        condition_on_previous_text=not args.no_condition,
        word_timestamps=args.word_timestamps, alignment_heads=args.alignment_heads,
        # spec decode is argmax-only; the suppression grammar is sequential
        # state the verify window cannot replay
        apply_filters=not speculative, spec_draft=args.spec_draft,
        spec_draft_checkpoint=args.spec_draft_checkpoint, spec_gamma=args.spec_gamma,
        device=args.device)
    if speculative:
        print("speculative decoding: suppression filters disabled "
              "(greedy/argmax-only path)", file=sys.stderr)
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
            if args.word_timestamps and r.words:
                for w in r.words:
                    print(f"  {w['start']:7.2f} -> {w['end']:7.2f}  {w['word']}")
        print(f"  audio {r.audio_seconds:.2f}s  wall {r.wall_seconds:.2f}s  RTF {r.rtf:.4f}",
              file=sys.stderr)
    if pipe.last_spec_stats is not None:
        s = pipe.last_spec_stats
        print(f"speculative: acceptance {s['acceptance']:.1%} "
              f"({s['accepted']}/{s['drafted']} draft tokens, {s['rounds']} rounds)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
