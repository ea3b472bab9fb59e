"""WER eval entry point (port of ``python -m whisper_tpu.eval``).

    python -m whisper_tpu_torch.eval --dataset aishell \\
        --gt_path datasets/ground_truth.txt --model_type small \\
        --checkpoint small.pt --batch 32

Runs on the card unless ``--device cpu``; ``--language auto`` detects each
clip's language. Writes the total WER to ``--out`` and the per-utterance
lines to ``--log``.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser("whisper_tpu_torch.eval")
    p.add_argument("--dataset", "-d", default="aishell", choices=["aishell", "commonvoice"])
    p.add_argument("--gt_path", required=True, help="ground-truth txt / tsv file")
    p.add_argument("--wav_dir", default=None)
    p.add_argument("--model_type", "-t", default="tiny")
    p.add_argument("--checkpoint", "-p", default=None,
                   help="OpenAI .pt / HF dir / .safetensors weights (random init if omitted)")
    p.add_argument("--language", "-l", default="zh", help="language code or 'auto'")
    p.add_argument("--level", default="char", choices=["char", "word"],
                   help="char = the zh metric; word = spaced-language WER")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--log", default="test_wer.log")
    p.add_argument("--out", default="wer.txt")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="%(message)s")

    from ..pipeline import WhisperPipeline
    from .wer import AIShellDataset, CommonVoiceDataset, evaluate

    ds = (AIShellDataset(args.gt_path, args.wav_dir) if args.dataset == "aishell"
          else CommonVoiceDataset(args.gt_path, args.wav_dir))
    language = None if args.language == "auto" else args.language
    pipe = WhisperPipeline(model=args.model_type, checkpoint=args.checkpoint, language=language,
                           compute_dtype=args.dtype, device=args.device)
    res = evaluate(pipe, ds, batch_size=args.batch, language=language, limit=args.limit,
                   log_path=args.log, level=args.level)
    with open(args.out, "w") as f:
        f.write(f"{res.wer:.6f}\n")
    print(f"Total WER: {res.wer:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
