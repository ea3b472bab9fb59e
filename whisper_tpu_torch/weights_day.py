"""Weights day through the port: ``docs/WEIGHTS_DAY.md`` steps 0-5 in one
command, as ``scripts/weights_day.py`` runs them through the JAX package.

    python -m whisper_tpu_torch.weights_day --checkpoints_dir /path/to/ckpts \\
        --sizes tiny,base,small,turbo
    python -m whisper_tpu_torch.weights_day --dry-run --device cpu --workdir out/

Steps (each logged, each fatal on a real run):
  0. check that the assets are present: the vocab, the demo clip and the
     AIShell set (nothing is fetched; a real run stops and names what is
     missing)
  1. golden smoke: the demo clip through the first size's checkpoint must
     transcribe to the reference's recorded text
  2. the quantization gate on real logits (``eval.quant_gate``)
  3. WER per size against the reference table (``python -m
     whisper_tpu_torch.eval``)
  4. quality spot checks (silence -> "", a clip over 30 s) and a sweep of
     the fuzzy merge's similarity gate over real window decodes
  4b. the served surface: ``python -m whisper_tpu_torch.serving --dp N``
     (the server's defaults behind the router) answers the golden clip and
     WER spot checks through POST /asr (``serving.client``)
  5. ``weights_day_report.{json,md}`` in ``--workdir``

``--dry-run`` runs offline with what the repository holds: test-nano (tiny
on the card, whose attention kernels take a head dim of 64 only; test-nano's
is 32) with seeded random weights, fp32, batch at most 4, 4 utterances, a
synthetic AIShell-format set and demo clip written with
``ops.audio.write_wav``;
every step runs end to end with the accuracy assertions off (random
weights transcribe noise). ``--device`` (default ``cuda``) places every
step, the fleet's workers included.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's WER table per size, the targets BASELINE.md commits to
WER_TARGETS = {"tiny": 0.24, "base": 0.18, "small": 0.11, "turbo": 0.06}
GOLDEN_TEXT = "甚至出现交易几乎停止的情况"  # the reference's demo.wav transcript
# the dry run's model per device: the card's kernels need a head dim of 64
DRY_RUN_MODEL = {"cpu": "test-nano", "cuda": "tiny"}


def log(msg: str) -> None:
    print(f"[weights-day] {msg}", flush=True)


def _synthetic_dataset(root: str, n: int = 4) -> str:
    """An AIShell-format set for the dry run (ground_truth.txt and
    aishell_S0764/*.wav, as the WER harness reads them)."""
    from .ops.audio import write_wav

    wav_dir = os.path.join(root, "aishell_S0764")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        utt = f"BAC000{i:02d}"
        write_wav(os.path.join(wav_dir, f"{utt}.wav"),
                  (rng.standard_normal(8000) * 0.05).astype(np.float32))
        lines.append(f"{utt} 测试句子{i}")
    gt = os.path.join(root, "ground_truth.txt")
    with open(gt, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return gt


def _synthetic_demo(root: str) -> str:
    from .ops.audio import write_wav

    path = os.path.join(root, "demo.wav")
    write_wav(path, (np.random.default_rng(1).standard_normal(32000) * 0.05).astype(np.float32))
    return path


def missing_assets(args) -> list:
    """What a real run needs and does not find: the vocab, the demo clip,
    the ground truth and its WAV folder."""
    from .tokenizer import find_vocab_file

    missing = []
    try:
        find_vocab_file()
    except FileNotFoundError as e:
        missing.append(f"vocab ({e})")
    if not os.path.exists(args.demo_wav):
        missing.append(f"demo clip {args.demo_wav}")
    if not os.path.exists(args.gt_path):
        missing.append(f"ground truth {args.gt_path}")
    wav_dir = os.path.join(os.path.dirname(args.gt_path), "aishell_S0764")
    if not os.path.isdir(wav_dir):
        missing.append(f"dataset WAVs {wav_dir}")
    return missing


def step0_assets(args, report: dict) -> None:
    if args.dry_run:
        log("step 0 (assets): SKIPPED in dry-run (synthetic data)")
        report["fetch"] = "skipped (dry-run)"
        return
    log("step 0: checking the vocab, the demo clip and the dataset ...")
    missing = missing_assets(args)
    if missing:
        raise SystemExit("missing (nothing is downloaded; put them in place): "
                         + "; ".join(missing))
    report["fetch"] = "ok (present)"


def _model_type(args, size: str) -> str:
    """The model a step runs: ``size``, or in a dry run the small model of
    the device (``DRY_RUN_MODEL``)."""
    return DRY_RUN_MODEL[args.device] if args.dry_run else size


def _ckpt(args, size: str):
    if args.dry_run or not args.checkpoints_dir:
        return None
    for ext in (".pt", ".safetensors"):
        p = os.path.join(args.checkpoints_dir, size + ext)
        if os.path.exists(p):
            return p
    raise SystemExit(f"no checkpoint for '{size}' in {args.checkpoints_dir}")


def _pipeline(args, size: str):
    from .pipeline import WhisperPipeline

    return WhisperPipeline(model=_model_type(args, size),
                           checkpoint=_ckpt(args, size), language="zh",
                           compute_dtype=args.dtype, device=args.device)


def step1_golden(args, report: dict) -> None:
    log("step 1: golden demo clip smoke ...")
    from .ops.audio import load_audio

    res = _pipeline(args, args.sizes[0]).transcribe(load_audio(args.demo_wav))
    report["golden"] = {"text": res.text, "expected": GOLDEN_TEXT, "rtf": res.rtf}
    if args.dry_run:
        log(f"  dry-run transcript (random weights): {res.text[:40]!r}: plumbing ok")
        return
    if res.text.strip() != GOLDEN_TEXT:
        raise SystemExit(f"GOLDEN MISMATCH: {res.text!r} != {GOLDEN_TEXT!r}: a checkpoint "
                         "mapping fault; stop before quantization (WEIGHTS_DAY.md step 1)")
    log(f"  golden ok: {res.text!r}")


def step2_quant_gate(args, report: dict) -> None:
    log("step 2: quant gate on real logits ...")
    from .eval.quant_gate import main as gate_main

    size = args.flagship
    argv = ["--model", _model_type(args, size),
            "--batch", "2" if args.dry_run else "4",
            "--max_tokens", "4" if args.dry_run else "32",
            "--dtype", "float32", "--device", args.device]
    if args.dry_run:
        argv += ["--variants", "int8_weights,w8a8"]
    ck = _ckpt(args, size)
    if ck:
        argv += ["--checkpoint", ck]
    rc = gate_main(argv)
    report["quant_gate"] = {"rc": rc}
    if rc != 0 and not args.dry_run:
        raise SystemExit("quant gate FAILED on real weights: do not ship quantized "
                         "defaults; see WEIGHTS_DAY.md step 2")


def step3_wer(args, report: dict) -> None:
    log("step 3: per-size WER ladder ...")
    from .eval.__main__ import main as eval_main

    table = {}
    for size in args.sizes:
        out = os.path.join(args.workdir, f"wer_{size}.txt")
        argv = ["--dataset", "aishell", "--gt_path", args.gt_path,
                "--model_type", _model_type(args, size), "--language", "zh",
                "--batch", str(args.batch), "--dtype", args.dtype, "--device", args.device,
                "--log", os.path.join(args.workdir, f"wer_{size}.log"), "--out", out]
        ck = _ckpt(args, size)
        if ck:
            argv += ["--checkpoint", ck]
        if args.limit:
            argv += ["--limit", str(args.limit)]
        if eval_main(argv) != 0:
            raise SystemExit(f"eval harness failed for {size}")
        with open(out) as f:
            wer = float(f.read().strip())
        target = WER_TARGETS.get(size)
        table[size] = {"wer": wer, "target": target,
                       "pass": None if target is None or args.dry_run else wer <= target}
        log(f"  {size}: WER {wer:.4f} (target <= {target})")
    report["wer"] = table
    bad = [s for s, r in table.items() if r["pass"] is False]
    if bad:
        raise SystemExit(f"WER targets missed: {bad}; see the ladder in WEIGHTS_DAY.md "
                         "step 3 before quantizing")


def step4_quality(args, report: dict) -> None:
    log("step 4: quality-gate spot checks ...")
    from .config import N_SAMPLES
    from .longform import merge_texts, split_audio

    pipe = _pipeline(args, args.sizes[0])
    res = pipe.transcribe(np.zeros(16000, np.float32))
    report["silence_gate"] = {"text": res.text, "no_speech_prob": res.no_speech_prob}
    if not args.dry_run and res.text.strip():
        raise SystemExit(f"silence gate failed: a silent clip gave {res.text!r} "
                         f"(no_speech_prob={res.no_speech_prob:.3f})")
    # over 30 s: the window path
    long = np.zeros(16000 * 35, np.float32)
    rng = np.random.default_rng(2)
    long[: 16000 * 2] = rng.standard_normal(16000 * 2) * 0.05
    long[16000 * 26: 16000 * 30] = rng.standard_normal(16000 * 4) * 0.05
    res2 = pipe.transcribe(long)
    report["longform"] = {"audio_seconds": res2.audio_seconds}
    if not res2.audio_seconds > 30.0:
        raise SystemExit(f"the 35 s clip reported {res2.audio_seconds} s")
    # the merge's similarity gate (0.72) was chosen on synthetic near
    # duplicates: on real weights, read the merged text across gates
    waves, _ = split_audio(long, N_SAMPLES, pipe.longform_overlap)
    parts = [pipe.transcribe(w).text for w in waves]
    sweep = {str(sim): merge_texts(parts, "zh", similarity=sim) for sim in (0.6, 0.72, 0.85)}
    report["merge_sweep"] = {"window_texts": parts, "merged": sweep}
    distinct = len(set(sweep.values()))
    if not args.dry_run and distinct > 1:
        log(f"  WARNING: the similarity gate changes the merged text ({distinct} variants): "
            "read report['merge_sweep'] and pin the best gate (WEIGHTS_DAY.md step 4)")
    log("  quality checks exercised")


def step4b_serving(args, report: dict) -> None:
    """The shipped serving entry point (the server's defaults behind
    ``--dp N`` and the router) answers the golden clip and two WER spot
    checks through POST /asr."""
    from .serving.__main__ import _wait_healthy
    from .serving.client import transcribe_file

    log(f"step 4b: serving surface through /asr (--dp {args.serving_dp}) ...")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    size = args.sizes[0]
    cmd = [sys.executable, "-m", "whisper_tpu_torch.serving", "--host", "127.0.0.1",
           "--port", str(port), "--dp", str(args.serving_dp), "--device", args.device,
           "--model_type", _model_type(args, size)]
    if args.dry_run:
        cmd += ["--dtype", "float32", "--slots", "2", "--max_tokens", "6",
                "--steps_per_sync", "2"]
    ck = _ckpt(args, size)
    if ck:
        cmd += ["--checkpoint", ck]
    proc = subprocess.Popen(cmd, cwd=REPO, start_new_session=True)
    try:
        if not _wait_healthy(f"http://127.0.0.1:{port}", 300 if args.dry_run else 1800,
                             alive=lambda: proc.poll() is None):
            raise SystemExit(f"serving fleet never became healthy (rc={proc.poll()})")
        res = transcribe_file(args.demo_wav, "127.0.0.1", port, language="zh", timeout=600)
        report["serving_golden"] = {"text": res.get("text"), "success": res.get("success")}
        if not res.get("success"):
            raise SystemExit(f"served golden decode failed: {res}")
        if not args.dry_run and res["text"].strip() != GOLDEN_TEXT:
            raise SystemExit(f"SERVED GOLDEN MISMATCH: {res['text']!r} != {GOLDEN_TEXT!r}: "
                             "the serving tier disagrees with the pipeline")
        # WER spot checks through the wire: the dataset's first utterances
        wav_dir = os.path.join(os.path.dirname(args.gt_path), "aishell_S0764")
        spots = []
        with open(args.gt_path, encoding="utf-8") as f:
            for line in list(f)[:2]:
                utt, gt_text = line.strip().split(" ", 1)
                wav = os.path.join(wav_dir, f"{utt}.wav")
                if not os.path.exists(wav):
                    continue
                r = transcribe_file(wav, "127.0.0.1", port, language="zh", timeout=600)
                if not r.get("success"):
                    raise SystemExit(f"served WER spot decode failed: {r}")
                spots.append({"utt": utt, "gt": gt_text, "text": r.get("text")})
        report["serving_spots"] = spots
        log(f"  served golden + {len(spots)} WER spots through /asr ok")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def step5_record(args, report: dict) -> None:
    jpath = os.path.join(args.workdir, "weights_day_report.json")
    with open(jpath, "w", encoding="utf-8") as f:
        json.dump(report, f, ensure_ascii=False, indent=2)
    mpath = os.path.join(args.workdir, "weights_day_report.md")
    with open(mpath, "w", encoding="utf-8") as f:
        f.write("# Weights day report\n\n")
        f.write(f"mode: {'DRY-RUN (random weights)' if args.dry_run else 'REAL'}"
                f", device {args.device}\n\n")
        if "wer" in report:
            f.write("| model | WER | target | pass |\n|---|---|---|---|\n")
            for size, r in report["wer"].items():
                f.write(f"| {size} | {r['wer']:.4f} | {r['target']} | {r['pass']} |\n")
        f.write("\nPaste this table into BENCH_NOTES.md and README.md (WEIGHTS_DAY.md "
                "step 5).\n")
    log(f"step 5: report written to {jpath} and {mpath}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("whisper_tpu_torch.weights_day")
    p.add_argument("--checkpoints_dir", default=None,
                   help="dir with <size>.pt or <size>.safetensors")
    p.add_argument("--sizes", default="tiny,base,small,turbo")
    p.add_argument("--flagship", default="turbo", help="size used for the quant re-gate")
    p.add_argument("--gt_path", default="datasets/ground_truth.txt")
    p.add_argument("--demo_wav", default="demo.wav")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--workdir", default=".")
    p.add_argument("--serving_dp", type=int, default=2,
                   help="data-parallel replicas of the step-4b fleet (1 = a single "
                        "server behind the router)")
    p.add_argument("--dry-run", dest="dry_run", action="store_true",
                   help="offline rehearsal: synthetic data, random weights, accuracy "
                        "assertions off")
    args = p.parse_args(argv)
    args.sizes = [s for s in args.sizes.split(",") if s]
    if not args.dry_run and not args.checkpoints_dir:
        p.error("--checkpoints_dir is required outside --dry-run")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    if args.dry_run:
        args.dtype = "float32"
        args.batch = min(args.batch, 4)
        args.limit = args.limit or 4
        args.gt_path = _synthetic_dataset(args.workdir)
        args.demo_wav = _synthetic_demo(args.workdir)
        args.sizes = args.sizes[:1]
        args.flagship = args.sizes[0]

    t0 = time.time()
    report: dict = {"dry_run": args.dry_run, "sizes": args.sizes, "device": args.device}
    step0_assets(args, report)
    step1_golden(args, report)
    step2_quant_gate(args, report)
    step3_wer(args, report)
    step4_quality(args, report)
    step4b_serving(args, report)
    report["wall_seconds"] = round(time.time() - t0, 1)
    step5_record(args, report)
    log(f"DONE in {report['wall_seconds']}s"
        + (" (dry-run: accuracy not checked)" if args.dry_run else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
