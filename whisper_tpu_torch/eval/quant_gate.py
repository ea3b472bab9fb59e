"""Quantization accuracy gate: proxy metrics for the WER-delta check.

Port of ``whisper_tpu/eval/quant_gate.py``. Runnable without labelled audio:
the fp32 greedy path's tokens are teacher-forced through each variant (one
prefill-style ``decoder_forward`` over the whole row), and the gate reports

- the mean per-step KL divergence of the next-token distributions from fp32,
- top-1 agreement (the share of steps whose argmax token matches),
- the largest absolute logit error.

The variants are the int8 modes (weights, cross-KV, self-KV, the logits
embedding, all four), the tanh GELU and the W8A8 encoder; ``fp32`` is the
control and must read zero. The JAX gate switches GELU and W8A8 through
environment variables read at trace time; here ``gelu=`` and ``w8a8=`` are
passed down the port's functions.

    python -m whisper_tpu_torch.eval.quant_gate --model tiny --batch 4

Runs on the card unless ``--device cpu``. With real weights the WER harness
(``python -m whisper_tpu_torch.eval``) is the final word.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch


@dataclass
class GateResult:
    variant: str
    kl_mean: float          # nats/step, fp32 || variant
    top1_agreement: float   # [0, 1]
    logit_max_abs_err: float
    steps: int

    def row(self) -> dict:
        return {
            "variant": self.variant,
            "kl_mean_nats": round(self.kl_mean, 6),
            "top1_agreement": round(self.top1_agreement, 4),
            "logit_max_abs_err": round(self.logit_max_abs_err, 4),
            "steps": self.steps,
        }


# "fp32" is the control: no quantization, so the harness itself must add no
# divergence. "gelu_tanh" is the tanh approximation of GELU (an accuracy for
# speed trade like the int8 modes); "w8a8" is int8 activations x int8
# weights in the encoder's linears (``models.model._linear_a8``).
VARIANTS = ("fp32", "int8_weights", "int8_cross_kv", "int8_self_kv",
            "int8_logits", "int8_all", "gelu_tanh", "w8a8")


def _teacher_forced_logits(model, cross_kv, tokens: torch.Tensor, dt,
                           self_kv_quant: bool, gelu: str = "erf") -> torch.Tensor:
    """Per-step next-token logits (B, T, V) fp32 of the token rows, as one
    prefill over a full-context self-KV cache (int8 with ``self_kv_quant``)."""
    from ..models.model import decoder_forward, new_kv_cache

    kv = new_kv_cache(model, tokens.shape[0], dt, quant=self_kv_quant)
    logits, _ = decoder_forward(model, tokens, 0, kv, cross_kv, dt, gelu=gelu)
    return logits


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def run_gate(
    model,
    mel: torch.Tensor,
    variant: str,
    prompt: Optional[np.ndarray] = None,
    max_tokens: int = 32,
    compute_dtype=None,
) -> GateResult:
    """Compare one variant of ``model`` (fp32 weights, left as they are)
    against the fp32 reference on ``mel`` (B, n_mels, frames), on the
    model's device."""
    from ..decode import encode_cross_kv, greedy_decode
    from ..ops.quant import quantize_logits_emb, quantize_params

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    cfg = model.cfg
    dt = compute_dtype or torch.float32
    B = mel.shape[0]
    if prompt is None:
        prompt = np.tile(np.asarray(cfg.sot_sequence("zh", "transcribe"), np.int64), (B, 1))
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64, device=mel.device)

    # the fp32 reference decode: its tokens are the teacher-forced path
    ref = greedy_decode(model, mel, prompt, dt, max_tokens=max_tokens)
    tokens, lengths = ref.tokens, ref.lengths.cpu().numpy()

    kv_quant = variant in ("int8_cross_kv", "int8_all")
    self_kv_quant = variant in ("int8_self_kv", "int8_all")
    weights = variant in ("int8_weights", "int8_all", "w8a8")
    logits_q8 = variant in ("int8_logits", "int8_all")
    gelu = "tanh" if variant == "gelu_tanh" else "erf"
    q_model = copy.deepcopy(model) if weights or logits_q8 else model
    if weights:
        quantize_params(q_model)
    if logits_q8:
        quantize_logits_emb(q_model)

    ref_logits = _teacher_forced_logits(model, encode_cross_kv(model, mel, dt), tokens, dt,
                                        self_kv_quant=False)
    q_ckv = encode_cross_kv(q_model, mel, dt, kv_quant=kv_quant, w8a8=variant == "w8a8",
                            gelu=gelu)
    q_logits = _teacher_forced_logits(q_model, q_ckv, tokens, dt, self_kv_quant, gelu)

    P = prompt.shape[1]
    ref_np = ref_logits.to(torch.float32).cpu().numpy()
    q_np = q_logits.to(torch.float32).cpu().numpy()
    kls, agree, max_err, steps = [], [], 0.0, 0
    for b in range(B):
        # the positions whose output predicts a sampled token: P-1 up to
        # lengths[b]-1, the step that sampled eot included
        lo, hi = P - 1, int(lengths[b])
        if hi <= lo:
            continue
        r = _log_softmax(ref_np[b, lo:hi])
        q = _log_softmax(q_np[b, lo:hi])
        kls.append(np.sum(np.exp(r) * (r - q), axis=-1))
        agree.append(np.argmax(r, axis=-1) == np.argmax(q, axis=-1))
        max_err = max(max_err, float(np.abs(ref_np[b, lo:hi] - q_np[b, lo:hi]).max()))
        steps += hi - lo
    # KL >= 0; fp32 round-off can leave a ~1e-8 negative
    kl = max(0.0, float(np.mean(np.concatenate(kls)))) if kls else 0.0
    top1 = float(np.mean(np.concatenate(agree))) if agree else 1.0
    return GateResult(variant=variant, kl_mean=kl, top1_agreement=top1,
                      logit_max_abs_err=max_err, steps=steps)


def gate(results: Dict[str, GateResult], kl_threshold: float = 0.02,
         top1_threshold: float = 0.98) -> bool:
    """Pass iff every variant stays within both thresholds."""
    return not any(r.kl_mean > kl_threshold or r.top1_agreement < top1_threshold
                   for r in results.values())


def main(argv=None) -> int:
    p = argparse.ArgumentParser("whisper_tpu_torch.eval.quant_gate")
    p.add_argument("--model", "-t", default="tiny")
    p.add_argument("--checkpoint", "-p", default=None)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max_tokens", type=int, default=32)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--kl_threshold", type=float, default=0.02)
    p.add_argument("--top1_threshold", type=float, default=0.98)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ..config import get_config
    from ..models.checkpoint import load_checkpoint
    from ..params import init_params
    from ..pipeline import resolve_device

    device = resolve_device(args.device)
    if args.checkpoint:
        model, cfg = load_checkpoint(args.checkpoint, size=args.model, device=device)
    else:
        cfg = get_config(args.model)
        model = init_params(cfg, args.seed, device=device)

    rng = np.random.default_rng(args.seed)
    mel = torch.from_numpy((rng.standard_normal((args.batch, cfg.n_mels, 2 * cfg.n_audio_ctx))
                            * 0.3).astype(np.float32)).to(device)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    results = {}
    for v in args.variants.split(","):
        results[v] = run_gate(model, mel, v, max_tokens=args.max_tokens, compute_dtype=dt)
        print(json.dumps(results[v].row()), file=sys.stderr)
    ok = gate(results, args.kl_threshold, args.top1_threshold)
    # KL and top-1 on random weights are a weak proxy for WER deltas: the
    # thresholds mean something only once a checkpoint is gated
    weights = "checkpoint" if args.checkpoint else "random-init"
    out = {"pass": ok, "weights": weights, **{v: r.row() for v, r in results.items()}}
    if weights == "random-init":
        out["caveat"] = ("thresholds exercised on random-init logits only; "
                         "re-gate with --checkpoint before trusting for WER")
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
