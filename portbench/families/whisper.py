"""The Whisper family (``"model_type": "whisper"``): OpenAI's encoder-decoder
as its published Hugging Face configuration gives it.

- ``dims``: the configuration's sizes as ``weights.Dims``.
- ``judge``: the plain fp32 reference (``reference.py``) over the weights
  ``weights.make_weights`` makes from the seed, teacher-forced over each
  judged request's prompt and served tokens, read under the decode's rules
  (``reference.allowed_mask``); with ``control``, the reference rounded to
  that precision (``reference.Reference(quant=...)``) beside it.
- ``port_model``: the port's ``Whisper`` over the same weights.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from portbench.judge import Gaps, Served, gaps_below_best, masked, mean_logprob
from portbench.reference import N_SAMPLES, Reference, Specials, allowed_mask, log_mel
from portbench.weights import Dims, make_weights

CONTROL = "int4"  # the configurations serve int8: the control is the precision below
ENCODE_BLOCK = 4  # clips the reference encodes at a time


def dims(config: dict) -> Dims:
    return Dims.from_config(config)


@torch.no_grad()
def judge(dims: Dims, weight_seed: int, served: Sequence[Served], device,
          control: Optional[str] = None) -> Gaps:
    """The reference's (and, with ``control``, the control's) reading of
    ``served``; weights made again from ``weight_seed`` on ``device``."""
    w = make_weights(dims, weight_seed, device)
    ref = Reference(dims, w)
    ctl = Reference(dims, w, quant=control) if control else None
    sp = Specials(dims)
    first, rest = allowed_mask(dims, device, True), allowed_mask(dims, device, False)
    gaps, ctl_gaps, lp_err, ctl_lp_err, fault = [], [], [], [], []
    for lo in range(0, len(served), ENCODE_BLOCK):
        block = served[lo: lo + ENCODE_BLOCK]
        audio = torch.zeros((len(block), N_SAMPLES), dtype=torch.float32, device=device)
        for i, s in enumerate(block):
            clip = torch.from_numpy(np.ascontiguousarray(s.audio[:N_SAMPLES]))
            audio[i, : len(clip)] = clip.to(device)
        mel = log_mel(audio, [min(len(s.audio), N_SAMPLES) for s in block], dims.n_mels)
        feats = ref.encode(mel)
        ctl_feats = ctl.encode(mel) if ctl else None
        for i, s in enumerate(block):
            if len(s.tokens) == 0:
                continue
            prompt = sp.prompt(s.language)
            toks = torch.as_tensor(np.asarray(s.tokens, np.int64), device=device)
            seq = torch.cat([torch.as_tensor(prompt, device=device), toks[:-1]])[None]
            at = slice(len(prompt) - 1, len(prompt) - 1 + len(toks))
            ref_m = masked(ref.logits(feats[i: i + 1], seq)[0, at], first, rest)
            gaps.append(gaps_below_best(ref_m, toks))
            lp_err.append(abs(s.avg_logprob - mean_logprob(ref_m, toks)))
            if ctl:
                c = masked(ctl.logits(ctl_feats[i: i + 1], seq)[0, at], first, rest)
                ctl_gaps.append(gaps_below_best(ref_m, c.argmax(dim=-1)))
                ctl_lp_err.append(abs(mean_logprob(c, toks) - mean_logprob(ref_m, toks)))
                if not fault:
                    ok = torch.isfinite(ref_m[0]).nonzero()[:, 0]
                    moved = ok[(ok > toks[0]).nonzero()[0, 0] if (ok > toks[0]).any() else 0]
                    fault.append(float(gaps_below_best(ref_m[:1], moved[None])[0]))
    if not gaps:
        return Gaps(widest=math.inf, mean=math.inf, tokens=0, logprob_error=math.inf)
    g = torch.cat(gaps)
    return Gaps(widest=float(g.max()), mean=float(g.mean()), tokens=int(g.numel()),
                logprob_error=max(lp_err),
                control=float(torch.cat(ctl_gaps).max()) if ctl_gaps else None,
                control_logprob_error=max(ctl_lp_err) if ctl_lp_err else None,
                fault=max(fault[0], float(g.max())) if fault else None)


def port_model(dims: Dims, config: dict, seed: int, device):
    """The port's ``Whisper`` over this benchmark's weights (views of one
    buffer: the port's quantization and cast replace every leaf)."""
    from whisper_tpu_torch.config import WhisperConfig
    from whisper_tpu_torch.models.model import Decoder, Encoder, Whisper

    if dims.n_audio_ffn != 4 * dims.n_audio_state or dims.n_text_ffn != 4 * dims.n_text_state:
        raise ValueError("the port's blocks take an MLP four times their width")
    cfg = WhisperConfig(name=config["name"], n_mels=dims.n_mels, n_audio_ctx=dims.n_audio_ctx,
                        n_audio_state=dims.n_audio_state, n_audio_head=dims.n_audio_head,
                        n_audio_layer=dims.n_audio_layer, n_vocab=dims.n_vocab,
                        n_text_ctx=dims.n_text_ctx, n_text_state=dims.n_text_state,
                        n_text_head=dims.n_text_head, n_text_layer=dims.n_text_layer,
                        num_languages=dims.num_languages)
    w = make_weights(dims, seed, device)
    e, d = w["encoder"], w["decoder"]
    encoder = Encoder(conv1=e["conv1"], conv2=e["conv2"], pos_emb=e["pos_emb"],
                      ln_post=e["ln_post"], blocks=e["blocks"])
    decoder = Decoder(tok_emb=d["tok_emb"], pos_emb=d["pos_emb"], ln=d["ln"],
                      blocks=d["blocks"])
    return Whisper(cfg, encoder, decoder)
