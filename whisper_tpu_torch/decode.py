"""Batched greedy decoding.

Port of ``whisper_tpu/decode.py``. The JAX package runs prefill and the whole
token loop as one ``lax.while_loop``; here the loop is Python over eager
PyTorch ops: one :func:`decoder_forward` prefill over the prompt, then one
S=1 step per token, each followed by the rules (``sampling.apply_rules``),
log_softmax and argmax. The all-done early exit reads one flag from the
device per step; those host syncs are counted in the result.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from .models.model import (
    KVCache,
    QKVCache,
    Whisper,
    compute_cross_kv,
    decoder_forward,
    encoder_forward,
    quantize_cross_kv,
)
from .sampling import RuleState, apply_rules


class GreedyResult(NamedTuple):
    tokens: torch.Tensor          # (B, n_text_ctx) int64, prompt included, eot-padded
    lengths: torch.Tensor         # (B,) index of the first eot after the prompt
    no_speech_prob: torch.Tensor  # (B,) fp32: P(<|nospeech|>) at the sot position
    avg_logprob: torch.Tensor     # (B,) fp32: mean logprob of sampled tokens (incl. eot)
    steps: int = 0                # S=1 decoder steps run after the prefill
    host_syncs: int = 0           # device->host reads of the all-done flag


def encode_cross_kv(model: Whisper, mel: torch.Tensor, compute_dtype=torch.float32,
                    kv_quant: bool = False, w8a8: bool = False, gelu: str = "erf"):
    """Encoder + per-layer cross-attention K/V: the 2-tuple (k, v) each
    (L, B, H, Ta, dh), or with ``kv_quant`` the int8 4-tuple of
    :func:`quantize_cross_kv`."""
    with record_function("whisper.encoder"):
        audio = encoder_forward(model, mel, compute_dtype, w8a8=w8a8, gelu=gelu)
    with record_function("whisper.cross_kv"):
        cross_kv = compute_cross_kv(model, audio, compute_dtype)
        return quantize_cross_kv(cross_kv) if kv_quant else cross_kv


def greedy_decode_kv(
    model: Whisper,
    cross_kv,
    prompt: torch.Tensor,  # (B, P) int64, e.g. [sot, lang, task, notimestamps]
    compute_dtype=torch.float32,
    max_tokens: Optional[int] = None,
    suppress_ids: Optional[torch.Tensor] = None,
    apply_filters: bool = False,
    self_kv_quant: bool = False,
    gelu: str = "erf",
    timestamps: bool = False,
    prompt_pad: Optional[torch.Tensor] = None,  # (B,) int64 left-pad lengths
    sot_index: int = 0,
) -> GreedyResult:
    """Prefill + greedy token loop against precomputed cross-KV.

    Same semantics as the JAX ``greedy_decode_kv`` at temperature 0: the
    loop runs while ``i < limit - 1`` and some stream is not done; a done
    stream keeps emitting eot; ``lengths`` is the first eot at or after the
    prompt. The self-KV cache is sized to the 128-rounded token budget.
    ``timestamps`` runs the timestamp grammar of ``sampling.apply_rules``.
    ``prompt_pad`` right-aligns prompts of differing lengths (e.g.
    ``[sot_prev, *prev, sot, lang, task]``): the first ``prompt_pad[b]``
    positions of row b are masked out of attention and skipped in its
    positional indexing, at the prefill and at every step. ``sot_index`` is
    the column of sot, where the no-speech probability is read.
    """
    cfg = model.cfg
    device = prompt.device
    B = prompt.shape[0]
    P = prompt.shape[1]
    T = cfg.n_text_ctx
    if P >= T:
        raise ValueError(f"prompt of {P} tokens leaves no room in n_text_ctx={T}")
    limit = min(T, P + max_tokens) if max_tokens else T
    kv_ctx = min(T, -(-limit // 128) * 128)
    eot = cfg.eot
    ts0 = cfg.timestamp_begin
    use_rules = apply_filters or timestamps or suppress_ids is not None

    def filt(logits, state):
        if not use_rules:
            return logits
        return apply_rules(logits, state, cfg, suppress_ids=suppress_ids,
                           timestamps=timestamps)

    def sample(logits_f):
        lp = torch.log_softmax(logits_f.to(torch.float32), dim=-1)
        tok = torch.argmax(lp, dim=-1)
        return tok, torch.gather(lp, 1, tok[:, None])[:, 0]

    if self_kv_quant:
        kv = QKVCache.create(cfg, B, ctx=kv_ctx, device=device)
    else:
        kv = KVCache.create(cfg, B, dtype=compute_dtype, ctx=kv_ctx, device=device)

    prompt = prompt.to(torch.int64)
    tokens = torch.full((B, T), eot, dtype=torch.int64, device=device)
    tokens[:, :prompt.shape[1]] = prompt

    if prompt_pad is not None:
        prompt_pad = prompt_pad.to(device=device, dtype=torch.int64)
    logits, kv = decoder_forward(model, prompt, 0, kv, cross_kv, compute_dtype,
                                 pad=prompt_pad, gelu=gelu)
    no_speech_prob = torch.softmax(logits[:, sot_index], dim=-1)[:, cfg.no_speech]
    rs = RuleState.create(B, device=device)
    first, first_lp = sample(filt(logits[:, -1], rs))
    rs = rs.advance(first, ts0)
    tokens[:, P] = first
    done = first == eot
    sum_lp = first_lp
    n_lp = torch.ones((B,), dtype=torch.float32, device=device)

    i, steps, syncs = P, 0, 0
    while i < limit - 1:
        syncs += 1
        if bool(done.all()):
            break
        logits, kv = decoder_forward(model, tokens[:, i:i + 1], i, kv, cross_kv,
                                     compute_dtype, pad=prompt_pad, gelu=gelu)
        nxt, lp = sample(filt(logits[:, 0], rs))
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
    first_eot = torch.where((tokens == eot) & (pos >= P), pos,
                            torch.full_like(pos, T)).amin(dim=1)
    return GreedyResult(tokens=tokens, lengths=first_eot, no_speech_prob=no_speech_prob,
                        avg_logprob=sum_lp / torch.clamp(n_lp, min=1.0),
                        steps=steps, host_syncs=syncs)


def greedy_decode(model: Whisper, mel: torch.Tensor, prompt: torch.Tensor,
                  compute_dtype=torch.float32, kv_quant: bool = False,
                  w8a8: bool = False, gelu: str = "erf", **kw) -> GreedyResult:
    """Encoder + prefill + greedy loop (:func:`encode_cross_kv` then
    :func:`greedy_decode_kv`, which takes the remaining keywords)."""
    cross_kv = encode_cross_kv(model, mel, compute_dtype, kv_quant=kv_quant,
                               w8a8=w8a8, gelu=gelu)
    return greedy_decode_kv(model, cross_kv, prompt, compute_dtype, gelu=gelu, **kw)


def extract_texts(result: GreedyResult, prompt_len: int, tokenizer,
                  timestamps: bool = False) -> list:
    """Host side: token buffer -> list of decoded strings; with
    ``timestamps`` the timestamp tokens are kept as ``<|t.tt|>``."""
    toks = result.tokens.cpu().numpy()
    lens = result.lengths.cpu().numpy()
    decode = tokenizer.decode_with_timestamps if timestamps else tokenizer.decode
    return [decode(toks[b, prompt_len: lens[b]]).strip() for b in range(toks.shape[0])]
