"""Batched greedy and sampled decoding, and language detection.

Port of ``whisper_tpu/decode.py``. The JAX package runs prefill and the whole
token loop as one ``lax.while_loop``; here the loop is Python over eager
PyTorch ops: one :func:`decoder_forward` prefill over the prompt, then one
S=1 step per token, each followed by the rules (``sampling.apply_rules``),
log_softmax and argmax (at ``temperature > 0``, a categorical draw). The
all-done early exit reads one flag from the device per step; those host
syncs are counted in the result. Every function takes a sharded model
(``parallel.sharding.shard_params``, on a mesh of any (data, model) shape)
wherever it takes a ``Whisper``: under data rows the model functions split
each step's batch over the rows, and the loop reads one flag for them all.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from .models.model import (
    DataRows,
    Shards,
    compute_cross_kv,
    decoder_forward,
    encoder_forward,
    new_kv_cache,
    quantize_cross_kv,
    shard_values,
)
from .sampling import RuleState, apply_rules


class GreedyResult(NamedTuple):
    tokens: torch.Tensor          # (B, n_text_ctx) int64, prompt included, eot-padded
    lengths: torch.Tensor         # (B,) index of the first eot after the prompt
    no_speech_prob: torch.Tensor  # (B,) fp32: P(<|nospeech|>) at the sot position
    avg_logprob: torch.Tensor     # (B,) fp32: mean logprob of sampled tokens (incl. eot)
    steps: int = 0                # S=1 decoder steps run after the prefill
    host_syncs: int = 0           # device->host reads of the all-done flag


def encode_cross_kv(model, mel: torch.Tensor, compute_dtype=torch.float32,
                    kv_quant: bool = False, w8a8: bool = False, gelu: str = "erf",
                    encoder_attention: str = "btd"):
    """Encoder + per-layer cross-attention K/V: the 2-tuple (k, v) each
    (L, B, H, Ta, dh), or with ``kv_quant`` the int8 4-tuple of
    :func:`quantize_cross_kv`. ``encoder_attention`` selects the encoder's
    attention kernel (:func:`~whisper_tpu_torch.models.model.encoder_blocks`)."""
    with record_function("whisper.encoder"):
        audio = encoder_forward(model, mel, compute_dtype, w8a8=w8a8, gelu=gelu,
                                attn=encoder_attention)
    with record_function("whisper.cross_kv"):
        cross_kv = compute_cross_kv(model, audio, compute_dtype)
        return quantize_cross_kv(cross_kv) if kv_quant else cross_kv


def index_cross_kv(cross_kv, idx: torch.Tensor):
    """A batch subset of a (possibly int8, possibly sharded) cross-KV: every
    leaf is (L, B, ...), batch on axis 1. The temperature ladder re-decodes
    only the failed rows against it, without re-running the encoder. Its
    rows are those of one data row (the pipeline places no data rows)."""
    if isinstance(cross_kv, DataRows):
        raise TypeError("index_cross_kv takes the cross-KV of one data row, not DataRows")
    if isinstance(cross_kv, Shards):
        return Shards(index_cross_kv(c, idx) for c in cross_kv)
    return tuple(a.index_select(1, idx.to(a.device)) for a in cross_kv)


def gumbel_noise(seed: int, device) -> Callable[[int, tuple], torch.Tensor]:
    """The sampler's own noise: step -> standard Gumbel draws of a shape,
    ``-log(-log(u))`` of uniforms from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (floored at the smallest normal fp32, as
    ``jax.random.gumbel`` floors them)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tiny = torch.finfo(torch.float32).tiny

    def draw(step: int, shape: tuple) -> torch.Tensor:
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))

    return draw


def greedy_decode_kv(
    model,
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
    cross_decode: str = "fd",
    temperature: float = 0.0,
    seed: int = 0,
    noise: Optional[Callable[[int, tuple], torch.Tensor]] = None,
) -> GreedyResult:
    """Prefill + greedy (or sampled) token loop against precomputed cross-KV.

    Same semantics as the JAX ``greedy_decode_kv``: the loop runs while
    ``i < limit - 1`` and some stream is not done; a done stream keeps
    emitting eot; ``lengths`` is the first eot at or after the prompt. The
    self-KV cache is sized to the 128-rounded token budget.

    At ``temperature > 0`` each token is a categorical draw from the
    filtered distribution at that temperature, as ``jax.random.categorical``
    draws it: ``argmax(log_softmax(logits) / T + g)`` with standard Gumbel
    noise ``g``; its logprob (``avg_logprob``) is read from the unscaled
    distribution, as in JAX. ``noise(step, shape)`` supplies the draws of
    step 0 (the token after the prefill), 1, ... (tests hand in the JAX
    package's own, drawn from ``PRNGKey(seed)`` with its key splits);
    without it the draws come from :func:`gumbel_noise` of ``seed`` on the
    logits' device.
    ``timestamps`` runs the timestamp grammar of ``sampling.apply_rules``.
    ``prompt_pad`` right-aligns prompts of differing lengths (e.g.
    ``[sot_prev, *prev, sot, lang, task]``): the first ``prompt_pad[b]``
    positions of row b are masked out of attention and skipped in its
    positional indexing, at the prefill and at every step. ``sot_index`` is
    the column of sot, where the no-speech probability is read.
    ``cross_decode`` selects the step's int8 cross-attention kernel
    (:func:`~whisper_tpu_torch.models.model.decoder_forward`).
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

    stochastic = bool(temperature and temperature > 0)
    if stochastic and noise is None:
        noise = gumbel_noise(seed, device)

    def sample(logits_f, step: int):
        lp = torch.log_softmax(logits_f.to(torch.float32), dim=-1)
        if stochastic:
            # a tensor divisor, so the card divides as the CPU does
            tok = torch.argmax(lp / lp.new_full((), temperature) + noise(step, tuple(lp.shape)),
                               dim=-1)
        else:
            tok = torch.argmax(lp, dim=-1)
        return tok, torch.gather(lp, 1, tok[:, None])[:, 0]

    kv = new_kv_cache(model, B, compute_dtype, kv_ctx, quant=self_kv_quant)

    prompt = prompt.to(torch.int64)
    tokens = torch.full((B, T), eot, dtype=torch.int64, device=device)
    tokens[:, :prompt.shape[1]] = prompt

    if prompt_pad is not None:
        prompt_pad = prompt_pad.to(device=device, dtype=torch.int64)
    logits, kv = decoder_forward(model, prompt, 0, kv, cross_kv, compute_dtype,
                                 pad=prompt_pad, gelu=gelu, cross_decode=cross_decode)
    no_speech_prob = torch.softmax(logits[:, sot_index], dim=-1)[:, cfg.no_speech]
    rs = RuleState.create(B, device=device)
    first, first_lp = sample(filt(logits[:, -1], rs), 0)
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
                                     compute_dtype, pad=prompt_pad, gelu=gelu,
                                     cross_decode=cross_decode)
        nxt, lp = sample(filt(logits[:, 0], rs), steps + 1)
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


def greedy_decode(model, mel: torch.Tensor, prompt: torch.Tensor,
                  compute_dtype=torch.float32, kv_quant: bool = False,
                  w8a8: bool = False, gelu: str = "erf", encoder_attention: str = "btd",
                  **kw) -> GreedyResult:
    """Encoder + prefill + greedy loop (:func:`encode_cross_kv` then
    :func:`greedy_decode_kv`, which takes the remaining keywords)."""
    cross_kv = encode_cross_kv(model, mel, compute_dtype, kv_quant=kv_quant,
                               w8a8=w8a8, gelu=gelu, encoder_attention=encoder_attention)
    return greedy_decode_kv(model, cross_kv, prompt, compute_dtype, gelu=gelu, **kw)


def cross_batch(cross_kv) -> int:
    """The batch of a (possibly int8, sharded or data-row) cross-KV: every
    leaf is (L, B, ...)."""
    if isinstance(cross_kv, DataRows):
        return sum(cross_batch(c) for c in cross_kv)
    return shard_values(cross_kv)[0][0].shape[1]


def detect_language_kv(model, cross_kv, compute_dtype=torch.float32,
                       cross_decode: str = "fd") -> Tuple[torch.Tensor, torch.Tensor]:
    """Language ID against precomputed cross-KV (the JAX package's
    ``detect_language_kv`` and ``_detect_language_from_kv``): one decoder
    step on ``[sot]`` at offset 0 over a float self-KV cache of 128
    positions in the compute dtype, whatever the caller's self-KV
    quantization; softmax and argmax over the language tokens' logits.
    With the int8 cross-KV the step runs the ``cross_decode`` kernel and the
    float self-attention kernel once a decoder layer. Returns (lang_index
    (B,) int64, an offset into the canonical language list; probs (B,
    num_languages) fp32)."""
    cfg = model.cfg
    B = cross_batch(cross_kv)
    kv = new_kv_cache(model, B, compute_dtype, ctx=128)
    sot = torch.full((B, 1), cfg.sot, dtype=torch.int64, device=model.device)
    logits, _ = decoder_forward(model, sot, 0, kv, cross_kv, compute_dtype,
                                cross_decode=cross_decode)
    lang_logits = logits[:, 0, cfg.lang_token_start: cfg.lang_token_start + cfg.num_languages]
    return torch.argmax(lang_logits, dim=-1), torch.softmax(lang_logits, dim=-1)


def detect_language(model, mel: torch.Tensor,
                    compute_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder + float cross-KV + :func:`detect_language_kv` (the JAX
    package's ``detect_language``)."""
    return detect_language_kv(model, encode_cross_kv(model, mel, compute_dtype), compute_dtype)


def extract_texts(result, prompt_len: int, tokenizer, timestamps: bool = False) -> list:
    """Host side: the token buffer of a ``GreedyResult`` or a
    ``beam.BeamResult`` -> list of decoded strings; with ``timestamps`` the
    timestamp tokens are kept as ``<|t.tt|>``."""
    toks = result.tokens.cpu().numpy()
    lens = result.lengths.cpu().numpy()
    decode = tokenizer.decode_with_timestamps if timestamps else tokenizer.decode
    return [decode(toks[b, prompt_len: lens[b]]).strip() for b in range(toks.shape[0])]
