"""Batched beam search.

Port of ``whisper_tpu/beam.py``: whisper-style beams (K beams an utterance;
a hypothesis that emits eot retires to a finished set of K; the best
finished hypothesis is returned). The JAX package runs the loop as one
``lax.while_loop``; here it is a Python loop over eager PyTorch ops that
reads its condition from the device once a step, as ``greedy_decode_kv``
does (counted in ``host_syncs``).

The prompt is prefilled once per utterance and the self-KV cache tiled to
the B*K beams. Each step is one :func:`decoder_forward` over the beams with
``beam_k=K``: self-attention per beam through the self-attention kernel,
cross-attention against the UNEXPANDED cross-KV with each utterance's K
beams folded into the query axis (the JAX package's einsum), so the
cross-KV is never tiled. After the top-K the beams' self-KV cache, tokens
and rule state are reordered by gathers into fresh tensors (never a
scatter: parents repeat, and a scatter with repeated indices is
nondeterministic on CUDA).

``jax.lax.top_k`` breaks ties toward the lower index and ties are the
normal case here (every beam but beam 0 starts at ``NEG_INF``, an
utterance whose beams are all dead has whole rows of it), while
``torch.topk`` promises no order among equal values: :func:`_top_k` sorts
descending with a stable sort and slices, which is top_k's order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .decode import encode_cross_kv
from .models.model import DataRows, Shards, decoder_forward, new_kv_cache
from .sampling import NEG_INF, RuleState, apply_rules


class BeamResult(NamedTuple):
    tokens: torch.Tensor          # (B, n_text_ctx) int64 best hypothesis, prompt included
    lengths: torch.Tensor         # (B,) index of its eot (or of the cap)
    scores: torch.Tensor          # (B,) fp32 normalized log-prob of the winner
    all_tokens: torch.Tensor      # (B, K, n_text_ctx) the finished set
    all_scores: torch.Tensor      # (B, K) fp32
    no_speech_prob: torch.Tensor  # (B,) fp32: P(<|nospeech|>) at the sot position
    avg_logprob: torch.Tensor     # (B,) the winner's normalized score
    steps: int = 0                # S=1 decoder steps run after the prefill
    host_syncs: int = 0           # device->host reads of the loop condition

    @property
    def device_steps(self) -> int:
        """S=1 steps the device ran: the beam loop runs no masked step."""
        return self.steps


def _norm_score(raw: torch.Tensor, length: torch.Tensor, alpha: Optional[float]):
    """GoogleNMT length penalty for ``alpha``, else the mean log-prob; the
    JAX package's fp32 arithmetic (tensor divisors, so the card divides as
    the CPU does)."""
    length = torch.clamp(length.to(torch.float32), min=1.0)
    if alpha is None:
        return raw / length
    return raw / (((5.0 + length) / length.new_full((), 6.0)) ** alpha)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, ties
    toward the lower index (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _map_cache(kv, fn):
    """``fn`` on every tensor of a self-KV cache (each rank's of each data
    row's, under a mesh), into a cache of the same kind."""
    if isinstance(kv, (Shards, DataRows)):
        return type(kv)(_map_cache(c, fn) for c in kv)
    return type(kv)(*(fn(t) for t in kv))


def _gather_cache(kv, flat: torch.Tensor):
    """The beams' reorder of a self-KV cache: axis 1 (the B*K stream axis)
    of every tensor gathered at ``flat`` (b*K + parent), into new tensors.
    A beam's parent is a beam of its utterance, so under data rows each
    row's block of ``flat`` indexes the row's own block."""
    if isinstance(kv, DataRows):
        n = flat.shape[0] // len(kv)
        return DataRows(_gather_cache(c, flat[d * n:(d + 1) * n] - d * n)
                        for d, c in enumerate(kv))
    return _map_cache(kv, lambda t: t.index_select(1, flat.to(t.device)))


def beam_search_kv(
    model,
    cross_kv,              # 2- or 4-tuple from decode.encode_cross_kv, batch B
    prompt: torch.Tensor,  # (B, P) int64
    compute_dtype=torch.float32,
    beam_size: int = 5,
    max_tokens: Optional[int] = None,
    suppress_ids: Optional[torch.Tensor] = None,
    timestamps: bool = False,
    apply_filters: bool = True,
    length_penalty: Optional[float] = None,
    prompt_pad: Optional[torch.Tensor] = None,  # (B,) left-pad lengths
    sot_index: int = 0,
    self_kv_quant: bool = False,
    gelu: str = "erf",
) -> BeamResult:
    """Beam search against precomputed cross-KV (the JAX package's
    ``beam_search_kv``): shares one encoder pass with language detection
    and the pipeline's retry ladder. ``length_penalty`` is the GoogleNMT
    alpha (None: mean log-prob); ``prompt_pad`` and ``sot_index`` as in
    ``greedy_decode_kv``. The self-KV cache holds the 128-rounded token
    budget; no step writes past it."""
    cfg = model.cfg
    device = prompt.device
    B, P = prompt.shape
    K = beam_size
    N = B * K
    T = cfg.n_text_ctx
    V = cfg.n_vocab
    if P >= T:
        raise ValueError(f"prompt of {P} tokens leaves no room in n_text_ctx={T}")
    limit = min(T, P + max_tokens) if max_tokens else T
    kv_ctx = min(T, -(-limit // 128) * 128)
    eot = cfg.eot
    ts0 = cfg.timestamp_begin
    use_rules = apply_filters or timestamps or suppress_ids is not None
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=device)
    half = NEG_INF / 2

    def filt(logits, state):
        if not use_rules:
            return logits
        return apply_rules(logits, state, cfg, suppress_ids=suppress_ids, timestamps=timestamps)

    # prefill once per utterance, then tile the self-KV per beam; the
    # cross-KV stays at batch B (decoder_forward(beam_k=K) folds the beams)
    prompt = prompt.to(torch.int64)
    if prompt_pad is not None:
        prompt_pad = prompt_pad.to(device=device, dtype=torch.int64)
    kv = new_kv_cache(model, B, compute_dtype, kv_ctx, quant=self_kv_quant)
    logits, kv = decoder_forward(model, prompt, 0, kv, cross_kv, compute_dtype,
                                 pad=prompt_pad, gelu=gelu)
    no_speech_prob = torch.softmax(logits[:, sot_index].to(torch.float32),
                                   dim=-1)[:, cfg.no_speech]
    kv = _map_cache(kv, lambda t: t.repeat_interleave(K, dim=1))
    pad_n = None if prompt_pad is None else prompt_pad.repeat_interleave(K)

    tokens = torch.full((N, T), eot, dtype=torch.int64, device=device)
    tokens[:, :P] = prompt.repeat_interleave(K, dim=0)
    rs = RuleState.create(N, device=device)
    # first expansion: the top K tokens of beam 0 (the others start at -inf)
    lp0 = torch.log_softmax(filt(logits[:, -1].repeat_interleave(K, dim=0), rs)
                            .to(torch.float32), dim=-1)
    beam0 = (torch.arange(N, device=device) % K == 0)[:, None]
    scores, flat_idx = _top_k(torch.where(beam0, lp0, neg).reshape(B, K * V), K)
    first = flat_idx % V
    tokens[:, P] = first.reshape(N)
    rs = rs.advance(first.reshape(N), ts0)
    # a beam that opened with eot is finished at once
    opened = first == eot
    fin_scores = torch.where(opened, _norm_score(scores, torch.ones_like(scores),
                                                 length_penalty), neg)
    fin_tokens = tokens.reshape(B, K, T).clone()
    fin_lens = torch.full((B, K), P, dtype=torch.int64, device=device)
    scores = torch.where(opened, neg, scores)
    n_gen = torch.ones((B, K), dtype=torch.int64, device=device)
    parent_base = (torch.arange(B, device=device) * K)[:, None]

    i, steps, syncs = P, 0, 0
    while i < limit - 1:
        # running beams left in an utterance whose finished set is not full
        syncs += 1
        live = (scores > half).any(dim=1)
        unfinished = (fin_scores <= half).any(dim=1)
        if not bool((live & unfinished).any()):
            break
        logits, kv = decoder_forward(model, tokens[:, i:i + 1], i, kv, cross_kv,
                                     compute_dtype, pad=pad_n, gelu=gelu, beam_k=K)
        lp = torch.log_softmax(filt(logits[:, 0], rs).to(torch.float32), dim=-1)  # (N, V)
        cand = scores.reshape(N, 1) + lp
        cand = torch.where((scores.reshape(N) > half)[:, None], cand, neg)
        cand2k, idx2k = _top_k(cand.reshape(B, K * V), 2 * K)
        tok2k, src2k = idx2k % V, idx2k // V
        is_eot = tok2k == eot
        ngen_src = torch.gather(n_gen, 1, src2k)
        n_gen2k = ngen_src + 1

        # retire the eot candidates into the finished set (top K of 3K)
        eot_norm = torch.where(is_eot, _norm_score(cand2k, n_gen2k, length_penalty), neg)
        merged_scores = torch.cat([fin_scores, eot_norm], dim=1)
        cand_tokens = torch.gather(tokens.reshape(B, K, T), 1,
                                   src2k[..., None].expand(B, 2 * K, T))
        merged_tokens = torch.cat([fin_tokens, cand_tokens], dim=1)
        merged_lens = torch.cat([fin_lens, P + ngen_src], dim=1)
        fin_scores, fin_idx = _top_k(merged_scores, K)
        fin_tokens = torch.gather(merged_tokens, 1, fin_idx[..., None].expand(B, K, T))
        fin_lens = torch.gather(merged_lens, 1, fin_idx)

        # keep the top K non-eot candidates running
        scores, pick = _top_k(torch.where(is_eot, neg, cand2k), K)
        new_tok = torch.gather(tok2k, 1, pick).reshape(N)
        n_gen = torch.gather(n_gen2k, 1, pick)
        flat = (parent_base + torch.gather(src2k, 1, pick)).reshape(N)
        tokens = tokens.index_select(0, flat)
        tokens[:, i + 1] = new_tok
        kv = _gather_cache(kv, flat)
        rs = RuleState(*(f.index_select(0, flat) for f in rs)).advance(new_tok, ts0)
        i += 1
        steps += 1

    # an utterance with no finished hypothesis falls back to its best
    # running beam, which ran to the cap
    run_norm = _norm_score(scores, n_gen, length_penalty)
    no_fin = (fin_scores <= half).all(dim=1, keepdim=True)
    rows = torch.arange(B, device=device)
    best_run = torch.argmax(run_norm, dim=1)
    run_tokens = tokens.reshape(B, K, T)[rows, best_run]
    fin_scores_or_run = torch.where(no_fin, torch.gather(run_norm, 1, best_run[:, None]),
                                    fin_scores)
    best = torch.argmax(fin_scores_or_run, dim=1)
    best_tokens = torch.where(no_fin, run_tokens, fin_tokens[rows, best])
    best_lens = torch.where(no_fin[:, 0], torch.full_like(fin_lens[:, 0], i + 1),
                            torch.gather(fin_lens, 1, best[:, None])[:, 0])
    best_scores = torch.gather(fin_scores_or_run, 1, best[:, None])[:, 0]
    # the buffer is eot after the hypothesis
    pos = torch.arange(T, device=device)[None, :]
    best_tokens = torch.where(pos >= best_lens[:, None], torch.full_like(best_tokens, eot),
                              best_tokens)
    return BeamResult(tokens=best_tokens, lengths=best_lens, scores=best_scores,
                      all_tokens=fin_tokens, all_scores=fin_scores,
                      no_speech_prob=no_speech_prob, avg_logprob=best_scores,
                      steps=steps, host_syncs=syncs)


def beam_search(model, mel: torch.Tensor, prompt: torch.Tensor, compute_dtype=torch.float32,
                kv_quant: bool = False, w8a8: bool = False, gelu: str = "erf",
                encoder_attention: str = "btd", **kw) -> BeamResult:
    """Encoder + beam loop (:func:`~whisper_tpu_torch.decode.encode_cross_kv`
    then :func:`beam_search_kv`, which takes the remaining keywords)."""
    cross_kv = encode_cross_kv(model, mel, compute_dtype, kv_quant=kv_quant, w8a8=w8a8,
                               gelu=gelu, encoder_attention=encoder_attention)
    return beam_search_kv(model, cross_kv, prompt, compute_dtype, gelu=gelu, **kw)
