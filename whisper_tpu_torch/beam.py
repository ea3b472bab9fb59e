"""Batched beam search.

Port of ``whisper_tpu/beam.py``: whisper-style beams (K beams an utterance;
a hypothesis that emits eot retires to a finished set of K; the best
finished hypothesis is returned). The JAX package runs the loop as one
``lax.while_loop``. Here, as the greedy loop of ``decode.greedy_decode_kv``,
it runs in rounds of ``decode.ROUND_STEPS`` steps that never read the device
from the host: each step computes JAX's ``cond`` on the device (the position
below ``limit - 1`` and some utterance with a running beam and a finished set
not yet full) and gates every write by it, so a step past the loop's end
changes nothing; the host reads the loop's flags once a round (counted in
``host_syncs``). On the card a round of a single-device ``Whisper``, or of a
mesh whose ranks all lie on the card, is a CUDA graph (``utils.graphs``),
captured once per shape and replayed; on the CPU and under a mesh over
distinct cards the same round runs uncaptured.

The prompt is prefilled once per utterance and the self-KV cache tiled to
the B*K beams. Each step is one S=1 decoder step over the beams at the
position held on the device (``models.model._step_multipos`` with
``beam_k=K``): self-attention per beam through the self-attention kernel,
cross-attention against the UNEXPANDED cross-KV with each utterance's K
beams folded into the query axis (the JAX package's einsum), so the
cross-KV is never tiled. After the top-K the beams' self-KV cache is
reordered by a gather into a second cache of the loop's, the two caches
taking turns step by step (one read and one write of the cache a step; a
round of even ``ROUND_STEPS`` ends in the cache it began in, an odd one
gathers back once), and their tokens and rule state by gathers into
temporaries that are copied back in place: never a scatter, since parents
repeat, and a scatter with repeated indices is nondeterministic on CUDA.

``jax.lax.top_k`` breaks ties toward the lower index and ties are the
normal case here (every beam but beam 0 starts at ``NEG_INF``, an
utterance whose beams are all dead has whole rows of it), while
``torch.topk`` promises no order among equal values: :func:`_top_k` sorts
descending with a stable sort and slices, which is top_k's order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import decode
from .decode import capturable, encode_cross_kv
from .models.model import (
    DataRows,
    _step_multipos,
    decoder_forward,
    new_kv_cache,
    shard_values,
)
from .sampling import NEG_INF, RuleState

HALF = NEG_INF / 2


class BeamResult(NamedTuple):
    tokens: torch.Tensor          # (B, n_text_ctx) int64 best hypothesis, prompt included
    lengths: torch.Tensor         # (B,) index of its eot (or of the cap)
    scores: torch.Tensor          # (B,) fp32 normalized log-prob of the winner
    all_tokens: torch.Tensor      # (B, K, n_text_ctx) the finished set
    all_scores: torch.Tensor      # (B, K) fp32
    no_speech_prob: torch.Tensor  # (B,) fp32: P(<|nospeech|>) at the sot position
    avg_logprob: torch.Tensor     # (B,) the winner's normalized score
    steps: int = 0                # the loop's trip count: S=1 steps run after the first expansion
    host_syncs: int = 0           # device->host reads of the loop's flags: one a round
    # S=1 steps the device ran: whole rounds, masked steps included (each
    # launches the step's kernels)
    device_steps: int = 0


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


def _gather_cache(src, dst, flat: torch.Tensor) -> None:
    """The beams' reorder of a self-KV cache: axis 1 (the B*K stream axis)
    of every tensor of ``src`` gathered at ``flat`` (b*K + parent) into the
    same tensor of ``dst``, a cache of the same shapes. A beam's parent is
    a beam of its utterance, so under data rows each row's block of
    ``flat`` indexes the row's own block."""
    if isinstance(src, DataRows):
        n = flat.shape[0] // len(src)
        for d, (s, t) in enumerate(zip(src, dst)):
            _gather_cache(s, t, flat[d * n:(d + 1) * n] - d * n)
        return
    for s_cache, d_cache in zip(shard_values(src), shard_values(dst)):
        for s, d in zip(s_cache, d_cache):
            torch.index_select(s, 1, flat.to(s.device), out=d)


class _BeamLoop:
    """The beam loop's device state, written in place by the first
    expansion and by every round: all that a captured round reads or
    writes besides the weights. ``cross``, ``pad`` (one a beam) and
    ``suppress`` are the caller's tensors in an uncaptured loop and the
    graph's own copies in a captured one; ``kv`` is the tiled prefill's
    cache in an uncaptured loop and a cache of the loop's own in a
    captured one, and ``spare`` the cache the reorder gathers it into."""

    def __init__(self, batch: int, k: int, n_ctx: int, device, kv=None):
        N = batch * k
        i64 = dict(dtype=torch.int64, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.k = k
        self.kv = kv
        self.spare = None  # made beside ``kv`` by the first expansion
        self.tokens = torch.empty((N, n_ctx), **i64)
        self.pos = torch.empty((N,), **i64)  # the step's position, the same on every beam
        self.last = torch.empty((), **i64)   # limit - 1: where the loop stops
        self.p0 = torch.empty((), **i64)     # the prompt's length
        self.rs = RuleState.create(N, device=device)
        self.scores = torch.empty((batch, k), **f32)  # raw running log-prob sums
        self.n_gen = torch.empty((batch, k), **i64)
        self.fin_scores = torch.empty((batch, k), **f32)
        self.fin_tokens = torch.empty((batch, k, n_ctx), **i64)
        self.fin_lens = torch.empty((batch, k), **i64)
        self.flags = torch.empty((2,), **i64)  # [the loop goes on, position]: read once a round
        self.neg = torch.full((), NEG_INF, **f32)
        self.beams = torch.arange(N, device=device)
        self.base = (torch.arange(batch, device=device) * k)[:, None]
        self.cross = self.pad = self.suppress = None


def _going(loop: _BeamLoop) -> torch.Tensor:
    """JAX's ``cond`` as a 0-d bool on the device: the position below
    ``limit - 1`` and some utterance with a running beam and a finished set
    not yet full."""
    live = (loop.scores > HALF).any(dim=1)
    unfinished = (loop.fin_scores <= HALF).any(dim=1)
    return (loop.pos[0] < loop.last) & (live & unfinished).any()


def _first_expansion(model, loop: _BeamLoop, prompt: torch.Tensor, prompt_pad, limit: int,
                     kv_ctx: int, sot_index: int, dt, gelu: str, self_kv_quant: bool,
                     use_rules: bool, timestamps: bool, alpha) -> torch.Tensor:
    """The prompt through the decoder once an utterance, its cache tiled
    to the beams into ``loop.kv``, the top K first tokens of beam 0 and the
    loop state reset around them; returns the no-speech probability."""
    cfg = model.cfg
    B, P = prompt.shape
    K, V, T = loop.k, cfg.n_vocab, cfg.n_text_ctx
    N = B * K
    kv = new_kv_cache(model, B, dt, kv_ctx, quant=self_kv_quant)
    logits, kv = decoder_forward(model, prompt, 0, kv, loop.cross, dt, pad=prompt_pad, gelu=gelu)
    no_speech_prob = torch.softmax(logits[:, sot_index].to(torch.float32),
                                   dim=-1)[:, cfg.no_speech]
    tiled = decode._nested_map(kv, lambda t: t.repeat_interleave(K, dim=1))
    if loop.kv is None:
        loop.kv = tiled
    else:  # every rank's and data row's cache, in place
        for dst, src in zip(decode._nested_leaves(loop.kv), decode._nested_leaves(tiled)):
            dst.copy_(src)
    if loop.spare is None:
        loop.spare = decode._nested_map(loop.kv, torch.empty_like)
    loop.tokens.fill_(cfg.eot)
    loop.tokens[:, :P] = prompt.repeat_interleave(K, dim=0)
    rs = RuleState.create(N, device=prompt.device)
    lp0 = torch.log_softmax(decode._filter(logits[:, -1].repeat_interleave(K, dim=0), rs, loop,
                                           cfg, use_rules, timestamps).to(torch.float32), dim=-1)
    beam0 = (loop.beams % K == 0)[:, None]
    scores, flat_idx = _top_k(torch.where(beam0, lp0, loop.neg).reshape(B, K * V), K)
    first = flat_idx % V
    loop.tokens[:, P] = first.reshape(N)
    for state, v in zip(loop.rs, rs.advance(first.reshape(N), cfg.timestamp_begin)):
        state.copy_(v)
    # a beam that opened with eot is finished at once
    opened = first == cfg.eot
    loop.fin_scores.copy_(torch.where(opened, _norm_score(scores, torch.ones_like(scores), alpha),
                                      loop.neg))
    loop.fin_tokens.copy_(loop.tokens.reshape(B, K, T))
    loop.fin_lens.fill_(P)
    loop.scores.copy_(torch.where(opened, loop.neg, scores))
    loop.n_gen.fill_(1)
    loop.pos.fill_(P)
    loop.last.fill_(limit - 1)
    loop.p0.fill_(P)
    return no_speech_prob


def _beam_round(model, loop: _BeamLoop, n_steps: int, dt, gelu: str, use_rules: bool,
                timestamps: bool, alpha) -> None:
    """``n_steps`` beam steps, in place on ``loop``, and its flags for the
    host: no host read. Each step runs JAX's loop body under its ``cond``
    (:func:`_going`); a step where it fails writes nothing (its K/V at the
    current position are never read) and its reorder is the identity. The
    steps read ``loop.kv`` and ``loop.spare`` in turns; the round ends
    with the cache in ``loop.kv``."""
    cfg = model.cfg
    eot, ts0, T, V = cfg.eot, cfg.timestamp_begin, cfg.n_text_ctx, cfg.n_vocab
    B, K = loop.scores.shape
    N = B * K
    neg = loop.neg
    kv, spare = loop.kv, loop.spare
    for _ in range(n_steps):
        go = _going(loop)
        cur = torch.gather(loop.tokens, 1, loop.pos[:, None])[:, 0]
        logits, _ = _step_multipos(model, cur, loop.pos, kv, loop.cross, dt, loop.pad, gelu,
                                   "fd", beam_k=K)
        lp = torch.log_softmax(decode._filter(logits, loop.rs, loop, cfg, use_rules, timestamps)
                               .to(torch.float32), dim=-1)  # (N, V)
        cand = loop.scores.reshape(N, 1) + lp
        cand = torch.where((loop.scores.reshape(N) > HALF)[:, None], cand, neg)
        cand2k, idx2k = _top_k(cand.reshape(B, K * V), 2 * K)
        tok2k, src2k = idx2k % V, idx2k // V
        is_eot = tok2k == eot
        ngen_src = torch.gather(loop.n_gen, 1, src2k)
        n_gen2k = ngen_src + 1

        # retire the eot candidates into the finished set (top K of 3K)
        eot_norm = torch.where(is_eot, _norm_score(cand2k, n_gen2k, alpha), neg)
        merged_scores = torch.cat([loop.fin_scores, eot_norm], dim=1)
        cand_tokens = torch.gather(loop.tokens.reshape(B, K, T), 1,
                                   src2k[..., None].expand(B, 2 * K, T))
        merged_tokens = torch.cat([loop.fin_tokens, cand_tokens], dim=1)
        merged_lens = torch.cat([loop.fin_lens, loop.p0 + ngen_src], dim=1)
        fin_scores, fin_idx = _top_k(merged_scores, K)
        fin_tokens = torch.gather(merged_tokens, 1, fin_idx[..., None].expand(B, K, T))
        fin_lens = torch.gather(merged_lens, 1, fin_idx)

        # keep the top K non-eot candidates running
        scores, pick = _top_k(torch.where(is_eot, neg, cand2k), K)
        new_tok = torch.gather(tok2k, 1, pick).reshape(N)
        n_gen = torch.gather(n_gen2k, 1, pick)
        flat = torch.where(go, (loop.base + torch.gather(src2k, 1, pick)).reshape(N), loop.beams)
        tokens = loop.tokens.index_select(0, flat)
        tokens.scatter_(1, torch.clamp(loop.pos + 1, max=T - 1)[:, None], new_tok[:, None])
        rs = RuleState(*(f.index_select(0, flat) for f in loop.rs)).advance(new_tok, ts0)
        _gather_cache(kv, spare, flat)
        kv, spare = spare, kv
        for state, new in ((loop.tokens, tokens), (loop.scores, scores), (loop.n_gen, n_gen),
                           (loop.fin_scores, fin_scores), (loop.fin_tokens, fin_tokens),
                           (loop.fin_lens, fin_lens), *zip(loop.rs, rs)):
            state.copy_(torch.where(go, new, state))
        loop.pos += go
    if kv is not loop.kv:  # an odd number of steps: back into the loop's cache
        _gather_cache(kv, loop.kv, loop.beams)
    loop.flags[0] = _going(loop)
    loop.flags[1] = loop.pos[0]


def _best(loop: _BeamLoop, alpha, eot: int):
    """(tokens, lengths, scores) of every utterance's best hypothesis, as
    new tensors, the token buffer eot after it: an utterance with no
    finished hypothesis falls back to its best running beam, which ran to
    the cap."""
    B, K = loop.scores.shape
    T = loop.tokens.shape[1]
    run_norm = _norm_score(loop.scores, loop.n_gen, alpha)
    no_fin = (loop.fin_scores <= HALF).all(dim=1, keepdim=True)
    rows = torch.arange(B, device=loop.scores.device)
    best_run = torch.argmax(run_norm, dim=1)
    run_tokens = loop.tokens.reshape(B, K, T)[rows, best_run]
    fin_scores = torch.where(no_fin, torch.gather(run_norm, 1, best_run[:, None]),
                             loop.fin_scores)
    best = torch.argmax(fin_scores, dim=1)
    best_tokens = torch.where(no_fin, run_tokens, loop.fin_tokens[rows, best])
    best_lens = torch.where(no_fin[:, 0], loop.pos[0] + 1,
                            torch.gather(loop.fin_lens, 1, best[:, None])[:, 0])
    best_scores = torch.gather(fin_scores, 1, best[:, None])[:, 0]
    pos = torch.arange(T, device=rows.device)[None, :]
    best_tokens = torch.where(pos >= best_lens[:, None], torch.full_like(best_tokens, eot),
                              best_tokens)
    return best_tokens, best_lens, best_scores


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
    budget; no step writes past it. The loop runs in rounds of
    ``decode.ROUND_STEPS`` steps, each a CUDA graph where
    ``decode.capturable(model, device)`` holds: the caller's cross-KV, pads
    and suppress ids are copied into the graph's own buffers and the
    results are new tensors."""
    return _beam_rounds(model, cross_kv, prompt, compute_dtype, beam_size, max_tokens,
                        suppress_ids, timestamps, apply_filters, length_penalty, prompt_pad,
                        sot_index, self_kv_quant, gelu, capturable(model, prompt.device))


def _beam_rounds(model, cross_kv, prompt, compute_dtype, beam_size, max_tokens, suppress_ids,
                 timestamps, apply_filters, length_penalty, prompt_pad, sot_index,
                 self_kv_quant, gelu, graphed: bool) -> BeamResult:
    """:func:`beam_search_kv` (its arguments in order) with the capture
    chosen by the caller: ``graphed`` replays each round as a CUDA graph,
    else the same round runs eagerly. The card's checks hold the one
    against the other."""
    cfg = model.cfg
    device = prompt.device
    B, P = prompt.shape
    K = beam_size
    T = cfg.n_text_ctx
    if P >= T:
        raise ValueError(f"prompt of {P} tokens leaves no room in n_text_ctx={T}")
    limit = min(T, P + max_tokens) if max_tokens else T
    kv_ctx = min(T, -(-limit // 128) * 128)
    use_rules = apply_filters or timestamps or suppress_ids is not None
    prompt = prompt.to(torch.int64)
    if prompt_pad is not None:
        prompt_pad = prompt_pad.to(device=device, dtype=torch.int64)
    R = decode.ROUND_STEPS
    opts = (compute_dtype, gelu, use_rules, timestamps, length_penalty)

    def drive(loop: _BeamLoop, run_round) -> BeamResult:
        no_speech_prob = _first_expansion(model, loop, prompt, prompt_pad, limit, kv_ctx,
                                          sot_index, compute_dtype, gelu, self_kv_quant,
                                          use_rules, timestamps, length_penalty)
        i, rounds = P, 0
        while i < limit - 1:
            run_round()
            rounds += 1
            going, i = loop.flags.tolist()
            if not going:
                break
        best_tokens, best_lens, best_scores = _best(loop, length_penalty, cfg.eot)
        return BeamResult(tokens=best_tokens, lengths=best_lens, scores=best_scores,
                          all_tokens=loop.fin_tokens.clone(), all_scores=loop.fin_scores.clone(),
                          no_speech_prob=no_speech_prob, avg_logprob=best_scores,
                          steps=i - P, host_syncs=rounds, device_steps=rounds * R)

    if not graphed:
        loop = _BeamLoop(B, K, T, device)
        loop.cross, loop.suppress = cross_kv, suppress_ids
        loop.pad = None if prompt_pad is None else prompt_pad.repeat_interleave(K)
        return drive(loop, lambda: _beam_round(model, loop, R, *opts))
    owner = decode._decode_graphs(model)
    with owner.lock:
        key = ("beam", K) + decode._shape_key(B, cross_kv, prompt_pad, suppress_ids, kv_ctx,
                                             compute_dtype, self_kv_quant)
        loop = decode._loop_buffers(
            owner, key, lambda: _BeamLoop(B, K, T, device, new_kv_cache(
                model, B * K, compute_dtype, kv_ctx, quant=self_kv_quant)),
            cross_kv, None if prompt_pad is None else prompt_pad.repeat_interleave(K),
            suppress_ids)
        round_fn = functools.partial(_beam_round, model, loop, R, *opts)
        return drive(loop, lambda: owner.graphs.run(key + (R, *opts), round_fn))


def beam_search(model, mel: torch.Tensor, prompt: torch.Tensor, compute_dtype=torch.float32,
                kv_quant: bool = False, w8a8: bool = False, gelu: str = "erf",
                encoder_attention: str = "btd", **kw) -> BeamResult:
    """Encoder + beam loop (:func:`~whisper_tpu_torch.decode.encode_cross_kv`
    then :func:`beam_search_kv`, which takes the remaining keywords)."""
    cross_kv = encode_cross_kv(model, mel, compute_dtype, kv_quant=kv_quant, w8a8=w8a8,
                               gelu=gelu, encoder_attention=encoder_attention)
    return beam_search_kv(model, cross_kv, prompt, compute_dtype, gelu=gelu, **kw)
