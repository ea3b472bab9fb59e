"""Batched greedy and sampled decoding, and language detection.

Port of ``whisper_tpu/decode.py``. The JAX package runs prefill and the whole
token loop as one jitted ``lax.while_loop``. Here one
:func:`decoder_forward` prefill over the prompt is followed by rounds of
``ROUND_STEPS`` S=1 steps (:func:`decoder_step_multipos` at a position held
on the device, the rules of ``sampling.apply_rules``, log_softmax and
argmax; at ``temperature > 0``, a categorical draw against noise the host
put in a buffer before the round), none of which reads the device from the
host: the host reads the all-done flag once a round, and those reads are
counted in the result. On the card a round of a single-device model is a
CUDA graph (``utils.graphs``), captured once per shape and temperature and
replayed, as the JAX loop is compiled once per shape and static
temperature. ``beam.beam_search_kv`` runs its loop the same way. Every
function takes a sharded model (``parallel.sharding.shard_params``, on a
mesh of any (data, model) shape) wherever it takes a ``Whisper``: under
data rows the model functions split each step's batch over the rows, and
the loop reads one flag for them all. A mesh whose every rank lies on the
card replays its rounds as graphs too (one graph holds every rank's
launches, as one jitted program holds every shard's under the JAX
package's SPMD partitioner); a mesh over distinct cards runs them
uncaptured.
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from .models.model import (
    DataParallelWhisper,
    DataRows,
    QKVCache,
    ShardedWhisper,
    Shards,
    Whisper,
    compute_cross_kv,
    decoder_forward,
    decoder_step_multipos,
    encoder_forward,
    model_shards,
    new_kv_cache,
    quantize_cross_kv,
    shard_values,
)
from .ops.quant import QTensor
from .sampling import RuleState, apply_rules
from .utils.graphs import GraphSet


ROUND_STEPS = 8  # S=1 steps a round: one graph replay and one host read of the loop's flags
# the captured loops' buffer sets a model keeps, the least recently used
# dropped first: a batch's main decode and the five rungs of its
# temperature ladder, each rung re-decoding only the rows that failed the
# one before (a smaller batch, a shape of its own), so the next batch's
# main decode still finds its loop. Each holds a copy of its batch's
# cross-KV (983 MB at turbo B64, int8; a rung's rows' share of that).
LOOP_SHAPES = 6


class GreedyResult(NamedTuple):
    tokens: torch.Tensor          # (B, n_text_ctx) int64, prompt included, eot-padded
    lengths: torch.Tensor         # (B,) index of the first eot after the prompt
    no_speech_prob: torch.Tensor  # (B,) fp32: P(<|nospeech|>) at the sot position
    avg_logprob: torch.Tensor     # (B,) fp32: mean logprob of sampled tokens (incl. eot)
    steps: int = 0                # the loop's trip count: S=1 steps run after the prefill
    host_syncs: int = 0           # device->host reads of the loop's flags: one a round
    # S=1 steps the device ran: whole rounds, masked steps included (each
    # launches the step's kernels)
    device_steps: int = 0


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

    def into(step: int, out: torch.Tensor) -> None:
        """``draw(step, out.shape)`` written in place into ``out``: the same
        values, with no tensor of its own to copy."""
        torch.rand(out.shape, generator=gen, out=out)
        out.clamp_(min=tiny).log_().neg_().log_().neg_()

    draw.into = into
    return draw


def _indexed(device) -> torch.device:
    """``device`` with its index filled in: ``cuda`` is the current card
    (card 0 where torch sees none), which a tensor's device never omits."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device()
                            if torch.cuda.is_available() else 0)
    return device


def _ranks(model) -> tuple:
    """Every rank of ``model``: each data row's shards in row order, a
    ``ShardedWhisper``'s shards, or the ``Whisper`` itself."""
    if isinstance(model, DataParallelWhisper):
        return tuple(s for row in model.rows for s in model_shards(row))
    return model_shards(model)


def capturable(model, device) -> bool:
    """Whether a decode loop's rounds (greedy, sampled at any
    ``temperature``, beam or speculative) run as CUDA graphs on
    ``device``: on the card, for a single-device ``Whisper``, and for a
    ``ShardedWhisper`` or ``DataParallelWhisper`` whose every rank lies on
    that card (one side stream and one pool hold every rank's launches).
    A mesh over distinct cards, and anything on the CPU, runs the same
    rounds uncaptured. A sampled round reads its draws from a buffer the
    host fills before it, so the temperature does not decide."""
    device = _indexed(device)
    if device.type != "cuda":
        return False
    if isinstance(model, Whisper):
        return True
    return (isinstance(model, (ShardedWhisper, DataParallelWhisper))
            and all(_indexed(r.device) == device for r in _ranks(model)))


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

    The loop runs in rounds of ``ROUND_STEPS`` S=1 steps
    (:func:`decoder_step_multipos` at a (B,) position tensor, the rules,
    log_softmax and the token choice), which never read the device from
    the host; a step once every stream is done, or past ``limit - 1``,
    writes and counts nothing. The host reads the all-done flag and the
    step count once a round. On the card, for a single-device ``Whisper``,
    each round is a CUDA graph (``utils.graphs``), captured once per shape
    and temperature and replayed: the caller's cross-KV, pads and suppress
    ids are copied into the graph's own buffers, the prefill runs eagerly
    into its self-KV cache, and the returned tokens are a copy. A
    ``ShardedWhisper`` or ``DataParallelWhisper`` whose ranks all lie on
    the card is captured the same way (:func:`capturable`); on the CPU and
    for a mesh over distinct cards the same round runs uncaptured.

    At ``temperature > 0`` each token is a categorical draw from the
    filtered distribution at that temperature, as ``jax.random.categorical``
    draws it: ``argmax(log_softmax(logits) / T + g)`` with standard Gumbel
    noise ``g``; its logprob (``avg_logprob``) is read from the unscaled
    distribution, as in JAX. ``noise(step, shape)`` supplies the draws of
    step 0 (the token after the prefill), 1, ... (tests hand in the JAX
    package's own, drawn from ``PRNGKey(seed)`` with its key splits);
    without it the draws come from :func:`gumbel_noise` of ``seed`` on the
    logits' device. Before each round the host asks the hook for that
    round's steps, in order, into the loop's noise buffer (ROUND_STEPS, B,
    V); a step past the loop's most steps (the masked tail of the last
    round) draws nothing and reads a row of zeros.
    ``timestamps`` runs the timestamp grammar of ``sampling.apply_rules``.
    ``prompt_pad`` right-aligns prompts of differing lengths (e.g.
    ``[sot_prev, *prev, sot, lang, task]``): the first ``prompt_pad[b]``
    positions of row b are masked out of attention and skipped in its
    positional indexing, at the prefill and at every step. ``sot_index`` is
    the column of sot, where the no-speech probability is read.
    ``cross_decode`` selects the step's int8 cross-attention kernel
    (:func:`~whisper_tpu_torch.models.model.decoder_forward`).
    """
    graphed = capturable(model, prompt.device)
    return _greedy_rounds(model, cross_kv, prompt, compute_dtype, max_tokens, suppress_ids,
                          apply_filters, self_kv_quant, gelu, timestamps, prompt_pad,
                          sot_index, cross_decode, temperature, seed, noise, graphed)


class _Loop:
    """The token loop's device state, written in place by the prefill and
    by every round: all that a captured round reads or writes besides the
    weights. ``cross``, ``pad`` and ``suppress`` are the caller's tensors in
    an uncaptured loop and the graph's own copies in a captured one."""

    def __init__(self, model, batch: int, kv_ctx: int, dtype, self_kv_quant: bool, device):
        i64 = dict(dtype=torch.int64, device=device)
        self.kv = new_kv_cache(model, batch, dtype, kv_ctx, quant=self_kv_quant)
        self.tokens = torch.empty((batch, model.cfg.n_text_ctx), **i64)
        self.pos = torch.empty((batch,), **i64)   # every row's current token position
        self.last = torch.empty((batch,), **i64)  # limit - 1: where the loop stops
        self.done = torch.empty((batch,), dtype=torch.bool, device=device)
        self.rs = RuleState.create(batch, device=device)
        self.sum_lp = torch.empty((batch,), dtype=torch.float32, device=device)
        self.n_lp = torch.empty((batch,), dtype=torch.float32, device=device)
        self.steps = torch.empty((), **i64)
        self.flags = torch.empty((2,), **i64)  # [all done, steps]: read once a round
        self.noise = None  # a sampled round's draws, (ROUND_STEPS, B, V) fp32: _fill_noise
        self.cross = self.pad = self.suppress = None


def _filter(logits, rs, loop: _Loop, cfg, use_rules: bool, timestamps: bool):
    if not use_rules:
        return logits
    return apply_rules(logits, rs, cfg, suppress_ids=loop.suppress, timestamps=timestamps)


def _sample(logits_f, temperature: float, gumbel: Optional[torch.Tensor]):
    """(token, its logprob): argmax of the log-probabilities, or at
    ``temperature > 0`` of them over T plus the draws ``gumbel``."""
    lp = torch.log_softmax(logits_f.to(torch.float32), dim=-1)
    if temperature and temperature > 0:
        # a tensor divisor, so the card divides as the CPU does
        tok = torch.argmax(lp / lp.new_full((), temperature) + gumbel, dim=-1)
    else:
        tok = torch.argmax(lp, dim=-1)
    return tok, torch.gather(lp, 1, tok[:, None])[:, 0]


def _prefill(model, loop: _Loop, prompt: torch.Tensor, limit: int, sot_index: int, dt, gelu,
             cross_decode, use_rules, timestamps, temperature, noise) -> torch.Tensor:
    """The prompt through the decoder into ``loop.kv``, the first token and
    the loop state reset around it; returns the no-speech probability."""
    cfg = model.cfg
    B, P = prompt.shape
    loop.tokens.fill_(cfg.eot)
    loop.tokens[:, :P] = prompt
    logits, _ = decoder_forward(model, prompt, 0, loop.kv, loop.cross, dt, pad=loop.pad,
                                gelu=gelu, cross_decode=cross_decode)
    no_speech_prob = torch.softmax(logits[:, sot_index], dim=-1)[:, cfg.no_speech]
    rs = RuleState.create(B, device=prompt.device)
    last = logits[:, -1]
    first, first_lp = _sample(_filter(last, rs, loop, cfg, use_rules, timestamps), temperature,
                              noise(0, tuple(last.shape)) if noise is not None else None)
    for state, v in zip(loop.rs, rs.advance(first, cfg.timestamp_begin)):
        state.copy_(v)
    loop.tokens[:, P] = first
    loop.done.copy_(first == cfg.eot)
    loop.sum_lp.copy_(first_lp)
    loop.n_lp.fill_(1.0)
    loop.pos.fill_(P)
    loop.last.fill_(limit - 1)
    loop.steps.zero_()
    return no_speech_prob


def _fill_noise(loop: _Loop, noise, step0: int, draws: int) -> None:
    """A sampled round's draws, on the host and outside any capture: row j
    of ``loop.noise`` takes ``noise(step0 + j + 1, (B, V))`` up to step
    ``draws``, the loop's most steps, in order, once each; the rows past
    it are zeros (their steps are masked and write nothing). The port's
    own :func:`gumbel_noise` draws straight into the row."""
    n = max(0, min(loop.noise.shape[0], draws - step0))
    shape = tuple(loop.noise.shape[1:])
    into = getattr(noise, "into", None)
    for j in range(n):
        if into is not None:
            into(step0 + j + 1, loop.noise[j])
        else:
            loop.noise[j].copy_(noise(step0 + j + 1, shape))
    loop.noise[n:].zero_()


def _decode_round(model, loop: _Loop, n_steps: int, dt, gelu, cross_decode, use_rules,
                  timestamps, temperature: float = 0.0) -> None:
    """``n_steps`` S=1 steps of the token loop, in place on ``loop``, and
    its flags for the host: no host read. A step runs while its position
    is below ``loop.last`` and some stream is live (``go``); any other step
    writes and counts nothing (its K/V rewrite the current position's
    own). At ``temperature > 0`` step j of the round samples against row j
    of ``loop.noise`` (:func:`_fill_noise`)."""
    cfg = model.cfg
    eot, ts0, T = cfg.eot, cfg.timestamp_begin, cfg.n_text_ctx
    for j in range(n_steps):
        go = (loop.pos < loop.last) & ~loop.done.all()
        cur = torch.gather(loop.tokens, 1, loop.pos[:, None])[:, 0]
        logits, _ = decoder_step_multipos(model, cur, loop.pos, loop.kv, loop.cross, dt,
                                          pads=loop.pad, gelu=gelu, cross_decode=cross_decode)
        nxt, lp = _sample(_filter(logits, loop.rs, loop, cfg, use_rules, timestamps),
                          temperature, loop.noise[j] if temperature > 0 else None)
        nxt = torch.where(loop.done, torch.full_like(nxt, eot), nxt)
        alive = go & ~loop.done
        loop.sum_lp += torch.where(alive, lp, torch.zeros_like(lp))
        loop.n_lp += alive.to(torch.float32)
        loop.done |= go & (nxt == eot)
        at = torch.clamp(loop.pos + 1, max=T - 1)[:, None]
        loop.tokens.scatter_(1, at, torch.where(go[:, None], nxt[:, None],
                                                torch.gather(loop.tokens, 1, at)))
        if use_rules:
            new = [torch.where(go, n, o) for n, o in zip(loop.rs.advance(nxt, ts0), loop.rs)]
            for state, v in zip(loop.rs, new):
                state.copy_(v)
        loop.steps += go[0]
        loop.pos += go
    loop.flags[0] = loop.done.all()
    loop.flags[1] = loop.steps


class _DecodeGraphs:
    """A model's captured rounds, greedy, sampled, beam and speculative
    alike: the loops' buffers by shape (the ``LOOP_SHAPES`` latest of any
    kind, least recent first), their graphs by key in one
    :class:`~whisper_tpu_torch.utils.graphs.GraphSet` (one pool), and the
    decoder weights' pointers they were captured against (a speculative
    loop's key holds its draft's). ``lock``
    serializes the loops of one model across threads (the engine's aux
    worker and a pipeline may share it)."""

    def __init__(self, device, weights: tuple):
        self.graphs = GraphSet(device)
        self.loops = {}
        self.weights = weights
        self.lock = threading.Lock()


# a Whisper, ShardedWhisper or DataParallelWhisper -> its _DecodeGraphs
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_GRAPHS_LOCK = threading.Lock()


def _decoder_pointers(model) -> tuple:
    """Where every decoder weight of every rank lies: a graph reads them
    there."""
    leaves = []
    for rank in _ranks(model):
        dec = rank.decoder
        leaves += [dec.tok_emb, dec.pos_emb, dec.tok_emb_q8, *dec.ln.values()]
        for blk in dec.blocks:
            for d in blk.sublayers().values():
                leaves.extend(d.values())
    ptrs = []
    for t in leaves:
        if isinstance(t, QTensor):
            ptrs += [t.q.data_ptr(), t.s.data_ptr()]
        elif t is not None:
            ptrs.append(t.data_ptr())
    return tuple(ptrs)


def _decode_graphs(model) -> _DecodeGraphs:
    """``model``'s captured rounds (one set for a whole mesh, in one pool on
    its card); all dropped when a decoder weight of any rank moved
    (``cast_floating`` and ``to_device`` rebind them)."""
    weights = _decoder_pointers(model)
    with _GRAPHS_LOCK:
        owner = _GRAPHS.get(model)
        if owner is None or owner.weights != weights:
            owner = _GRAPHS[model] = _DecodeGraphs(model.device, weights)
    return owner


def graph_stats(model) -> Optional[dict]:
    """The captured rounds of ``model``'s greedy, sampled, beam and
    speculative decodes (keys, replays, capture seconds per key, the pool's
    bytes), or None before the first."""
    owner = _GRAPHS.get(model)
    return None if owner is None else owner.graphs.stats()


def _nested_leaves(x) -> list:
    """The tensors of a (possibly nested) value in order: a cross-KV or a
    cache, flat or as :class:`Shards` / :class:`DataRows` of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for c in x for t in _nested_leaves(c)]


def _nested_map(x, fn):
    """``fn`` on every tensor of a (possibly nested) value, into a value of
    the same structure: its ``Shards`` / ``DataRows`` (which the model
    functions dispatch on), caches and tuples kept."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    items = [_nested_map(c, fn) for c in x]
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


def _structure(x) -> tuple:
    """What buffers of ``x``'s structure are shaped by: its nesting and its
    leaves' shapes and dtypes."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    return (type(x).__name__, tuple(_structure(c) for c in x))


def _shape_key(batch: int, cross_kv, prompt_pad, suppress_ids, kv_ctx: int, dt,
               self_kv_quant: bool) -> tuple:
    """What a captured loop's buffers are shaped by, besides its kind:
    ``batch`` first, and the cross-KV's whole structure (every rank's and
    data row's leaves under a mesh)."""
    return (batch, kv_ctx, dt, self_kv_quant, _structure(cross_kv), prompt_pad is not None,
            None if suppress_ids is None else suppress_ids.numel())


def _loop_buffers(owner: _DecodeGraphs, key: tuple, make: Callable, cross_kv, pad,
                  suppress_ids):
    """The captured loop of ``key`` (``make()`` at its first use), loaded
    with the call's cross-KV (of any nesting, kept as it is), pads (one a
    stream) and suppress ids copied into its own buffers. A new shape
    beyond ``LOOP_SHAPES`` drops the least recent one and its graphs."""
    loop = owner.loops.pop(key, None)
    if loop is None:
        if len(owner.loops) >= LOOP_SHAPES:
            old = next(iter(owner.loops))
            del owner.loops[old]
            owner.graphs.forget(lambda k: k[:len(old)] == old)
        loop = make()
        loop.cross = _nested_map(cross_kv, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                                  device=t.device))
        if pad is not None:
            loop.pad = torch.empty(pad.shape, dtype=torch.int64, device=pad.device)
        if suppress_ids is not None:
            loop.suppress = torch.empty((suppress_ids.numel(),), dtype=torch.int64,
                                        device=suppress_ids.device)
    owner.loops[key] = loop  # the most recent last
    for dst, src in zip(_nested_leaves(loop.cross), _nested_leaves(cross_kv)):
        dst.copy_(src)
    if pad is not None:
        loop.pad.copy_(pad)
    if suppress_ids is not None:
        loop.suppress.copy_(suppress_ids.reshape(-1))
    return loop


def _static_loop(owner: _DecodeGraphs, model, batch: int, cross_kv, prompt_pad, suppress_ids,
                 kv_ctx: int, dt, self_kv_quant: bool) -> Tuple[_Loop, tuple]:
    """The captured greedy loop's buffers for this shape, loaded with the
    call's inputs, its self-KV cache as a new one's."""
    key = _shape_key(batch, cross_kv, prompt_pad, suppress_ids, kv_ctx, dt, self_kv_quant)
    loop = _loop_buffers(owner, key, lambda: _Loop(model, batch, kv_ctx, dt, self_kv_quant,
                                                  model.device),
                         cross_kv, prompt_pad, suppress_ids)
    _reset_cache(loop.kv)
    return loop, key


def _reset_cache(kv) -> None:
    """A captured loop's self-KV cache, in place, as a new one's: zeros (an
    int8 cache's scales ones), every rank's and data row's under a mesh."""
    if isinstance(kv, (Shards, DataRows)):
        for c in kv:
            _reset_cache(c)
        return
    kv[0].zero_()
    if isinstance(kv, QKVCache):
        kv.s.fill_(1.0)
    else:
        kv[1].zero_()


def _greedy_rounds(model, cross_kv, prompt, compute_dtype, max_tokens, suppress_ids,
                   apply_filters, self_kv_quant, gelu, timestamps, prompt_pad, sot_index,
                   cross_decode, temperature, seed, noise, graphed: bool) -> GreedyResult:
    """:func:`greedy_decode_kv` (its arguments in order) with the capture
    chosen by the caller: ``graphed`` replays each round as a CUDA graph,
    else the same round runs eagerly. The card's checks hold the one
    against the other."""
    cfg = model.cfg
    device = prompt.device
    B, P = prompt.shape
    T = cfg.n_text_ctx
    if P >= T:
        raise ValueError(f"prompt of {P} tokens leaves no room in n_text_ctx={T}")
    limit = min(T, P + max_tokens) if max_tokens else T
    kv_ctx = min(T, -(-limit // 128) * 128)
    use_rules = apply_filters or timestamps or suppress_ids is not None
    stochastic = bool(temperature and temperature > 0)
    if stochastic and noise is None:
        noise = gumbel_noise(seed, device)
    prompt = prompt.to(torch.int64)
    if prompt_pad is not None:
        prompt_pad = prompt_pad.to(device=device, dtype=torch.int64)
    R = ROUND_STEPS
    # the graph's key: one program per static temperature, as JAX jits it
    opts = (compute_dtype, gelu, cross_decode, use_rules, timestamps,
            float(temperature) if stochastic else 0.0)

    def noise_buffer(loop: _Loop) -> bool:
        """Give a sampled loop its round's noise buffer; True if it is new."""
        if not stochastic or (loop.noise is not None and loop.noise.shape[0] == R):
            return False
        loop.noise = torch.empty((R, B, cfg.n_vocab), dtype=torch.float32, device=device)
        return True

    def drive(loop: _Loop, run_round) -> GreedyResult:
        no_speech_prob = _prefill(model, loop, prompt, limit, sot_index, compute_dtype, gelu,
                                  cross_decode, use_rules, timestamps, temperature, noise)
        i, rounds, steps = P, 0, 0
        while i < limit - 1:
            if stochastic:
                _fill_noise(loop, noise, rounds * R, limit - 1 - P)
            run_round()
            rounds += 1
            i += R
            with record_function("whisper.decode.flags"):  # the host waits for the round
                all_done, steps = loop.flags.tolist()
            if all_done:
                break
        tokens = loop.tokens.clone() if graphed else loop.tokens
        pos = torch.arange(T, device=device)[None, :]
        first_eot = torch.where((tokens == cfg.eot) & (pos >= P), pos,
                                torch.full_like(pos, T)).amin(dim=1)
        return GreedyResult(tokens=tokens, lengths=first_eot, no_speech_prob=no_speech_prob,
                            avg_logprob=loop.sum_lp / torch.clamp(loop.n_lp, min=1.0),
                            steps=steps, host_syncs=rounds, device_steps=rounds * R)

    if not graphed:
        loop = _Loop(model, B, kv_ctx, compute_dtype, self_kv_quant, device)
        loop.cross, loop.pad, loop.suppress = cross_kv, prompt_pad, suppress_ids
        noise_buffer(loop)
        return drive(loop, lambda: _decode_round(model, loop, R, *opts))
    owner = _decode_graphs(model)
    with owner.lock:
        loop, key = _static_loop(owner, model, B, cross_kv, prompt_pad, suppress_ids, kv_ctx,
                                 compute_dtype, self_kv_quant)
        if noise_buffer(loop):  # the loop's sampled graphs read the buffer it replaces
            owner.graphs.forget(lambda k: k[:len(key)] == key and k[-1] > 0)
        round_fn = functools.partial(_decode_round, model, loop, R, *opts)
        return drive(loop, lambda: owner.graphs.run(key + (R, *opts), round_fn))


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
