"""Speculative greedy decoding: a cheap draft model proposes, the target
verifies gamma + 1 positions a pass.

Port of ``whisper_tpu/spec_decode.py``. The JAX package runs the whole
accept/reject loop as one jitted ``lax.while_loop``. Here the loop runs in
groups of ``SPEC_ROUNDS`` accept/verify rounds (:func:`_spec_round`) that
never read the device from the host: each round computes JAX's ``cond`` (some
row not done) on the device, and a round after every row is done changes no
result and counts no round. The host reads the all-done flag once a group
(counted in ``host_syncs``). On the card, for a target and a draft whose
ranks all lie on one card (single-device models or meshes), each group is a
CUDA graph (``utils.graphs``) of the target's captured loops, captured once
per shape, draft and gamma and replayed, as the JAX loop is compiled once
per static shape; on the CPU and under a mesh over distinct cards the same
groups run uncaptured. Rows sit at their own offsets
(:func:`~whisper_tpu_torch.models.model.decoder_window_multipos`), so a batch
never waits in lock step on its slowest row's acceptance.

Exactness: at temperature 0 the emitted tokens are the target's own greedy
tokens for any draft. A draft token is kept only when it equals the target's
argmax after the same validated prefix; at the first mismatch the target's
argmax (the bonus token) is emitted instead. The draft moves only the
acceptance rate. The verify window sums its products in another order than
the 1-wide greedy step, so an argmax can flip on a numerical tie.

KV bookkeeping, with no rollback copies: both caches hold every validated
token but the last. A rejected draft leaves stale K/V past the validated
frontier; the causal mask (key <= query) hides it, and the next round's
window, which starts at the frontier, overwrites it. A masked round writes
K/V only there too.

Each round runs the draft's width-2 feed at ``off - 2`` (it repairs the hole
a fully accepted round leaves: the last accepted proposal was never fed),
``gamma - 1`` 1-wide draft steps through
:func:`~whisper_tpu_torch.models.model.decoder_step_multipos` (the
self-attention kernel and, with the int8 cross-KV, the ``cross_decode``
kernel once a draft layer), and one target window of ``gamma + 1`` at
``off - 1``; the windows and both prefills are plain products, as in JAX.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.profiler import record_function

from .decode import (
    _decode_graphs,
    _decoder_pointers,
    _loop_buffers,
    _reset_cache,
    _shape_key,
    capturable,
)
from .models.model import (
    _window_targets,
    decoder_forward,
    decoder_step_multipos,
    decoder_window_multipos,
    new_kv_cache,
)

# accept/verify rounds a group: one graph replay and one host read of the
# loop's flags. Picked on the card among 1, 2 and 4 by the spec decode's
# wall (PERF.md): a flag read between replays costs less than the masked
# rounds a longer last group runs, the more so as acceptance rises.
SPEC_ROUNDS = 1


class SpecResult(NamedTuple):
    tokens: torch.Tensor          # (B, n_text_ctx) int64, prompt included, eot-padded
    lengths: torch.Tensor         # (B,) index of the first eot after the prompt
    no_speech_prob: torch.Tensor  # (B,) fp32: P(<|nospeech|>) at sot (target prefill)
    avg_logprob: torch.Tensor     # (B,) fp32: mean TARGET logprob of the emitted tokens
    accepted: torch.Tensor        # () int64: draft tokens accepted (all rows)
    drafted: torch.Tensor         # () int64: draft tokens proposed (live rows)
    rounds: int = 0               # verify rounds run while a row was live (JAX's count)
    host_syncs: int = 0           # device->host reads of the loop's flags: one a group
    # rounds the device ran: whole groups, masked rounds included (each
    # launches the draft steps' kernels)
    device_rounds: int = 0


class _SpecLoop:
    """The speculative loop's device state, written in place by the
    prefills and by every group of rounds: all that a captured group reads
    or writes besides both models' weights. ``cross_t`` and ``cross_d`` are
    the caller's cross-KVs of target and draft in an uncaptured loop, and
    in a captured one the graph's own copies (``cross``, the pair of
    them, each nested as the caller's)."""

    def __init__(self, model, draft, batch: int, kv_ctx: int, gamma: int, dtype,
                 self_kv_quant: bool, device):
        i64 = dict(dtype=torch.int64, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.kv_t = new_kv_cache(model, batch, dtype, kv_ctx, quant=self_kv_quant)
        self.kv_d = new_kv_cache(draft, batch, dtype, kv_ctx, quant=self_kv_quant)
        self.tokens = torch.empty((batch, model.cfg.n_text_ctx), **i64)
        self.off = torch.empty((batch,), **i64)  # every row's validated token count
        self.limit = torch.empty((), **i64)      # min(T, P + max_tokens)
        self.done = torch.empty((batch,), dtype=torch.bool, device=device)
        self.sum_lp = torch.empty((batch,), **f32)
        self.n_lp = torch.empty((batch,), **f32)
        self.stats = torch.empty((3,), **i64)  # accepted, drafted, live rounds
        self.flags = torch.empty((2,), **i64)  # [all done, live rounds]: read once a group
        self.rows = torch.arange(batch, device=device)
        self.jar = torch.arange(gamma + 1, device=device)
        self.cross = self.cross_t = self.cross_d = None


def _prefills(model, draft, loop: _SpecLoop, prompt: torch.Tensor, limit: int,
              sot_index: int, dt, gelu: str, cross_decode: str) -> torch.Tensor:
    """Both prefills into the loop's caches (the draft's logits are
    discarded: its cache now holds the prompt, which is all the invariant
    needs), the target's first token and the loop state reset around it;
    returns the no-speech probability."""
    cfg = model.cfg
    B, P = prompt.shape
    loop.tokens.fill_(cfg.eot)
    loop.tokens[:, :P] = prompt
    logits_t, _ = decoder_forward(model, prompt, 0, loop.kv_t, loop.cross_t, dt, gelu=gelu,
                                  cross_decode=cross_decode)
    decoder_forward(draft, prompt, 0, loop.kv_d, loop.cross_d, dt, gelu=gelu,
                    cross_decode=cross_decode)
    no_speech_prob = torch.softmax(logits_t[:, sot_index], dim=-1)[:, cfg.no_speech]
    lp0 = torch.log_softmax(logits_t[:, -1].to(torch.float32), dim=-1)
    first = torch.argmax(lp0, dim=-1)
    loop.sum_lp.copy_(torch.gather(lp0, 1, first[:, None])[:, 0])
    loop.n_lp.fill_(1.0)
    loop.tokens[:, P] = first
    loop.off.fill_(P + 1)
    loop.limit.fill_(limit)
    loop.done.copy_((first == cfg.eot) | (loop.off >= limit))
    loop.stats.zero_()
    return no_speech_prob


def _spec_round(model, draft, loop: _SpecLoop, n_rounds: int, gamma: int, dt, gelu: str,
                cross_decode: str) -> None:
    """``n_rounds`` accept/verify rounds, in place on ``loop``, and its
    flags for the host: no host read. A row that is done emits nothing
    (``n_new`` 0), so a round after every row is done moves no token,
    offset, log-prob or count; only a round with a live row counts in
    ``stats[2]`` (JAX's ``cond``)."""
    cfg = model.cfg
    T, eot, W = cfg.n_text_ctx, cfg.eot, gamma + 1
    rows, jar = loop.rows, loop.jar
    for _ in range(n_rounds):
        off, done = loop.off, loop.done
        alive = ~done
        # ---- draft: the width-2 feed over the last two validated tokens,
        # then gamma - 1 one-wide steps
        y0 = torch.stack([loop.tokens[rows, torch.clamp(off - 2, min=0)],
                          loop.tokens[rows, off - 1]], 1)
        dlog0, _ = decoder_window_multipos(draft, y0, off - 2, loop.kv_d, loop.cross_d, dt,
                                           gelu=gelu)
        cur = torch.argmax(dlog0[:, 1], dim=-1)
        g = [cur]
        for j in range(1, gamma):
            dlogits, _ = decoder_step_multipos(draft, cur, off - 1 + j, loop.kv_d, loop.cross_d,
                                               dt, gelu=gelu, cross_decode=cross_decode)
            cur = torch.argmax(dlogits, dim=-1)
            g.append(cur)
        g = torch.stack(g, dim=1)  # (B, gamma)

        # ---- verify: one target window of gamma + 1 from the frontier
        y = torch.cat([loop.tokens[rows, off - 1][:, None], g], dim=1)
        vlogits, _ = decoder_window_multipos(model, y, off - 1, loop.kv_t, loop.cross_t, dt,
                                             gelu=gelu)
        vlp = torch.log_softmax(vlogits.to(torch.float32), dim=-1)
        t = torch.argmax(vlp, dim=-1)  # (B, W)
        t_lp = torch.gather(vlp, 2, t[..., None])[..., 0]

        # draft token j + 1 survives iff it equals the target's argmax t_j;
        # the row emits t[:, :a + 1], cut at its first eot and its budget
        a = torch.cumprod((g == t[:, :gamma]).to(torch.int64), dim=1).sum(dim=1)
        is_eot = t == eot
        first_eot = torch.where(is_eot, jar[None, :], torch.full_like(t, W)).amin(dim=1)
        n_new = torch.minimum(torch.minimum(a + 1, first_eot + 1), loop.limit - off)
        n_new = torch.where(done, torch.zeros_like(n_new), n_new)

        # the emitted tokens (all inside the context) are written; the other
        # entries are dropped, written back where no two entries meet
        valid = jar[None, :] < n_new[:, None]  # (B, W)
        at, _ = _window_targets(off[:, None] + jar[None, :], T)
        loop.tokens.scatter_(1, at, torch.where(valid, t, loop.tokens.gather(1, at)))

        loop.stats += torch.stack([
            torch.where(alive, torch.minimum(a, n_new), torch.zeros_like(a)).sum(),
            alive.sum() * gamma, alive.any().to(torch.int64)])
        loop.sum_lp += torch.where(valid, t_lp, torch.zeros_like(t_lp)).sum(dim=1)
        loop.n_lp += n_new.to(torch.float32)
        loop.off += n_new
        loop.done |= (valid & is_eot).any(dim=1) | (loop.off >= loop.limit)
    loop.flags[0] = loop.done.all()
    loop.flags[1] = loop.stats[2]


def speculative_decode_kv(
    model,
    cross_kv,
    draft,
    draft_cross_kv,
    prompt: torch.Tensor,  # (B, P) int64, shared vocabulary
    gamma: int = 4,
    compute_dtype=torch.float32,
    max_tokens=None,
    self_kv_quant: bool = False,
    sot_index: int = 0,
    gelu: str = "erf",
    cross_decode: str = "fd",
) -> SpecResult:
    """Greedy speculative decode against precomputed cross-KV of both models
    (one encoder pass each), as the JAX ``speculative_decode_kv``: both
    caches sized ``min(n_text_ctx, ceil128(limit + gamma))``, so no window
    write below the context's end is dropped; the first token is the target
    prefill's argmax; no suppression rules (greedy argmax only).
    ``cross_decode`` selects the draft steps' int8 cross-attention kernel.

    The rounds run in groups of ``SPEC_ROUNDS``; on the card, where target
    and draft lie on one card and are both capturable there
    (``decode.capturable``: single-device models, or meshes whose ranks
    all lie on the card), each group is a CUDA graph kept with the
    target's captured loops
    (``decode.graph_stats``), keyed by the draft's decoder-weight pointers
    (every rank's) among the rest: the callers' cross-KVs are copied into
    the graph's own buffers, both prefills run eagerly into its caches and
    the results are new tensors."""
    graphed = (capturable(model, prompt.device) and capturable(draft, prompt.device)
               and draft.device == model.device)
    return _spec_rounds(model, cross_kv, draft, draft_cross_kv, prompt, gamma, compute_dtype,
                        max_tokens, self_kv_quant, sot_index, gelu, cross_decode, graphed)


def _spec_rounds(model, cross_kv, draft, draft_cross_kv, prompt, gamma, compute_dtype,
                 max_tokens, self_kv_quant, sot_index, gelu, cross_decode,
                 graphed: bool) -> SpecResult:
    """:func:`speculative_decode_kv` (its arguments in order) with the
    capture chosen by the caller: ``graphed`` replays each group of rounds
    as a CUDA graph, else the same group runs eagerly. The card's checks
    hold the one against the other."""
    cfg, dcfg = model.cfg, draft.cfg
    assert cfg.n_vocab == dcfg.n_vocab, "draft and target must share a vocabulary/tokenizer"
    assert gamma >= 1
    device = prompt.device
    B, P = prompt.shape
    T = cfg.n_text_ctx
    limit = min(T, P + max_tokens) if max_tokens else T
    kv_ctx = min(T, -(-(limit + gamma) // 128) * 128)
    prompt = prompt.to(torch.int64)
    R = SPEC_ROUNDS
    opts = (gamma, compute_dtype, gelu, cross_decode)

    def drive(loop: _SpecLoop, run_group) -> SpecResult:
        no_speech_prob = _prefills(model, draft, loop, prompt, limit, sot_index, compute_dtype,
                                   gelu, cross_decode)
        groups = 0
        while True:
            run_group()
            groups += 1
            with record_function("whisper.decode.flags"):
                all_done, rounds = loop.flags.tolist()
            if all_done:
                break
        # eot past each row's validated frontier, so the buffer reads as
        # greedy's (junk of rejected windows must not look like text)
        pos = torch.arange(T, device=device)[None, :]
        tokens = torch.where((pos >= loop.off[:, None]) & (pos >= P),
                             torch.full_like(loop.tokens, cfg.eot), loop.tokens)
        first_eot = torch.where((tokens == cfg.eot) & (pos >= P), pos,
                                torch.full_like(pos, T)).amin(dim=1)
        stats = loop.stats.clone()
        return SpecResult(tokens=tokens, lengths=first_eot, no_speech_prob=no_speech_prob,
                          avg_logprob=loop.sum_lp / torch.clamp(loop.n_lp, min=1.0),
                          accepted=stats[0], drafted=stats[1], rounds=rounds,
                          host_syncs=groups, device_rounds=groups * R)

    if not graphed:
        loop = _SpecLoop(model, draft, B, kv_ctx, gamma, compute_dtype, self_kv_quant, device)
        loop.cross_t, loop.cross_d = cross_kv, draft_cross_kv
        return drive(loop, lambda: _spec_round(model, draft, loop, R, *opts))
    owner = _decode_graphs(model)
    with owner.lock:
        both = (cross_kv, draft_cross_kv)
        key = ("spec", gamma, _decoder_pointers(draft)) + _shape_key(
            B, both, None, None, kv_ctx, compute_dtype, self_kv_quant)
        loop = _loop_buffers(owner, key, lambda: _SpecLoop(
            model, draft, B, kv_ctx, gamma, compute_dtype, self_kv_quant, model.device),
            both, None, None)
        loop.cross_t, loop.cross_d = loop.cross
        _reset_cache(loop.kv_t)
        _reset_cache(loop.kv_d)
        group = functools.partial(_spec_round, model, draft, loop, R, *opts)
        return drive(loop, lambda: owner.graphs.run(key + (R, *opts), group))
