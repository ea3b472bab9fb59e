"""Speculative greedy decoding: a cheap draft model proposes, the target
verifies gamma + 1 positions a pass.

Port of ``whisper_tpu/spec_decode.py``. The JAX package runs the whole
accept/reject loop as one ``lax.while_loop``; here the loop is Python over
eager PyTorch ops, one round at a time, and reads one all-done flag from the
device a round (counted in ``host_syncs``). Rows sit at their own offsets
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
window, which starts at the frontier, overwrites it.

Each round runs the draft's width-2 feed at ``off - 2`` (it repairs the hole
a fully accepted round leaves: the last accepted proposal was never fed),
``gamma - 1`` 1-wide draft steps through
:func:`~whisper_tpu_torch.models.model.decoder_step_multipos` (the
self-attention kernel and, with the int8 cross-KV, the ``cross_decode``
kernel once a draft layer), and one target window of ``gamma + 1`` at
``off - 1``; the windows and both prefills are plain products, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .models.model import (
    _window_targets,
    decoder_forward,
    decoder_step_multipos,
    decoder_window_multipos,
    new_kv_cache,
)


class SpecResult(NamedTuple):
    tokens: torch.Tensor          # (B, n_text_ctx) int64, prompt included, eot-padded
    lengths: torch.Tensor         # (B,) index of the first eot after the prompt
    no_speech_prob: torch.Tensor  # (B,) fp32: P(<|nospeech|>) at sot (target prefill)
    avg_logprob: torch.Tensor     # (B,) fp32: mean TARGET logprob of the emitted tokens
    accepted: torch.Tensor        # () int64: draft tokens accepted (all rows)
    drafted: torch.Tensor         # () int64: draft tokens proposed (live rows)
    rounds: int = 0               # verify rounds run
    host_syncs: int = 0           # device->host reads of the all-done flag


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
    ``cross_decode`` selects the draft steps' int8 cross-attention kernel."""
    cfg, dcfg = model.cfg, draft.cfg
    assert cfg.n_vocab == dcfg.n_vocab, "draft and target must share a vocabulary/tokenizer"
    assert gamma >= 1
    device = prompt.device
    dt = compute_dtype
    B, P = prompt.shape
    T = cfg.n_text_ctx
    limit = min(T, P + max_tokens) if max_tokens else T
    W = gamma + 1
    kv_ctx = min(T, -(-(limit + gamma) // 128) * 128)
    eot = cfg.eot
    kv_t = new_kv_cache(model, B, dt, kv_ctx, quant=self_kv_quant)
    kv_d = new_kv_cache(draft, B, dt, kv_ctx, quant=self_kv_quant)

    prompt = prompt.to(torch.int64)
    tokens = torch.full((B, T), eot, dtype=torch.int64, device=device)
    tokens[:, :P] = prompt

    # both prefills; the draft's logits are discarded (its cache now holds
    # the prompt, which is all the invariant needs)
    logits_t, _ = decoder_forward(model, prompt, 0, kv_t, cross_kv, dt, gelu=gelu,
                                  cross_decode=cross_decode)
    decoder_forward(draft, prompt, 0, kv_d, draft_cross_kv, dt, gelu=gelu,
                    cross_decode=cross_decode)
    no_speech_prob = torch.softmax(logits_t[:, sot_index], dim=-1)[:, cfg.no_speech]
    lp0 = torch.log_softmax(logits_t[:, -1].to(torch.float32), dim=-1)
    first = torch.argmax(lp0, dim=-1)
    sum_lp = torch.gather(lp0, 1, first[:, None])[:, 0]
    n_lp = torch.ones((B,), dtype=torch.float32, device=device)
    tokens[:, P] = first

    off = torch.full((B,), P + 1, dtype=torch.int64, device=device)  # validated count
    done = (first == eot) | (off >= limit)
    stats = torch.zeros((2,), dtype=torch.int64, device=device)  # accepted, drafted
    rows = torch.arange(B, device=device)
    jar = torch.arange(W, device=device)

    rounds = syncs = 0
    while True:
        syncs += 1
        if bool(done.all()):
            break
        # ---- draft: the width-2 feed over the last two validated tokens,
        # then gamma - 1 one-wide steps
        y0 = torch.stack([tokens[rows, torch.clamp(off - 2, min=0)], tokens[rows, off - 1]], 1)
        dlog0, _ = decoder_window_multipos(draft, y0, off - 2, kv_d, draft_cross_kv, dt,
                                           gelu=gelu)
        cur = torch.argmax(dlog0[:, 1], dim=-1)
        g = [cur]
        for j in range(1, gamma):
            dlogits, _ = decoder_step_multipos(draft, cur, off - 1 + j, kv_d, draft_cross_kv,
                                               dt, gelu=gelu, cross_decode=cross_decode)
            cur = torch.argmax(dlogits, dim=-1)
            g.append(cur)
        g = torch.stack(g, dim=1)  # (B, gamma)

        # ---- verify: one target window of gamma + 1 from the frontier
        y = torch.cat([tokens[rows, off - 1][:, None], g], dim=1)
        vlogits, _ = decoder_window_multipos(model, y, off - 1, kv_t, cross_kv, dt, gelu=gelu)
        vlp = torch.log_softmax(vlogits.to(torch.float32), dim=-1)
        t = torch.argmax(vlp, dim=-1)  # (B, W)
        t_lp = torch.gather(vlp, 2, t[..., None])[..., 0]

        # draft token j + 1 survives iff it equals the target's argmax t_j;
        # the row emits t[:, :a + 1], cut at its first eot and its budget
        a = torch.cumprod((g == t[:, :gamma]).to(torch.int64), dim=1).sum(dim=1)
        is_eot = t == eot
        first_eot = torch.where(is_eot, jar[None, :], torch.full_like(t, W)).amin(dim=1)
        n_new = torch.minimum(torch.minimum(a + 1, first_eot + 1), limit - off)
        n_new = torch.where(done, torch.zeros_like(n_new), n_new)

        # the emitted tokens (all inside the context) are written; the other
        # entries are dropped, written back where no two entries meet
        valid = jar[None, :] < n_new[:, None]  # (B, W)
        at, _ = _window_targets(off[:, None] + jar[None, :], T)
        tokens.scatter_(1, at, torch.where(valid, t, tokens.gather(1, at)))

        alive = ~done
        stats = stats + torch.stack([
            torch.where(alive, torch.minimum(a, n_new), torch.zeros_like(a)).sum(),
            alive.sum() * gamma])
        sum_lp = sum_lp + torch.where(valid, t_lp, torch.zeros_like(t_lp)).sum(dim=1)
        n_lp = n_lp + n_new.to(torch.float32)
        off = off + n_new
        done = done | (valid & is_eot).any(dim=1) | (off >= limit)
        rounds += 1

    # eot past each row's validated frontier, so the buffer reads as greedy's
    # (junk of rejected windows must not look like text)
    pos = torch.arange(T, device=device)[None, :]
    tokens = torch.where((pos >= off[:, None]) & (pos >= P), torch.full_like(tokens, eot), tokens)
    first_eot = torch.where((tokens == eot) & (pos >= P), pos,
                            torch.full_like(pos, T)).amin(dim=1)
    return SpecResult(tokens=tokens, lengths=first_eot, no_speech_prob=no_speech_prob,
                      avg_logprob=sum_lp / torch.clamp(n_lp, min=1.0),
                      accepted=stats[0], drafted=stats[1], rounds=rounds, host_syncs=syncs)
