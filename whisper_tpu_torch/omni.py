"""Speech to token ids with Uni-MoE-2.0-Omni (``models/omni.py``).

``OmniPipeline.transcribe_batch`` follows ``WhisperPipeline``'s: audio
(``whisper.audio``: load, pad to 30 s, copy to the device), the log-mel
(``whisper.mel``, K7 on the card), the Whisper encoder
(``whisper.encoder``), the pooling and projector into the language model
and the prompt's embeddings (``whisper.omni.project``), the prefill over
the prompt (``whisper.omni.prefill``; each block's ``whisper.omni.attn``
and ``whisper.omni.moe`` inside it), then a greedy decode in rounds of
``ROUND_STEPS`` steps (``whisper.decode``), which never read the device
from the host: the host reads the loop's flags once a round
(``whisper.decode.flags``), and on the card each round is a CUDA graph
(``utils.graphs.GraphSet``), captured once for the batch size and
replayed. The decode stops at the configuration's ``stop_id`` or after
``max_tokens`` tokens. The prompt is ``prefix_ids``, the clip's audio
tokens, ``suffix_ids``; without a tokenizer the result is token ids.

The precision keywords are those of ``WhisperPipeline`` that this model
takes: ``w8a8`` serves every linear of the encoder and of the language
model, the projector and the head as W8A8 products (the model is built
quantized, ``models.omni.build_omni``), ``compute_dtype``, ``gelu`` and
``encoder_attention``; the KV cache is in ``compute_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from .config import N_SAMPLES, OmniConfig, get_omni_config
from .decode import ROUND_STEPS
from .models.model import encoder_forward
from .models.omni import (
    MAX_POSITIONS,
    Omni,
    init_omni_params,
    new_cache,
    prefill,
    project,
    prompt_embeddings,
    step,
)
from .ops.audio import load_audio
from .ops.mel import log_mel_batch
from .pipeline import _DTYPES, resolve_device
from .utils.graphs import GraphSet

@dataclass
class OmniResult:
    tokens: np.ndarray       # the served ids, a final stop id included where the decode stopped
    avg_logprob: float       # mean log-probability of ``tokens``


class OmniDecode(NamedTuple):
    tokens: torch.Tensor       # (B, max_tokens) int64, stop-padded after a stop
    lengths: torch.Tensor      # (B,) served ids: up to and with the first stop id
    avg_logprob: torch.Tensor  # (B,) fp32 over the served ids
    steps: int = 0             # steps run after the prefill
    host_syncs: int = 0        # reads of the loop's flags: one a round
    device_steps: int = 0      # steps the device ran: whole rounds, masked steps included


def default_prompt_ids(cfg: OmniConfig, seed: int = 0):
    """Prefix and suffix ids drawn from ``seed`` below ``n_text_ids``."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.n_text_ids, (cfg.n_prefix + cfg.n_suffix,), generator=gen)
    return ids[: cfg.n_prefix].tolist(), ids[cfg.n_prefix:].tolist()


class _Loop:
    """The decode's device state, written in place by the prefill and by
    every round: all that a captured round reads or writes besides the
    weights."""

    def __init__(self, model: Omni, batch: int, n_new: int, dtype):
        cfg, dev = model.cfg, model.device
        i64 = dict(dtype=torch.int64, device=dev)
        ctx = -(-(cfg.prompt_len + n_new) // 128) * 128
        self.kv = new_cache(model, batch, ctx, dtype)
        self.tokens = torch.empty((batch, n_new), **i64)
        self.n = torch.empty((), **i64)  # ids produced so far
        self.done = torch.empty((batch,), dtype=torch.bool, device=dev)
        self.sum_lp = torch.empty((batch,), dtype=torch.float32, device=dev)
        self.n_lp = torch.empty((batch,), dtype=torch.float32, device=dev)
        self.steps = torch.empty((), **i64)
        self.flags = torch.empty((2,), **i64)  # [all done, steps]: read once a round


def _choose(logits: torch.Tensor):
    lp = torch.log_softmax(logits, dim=-1)
    tok = torch.argmax(lp, dim=-1)
    return tok, torch.gather(lp, 1, tok[:, None])[:, 0]


def _round(model: Omni, loop: _Loop, n_steps: int, dt) -> None:
    """``n_steps`` greedy steps, in place on ``loop``, and its flags: no
    host read. A step once every row is done, or past the budget, writes
    and counts nothing."""
    cfg = model.cfg
    N, P = loop.tokens.shape[1], cfg.prompt_len
    for _ in range(n_steps):
        go = (loop.n < N) & ~loop.done.all()
        at = (loop.n - 1).reshape(1)
        cur = loop.tokens.index_select(1, at)[:, 0]
        live = go & ~loop.done
        nxt, lp = _choose(step(model, cur, loop.n - 1 + P, loop.kv, dt, live=live))
        nxt = torch.where(loop.done, torch.full_like(nxt, cfg.stop_id), nxt)
        loop.sum_lp += torch.where(live, lp, torch.zeros_like(lp))
        loop.n_lp += live.to(torch.float32)
        loop.done |= go & (nxt == cfg.stop_id)
        to = torch.clamp(loop.n, max=N - 1).reshape(1)
        old = loop.tokens.index_select(1, to)[:, 0]
        loop.tokens.index_copy_(1, to, torch.where(go, nxt, old)[:, None])
        loop.steps += go
        loop.n += go
    loop.flags[0] = loop.done.all()
    loop.flags[1] = loop.steps


def greedy(model: Omni, x: torch.Tensor, loop: _Loop, dt, run_round) -> OmniDecode:
    """The prefill of prompt embeddings ``x`` into ``loop`` (its first id),
    then ``run_round()`` until every row is done or the budget is spent."""
    N = loop.tokens.shape[1]
    with record_function("whisper.omni.prefill"):
        loop.kv.zero_()
        first, first_lp = _choose(prefill(model, x, loop.kv, dt))
    # the loop's state is set inside the decode's range: the range's device
    # span then runs from these launches to the tokens' copy, over every
    # round (a graph replay's kernels belong to no range)
    with record_function("whisper.decode"):
        loop.tokens.fill_(model.cfg.stop_id)
        loop.tokens[:, 0] = first
        loop.done.copy_(first == model.cfg.stop_id)
        loop.sum_lp.copy_(first_lp)
        loop.n_lp.fill_(1.0)
        loop.n.fill_(1)
        loop.steps.zero_()
        i, rounds, steps = 1, 0, 0
        while i < N:
            run_round()
            rounds += 1
            i += ROUND_STEPS
            with record_function("whisper.decode.flags"):  # the host waits for the round
                all_done, steps = loop.flags.tolist()
            if all_done:
                break
        tokens = loop.tokens.clone()
        pos = torch.arange(N, device=tokens.device)[None]
        first_stop = torch.where(tokens == model.cfg.stop_id, pos, N).amin(dim=1)
        return OmniDecode(tokens=tokens, lengths=torch.clamp(first_stop + 1, max=N),
                          avg_logprob=loop.sum_lp / torch.clamp(loop.n_lp, min=1.0),
                          steps=steps, host_syncs=rounds, device_steps=rounds * ROUND_STEPS)


class OmniPipeline:
    """Load once, decode many: batched greedy speech to token ids."""

    def __init__(
        self,
        model: str = "uni-moe-2.0-omni",
        params: Optional[Omni] = None,
        prefix_ids: Optional[Sequence[int]] = None,
        suffix_ids: Optional[Sequence[int]] = None,
        compute_dtype: str = "float32",
        w8a8: bool = False,
        gelu: str = "erf",
        encoder_attention: str = "btd",
        max_tokens: int = 128,
        seed: int = 0,
        device="cuda",
    ):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        self.device = resolve_device(device)
        self.compute_dtype = _DTYPES[compute_dtype]
        if params is None:
            params = init_omni_params(get_omni_config(model), seed, device=self.device,
                                      dtype=self.compute_dtype, quantize=w8a8)
        elif params.device != self.device:
            raise ValueError(f"params are on {params.device}, the pipeline on {self.device}")
        elif params.quantized != w8a8:
            raise ValueError(f"the model was built with quantize={params.quantized}: pass "
                             f"w8a8={params.quantized}")
        self.model, self.cfg = params, params.cfg
        if not 1 <= max_tokens <= MAX_POSITIONS - self.cfg.prompt_len:
            raise ValueError(f"max_tokens must lie in 1..{MAX_POSITIONS - self.cfg.prompt_len}")
        if prefix_ids is None or suffix_ids is None:
            drawn = default_prompt_ids(self.cfg, seed)
            prefix_ids = drawn[0] if prefix_ids is None else prefix_ids
            suffix_ids = drawn[1] if suffix_ids is None else suffix_ids
        ids = list(prefix_ids) + list(suffix_ids)
        if (len(prefix_ids), len(suffix_ids)) != (self.cfg.n_prefix, self.cfg.n_suffix) or \
                not all(0 <= i < self.cfg.n_vocab for i in ids):
            raise ValueError(f"the prompt takes {self.cfg.n_prefix} prefix and "
                             f"{self.cfg.n_suffix} suffix ids below {self.cfg.n_vocab}")
        self.prefix = torch.as_tensor(list(prefix_ids), dtype=torch.int64, device=self.device)
        self.suffix = torch.as_tensor(list(suffix_ids), dtype=torch.int64, device=self.device)
        self.max_tokens = max_tokens
        self.w8a8, self.gelu, self.encoder_attention = w8a8, gelu, encoder_attention
        self.graphs = GraphSet(self.device) if self.device.type == "cuda" else None
        self._loops = {}
        self.last_decode: Optional[OmniDecode] = None

    def _prepare_batch(self, waves: Sequence[np.ndarray]):
        if any(len(w) > N_SAMPLES for w in waves):
            raise ValueError("the omni pipeline takes clips of at most 30 s")
        batch = np.zeros((len(waves), N_SAMPLES), np.float32)
        for i, w in enumerate(waves):
            batch[i, : len(w)] = w
        lengths = np.array([len(w) for w in waves], np.int64)
        return (torch.from_numpy(batch).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def embed_audio(self, audios: Sequence[Union[str, bytes, np.ndarray]]):
        """The batch's clips (mono float32 at 16 kHz) and prompt embeddings
        (B, prompt_len, D) fp32."""
        a = self.cfg.audio
        with record_function("whisper.audio"):
            waves = [load_audio(x) for x in audios]
            batch, lengths = self._prepare_batch(waves)
        with record_function("whisper.mel"):
            mel = log_mel_batch(batch, lengths, n_mels=a.n_mels)[..., : 2 * a.n_audio_ctx]
        with record_function("whisper.encoder"):
            feats = encoder_forward(self.model.audio, mel, self.compute_dtype, w8a8=self.w8a8,
                                    gelu=self.gelu, attn=self.encoder_attention)
        with record_function("whisper.omni.project"):
            return waves, prompt_embeddings(self.model, self.prefix, project(self.model, feats),
                                            self.suffix)

    def decode(self, x: torch.Tensor) -> OmniDecode:
        """The greedy decode of prompt embeddings ``x``; on the card its
        rounds replay as CUDA graphs, one per batch size."""
        B = x.shape[0]
        loop = self._loops.get(B)
        if loop is None:
            loop = self._loops[B] = _Loop(self.model, B, self.max_tokens, self.compute_dtype)

        def one_round():
            _round(self.model, loop, ROUND_STEPS, self.compute_dtype)

        if self.graphs is not None:
            return greedy(self.model, x, loop, self.compute_dtype,
                          lambda: self.graphs.run(B, one_round))
        return greedy(self.model, x, loop, self.compute_dtype, one_round)

    def transcribe_batch(self, audios: Sequence[Union[str, bytes, np.ndarray]]
                         ) -> List[OmniResult]:
        """Each clip's served ids and their mean log-probability."""
        waves, x = self.embed_audio(audios)
        result = self.decode(x)
        self.last_decode = result
        toks, lens = result.tokens.cpu().numpy(), result.lengths.cpu().numpy()
        lps = result.avg_logprob.cpu().numpy()
        return [OmniResult(tokens=toks[i, : lens[i]], avg_logprob=float(lps[i]))
                for i in range(len(waves))]
