"""Continuous-batching inference engine: greedy slots on one card.

Port of ``whisper_tpu/serving/engine.py``'s greedy core. The engine keeps a
fixed pool of ``max_slots`` decode slots on the device:

- new requests are admitted between decode rounds: their mel, encoder,
  cross-KV and prompt prefill run as one bucketed batch, and the resulting
  cross-KV and self-KV are copied into free slots;
- every round advances ALL slots ``steps_per_sync`` tokens with
  :func:`~whisper_tpu_torch.models.model.decoder_step_multipos`, each slot at
  its own cache offset, without reading the device from the host;
- after a round, the slot state is packed into one int32 buffer whose copy
  to pinned host memory overlaps the next round; the next tick resolves it,
  detokenizes the finished slots and frees them.

One thread (``_run``) owns the device state and calls :meth:`_tick`; HTTP
handler threads only :meth:`submit` and wait on futures. Admission runs
inline in ``_tick`` (the JAX engine's single-thread mode), so tests drive
rounds deterministically by calling ``_tick`` themselves.

Not ported yet, and refused with ``NotImplementedError``: the beam worker,
sampling temperatures and the retry ladder, requests over 30 s, word
timestamps, ``initial_prompt`` / ``condition_on_previous``, language
auto-detection, ``on_partial`` streaming, timestamps, a device mesh,
segmented admission encodes and adaptive round sizes.
"""

from __future__ import annotations

import queue
import threading
import time
import zlib
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import N_SAMPLES
from ..decode import encode_cross_kv
from ..models.model import (
    KVCache,
    QKVCache,
    Whisper,
    cast_floating,
    check_selections,
    decoder_forward,
    decoder_step_multipos,
)
from ..ops import _build
from ..ops.mel import log_mel_batch
from ..sampling import RuleState, apply_rules, build_suppress_ids
from ..text import postprocess


@dataclass
class Request:
    audio: np.ndarray          # mono f32 @16k, at most 30 s
    language: str = "zh"
    task: str = "transcribe"
    beam_size: int = 1         # > 1 is not ported
    # per-request generated-token budget (None = the engine's max_tokens),
    # capped by the engine's bucketed cache
    max_tokens: Optional[int] = None
    temperature: float = 0.0   # > 0 is not ported
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.perf_counter)
    on_partial: Optional[object] = None  # streaming: not ported
    # engine-enforced deadline (seconds from enqueue; None = no limit).
    # Expired requests fail with TimeoutError and their slot is freed.
    deadline_s: Optional[float] = None
    word_timestamps: bool = False        # not ported
    initial_prompt: Optional[str] = None  # not ported
    condition_on_previous: bool = False  # not ported

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_s is None:
            return False
        return (now or time.perf_counter()) - self.enqueued_at > self.deadline_s

    def cancel(self) -> bool:
        """Cooperative cancellation: the engine drops the request at the next
        admission/sync boundary (future resolves CancelledError)."""
        return self.future.cancel()


@dataclass
class EngineStats:
    requests_total: int = 0
    tokens_total: int = 0
    audio_seconds_total: float = 0.0
    busy_seconds_total: float = 0.0
    queue_depth: int = 0
    active_slots: int = 0
    # quality gates (harvest-time, OpenAI transcribe semantics)
    no_speech_total: int = 0      # requests gated to "" by the silence rule
    low_quality_total: int = 0    # compression-ratio / logprob criteria failed
    # host-side phase breakdown of busy time: eager launches return before
    # the card finishes, so admit/step measure enqueue cost and the card's
    # execution pools into harvest_seconds_total at its one sync per tick
    admit_seconds_total: float = 0.0
    step_seconds_total: float = 0.0
    harvest_seconds_total: float = 0.0
    ticks_total: int = 0          # sync rounds run
    steps_total: int = 0          # decode steps stepped over all slots
    # admission encode + prefill (inline in _tick), inside step_seconds
    encode_seconds_total: float = 0.0
    encode_batches_total: int = 0
    prepared_depth: int = 0       # requests encoded+prefilled awaiting a slot
    warmup_seconds: float = 0.0   # start(): the CUDA kernels' build

    def snapshot(self) -> dict:
        d = dict(self.__dict__)
        busy = max(self.busy_seconds_total, 1e-9)
        d["audio_seconds_per_second"] = self.audio_seconds_total / busy
        d["rtf"] = busy / max(self.audio_seconds_total, 1e-9)
        return d


class OverloadedError(RuntimeError):
    """Raised on submit when the request queue is at capacity (backpressure)."""


@dataclass
class _PreparedBatch:
    """An encoded and prefilled admission batch; rows are copied into free
    slots, possibly across several ticks."""

    reqs: List[Request]            # row i of the device tensors <-> reqs[i]
    kv: tuple                      # prefilled self-KV (bucket rows)
    cross: tuple                   # cross-KV parts (bucket rows)
    first: torch.Tensor            # (bucket,) first sampled token
    first_lp: torch.Tensor         # (bucket,) its logprob
    nsp: torch.Tensor              # (bucket,) no-speech prob
    prompts: torch.Tensor          # (bucket, P) prompt rows
    prompt_len: int
    consumed: int = 0              # rows already copied into slots


def _safe_set_result(fut: Future, result) -> None:
    """Resolve a future, tolerating a concurrent cancel (the
    ``if not done(): set_result()`` idiom races ``Future.cancel()``)."""
    try:
        if not fut.done():
            fut.set_result(result)
    except InvalidStateError:
        pass


def _safe_set_exception(fut: Future, exc: BaseException) -> None:
    """set_exception twin of _safe_set_result (same cancel race)."""
    try:
        if not fut.done():
            fut.set_exception(exc)
    except InvalidStateError:
        pass


PREFILL_BUCKETS = (1, 2, 4, 8, 16, 32, 64)  # admission batch sizes


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ContinuousBatchingEngine:
    """Slot-based continuous batching over one model on one device (the
    model's). ``model`` is cast to ``compute_dtype`` in place.
    ``encoder_attention`` selects the admission encode's attention kernel
    and ``cross_decode`` the decode step's int8 cross-attention kernel (see
    ``models/model.py``)."""

    def __init__(
        self,
        model: Whisper,
        tokenizer,
        max_slots: int = 8,
        compute_dtype=torch.bfloat16,
        steps_per_sync: int = 4,
        max_tokens: Optional[int] = None,
        max_queue: int = 256,
        kv_quant: bool = False,
        self_kv_quant: bool = False,
        w8a8: bool = False,
        encoder_attention: str = "btd",
        cross_decode: str = "fd",
        no_speech_threshold: Optional[float] = 0.6,
        logprob_threshold: Optional[float] = -1.0,
        compression_ratio_threshold: Optional[float] = 2.4,
        admit_chunk: Optional[int] = None,
        timestamps: bool = False,
        mesh=None,
        encode_chunks: int = 1,
        temperature_fallback: Optional[Sequence[float]] = None,
        adaptive_sync: bool = False,
    ):
        unported = {"timestamps": timestamps, "mesh": mesh is not None,
                    "encode_chunks > 1": encode_chunks > 1,
                    "temperature_fallback": bool(temperature_fallback),
                    "adaptive_sync": adaptive_sync}
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"not ported to whisper_tpu_torch yet: {', '.join(asked)}")
        check_selections(encoder_attention, cross_decode)
        cfg = model.cfg
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.dt = compute_dtype
        self.device = model.device
        self.B = B = max_slots
        self.steps_per_sync = steps_per_sync
        self.prefill_buckets = tuple(b for b in PREFILL_BUCKETS if b <= max_slots) or (max_slots,)
        self.max_tokens = max_tokens
        self.kv_quant = kv_quant
        self.self_kv_quant = self_kv_quant
        self.w8a8 = w8a8
        self.encoder_attention = encoder_attention
        self.cross_decode = cross_decode
        self.no_speech_threshold = no_speech_threshold
        self.logprob_threshold = logprob_threshold
        self.compression_ratio_threshold = compression_ratio_threshold
        # while slots are decoding, at most this many newcomers encode per
        # round, so one admission stalls the active slots by a small encoder
        # pass; an idle engine admits whole buckets
        self.admit_chunk = admit_chunk or max(1, max_slots // 4)
        self.model = cast_floating(model, compute_dtype)
        self._suppress = torch.as_tensor(build_suppress_ids(cfg, tokenizer), dtype=torch.int64,
                                         device=self.device)

        T = cfg.n_text_ctx
        dev = self.device
        # the prompts are sot sequences (<= 4 tokens), so a token budget
        # bounds every cache write: the cache holds only the reachable
        # positions, rounded up to 128
        self.kv_ctx = min(T, -(-(4 + max_tokens) // 128) * 128) if max_tokens else T
        self.kv = self._new_cache(B)
        L, H, dh, Ta = cfg.n_text_layer, cfg.n_text_head, cfg.head_dim_text, cfg.n_audio_ctx
        if kv_quant:  # int8 payloads + fp32 scales, audio-minor (quantize_cross_kv)
            q8 = dict(dtype=torch.int8, device=dev)
            f32 = dict(dtype=torch.float32, device=dev)
            self.cross = (torch.zeros((L, B, H, dh, Ta), **q8), torch.zeros((L, B, H, 1, dh), **f32),
                          torch.zeros((L, B, H, dh, Ta), **q8), torch.zeros((L, B, H, 1, dh), **f32))
        else:
            self.cross = tuple(torch.zeros((L, B, H, Ta, dh), dtype=compute_dtype, device=dev)
                               for _ in range(2))
        self.tokens = torch.full((B, T), cfg.eot, dtype=torch.int64, device=dev)
        self.offsets = torch.zeros((B,), dtype=torch.int64, device=dev)  # next write position
        self.active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.rs = RuleState.create(B, device=dev)
        self.limit = torch.full((B,), T, dtype=torch.int64, device=dev)
        # per-slot quality state, read host-side only at harvest:
        # fstate = [sum_logprob, n_sampled], nsp = P(<|nospeech|>) at sot
        self.fstate = torch.zeros((B, 2), dtype=torch.float32, device=dev)
        self.nsp = torch.zeros((B,), dtype=torch.float32, device=dev)

        # host-side slot bookkeeping
        self._slot_req: List[Optional[Request]] = [None] * B
        self._slot_prompt_len: List[int] = [0] * B
        # per-slot admission generation, bumped by every _scatter_rows. The
        # pipelined harvest resolves a buffer packed ONE TICK AGO: if the
        # slot was freed and re-admitted in between, that buffer's row is the
        # PREVIOUS request's state, and resolving it against the new
        # _slot_req entry would deliver the old transcript to the new caller.
        # Each packed buffer records the vector at pack time; resolve skips
        # any slot whose generation moved.
        self._slot_gen = np.zeros((B,), np.int64)

        self._queue: "queue.Queue[Request]" = queue.Queue(maxsize=max_queue)
        # FIFO admission order: requests drain queue -> _pending and are
        # admitted strictly from the left
        self._pending: "deque[Request]" = deque()
        self._ready: "deque[_PreparedBatch]" = deque()  # prepared, awaiting slots
        self._prepared_reqs = 0
        # (pinned host copy, its CUDA event or None, _slot_gen at pack) of
        # the last round; resolved at the start of the next tick
        self._inflight_harvest = None
        self.stats = EngineStats()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _new_cache(self, batch: int):
        if self.self_kv_quant:
            return QKVCache.create(self.cfg, batch, ctx=self.kv_ctx, device=self.device)
        return KVCache.create(self.cfg, batch, dtype=self.dt, ctx=self.kv_ctx, device=self.device)

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting on the card: staged
        through pinned memory and copied on the stream."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------- API
    def submit(self, req: Request) -> Future:
        if not (0.0 <= req.temperature <= 2.0):
            raise ValueError(f"temperature {req.temperature} not in [0, 2]")
        if req.task not in ("transcribe", "translate"):
            raise ValueError(f"bad task {req.task!r}")
        unported = {
            "beam_size > 1": req.beam_size > 1,
            "temperature > 0": req.temperature > 0,
            "audio over 30 s": len(req.audio) > N_SAMPLES,
            "word_timestamps": req.word_timestamps,
            "initial_prompt": bool(req.initial_prompt),
            "condition_on_previous": req.condition_on_previous,
            "language=auto": req.language in (None, "auto"),
            "on_partial streaming": req.on_partial is not None,
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"not ported to whisper_tpu_torch yet: {', '.join(asked)}")
        self.cfg.sot_sequence(req.language, req.task)  # ValueError on an unknown language
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise OverloadedError(f"queue full ({self._queue.maxsize} pending requests)") from None
        self.stats.queue_depth = self._queue.qsize() + len(self._pending)
        return req.future

    def transcribe(self, audio: np.ndarray, language: str = "zh", task: str = "transcribe",
                   timeout: Optional[float] = 120.0, beam_size: int = 1) -> dict:
        fut = self.submit(Request(audio=audio, language=language, task=task,
                                  beam_size=beam_size))
        return fut.result(timeout=timeout)

    def start(self):
        """Build the CUDA kernels (so no request pays for nvcc), then start
        the decode thread."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.build_all()
        self.stats.warmup_seconds = time.perf_counter() - t0
        self._thread = threading.Thread(target=self._run, daemon=True, name="cb-engine")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # ------------------------------------------------------------- admission
    def _free_slots(self) -> List[int]:
        return [i for i in range(self.B) if self._slot_req[i] is None]

    def _drain_queue(self):
        while True:
            try:
                self._pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        self.stats.queue_depth = len(self._pending)

    def _prepare_pending_once(self) -> bool:
        """Take pending requests (bounded by the bucket size, admit_chunk
        while slots are active, and one slot pool's worth prepared ahead),
        run mel + encoder + cross-KV + prefill, and queue a _PreparedBatch.
        Returns True if a batch was prepared."""
        self._drain_queue()
        cap = min(max(self.prefill_buckets), self.B - self._prepared_reqs)
        if self.stats.active_slots > 0:
            cap = min(cap, self.admit_chunk)
        newcomers: List[Request] = []
        now = time.perf_counter()
        while self._pending and len(newcomers) < cap:
            r = self._pending.popleft()  # strict FIFO: submit order = admit order
            if r.future.cancelled():
                continue
            if r.expired(now):
                _safe_set_exception(r.future, TimeoutError(
                    f"deadline {r.deadline_s}s expired in queue"))
                continue
            newcomers.append(r)
        self.stats.queue_depth = len(self._pending)
        if not newcomers:
            return False
        t0 = time.perf_counter()
        try:
            batch = self._prepare_batch(newcomers)
        except Exception as e:  # noqa: BLE001 — fail these requests, keep serving
            for r in newcomers:
                _safe_set_exception(r.future, e)
            return False
        self._ready.append(batch)
        self._prepared_reqs += len(newcomers)
        self.stats.prepared_depth = self._prepared_reqs
        self.stats.encode_seconds_total += time.perf_counter() - t0
        self.stats.encode_batches_total += 1
        return True

    def _prepare_batch(self, newcomers: List[Request]) -> _PreparedBatch:
        """Bucketed mel -> encoder -> cross-KV (+int8) -> prefill, then the
        no-speech probability and the first token under the rules. Only
        enqueues work on the card: no host sync."""
        cfg, dt = self.cfg, self.dt
        bucket = _bucket(len(newcomers), self.prefill_buckets)
        audio = np.zeros((bucket, N_SAMPLES), np.float32)
        lengths = np.zeros((bucket,), np.int64)
        for i, r in enumerate(newcomers):
            a = np.asarray(r.audio, np.float32)[:N_SAMPLES]
            audio[i, : len(a)] = a
            lengths[i] = len(a)
        mel = log_mel_batch(self._to_dev(audio), self._to_dev(lengths),
                            n_mels=cfg.n_mels)[..., : 2 * cfg.n_audio_ctx]
        cross = encode_cross_kv(self.model, mel, dt, kv_quant=self.kv_quant, w8a8=self.w8a8,
                                encoder_attention=self.encoder_attention)

        rows = [cfg.sot_sequence(r.language, r.task) for r in newcomers]
        prompts = np.asarray(rows + rows[:1] * (bucket - len(rows)), np.int64)
        prompts_dev = self._to_dev(prompts)
        logits, kv = decoder_forward(self.model, prompts_dev, 0, self._new_cache(bucket), cross,
                                     dt, cross_decode=self.cross_decode)
        # OpenAI-style no-speech probability: softmax at the sot position
        nsp = torch.softmax(logits[:, 0].to(torch.float32), dim=-1)[:, cfg.no_speech]
        last = apply_rules(logits[:, -1], RuleState.create(bucket, device=self.device), cfg,
                           suppress_ids=self._suppress)
        lp0 = torch.log_softmax(last.to(torch.float32), dim=-1)
        first = torch.argmax(last, dim=-1)
        first_lp = torch.gather(lp0, 1, first[:, None])[:, 0]
        return _PreparedBatch(reqs=newcomers, kv=tuple(kv), cross=tuple(cross), first=first,
                              first_lp=first_lp, nsp=nsp, prompts=prompts_dev,
                              prompt_len=prompts.shape[1])

    def _admit_new(self):
        """Copy prepared admissions into free slots. Partial copies (fewer
        free slots than prepared rows) consume a batch across several
        ticks."""
        while self._ready:
            batch = self._ready[0]
            free = self._free_slots()
            if not free:
                return
            rows: List[int] = []
            takers: List[Request] = []
            start = batch.consumed
            now = time.perf_counter()
            while batch.consumed < len(batch.reqs) and len(rows) < len(free):
                i = batch.consumed
                r = batch.reqs[i]
                batch.consumed += 1
                if r.future.cancelled():
                    continue
                if r.expired(now):
                    _safe_set_exception(r.future, TimeoutError(
                        f"deadline {r.deadline_s}s expired before a slot freed"))
                    continue
                rows.append(i)
                takers.append(r)
            if rows:
                self._scatter_rows(batch, rows, takers)
            self._prepared_reqs = max(0, self._prepared_reqs - (batch.consumed - start))
            self.stats.prepared_depth = self._prepared_reqs
            if batch.consumed < len(batch.reqs):
                return  # out of free slots; the rest goes in next tick
            self._ready.popleft()

    def _scatter_rows(self, batch: _PreparedBatch, rows: List[int], takers: List[Request]):
        """Copy prepared rows ``rows`` into as many free slots. Only valid,
        distinct slots are indexed (index_copy_ with an out-of-range or a
        repeated index would raise or race)."""
        cfg = self.cfg
        k = len(rows)
        slots = self._free_slots()[:k]
        dst = self._to_dev(np.asarray(slots, np.int64))
        src = self._to_dev(np.asarray(rows, np.int64))
        P = batch.prompt_len
        # per-slot token budget: request override > engine default, always
        # capped by the bucketed cache (never write past it)
        lim = np.full((k,), min(cfg.n_text_ctx, self.kv_ctx), np.int64)
        for j, r in enumerate(takers):
            budget = r.max_tokens or self.max_tokens
            if budget:
                lim[j] = min(lim[j], P + budget)

        for dst_t, src_t in zip(tuple(self.kv) + self.cross, batch.kv + batch.cross):
            dst_t.index_copy_(1, dst, src_t.index_select(1, src))
        first = batch.first.index_select(0, src)
        row = torch.full((k, self.tokens.shape[1]), cfg.eot, dtype=torch.int64,
                         device=self.device)
        row[:, :P] = batch.prompts.index_select(0, src)
        row[:, P] = first
        self.tokens.index_copy_(0, dst, row)
        self.offsets.index_fill_(0, dst, P + 1)
        self.active.index_fill_(0, dst, True)
        self.done.index_copy_(0, dst, first == cfg.eot)
        self.limit.index_copy_(0, dst, self._to_dev(lim))
        self.rs.last.index_copy_(0, dst, first)
        self.rs.penult.index_fill_(0, dst, -1)
        self.rs.max_ts.index_copy_(0, dst, torch.where(first >= cfg.timestamp_begin, first, 0))
        self.rs.n_sampled.index_fill_(0, dst, 1)
        # quality state: sum_logprob starts at the prefill-sampled token's
        first_lp = batch.first_lp.index_select(0, src)
        self.fstate.index_copy_(0, dst, torch.stack([first_lp, torch.ones_like(first_lp)], 1))
        self.nsp.index_copy_(0, dst, batch.nsp.index_select(0, src))

        for i, r in zip(slots, takers):
            self._slot_req[i] = r
            self._slot_prompt_len[i] = P
            self._slot_gen[i] += 1  # in-flight packed buffers go stale here
        self.stats.active_slots = sum(r is not None for r in self._slot_req)

    def _expire_slots(self):
        """Fail in-flight requests past their deadline (or cancelled) and free
        their slots so the capacity returns to the pool."""
        now = time.perf_counter()
        drop = [i for i in range(self.B)
                if self._slot_req[i] is not None
                and (self._slot_req[i].expired(now) or self._slot_req[i].future.cancelled())]
        if not drop:
            return
        for i in drop:
            req = self._slot_req[i]
            _safe_set_exception(req.future, TimeoutError(
                f"deadline {req.deadline_s}s expired mid-decode"))
            self._slot_req[i] = None
            self._slot_prompt_len[i] = 0
        self._deactivate(drop)

    def _deactivate(self, slots: List[int]):
        mask = np.zeros((self.B,), bool)
        mask[slots] = True
        keep = ~self._to_dev(mask)
        self.active = self.active & keep
        self.done = self.done & keep
        self.stats.active_slots = sum(r is not None for r in self._slot_req)

    # ------------------------------------------------------------- decode round
    def _steps(self, n_steps: int):
        """``n_steps`` greedy steps over every slot, all on the device: a slot
        steps only while active and not done (``step_ok``); the others
        re-run their last position and keep their state. No host sync."""
        cfg = self.cfg
        eot, ts0 = cfg.eot, cfg.timestamp_begin
        tokens, offsets, done, rs, fstate = self.tokens, self.offsets, self.done, self.rs, self.fstate
        active, limit = self.active, self.limit
        cols = torch.arange(tokens.shape[1], device=self.device)[None, :]
        for _ in range(n_steps):
            # clamp: empty slots sit at offset 0
            pos = torch.clamp(offsets - 1, min=0)
            cur = torch.gather(tokens, 1, pos[:, None])[:, 0]
            logits, _ = decoder_step_multipos(self.model, cur, pos, self.kv, self.cross, self.dt,
                                              cross_decode=self.cross_decode)
            logits = apply_rules(logits, rs, cfg, suppress_ids=self._suppress)
            lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            nxt = torch.argmax(logits, dim=-1)
            step_ok = active & ~done
            # quality: the sampled token's logprob under the filtered
            # distribution (the step emitting eot counts, later ones don't)
            tok_lp = torch.gather(lp, 1, nxt[:, None])[:, 0]
            fstate = torch.stack([fstate[:, 0] + torch.where(step_ok, tok_lp, 0.0),
                                  fstate[:, 1] + step_ok.to(torch.float32)], dim=1)
            nxt = torch.where(step_ok, nxt, eot)
            rs = RuleState(*(torch.where(step_ok, n, o)
                             for n, o in zip(rs.advance(nxt, ts0), rs)))
            tokens = torch.where((cols == offsets[:, None]) & step_ok[:, None],
                                 nxt[:, None], tokens)
            done = done | (step_ok & ((nxt == eot) | (offsets + 1 >= limit)))
            offsets = torch.where(step_ok, offsets + 1, offsets)
        self.tokens, self.offsets, self.done, self.rs, self.fstate = tokens, offsets, done, rs, fstate
        self.stats.steps_total += n_steps

    # ------------------------------------------------------------- harvest
    def _pack_harvest_fn(self) -> torch.Tensor:
        """All harvest state in ONE (B, 6+T) int32 tensor, so one copy brings
        it to the host: [offset, active, done, bits(sum_lp), bits(n_lp),
        bits(nsp), tokens...]."""
        ctrl = torch.stack([self.offsets, self.active.to(torch.int64),
                            self.done.to(torch.int64)], dim=1).to(torch.int32)
        return torch.cat([ctrl, self.fstate.view(torch.int32),
                          self.nsp[:, None].view(torch.int32), self.tokens.to(torch.int32)], 1)

    def _start_harvest_copy(self):
        """Start the copy of the round's packed state into pinned host memory
        WITHOUT waiting on it; the next tick resolves it, so the transfer
        overlaps the card's work on the round just enqueued."""
        buf = self._pack_harvest_fn()
        if buf.is_cuda:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = buf, None
        # snapshot the admission generations: the resolve next tick must
        # ignore any slot re-admitted after this pack (see _slot_gen)
        self._inflight_harvest = (host, event, self._slot_gen.copy())

    @staticmethod
    def _compression_ratio(text: str) -> float:
        b = text.encode("utf-8")
        return len(b) / max(len(zlib.compress(b)), 1)

    def _quality_gate(self, text: str, nsp: float, avg_lp: float):
        """Harvest-time quality gates (OpenAI transcribe semantics): silence
        unless the decode is confident anyway; compression/logprob failures
        are flagged. Returns (text, comp, quality_ok, silenced) and bumps the
        gate counters."""
        comp = self._compression_ratio(text)
        quality_ok = True
        if ((self.compression_ratio_threshold is not None
             and comp > self.compression_ratio_threshold)
                or (self.logprob_threshold is not None and avg_lp < self.logprob_threshold)):
            quality_ok = False
            self.stats.low_quality_total += 1
        silenced = False
        if (self.no_speech_threshold is not None and nsp > self.no_speech_threshold
                and not (self.logprob_threshold is not None
                         and avg_lp > self.logprob_threshold)):
            text = ""
            silenced = True
            self.stats.no_speech_total += 1
        return text, comp, quality_ok, silenced

    def _harvest_host(self, done_h, active_h, offs_h, tokens_h, fstate_h, nsp_h):
        ready = [i for i in range(self.B)
                 if active_h[i] and done_h[i] and self._slot_req[i] is not None]
        if not ready:
            return
        for i in ready:
            req = self._slot_req[i]
            P = self._slot_prompt_len[i]
            ids = tokens_h[i, P: offs_h[i]]
            ids = ids[ids != self.cfg.eot]
            text = postprocess(self.tokenizer.decode(ids).strip(), req.language)
            avg_lp = float(fstate_h[i, 0] / max(fstate_h[i, 1], 1.0))
            nsp = float(nsp_h[i])
            text, comp, quality_ok, silenced = self._quality_gate(text, nsp, avg_lp)
            wall = time.perf_counter() - req.enqueued_at
            audio_s = len(req.audio) / 16000.0
            self.stats.requests_total += 1
            self.stats.tokens_total += int(len(ids))
            self.stats.audio_seconds_total += audio_s
            _safe_set_result(req.future, {
                "success": True,
                "text": text,
                "language": req.language,
                "audio_seconds": audio_s,
                "wall_seconds": wall,
                "rtf": wall / max(audio_s, 1e-9),
                "tokens": int(len(ids)),
                "temperature": req.temperature,
                "attempts": 1,
                "no_speech_prob": nsp,
                "avg_logprob": avg_lp,
                "compression_ratio": comp,
                "quality_ok": quality_ok,
            })
            self._slot_req[i] = None
            self._slot_prompt_len[i] = 0
        self._deactivate(ready)

    def _fail_inflight(self, exc: BaseException):
        """Fail every in-flight, prepared and queued request; reset slot
        state so the loop can keep serving."""
        for i, req in enumerate(self._slot_req):
            if req is not None:
                _safe_set_exception(req.future, exc)
            self._slot_req[i] = None
            self._slot_prompt_len[i] = 0
        for batch in self._ready:
            for req in batch.reqs[batch.consumed:]:
                _safe_set_exception(req.future, exc)
        self._ready.clear()
        self._prepared_reqs = 0
        self.stats.prepared_depth = 0
        self._drain_queue()
        while self._pending:
            _safe_set_exception(self._pending.popleft().future, exc)
        self._inflight_harvest = None
        self.active = torch.zeros_like(self.active)
        self.done = torch.zeros_like(self.done)
        self.stats.active_slots = 0
        self.stats.queue_depth = 0

    # ------------------------------------------------------------- the loop
    def _tick(self):
        """One decode-thread round:

        1. admission: encode + prefill pending requests (inline);
        2. enqueue round N (steps_per_sync steps) and start its harvest copy;
        3. resolve round N-1's copy (the card is busy with round N meanwhile)
           and free finished slots;
        4. expire/cancel; copy prepared admissions into free slots.
        """
        t0 = time.perf_counter()
        self.stats.ticks_total += 1
        self._prepare_pending_once()
        prev = self._inflight_harvest  # round N-1 copy, still in flight
        self._inflight_harvest = None
        if any(r is not None for r in self._slot_req):
            self._steps(self.steps_per_sync)
            self._start_harvest_copy()
        t1 = time.perf_counter()
        self.stats.step_seconds_total += t1 - t0
        if prev is not None:
            host, event, prev_gen = prev
            if event is not None:
                event.synchronize()
            h = host.numpy()
            # a slot re-admitted since the pack carries the PREVIOUS
            # request's row in this buffer: don't harvest it
            fresh = prev_gen == self._slot_gen
            self._harvest_host((h[:, 2] > 0) & fresh, h[:, 1] > 0, h[:, 0], h[:, 6:],
                               h[:, 3:5].view(np.float32), h[:, 5:6].view(np.float32)[:, 0])
        t2 = time.perf_counter()
        self.stats.harvest_seconds_total += t2 - t1
        self._expire_slots()
        self._admit_new()  # copied now, stepped in round N+1
        self.stats.admit_seconds_total += time.perf_counter() - t2
        self.stats.busy_seconds_total += time.perf_counter() - t0

    def _idle(self) -> bool:
        return (all(r is None for r in self._slot_req) and self._inflight_harvest is None
                and not self._ready and not self._pending)

    def _run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            try:
                if self._idle():
                    try:
                        self._pending.append(self._queue.get(timeout=0.05))
                    except queue.Empty:
                        continue
                self._tick()
            except Exception as e:  # noqa: BLE001 — engine thread must survive
                self._fail_inflight(e)
