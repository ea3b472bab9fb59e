"""Continuous-batching inference engine: greedy slots, an aux worker for
sampled decodes and the temperature ladder, on one card or a TP mesh.

Port of ``whisper_tpu/serving/engine.py``. The engine keeps a fixed pool of
``max_slots`` decode slots on the device:

- new requests are admitted between decode rounds: their mel, encoder,
  cross-KV and prompt prefill run as one bucketed batch, and the resulting
  cross-KV and self-KV are copied into free slots;
- every round advances ALL slots ``steps_per_sync`` tokens with
  :func:`~whisper_tpu_torch.models.model.decoder_step_multipos`, each slot at
  its own cache offset, without reading the device from the host;
- after a round, the slot state is packed into one int32 buffer whose copy
  to pinned host memory overlaps the next round; the next tick resolves it,
  detokenizes the finished slots and frees them.

One thread (``_run``) owns the slot state and calls :meth:`_tick`; HTTP
handler threads only :meth:`submit` and wait on futures. Admission runs
inline in ``_tick`` (the JAX engine's single-thread mode), so tests drive
rounds deterministically by calling ``_tick`` themselves.

The aux worker (its own thread after :meth:`start`, one round per
:meth:`aux_round` in tests) decodes ``temperature > 0`` requests: a
micro-batch of one temperature gets a bucketed encode through the engine's
own encode function and a sampled ``greedy_decode_kv``, with its own caches.
OpenAI's temperature ladder (``temperature_fallback``) sends a result that
fails the compression-ratio or logprob gate there again at the next
temperature, from the slots or from the aux worker itself.

Under a ``mesh`` (tensor parallelism over its MODEL axis) the weights are
split per rank (``parallel.sharding.shard_params``) and the slot caches and
cross-KV are kept per rank over its local heads; slot bookkeeping is one
copy on the lead device. Data parallelism runs across engines, so a mesh
with ``n_data > 1`` is refused.

``language="auto"`` detects a request's language from its cross-KV with one
``[sot]`` decoder step (``decode.detect_language_kv``): on the slot path
once per admission batch that holds an auto row, its language tokens
written into those rows' prompts on the device, with no host read until
harvest; on the aux worker, per micro-batch, read at once. The request keeps
``language="auto"`` (a retried request detects again); the detected code
goes into ``language_resolved`` and the reply's ``language``.

Not ported yet, and refused with ``NotImplementedError``: beams, requests
over 30 s, word timestamps, ``initial_prompt`` / ``condition_on_previous``,
``on_partial`` streaming, timestamps, segmented admission encodes and
adaptive round sizes.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import LANGUAGES, N_SAMPLES
from ..decode import detect_language_kv, encode_cross_kv, extract_texts, greedy_decode_kv
from ..longform import compression_ratio
from ..models.model import (
    Shards,
    Whisper,
    cast_floating,
    check_selections,
    decoder_forward,
    decoder_step_multipos,
    model_shards,
    new_kv_cache,
    shard_values,
)
from ..ops import _build
from ..ops.mel import log_mel_batch
from ..sampling import RuleState, apply_rules, build_suppress_ids
from ..text import postprocess


@dataclass
class Request:
    audio: np.ndarray          # mono f32 @16k, at most 30 s
    language: str = "zh"       # a code, or "auto" (None) to detect it
    task: str = "transcribe"
    beam_size: int = 1         # > 1 is not ported
    # per-request generated-token budget (None = the engine's max_tokens),
    # capped by the engine's bucketed cache
    max_tokens: Optional[int] = None
    # sampling temperature: 0 = greedy slots; t > 0 routes to the aux
    # worker's sampled decode (OpenAI semantics: no beam at t > 0)
    temperature: float = 0.0
    # internal: temperature-ladder attempt counter (0 = first decode)
    _attempt: int = 0
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.perf_counter)
    on_partial: Optional[object] = None  # streaming: not ported
    # engine-enforced deadline (seconds from enqueue; None = no limit).
    # Expired requests fail with TimeoutError and their slot is freed.
    deadline_s: Optional[float] = None
    word_timestamps: bool = False        # not ported
    initial_prompt: Optional[str] = None  # not ported
    condition_on_previous: bool = False  # not ported
    # "auto" requests keep language="auto" (a retried request detects
    # again); the detected code lands here. On the slot path it stays on the
    # device until harvest: _lang_holder is a dict the admission batch
    # shares ({"idx": (bucket,) device tensor}), read once per batch.
    language_resolved: Optional[str] = None
    _lang_holder: Optional[dict] = None
    _lang_row: int = 0

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
    retries_total: int = 0        # temperature-ladder re-decodes
    # aux worker (sampled decodes): micro-batches, and the S=1 decoder steps
    # and encoder passes they ran
    aux_batches_total: int = 0
    aux_steps_total: int = 0
    # language-detection steps (admission and aux batches with an auto row)
    detect_batches_total: int = 0
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
    kv: object                     # prefilled self-KV (bucket rows; Shards under a mesh)
    cross: object                  # cross-KV parts (bucket rows; Shards under a mesh)
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


def _auto(req: Request) -> bool:
    return req.language in (None, "auto")


def _cache_leaves(kv, cross) -> list:
    """Every tensor of a self-KV and a cross-KV, rank by rank: (L, B, ...)
    each, batch on axis 1."""
    return [t for c, x in zip(shard_values(kv), shard_values(cross)) for t in (*c, *x)]


class ContinuousBatchingEngine:
    """Slot-based continuous batching over one model on the model's device,
    or with ``mesh`` split over its MODEL axis. ``model`` is cast to
    ``compute_dtype`` in place. ``encoder_attention`` selects the admission
    encode's attention kernel and ``cross_decode`` the decode step's int8
    cross-attention kernel (see ``models/model.py``).
    ``temperature_fallback`` is the retry ladder (off when empty, as for
    library users of the JAX engine; its server turns it on), and
    ``beam_batch_max`` caps an aux micro-batch."""

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
        beam_batch_max: int = 8,
    ):
        unported = {"timestamps": timestamps, "encode_chunks > 1": encode_chunks > 1,
                    "adaptive_sync": adaptive_sync}
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"not ported to whisper_tpu_torch yet: {', '.join(asked)}")
        check_selections(encoder_attention, cross_decode)
        cfg = model.cfg
        self.mesh = mesh
        if mesh is not None:
            # tensor-parallel placement: weights split per rank, the slot
            # KV/cross caches over each rank's local heads; slot bookkeeping
            # one copy. DP is done ACROSS engines (one per data replica), so
            # shard_params refuses n_data > 1.
            from ..parallel.sharding import shard_params

            model = shard_params(model, mesh)
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
        # OpenAI transcribe's retry ladder: a result failing the compression
        # or logprob criteria (and not silence-gated) is decoded again on the
        # aux worker at the next temperature instead of resolving
        self.temperature_fallback = tuple(temperature_fallback or ())
        self.beam_batch_max = beam_batch_max
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
        shards = model_shards(self.model)
        L, dh, Ta = cfg.n_text_layer, cfg.head_dim_text, cfg.n_audio_ctx
        H = cfg.n_text_head // len(shards)  # each rank's local heads
        cross = []
        for shard in shards:
            if kv_quant:  # int8 payloads + fp32 scales, audio-minor (quantize_cross_kv)
                q8 = dict(dtype=torch.int8, device=shard.device)
                f32 = dict(dtype=torch.float32, device=shard.device)
                cross.append((torch.zeros((L, B, H, dh, Ta), **q8),
                              torch.zeros((L, B, H, 1, dh), **f32),
                              torch.zeros((L, B, H, dh, Ta), **q8),
                              torch.zeros((L, B, H, 1, dh), **f32)))
            else:
                cross.append(tuple(torch.zeros((L, B, H, Ta, dh), dtype=compute_dtype,
                                               device=shard.device) for _ in range(2)))
        self.cross = cross[0] if len(cross) == 1 else Shards(cross)
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
        # the decode thread and the aux worker both bump the gate, retry,
        # request and busy counters: read-modify-writes under this lock
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # aux worker state: FIFO deque guarded by a condition; the worker
        # micro-batches same-temperature runs from the left
        self._aux_pending: "deque[Request]" = deque()
        self._aux_cv = threading.Condition()
        self._aux_thread: Optional[threading.Thread] = None
        self._aux_max_queue = max_queue

    def _new_cache(self, batch: int):
        return new_kv_cache(self.model, batch, self.dt, self.kv_ctx, quant=self.self_kv_quant)

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
            "audio over 30 s": len(req.audio) > N_SAMPLES,
            "word_timestamps": req.word_timestamps,
            "initial_prompt": bool(req.initial_prompt),
            "condition_on_previous": req.condition_on_previous,
            "on_partial streaming": req.on_partial is not None,
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"not ported to whisper_tpu_torch yet: {', '.join(asked)}")
        if not _auto(req):
            self.cfg.sot_sequence(req.language, req.task)  # ValueError on an unknown language
        if req.temperature > 0:
            return self._submit_aux(req)
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

    def _submit_aux(self, req: Request) -> Future:
        with self._aux_cv:
            if len(self._aux_pending) >= self._aux_max_queue:
                raise OverloadedError(f"aux queue full ({self._aux_max_queue} pending requests)")
            self._aux_pending.append(req)
            self._aux_cv.notify()
        return req.future

    def start(self):
        """Build the CUDA kernels (so no request pays for nvcc), then start
        the decode thread and the aux worker."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.build_all()
        self.stats.warmup_seconds = time.perf_counter() - t0
        self._thread = threading.Thread(target=self._run, daemon=True, name="cb-engine")
        self._thread.start()
        self._aux_thread = threading.Thread(target=self._aux_run, daemon=True, name="cb-aux")
        self._aux_thread.start()
        return self

    def stop(self):
        self._stop.set()
        with self._aux_cv:
            self._aux_cv.notify_all()
        for name in ("_thread", "_aux_thread"):
            thread = getattr(self, name)
            if thread is not None:
                thread.join(timeout=30)
                setattr(self, name, None)

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

    def _encode(self, reqs: List[Request], bucket: int):
        """The engine's encode function: the requests' audio zero-padded to
        ``bucket`` rows -> mel -> encoder -> cross-KV (+int8), as the slots
        and the aux worker share it. Only enqueues work on the card."""
        cfg = self.cfg
        audio = np.zeros((bucket, N_SAMPLES), np.float32)
        lengths = np.zeros((bucket,), np.int64)
        for i, r in enumerate(reqs):
            a = np.asarray(r.audio, np.float32)[:N_SAMPLES]
            audio[i, : len(a)] = a
            lengths[i] = len(a)
        mel = log_mel_batch(self._to_dev(audio), self._to_dev(lengths),
                            n_mels=cfg.n_mels)[..., : 2 * cfg.n_audio_ctx]
        return encode_cross_kv(self.model, mel, self.dt, kv_quant=self.kv_quant, w8a8=self.w8a8,
                               encoder_attention=self.encoder_attention)

    def _prepare_batch(self, newcomers: List[Request]) -> _PreparedBatch:
        """Bucketed mel -> encoder -> cross-KV (+int8) -> prefill, then the
        no-speech probability and the first token under the rules. Only
        enqueues work on the card: no host sync."""
        cfg, dt = self.cfg, self.dt
        bucket = _bucket(len(newcomers), self.prefill_buckets)
        cross = self._encode(newcomers, bucket)

        auto = [i for i, r in enumerate(newcomers) if _auto(r)]
        if not cfg.is_multilingual:
            for i in auto:
                newcomers[i].language_resolved = "en"
            auto = []
        # an auto row's language column holds a placeholder until the
        # detected token is written over it below, on the device
        rows = [cfg.sot_sequence("en" if _auto(r) else r.language, r.task) for r in newcomers]
        prompts = np.asarray(rows + rows[:1] * (bucket - len(rows)), np.int64)
        prompts_dev = self._to_dev(prompts)
        if auto:
            idx = self._detect(cross)
            mask = np.zeros((bucket,), bool)
            mask[auto] = True
            prompts_dev[:, 1] = torch.where(self._to_dev(mask), cfg.lang_token_start + idx,
                                            prompts_dev[:, 1])
            holder = {"idx": idx}
            for i in auto:
                newcomers[i]._lang_holder, newcomers[i]._lang_row = holder, i
        logits, kv = decoder_forward(self.model, prompts_dev, 0, self._new_cache(bucket), cross,
                                     dt, cross_decode=self.cross_decode)
        # OpenAI-style no-speech probability: softmax at the sot position
        nsp = torch.softmax(logits[:, 0].to(torch.float32), dim=-1)[:, cfg.no_speech]
        last = apply_rules(logits[:, -1], RuleState.create(bucket, device=self.device), cfg,
                           suppress_ids=self._suppress)
        lp0 = torch.log_softmax(last.to(torch.float32), dim=-1)
        first = torch.argmax(last, dim=-1)
        first_lp = torch.gather(lp0, 1, first[:, None])[:, 0]
        return _PreparedBatch(reqs=newcomers, kv=kv, cross=cross, first=first,
                              first_lp=first_lp, nsp=nsp, prompts=prompts_dev,
                              prompt_len=prompts.shape[1])

    def _detect(self, cross) -> torch.Tensor:
        """Language indices (bucket,) of a batch's cross-KV, on the device."""
        with self._stats_lock:
            self.stats.detect_batches_total += 1
        idx, _ = detect_language_kv(self.model, cross, self.dt, cross_decode=self.cross_decode)
        return idx

    def _effective_language(self, req: Request) -> str:
        """The request's language: explicit, else detected. The slot path's
        detection is read from the device here, at harvest, once for its
        whole admission batch."""
        if not _auto(req):
            return req.language
        if req.language_resolved is None and req._lang_holder is not None:
            holder = req._lang_holder
            if "host" not in holder:
                holder["host"] = holder["idx"].cpu().numpy()
            req.language_resolved = list(LANGUAGES)[int(holder["host"][req._lang_row])]
        return req.language_resolved or "en"

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

        # every rank's caches, each written the same way on its own device
        for dst_t, src_t in zip(_cache_leaves(self.kv, self.cross),
                                _cache_leaves(batch.kv, batch.cross)):
            dst_t.index_copy_(1, dst.to(dst_t.device), src_t.index_select(1, src.to(src_t.device)))
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

    def _quality_gate(self, text: str, nsp: float, avg_lp: float):
        """Harvest-time quality gates (OpenAI transcribe semantics): silence
        unless the decode is confident anyway; compression/logprob failures
        feed the temperature ladder. Shared by the greedy harvest and the
        aux worker. Returns (text, comp, quality_ok, silenced) and bumps the
        gate counters."""
        comp = compression_ratio(text)
        quality_ok = not ((self.compression_ratio_threshold is not None
                           and comp > self.compression_ratio_threshold)
                          or (self.logprob_threshold is not None
                              and avg_lp < self.logprob_threshold))
        silenced = (self.no_speech_threshold is not None and nsp > self.no_speech_threshold
                    and not (self.logprob_threshold is not None
                             and avg_lp > self.logprob_threshold))
        with self._stats_lock:
            self.stats.low_quality_total += not quality_ok
            self.stats.no_speech_total += silenced
        return ("" if silenced else text), comp, quality_ok, silenced

    def _maybe_retry(self, req: Request, quality_ok: bool, silenced: bool) -> bool:
        """OpenAI retry criteria: a repetitive or low-confidence result is
        decoded again at the next ladder temperature (silence is skipped,
        not retried). Returns True if the request went to the aux worker:
        the caller must NOT resolve its future."""
        if quality_ok or silenced or not self.temperature_fallback:
            return False
        # only climb: a request already decoded at t skips rungs <= t
        while (req._attempt < len(self.temperature_fallback)
               and self.temperature_fallback[req._attempt] <= req.temperature):
            req._attempt += 1
        if req._attempt >= len(self.temperature_fallback):
            return False
        if req.future.done() or req.future.cancelled() or req.expired():
            return False
        req.temperature = self.temperature_fallback[req._attempt]
        req._attempt += 1
        with self._stats_lock:
            self.stats.retries_total += 1
        try:
            self._submit_aux(req)
        except OverloadedError:
            return False  # aux queue full: resolve with what we have
        return True

    def _resolve(self, req: Request, text: str, n_tok: int, nsp: float, avg_lp: float,
                 comp: float, quality_ok: bool):
        """Count a finished request and set its reply (from the slots or the
        aux worker)."""
        wall = time.perf_counter() - req.enqueued_at
        audio_s = len(req.audio) / 16000.0
        with self._stats_lock:
            self.stats.requests_total += 1
            self.stats.tokens_total += n_tok
            self.stats.audio_seconds_total += audio_s
        _safe_set_result(req.future, {
            "success": True,
            "text": text,
            "language": self._effective_language(req),
            "audio_seconds": audio_s,
            "wall_seconds": wall,
            "rtf": wall / max(audio_s, 1e-9),
            "tokens": n_tok,
            "temperature": req.temperature,
            "attempts": req._attempt + 1,
            "no_speech_prob": nsp,
            "avg_logprob": avg_lp,
            "compression_ratio": comp,
            "quality_ok": quality_ok,
        })

    def _add_busy(self, seconds: float):
        with self._stats_lock:
            self.stats.busy_seconds_total += seconds

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
            text = postprocess(self.tokenizer.decode(ids).strip(), self._effective_language(req))
            avg_lp = float(fstate_h[i, 0] / max(fstate_h[i, 1], 1.0))
            nsp = float(nsp_h[i])
            text, comp, quality_ok, silenced = self._quality_gate(text, nsp, avg_lp)
            if self._maybe_retry(req, quality_ok, silenced):
                # re-decoding on the aux worker at the next ladder
                # temperature: free the slot, leave the future pending
                self._slot_req[i] = None
                self._slot_prompt_len[i] = 0
                continue
            self._resolve(req, text, int(len(ids)), nsp, avg_lp, comp, quality_ok)
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
        self._add_busy(time.perf_counter() - t0)

    # ------------------------------------------------------------- aux worker
    def _aux_collect(self) -> List[Request]:
        """Take a same-temperature micro-batch (at most ``beam_batch_max``)
        from the left of the aux deque; requests of another temperature keep
        their place."""
        with self._aux_cv:
            batch: List[Request] = []
            keep: List[Request] = []
            now = time.perf_counter()
            while self._aux_pending and len(batch) < self.beam_batch_max:
                r = self._aux_pending.popleft()
                if r.future.cancelled():
                    continue
                if r.expired(now):
                    _safe_set_exception(r.future, TimeoutError(
                        f"deadline {r.deadline_s}s expired in aux queue"))
                    continue
                (batch if not batch or r.temperature == batch[0].temperature
                 else keep).append(r)
            self._aux_pending.extendleft(reversed(keep))
            return batch

    def _run_aux_batch(self, reqs: List[Request]):
        """One micro-batched sampled decode: bucketed encode through
        :meth:`_encode` (int8 cross-KV and the mesh apply), then
        ``greedy_decode_kv`` at the batch's temperature (seed 0, as the JAX
        engine's) with its own caches; results pass the same quality gate as
        the slots' and may climb the ladder again."""
        cfg = self.cfg
        temp = reqs[0].temperature
        buckets = sorted({b for b in self.prefill_buckets if b <= self.beam_batch_max}
                         | {self.beam_batch_max})
        bucket = _bucket(len(reqs), buckets)
        cross = self._encode(reqs, bucket)
        auto = [i for i, r in enumerate(reqs) if _auto(r)]
        # a host read is fine here: the aux worker is off the decode thread
        idx = self._detect(cross).cpu().numpy() if auto and cfg.is_multilingual else None
        for i in auto:
            reqs[i].language_resolved = "en" if idx is None else list(LANGUAGES)[int(idx[i])]
        langs = [self._effective_language(r) for r in reqs]
        rows = [cfg.sot_sequence(lang, r.task) for lang, r in zip(langs, reqs)]
        prompts = np.asarray(rows + rows[:1] * (bucket - len(rows)), np.int64)
        P = prompts.shape[1]
        result = greedy_decode_kv(
            self.model, cross, self._to_dev(prompts), self.dt, max_tokens=self.max_tokens,
            suppress_ids=self._suppress, apply_filters=True, self_kv_quant=self.self_kv_quant,
            cross_decode=self.cross_decode, temperature=float(temp))
        self.stats.aux_batches_total += 1
        self.stats.aux_steps_total += result.steps
        texts = extract_texts(result, P, self.tokenizer)
        lens = result.lengths.cpu().numpy()
        nsp_h = result.no_speech_prob.cpu().numpy()
        lp_h = result.avg_logprob.cpu().numpy()
        for i, r in enumerate(reqs):
            text = postprocess(texts[i], langs[i])
            text, comp, quality_ok, silenced = self._quality_gate(
                text, float(nsp_h[i]), float(lp_h[i]))
            if self._maybe_retry(r, quality_ok, silenced):
                continue  # re-decoding at the next ladder temperature
            self._resolve(r, text, int(max(lens[i] - P, 0)), float(nsp_h[i]), float(lp_h[i]),
                          comp, quality_ok)

    def aux_round(self) -> int:
        """Run one aux micro-batch if any is pending (the aux thread's round,
        for callers that drive the engine themselves, as ``_tick``).
        Returns the number of requests it took."""
        batch = self._aux_collect()
        if batch:
            t0 = time.perf_counter()
            try:
                self._run_aux_batch(batch)
            except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
                for r in batch:
                    _safe_set_exception(r.future, e)
            self._add_busy(time.perf_counter() - t0)
        return len(batch)

    def _aux_run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            with self._aux_cv:
                while not self._aux_pending and not self._stop.is_set():
                    self._aux_cv.wait()
            self.aux_round()

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
