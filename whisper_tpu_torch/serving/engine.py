"""Continuous-batching inference engine: greedy slots, an encode thread, an
aux worker for beams, sampled decodes and the temperature ladder, on one
card or a TP mesh.

Port of ``whisper_tpu/serving/engine.py``. The engine keeps a fixed pool of
``max_slots`` decode slots on the device:

- new requests are prepared ahead of the slots: their mel, encoder,
  cross-KV and prompt prefill run as one bucketed batch (on the encode
  thread after :meth:`start`), and the decode thread copies the resulting
  cross-KV and self-KV into free slots;
- every round advances ALL slots ``steps_per_sync`` tokens (with
  ``adaptive_sync``, 2x or 4x that while every slot is far from its
  budget) with :func:`~whisper_tpu_torch.models.model.decoder_step_multipos`,
  each slot at its own cache offset behind its own masked left pad, without
  reading the device from the host; on the card an engine whose ranks all
  lie on it (one device, or a ``mesh`` whose ranks share the card)
  replays each round size as a CUDA graph (``utils.graphs``), the
  counterpart of the JAX engine's jitted ``lax.scan``, so the slot state
  is only ever written in place;
- after a round, the slot state is packed into one int32 buffer whose copy
  to pinned host memory overlaps the next round; the next tick resolves it,
  streams partial transcripts (``on_partial``), detokenizes the finished
  slots and frees them.

The decode thread (``_run``) owns the slot state and calls :meth:`_tick`;
the encode thread (``_prepare_run``) prepares admission batches into
``_ready``, guarded by ``_ready_cv``; HTTP handler threads only
:meth:`submit` and wait on futures. Both threads enqueue on the device's one
stream, so a prepared batch's work is ordered before the copy that admits
it. An engine that was not started prepares inline in ``_tick``, so tests
drive rounds deterministically by calling ``_tick`` themselves. With
``encode_chunks > 1`` the admission encoder runs as that many layer groups,
paced while slots decode so decode rounds reach the card between them.

Prompts are right-aligned ``[pad..., sot_prev, context..., sot sequence]``
rows: ``initial_prompt`` (and, for a request over 30 s with
``condition_on_previous``, the transcript so far) rides as context behind a
per-slot masked pad. ``timestamps`` drops ``<|notimestamps|>`` and runs the
timestamp grammar. A request over 30 s is split into overlapping windows
that decode as ordinary requests (one after another, each prompted with the
text so far, under ``condition_on_previous``) and are merged
(``longform.merge_transcripts``).

The aux worker (its own thread after :meth:`start`, one round per
:meth:`aux_round` in tests) decodes ``beam_size > 1`` and ``temperature >
0`` requests (the JAX engine's beam worker): a micro-batch of one effective
beam size, temperature and context width gets a bucketed encode through the
engine's own encode function, then ``beam.beam_search_kv`` (t = 0, K > 1,
with ``length_penalty``) or a sampled ``greedy_decode_kv`` (t > 0: beams
only at t = 0, as in OpenAI's decoder, so a retried beam request samples
one beam), with its own caches; on the card their rounds replay the
model's CUDA graphs (``decode.capturable``: one device, or a mesh whose
ranks all lie on the card), captured at each key's first use on the aux
thread while the decode thread replays the step rounds.
``max_beam_size`` caps a request's K.
OpenAI's temperature ladder (``temperature_fallback``) sends a result that
fails the compression-ratio or logprob gate there again at the next
temperature, from the slots or from the aux worker itself.

Under a ``mesh`` (tensor parallelism over its MODEL axis) the weights are
split per rank (``parallel.sharding.shard_params``) and the slot caches and
cross-KV are kept per rank over its local heads; slot bookkeeping is one
copy on the lead device. A mesh with ``n_data > 1`` is taken as the JAX
engine takes it: there every data row holds the slots and their
bookkeeping replicated and computes the same thing, so here the engine
runs on data row 0 alone (``mesh.devices[0, :]``) and gives the same
outputs. Where every rank of that row lies on one card, the step rounds
and the aux worker's loops are captured as on one device; over distinct
cards they run uncaptured. Data parallelism proper runs across engines behind the router
(``serving/router.py``, ``--dp``).

``language="auto"`` detects a request's language from its cross-KV with one
``[sot]`` decoder step (``decode.detect_language_kv``): on the slot path
once per admission batch that holds an auto row, its language tokens
written into those rows' prompts on the device, with no host read until
harvest; on the aux worker, per micro-batch, read at once. The request keeps
``language="auto"`` (a retried request detects again); the detected code
goes into ``language_resolved`` and the reply's ``language``.

``word_timestamps`` adds word timings to a reply (``words``): a finished
request's decoded sequence and a copy of its cross-KV go to the align
worker (its own thread, started by the first such request), which
micro-batches up to ``align_batch_max`` queued jobs into one
``align.alignment_matrix`` pass (the batch a power-of-two bucket padded with
the first job's cross-KV, S bucketed to a multiple of 32), then runs the DTW
and word grouping on the host and resolves the futures. The slots' cross-KV
is rewritten in place when a slot is re-admitted, so the harvest copies a
slot's cross-KV before freeing it. Replies of the aux worker (beams, sampled
decodes, ladder retries) are aligned the same way, and a request over 30 s
gets its windows' words merged. A failed alignment answers ``words: None``
with ``align_error``; the worker keeps serving.

:meth:`warmup` (run by :meth:`start` unless ``warm_start=False``) builds the
kernels and runs, while no slot is active, every program of the slot path
once at each shape it takes: the step round at each round size, the harvest
pack, and prepare (mel, encoder, cross-KV, detection, prefill) and admit for
every prefill bucket; the step round's first run at a size captures its
graph. Each (program, shape) key's first run counts in
``EngineStats.cold_compiles_total``; after a warm start a greedy burst
moves it no more.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..align import alignment_head_mask, alignment_matrix, dequantize_cross_kv, row_words
from ..beam import beam_search_kv
from ..config import LANGUAGES, N_SAMPLES
from ..decode import (
    capturable,
    detect_language_kv,
    encode_cross_kv,
    extract_texts,
    greedy_decode_kv,
)
from ..longform import (
    _bucket_prev,
    compression_ratio,
    merge_texts,
    merge_transcripts,
    split_audio,
)
from ..models.model import (
    Shards,
    Whisper,
    _pack,
    cast_floating,
    check_selections,
    compute_cross_kv,
    decoder_forward,
    decoder_step_multipos,
    encoder_blocks,
    encoder_post,
    encoder_stem,
    model_shards,
    new_kv_cache,
    quantize_cross_kv,
    shard_values,
)
from ..ops import _build
from ..ops.mel import log_mel_batch
from ..sampling import RuleState, apply_rules, build_suppress_ids
from ..text import postprocess
from ..utils.graphs import GraphSet


@dataclass
class Request:
    audio: np.ndarray          # mono f32 @16k; over 30 s is split into windows
    language: str = "zh"       # a code, or "auto" (None) to detect it
    task: str = "transcribe"
    beam_size: int = 1         # > 1: beam search on the aux worker
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
    # on the same clock: when the encode thread took it into an admission
    # batch, and when that batch's row was copied into a slot (None before)
    taken_at: Optional[float] = None
    admitted_at: Optional[float] = None
    # streaming: called with the partial transcript after each sync round
    on_partial: Optional[object] = None  # Callable[[str], None]
    # engine-enforced deadline (seconds from enqueue; None = no limit).
    # Expired requests fail with TimeoutError and their slot is freed.
    deadline_s: Optional[float] = None
    # per-word timings (align.py), from one teacher-forced pass over the
    # finished sequence on the align worker
    word_timestamps: bool = False
    # OpenAI's initial_prompt: free text prepended as [sot_prev, tokens]
    # context, trimmed to n_text_ctx // 2 - 1 tokens (and to the slot
    # cache), right-aligned behind a masked left pad. For a request over
    # 30 s it seeds window 0; with condition_on_previous the windows decode
    # one after another, each prompted with the transcript so far
    initial_prompt: Optional[str] = None
    condition_on_previous: bool = False
    _prompt_ids: Optional[list] = None   # memoized context token ids
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
    # aux worker (beams and sampled decodes): micro-batches, and the S=1
    # decoder steps they ran
    aux_batches_total: int = 0
    aux_steps_total: int = 0
    beam_requests_total: int = 0  # requests served by beam search (K > 1)
    align_total: int = 0          # word-timestamp alignments completed
    align_batches_total: int = 0  # micro-batched alignment passes run
    # language-detection steps (admission and aux batches with an auto row)
    detect_batches_total: int = 0
    # host-side phase breakdown of busy time: eager launches return before
    # the card finishes, so admit/step measure enqueue cost and the card's
    # execution pools into harvest_seconds_total at its one sync per tick,
    # which holds card_wait_seconds_total
    admit_seconds_total: float = 0.0
    step_seconds_total: float = 0.0
    harvest_seconds_total: float = 0.0
    card_wait_seconds_total: float = 0.0  # the decode thread blocked on a round's copy
    ticks_total: int = 0          # sync rounds run
    steps_total: int = 0          # decode steps stepped over all slots
    # admission encode + prefill: on the encode thread after start(), so
    # outside busy time; inline in _tick (inside step_seconds) without it
    encode_seconds_total: float = 0.0
    encode_batches_total: int = 0
    prepared_depth: int = 0       # requests encoded+prefilled awaiting a slot
    warmup_seconds: float = 0.0   # warmup(): the kernels' build and the warm runs
    # first runs of a (program, shape) key (see _first_run): the port
    # compiles no XLA, so what a cold key costs is the first launch on the
    # card (lazy module load, cuBLAS heuristics, the allocator's growth);
    # unchanged by a greedy burst after warmup()
    cold_compiles_total: int = 0
    # decode rounds by their size in steps (adaptive_sync: base, 2x, 4x)
    round_sizes: Dict[str, int] = field(default_factory=dict)
    partials_total: int = 0       # on_partial calls made
    # slot requests' lifecycle, each wait summed over the count after it:
    # enqueue to being taken into an admission batch (over prepared_total),
    # the batch being prepared to the request's copy into a slot (over
    # admitted_total), enqueue to the first harvest that shows one of its
    # tokens (over first_tokens_total)
    queue_wait_seconds_total: float = 0.0
    prepared_total: int = 0
    ready_wait_seconds_total: float = 0.0
    admitted_total: int = 0
    first_token_seconds_total: float = 0.0
    first_tokens_total: int = 0
    # occupied slots x the round's steps, summed over rounds: the slots'
    # occupancy is slot_steps_total / (steps_total x max_slots)
    slot_steps_total: int = 0

    def snapshot(self) -> dict:
        d = dict(self.__dict__)
        d["round_sizes"] = dict(self.round_sizes)
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
    pads: np.ndarray               # (bucket,) masked left pad of each row
    consumed: int = 0              # rows already copied into slots
    ready_at: float = 0.0          # when it joined _ready (time.perf_counter)


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


class _SegmentClock:
    """Durations of consecutive stretches of enqueued work: CUDA events on
    the card (waited for by :meth:`seconds`), the host clock on the CPU,
    whose work runs as it is enqueued."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = [self._now()]

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def mark(self):
        self.marks.append(self._now())

    def seconds(self) -> List[float]:
        pairs = list(zip(self.marks, self.marks[1:]))
        if not self.cuda:
            return [b - a for a, b in pairs]
        self.marks[-1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in pairs]


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
    library users of the JAX engine; its server turns it on),
    ``beam_batch_max`` caps an aux micro-batch, ``max_beam_size`` a
    request's beam size, and ``length_penalty`` is the beams' GoogleNMT
    alpha (None: mean log-prob). ``timestamps`` decodes with
    timestamp tokens; ``encode_chunks`` splits the admission encoder into
    that many layer groups; ``adaptive_sync`` sizes rounds at 1, 2 or 4
    times ``steps_per_sync``; ``longform_overlap_s`` is the overlap of the
    windows a request over 30 s is split into. ``prefill_buckets`` are the
    admission batch sizes (those above ``max_slots`` dropped);
    ``apply_filters=False`` drops the suppress rules (the timestamp grammar
    stays with ``timestamps``); ``warm_start`` (None: ``WARM_START_DEFAULT``)
    makes :meth:`start` run :meth:`warmup`."""

    # start()'s warm default when the constructor's warm_start is None
    WARM_START_DEFAULT = True

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
        longform_overlap_s: float = 2.0,
        max_beam_size: int = 8,
        length_penalty: Optional[float] = None,
        align_batch_max: int = 8,
        prefill_buckets: Sequence[int] = PREFILL_BUCKETS,
        apply_filters: bool = True,
        warm_start: Optional[bool] = None,
    ):
        check_selections(encoder_attention, cross_decode)
        cfg = model.cfg
        self.mesh = mesh
        if mesh is not None:
            # tensor-parallel placement: weights split per rank, the slot
            # KV/cross caches over each rank's local heads; slot bookkeeping
            # one copy. Data rows past the first would only repeat row 0's
            # work (JAX replicates the slots over DATA): row 0 runs it
            from ..parallel.sharding import Mesh, shard_params

            model = shard_params(model, Mesh(mesh.devices[:1], mesh.axis_names))
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.dt = compute_dtype
        self.device = model.device
        self.B = B = max_slots
        self.steps_per_sync = steps_per_sync
        # a round grows to 2x / 4x steps_per_sync while EVERY active slot
        # still needs that many tokens (off by default, as in JAX)
        self.adaptive_sync = adaptive_sync
        self.timestamps = timestamps
        self.prefill_buckets = tuple(b for b in prefill_buckets if b <= max_slots) or (max_slots,)
        self.apply_filters = apply_filters
        # the rules run where the JAX engine's use_rules runs them
        self._use_rules = apply_filters or timestamps
        self.warm_start = self.WARM_START_DEFAULT if warm_start is None else warm_start
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
        self.max_beam_size = max_beam_size
        self.length_penalty = length_penalty
        # while slots are decoding, at most this many newcomers encode per
        # round, so one admission stalls the active slots by a small encoder
        # pass; an idle engine admits whole buckets
        self.admit_chunk = admit_chunk or max(1, max_slots // 4)
        # > 1 splits the admission encoder into that many layer groups; with
        # slots decoding, the encode thread waits about each group's measured
        # time before enqueueing the next, so decode rounds run between them
        self.encode_chunks = max(1, min(encode_chunks, cfg.n_audio_layer))
        self._encode_seg_est: Dict[int, List[float]] = {}  # bucket -> seconds a group
        # requests over 30 s split into windows this many samples apart
        self.longform_overlap = int(longform_overlap_s * 16000)
        self.model = cast_floating(model, compute_dtype)
        self._suppress = (torch.as_tensor(build_suppress_ids(cfg, tokenizer), dtype=torch.int64,
                                          device=self.device) if apply_filters else None)

        T = cfg.n_text_ctx
        dev = self.device
        # the sot sequences are <= 4 tokens and a context prompt is capped to
        # fit (_context_ids), so a token budget bounds every cache write: the
        # cache holds only the reachable positions, rounded up to 128
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
        # per-slot masked left pad: a prompt's context rides right-aligned,
        # its pad positions out of attention and positional indexing
        self.pads = torch.zeros((B,), dtype=torch.int64, device=dev)
        # the step rounds' CUDA graphs, by size (every rank's launches in one
        # graph where the ranks share the card; None over distinct cards and
        # on the CPU): they read and write the slot state above, and every
        # rank's caches, in place, so nothing may rebind them
        self._graphs = GraphSet(dev) if capturable(self.model, dev) else None

        # host-side slot bookkeeping
        self._slot_req: List[Optional[Request]] = [None] * B
        self._slot_prompt_len: List[int] = [0] * B
        self._slot_pad: List[int] = [0] * B
        # host mirrors for adaptive round sizes: each slot's token limit (set
        # at scatter) and the last resolved offsets (one round stale; -1 done)
        self._slot_limit_h = np.full((B,), self.kv_ctx, np.int64)
        self._last_offs_h: Optional[np.ndarray] = None
        # slots admitted since their last harvest: the next one shows the
        # request's first token
        self._slot_unseen = np.zeros((B,), bool)
        # steps of the round in flight: the sizing discounts what was really
        # dispatched, not steps_per_sync
        self._last_round_steps = steps_per_sync
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
        # prepared batches awaiting slots (written by the encode thread, read
        # by the decode thread) and the count of their requests, under
        # _ready_cv; at most one slot pool's worth is prepared ahead
        self._ready: "deque[_PreparedBatch]" = deque()
        self._ready_cv = threading.Condition()
        self._prepared_reqs = 0
        self._encode_thread: Optional[threading.Thread] = None
        # (pinned host copy, its CUDA event or None, _slot_gen at pack) of
        # the last round; resolved at the start of the next tick
        self._inflight_harvest = None
        self.stats = EngineStats()
        self._warm_keys: set = set()  # (program, shape) keys run at least once
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
        # word-timestamp align worker (its thread started by the first job):
        # queued jobs are micro-batched into one bucketed alignment pass
        self._align_q: "deque[tuple]" = deque()
        self._align_cv = threading.Condition()
        self._align_thread: Optional[threading.Thread] = None
        self.align_batch_max = align_batch_max
        self._align_mask: Optional[torch.Tensor] = None  # (L, H) alignment heads, made once

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
        if req.beam_size > self.max_beam_size:
            raise ValueError(f"beam_size {req.beam_size} exceeds the engine cap "
                             f"{self.max_beam_size}")
        if not (0.0 <= req.temperature <= 2.0):
            raise ValueError(f"temperature {req.temperature} not in [0, 2]")
        if req.task not in ("transcribe", "translate"):
            raise ValueError(f"bad task {req.task!r}")
        if not _auto(req):
            self.cfg.sot_sequence(req.language, req.task)  # ValueError on an unknown language
        if len(req.audio) > N_SAMPLES:
            return self._submit_longform(req)
        return self._enqueue(req)

    def _enqueue(self, req: Request) -> Future:
        """A request of at most 30 s to the slots' queue, or (beams, t > 0)
        to the aux worker; OverloadedError when that queue is full."""
        if req.beam_size > 1 or req.temperature > 0:
            return self._submit_aux(req)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise OverloadedError(f"queue full ({self._queue.maxsize} pending requests)") from None
        self.stats.queue_depth = self._queue.qsize() + len(self._pending)
        return req.future

    def _window(self, req: Request, audio: np.ndarray, language: Optional[str],
                initial_prompt: Optional[str]) -> Request:
        """One window of a request over 30 s, as an ordinary request whose
        deadline counts from the parent's arrival."""
        child = Request(audio=audio, language=language, task=req.task,
                        deadline_s=req.deadline_s, beam_size=req.beam_size,
                        temperature=req.temperature, word_timestamps=req.word_timestamps,
                        initial_prompt=initial_prompt)
        child.enqueued_at = req.enqueued_at
        return child

    def _merged_reply(self, req: Request, results: List[dict], lang: str, **extra) -> dict:
        """The reply of a request over 30 s from its windows' replies."""
        merged = merge_transcripts(results, (N_SAMPLES - self.longform_overlap) / 16000.0,
                                   self.longform_overlap / 16000.0, lang)
        wall = time.perf_counter() - req.enqueued_at
        audio_s = len(req.audio) / 16000.0
        lps = [r["avg_logprob"] for r in results]
        reply = {"success": True, "text": merged["text"], "language": lang,
                 "audio_seconds": audio_s, "wall_seconds": wall,
                 "rtf": wall / max(audio_s, 1e-9), "windows": len(results), **extra,
                 "tokens": int(sum(r.get("tokens", 0) for r in results)),
                 "no_speech_prob": max(r["no_speech_prob"] for r in results),
                 "avg_logprob": float(sum(lps) / len(lps)),
                 "compression_ratio": max(r["compression_ratio"] for r in results),
                 "quality_ok": all(r["quality_ok"] for r in results)}
        # the merged words when every window has its list; a conditioned
        # request answers an empty list otherwise, a fanned-out one none
        if req.word_timestamps and ("words" in merged or extra.get("conditioned")):
            reply["words"] = merged.get("words", [])
        return reply

    def _submit_longform(self, req: Request) -> Future:
        """Split a request over 30 s into overlapping 30 s windows submitted
        as ordinary requests; the parent future resolves with the merged
        transcript. Each window passes the quality gates on its own, so
        silent stretches drop out. The windows' callbacks run where their
        futures resolve: on the decode thread or the aux worker."""
        waves, _ = split_audio(req.audio, N_SAMPLES, self.longform_overlap)
        n = len(waves)
        if req.condition_on_previous and n > 1:
            return self._submit_longform_conditioned(req, waves)
        children: List[Request] = []
        lock = threading.Lock()
        results: List[Optional[dict]] = [None] * n

        def effective_lang() -> str:
            if not _auto(children[0]):
                return children[0].language
            return next((c.language_resolved for c in children if c.language_resolved), "en")

        def partial_for(i: int, text: str):
            if req.on_partial is None:
                return
            with lock:
                prefix = ["" if results[j] is None else results[j]["text"] for j in range(i)]
            try:
                req.on_partial(merge_texts(prefix + [text], effective_lang()))
            except Exception:  # noqa: BLE001 — a dead consumer stops its stream
                req.on_partial = None

        def on_child_done(i: int, fut: Future):
            if req.future.cancelled():
                for c in children:
                    c.cancel()
                return
            if req.future.done():
                return
            exc = fut.exception() if not fut.cancelled() else None
            if fut.cancelled() or exc is not None:
                for c in children:
                    c.cancel()
                if exc is not None:
                    _safe_set_exception(req.future, exc)
                else:
                    req.future.cancel()
                return
            with lock:
                results[i] = fut.result()
                done = all(r is not None for r in results)
            if done:
                _safe_set_result(req.future, self._merged_reply(req, results, effective_lang()))

        if self._queue.maxsize and self._queue.qsize() + n > self._queue.maxsize:
            raise OverloadedError(f"queue full ({self._queue.maxsize} pending requests; "
                                  f"the request needs {n} windows)")
        for i, w in enumerate(waves):
            # a user initial_prompt seeds window 0 only, as OpenAI seeds once
            child = self._window(req, w, req.language, req.initial_prompt if i == 0 else None)
            if req.on_partial is not None:
                child.on_partial = functools.partial(partial_for, i)
            children.append(child)
        for i, child in enumerate(children):
            child.future.add_done_callback(functools.partial(on_child_done, i))
            try:
                self._enqueue(child)
            except OverloadedError as e:
                for c in children:
                    c.cancel()
                _safe_set_exception(req.future, e)
                raise
        return req.future

    def _submit_longform_conditioned(self, req: Request, waves: List[np.ndarray]) -> Future:
        """Windows decoded one after another, window i + 1 prompted with the
        transcript so far (after any initial_prompt), as the offline seek
        loop's condition-on-previous-text; the first window's detected
        language carries to the rest. Window i + 1 is submitted from window
        i's callback, on the decode thread: a full queue fails the parent."""
        n = len(waves)
        results: List[Optional[dict]] = [None] * n
        lang_box = {"lang": req.language}

        def context_for(i: int) -> Optional[str]:
            parts = [req.initial_prompt.strip()] if req.initial_prompt else []
            parts += [results[j]["text"] for j in range(i) if results[j]["text"]]
            return " ".join(p for p in parts if p).strip() or None

        def submit_window(i: int):
            child = self._window(req, waves[i], lang_box["lang"], context_for(i))
            if req.on_partial is not None:
                prefix = [results[j]["text"] for j in range(i)]

                def relay(text, _prefix=prefix):
                    try:
                        req.on_partial(merge_texts(_prefix + [text], lang_box["lang"] or "en"))
                    except Exception:  # noqa: BLE001 — a dead consumer stops its stream
                        req.on_partial = None
                child.on_partial = relay
            child.future.add_done_callback(functools.partial(on_window_done, i))
            try:
                self._enqueue(child)
            except OverloadedError as e:
                _safe_set_exception(req.future, e)

        def on_window_done(i: int, fut: Future):
            if req.future.done():
                return
            exc = fut.exception() if not fut.cancelled() else None
            if fut.cancelled() or exc is not None:
                if exc is not None:
                    _safe_set_exception(req.future, exc)
                else:
                    req.future.cancel()
                return
            results[i] = fut.result()
            # one utterance keeps one language: the detected one carries on
            if lang_box["lang"] in (None, "", "auto"):
                lang_box["lang"] = results[i].get("language") or lang_box["lang"]
            if i + 1 < n:
                submit_window(i + 1)
                return
            lang = lang_box["lang"]
            if lang in (None, "", "auto"):
                lang = next((r.get("language") for r in results if r.get("language")), "en")
            _safe_set_result(req.future, self._merged_reply(req, results, lang,
                                                            conditioned=True))

        submit_window(0)
        return req.future

    def transcribe(self, audio: np.ndarray, language: str = "zh", task: str = "transcribe",
                   timeout: Optional[float] = 120.0, beam_size: int = 1) -> dict:
        fut = self.submit(Request(audio=audio, language=language, task=task,
                                  beam_size=beam_size))
        return fut.result(timeout=timeout)

    def transcribe_beam(self, audio: np.ndarray, language: str = "zh",
                        task: str = "transcribe", beam_size: int = 5,
                        timeout: Optional[float] = 120.0) -> dict:
        return self.transcribe(audio, language=language, task=task, timeout=timeout,
                               beam_size=beam_size)

    def _submit_aux(self, req: Request) -> Future:
        with self._aux_cv:
            if len(self._aux_pending) >= self._aux_max_queue:
                raise OverloadedError(f"aux queue full ({self._aux_max_queue} pending requests)")
            self._aux_pending.append(req)
            self._aux_cv.notify()
        return req.future

    def _first_run(self, key: tuple) -> None:
        """Count the first run of a (program, shape) key (the JAX engine's
        ``_traced_call`` keys: ``("step", n)``, ``("pack",)``, ``("prepare",
        bucket, context width)``, ``("admit", bucket, P)``, the aux worker's
        ``("aux_encode", bucket)``, ``("aux_detect", bucket)``,
        ``("aux_sampled", bucket, t, width)``, ``("aux_beam", bucket, K,
        width)`` and ``("align", batch, S)``)."""
        if key in self._warm_keys:
            return
        with self._stats_lock:
            if key not in self._warm_keys:
                self._warm_keys.add(key)
                self.stats.cold_compiles_total += 1

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Run the slot path's programs once at every shape the slots reach,
        on the calling thread, while no slot is active: build the kernels
        (on the card), run the step round at each round size
        (``steps_per_sync``, and 2x and 4x under ``adaptive_sync``; on the
        card this run is a size's warm-up and graph capture), the
        harvest pack and its copy to the host, and prepare (on dummy
        requests: ``language="auto"`` and ``"en"`` in turn on a multilingual
        model, so detection runs) and admit for each bucket of ``buckets``
        (default ``prefill_buckets``); with ``encode_chunks > 1`` a second
        encode of each bucket, past first-use costs, times its layer
        groups.

        The slot bookkeeping is left bit-equal (tokens, offsets, active,
        done, limit, rule state, fstate, nsp, pads): an inactive slot's step
        keeps its state (``step_ok`` is false), and the admit copies zero
        rows, so it writes nothing and clips no index. The one write is the
        step's self-KV at ``clamp(offset - 1, 0)`` of every empty slot;
        admission overwrites a slot's whole self-KV and cross-KV row before
        it is read. Every counter but ``warmup_seconds`` and
        ``cold_compiles_total`` is restored. The aux worker's programs (a
        caller-chosen beam size or temperature) still run cold."""
        if any(r is not None for r in self._slot_req):
            raise RuntimeError("warmup() runs only while no slot is active")
        t0 = time.perf_counter()
        counters = copy.deepcopy(self.stats)
        if self.device.type == "cuda":
            _build.build_all()
        sizes = [self.steps_per_sync]
        if self.adaptive_sync:
            sizes += [2 * self.steps_per_sync, 4 * self.steps_per_sync]
        for n in sizes:
            self._steps(n)
        pending = self._inflight_harvest  # an idle engine's last pack: harvested next tick
        self._start_harvest_copy()
        _, event, _ = self._inflight_harvest
        if event is not None:
            event.synchronize()
        self._inflight_harvest = pending
        for b in buckets or self.prefill_buckets:
            dummies = [Request(audio=np.zeros(1600, np.float32),
                               language="auto" if i % 2 == 0 and self.cfg.is_multilingual
                               else "en") for i in range(b)]
            batch = self._prepare_batch(dummies)
            self._scatter_rows(batch, [], [])
            if self.encode_chunks > 1:
                bucket = batch.first.shape[0]
                self._encode_seg_est.pop(bucket, None)
                self._encode(dummies, bucket)
        for shard in model_shards(self.model):
            if shard.device.type == "cuda":
                torch.cuda.synchronize(shard.device)
        for f in dataclasses.fields(EngineStats):
            if f.name not in ("cold_compiles_total", "warmup_seconds"):
                setattr(self.stats, f.name, getattr(counters, f.name))
        self.stats.warmup_seconds = time.perf_counter() - t0
        return self

    def start(self, warm: Optional[bool] = None):
        """Run :meth:`warmup` (when ``warm``, default ``warm_start``; without
        it the kernels build at first use), then start the decode thread,
        the encode thread and the aux worker."""
        if self.warm_start if warm is None else warm:
            self.warmup()
        for name, target, tag in (("_thread", self._run, "cb-engine"),
                                  ("_encode_thread", self._prepare_run, "cb-encode"),
                                  ("_aux_thread", self._aux_run, "cb-aux")):
            setattr(self, name, threading.Thread(target=target, daemon=True, name=tag))
            getattr(self, name).start()
        return self

    def stop(self):
        self._stop.set()
        for cv in (self._aux_cv, self._ready_cv, self._align_cv):
            with cv:
                cv.notify_all()
        for name in ("_thread", "_encode_thread", "_aux_thread", "_align_thread"):
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

    def _prepare_pending_once(self, block: bool = False) -> bool:
        """One encode-thread iteration: take pending requests (bounded by the
        bucket size, admit_chunk while slots are active, and one slot pool's
        worth prepared ahead), run mel + encoder + cross-KV + prefill, and
        queue a _PreparedBatch for the decode thread. ``block`` (the encode
        thread) waits briefly for a request. Returns True if a batch was
        prepared."""
        if block and not self._pending:
            try:
                self._pending.append(self._queue.get(timeout=0.05))
            except queue.Empty:
                return False
        self._drain_queue()
        with self._ready_cv:
            ahead = self._prepared_reqs
        cap = min(max(self.prefill_buckets), self.B - ahead)
        if cap <= 0:
            if block:
                time.sleep(0.002)  # the prepared-ahead cap is reached: don't spin
            return False
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
            r.taken_at = now
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
        batch.ready_at = time.perf_counter()
        with self._ready_cv:
            self._ready.append(batch)
            self._prepared_reqs += len(newcomers)
            self.stats.prepared_depth = self._prepared_reqs
            self._ready_cv.notify_all()
        self.stats.encode_seconds_total += time.perf_counter() - t0
        self.stats.encode_batches_total += 1
        self.stats.prepared_total += len(newcomers)
        self.stats.queue_wait_seconds_total += sum(r.taken_at - r.enqueued_at for r in newcomers)
        return True

    def _prepare_run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            self._prepare_pending_once(block=True)

    @functools.cached_property
    def _encode_seg_fns(self) -> list:
        """The admission encode as ``encode_chunks`` groups of encoder layers
        split at ``round(i * L / n)``: the first runs the conv stem, the last
        ``ln_post`` and the cross-KV (+ int8), so their composition is the
        monolithic encode op for op."""
        n, L = self.encode_chunks, self.cfg.n_audio_layer
        bounds = [round(i * L / n) for i in range(n + 1)]
        kw = dict(w8a8=self.w8a8, attn=self.encoder_attention)

        def group(i):
            def run(x):
                if i == 0:
                    x = encoder_stem(self.model, x, self.dt)
                x = encoder_blocks(self.model, x, self.dt, bounds[i], bounds[i + 1], **kw)
                if i < n - 1:
                    return x
                cross = compute_cross_kv(self.model, encoder_post(self.model, x), self.dt)
                return quantize_cross_kv(cross) if self.kv_quant else cross
            return run

        return [group(i) for i in range(n)]

    def _encode(self, reqs: List[Request], bucket: int):
        """The engine's encode function: the requests' audio zero-padded to
        ``bucket`` rows -> mel -> encoder -> cross-KV (+int8), as the slots
        and the aux worker share it. Only enqueues work on the card, except
        that the first segmented encode of a bucket on an idle engine waits
        for each group to time it.

        With ``encode_chunks > 1`` the encoder runs group by group; while
        slots are decoding, the thread sleeps about 0.9 of the group in
        flight's time before enqueueing the next, so the decode thread's
        round reaches the stream between them. The times are measured once a
        bucket while no slot is active (CUDA events; host clock on the CPU),
        never with slots active."""
        cfg = self.cfg
        audio = np.zeros((bucket, N_SAMPLES), np.float32)
        lengths = np.zeros((bucket,), np.int64)
        for i, r in enumerate(reqs):
            a = np.asarray(r.audio, np.float32)[:N_SAMPLES]
            audio[i, : len(a)] = a
            lengths[i] = len(a)
        segmented = self.encode_chunks > 1
        est = self._encode_seg_est.get(bucket)
        active = self.stats.active_slots > 0
        clock = _SegmentClock(self.device) if segmented and est is None and not active else None
        h = log_mel_batch(self._to_dev(audio), self._to_dev(lengths),
                          n_mels=cfg.n_mels)[..., : 2 * cfg.n_audio_ctx]
        if not segmented:
            return encode_cross_kv(self.model, h, self.dt, kv_quant=self.kv_quant,
                                   w8a8=self.w8a8, encoder_attention=self.encoder_attention)
        for i, fn in enumerate(self._encode_seg_fns):
            if i and active and est is not None:
                time.sleep(est[i - 1] * 0.9)
            h = fn(h)
            if clock is not None:
                clock.mark()
        if clock is not None:
            self._encode_seg_est[bucket] = clock.seconds()
        return h

    def _context_ids(self, r: Request) -> list:
        """The request's initial_prompt as context token ids, memoized on the
        request (a retried request keeps its conditioning). OpenAI trims the
        context to n_text_ctx // 2 - 1 tokens; it is also capped so that
        [sot_prev, context, sot sequence] and 8 generated tokens fit the
        slot cache."""
        if r._prompt_ids is None:
            ids: list = []
            txt = (r.initial_prompt or "").strip()
            if txt and hasattr(self.tokenizer, "encode"):
                cap = min(self.cfg.n_text_ctx // 2 - 1, max(self.kv_ctx - 13, 0))
                if cap > 0:
                    ids = [int(t) for t in self.tokenizer.encode(" " + txt)[-cap:]]
            r._prompt_ids = ids
        return r._prompt_ids

    def _prev_width(self, ctx_lens) -> int:
        """A batch's shared context width (0: no context): the long-form
        prompt buckets, clamped so the prompt fits the slot cache."""
        longest = max(ctx_lens)
        if longest == 0:
            return 0
        return min(_bucket_prev(longest), max(self.kv_ctx - 13, longest))

    def _prompt_rows(self, reqs: List[Request], langs: List[str], prev_w: int, bucket: int):
        """Right-aligned prompt rows over one width: ``[pad..., sot_prev,
        context..., sot, lang, task(, notimestamps)]``, the pad masked out of
        attention and positions (a row without context keeps its pad at
        sot); rows past ``reqs`` repeat row 0. Returns (prompts (bucket, P)
        int64, pads (bucket,) int64, sot_index)."""
        cfg = self.cfg
        seqs = [list(cfg.sot_sequence(lang, r.task)) for lang, r in zip(langs, reqs)]
        if self.timestamps:
            seqs = [seq[:-1] for seq in seqs]  # no <|notimestamps|>
        P0 = len(seqs[0])
        P = 1 + prev_w + P0 if prev_w else P0
        prompts = np.full((bucket, P), cfg.eot, np.int64)
        pads = np.full((bucket,), P - P0, np.int64)
        for i, (r, seq) in enumerate(zip(reqs, seqs)):
            prompts[i, -P0:] = seq
            t = self._context_ids(r)[-prev_w:] if prev_w else []
            if t:
                pads[i] = prev_w - len(t)
                prompts[i, pads[i]] = cfg.sot_prev
                prompts[i, pads[i] + 1: pads[i] + 1 + len(t)] = t
        prompts[len(reqs):] = prompts[0]
        pads[len(reqs):] = pads[0]
        return prompts, pads, P - P0

    def _prepare_batch(self, newcomers: List[Request]) -> _PreparedBatch:
        """Bucketed mel -> encoder -> cross-KV (+int8) -> prefill of the
        right-aligned prompts, then the no-speech probability at the shared
        sot column and the first token under the rules. Only enqueues work
        on the card: no host sync."""
        with record_function("whisper.engine.prepare"):
            cfg, dt = self.cfg, self.dt
            bucket = _bucket(len(newcomers), self.prefill_buckets)
            prev_w = self._prev_width([len(self._context_ids(r)) for r in newcomers])
            cross = self._encode(newcomers, bucket)

            auto = [i for i, r in enumerate(newcomers) if _auto(r)]
            if not cfg.is_multilingual:
                for i in auto:
                    newcomers[i].language_resolved = "en"
                auto = []
            # an auto row's language column holds a placeholder until the
            # detected token is written over it below, on the device
            langs = ["en" if _auto(r) else r.language for r in newcomers]
            prompts, pads, sot_index = self._prompt_rows(newcomers, langs, prev_w, bucket)
            prompts_dev = self._to_dev(prompts)
            if auto:
                idx = self._detect(cross)
                mask = np.zeros((bucket,), bool)
                mask[auto] = True
                col = sot_index + 1  # the language token follows sot
                prompts_dev[:, col] = torch.where(self._to_dev(mask), cfg.lang_token_start + idx,
                                                  prompts_dev[:, col])
                holder = {"idx": idx}
                for i in auto:
                    newcomers[i]._lang_holder, newcomers[i]._lang_row = holder, i
            logits, kv = decoder_forward(self.model, prompts_dev, 0, self._new_cache(bucket), cross,
                                         dt, pad=self._to_dev(pads) if prev_w else None,
                                         cross_decode=self.cross_decode)
            # OpenAI-style no-speech probability: softmax at the sot position
            nsp = torch.softmax(logits[:, sot_index].to(torch.float32), dim=-1)[:, cfg.no_speech]
            last = logits[:, -1]
            if self._use_rules:
                last = apply_rules(last, RuleState.create(bucket, device=self.device), cfg,
                                   suppress_ids=self._suppress, timestamps=self.timestamps)
            lp0 = torch.log_softmax(last.to(torch.float32), dim=-1)
            first = torch.argmax(last, dim=-1)
            first_lp = torch.gather(lp0, 1, first[:, None])[:, 0]
            self._first_run(("prepare", bucket, prev_w))
            return _PreparedBatch(reqs=newcomers, kv=kv, cross=cross, first=first,
                                  first_lp=first_lp, nsp=nsp, prompts=prompts_dev,
                                  prompt_len=prompts.shape[1], pads=pads)

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
        while True:
            with self._ready_cv:
                batch = self._ready[0] if self._ready else None
            if batch is None:
                return
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
            exhausted = batch.consumed >= len(batch.reqs)
            with self._ready_cv:
                self._prepared_reqs = max(0, self._prepared_reqs - (batch.consumed - start))
                self.stats.prepared_depth = self._prepared_reqs
                if exhausted and self._ready and self._ready[0] is batch:
                    self._ready.popleft()
            if not exhausted:
                return  # out of free slots; the rest goes in next tick

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
        pad_rows = batch.pads[rows]

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
        self.pads.index_copy_(0, dst, self._to_dev(pad_rows))
        self.rs.last.index_copy_(0, dst, first)
        self.rs.penult.index_fill_(0, dst, -1)
        self.rs.max_ts.index_copy_(0, dst, torch.where(first >= cfg.timestamp_begin, first, 0))
        self.rs.n_sampled.index_fill_(0, dst, 1)
        # quality state: sum_logprob starts at the prefill-sampled token's
        first_lp = batch.first_lp.index_select(0, src)
        self.fstate.index_copy_(0, dst, torch.stack([first_lp, torch.ones_like(first_lp)], 1))
        self.nsp.index_copy_(0, dst, batch.nsp.index_select(0, src))
        self._first_run(("admit", int(batch.first.shape[0]), P))

        now = time.perf_counter()
        for j, (i, r) in enumerate(zip(slots, takers)):
            self._slot_req[i] = r
            self._slot_prompt_len[i] = P
            self._slot_pad[i] = int(pad_rows[j])
            self._slot_limit_h[i] = int(lim[j])
            self._slot_gen[i] += 1  # in-flight packed buffers go stale here
            self._slot_unseen[i] = True
            if self._last_offs_h is not None:
                self._last_offs_h[i] = P + 1  # a fresh slot starts after its prefill
            r.admitted_at = now
            self.stats.ready_wait_seconds_total += now - batch.ready_at
        self.stats.admitted_total += k
        self.stats.active_slots = sum(r is not None for r in self._slot_req)

    def _free_slot(self, i: int):
        self._slot_req[i] = None
        self._slot_prompt_len[i] = 0
        self._slot_pad[i] = 0

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
            self._free_slot(i)
        self._deactivate(drop)

    def _deactivate(self, slots: List[int]):
        mask = np.zeros((self.B,), bool)
        mask[slots] = True
        keep = ~self._to_dev(mask)
        self.active &= keep
        self.done &= keep
        self.stats.active_slots = sum(r is not None for r in self._slot_req)

    # ------------------------------------------------------------- decode round
    def _steps(self, n_steps: int):
        """``n_steps`` greedy steps over every slot, all on the device: a slot
        steps only while active and not done (``step_ok``); the others
        re-run their last position and keep their state. No host sync. On
        the card an engine whose ranks all lie on it (one device, or a
        ``--tp`` mesh whose ranks share the card) replays the round as a
        CUDA graph (one per round size, captured at the size's first round,
        as the JAX engine traces one ``_step_fn`` per size); under a mesh
        over distinct cards and on the CPU the round runs uncaptured."""
        if self._graphs is None:
            self._round(n_steps)
        else:
            self._graphs.run(("step", n_steps), functools.partial(self._round, n_steps))
        self._first_run(("step", n_steps))
        self.stats.steps_total += n_steps
        self.stats.slot_steps_total += n_steps * sum(r is not None for r in self._slot_req)
        key = str(n_steps)
        self.stats.round_sizes[key] = self.stats.round_sizes.get(key, 0) + 1

    def _round(self, n_steps: int):
        """The round's steps, writing the slot state in place (a graph of
        the round reads and writes those very tensors)."""
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
                                              pads=self.pads, cross_decode=self.cross_decode)
            if self._use_rules:
                logits = apply_rules(logits, rs, cfg, suppress_ids=self._suppress,
                                     timestamps=self.timestamps)
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
        for state, new in zip((self.tokens, self.offsets, self.done, self.fstate, *self.rs),
                              (tokens, offsets, done, fstate, *rs)):
            state.copy_(new)

    def _adaptive_steps(self) -> int:
        """This round's size: 1, 2 or 4 times steps_per_sync. From the
        one-round-stale host offsets and the slots' limits: when the least
        budget left among active slots, less the round in flight (its real
        size), still covers a bigger round, take it; overshoot costs only
        masked steps."""
        base = self.steps_per_sync
        if self._last_offs_h is None:
            return base
        rem = [int(self._slot_limit_h[i]) - int(self._last_offs_h[i]) for i in range(self.B)
               if self._slot_req[i] is not None and self._last_offs_h[i] >= 0]
        if not rem:
            return base
        m = min(rem) - self._last_round_steps
        for mult in (4, 2):
            if m >= base * mult:
                return base * mult
        return base

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
        self._first_run(("pack",))
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
                 comp: float, quality_ok: bool, beam_size: Optional[int] = None, align=None):
        """Count a finished request and set its reply (from the slots, or
        from the aux worker, whose replies name the ``beam_size`` decoded).
        With ``word_timestamps`` the reply goes to ``align`` (a callable
        that queues it for the align worker) when one is given, and carries
        an empty ``words`` list otherwise (silence, no text)."""
        wall = time.perf_counter() - req.enqueued_at
        audio_s = len(req.audio) / 16000.0
        with self._stats_lock:
            self.stats.requests_total += 1
            self.stats.beam_requests_total += (beam_size or 1) > 1
            self.stats.tokens_total += n_tok
            self.stats.audio_seconds_total += audio_s
        reply = {
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
        }
        if beam_size is not None:
            reply["beam_size"] = beam_size
        if req.word_timestamps:
            if align is not None:
                if not req.future.done():
                    align(reply)
                return
            reply["words"] = []
        _safe_set_result(req.future, reply)

    def _add_busy(self, seconds: float):
        with self._stats_lock:
            self.stats.busy_seconds_total += seconds

    def _slot_text(self, i: int, offs_h, tokens_h) -> tuple:
        """(generated ids, their text) of slot ``i`` in a resolved buffer;
        with ``timestamps`` the timestamp tokens read as ``<|t.tt|>``."""
        ids = tokens_h[i, self._slot_prompt_len[i]: offs_h[i]]
        ids = ids[ids != self.cfg.eot]
        decode = self.tokenizer.decode_with_timestamps if self.timestamps else self.tokenizer.decode
        return ids, decode(ids)

    def _emit_partials(self, tokens_h, offs_h, done_h, fresh):
        """Each streaming slot's transcript so far, from the resolved buffer
        (no device read); a slot re-admitted since its pack is skipped."""
        for i in range(self.B):
            req = self._slot_req[i]
            if req is None or req.on_partial is None or done_h[i] or not fresh[i]:
                continue
            _, text = self._slot_text(i, offs_h, tokens_h)
            try:
                req.on_partial(postprocess(text, self._effective_language(req)))
            except Exception:  # noqa: BLE001 — a dead consumer stops its stream
                req.on_partial = None
            self.stats.partials_total += 1

    def _harvest_host(self, done_h, active_h, offs_h, tokens_h, fstate_h, nsp_h, fresh=None):
        if fresh is None:
            fresh = np.ones((self.B,), bool)
        if any(r is not None and r.on_partial is not None for r in self._slot_req):
            self._emit_partials(tokens_h, offs_h, done_h, fresh)
        ready = [i for i in range(self.B)
                 if active_h[i] and done_h[i] and self._slot_req[i] is not None]
        if not ready:
            return
        for i in ready:
            req = self._slot_req[i]
            ids, text = self._slot_text(i, offs_h, tokens_h)
            text = postprocess(text.strip(), self._effective_language(req))
            avg_lp = float(fstate_h[i, 0] / max(fstate_h[i, 1], 1.0))
            nsp = float(nsp_h[i])
            text, comp, quality_ok, silenced = self._quality_gate(text, nsp, avg_lp)
            # a retried request re-decodes on the aux worker at the next
            # ladder temperature: free the slot, leave the future pending
            if not self._maybe_retry(req, quality_ok, silenced):
                align = None
                if req.word_timestamps and text and not silenced:
                    align = functools.partial(self._submit_align, req, i, tokens_h, offs_h)
                self._resolve(req, text, int(len(ids)), nsp, avg_lp, comp, quality_ok,
                              align=align)
            self._free_slot(i)
        self._deactivate(ready)

    # ------------------------------------------------------------- word alignment
    def _submit_align(self, req: Request, slot: int, tokens_h, offs_h, reply: dict):
        """Queue a harvested slot's reply for word alignment. The slot's
        cross-KV is COPIED (each rank's under a mesh): a re-admission
        rewrites the slot in place, and the align worker reads it later on
        its own thread. The copy is enqueued on the stream before any later
        admission's write. The sequence loses its masked left pad, so the
        teacher-forced pass sees it at its own positions; its context tokens
        stay, out of the word rows."""
        cross_row = _pack([tuple(x[:, slot:slot + 1].clone() for x in c)
                                 for c in shard_values(self.cross)])
        pad = self._slot_pad[slot]
        seq = np.concatenate([tokens_h[slot, pad:int(offs_h[slot])], [self.cfg.eot]])
        self._queue_align(req, reply, cross_row=cross_row, seq=seq,
                          prompt_len=self._slot_prompt_len[slot] - pad,
                          lang=self._effective_language(req))

    def _queue_align(self, req: Request, reply: dict, *, cross_row, seq: np.ndarray,
                     prompt_len: int, lang: str):
        """The align queue's one entry, for the slots' harvest and the aux
        worker alike; starts the align worker with the first job."""
        job = (req, reply, cross_row, seq.astype(np.int64), prompt_len, lang,
               min(len(req.audio), N_SAMPLES))
        with self._align_cv:
            if self._align_thread is None:
                self._align_thread = threading.Thread(target=self._align_run, daemon=True,
                                                      name="cb-align")
                self._align_thread.start()
            self._align_q.append(job)
            self._align_cv.notify()

    def _align_run(self):
        """Align worker loop: up to ``align_batch_max`` queued jobs at a time
        into ONE bucketed alignment pass. A failure the batch does not catch
        itself fails that batch's replies (``align_error``), not the worker."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._align_cv:
                while not self._align_q and not self._stop.is_set():
                    self._align_cv.wait()
                if not self._align_q and self._stop.is_set():
                    return
                jobs = []
                while self._align_q and len(jobs) < self.align_batch_max:
                    jobs.append(self._align_q.popleft())
            try:
                self._align_batch(jobs)
            except Exception as e:  # noqa: BLE001 — the worker must survive
                for req, reply, *_ in jobs:
                    reply.setdefault("align_error", f"{type(e).__name__}: {e}")
                    reply.setdefault("words", None)
                    _safe_set_result(req.future, reply)

    def _align_batch(self, jobs: list):
        """One micro-batched alignment pass and each job's DTW and words:
        the batch padded to a power-of-two bucket with the first job's
        cross-KV, S the longest sequence rounded up to a multiple of 32 (at
        least 32, at most n_text_ctx), each row's frames its audio's
        (ceil(samples / 320), at most n_audio_ctx)."""
        cfg = self.cfg
        k = len(jobs)
        try:
            if self._align_mask is None:
                self._align_mask = torch.as_tensor(alignment_head_mask(cfg), dtype=torch.float32,
                                                   device=self.device)
            Bb = 1 << max(0, k - 1).bit_length()  # power-of-two batch bucket
            S = min(max(32, 32 * max(-(-len(j[3]) // 32) for j in jobs)), cfg.n_text_ctx)
            toks = np.full((Bb, S), cfg.eot, np.int64)
            row_mask = np.zeros((Bb, S), bool)
            frames = np.ones((Bb,), np.int64)
            for j, (_, _, _, seq, pl, _, samples) in enumerate(jobs):
                L = min(len(seq), S)
                toks[j, :L] = seq[:L]
                row_mask[j, pl:L] = True
                frames[j] = min(-(-samples // 320), cfg.n_audio_ctx)
            rows = [shard_values(j[2]) for j in jobs]
            rows += [rows[0]] * (Bb - k)
            cross = _pack([tuple(torch.cat([r[rank][part] for r in rows], dim=1)
                                       for part in range(len(rows[0][rank])))
                                 for rank in range(len(rows[0]))])
            matrix, tlp = alignment_matrix(self.model, self._to_dev(toks),
                                           dequantize_cross_kv(cross), self._align_mask,
                                           self._to_dev(row_mask), self._to_dev(frames), self.dt)
            matrix, tlp = matrix.cpu().numpy(), tlp.cpu().numpy()
            self._first_run(("align", Bb, S))
        except Exception as e:  # noqa: BLE001 — words are best-effort
            for req, reply, *_ in jobs:
                reply["words"] = None
                reply["align_error"] = f"{type(e).__name__}: {e}"
                _safe_set_result(req.future, reply)
            return
        with self._stats_lock:
            self.stats.align_batches_total += 1
        for j, (req, reply, _, _, pl, lang, _) in enumerate(jobs):
            try:
                reply["words"] = row_words(matrix[j], tlp[j], toks[j], pl,
                                           min(len(jobs[j][3]), S), int(frames[j]), lang,
                                           self.tokenizer)
                with self._stats_lock:
                    self.stats.align_total += 1
            except Exception as e:  # noqa: BLE001
                reply["words"] = None
                reply["align_error"] = f"{type(e).__name__}: {e}"
            _safe_set_result(req.future, reply)

    def _fail_inflight(self, exc: BaseException):
        """Fail every in-flight, prepared and queued request; reset slot
        state so the loop can keep serving."""
        for i, req in enumerate(self._slot_req):
            if req is not None:
                _safe_set_exception(req.future, exc)
            self._free_slot(i)
        with self._ready_cv:
            prepared = list(self._ready)
            self._ready.clear()
            self._prepared_reqs = 0
            self.stats.prepared_depth = 0
        for batch in prepared:
            for req in batch.reqs[batch.consumed:]:
                _safe_set_exception(req.future, exc)
        self._drain_queue()
        while self._pending:
            _safe_set_exception(self._pending.popleft().future, exc)
        self._inflight_harvest = None
        self.active.zero_()
        self.done.zero_()
        self.stats.active_slots = 0
        self.stats.queue_depth = 0

    # ------------------------------------------------------------- the loop
    def _tick(self):
        """One decode-thread round:

        1. without an encode thread (an engine not started): encode +
           prefill pending requests inline;
        2. enqueue round N (steps_per_sync steps, or the adaptive size) and
           start its harvest copy;
        3. resolve round N-1's copy (the card is busy with round N meanwhile),
           stream partials and free finished slots;
        4. expire/cancel; copy prepared admissions into free slots.

        Steps 2-4 are the profiler ranges ``whisper.engine.step``,
        ``whisper.engine.harvest`` and ``whisper.engine.admit``; a prepare
        is ``whisper.engine.prepare`` on whichever thread runs it.
        """
        t0 = time.perf_counter()
        self.stats.ticks_total += 1
        if self._encode_thread is None:
            self._prepare_pending_once()
        prev = self._inflight_harvest  # round N-1 copy, still in flight
        self._inflight_harvest = None
        if any(r is not None for r in self._slot_req):
            with record_function("whisper.engine.step"):
                n_steps = self._adaptive_steps() if self.adaptive_sync else self.steps_per_sync
                self._last_round_steps = n_steps
                self._steps(n_steps)
                self._start_harvest_copy()
        t1 = time.perf_counter()
        self.stats.step_seconds_total += t1 - t0
        if prev is not None:
            with record_function("whisper.engine.harvest"):
                host, event, prev_gen = prev
                if event is not None:
                    tw = time.perf_counter()
                    event.synchronize()
                    self.stats.card_wait_seconds_total += time.perf_counter() - tw
                h = host.numpy()
                # a slot re-admitted since the pack carries the PREVIOUS
                # request's row in this buffer: don't harvest it, don't stream
                # its tokens, and don't let its offset size the next round
                fresh = prev_gen == self._slot_gen
                done_h, offs_h = h[:, 2] > 0, h[:, 0]
                resolved = np.where(done_h, -1, offs_h)
                self._last_offs_h = np.where(fresh, resolved, -1 if self._last_offs_h is None
                                             else self._last_offs_h)
                self._note_first_tokens(fresh)
                self._harvest_host(done_h & fresh, h[:, 1] > 0, offs_h, h[:, 6:],
                                   h[:, 3:5].view(np.float32), h[:, 5:6].view(np.float32)[:, 0],
                                   fresh)
        t2 = time.perf_counter()
        self.stats.harvest_seconds_total += t2 - t1
        with record_function("whisper.engine.admit"):
            self._expire_slots()
            self._admit_new()  # copied now, stepped in round N+1
        self.stats.admit_seconds_total += time.perf_counter() - t2
        self._add_busy(time.perf_counter() - t0)

    def _note_first_tokens(self, fresh: np.ndarray):
        """Count, at a harvest, the slots whose first packed round it
        resolves: its buffer shows the request's first token."""
        now = time.perf_counter()
        for i in np.flatnonzero(fresh & self._slot_unseen):
            req = self._slot_req[i]
            self._slot_unseen[i] = False
            if req is not None:
                self.stats.first_token_seconds_total += now - req.enqueued_at
                self.stats.first_tokens_total += 1

    # ------------------------------------------------------------- aux worker
    def _aux_collect(self) -> List[Request]:
        """Take a micro-batch of one effective beam size, temperature and
        context width (at most ``beam_batch_max``) from the left of the aux
        deque; the other requests keep their place. A request at t > 0
        samples (beams only at t = 0), so its effective beam size is 1."""
        with self._aux_cv:
            batch: List[Request] = []
            keep: List[Request] = []
            now = time.perf_counter()
            key = None
            while self._aux_pending and len(batch) < self.beam_batch_max:
                r = self._aux_pending.popleft()
                if r.future.cancelled():
                    continue
                if r.expired(now):
                    _safe_set_exception(r.future, TimeoutError(
                        f"deadline {r.deadline_s}s expired in aux queue"))
                    continue
                prev_w = self._prev_width([len(self._context_ids(r))])
                rk = ((1, r.temperature, prev_w) if r.temperature > 0
                      else (r.beam_size, 0.0, prev_w))
                key = key or rk
                (batch if rk == key else keep).append(r)
            self._aux_pending.extendleft(reversed(keep))
            return batch

    def _run_aux_batch(self, reqs: List[Request]):
        """One aux micro-batch: bucketed encode through :meth:`_encode` (int8
        cross-KV and the mesh apply), then, on the slots' right-aligned
        prompts with its own caches, ``beam_search_kv`` at the batch's beam
        size (t = 0) or ``greedy_decode_kv`` at its temperature (seed 0, as
        the JAX engine's), each in captured rounds on the card where
        ``decode.capturable`` holds (``aux_steps_total`` counts the steps
        the card ran: whole rounds); results pass the same quality gate as
        the slots' and may climb the ladder again (sampling one beam)."""
        cfg = self.cfg
        temp = reqs[0].temperature
        K = reqs[0].beam_size if temp == 0 else 1
        buckets = sorted({b for b in self.prefill_buckets if b <= self.beam_batch_max}
                         | {self.beam_batch_max})
        bucket = _bucket(len(reqs), buckets)
        cross = self._encode(reqs, bucket)
        self._first_run(("aux_encode", bucket))
        auto = [i for i, r in enumerate(reqs) if _auto(r)]
        idx = None
        if auto and cfg.is_multilingual:
            # a host read is fine here: the aux worker is off the decode thread
            idx = self._detect(cross).cpu().numpy()
            self._first_run(("aux_detect", bucket))
        for i in auto:
            reqs[i].language_resolved = "en" if idx is None else list(LANGUAGES)[int(idx[i])]
        langs = [self._effective_language(r) for r in reqs]
        prev_w = self._prev_width([len(self._context_ids(r)) for r in reqs])
        prompts, pads, sot_index = self._prompt_rows(reqs, langs, prev_w, bucket)
        P = prompts.shape[1]
        kw = dict(max_tokens=self.max_tokens, suppress_ids=self._suppress,
                  apply_filters=self.apply_filters,
                  self_kv_quant=self.self_kv_quant, timestamps=self.timestamps,
                  prompt_pad=self._to_dev(pads) if prev_w else None, sot_index=sot_index)
        if temp > 0:
            result = greedy_decode_kv(self.model, cross, self._to_dev(prompts), self.dt,
                                      cross_decode=self.cross_decode, temperature=float(temp),
                                      **kw)
        else:
            result = beam_search_kv(self.model, cross, self._to_dev(prompts), self.dt,
                                    beam_size=K, length_penalty=self.length_penalty, **kw)
        self._first_run(("aux_sampled", bucket, round(float(temp), 6), prev_w) if temp > 0
                        else ("aux_beam", bucket, K, prev_w))
        self.stats.aux_batches_total += 1
        self.stats.aux_steps_total += result.device_steps
        texts = extract_texts(result, P, self.tokenizer, timestamps=self.timestamps)
        lens = result.lengths.cpu().numpy()
        nsp_h = result.no_speech_prob.cpu().numpy()
        lp_h = result.avg_logprob.cpu().numpy()
        toks_h = result.tokens.cpu().numpy() if any(r.word_timestamps for r in reqs) else None
        for i, r in enumerate(reqs):
            text = postprocess(texts[i], langs[i])
            text, comp, quality_ok, silenced = self._quality_gate(
                text, float(nsp_h[i]), float(lp_h[i]))
            if self._maybe_retry(r, quality_ok, silenced):
                continue  # re-decoding at the next ladder temperature
            align = None
            if r.word_timestamps and text and not silenced:
                # aligned here too, so a retried request keeps its words: the
                # sequence without its masked left pad, and the batch's
                # cross-KV rows (a fresh tensor per batch that nothing
                # writes, so views do)
                seq = np.concatenate([toks_h[i, int(pads[i]): int(lens[i])], [cfg.eot]])
                cross_row = _pack([tuple(x[:, i:i + 1] for x in c)
                                         for c in shard_values(cross)])
                align = functools.partial(self._queue_align, r, cross_row=cross_row, seq=seq,
                                          prompt_len=P - int(pads[i]), lang=langs[i])
            self._resolve(r, text, int(max(lens[i] - P, 0)), float(nsp_h[i]), float(lp_h[i]),
                          comp, quality_ok, beam_size=K, align=align)

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

    def _run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            try:
                if (all(r is None for r in self._slot_req)
                        and self._inflight_harvest is None):
                    # idle: wait for the encode thread to prepare work
                    with self._ready_cv:
                        if not self._ready:
                            with record_function("whisper.engine.wait"):
                                self._ready_cv.wait(timeout=0.05)
                            if not self._ready:
                                continue
                self._tick()
            except Exception as e:  # noqa: BLE001 — engine thread must survive
                self._fail_inflight(e)
