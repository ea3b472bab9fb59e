"""End-to-end ASR pipeline: audio -> mel -> encode -> greedy or beam decode -> text.

Port of ``whisper_tpu/pipeline.py``'s ``WhisperPipeline``:
``transcribe_batch`` (fixed windows), ``transcribe_longform`` (seek-based,
with timestamps), ``transcribe`` and ``run``, with timestamps,
``initial_prompt``, condition-on-previous-text, a sampling ``temperature``
and OpenAI's temperature-fallback ladder (``temperature_fallback``: the rows
that fail the compression-ratio or logprob gate are decoded again at 0.2,
0.4, ... 1.0 against the batch's cross-KV) and beam search (``beam_size``
above 1: ``beam.beam_search_kv``; the ladder retries a beam decode's failed
rows by sampling, one beam each, as after greedy). As in the JAX package,
the seek loop runs without the ladder. ``checkpoint`` loads real
weights (``models/checkpoint.load_checkpoint``: an OpenAI ``.pt``, an HF
directory or a bare ``.safetensors``) and, as in the JAX package, turns the
ladder on unless told otherwise. ``language=None`` detects each chunk's
language from the batch's one cross-KV (``decode.detect_language_kv``) and
builds each row's prompt from it; an utterance takes its first chunk's.
``word_timestamps`` adds word timings to ``transcribe_batch``'s results
(``TranscribeResult.words``) from one teacher-forced pass over each
sub-batch of the decoded sequences (``align.alignment_matrix``) and a DTW on
the host; ``alignment_heads`` names a JSON sidecar of alignment heads. A
clip over 30 s gets its windows' words merged and its text spelled from
them. ``spec_draft`` (a preset name) or ``spec_draft_checkpoint`` decodes
speculatively (``spec_decode.speculative_decode_kv``): the draft encodes the
same audio (with its own mel bank where its ``n_mels`` differ) and proposes
``spec_gamma`` tokens a round for the target to verify; greedy argmax only,
so the suppression filters, timestamps, beams, sampling and the seek loop
refuse it with ``ValueError``, as in the JAX package.

Runs on ``device`` ("cuda" by default); asking for cuda without a card
raises. Nothing moves to the CPU unless the caller asks for it.

``encoder_attention`` ("btd" or "bhtd") and ``cross_decode`` ("fd",
"legacy" or "dense") select the encoder-attention and decode
cross-attention kernels of every path (the JAX package's
``WHISPER_TPU_FLASH`` and ``WHISPER_TPU_DECODE_FLASH``; see
``models/model.py``); an unknown value raises ``ValueError``.

``transcribe_batch`` marks its stages as ``torch.profiler`` ranges
(``whisper.audio``, ``whisper.mel``, ``whisper.encoder``, ``whisper.cross_kv``,
``whisper.detect`` when it detects, ``whisper.draft_encoder`` with a
draft, ``whisper.decode``, ``whisper.texts``, ``whisper.align`` with word
timestamps) so
a profile of the real call splits its time by stage; outside a profile they
cost a few microseconds each.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from .align import alignment_head_mask, alignment_matrix, dequantize_cross_kv, row_words
from .beam import beam_search_kv
from .config import LANGUAGES, N_SAMPLES, get_config
from .decode import (
    GreedyResult,
    detect_language_kv,
    encode_cross_kv,
    extract_texts,
    greedy_decode_kv,
    index_cross_kv,
)
from .longform import (
    compression_ratio,
    merge_texts,
    merge_window_words,
    silence_mask,
    split_audio,
    text_from_words,
    transcribe_seek,
)
from .models.checkpoint import load_checkpoint
from .models.model import Whisper, cast_floating, check_selections
from .ops.audio import load_audio
from .ops.mel import log_mel_batch
from .ops.quant import quantize_logits_emb, quantize_params
from .params import init_params
from .sampling import build_suppress_ids
from .spec_decode import speculative_decode_kv
from .text import parse_segments, postprocess
from .tokenizer import get_tokenizer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TranscribeResult:
    text: str
    language: str
    tokens: np.ndarray
    audio_seconds: float
    wall_seconds: float
    no_speech_prob: float = 0.0
    segments_list: Optional[list] = None  # explicit segments (seek-based long-form)
    words: Optional[list] = None  # [{word, start, end, probability}] (align.py)

    @property
    def rtf(self) -> float:
        """Real-time factor = wall / audio duration."""
        return self.wall_seconds / max(self.audio_seconds, 1e-9)

    @property
    def segments(self):
        """[(start_s, end_s or None, text)] when decoded with timestamps,
        else []."""
        if self.segments_list is not None:
            return self.segments_list
        return parse_segments(self.text)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; cuda without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA card is "
                           "available (pass device='cpu' to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class WhisperPipeline:
    """Load once, transcribe many: batched greedy, beam (``beam_size``
    above 1) or speculative (a draft) transcription."""

    def __init__(
        self,
        model: str = "tiny",
        checkpoint: Optional[str] = None,
        language: Optional[str] = "zh",
        task: str = "transcribe",
        compute_dtype: str = "float32",
        vocab_path: Optional[str] = None,
        seed: int = 0,
        beam_size: int = 0,
        timestamps: bool = False,
        max_tokens: Optional[int] = None,
        apply_filters: bool = True,
        quantize: bool = False,
        quantize_logits: bool = False,
        kv_quant: bool = False,
        self_kv_quant: bool = False,
        w8a8: bool = False,
        gelu: str = "erf",
        encoder_attention: str = "btd",
        cross_decode: str = "fd",
        temperature: float = 0.0,
        temperature_fallback: Optional[bool] = None,
        compression_ratio_threshold: float = 2.4,
        logprob_threshold: float = -1.0,
        no_speech_threshold: float = 0.6,
        condition_on_previous_text: bool = True,
        initial_prompt: Optional[str] = None,
        longform_overlap_s: float = 2.0,
        word_timestamps: bool = False,
        alignment_heads: Optional[str] = None,
        spec_draft: Optional[str] = None,
        spec_draft_checkpoint: Optional[str] = None,
        spec_gamma: int = 4,
        device="cuda",
        params: Optional[Whisper] = None,
        draft_params: Optional[Whisper] = None,
    ):
        if task not in ("transcribe", "translate"):
            raise ValueError(f"task must be transcribe or translate, not {task!r}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        check_selections(encoder_attention, cross_decode)
        if checkpoint is not None and params is not None:
            raise ValueError("pass checkpoint= or params=, not both")
        if spec_draft_checkpoint is not None and draft_params is not None:
            raise ValueError("pass spec_draft_checkpoint= or draft_params=, not both")
        self.device = resolve_device(device)
        self.task = task
        self.language = language  # None: detected per chunk
        self.compute_dtype = _DTYPES[compute_dtype]
        self.max_tokens = max_tokens
        self.beam_size = beam_size
        self.timestamps = timestamps
        self.apply_filters = apply_filters
        self.kv_quant = kv_quant
        self.self_kv_quant = self_kv_quant
        self.w8a8 = w8a8
        self.gelu = gelu
        self.encoder_attention = encoder_attention
        self.cross_decode = cross_decode
        self.temperature = temperature
        # whisper's retry ladder only makes sense with trained weights: on
        # when a checkpoint is given, unless asked for
        self.temperature_fallback = (temperature_fallback if temperature_fallback is not None
                                     else checkpoint is not None)
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        self.condition_on_previous_text = condition_on_previous_text
        self.initial_prompt = initial_prompt
        self.longform_overlap = int(longform_overlap_s * 16000)
        # word timings (align.py): one teacher-forced pass over each batch's
        # decoded sequences; transcribe_batch only (the seek path reports
        # segment times instead)
        self.word_timestamps = word_timestamps
        self.alignment_heads = alignment_heads
        self.last_decode = None  # the GreedyResult or BeamResult of the last batch
        # rounds, windows, steps, device_steps of transcribe_longform
        self.last_seek: Optional[dict] = None

        if checkpoint is not None:
            params, _ = load_checkpoint(checkpoint, size=model, device=self.device)
        elif params is None:
            params = init_params(get_config(model), seed, device=self.device)
        elif params.device != self.device:
            raise ValueError(f"params are on {params.device}, the pipeline on {self.device}")
        self.cfg = params.cfg
        if quantize:
            quantize_params(params)
        if quantize_logits:
            quantize_logits_emb(params)
        self.model = cast_floating(params, self.compute_dtype)

        # speculative decoding: greedy argmax only (the suppression grammar
        # is sequential state the verify window cannot replay), so every
        # other decode option refuses it rather than ignoring it
        self.spec_gamma = spec_gamma
        self.draft: Optional[Whisper] = None
        self.last_spec_stats: Optional[dict] = None
        if spec_draft or spec_draft_checkpoint or draft_params is not None:
            if apply_filters or timestamps or (beam_size and beam_size > 1) or temperature > 0:
                raise ValueError("speculative decoding is greedy/argmax-only: use "
                                 "apply_filters=False, timestamps=False, beam_size<=1, "
                                 "temperature=0")
            if spec_draft_checkpoint is not None:
                draft_params, _ = load_checkpoint(spec_draft_checkpoint,
                                                  size=spec_draft or "tiny", device=self.device)
            elif draft_params is None:
                if checkpoint is not None:
                    # a real target with a random draft decodes right but
                    # slower (acceptance ~0): the feature's point defeated
                    raise ValueError("target has a real checkpoint but the draft would be "
                                     "random-init (acceptance ~0, pure slowdown): pass "
                                     "spec_draft_checkpoint")
                draft_params = init_params(get_config(spec_draft), seed + 1, device=self.device)
            elif draft_params.device != self.device:
                raise ValueError(f"draft_params are on {draft_params.device}, "
                                 f"the pipeline on {self.device}")
            if draft_params.cfg.n_vocab != self.cfg.n_vocab:
                raise ValueError(f"draft vocab {draft_params.cfg.n_vocab} != target "
                                 f"{self.cfg.n_vocab}: draft and target must share a tokenizer")
            if quantize:
                quantize_params(draft_params)
            self.draft = cast_floating(draft_params, self.compute_dtype)

        if not self.cfg.is_multilingual:
            raise NotImplementedError("English-only (.en) vocabularies are not ported yet")
        self.tokenizer = get_tokenizer(num_languages=self.cfg.num_languages,
                                       language=language, task=task, vocab_path=vocab_path)
        self._suppress_ids = (
            torch.as_tensor(build_suppress_ids(self.cfg, self.tokenizer),
                            dtype=torch.int64, device=self.device)
            if apply_filters else None)

    def _prepare_batch(self, waves: Sequence[np.ndarray]):
        lengths = np.array([min(len(w), N_SAMPLES) for w in waves], np.int64)
        batch = np.zeros((len(waves), N_SAMPLES), np.float32)
        for i, w in enumerate(waves):
            batch[i, : lengths[i]] = w[: lengths[i]]
        return (torch.from_numpy(batch).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def _prompt(self, language: str) -> np.ndarray:
        return np.asarray(self.cfg.sot_sequence(language, self.task), np.int64)

    def transcribe_batch(
        self,
        audios: Sequence[Union[str, bytes, np.ndarray]],
        language: Optional[str] = None,
    ) -> List[TranscribeResult]:
        """Batched transcription. Audio longer than 30 s is split into
        overlapping windows that decode with the rest of the batch; the
        per-utterance texts are merged after."""
        t0 = time.perf_counter()
        language = language or self.language
        with record_function("whisper.audio"):
            waves = [load_audio(a) for a in audios]
            chunk_lists = [split_audio(w, overlap_samples=self.longform_overlap)[0]
                           for w in waves]
            flat_waves = [c for cl in chunk_lists for c in cl]
            batch, lengths = self._prepare_batch(flat_waves)
        with record_function("whisper.mel"):
            mel = log_mel_batch(batch, lengths, n_mels=self.cfg.n_mels)
            # configs with a shorter audio context take the leading frames
            mel = mel[..., : 2 * self.cfg.n_audio_ctx]

        # ONE encoder pass feeds language detection, the decode and the ladder
        cross_kv = encode_cross_kv(self.model, mel, self.compute_dtype,
                                   kv_quant=self.kv_quant, w8a8=self.w8a8, gelu=self.gelu,
                                   encoder_attention=self.encoder_attention)
        if language is None:
            with record_function("whisper.detect"):
                lang_idx, _ = detect_language_kv(self.model, cross_kv, self.compute_dtype,
                                                 cross_decode=self.cross_decode)
                codes = list(LANGUAGES)
                langs = [codes[int(i)] for i in lang_idx.cpu().numpy()]  # per chunk
        else:
            langs = [language] * len(flat_waves)
        prompts = np.stack([self._prompt(lang) for lang in langs])
        if self.timestamps:
            prompts = prompts[:, :-1]  # drop <|notimestamps|>
        sot_index = 0
        if self.initial_prompt:
            # [sot_prev, *prompt_tokens] before the sot sequence; the same
            # prefix on every row, so no left padding
            ptoks = self.tokenizer.encode(
                " " + self.initial_prompt.strip())[-(self.cfg.n_text_ctx // 2 - 1):]
            prefix = np.asarray([self.cfg.sot_prev, *ptoks], np.int64)
            prompts = np.concatenate([np.tile(prefix[None], (len(prompts), 1)), prompts], axis=1)
            sot_index = len(prefix)
        cross_d = self._draft_cross_kv(batch, lengths, mel) if self.draft is not None else None
        with record_function("whisper.decode"):
            kw = dict(max_tokens=self.max_tokens, suppress_ids=self._suppress_ids,
                      apply_filters=self.apply_filters, self_kv_quant=self.self_kv_quant,
                      gelu=self.gelu, timestamps=self.timestamps, sot_index=sot_index)
            prompt_t = torch.from_numpy(prompts).to(self.device)
            if self.beam_size and self.beam_size > 1:
                result = beam_search_kv(self.model, cross_kv, prompt_t, self.compute_dtype,
                                        beam_size=self.beam_size, **kw)
            elif self.draft is not None:
                result = self._speculative(cross_kv, cross_d, prompt_t, sot_index)
            else:
                result = greedy_decode_kv(self.model, cross_kv, prompt_t, self.compute_dtype,
                                          cross_decode=self.cross_decode,
                                          temperature=self.temperature, **kw)
            # OpenAI's ladder falls back from beam or greedy at t=0 to
            # sampling at rising temperatures, re-decoding only the rows
            # that failed
            if self.temperature_fallback:
                result = self._temperature_retry(result, cross_kv, prompts, sot_index)
        self.last_decode = result
        with record_function("whisper.texts"):
            texts = extract_texts(result, prompts.shape[1], self.tokenizer,
                                  timestamps=self.timestamps)
            silent = silence_mask(result, self.no_speech_threshold, self.logprob_threshold)
            texts = ["" if s else t for t, s in zip(texts, silent)]
            toks = result.tokens.cpu().numpy()
            lens = result.lengths.cpu().numpy()
            nsp = result.no_speech_prob.cpu().numpy()
        chunk_words = None
        if self.word_timestamps:
            with record_function("whisper.align"):
                samples = np.array([min(len(w), N_SAMPLES) for w in flat_waves])
                chunk_words = self._align_words(cross_kv, toks, lens, prompts.shape[1],
                                                samples, langs, silent)
        wall = time.perf_counter() - t0

        window_step_s = (N_SAMPLES - self.longform_overlap) / 16000.0
        overlap_s = self.longform_overlap / 16000.0
        out, pos = [], 0
        for u, nc in enumerate(len(cl) for cl in chunk_lists):
            chunk_texts = texts[pos: pos + nc]
            lang = langs[pos]  # the utterance's language is its first chunk's
            words = None
            if chunk_words is not None:
                # windows merged at word level: a midpoint cut on start times
                words = merge_window_words(chunk_words[pos: pos + nc], window_step_s, overlap_s)
            if words is not None and nc > 1:
                # the text spelled from the merged words, so the two agree
                merged = text_from_words(words, lang)
            else:
                merged = merge_texts(chunk_texts, lang) if nc > 1 else chunk_texts[0]
            out.append(TranscribeResult(
                text=postprocess(merged, lang),
                language=lang,
                tokens=np.concatenate([toks[pos + j, prompts.shape[1]: lens[pos + j]]
                                       for j in range(nc)]),
                audio_seconds=len(waves[u]) / 16000.0,
                wall_seconds=wall / len(audios),
                no_speech_prob=float(nsp[pos]),
                words=words,
            ))
            pos += nc
        return out

    def _draft_cross_kv(self, batch, lengths, mel):
        """The draft's encode of the batch: its own mel bank where its
        ``n_mels`` differ (the filterbanks are different frequency maps, so
        a slice of the target's mel would feed it garbage), else the
        target's mel."""
        dcfg = self.draft.cfg
        with record_function("whisper.draft_encoder"):
            mel_d = (mel if dcfg.n_mels == self.cfg.n_mels
                     else log_mel_batch(batch, lengths, n_mels=dcfg.n_mels))
            return encode_cross_kv(self.draft, mel_d[..., : 2 * dcfg.n_audio_ctx],
                                   self.compute_dtype, kv_quant=self.kv_quant, w8a8=self.w8a8,
                                   gelu=self.gelu, encoder_attention=self.encoder_attention)

    def _speculative(self, cross_kv, cross_d, prompt_t, sot_index: int):
        """The speculative decode; records ``last_spec_stats`` (the JAX
        package's counts, and the rounds the device ran and the host's
        reads of the loop's flags)."""
        result = speculative_decode_kv(
            self.model, cross_kv, self.draft, cross_d, prompt_t, gamma=self.spec_gamma,
            compute_dtype=self.compute_dtype, max_tokens=self.max_tokens,
            self_kv_quant=self.self_kv_quant, sot_index=sot_index, gelu=self.gelu,
            cross_decode=self.cross_decode)
        accepted, drafted = int(result.accepted), int(result.drafted)
        self.last_spec_stats = {"accepted": accepted, "drafted": drafted,
                                "rounds": result.rounds,
                                "acceptance": accepted / max(drafted, 1),
                                "device_rounds": result.device_rounds,
                                "host_syncs": result.host_syncs}
        return result

    def _align_words(self, cross_kv, toks: np.ndarray, lens: np.ndarray, prompt_len: int,
                     samples: np.ndarray, langs: List[str], silent: np.ndarray) -> List[list]:
        """Each chunk's word timings from the teacher-forced pass over its
        decoded sequence (:func:`~whisper_tpu_torch.align.alignment_matrix`:
        the head selection, standardization, median filter and head mean on
        the device, so only the reduced (b, S, Ta) matrix reaches the host),
        in sub-batches of 8: S is the longest sequence plus its eot, rounded
        up to a multiple of 32 (at least 32, at most n_text_ctx), and each
        sub-batch's cross-KV is dequantized on its own. A silent row gets no
        words."""
        cfg = self.cfg
        head_mask = torch.as_tensor(alignment_head_mask(cfg, self.alignment_heads),
                                    dtype=torch.float32, device=self.device)
        n = len(toks)
        words: List[list] = [[] for _ in range(n)]
        for lo in range(0, n, 8):
            hi = min(lo + 8, n)
            S = min(max(32, 32 * math.ceil((int(max(lens[lo:hi])) + 1) / 32)), cfg.n_text_ctx)
            seqs = np.full((hi - lo, S), cfg.eot, np.int64)
            row_mask = np.zeros((hi - lo, S), bool)
            frame_len = np.zeros((hi - lo,), np.int64)
            for i in range(lo, hi):
                L = min(int(lens[i]) + 1, S)
                seqs[i - lo, :L] = toks[i, :L]
                row_mask[i - lo, prompt_len:L] = True
                frame_len[i - lo] = min(math.ceil(samples[i] / 320), cfg.n_audio_ctx)
            fp = dequantize_cross_kv(tuple(a[:, lo:hi] for a in cross_kv))
            matrix, tlp = alignment_matrix(
                self.model, torch.from_numpy(seqs).to(self.device), fp, head_mask,
                torch.from_numpy(row_mask).to(self.device),
                torch.from_numpy(frame_len).to(self.device), self.compute_dtype, gelu=self.gelu)
            matrix, tlp = matrix.cpu().numpy(), tlp.cpu().numpy()
            for i in range(lo, hi):
                if not silent[i]:  # a silence-gated row has no words
                    words[i] = row_words(matrix[i - lo], tlp[i - lo], seqs[i - lo], prompt_len,
                                         min(int(lens[i]) + 1, S), int(frame_len[i - lo]),
                                         langs[i], self.tokenizer)
        return words

    def _needs_retry(self, result, prompts: np.ndarray) -> np.ndarray:
        """OpenAI failure criteria: repetitive text or low confidence,
        except silent rows, which are skipped, not retried."""
        texts = extract_texts(result, prompts.shape[1], self.tokenizer,
                              timestamps=self.timestamps)
        avg_lp = result.avg_logprob.cpu().numpy()
        bad = np.array([compression_ratio(t) > self.compression_ratio_threshold
                        or avg_lp[i] < self.logprob_threshold for i, t in enumerate(texts)],
                       dtype=bool)
        return bad & ~silence_mask(result, self.no_speech_threshold, self.logprob_threshold)

    def _temperature_retry(self, result, cross_kv, prompts: np.ndarray, sot_index: int = 0):
        """Whisper's temperature ladder: re-decode the failed rows of a greedy
        or beam decode at 0.2, 0.4, ... 1.0 (those above
        ``self.temperature``) by sampling, each rung with seed
        ``int(temp * 1000)``, until the quality criteria pass. Reuses the
        batch's cross-KV (indexed, not re-encoded); keeps the first decode's
        no-speech probabilities. After a retry the result is a
        ``GreedyResult``, as in the JAX package."""
        for temp in [t for t in (0.2, 0.4, 0.6, 0.8, 1.0) if t > self.temperature]:
            bad = self._needs_retry(result, prompts)
            if not bad.any():
                break
            idx = torch.from_numpy(np.nonzero(bad)[0]).to(self.device)
            sub = greedy_decode_kv(
                self.model, index_cross_kv(cross_kv, idx),
                torch.from_numpy(prompts[bad]).to(self.device), self.compute_dtype,
                max_tokens=self.max_tokens, suppress_ids=self._suppress_ids,
                apply_filters=self.apply_filters, self_kv_quant=self.self_kv_quant,
                gelu=self.gelu, timestamps=self.timestamps, sot_index=sot_index,
                cross_decode=self.cross_decode, temperature=temp, seed=int(temp * 1000))
            tokens, lengths, avg_lp = (t.clone() for t in (result.tokens, result.lengths,
                                                            result.avg_logprob))
            tokens[idx], lengths[idx], avg_lp[idx] = sub.tokens, sub.lengths, sub.avg_logprob
            result = GreedyResult(tokens=tokens, lengths=lengths,
                                  no_speech_prob=result.no_speech_prob, avg_logprob=avg_lp,
                                  # a speculative result counts rounds, not steps
                                  steps=getattr(result, "steps", 0) + sub.steps,
                                  host_syncs=result.host_syncs + sub.host_syncs,
                                  device_steps=(getattr(result, "device_steps", 0)
                                                + sub.device_steps))
        return result

    def transcribe(self, audio: Union[str, bytes, np.ndarray],
                   language: Optional[str] = None) -> TranscribeResult:
        return self.transcribe_batch([audio], language=language)[0]

    def transcribe_longform(
        self,
        audios: Sequence[Union[str, bytes, np.ndarray]],
        language: Optional[str] = None,
    ) -> List[TranscribeResult]:
        """Seek-based long-form (:func:`~whisper_tpu_torch.longform.
        transcribe_seek`): timestamp-conditioned sliding windows, batched
        across utterances, so windows end at segment boundaries. Each result
        carries its segments in ``segments_list``. Refuses a draft: the seek
        loop decodes with the timestamp grammar."""
        if self.draft is not None:
            raise ValueError("speculative decoding is not supported on the seek-based "
                             "longform path; use transcribe/transcribe_batch (fixed windows) "
                             "with spec_draft")
        t0 = time.perf_counter()
        language = language or self.language or "en"
        waves = [load_audio(a) for a in audios]
        results = transcribe_seek(self, waves, language)
        wall = time.perf_counter() - t0
        return [TranscribeResult(text=text, language=language, tokens=np.zeros((0,), np.int64),
                                 audio_seconds=len(w) / 16000.0,
                                 wall_seconds=wall / len(audios), segments_list=segs)
                for (text, segs), w in zip(results, waves)]

    def run(self, audio: Union[str, np.ndarray]) -> str:
        """The reference's ``Whisper.run``: one clip to its text."""
        return self.transcribe(audio).text
