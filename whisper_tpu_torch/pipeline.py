"""End-to-end ASR pipeline: audio -> mel -> encode -> greedy decode -> text.

Port of ``whisper_tpu/pipeline.py``'s ``WhisperPipeline``, greedy only:
``transcribe_batch`` (fixed windows), ``transcribe_longform`` (seek-based,
with timestamps), ``transcribe`` and ``run``, with timestamps,
``initial_prompt`` and condition-on-previous-text. Arguments of the JAX
pipeline that this port does not carry yet raise ``NotImplementedError``
instead of being ignored: beam search, speculative decoding, word
timestamps, sampling temperatures and the retry ladder, checkpoint loading
and language auto-detection.

Runs on ``device`` ("cuda" by default); asking for cuda without a card
raises. Nothing moves to the CPU unless the caller asks for it.

``transcribe_batch`` marks its stages as ``torch.profiler`` ranges
(``whisper.audio``, ``whisper.mel``, ``whisper.encoder``, ``whisper.cross_kv``,
``whisper.decode``, ``whisper.texts``) so a profile of the real call splits
its time by stage; outside a profile they cost a few microseconds each.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from .config import N_SAMPLES, get_config
from .decode import GreedyResult, encode_cross_kv, extract_texts, greedy_decode_kv
from .longform import merge_texts, silence_mask, split_audio, transcribe_seek
from .models.model import Whisper, cast_floating
from .ops.audio import load_audio
from .ops.mel import log_mel_batch
from .ops.quant import quantize_logits_emb, quantize_params
from .params import init_params
from .sampling import build_suppress_ids
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
    """Load once, transcribe many: batched greedy transcription."""

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
        temperature: float = 0.0,
        temperature_fallback: Optional[bool] = None,
        logprob_threshold: float = -1.0,
        no_speech_threshold: float = 0.6,
        condition_on_previous_text: bool = True,
        initial_prompt: Optional[str] = None,
        longform_overlap_s: float = 2.0,
        word_timestamps: bool = False,
        spec_draft: Optional[str] = None,
        spec_draft_checkpoint: Optional[str] = None,
        device="cuda",
        params: Optional[Whisper] = None,
    ):
        unported = {
            "checkpoint": checkpoint is not None,
            "beam_size > 1": bool(beam_size and beam_size > 1),
            "spec_draft": bool(spec_draft or spec_draft_checkpoint),
            "word_timestamps": word_timestamps,
            "temperature > 0": bool(temperature and temperature > 0),
            "temperature_fallback": bool(temperature_fallback),
            "language=None (auto-detect)": language is None,
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"not ported to whisper_tpu_torch yet: {', '.join(asked)}")
        if task not in ("transcribe", "translate"):
            raise ValueError(f"task must be transcribe or translate, not {task!r}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        self.device = resolve_device(device)
        self.task = task
        self.language = language
        self.compute_dtype = _DTYPES[compute_dtype]
        self.max_tokens = max_tokens
        self.timestamps = timestamps
        self.apply_filters = apply_filters
        self.kv_quant = kv_quant
        self.self_kv_quant = self_kv_quant
        self.w8a8 = w8a8
        self.gelu = gelu
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        self.condition_on_previous_text = condition_on_previous_text
        self.initial_prompt = initial_prompt
        self.longform_overlap = int(longform_overlap_s * 16000)
        self.last_decode: Optional[GreedyResult] = None
        self.last_seek: Optional[dict] = None  # rounds, windows, steps of transcribe_longform

        if params is None:
            params = init_params(get_config(model), seed, device=self.device)
        elif params.device != self.device:
            raise ValueError(f"params are on {params.device}, the pipeline on {self.device}")
        self.cfg = params.cfg
        if quantize:
            quantize_params(params)
        if quantize_logits:
            quantize_logits_emb(params)
        self.model = cast_floating(params, self.compute_dtype)

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

        cross_kv = encode_cross_kv(self.model, mel, self.compute_dtype,
                                   kv_quant=self.kv_quant, w8a8=self.w8a8, gelu=self.gelu)
        prompts = np.tile(self._prompt(language)[None], (len(flat_waves), 1))
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
        with record_function("whisper.decode"):
            result = greedy_decode_kv(
                self.model, cross_kv, torch.from_numpy(prompts).to(self.device),
                self.compute_dtype, max_tokens=self.max_tokens,
                suppress_ids=self._suppress_ids, apply_filters=self.apply_filters,
                self_kv_quant=self.self_kv_quant, gelu=self.gelu,
                timestamps=self.timestamps, sot_index=sot_index)
        self.last_decode = result
        with record_function("whisper.texts"):
            texts = extract_texts(result, prompts.shape[1], self.tokenizer,
                                  timestamps=self.timestamps)
            silent = silence_mask(result, self.no_speech_threshold, self.logprob_threshold)
            texts = ["" if s else t for t, s in zip(texts, silent)]
            toks = result.tokens.cpu().numpy()
            lens = result.lengths.cpu().numpy()
            nsp = result.no_speech_prob.cpu().numpy()
        wall = time.perf_counter() - t0

        out, pos = [], 0
        for u, nc in enumerate(len(cl) for cl in chunk_lists):
            chunk_texts = texts[pos: pos + nc]
            merged = merge_texts(chunk_texts, language) if nc > 1 else chunk_texts[0]
            out.append(TranscribeResult(
                text=postprocess(merged, language),
                language=language,
                tokens=np.concatenate([toks[pos + j, prompts.shape[1]: lens[pos + j]]
                                       for j in range(nc)]),
                audio_seconds=len(waves[u]) / 16000.0,
                wall_seconds=wall / len(audios),
                no_speech_prob=float(nsp[pos]),
            ))
            pos += nc
        return out

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
        carries its segments in ``segments_list``."""
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
