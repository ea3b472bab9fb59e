"""Model/runtime configuration for the PyTorch Whisper port.

A copy of ``whisper_tpu/config.py`` (the port imports nothing of the JAX
package): the same typed config, special-token layout and presets, plus the
language table that :meth:`WhisperConfig.sot_sequence` needs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple

SAMPLE_RATE = 16000
N_FFT = 400  # canonical OpenAI value; reference python deviates to 480 (python/whisper.py:91)
HOP_LENGTH = 160
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 mel frames per 30s window

# Public OpenAI Whisper language table (order defines token ids:
# <|en|> = sot+1, ... ; reference copy at python/whisper_tokenizer.py:10-111).
LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}

TO_LANGUAGE_CODE = {name: code for code, name in LANGUAGES.items()}
TO_LANGUAGE_CODE.update(
    burmese="my", valencian="ca", flemish="nl", haitian="ht", letzeburgesch="lb",
    pushto="ps", panjabi="pa", moldavian="ro", moldovan="ro", sinhalese="si",
    castilian="es", mandarin="zh",
)


@dataclass(frozen=True)
class WhisperConfig:
    """Architecture + tokenizer-metadata config.

    Field set mirrors the reference's exported config metadata
    (model_convert/export_onnx.py:602-629) so checkpoints and configs are
    interchangeable at the JSON level.
    """

    name: str = "tiny"
    # audio frontend
    n_mels: int = 80
    sample_rate: int = SAMPLE_RATE
    n_fft: int = N_FFT
    hop_length: int = HOP_LENGTH
    # encoder
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    # decoder
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    is_multilingual: bool = True
    num_languages: int = 99  # 100 for large-v3 / turbo (adds yue)

    @property
    def head_dim_audio(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def head_dim_text(self) -> int:
        return self.n_text_state // self.n_text_head

    # ---- special-token ids (derived, multilingual layout) ----
    # For the multilingual vocab: eot = 50257, then specials follow
    # (python/whisper_tokenizer.py:345-358 defines the same ordering).
    @property
    def eot(self) -> int:
        return self._specials()["<|endoftext|>"]

    def _specials(self) -> dict:
        base = 50257 if self.is_multilingual else 50256
        out = {"<|endoftext|>": base}
        nxt = base + 1
        out["<|startoftranscript|>"] = nxt
        nxt += 1
        lang_start = nxt
        out["_lang_start"] = lang_start
        nxt += self.num_languages
        out["<|translate|>"] = nxt
        out["<|transcribe|>"] = nxt + 1
        out["<|startoflm|>"] = nxt + 2
        out["<|startofprev|>"] = nxt + 3
        out["<|nospeech|>"] = nxt + 4
        out["<|notimestamps|>"] = nxt + 5
        out["_timestamp_begin"] = nxt + 6
        return out

    @property
    def sot(self) -> int:
        return self._specials()["<|startoftranscript|>"]

    @property
    def transcribe(self) -> int:
        return self._specials()["<|transcribe|>"]

    @property
    def translate(self) -> int:
        return self._specials()["<|translate|>"]

    @property
    def no_timestamps(self) -> int:
        return self._specials()["<|notimestamps|>"]

    @property
    def no_speech(self) -> int:
        return self._specials()["<|nospeech|>"]

    @property
    def sot_prev(self) -> int:
        return self._specials()["<|startofprev|>"]

    @property
    def sot_lm(self) -> int:
        return self._specials()["<|startoflm|>"]

    @property
    def timestamp_begin(self) -> int:
        return self._specials()["_timestamp_begin"]

    @property
    def lang_token_start(self) -> int:
        return self._specials()["_lang_start"]

    @property
    def blank_id(self) -> int:
        # id of the " " token in the GPT-2 BPE table (reference config's blank_id)
        return 220

    def sot_sequence(self, language: str = "zh", task: str = "transcribe") -> Tuple[int, ...]:
        """[sot, lang, task, notimestamps] prompt (python/whisper.py:112-114);
        English-only models use just [sot, notimestamps]."""
        if not self.is_multilingual:
            return (self.sot, self.no_timestamps)
        codes = list(LANGUAGES.keys())[: self.num_languages]
        if language not in codes:
            raise ValueError(f"unknown language {language!r}")
        lang_token = self.lang_token_start + codes.index(language)
        task_token = self.transcribe if task == "transcribe" else self.translate
        return (self.sot, lang_token, task_token, self.no_timestamps)

    # ---- (de)serialization ----
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.update(
            sot=self.sot,
            eot=self.eot,
            blank_id=self.blank_id,
            no_timestamps=self.no_timestamps,
            no_speech=self.no_speech,
            translate=self.translate,
            transcribe=self.transcribe,
            sot_prev=self.sot_prev,
            sot_lm=self.sot_lm,
        )
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "WhisperConfig":
        d = json.loads(s)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# Presets for every size the reference toolchain exports
# (model_convert/export_onnx.py:36-56, dims are standard OpenAI Whisper).
_P = dict
PRESETS = {
    "tiny": _P(n_mels=80, n_audio_state=384, n_audio_head=6, n_audio_layer=4,
               n_text_state=384, n_text_head=6, n_text_layer=4, n_vocab=51865),
    "base": _P(n_mels=80, n_audio_state=512, n_audio_head=8, n_audio_layer=6,
               n_text_state=512, n_text_head=8, n_text_layer=6, n_vocab=51865),
    "small": _P(n_mels=80, n_audio_state=768, n_audio_head=12, n_audio_layer=12,
                n_text_state=768, n_text_head=12, n_text_layer=12, n_vocab=51865),
    "medium": _P(n_mels=80, n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
                 n_text_state=1024, n_text_head=16, n_text_layer=24, n_vocab=51865),
    "large-v2": _P(n_mels=80, n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                   n_text_state=1280, n_text_head=20, n_text_layer=32, n_vocab=51865),
    "large-v3": _P(n_mels=128, n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                   n_text_state=1280, n_text_head=20, n_text_layer=32, n_vocab=51866,
                   num_languages=100),
    "turbo": _P(n_mels=128, n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                n_text_state=1280, n_text_head=20, n_text_layer=4, n_vocab=51866,
                num_languages=100),
    "large-v1": _P(n_mels=80, n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                   n_text_state=1280, n_text_head=20, n_text_layer=32, n_vocab=51865),
    "distil-large-v3": _P(n_mels=128, n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                          n_text_state=1280, n_text_head=20, n_text_layer=2, n_vocab=51866,
                          num_languages=100),
    # distil-whisper family (HF distil-whisper model cards): full-depth
    # encoder, shallow decoder. distil-large-v2 keeps the large-v2
    # multilingual vocab/80 mels; v3.5 the large-v3 layout.
    "distil-large-v2": _P(n_mels=80, n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                          n_text_state=1280, n_text_head=20, n_text_layer=2, n_vocab=51865),
    "distil-large-v3.5": _P(n_mels=128, n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                            n_text_state=1280, n_text_head=20, n_text_layer=2, n_vocab=51866,
                            num_languages=100),
    # tiny test-only preset: real layout, toy dims (fast CPU tests)
    "test-nano": _P(n_mels=80, n_audio_ctx=96, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
                    n_text_ctx=32, n_text_state=64, n_text_head=2, n_text_layer=2, n_vocab=51865),
}
# English-only variants (OpenAI .en checkpoints): GPT-2 vocab, no language
# tokens; specials base shifts to 50256 (see _specials)
for _sz in ("tiny", "base", "small", "medium"):
    _p = dict(PRESETS[_sz])
    # layout keeps the 99 language-token slots (OpenAI builds the same
    # special set over the gpt2 base: 50257+1+99+6+1501 = 51864)
    _p.update(n_vocab=51864, is_multilingual=False)
    PRESETS[f"{_sz}.en"] = _p

# English-only distil models (distil-whisper): gpt2 vocab base like the
# OpenAI .en checkpoints; shallow decoders (distil-small.en keeps 4 decoder
# layers — 2 was below quality at that size, per the model card)
PRESETS["distil-small.en"] = _P(
    n_mels=80, n_audio_state=768, n_audio_head=12, n_audio_layer=12,
    n_text_state=768, n_text_head=12, n_text_layer=4,
    n_vocab=51864, is_multilingual=False)
PRESETS["distil-medium.en"] = _P(
    n_mels=80, n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
    n_text_state=1024, n_text_head=16, n_text_layer=2,
    n_vocab=51864, is_multilingual=False)

PRESETS["large"] = PRESETS["large-v3"]
PRESETS["large-v3-turbo"] = PRESETS["turbo"]
# icefall fine-tune served by the reference (export_onnx.py:429-506):
# medium dims, weights swapped at load time
PRESETS["medium-aishell"] = PRESETS["medium"]


def get_config(name: str, **overrides) -> WhisperConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown model size {name!r}; known: {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return WhisperConfig(name=name, **kw)


@dataclass(frozen=True)
class OmniConfig:
    """Uni-MoE-2.0-Omni's speech-to-text path (``model_type``
    ``grin_qwen2_vl``): a Whisper encoder (``audio``) pooled to ``n_query``
    frames and projected into a decoder-only language model of ``n_layer``
    blocks, each GQA self-attention (``n_head`` query heads over
    ``n_kv_head`` KV heads of ``head_dim``, RoPE at ``rope_theta``) then a
    mixture of experts: ``n_fixed`` fixed SwiGLU experts ``d_fixed`` wide
    that every token uses, ``n_routed`` routed ones ``d_routed`` wide and
    ``n_null`` null experts that add nothing, the routed and null ones
    chosen by a top-p (``top_p``) rule capped at ``top_k``. The prompt is
    ``n_prefix`` text ids, the audio tokens, ``n_suffix`` text ids; text ids
    lie below ``n_text_ids`` and the decode stops at ``stop_id``."""

    name: str = "uni-moe-2.0-omni"
    audio: WhisperConfig = WhisperConfig()
    n_query: int = 200
    d_model: int = 3584
    n_layer: int = 28
    n_head: int = 28
    n_kv_head: int = 4
    head_dim: int = 128
    n_vocab: int = 152064
    rms_eps: float = 1e-6
    rope_theta: float = 1e6
    n_fixed: int = 2
    d_fixed: int = 2368
    n_routed: int = 4
    d_routed: int = 18944
    n_null: int = 1
    top_p: float = 0.7
    top_k: int = 2
    n_prefix: int = 16
    n_suffix: int = 16
    n_text_ids: int = 151643
    stop_id: int = 151645

    @property
    def prompt_len(self) -> int:
        return self.n_prefix + self.n_query + self.n_suffix

    @property
    def n_experts(self) -> int:
        """Entries of the router's softmax: the routed experts, then the null ones."""
        return self.n_routed + self.n_null


# Omni presets: the audio tower by its Whisper preset's name; the rest as
# OmniConfig's fields. Uni-MoE-2.0-Omni at its published sizes
# (https://huggingface.co/HIT-TMG/Uni-MoE-2.0-Omni/blob/main/config.json;
# the encoder is Whisper-large-v3's), and a tiny one for the CPU tests that
# keeps its ratios: 7 query heads a KV head, 4 routed experts, a null one and
# 2 fixed ones 1/8 of the routed width, top-p 0.7 capped at 2.
OMNI_PRESETS = {
    "uni-moe-2.0-omni": _P(audio="large-v3"),
    "test-omni": _P(audio="test-nano", n_query=8, d_model=112, n_layer=2, n_head=7,
                    n_kv_head=1, head_dim=16, n_vocab=512, d_fixed=32, d_routed=256,
                    n_prefix=4, n_suffix=4, n_text_ids=500, stop_id=511),
}


def get_omni_config(name: str, **overrides) -> OmniConfig:
    if name not in OMNI_PRESETS:
        raise ValueError(f"unknown omni model {name!r}; known: {sorted(OMNI_PRESETS)}")
    kw = dict(OMNI_PRESETS[name])
    kw.update(overrides)
    if isinstance(kw["audio"], str):
        kw["audio"] = get_config(kw["audio"])
    return OmniConfig(name=name, **kw)
