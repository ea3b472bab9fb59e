"""The plain reference: OpenAI Whisper's forward pass in float32 PyTorch.

Mel (a float64 DFT of reflect-padded frames, the slaney filterbank, log10,
the -8 dB clamp against each clip's own maximum over its valid frames, zero
features past them), the encoder (conv stem, pre-LayerNorm blocks, exact
GELU), and the decoder run teacher-forced over whole sequences with a
causal mask: no kernel, no cache, no batching across requests' lengths.
It imports nothing of the port and takes nothing it made: it reads the
weights this benchmark makes from the seed (``weights.py``) and works the
rest out again.

``quant="int4"`` is the control: the same pass with every tensor the
configuration serves in int8 (the attention and MLP weights per output
channel, the encoder linears' activations per row, the cross-attention K/V
per channel over the audio, the self-attention K/V per position and head)
rounded to symmetric 4 bits instead, the next precision below.

The rules of the decode (``allowed``): OpenAI's default suppression
without timestamps (every special token and timestamp, the non-speech
symbols of ``vocab.json``, ``<|endoftext|>`` and the blank at the first
sampled position), so the reference's best token is taken over the tokens
the decode may emit.
"""

from __future__ import annotations

import base64
import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .weights import Dims

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLE_RATE, N_FFT, HOP, N_FRAMES = 16000, 400, 160, 3000
N_SAMPLES = SAMPLE_RATE * 30
ZERO_TAIL_FRAMES = 50  # a full 30 s clip's last frames read as zero features

# OpenAI Whisper's language codes in token order (the first ``num_languages``)
LANGUAGE_CODES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu ta no "
    "th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn bs kk sq sw "
    "gl mr pa si km sn yo so af oc ka be tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl "
    "mg as tt haw ln ha ba jw su yue").split()


# ------------------------------------------------------------------ tokens
class Specials:
    """The multilingual special-token layout: ``<|endoftext|>`` 50257, then
    ``<|startoftranscript|>``, the languages, translate, transcribe,
    startoflm, startofprev, nospeech, notimestamps and the timestamps."""

    def __init__(self, dims: Dims):
        self.eot = 50257
        self.sot = 50258
        self.lang_start = 50259
        nxt = self.lang_start + dims.num_languages
        self.translate, self.transcribe = nxt, nxt + 1
        self.no_timestamps = nxt + 5
        self.timestamp_begin = nxt + 6
        self.n_vocab = dims.n_vocab

    def prompt(self, language: str, task: str = "transcribe") -> List[int]:
        lang = self.lang_start + LANGUAGE_CODES.index(language)
        return [self.sot, lang, self.transcribe if task == "transcribe" else self.translate,
                self.no_timestamps]


def load_vocab_rules() -> dict:
    """``vocab.json``: the blank token and the non-speech symbols' ids."""
    with open(os.path.join(HERE, "vocab.json")) as f:
        return json.load(f)


def allowed_mask(dims: Dims, device, first: bool) -> torch.Tensor:
    """(V,) bool: the tokens a decode without timestamps may emit at a
    position (``first``: the first sampled one)."""
    sp, rules = Specials(dims), load_vocab_rules()
    ok = torch.zeros(dims.n_vocab, dtype=torch.bool, device=device)
    ok[: sp.eot + 1] = True
    ok[torch.as_tensor(rules["non_speech"], device=device)] = False
    if first:
        ok[rules["blank"]] = False
        ok[sp.eot] = False
    return ok


def bpe_ranks(path: str) -> Dict[bytes, int]:
    """A tiktoken rank file: one base64 token and its rank a line."""
    ranks = {}
    with open(path, "rb") as f:
        for line in f:
            if line.strip():
                tok, rank = line.split()
                ranks[base64.b64decode(tok)] = int(rank)
    return ranks


def bpe_encode(data: bytes, ranks: Dict[bytes, int]) -> List[int]:
    """Byte-pair encoding of one pre-token: merge the adjacent pair of
    lowest rank until none is in the table."""
    parts = [bytes([b]) for b in data]
    while len(parts) > 1:
        best = min(range(len(parts) - 1),
                   key=lambda i: ranks.get(parts[i] + parts[i + 1], math.inf))
        if parts[best] + parts[best + 1] not in ranks:
            break
        parts[best: best + 2] = [parts[best] + parts[best + 1]]
    return [ranks[p] for p in parts]


def vocab_rules(ranks: Dict[bytes, int]) -> dict:
    """OpenAI Whisper's non-speech symbols (in bare and space-led form when
    one token; musical notes by their first token) and the blank, worked
    out from a rank table: what ``vocab.json`` holds."""
    singles = '"#()*+/:;<=>@[\\]^_`{|}~「」『』'
    multis = "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
    notes = "♩♪♫♬♭♮♯"
    ids = {bpe_encode(b" -", ranks)[0], bpe_encode(b" '", ranks)[0]}
    for sym in [*singles, *multis, *notes]:
        for variant in (sym, " " + sym):
            toks = bpe_encode(variant.encode("utf-8"), ranks)
            if len(toks) == 1 or sym in notes:
                ids.add(toks[0])
    return {"blank": bpe_encode(b" ", ranks)[0], "non_speech": sorted(ids)}


# ------------------------------------------------------------------ mel
def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    lin = f / f_sp
    return np.where(f >= min_log_hz, min_log_hz / f_sp
                    + np.log(np.maximum(f, 1e-12) / min_log_hz) / logstep, lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa's slaney-normalised mel filterbank at 16 kHz, n_fft 400:
    (n_mels, 201) float64."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(np.array(0.0)), _hz_to_mel(np.array(SAMPLE_RATE / 2)),
                                n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    return weights * (2.0 / (hz[2: n_mels + 2] - hz[:n_mels]))[:, None]


def log_mel(audio: torch.Tensor, n_samples: Sequence[int], n_mels: int) -> torch.Tensor:
    """(B, N_SAMPLES) zero-padded clips and their true sample counts ->
    (B, n_mels, 3000) float32 features."""
    x = F.pad(audio.double()[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(1, N_FFT, HOP)[:, :N_FRAMES]  # (B, 3000, 400)
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=x.device)
    power = torch.fft.rfft(frames * window, dim=-1).abs().square()  # (B, 3000, 201)
    fb = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    spec = torch.log10(torch.clamp(torch.matmul(power, fb.t()), min=1e-10)).transpose(1, 2)
    n = torch.as_tensor(list(n_samples), device=x.device)
    n_valid = torch.where(n >= N_SAMPLES, N_FRAMES - ZERO_TAIL_FRAMES,
                          torch.clamp(n // HOP + 1, max=N_FRAMES))
    valid = torch.arange(N_FRAMES, device=x.device)[None] < n_valid[:, None]
    top = torch.where(valid[:, None], spec, -math.inf).amax(dim=(1, 2))
    feats = (torch.maximum(spec, top[:, None, None] - 8.0) + 4.0) / 4.0
    return torch.where(valid[:, None], feats, 0.0).float()


# ------------------------------------------------------------------ control rounding
def _round_sym(x: torch.Tensor, dims, bits: int) -> torch.Tensor:
    """Symmetric rounding to ``bits`` over ``dims`` (one scale per the rest)."""
    top = 2 ** (bits - 1) - 1
    s = torch.clamp(x.abs().amax(dim=dims, keepdim=True), min=1e-12) / top
    return torch.clamp(torch.round(x / s), -top, top) * s


# ------------------------------------------------------------------ model
class Reference:
    """Whisper in float32 over the weights of ``weights.make_weights``;
    ``quant="int4"`` makes it the control (module docstring)."""

    def __init__(self, dims: Dims, w: dict, quant: Optional[str] = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dims, self.w = dims, w
        self.bits = {None: None, "int4": 4}[quant]

    def _weight(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.bits is None else _round_sym(t, (0,), self.bits)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.bits is None else _round_sym(x, (-1,), self.bits)

    @staticmethod
    def _ln(x, p):
        return F.layer_norm(x, x.shape[-1:], p["g"], p["b"], eps=1e-5)

    @staticmethod
    def _attend(q, k, v, mask=None):
        scores = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        if mask is not None:
            scores = scores.masked_fill(~mask, -math.inf)
        return torch.matmul(torch.softmax(scores, dim=-1), v)

    def _heads(self, x: torch.Tensor, n_head: int) -> torch.Tensor:
        B, T, D = x.shape
        return x.view(B, T, n_head, D // n_head).transpose(1, 2)

    def _linear(self, x, w, b=None, act=False):
        y = torch.matmul(self._act(x) if act else x, self._weight(w))
        return y if b is None else y + b

    # the encoder's projections are the W8A8 linears: activations round too
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) -> audio features (B, n_audio_ctx, D)."""
        e, d = self.w["encoder"], self.dims
        x = F.gelu(F.conv1d(mel, e["conv1"]["w"], e["conv1"]["b"], padding=1))
        x = F.gelu(F.conv1d(x, e["conv2"]["w"], e["conv2"]["b"], stride=2, padding=1))
        x = x.transpose(1, 2)[:, : d.n_audio_ctx] + e["pos_emb"]
        for blk in e["blocks"]:
            a, h = blk["attn"], self._ln(x, blk["attn_ln"])
            q, k, v = (self._heads(self._linear(h, a[n], a.get(b), act=True), d.n_audio_head)
                       for n, b in (("wq", "bq"), ("wk", None), ("wv", "bv")))
            o = self._attend(q, k, v)
            x = x + self._linear(o.transpose(1, 2).flatten(2), a["wo"], a["bo"], act=True)
            m, h = blk["mlp"], self._ln(x, blk["mlp_ln"])
            h = F.gelu(self._linear(h, m["w1"], m["b1"], act=True))
            x = x + self._linear(h, m["w2"], m["b2"], act=True)
        return self._ln(x, e["ln_post"])

    def logits(self, audio: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (B, S, V) of ``tokens`` (B, S) over the
        audio features, causal over the sequence."""
        dec, d = self.w["decoder"], self.dims
        S = tokens.shape[1]
        x = dec["tok_emb"][tokens] + dec["pos_emb"][:S]
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        for blk in dec["blocks"]:
            a, h = blk["attn"], self._ln(x, blk["attn_ln"])
            q, k, v = (self._heads(self._linear(h, a[n], a.get(b)), d.n_text_head)
                       for n, b in (("wq", "bq"), ("wk", None), ("wv", "bv")))
            if self.bits is not None:  # the self-KV cache: a scale per position and head
                k, v = _round_sym(k, (-1,), self.bits), _round_sym(v, (-1,), self.bits)
            o = self._attend(q, k, v, causal)
            x = x + self._linear(o.transpose(1, 2).flatten(2), a["wo"], a["bo"])
            c, h = blk["cross"], self._ln(x, blk["cross_ln"])
            q = self._heads(self._linear(h, c["wq"], c["bq"]), d.n_text_head)
            k = self._heads(self._linear(audio, c["wk"]), d.n_text_head)
            v = self._heads(self._linear(audio, c["wv"], c["bv"]), d.n_text_head)
            if self.bits is not None:  # the cross-KV: a scale per channel over the audio
                k, v = _round_sym(k, (-2,), self.bits), _round_sym(v, (-2,), self.bits)
            o = self._attend(q, k, v)
            x = x + self._linear(o.transpose(1, 2).flatten(2), c["wo"], c["bo"])
            m, h = blk["mlp"], self._ln(x, blk["mlp_ln"])
            x = x + self._linear(F.gelu(self._linear(h, m["w1"], m["b1"])), m["w2"], m["b2"])
        return torch.matmul(self._ln(x, dec["ln"]), dec["tok_emb"].t())
