"""Whisper encoder/decoder in PyTorch.

Port of ``whisper_tpu/models/model.py``. The weights live in ``nn.Module``s
(an ``Encoder`` and a ``Decoder``, each with a ``ModuleList`` of blocks); each
block keeps its sublayers as dicts named like the JAX pytree (``attn``,
``mlp``, ``cross``, ``*_ln``), so a reader finds the counterpart of every
leaf. Matmul weights keep the JAX layout (d_in, d_out) and are either a
tensor or an int8 :class:`~whisper_tpu_torch.ops.quant.QTensor`.

The ops are plain functions on tensors. Matmuls run in the compute dtype;
LayerNorm, softmax and the logits stay fp32 islands, as in the JAX package.
Encoder self-attention always goes through the hand-written kernel
:func:`~whisper_tpu_torch.ops.flash_attention.flash_attention_btd`; the
decode step's self-attention through
:func:`~whisper_tpu_torch.ops.decode_attention.self_attention_decode` (or its
``_int8`` twin for the int8 cache), and its int8 cross-attention through
:func:`~whisper_tpu_torch.ops.decode_attention.cross_attention_decode_fd`.
The W8A8 encoder's int8 x int8 products go through
:func:`~whisper_tpu_torch.ops.int8_gemm.int8_gemm`.

The KV caches are updated IN PLACE (JAX returns new arrays). In
:func:`decoder_forward` a write that would fall outside a cache raises: JAX's
``dynamic_update_slice`` clamps the start instead, which would silently
overwrite other positions. In :func:`decoder_step_multipos` a row whose
write falls outside the cache is dropped, as JAX's scatter drops it.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import WhisperConfig
from ..ops.decode_attention import (
    cross_attention_decode_fd,
    self_attention_decode,
    self_attention_decode_int8,
)
from ..ops.flash_attention import flash_attention_btd
from ..ops.int8_gemm import int8_gemm
from ..ops.quant import QTensor

NEG = -1e30  # masked score, as the JAX package's jnp.float32(-1e30)


# ------------------------------------------------------------------ modules
class _Block(nn.Module):
    """A transformer block: sublayer dicts named as in the JAX pytree."""

    SUBLAYERS: Tuple[str, ...] = ()

    def __init__(self, p: Dict[str, Dict]):
        super().__init__()
        for name in self.SUBLAYERS:
            setattr(self, name, dict(p[name]))

    def sublayers(self) -> Dict[str, Dict]:
        return {name: getattr(self, name) for name in self.SUBLAYERS}


class EncoderBlock(_Block):
    SUBLAYERS = ("attn_ln", "attn", "mlp_ln", "mlp")


class DecoderBlock(_Block):
    SUBLAYERS = ("attn_ln", "attn", "cross_ln", "cross", "mlp_ln", "mlp")


class Encoder(nn.Module):
    def __init__(self, conv1, conv2, pos_emb, ln_post, blocks):
        super().__init__()
        self.conv1 = dict(conv1)  # w (C_out, C_in, 3) torch layout, b (C_out,)
        self.conv2 = dict(conv2)
        self.pos_emb = pos_emb    # (n_audio_ctx, D)
        self.ln_post = dict(ln_post)
        self.blocks = nn.ModuleList(EncoderBlock(p) for p in blocks)


class Decoder(nn.Module):
    def __init__(self, tok_emb, pos_emb, ln, blocks, tok_emb_q8=None):
        super().__init__()
        self.tok_emb = tok_emb    # (V, D), tied logits embedding
        self.pos_emb = pos_emb    # (n_text_ctx, D)
        self.ln = dict(ln)
        self.blocks = nn.ModuleList(DecoderBlock(p) for p in blocks)
        self.tok_emb_q8: Optional[QTensor] = tok_emb_q8


class Whisper(nn.Module):
    """The whole model: ``cfg``, ``encoder`` and ``decoder``."""

    def __init__(self, cfg: WhisperConfig, encoder: Encoder, decoder: Decoder):
        super().__init__()
        self.cfg = cfg
        self.encoder = encoder
        self.decoder = decoder

    @property
    def device(self) -> torch.device:
        return self.decoder.tok_emb.device

    def leaves(self) -> Iterator[Tuple[object, str, object]]:
        """(owner, key, value) of every weight but ``tok_emb_q8``; the owner
        is the dict or module that holds it."""
        enc, dec = self.encoder, self.decoder
        for owner, key in ((enc, "pos_emb"), (dec, "tok_emb"), (dec, "pos_emb")):
            yield owner, key, getattr(owner, key)
        dicts = [enc.conv1, enc.conv2, enc.ln_post, dec.ln]
        dicts += [d for blk in list(enc.blocks) + list(dec.blocks)
                  for d in blk.sublayers().values()]
        for d in dicts:
            for key, val in d.items():
                yield d, key, val

    def to_device(self, device) -> "Whisper":
        """Move every weight (QTensors included) to ``device``, in place."""
        for owner, key, val in self.leaves():
            _set(owner, key, val.to(device))
        if self.decoder.tok_emb_q8 is not None:
            self.decoder.tok_emb_q8 = self.decoder.tok_emb_q8.to(device)
        return self


def _set(owner, key, val) -> None:
    if isinstance(owner, dict):
        owner[key] = val
    else:
        setattr(owner, key, val)


def cast_floating(model: Whisper, dtype: torch.dtype) -> Whisper:
    """Cast floating-point weights to ``dtype`` in place; int8 QTensor
    payloads and their fp32 scales stay as they are (as the JAX
    ``cast_floating``)."""
    for owner, key, val in model.leaves():
        if isinstance(val, torch.Tensor) and val.is_floating_point():
            _set(owner, key, val.to(dtype))
    return model


# ------------------------------------------------------------------ helpers
def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """OpenAI Whisper's sinusoidal positional embedding for the encoder."""
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm island (biased variance); returns x's dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * g.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def _gelu(x: torch.Tensor, gelu: str = "erf") -> torch.Tensor:
    """Exact (erf) GELU, or the tanh approximation with ``gelu="tanh"``."""
    if gelu not in ("erf", "tanh"):
        raise ValueError(f"gelu must be 'erf' or 'tanh', not {gelu!r}")
    return F.gelu(x, approximate="tanh" if gelu == "tanh" else "none")


def _linear(x: torch.Tensor, w, b: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """x @ w (+ b) in ``dtype``. An int8 QTensor is weight-only: the payload
    is cast to the compute dtype and the per-channel scale applied to the
    product."""
    if isinstance(w, QTensor):
        y = torch.matmul(x.to(dtype), w.q.to(dtype)) * w.s.to(dtype).reshape(-1)
    else:
        y = torch.matmul(x.to(dtype), w.to(dtype))
    if b is not None:
        y = y + b.to(dtype)
    return y


def _int8_matmul(x8: torch.Tensor, w: QTensor) -> torch.Tensor:
    """(M, K) int8 @ the (K, N) int8 payload -> int32: the hand-written
    kernel :func:`~whisper_tpu_torch.ops.int8_gemm.int8_gemm` on the card,
    reading the payload K-major (:meth:`QTensor.k_major`); an exact int32
    matmul on the CPU. ``x8`` may be a strided view (the encoder's
    activations keep the conv stem's transposed layout, and at batch 1 the
    flattening stays a view): the kernel reads a contiguous copy."""
    return int8_gemm(x8.contiguous(), w.k_major())


def _linear_a8(x: torch.Tensor, w, b: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """W8A8 matmul: dynamic per-token symmetric int8 activations against the
    int8 weight payload, int32 product, (row scale x channel scale)
    epilogue. Falls back to :func:`_linear` for a weight that is not
    quantized, as the JAX ``_linear_a8`` does."""
    if not isinstance(w, QTensor):
        return _linear(x, w, b, dtype)
    xf = x.to(torch.float32)
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    # a tensor divisor: CUDA turns division by a Python scalar into a product
    # with its reciprocal, which can put the scale one ulp off the CPU's (and
    # the JAX package's) quotient and flip an int8 activation
    sx = amax / amax.new_full((), 127.0)
    x8 = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    lead = x8.shape[:-1]
    y = _int8_matmul(x8.reshape(-1, x8.shape[-1]), w).reshape(*lead, -1)
    y = ((y.to(torch.float32) * sx) * w.s.to(torch.float32).reshape(-1)).to(dtype)
    if b is not None:
        y = y + b.to(dtype)
    return y


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, dh)"""
    B, T, D = x.shape
    return x.reshape(B, T, n_head, D // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, dh) -> (B, T, D)"""
    B, H, T, dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * dh)


def _softmax32(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG))
    return torch.softmax(scores, dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, T, dh), fp32 softmax island;
    the weights are cast to v's dtype before the product with V."""
    dh = q.shape[-1]
    scores = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    w = _softmax32(scores * (dh ** -0.5), mask)
    return torch.matmul(w.to(v.dtype), v)


def attention_kvt(q: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """attention() over position-minor K/V: k_t, v_t are (B, H, dh, Tk)."""
    dh = q.shape[-1]
    scores = torch.matmul(q.to(torch.float32), k_t.to(torch.float32))
    w = _softmax32(scores * (dh ** -0.5), mask)
    return torch.matmul(w.to(v_t.dtype), v_t.transpose(-1, -2))


def attention_int8kv(q, k_q, k_s, v_q, v_s, mask=None) -> torch.Tensor:
    """Attention against transposed int8 K/V (B, H, dh, Tk) with fp32
    (B, H, 1, dh) per-channel scales: K scales fold into q, V scales into
    the output."""
    dt = q.dtype
    dh = q.shape[-1]
    q_scaled = (q.to(torch.float32) * k_s).to(dt)
    scores = torch.matmul(q_scaled.to(torch.float32), k_q.to(torch.float32))
    w = _softmax32(scores * (dh ** -0.5), mask)
    out = torch.matmul(w.to(dt), v_q.to(dt).transpose(-1, -2))
    return (out.to(torch.float32) * v_s).to(dt)


def attention_int8kv_perpos(q, kv_q, kv_s, mask=None) -> torch.Tensor:
    """Attention against a packed per-position int8 cache: kv_q
    (B, H, 2, dh, Tk) int8, kv_s (B, H, 2, Tk) fp32. Score columns scale by
    s_k after q.k, weights by s_v before w.v."""
    dt = q.dtype
    dh = q.shape[-1]
    k_q, v_q = kv_q[:, :, 0], kv_q[:, :, 1]
    scores = torch.matmul(q.to(torch.float32), k_q.to(torch.float32))
    scores = scores * kv_s[:, :, 0][:, :, None, :] * (dh ** -0.5)
    w = _softmax32(scores, mask)
    w = (w * kv_s[:, :, 1][:, :, None, :]).to(dt)
    return torch.matmul(w, v_q.to(dt).transpose(-1, -2))


# ------------------------------------------------------------------ encoder
def encoder_stem(model: Whisper, mel: torch.Tensor, compute_dtype=torch.float32,
                 gelu: str = "erf") -> torch.Tensor:
    """Conv stem + positional embedding: (B, n_mels, 3000) -> (B, Ta, D)."""
    enc = model.encoder
    dt = compute_dtype
    x = mel.to(dt)
    x = _gelu(F.conv1d(x, enc.conv1["w"].to(dt), enc.conv1["b"].to(dt), padding=1), gelu)
    x = _gelu(F.conv1d(x, enc.conv2["w"].to(dt), enc.conv2["b"].to(dt), stride=2,
                       padding=1), gelu)
    x = x.transpose(1, 2)
    return x + enc.pos_emb[: x.shape[1]].to(dt)


def encoder_blocks(model: Whisper, x: torch.Tensor, compute_dtype=torch.float32,
                   lo: int = 0, hi: Optional[int] = None, w8a8: bool = False,
                   gelu: str = "erf") -> torch.Tensor:
    """Transformer blocks [lo, hi) over the stem output. ``w8a8`` runs the
    projections and MLP as int8 x int8 products (attention, conv stem and
    LayerNorm stay in the compute dtype)."""
    dt = compute_dtype
    n_head = model.cfg.n_audio_head
    lin = _linear_a8 if w8a8 else _linear
    for blk in model.encoder.blocks[lo:hi]:
        a = blk.attn
        h = layer_norm(x, blk.attn_ln["g"], blk.attn_ln["b"])
        q = lin(h, a["wq"], a["bq"], dt)
        k = lin(h, a["wk"], None, dt)
        v = lin(h, a["wv"], a["bv"], dt)
        o = flash_attention_btd(q, k, v, n_head)
        x = x + lin(o, a["wo"], a["bo"], dt)
        h = layer_norm(x, blk.mlp_ln["g"], blk.mlp_ln["b"])
        h = _gelu(lin(h, blk.mlp["w1"], blk.mlp["b1"], dt), gelu)
        x = x + lin(h, blk.mlp["w2"], blk.mlp["b2"], dt)
    return x


def encoder_post(model: Whisper, x: torch.Tensor) -> torch.Tensor:
    ln = model.encoder.ln_post
    return layer_norm(x, ln["g"], ln["b"]).to(torch.float32)


def encoder_forward(model: Whisper, mel: torch.Tensor, compute_dtype=torch.float32,
                    w8a8: bool = False, gelu: str = "erf") -> torch.Tensor:
    """Conv stem + transformer encoder -> audio features (B, Ta, D) fp32."""
    x = encoder_stem(model, mel, compute_dtype, gelu)
    x = encoder_blocks(model, x, compute_dtype, w8a8=w8a8, gelu=gelu)
    return encoder_post(model, x)


def compute_cross_kv(model: Whisper, audio_features: torch.Tensor,
                     compute_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-decoder-layer cross-attention K/V, head-major (L, B, H, Ta, dh)."""
    dt = compute_dtype
    x = audio_features.to(dt)
    H = model.cfg.n_text_head
    ks, vs = [], []
    for blk in model.decoder.blocks:
        c = blk.cross
        ks.append(_split_heads(_linear(x, c["wk"], None, dt), H))
        vs.append(_split_heads(_linear(x, c["wv"], c["bv"], dt), H))
    return torch.stack(ks), torch.stack(vs)


def quantize_cross_kv(cross_kv: Tuple[torch.Tensor, torch.Tensor]):
    """Dynamic int8 quantization of the cross-attention K/V, symmetric per
    (layer, batch, head, channel) over the audio axis, 1e-12 scale floor.

    Returns (k_q, k_s, v_q, v_s): int8 stored TRANSPOSED (L, B, H, dh, Ta) so
    each (b, h) row of the decode step's reads is Ta contiguous bytes, and
    fp32 scales (L, B, H, 1, dh). Quantizes one layer at a time to bound the
    fp32 transient."""
    out = []
    for x in cross_kv:
        L, B, H, Ta, dh = x.shape
        q = torch.empty((L, B, H, dh, Ta), dtype=torch.int8, device=x.device)
        s = torch.empty((L, B, H, 1, dh), dtype=torch.float32, device=x.device)
        for l in range(L):
            x32 = x[l].to(torch.float32)
            sl = torch.clamp(x32.abs().amax(dim=2, keepdim=True) / 127.0, min=1e-12)
            q[l] = torch.clamp(torch.round(x32 / sl), -127, 127).to(torch.int8).transpose(-1, -2)
            s[l] = sl
        out += [q, s]
    return tuple(out)


# ------------------------------------------------------------------ decoder
class KVCache(NamedTuple):
    """Self-attention cache, head-major and position-minor:
    k/v (L, B, H, dh, T). :func:`decoder_forward` writes it IN PLACE."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: WhisperConfig, batch: int, dtype=torch.float32,
               ctx: Optional[int] = None, *, device) -> "KVCache":
        shape = (cfg.n_text_layer, batch, cfg.n_text_head, cfg.head_dim_text,
                 ctx or cfg.n_text_ctx)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


class QKVCache(NamedTuple):
    """Int8 self-attention cache, K and V packed: q (L, B, H, 2, dh, T) int8
    ([..., 0, :, :] = K^T, [..., 1, :, :] = V^T) and s (L, B, H, 2, T) fp32
    per-(position, head) scales, initialised to ones. Written IN PLACE."""

    q: torch.Tensor
    s: torch.Tensor

    @classmethod
    def create(cls, cfg: WhisperConfig, batch: int, ctx: Optional[int] = None, *,
               device) -> "QKVCache":
        L, H, dh = cfg.n_text_layer, cfg.n_text_head, cfg.head_dim_text
        T = ctx or cfg.n_text_ctx
        return cls(torch.zeros((L, batch, H, 2, dh, T), dtype=torch.int8, device=device),
                   torch.ones((L, batch, H, 2, T), dtype=torch.float32, device=device))


def quantize_kv_heads(kh: torch.Tensor, vh: torch.Tensor):
    """(B, H, S, dh) k/v -> packed transposed int8 (B, H, 2, dh, S) + fp32
    scales (B, H, 2, S)."""
    x = torch.stack([kh, vh], dim=2).to(torch.float32)  # (B, H, 2, S, dh)
    s = torch.clamp(x.abs().amax(dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127).to(torch.int8)
    return q.transpose(-1, -2), s


def _logits(x: torch.Tensor, dec: Decoder, dt) -> torch.Tensor:
    """Tied-embedding logits: compute-dtype operands, fp32 product (both are
    upcast, which is exact for bf16 values). With ``tok_emb_q8`` the int8
    copy is read and each vocab row rescaled on the fp32 output."""
    xf = x.to(dt).to(torch.float32)
    if dec.tok_emb_q8 is not None:
        q8 = dec.tok_emb_q8
        logits = torch.matmul(xf, q8.q.to(torch.float32).t())
        return logits * q8.s.to(torch.float32).reshape(1, 1, -1)
    return torch.matmul(xf, dec.tok_emb.to(dt).to(torch.float32).t())


def _check_window(offset: int, S: int, T: int, what: str):
    if offset < 0 or offset + S > T:
        raise ValueError(
            f"{what} positions [{offset}, {offset + S}) fall outside [0, {T})")


def decoder_forward(
    model: Whisper,
    tokens: torch.Tensor,   # (B, S) int64
    offset: int,            # write/attend position of tokens[:, 0]
    kv,                     # KVCache or QKVCache, updated in place
    cross_kv,               # (k, v) each (L, B, H, Ta, dh), or the int8 4-tuple
    compute_dtype=torch.float32,
    pad: Optional[torch.Tensor] = None,  # (B,) masked left-pad length
    gelu: str = "erf",
):
    """Run S decoder positions starting at ``offset`` against the KV cache.

    Covers prefill (S = prompt length) and incremental decode (S = 1).
    Returns (logits (B, S, n_vocab) fp32, kv) with ``kv`` written in place at
    positions offset..offset+S-1. Key position t is visible to query s iff
    t <= offset + s over the whole (bucketed) cache; with ``pad`` the first
    pad[b] positions of stream b are never visible and its positional
    embeddings are indexed ``pos - pad[b]``.

    The decode step (S = 1) runs the hand-written kernels: self-attention
    :func:`self_attention_decode` (``_int8`` for a :class:`QKVCache`) and,
    with the int8 cross-KV, :func:`cross_attention_decode_fd`; prefill
    (S > 1) takes :func:`attention_kvt` / :func:`attention_int8kv_perpos`
    and :func:`attention_int8kv`, as the JAX package does.
    """
    cfg = model.cfg
    dec = model.decoder
    dt = compute_dtype
    B, S = tokens.shape
    T = kv[0].shape[-1]
    n_head = cfg.n_text_head
    device = tokens.device
    _check_window(offset, S, T, "KV cache write")

    x = dec.tok_emb[tokens].to(dt)
    if pad is None:
        _check_window(offset, S, dec.pos_emb.shape[0], "positional embedding")
        x = x + dec.pos_emb[offset:offset + S].to(dt)[None]
    else:
        idx = torch.clamp(offset + torch.arange(S, device=device)[None, :] - pad[:, None],
                          0, dec.pos_emb.shape[0] - 1)
        x = x + dec.pos_emb[idx].to(dt)

    vis = None
    if S > 1:
        key_pos = torch.arange(T, device=device)[None, :]
        q_pos = offset + torch.arange(S, device=device)[:, None]
        vis = (key_pos <= q_pos)[None, None]  # (1, 1, S, T)
        if pad is not None:
            vis = vis & (key_pos[None, None] >= pad[:, None, None, None])

    kv_quant = len(cross_kv) == 4
    self_quant = isinstance(kv, QKVCache)
    window = slice(offset, offset + S)
    for layer, blk in enumerate(dec.blocks):
        a = blk.attn
        h = layer_norm(x, blk.attn_ln["g"], blk.attn_ln["b"])
        q = _linear(h, a["wq"], a["bq"], dt)
        k_new = _linear(h, a["wk"], None, dt)
        v_new = _linear(h, a["wv"], a["bv"], dt)
        kh, vh, qh = (_split_heads(t, n_head) for t in (k_new, v_new, q))
        if self_quant:
            qn, sn = quantize_kv_heads(kh, vh)
            kv.q[layer, ..., window] = qn
            kv.s[layer, ..., window] = sn
            if S == 1:
                o = self_attention_decode_int8(qh, kv.q[layer], kv.s[layer], offset, pad)
            else:
                o = attention_int8kv_perpos(qh, kv.q[layer], kv.s[layer], mask=vis)
        else:
            kv.k[layer, ..., window] = kh.transpose(-1, -2).to(kv.k.dtype)
            kv.v[layer, ..., window] = vh.transpose(-1, -2).to(kv.v.dtype)
            if S == 1:
                o = self_attention_decode(qh, kv.k[layer], kv.v[layer], offset, pad)
            else:
                o = attention_kvt(qh, kv.k[layer].to(dt), kv.v[layer].to(dt), mask=vis)
        x = x + _linear(_merge_heads(o), a["wo"], a["bo"], dt)
        x = _cross_and_mlp(x, blk, layer, cross_kv, kv_quant and S == 1, n_head, dt, gelu)

    x = layer_norm(x, dec.ln["g"], dec.ln["b"])
    return _logits(x, dec, dt), kv


def _cross_and_mlp(x, blk: DecoderBlock, layer: int, cross_kv, decode_kernel: bool,
                   n_head: int, dt, gelu: str) -> torch.Tensor:
    """A decoder block after its self-attention: cross-attention (the int8
    decode kernel where ``decode_kernel``) and the MLP, residuals included."""
    c = blk.cross
    h = layer_norm(x, blk.cross_ln["g"], blk.cross_ln["b"])
    qh = _split_heads(_linear(h, c["wq"], c["bq"], dt), n_head)
    if decode_kernel:
        o = cross_attention_decode_fd(qh, *(t[layer] for t in cross_kv))
    elif len(cross_kv) == 4:
        o = attention_int8kv(qh, *(t[layer] for t in cross_kv))
    else:
        o = attention(qh, cross_kv[0][layer].to(dt), cross_kv[1][layer].to(dt))
    x = x + _linear(_merge_heads(o), c["wo"], c["bo"], dt)
    h = layer_norm(x, blk.mlp_ln["g"], blk.mlp_ln["b"])
    h = _gelu(_linear(h, blk.mlp["w1"], blk.mlp["b1"], dt), gelu)
    return x + _linear(h, blk.mlp["w2"], blk.mlp["b2"], dt)


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, at: torch.Tensor,
                inside: torch.Tensor, new: torch.Tensor) -> None:
    """cache[rows[b], ..., at[b]] = new[b] for every row b whose position is
    ``inside`` the cache; the other rows write back the value already there,
    so their write is dropped (JAX's scatter ``mode="drop"``). ``at`` is
    clamped into the cache only so that the dropped rows index something;
    every row writes its own b, so no two writes meet. No host sync."""
    old = cache[rows, ..., at]
    keep = inside.reshape(-1, *([1] * (new.dim() - 1)))
    cache[rows, ..., at] = torch.where(keep, new.to(cache.dtype), old)


def decoder_step_multipos(
    model: Whisper,
    tokens: torch.Tensor,   # (B,) int64: one token per stream
    offsets: torch.Tensor,  # (B,) int64: per-stream write/attend position
    kv,                     # KVCache or QKVCache, updated in place
    cross_kv,               # (k, v) each (L, B, H, Ta, dh), or the int8 4-tuple
    compute_dtype=torch.float32,
    pads: Optional[torch.Tensor] = None,  # (B,) int64 masked left-pad length
    gelu: str = "erf",
) -> Tuple[torch.Tensor, object]:
    """One decode step where every stream sits at its own position: the
    continuous-batching primitive (port of the JAX
    ``decoder_step_multipos``).

    Row b writes its K/V at ``offsets[b]`` and attends to positions
    ``pads[b] <= t <= offsets[b]``; its positional embedding is indexed
    ``offsets[b] - pads[b]``, clipped to the table. A row whose offset falls
    outside [0, T) writes nothing (JAX drops it) and attends to the whole
    cache. Self-attention runs :func:`self_attention_decode` (``_int8`` for
    a :class:`QKVCache`), the int8 cross-attention
    :func:`cross_attention_decode_fd`. Returns (logits (B, n_vocab) fp32,
    kv). Nothing here reads the device from the host.
    """
    cfg = model.cfg
    dec = model.decoder
    dt = compute_dtype
    B = tokens.shape[0]
    T = kv[0].shape[-1]
    n_head, dh = cfg.n_text_head, cfg.head_dim_text
    rows = torch.arange(B, device=tokens.device)

    pos_idx = offsets if pads is None else offsets - pads
    pos_idx = torch.clamp(pos_idx, 0, dec.pos_emb.shape[0] - 1)
    x = (dec.tok_emb[tokens].to(dt) + dec.pos_emb[pos_idx].to(dt))[:, None, :]  # (B, 1, D)
    inside = (offsets >= 0) & (offsets < T)
    at = torch.clamp(offsets, 0, T - 1)

    kv_quant = len(cross_kv) == 4
    self_quant = isinstance(kv, QKVCache)
    for layer, blk in enumerate(dec.blocks):
        a = blk.attn
        h = layer_norm(x, blk.attn_ln["g"], blk.attn_ln["b"])
        qh = _split_heads(_linear(h, a["wq"], a["bq"], dt), n_head)
        kh = _linear(h, a["wk"], None, dt).reshape(B, n_head, dh)
        vh = _linear(h, a["wv"], a["bv"], dt).reshape(B, n_head, dh)
        if self_quant:
            qn, sn = quantize_kv_heads(kh[:, :, None], vh[:, :, None])
            # advanced indices at dims 0 and 4 of the (B, H, 2, dh, T) view:
            # the indexed shape is (B, H, 2, dh)
            _write_rows(kv.q[layer], rows, at, inside, qn[..., 0])
            _write_rows(kv.s[layer], rows, at, inside, sn[..., 0])
            o = self_attention_decode_int8(qh, kv.q[layer], kv.s[layer], offsets, pads)
        else:
            _write_rows(kv.k[layer], rows, at, inside, kh)
            _write_rows(kv.v[layer], rows, at, inside, vh)
            o = self_attention_decode(qh, kv.k[layer], kv.v[layer], offsets, pads)
        x = x + _linear(_merge_heads(o), a["wo"], a["bo"], dt)
        x = _cross_and_mlp(x, blk, layer, cross_kv, kv_quant, n_head, dt, gelu)

    x = layer_norm(x, dec.ln["g"], dec.ln["b"])
    return _logits(x, dec, dt)[:, 0], kv
