"""Whisper encoder/decoder in PyTorch.

Port of ``whisper_tpu/models/model.py``. The weights live in ``nn.Module``s
(an ``Encoder`` and a ``Decoder``, each with a ``ModuleList`` of blocks); each
block keeps its sublayers as dicts named like the JAX pytree (``attn``,
``mlp``, ``cross``, ``*_ln``), so a reader finds the counterpart of every
leaf. Matmul weights keep the JAX layout (d_in, d_out) and are either a
tensor or an int8 :class:`~whisper_tpu_torch.ops.quant.QTensor`.

The ops are plain functions on tensors. Matmuls run in the compute dtype;
LayerNorm, softmax and the logits stay fp32 islands, as in the JAX package.
Encoder self-attention always goes through a hand-written kernel, chosen by
``attn`` (the JAX package's ``WHISPER_TPU_FLASH``): ``"btd"`` (default)
:func:`~whisper_tpu_torch.ops.flash_attention.flash_attention_btd` on the
(B, T, D) layout, ``"bhtd"``
:func:`~whisper_tpu_torch.ops.flash_attention.flash_attention` on split heads.
The decode step's self-attention goes through
:func:`~whisper_tpu_torch.ops.decode_attention.self_attention_decode` (or its
``_int8`` twin for the int8 cache), and its int8 cross-attention through the
kernel ``cross_decode`` names (the JAX package's
``WHISPER_TPU_DECODE_FLASH``): ``"fd"`` (default)
:func:`~whisper_tpu_torch.ops.decode_attention.cross_attention_decode_fd`,
``"legacy"`` :func:`~whisper_tpu_torch.ops.decode_attention.cross_attention_decode`
(its default, non-``use_vpu`` form, as the JAX model calls it) or ``"dense"``
:func:`~whisper_tpu_torch.ops.decode_attention.cross_attention_decode_dense`.
The JAX value ``0`` of both knobs (XLA's einsum attention) has no
counterpart: on the card every attention at these sites runs a kernel, and
an unknown selection raises ``ValueError``. Beam search's step
(``decoder_forward(beam_k=K)``) is the exception JAX makes too: its
cross-attention folds the beams into the query axis and is the plain
product, with no kernel selected. The W8A8 encoder's linears go
through two kernels: the row quantization
:func:`~whisper_tpu_torch.ops.quantize_rows.quantize_rows` (K8q) and the int8
GEMM with the scale epilogue fused in,
:func:`~whisper_tpu_torch.ops.int8_gemm.int8_gemm_scaled` (K8).

Tensor parallelism: every forward function also takes a
:class:`ShardedWhisper` (``parallel.sharding.shard_params``), whose ranks
hold their local heads and MLP columns. The ranks of a layer run in rank
order in one process; the row-parallel products are summed on the lead
device (:func:`_row_parallel`), so no process group is needed, and caches
and cross-KV come as :class:`Shards`, one per rank over its local heads. A
``Whisper`` is the one-rank case of the same code.

Data parallelism: on a mesh with more than one data row ``shard_params``
gives a :class:`DataParallelWhisper`, one ``ShardedWhisper`` per row. Every
forward function splits its batch into the rows' contiguous blocks (the
JAX package's DATA axis of ``data_specs``), runs each block as above on its
row's devices and gathers the outputs on the lead device; caches and
cross-KV stay per row, as :class:`DataRows`. A batch the rows do not divide
raises ``ValueError``, as JAX's ``device_put`` of a data-sharded array does.

The KV caches are updated IN PLACE (JAX returns new arrays). In
:func:`decoder_forward` a write that would fall outside a cache raises: JAX's
``dynamic_update_slice`` clamps the start instead, which would silently
overwrite other positions. In :func:`decoder_step_multipos` and
:func:`decoder_window_multipos` (W tokens a row, the verify window of
``spec_decode``) a write that falls outside the cache is dropped, as JAX's
scatter drops it.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import WhisperConfig
from ..ops.decode_attention import (
    cross_attention_decode,
    cross_attention_decode_dense,
    cross_attention_decode_fd,
    self_attention_decode,
    self_attention_decode_int8,
)
from ..ops.flash_attention import flash_attention, flash_attention_btd_local
from ..ops.int8_gemm import int8_gemm, int8_gemm_scaled, scale_epilogue
from ..ops.quant import QTensor
from ..ops.quantize_rows import quantize_rows, row_scale

NEG = -1e30  # masked score, as the JAX package's jnp.float32(-1e30)

# the kernel selections: encoder attention (WHISPER_TPU_FLASH=btd|bhtd) and
# the S=1 int8 cross-attention (WHISPER_TPU_DECODE_FLASH=fd|legacy|dense)
ENCODER_ATTENTION = ("btd", "bhtd")
CROSS_DECODE = ("fd", "legacy", "dense")


def check_selections(encoder_attention: str = "btd", cross_decode: str = "fd") -> None:
    """Raise ValueError on a selection the port has no kernel for."""
    if encoder_attention not in ENCODER_ATTENTION:
        raise ValueError(f"encoder_attention must be one of {ENCODER_ATTENTION}, "
                         f"not {encoder_attention!r}")
    if cross_decode not in CROSS_DECODE:
        raise ValueError(f"cross_decode must be one of {CROSS_DECODE}, not {cross_decode!r}")


def _cross_decode_kernel(kind: str):
    """The S=1 int8 cross-attention kernel ``kind`` selects ("legacy" in
    its default ``use_vpu=False`` form, as the JAX model calls it)."""
    return {"fd": cross_attention_decode_fd, "legacy": cross_attention_decode,
            "dense": cross_attention_decode_dense}[kind]


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


class ShardedWhisper:
    """A :class:`Whisper` split over the MODEL axis of a mesh
    (``parallel.sharding.shard_params``). ``shards[r]`` is a ``Whisper`` on
    rank r's device holding its local attention heads and MLP columns:
    column-parallel ``wq/bq/wk/wv/bv/w1/b1``, row-parallel ``wo/w2``; the
    other weights are replicated. With ``vocab_split`` the token embedding
    (and its int8 logits copy) is split over the vocabulary, rank r holding
    rows ``r * V / tp`` onwards.

    The forward functions of this module take it wherever they take a
    ``Whisper``, and run the ranks of a layer in rank order: each rank's
    local products on its device, then the row-parallel partial products
    summed on the lead device (``shards[0]``'s) in rank order, which is the
    all-reduce; replicated activations (LayerNorm, residuals, logits rules)
    are computed once there. A ``Whisper`` is the one-shard case of the
    same code."""

    def __init__(self, cfg: WhisperConfig, shards, mesh=None, vocab_split: bool = False):
        self.cfg = cfg
        self.shards = tuple(shards)
        self.mesh = mesh
        self.vocab_split = vocab_split

    @property
    def device(self) -> torch.device:
        return self.shards[0].device


class Shards(tuple):
    """Per-rank values under a :class:`ShardedWhisper`, in rank order: its
    self-KV caches (each over the rank's local heads) and its cross-KV
    tuples."""


class DataParallelWhisper:
    """A :class:`Whisper` on a (data, model) mesh with ``n_data > 1``
    (``parallel.sharding.shard_params``): ``rows[d]`` is the
    :class:`ShardedWhisper` of data row d, its ranks on
    ``mesh.devices[d, :]``. Every forward function of this module takes it
    and runs row d on the d-th contiguous block of the batch (one SPMD
    program's DATA axis, in row order in one process); the outputs are
    gathered on the lead device (``rows[0]``'s), and caches and cross-KV
    stay per row as :class:`DataRows`. The decode loops are unchanged: they
    read one all-done flag a step for all rows."""

    def __init__(self, cfg: WhisperConfig, rows, mesh):
        self.cfg = cfg
        self.rows = tuple(rows)
        self.mesh = mesh

    @property
    def device(self) -> torch.device:
        return self.rows[0].device


class DataRows(tuple):
    """Per-data-row values under a :class:`DataParallelWhisper`, in row
    order: self-KV caches and cross-KV, each over its row's block of the
    batch (a :class:`Shards` where a row has several ranks)."""


def _row_size(model: DataParallelWhisper, n: int, unit: int = 1) -> int:
    """Rows of a data row's block of an ``n``-row batch; ``unit`` rows (an
    utterance's beams) must stay in one block."""
    n_data = len(model.rows)
    if n % (n_data * unit):
        raise ValueError(f"a batch of {n} rows does not split over {n_data} data rows"
                         + (f" in whole groups of {unit}" if unit > 1 else ""))
    return n // n_data


def _row_blocks(model: DataParallelWhisper, t: Optional[torch.Tensor], unit: int = 1) -> list:
    """The data rows' contiguous blocks of ``t`` along dim 0, each on its
    row's lead device (a view where it is there already); None for every
    row where ``t`` is None."""
    if t is None:
        return [None] * len(model.rows)
    n = _row_size(model, t.shape[0], unit)
    return [_to(t[d * n:(d + 1) * n], m.device) for d, m in enumerate(model.rows)]


def _row_values(model: DataParallelWhisper, x, what: str) -> DataRows:
    if not (isinstance(x, DataRows) and len(x) == len(model.rows)):
        raise TypeError(f"{what} under {len(model.rows)} data rows must be DataRows of as "
                        "many (new_kv_cache and compute_cross_kv make them)")
    return x


def _gather(model: DataParallelWhisper, blocks) -> torch.Tensor:
    """The rows' output blocks as one batch on the lead device."""
    return torch.cat([_to(b, model.device) for b in blocks], dim=0)


def model_shards(model) -> Tuple[Whisper, ...]:
    """The ranks of ``model``: its shards, or the ``Whisper`` itself."""
    return model.shards if isinstance(model, ShardedWhisper) else (model,)


def shard_values(x) -> tuple:
    """A cache or cross-KV as per-rank values: a :class:`Shards` as it is,
    anything else as the one value of an unsharded model."""
    return x if isinstance(x, Shards) else (x,)


def _pack(values):
    """Per-rank values as one: the value itself for a single rank."""
    return values[0] if len(values) == 1 else Shards(values)


def _to(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``; nothing moves when it is there already."""
    return t if t.device == device else t.to(device)


def _set(owner, key, val) -> None:
    if isinstance(owner, dict):
        owner[key] = val
    else:
        setattr(owner, key, val)


def cast_floating(model, dtype: torch.dtype):
    """Cast floating-point weights to ``dtype`` in place (every shard of a
    :class:`ShardedWhisper`); int8 QTensor payloads and their fp32 scales
    stay as they are (as the JAX ``cast_floating``)."""
    for shard in model_shards(model):
        for owner, key, val in shard.leaves():
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


def _quantize_a8(x: torch.Tensor, sx: Optional[torch.Tensor] = None) -> tuple:
    """(..., K) activations -> (int8 rows (M, K), fp32 row scales (M, 1), the
    leading shape): the K8q wrapper
    :func:`~whisper_tpu_torch.ops.quantize_rows.quantize_rows` on the
    flattened rows (a view of a contiguous ``x``; a strided ``x``, such as a
    batch-1 transposed view, is read through a contiguous copy), at ``sx``
    (..., 1) when given."""
    K = x.shape[-1]
    if sx is not None:
        sx = sx.reshape(-1, 1)
    x8, sx = quantize_rows(x.reshape(-1, K).contiguous(), sx)
    return x8, sx, x.shape[:-1]


def _a8_scaled(xq: tuple, w: QTensor, b: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """One W8A8 product of quantized activations ``xq`` (:func:`_quantize_a8`)
    with the weight's payload read K-major (:meth:`QTensor.k_major`), the
    (row scale x channel scale) epilogue and the bias fused into K8
    (:func:`~whisper_tpu_torch.ops.int8_gemm.int8_gemm_scaled`)."""
    x8, sx, lead = xq
    return int8_gemm_scaled(x8, w.k_major(), sx, w.s, b, dtype).reshape(*lead, -1)


def _linear_a8(x: torch.Tensor, w, b: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """W8A8 matmul: dynamic per-token symmetric int8 activations against the
    int8 weight payload, int32 product, (row scale x channel scale)
    epilogue; on the card two launches, K8q and K8. Falls back to
    :func:`_linear` for a weight that is not quantized, as the JAX
    ``_linear_a8`` does."""
    if not isinstance(w, QTensor):
        return _linear(x, w, b, dtype)
    return _a8_scaled(_quantize_a8(x), w, b, dtype)


def _weight_device(w) -> torch.device:
    return w.q.device if isinstance(w, QTensor) else w.device


def _column(h: torch.Tensor, per_rank, dtype, a8: bool = False) -> list:
    """Column-parallel products of the replicated activation ``h``:
    ``per_rank[r]`` lists rank r's (weight, bias) pairs, and rank r gets
    ``[h @ w + b, ...]`` on its device. With ``a8`` and quantized weights
    each rank quantizes ``h`` once for all its products (:func:`_linear_a8`'s
    bits: the rows of ``h`` span its full width on every rank, so each
    rank's columns are the one-rank product's)."""
    out = []
    for pairs in per_rank:
        hs = _to(h, _weight_device(pairs[0][0]))
        if a8 and all(isinstance(w, QTensor) for w, _ in pairs):
            hq = _quantize_a8(hs)
            out.append([_a8_scaled(hq, w, b, dtype) for w, b in pairs])
        else:
            lin = _linear_a8 if a8 else _linear
            out.append([lin(hs, w, b, dtype) for w, b in pairs])
    return out


def _row_parallel(xs, ws, b: Optional[torch.Tensor], dtype, a8: bool = False) -> torch.Tensor:
    """sum over ranks of ``xs[r] @ ws[r]`` (+ ``b``), on the lead device:
    each rank's partial product of its rows of the weight against its local
    columns of the activation, summed in rank order (the all-reduce), then
    the bias once.

    With ``a8`` and a quantized weight (W8A8) every rank quantizes its
    columns with the GLOBAL row scale, from the maximum of the ranks' local
    row maxima (as GSPMD computes it), and the int32 partial products are
    summed before the (row scale x channel scale) epilogue. The int32 sum
    is exact, so any number of ranks gives the bits of one."""
    if len(xs) == 1:
        return (_linear_a8 if a8 else _linear)(xs[0], ws[0], b, dtype)
    lead = xs[0].device
    if a8 and isinstance(ws[0], QTensor):
        amax = None
        for x in xs:  # |x| and its maximum are exact in any float dtype
            m = _to(x.abs().amax(dim=-1, keepdim=True).to(torch.float32), lead)
            amax = m if amax is None else torch.maximum(amax, m)
        sx = row_scale(amax)
        acc = None
        for x, w in zip(xs, ws):
            x8, _, shape = _quantize_a8(x, _to(sx, x.device))
            y = int8_gemm(x8, w.k_major()).reshape(*shape, -1)
            acc = y if acc is None else acc + _to(y, lead)
        return scale_epilogue(acc, sx, ws[0].s, b, dtype)
    acc = None
    for x, w in zip(xs, ws):
        y = _linear(x, w, None, dtype)
        acc = y if acc is None else acc + _to(y, lead)
    return acc if b is None else acc + b.to(dtype)


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
def encoder_stem(model, mel: torch.Tensor, compute_dtype=torch.float32,
                 gelu: str = "erf") -> torch.Tensor:
    """Conv stem + positional embedding: (B, n_mels, 3000) -> (B, Ta, D)
    (on the lead device under a mesh)."""
    enc = model_shards(model)[0].encoder
    dt = compute_dtype
    x = mel.to(dt)
    x = _gelu(F.conv1d(x, enc.conv1["w"].to(dt), enc.conv1["b"].to(dt), padding=1), gelu)
    x = _gelu(F.conv1d(x, enc.conv2["w"].to(dt), enc.conv2["b"].to(dt), stride=2,
                       padding=1), gelu)
    x = x.transpose(1, 2)
    # written (B, T, D) contiguous, not in the conv's transposed layout: every
    # LayerNorm then reduces over contiguous rows, and K8q reads them in place
    return torch.add(x, enc.pos_emb[: x.shape[1]].to(dt), out=x.new_empty(x.shape))


def encoder_blocks(model, x: torch.Tensor, compute_dtype=torch.float32,
                   lo: int = 0, hi: Optional[int] = None, w8a8: bool = False,
                   gelu: str = "erf", attn: str = "btd") -> torch.Tensor:
    """Transformer blocks [lo, hi) over the stem output. ``w8a8`` runs the
    projections and MLP as int8 x int8 products (attention, conv stem and
    LayerNorm stay in the compute dtype). ``attn="btd"`` runs the attention
    on the (B, T, D) projections as they are; ``"bhtd"`` splits heads into
    contiguous (B, H, T, dh) copies, runs the split-head kernel and merges
    back, as the JAX package does under ``WHISPER_TPU_FLASH=bhtd``.

    Under a mesh (:class:`ShardedWhisper`) each rank projects its local
    heads, runs the attention kernel on them (``btd``: K1 per rank through
    :func:`~whisper_tpu_torch.ops.flash_attention.flash_attention_btd_local`,
    the sharded entry's launch; ``bhtd``: K6 per rank) and its partial
    ``wo``; the MLP splits the same way (:func:`_column`,
    :func:`_row_parallel`). W8A8 then gives the one-rank encoder's bits.
    Every K1 launch under a mesh of more than one block (data rows or
    ranks) also counts as one of ``flash_attention_btd_sharded``'s."""
    check_selections(encoder_attention=attn)
    dt = compute_dtype
    shards = model_shards(model)
    on_mesh = (isinstance(model, ShardedWhisper) and model.mesh is not None
               and model.mesh.devices.size > 1)
    n_local = model.cfg.n_audio_head // len(shards)
    for i in range(len(shards[0].encoder.blocks))[lo:hi]:
        blks = [s.encoder.blocks[i] for s in shards]
        b0 = blks[0]
        # the LayerNorm outputs are not kept past their products (peak memory)
        qkv = _column(layer_norm(x, b0.attn_ln["g"], b0.attn_ln["b"]),
                      [[(blk.attn["wq"], blk.attn["bq"]), (blk.attn["wk"], None),
                        (blk.attn["wv"], blk.attn["bv"])] for blk in blks], dt, w8a8)
        if attn == "btd":
            outs = flash_attention_btd_local(*zip(*qkv), model.cfg.n_audio_head,
                                             sharded=on_mesh)
        else:
            outs = [_merge_heads(flash_attention(
                *(_split_heads(t, n_local).contiguous() for t in p))) for p in qkv]
        x = x + _row_parallel(outs, [blk.attn["wo"] for blk in blks], b0.attn["bo"], dt, w8a8)
        hs = [_gelu(y, gelu) for (y,) in _column(
            layer_norm(x, b0.mlp_ln["g"], b0.mlp_ln["b"]),
            [[(blk.mlp["w1"], blk.mlp["b1"])] for blk in blks], dt, w8a8)]
        x = x + _row_parallel(hs, [blk.mlp["w2"] for blk in blks], b0.mlp["b2"], dt, w8a8)
    return x


def encoder_post(model, x: torch.Tensor) -> torch.Tensor:
    ln = model_shards(model)[0].encoder.ln_post
    return layer_norm(x, ln["g"], ln["b"]).to(torch.float32)


def encoder_forward(model, mel: torch.Tensor, compute_dtype=torch.float32,
                    w8a8: bool = False, gelu: str = "erf", attn: str = "btd") -> torch.Tensor:
    """Conv stem + transformer encoder -> audio features (B, Ta, D) fp32;
    ``attn`` as in :func:`encoder_blocks`."""
    if isinstance(model, DataParallelWhisper):
        return _gather(model, [encoder_forward(m, x, compute_dtype, w8a8, gelu, attn)
                               for m, x in zip(model.rows, _row_blocks(model, mel))])
    x = encoder_stem(model, mel, compute_dtype, gelu)
    x = encoder_blocks(model, x, compute_dtype, w8a8=w8a8, gelu=gelu, attn=attn)
    return encoder_post(model, x)


def compute_cross_kv(model, audio_features: torch.Tensor, compute_dtype=torch.float32):
    """Per-decoder-layer cross-attention K/V, head-major (L, B, H, Ta, dh).
    Under a mesh, :class:`Shards` of each rank's (k, v) over its local
    heads, on its device; under data rows, :class:`DataRows` of each row's
    over its block of the batch."""
    if isinstance(model, DataParallelWhisper):
        return DataRows(compute_cross_kv(m, a, compute_dtype)
                        for m, a in zip(model.rows, _row_blocks(model, audio_features)))
    dt = compute_dtype
    shards = model_shards(model)
    H = model.cfg.n_text_head // len(shards)
    out = []
    for shard in shards:
        x = _to(audio_features, shard.device).to(dt)
        ks, vs = [], []
        for blk in shard.decoder.blocks:
            c = blk.cross
            ks.append(_split_heads(_linear(x, c["wk"], None, dt), H))
            vs.append(_split_heads(_linear(x, c["wv"], c["bv"], dt), H))
        out.append((torch.stack(ks), torch.stack(vs)))
    return _pack(out)


def quantize_cross_kv(cross_kv):
    """Dynamic int8 quantization of the cross-attention K/V, symmetric per
    (layer, batch, head, channel) over the audio axis, 1e-12 scale floor.

    Returns (k_q, k_s, v_q, v_s): int8 stored TRANSPOSED (L, B, H, dh, Ta) so
    each (b, h) row of the decode step's reads is Ta contiguous bytes, and
    fp32 scales (L, B, H, 1, dh). Quantizes one layer at a time to bound the
    fp32 transient. The scales are per head, so :class:`Shards` quantize
    rank by rank to the one-rank result."""
    if isinstance(cross_kv, (Shards, DataRows)):
        return type(cross_kv)(quantize_cross_kv(c) for c in cross_kv)
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
               ctx: Optional[int] = None, *, device, heads: Optional[int] = None) -> "KVCache":
        shape = (cfg.n_text_layer, batch, heads or cfg.n_text_head, cfg.head_dim_text,
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
               device, heads: Optional[int] = None) -> "QKVCache":
        L, H, dh = cfg.n_text_layer, heads or cfg.n_text_head, cfg.head_dim_text
        T = ctx or cfg.n_text_ctx
        return cls(torch.zeros((L, batch, H, 2, dh, T), dtype=torch.int8, device=device),
                   torch.ones((L, batch, H, 2, T), dtype=torch.float32, device=device))


def new_kv_cache(model, batch: int, dtype=torch.float32, ctx: Optional[int] = None,
                 quant: bool = False):
    """A self-KV cache for ``model``: a :class:`KVCache` (a
    :class:`QKVCache` with ``quant``) on its device, or under a mesh
    :class:`Shards` of each rank's cache over its local heads; under data
    rows :class:`DataRows` of each row's over its block of ``batch``."""
    if isinstance(model, DataParallelWhisper):
        rows = _row_size(model, batch)
        return DataRows(new_kv_cache(m, rows, dtype, ctx, quant) for m in model.rows)
    shards = model_shards(model)
    H = model.cfg.n_text_head // len(shards)
    return _pack([QKVCache.create(model.cfg, batch, ctx, device=s.device, heads=H) if quant
                  else KVCache.create(model.cfg, batch, dtype, ctx, device=s.device, heads=H)
                  for s in shards])


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


def _model_logits(model, x: torch.Tensor, dt) -> torch.Tensor:
    """:func:`_logits` on the lead device; under a vocabulary-split
    embedding each rank's logit columns, concatenated there in rank order,
    which is vocabulary order."""
    shards = model_shards(model)
    if not (isinstance(model, ShardedWhisper) and model.vocab_split):
        return _logits(x, shards[0].decoder, dt)
    return torch.cat([_to(_logits(_to(x, s.device), s.decoder, dt), x.device)
                      for s in shards], dim=-1)


def _embed(model, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings on the lead device. Under a vocabulary-split table
    rank r looks up the ids in its rows [r * V / tp, (r + 1) * V / tp) and
    each id takes the row of the rank that holds it (GSPMD's masked
    gather, with a select for its sum)."""
    shards = model_shards(model)
    if not (isinstance(model, ShardedWhisper) and model.vocab_split):
        return shards[0].decoder.tok_emb[tokens]
    out = None
    for r, s in enumerate(shards):
        table = s.decoder.tok_emb
        local = _to(tokens, s.device) - r * table.shape[0]
        held = (local >= 0) & (local < table.shape[0])
        rows = _to(table[torch.clamp(local, 0, table.shape[0] - 1)], tokens.device)
        held = _to(held, tokens.device)[..., None]
        out = rows if out is None else torch.where(held, rows, out)
    return out


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
    cross_decode: str = "fd",
    beam_k: Optional[int] = None,  # cross_kv batch is B // beam_k (shared)
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
    with the int8 cross-KV, the kernel ``cross_decode`` selects ("fd",
    "legacy" or "dense", see the module docstring); prefill (S > 1) takes
    :func:`attention_kvt` / :func:`attention_int8kv_perpos` and
    :func:`attention_int8kv`, as the JAX package does.

    ``beam_k``: the K beams of an utterance share its cross-KV, so beam
    search passes the cross-KV UNEXPANDED (batch B // beam_k) and the
    cross-attention folds each utterance's K beams into the query axis
    (:func:`_fold_beams`): one :func:`attention_int8kv` (or
    :func:`attention` for a float cross-KV) of K queries a row, as the JAX
    package's einsum, never a decode kernel. Self-attention stays per beam
    (batch B) and keeps its kernel. Under data rows each row's block holds
    whole utterances' beams.
    """
    check_selections(cross_decode=cross_decode)
    if isinstance(model, DataParallelWhisper):
        unit = beam_k or 1
        outs = [decoder_forward(m, t, offset, c, x, compute_dtype, p, gelu, cross_decode, beam_k)
                for m, t, c, x, p in zip(model.rows, _row_blocks(model, tokens, unit),
                                         _row_values(model, kv, "kv"),
                                         _row_values(model, cross_kv, "cross_kv"),
                                         _row_blocks(model, pad, unit))]
        return _gather(model, [o[0] for o in outs]), DataRows(o[1] for o in outs)
    cfg = model.cfg
    shards = model_shards(model)
    dec = shards[0].decoder
    dt = compute_dtype
    B, S = tokens.shape
    kvs, crosses = shard_values(kv), shard_values(cross_kv)
    T = kvs[0][0].shape[-1]
    n_head = cfg.n_text_head // len(shards)
    device = tokens.device
    _check_window(offset, S, T, "KV cache write")

    x = _embed(model, tokens).to(dt)
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

    kv_quant = len(crosses[0]) == 4
    self_quant = isinstance(kvs[0], QKVCache)
    window = slice(offset, offset + S)
    for layer in range(cfg.n_text_layer):
        blks = [s.decoder.blocks[layer] for s in shards]
        b0 = blks[0]
        h = layer_norm(x, b0.attn_ln["g"], b0.attn_ln["b"])
        outs = []
        for c, (q, k_new, v_new) in zip(kvs, _column(
                h, [[(blk.attn["wq"], blk.attn["bq"]), (blk.attn["wk"], None),
                     (blk.attn["wv"], blk.attn["bv"])] for blk in blks], dt)):
            kh, vh, qh = (_split_heads(t, n_head) for t in (k_new, v_new, q))
            pad_r = None if pad is None else _to(pad, q.device)
            vis_r = None if vis is None else _to(vis, q.device)
            if self_quant:
                qn, sn = quantize_kv_heads(kh, vh)
                c.q[layer, ..., window] = qn
                c.s[layer, ..., window] = sn
                if S == 1:
                    o = self_attention_decode_int8(qh, c.q[layer], c.s[layer], offset, pad_r)
                else:
                    o = attention_int8kv_perpos(qh, c.q[layer], c.s[layer], mask=vis_r)
            else:
                c.k[layer, ..., window] = kh.transpose(-1, -2).to(c.k.dtype)
                c.v[layer, ..., window] = vh.transpose(-1, -2).to(c.v.dtype)
                if S == 1:
                    o = self_attention_decode(qh, c.k[layer], c.v[layer], offset, pad_r)
                else:
                    o = attention_kvt(qh, c.k[layer].to(dt), c.v[layer].to(dt), mask=vis_r)
            outs.append(_merge_heads(o))
        x = x + _row_parallel(outs, [blk.attn["wo"] for blk in blks], b0.attn["bo"], dt)
        x = _cross_and_mlp(x, blks, layer, crosses, kv_quant and S == 1 and beam_k is None,
                           n_head, dt, gelu, cross_decode, beam_k)

    x = layer_norm(x, dec.ln["g"], dec.ln["b"])
    return _model_logits(model, x, dt), kv


def _fold_beams(qh: torch.Tensor, k: int) -> torch.Tensor:
    """(Bu*K, H, S, dh) -> (Bu, H, K*S, dh): each utterance's K beams as
    the query rows of one attention against its shared cross-KV."""
    N, H, S, dh = qh.shape
    return qh.reshape(N // k, k, H, S, dh).transpose(1, 2).reshape(N // k, H, k * S, dh)


def _unfold_beams(o: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of :func:`_fold_beams`."""
    Bu, H, KS, dh = o.shape
    return o.reshape(Bu, H, k, KS // k, dh).transpose(1, 2).reshape(Bu * k, H, KS // k, dh)


def _cross_and_mlp(x, blks, layer: int, crosses, decode_kernel: bool, n_head: int, dt,
                   gelu: str, cross_decode: str = "fd",
                   beam_k: Optional[int] = None) -> torch.Tensor:
    """A decoder block after its self-attention, over the ranks' blocks
    ``blks`` and cross-KVs ``crosses``: cross-attention on each rank's local
    heads (where ``decode_kernel``, the int8 decode kernel ``cross_decode``
    selects; under ``beam_k`` the beams folded into the query axis) and the
    MLP, residuals included."""
    b0 = blks[0]
    h = layer_norm(x, b0.cross_ln["g"], b0.cross_ln["b"])
    outs = []
    for ckv, (q,) in zip(crosses, _column(
            h, [[(blk.cross["wq"], blk.cross["bq"])] for blk in blks], dt)):
        qh = _split_heads(q, n_head)
        if beam_k is not None:
            qh = _fold_beams(qh, beam_k)
        if decode_kernel:
            o = _cross_decode_kernel(cross_decode)(qh, *(t[layer] for t in ckv))
        elif len(ckv) == 4:
            o = attention_int8kv(qh, *(t[layer] for t in ckv))
        else:
            o = attention(qh, ckv[0][layer].to(dt), ckv[1][layer].to(dt))
        if beam_k is not None:
            o = _unfold_beams(o, beam_k)
        outs.append(_merge_heads(o))
    x = x + _row_parallel(outs, [blk.cross["wo"] for blk in blks], b0.cross["bo"], dt)
    h = layer_norm(x, b0.mlp_ln["g"], b0.mlp_ln["b"])
    hs = [_gelu(y, gelu) for (y,) in
          _column(h, [[(blk.mlp["w1"], blk.mlp["b1"])] for blk in blks], dt)]
    return x + _row_parallel(hs, [blk.mlp["w2"] for blk in blks], b0.mlp["b2"], dt)


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, at: torch.Tensor,
                inside: torch.Tensor, new: torch.Tensor) -> None:
    """cache[rows[b], ..., at[b]] = new[b] for every entry whose position is
    ``inside`` the cache; the other entries write back the value already
    there, so their write is dropped (JAX's scatter ``mode="drop"``).
    ``at`` (and ``inside``) is (B,) for one position a row or (B, W) for a
    window, with ``rows`` (B,) or (B, 1); a dropped entry's ``at`` only has
    to index the cache, and no two entries of ``(rows, at)`` may meet
    (``index_put_`` picks an arbitrary winner among duplicates on CUDA). No
    host sync."""
    old = cache[rows, ..., at]
    keep = inside.reshape(*inside.shape, *([1] * (new.dim() - inside.dim())))
    cache[rows, ..., at] = torch.where(keep, new.to(cache.dtype), old)


def _window_targets(q_abs: torch.Tensor, T: int):
    """(at, inside) of a window's absolute positions ``q_abs`` (B, W), W <=
    T, in a cache of T positions: an entry at or past T is dropped, and its
    write-back goes to ``min(q, T + j) - W``, a position its row does not
    write in this window (below the row's first position, or T - W + j for
    a row wholly past the edge), so no two entries meet."""
    W = q_abs.shape[1]
    j = torch.arange(W, device=q_abs.device)[None, :]
    inside = q_abs < T
    return torch.where(inside, q_abs, torch.minimum(q_abs, T + j) - W), inside


def decoder_step_multipos(
    model: Whisper,
    tokens: torch.Tensor,   # (B,) int64: one token per stream
    offsets: torch.Tensor,  # (B,) int64: per-stream write/attend position
    kv,                     # KVCache or QKVCache, updated in place
    cross_kv,               # (k, v) each (L, B, H, Ta, dh), or the int8 4-tuple
    compute_dtype=torch.float32,
    pads: Optional[torch.Tensor] = None,  # (B,) int64 masked left-pad length
    gelu: str = "erf",
    cross_decode: str = "fd",
) -> Tuple[torch.Tensor, object]:
    """One decode step where every stream sits at its own position: the
    continuous-batching primitive (port of the JAX
    ``decoder_step_multipos``).

    Row b writes its K/V at ``offsets[b]`` and attends to positions
    ``pads[b] <= t <= offsets[b]``; its positional embedding is indexed
    ``offsets[b] - pads[b]``, clipped to the table. A row whose offset falls
    outside [0, T) writes nothing (JAX drops it) and attends to the whole
    cache. Self-attention runs :func:`self_attention_decode` (``_int8`` for
    a :class:`QKVCache`), the int8 cross-attention the kernel
    ``cross_decode`` selects (as in :func:`decoder_forward`). Returns
    (logits (B, n_vocab) fp32, kv). Nothing here reads the device from the
    host.
    """
    return _step_multipos(model, tokens, offsets, kv, cross_kv, compute_dtype, pads, gelu,
                          cross_decode)


def _step_multipos(model, tokens, offsets, kv, cross_kv, compute_dtype, pads, gelu: str,
                   cross_decode: str, beam_k: Optional[int] = None):
    """:func:`decoder_step_multipos`, and with ``beam_k`` the beam loop's
    step at a position held on the device: the K beams of an utterance
    fold into the query axis of one cross-attention against the
    UNEXPANDED cross-KV (batch B // beam_k), the plain product, never a
    decode kernel, as in :func:`decoder_forward`; under data rows each
    row's block holds whole utterances' beams."""
    check_selections(cross_decode=cross_decode)
    if isinstance(model, DataParallelWhisper):
        unit = beam_k or 1
        outs = [_step_multipos(m, t, o, c, x, compute_dtype, p, gelu, cross_decode, beam_k)
                for m, t, o, c, x, p in zip(model.rows, _row_blocks(model, tokens, unit),
                                            _row_blocks(model, offsets, unit),
                                            _row_values(model, kv, "kv"),
                                            _row_values(model, cross_kv, "cross_kv"),
                                            _row_blocks(model, pads, unit))]
        return _gather(model, [o[0] for o in outs]), DataRows(o[1] for o in outs)
    cfg = model.cfg
    shards = model_shards(model)
    dec = shards[0].decoder
    dt = compute_dtype
    B = tokens.shape[0]
    kvs, crosses = shard_values(kv), shard_values(cross_kv)
    T = kvs[0][0].shape[-1]
    n_head, dh = cfg.n_text_head // len(shards), cfg.head_dim_text

    pos_idx = offsets if pads is None else offsets - pads
    pos_idx = torch.clamp(pos_idx, 0, dec.pos_emb.shape[0] - 1)
    x = (_embed(model, tokens).to(dt) + dec.pos_emb[pos_idx].to(dt))[:, None, :]  # (B, 1, D)
    inside = (offsets >= 0) & (offsets < T)
    at = torch.clamp(offsets, 0, T - 1)
    # the per-row step state on each rank's device (one copy a step)
    local = {}
    for s in shards:
        if s.device not in local:
            local[s.device] = tuple(None if t is None else _to(t, s.device) for t in (
                torch.arange(B, device=tokens.device), at, inside, offsets, pads))

    kv_quant = len(crosses[0]) == 4
    self_quant = isinstance(kvs[0], QKVCache)
    for layer in range(cfg.n_text_layer):
        blks = [s.decoder.blocks[layer] for s in shards]
        b0 = blks[0]
        h = layer_norm(x, b0.attn_ln["g"], b0.attn_ln["b"])
        outs = []
        for c, (q, k_new, v_new) in zip(kvs, _column(
                h, [[(blk.attn["wq"], blk.attn["bq"]), (blk.attn["wk"], None),
                     (blk.attn["wv"], blk.attn["bv"])] for blk in blks], dt)):
            rows, at_r, inside_r, offsets_r, pads_r = local[q.device]
            qh = _split_heads(q, n_head)
            kh = k_new.reshape(B, n_head, dh)
            vh = v_new.reshape(B, n_head, dh)
            if self_quant:
                qn, sn = quantize_kv_heads(kh[:, :, None], vh[:, :, None])
                # advanced indices at dims 0 and 4 of the (B, H, 2, dh, T)
                # view: the indexed shape is (B, H, 2, dh)
                _write_rows(c.q[layer], rows, at_r, inside_r, qn[..., 0])
                _write_rows(c.s[layer], rows, at_r, inside_r, sn[..., 0])
                o = self_attention_decode_int8(qh, c.q[layer], c.s[layer], offsets_r, pads_r)
            else:
                _write_rows(c.k[layer], rows, at_r, inside_r, kh)
                _write_rows(c.v[layer], rows, at_r, inside_r, vh)
                o = self_attention_decode(qh, c.k[layer], c.v[layer], offsets_r, pads_r)
            outs.append(_merge_heads(o))
        x = x + _row_parallel(outs, [blk.attn["wo"] for blk in blks], b0.attn["bo"], dt)
        x = _cross_and_mlp(x, blks, layer, crosses, kv_quant and beam_k is None, n_head, dt,
                           gelu, cross_decode, beam_k)

    x = layer_norm(x, dec.ln["g"], dec.ln["b"])
    return _model_logits(model, x, dt)[:, 0], kv


def decoder_window_multipos(
    model: Whisper,
    tokens: torch.Tensor,   # (B, W) int64: a token window a stream
    offsets: torch.Tensor,  # (B,) int64: each stream's first write/attend position, >= 0
    kv,                     # KVCache or QKVCache, updated in place
    cross_kv,               # (k, v) each (L, B, H, Ta, dh), or the int8 4-tuple
    compute_dtype=torch.float32,
    gelu: str = "erf",
) -> Tuple[torch.Tensor, object]:
    """W tokens a stream, each stream at its own position: the verify
    window of speculative decoding (port of the JAX
    ``decoder_window_multipos``), the twin of :func:`decoder_step_multipos`.

    Row b's tokens sit at ``offsets[b] .. offsets[b] + W - 1``: their K/V
    are written there (quantized per position for a :class:`QKVCache`),
    and query j sees every key ``t <= offsets[b] + j`` of the cache, so
    stale entries past the window (a rejected draft's) stay hidden. Writes
    at or past the cache's end are dropped, as JAX's ``mode="drop"``
    scatter drops them (:func:`_window_targets`); positional indices are
    clipped to the table. The attentions are the plain products the JAX
    window computes (:func:`attention_kvt` / :func:`attention_int8kv_perpos`,
    then :func:`attention_int8kv` / :func:`attention` for cross): the JAX
    window takes no Pallas path, and the port's decode kernels take one
    query a row. Returns (logits (B, W, n_vocab) fp32, kv); ``logits[:, j]``
    predicts the token at ``offsets + j + 1``. Nothing here reads the device
    from the host.
    """
    if isinstance(model, DataParallelWhisper):
        outs = [decoder_window_multipos(m, t, o, c, x, compute_dtype, gelu)
                for m, t, o, c, x in zip(model.rows, _row_blocks(model, tokens),
                                         _row_blocks(model, offsets),
                                         _row_values(model, kv, "kv"),
                                         _row_values(model, cross_kv, "cross_kv"))]
        return _gather(model, [o[0] for o in outs]), DataRows(o[1] for o in outs)
    cfg = model.cfg
    shards = model_shards(model)
    dec = shards[0].decoder
    dt = compute_dtype
    B, W = tokens.shape
    kvs, crosses = shard_values(kv), shard_values(cross_kv)
    T = kvs[0][0].shape[-1]
    if W > T:
        raise ValueError(f"a window of {W} tokens does not fit a cache of {T} positions")
    n_head, dh = cfg.n_text_head // len(shards), cfg.head_dim_text

    q_abs = offsets[:, None] + torch.arange(W, device=tokens.device)[None, :]  # (B, W)
    pos_idx = torch.clamp(q_abs, 0, dec.pos_emb.shape[0] - 1)
    x = _embed(model, tokens).to(dt) + dec.pos_emb[pos_idx].to(dt)  # (B, W, D)
    key_pos = torch.arange(T, device=tokens.device)[None, None, :]
    vis = (key_pos <= q_abs[:, :, None])[:, None]  # (B, 1, W, T)
    at, inside = _window_targets(q_abs, T)
    # the window's state on each rank's device (one copy a call)
    local = {}
    for s in shards:
        if s.device not in local:
            local[s.device] = tuple(_to(t, s.device) for t in (
                torch.arange(B, device=tokens.device)[:, None], at, inside, vis))

    kv_quant = len(crosses[0]) == 4
    self_quant = isinstance(kvs[0], QKVCache)
    for layer in range(cfg.n_text_layer):
        blks = [s.decoder.blocks[layer] for s in shards]
        b0 = blks[0]
        h = layer_norm(x, b0.attn_ln["g"], b0.attn_ln["b"])
        outs = []
        for c, (q, k_new, v_new) in zip(kvs, _column(
                h, [[(blk.attn["wq"], blk.attn["bq"]), (blk.attn["wk"], None),
                     (blk.attn["wv"], blk.attn["bv"])] for blk in blks], dt)):
            rows, at_r, inside_r, vis_r = local[q.device]
            qh = _split_heads(q, n_head)
            kh = k_new.reshape(B, W, n_head, dh)
            vh = v_new.reshape(B, W, n_head, dh)
            if self_quant:
                # per (row, position): (B, H, 2, dh, W) / (B, H, 2, W), laid
                # out as the indexed (B, W, H, 2, dh) / (B, W, H, 2)
                qn, sn = quantize_kv_heads(kh.transpose(1, 2), vh.transpose(1, 2))
                _write_rows(c.q[layer], rows, at_r, inside_r, qn.permute(0, 4, 1, 2, 3))
                _write_rows(c.s[layer], rows, at_r, inside_r, sn.permute(0, 3, 1, 2))
                o = attention_int8kv_perpos(qh, c.q[layer], c.s[layer], mask=vis_r)
            else:
                _write_rows(c.k[layer], rows, at_r, inside_r, kh)
                _write_rows(c.v[layer], rows, at_r, inside_r, vh)
                o = attention_kvt(qh, c.k[layer].to(dt), c.v[layer].to(dt), mask=vis_r)
            outs.append(_merge_heads(o))
        x = x + _row_parallel(outs, [blk.attn["wo"] for blk in blks], b0.attn["bo"], dt)
        x = _cross_and_mlp(x, blks, layer, crosses, False, n_head, dt, gelu)

    x = layer_norm(x, dec.ln["g"], dec.ln["b"])
    return _model_logits(model, x, dt), kv
