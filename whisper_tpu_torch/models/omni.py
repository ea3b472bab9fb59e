"""Uni-MoE-2.0-Omni's speech-to-text model in PyTorch (``config.OmniConfig``).

The audio tower is the port's Whisper encoder (``model.encoder_forward``,
with its kernels) over a clip's log-mel, average-pooled to ``n_query``
frames and projected to the language model's width. The language model is
decoder-only: ``h = x + Attn(RMSNorm(x))``, then ``y = h + MoE(RMSNorm(h))``,
and after the last block a final RMSNorm and an untied head.

- Attention: q, k and v with biases and o without, RoPE in rotate-half form
  over the whole head at ``rope_theta`` (Qwen2-VL's M-RoPE with the three
  position ids equal, as it gives audio and text tokens, is this 1-D RoPE),
  ``n_head`` query heads sharing each of ``n_kv_head`` KV heads, causal, at
  scale ``head_dim ** -0.5``, over a self-KV cache in the compute dtype.
- MoE: ``p = softmax(u @ W_g)`` in fp32 over the routed experts, then the
  null ones; the chosen set is the shortest prefix of the experts sorted by
  ``p`` whose mass reaches ``top_p``, at most ``top_k`` of them
  (:func:`route`). The output is the sum of the fixed experts (weight 1)
  and of ``p_e E_e(u)`` over the chosen routed experts, with
  ``E(u) = W_down(silu(W_gate u) * W_up u)``; a null expert adds nothing
  and ``p`` is not renormalised over the chosen set.

Precision: the residual stream, every RMSNorm and the gate are fp32; with
quantized weights every linear of the language model, the projector and
the head is a W8A8 product (``model._linear_a8``: K8q then K8), writing
fp32 where its output joins the residual stream or the logits and the
compute dtype where it feeds attention or an expert's activation; the
embedding and the KV cache are in the compute dtype. The fixed experts run
as one expert of their concatenated widths (the same sum), and an expert's
gate and up projections as one product. K8q takes rows of at most
``MAX_K`` values, so a wider input (the routed experts' down projections)
is quantized in equal pieces at the whole row's scale, the bits of one
row quantization, before one K8 product (:func:`linear`).

The prefill computes each routed expert on the rows that chose it and
scatter-adds them (one host read a layer and expert); a decode step
computes every routed expert on every row, weight 0 where the row did not
choose it, which reads the same weights with no host read, so the step is
capturable; both give the same bits (``moe(all_rows=...)``).

``moe_counts`` counts the routing on the card, the prefill's in row 0 and
the decode's in row 1, inside captured rounds too (columns: each routed
expert's tokens, then ``NULL``, ``DECISIONS``, ``ONE``, ``TWO``, ``ACTIVE``
past them); :func:`moe_stats` reads them once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..config import OmniConfig, WhisperConfig
from ..ops.quant import QTensor, quantize_weight
from ..ops.quantize_rows import MAX_K, quantize_rows, row_scale
from .model import Encoder, _a8_scaled, _linear, _linear_a8, _quantize_a8, sinusoids

Weight = Union[torch.Tensor, QTensor]

# moe_counts columns after the routed experts' token counts
NULL, DECISIONS, ONE, TWO, ACTIVE = range(5)
MAX_POSITIONS = 2048  # RoPE table rows: prompts and budgets past this are not served


class AudioTower(nn.Module):
    """The Whisper encoder as ``model.encoder_forward`` reads it."""

    def __init__(self, cfg: WhisperConfig, encoder: Encoder):
        super().__init__()
        self.cfg = cfg
        self.encoder = encoder


class OmniLayer(nn.Module):
    """One block: ``attn`` {norm, w_qkv, b_qkv, w_o} and ``moe`` {norm,
    gate, fixed {w_gate_up, w_down}, routed [{w_gate_up, w_down}, ...]}."""

    def __init__(self, attn: dict, moe: dict):
        super().__init__()
        self.attn = attn
        self.moe = moe


class Omni(nn.Module):
    def __init__(self, cfg: OmniConfig, audio: AudioTower, proj: dict, embed: torch.Tensor,
                 layers: List[OmniLayer], norm: torch.Tensor, head: Weight):
        super().__init__()
        self.cfg = cfg
        self.audio = audio
        self.proj = proj
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.norm = norm
        self.head = head
        self.rope_cos, self.rope_sin = rope_tables(cfg, MAX_POSITIONS, embed.device)
        # routing counts: [prefill, decode] x [tokens to each routed expert,
        # NULL, DECISIONS, ONE, TWO, ACTIVE] (columns offset by n_routed)
        self.moe_counts = torch.zeros((2, cfg.n_routed + 5), dtype=torch.int64,
                                      device=embed.device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def quantized(self) -> bool:
        return isinstance(self.head, QTensor)


# ------------------------------------------------------------------ pieces
def rope_tables(cfg: OmniConfig, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (n, head_dim) fp32 of position x theta^(-2i/head_dim),
    the angle in float64, each half repeated (rotate-half form)."""
    inv = cfg.rope_theta ** (-torch.arange(0, cfg.head_dim, 2, dtype=torch.float64,
                                           device=device) / cfg.head_dim)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of fp32 ``x`` (..., T, head_dim) at (T, head_dim) tables."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 RMSNorm of ``x`` with gains ``g``."""
    x = x.to(torch.float32)
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g


def route(p: torch.Tensor, top_p: float, top_k: int) -> torch.Tensor:
    """(N, E) bool: the experts each row of probabilities ``p`` (N, E)
    chooses: sorted by probability (ties to the lower index), the shortest
    prefix whose mass reaches ``top_p``, at most ``top_k``."""
    ps, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    before = F.pad(torch.cumsum(ps, dim=-1)[:, :-1], (1, 0))  # mass ranked above
    rank = torch.arange(p.shape[-1], device=p.device)
    keep = (before < top_p) & (rank < top_k)
    return torch.zeros_like(keep).scatter(-1, idx, keep)


def _quantize_wide(x: torch.Tensor) -> tuple:
    """:func:`model._quantize_a8` of rows wider than K8q takes: the row scale
    over the whole row, then K8q over the rows cut into ``n`` equal pieces
    of at most ``MAX_K`` (a view), each at its row's scale: the bits of one
    row quantization."""
    lead, K = x.shape[:-1], x.shape[-1]
    n = -(-K // MAX_K)
    while K % n or (K // n) % 16:
        n += 1
    x2 = x.reshape(-1, K).contiguous()
    sx = row_scale(x2.abs().amax(dim=-1, keepdim=True).to(torch.float32))
    x8, _ = quantize_rows(x2.view(-1, K // n), sx.repeat_interleave(n, dim=0))
    return x8.view(-1, K), sx, lead


def linear(x: torch.Tensor, w: Weight, b: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """``x @ w + b`` written in ``dtype``: W8A8 for a quantized weight (its
    input quantized in pieces where it is wider than K8q takes), else in
    ``dtype``."""
    if isinstance(w, QTensor) and x.shape[-1] > MAX_K:
        return _a8_scaled(_quantize_wide(x), w, b, dtype)
    return _linear_a8(x, w, b, dtype)


def _quantized_rows(u: torch.Tensor, quantized: bool):
    """The MoE's input as its experts read it: int8 rows once for all of
    them (K8q) when their weights are quantized, else as it is."""
    return _quantize_a8(u) if quantized else u


def _take(uq, rows: torch.Tensor):
    if isinstance(uq, tuple):
        x8, sx, _ = uq
        return x8[rows], sx[rows], (rows.numel(),)
    return uq[rows]


def _expert(uq, e: dict, dt) -> torch.Tensor:
    """``W_down(silu(W_gate u) * W_up u)`` in fp32 of rows ``uq``."""
    w = e["w_gate_up"]
    gu = _a8_scaled(uq, w, None, dt) if isinstance(w, QTensor) else _linear(uq, w, None, dt)
    g, up = gu.chunk(2, dim=-1)
    return linear(F.silu(g.to(torch.float32)) * up.to(torch.float32), e["w_down"], None,
                  torch.float32)


def _count(counts: torch.Tensor, chosen: torch.Tensor, live: Optional[torch.Tensor],
           n_routed: int) -> None:
    """Add a routing's counts to a row of ``moe_counts``, in place (the
    rows ``live`` alone where given)."""
    if live is not None:
        chosen = chosen & live[:, None]
    n = chosen.sum(dim=-1)
    R = n_routed
    counts[:R] += chosen[:, :R].sum(dim=0)
    counts[R + NULL] += chosen[:, R:].sum()
    counts[R + DECISIONS] += chosen.shape[0] if live is None else live.sum()
    counts[R + ONE] += (n == 1).sum()
    counts[R + TWO] += (n == 2).sum()
    counts[R + ACTIVE] += chosen[:, :R].any(dim=0).sum()


def moe(model: Omni, layer: OmniLayer, x: torch.Tensor, dt, all_rows: bool = False,
        counts: Optional[torch.Tensor] = None, live: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """The MoE sublayer of residual rows ``x`` (N, D): its fp32 output.
    ``all_rows`` computes every routed expert on every row (the decode
    step's form), else each on its rows; ``counts`` (a row of
    ``moe_counts``) takes the routing's counts, of the ``live`` rows where
    given."""
    cfg, m = model.cfg, layer.moe
    u = rms_norm(x, m["norm"], cfg.rms_eps)
    p = torch.softmax(torch.matmul(u, m["gate"]), dim=-1)
    chosen = route(p, cfg.top_p, cfg.top_k)
    if counts is not None:
        _count(counts, chosen, live, cfg.n_routed)
    R = cfg.n_routed
    w = torch.where(chosen[:, :R], p[:, :R], torch.zeros_like(p[:, :R]))
    uq = _quantized_rows(u, isinstance(m["fixed"]["w_gate_up"], QTensor))
    out = _expert(uq, m["fixed"], dt)
    for e, expert in enumerate(m["routed"]):
        if all_rows:
            out += w[:, e: e + 1] * _expert(uq, expert, dt)
            continue
        rows = chosen[:, e].nonzero()[:, 0]
        if rows.numel():
            out.index_add_(0, rows, w[rows, e: e + 1] * _expert(_take(uq, rows), expert, dt))
    return out


def _qkv(layer: OmniLayer, x: torch.Tensor, cfg: OmniConfig):
    """q (..., H, dh), k and v (..., KV, dh) fp32 of the normed residual."""
    a = layer.attn
    h = rms_norm(x, a["norm"], cfg.rms_eps)
    qkv = linear(h, a["w_qkv"], a["b_qkv"], torch.float32)
    H, KV, dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    q, k, v = qkv.split([H * dh, KV * dh, KV * dh], dim=-1)
    lead = x.shape[:-1]
    return q.reshape(*lead, H, dh), k.reshape(*lead, KV, dh), v.reshape(*lead, KV, dh)


def attention_prefill(model: Omni, layer: OmniLayer, x: torch.Tensor, kv: torch.Tensor,
                      dt) -> torch.Tensor:
    """Causal GQA self-attention of the prompt ``x`` (B, T, D) from position
    0, its K/V written into ``kv`` (2, B, KV, ctx, dh); the fp32 output."""
    cfg = model.cfg
    B, T, _ = x.shape
    q, k, v = (t.transpose(1, 2) for t in _qkv(layer, x, cfg))  # (B, heads, T, dh)
    cos, sin = model.rope_cos[:T], model.rope_sin[:T]
    q, k, v = apply_rope(q, cos, sin).to(dt), apply_rope(k, cos, sin).to(dt), v.to(dt)
    kv[0, :, :, :T] = k
    kv[1, :, :, :T] = v
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    return linear(o.transpose(1, 2).reshape(B, T, -1), layer.attn["w_o"], None, torch.float32)


def attention_step(model: Omni, layer: OmniLayer, x: torch.Tensor, pos: torch.Tensor,
                   kv: torch.Tensor, dt) -> torch.Tensor:
    """One position of every row: ``x`` (B, D) at position ``pos`` (0-d,
    on the device), its K/V written there, attending to positions up to
    it; the fp32 output. No host read."""
    cfg = model.cfg
    B = x.shape[0]
    H, KV, dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    q, k, v = _qkv(layer, x, cfg)
    at = pos.reshape(1)
    cos, sin = model.rope_cos.index_select(0, at), model.rope_sin.index_select(0, at)
    q, k = apply_rope(q, cos, sin).to(dt), apply_rope(k, cos, sin).to(dt)
    kv[0].index_copy_(2, at, k[:, :, None])
    kv[1].index_copy_(2, at, v.to(dt)[:, :, None])
    s = torch.matmul(q.reshape(B, KV, H // KV, dh), kv[0].transpose(-1, -2)).to(torch.float32)
    seen = torch.arange(kv.shape[-2], device=x.device) <= pos
    s = torch.where(seen, s * dh ** -0.5, torch.full_like(s, -math.inf))
    o = torch.matmul(torch.softmax(s, dim=-1).to(dt), kv[1])  # (B, KV, H/KV, dh)
    return linear(o.reshape(B, H * dh), layer.attn["w_o"], None, torch.float32)


def head_logits(model: Omni, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of residual rows ``x`` (..., D)."""
    return linear(rms_norm(x, model.norm, model.cfg.rms_eps), model.head, None, torch.float32)


def project(model: Omni, feats: torch.Tensor) -> torch.Tensor:
    """Audio features (B, Ta, C) fp32 -> (B, n_query, D) fp32 audio
    embeddings: adaptive average pooling over time, then the projector."""
    pooled = F.adaptive_avg_pool1d(feats.transpose(1, 2), model.cfg.n_query).transpose(1, 2)
    return linear(pooled.contiguous(), model.proj["w"], model.proj["b"], torch.float32)


def prompt_embeddings(model: Omni, prefix: torch.Tensor, audio: torch.Tensor,
                      suffix: torch.Tensor) -> torch.Tensor:
    """(B, prompt_len, D) fp32: the prefix ids' embeddings, the audio
    embeddings, the suffix ids' embeddings."""
    B = audio.shape[0]
    emb = [model.embed[ids].to(torch.float32)[None].expand(B, -1, -1) for ids in (prefix, suffix)]
    return torch.cat([emb[0], audio, emb[1]], dim=1)


def new_cache(model: Omni, batch: int, ctx: int, dtype) -> torch.Tensor:
    """Zeroed self-KV (L, 2, B, KV, ctx, dh)."""
    c = model.cfg
    return torch.zeros((c.n_layer, 2, batch, c.n_kv_head, ctx, c.head_dim), dtype=dtype,
                       device=model.device)


def prefill(model: Omni, x: torch.Tensor, kv: torch.Tensor, dt) -> torch.Tensor:
    """The prompt ``x`` (B, T, D) fp32 through every block, its K/V into
    ``kv``; the last position's fp32 logits (B, V). Each block's
    attention and MoE are the ranges ``whisper.omni.attn`` and
    ``whisper.omni.moe``; the routing counts go to ``moe_counts[0]``."""
    B, T, D = x.shape
    for i, layer in enumerate(model.layers):
        with record_function("whisper.omni.attn"):
            x = x + attention_prefill(model, layer, x, kv[i], dt)
        with record_function("whisper.omni.moe"):
            x = x + moe(model, layer, x.reshape(B * T, D), dt,
                        counts=model.moe_counts[0]).reshape(B, T, D)
    return head_logits(model, x[:, -1])


def step(model: Omni, tokens: torch.Tensor, pos: torch.Tensor, kv: torch.Tensor, dt,
         live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step: ``tokens`` (B,) at position ``pos`` (0-d tensor)
    through every block against ``kv``; fp32 logits (B, V). The routing
    counts of the ``live`` rows go to ``moe_counts[1]``. No host read."""
    x = model.embed[tokens].to(torch.float32)
    for i, layer in enumerate(model.layers):
        x = x + attention_step(model, layer, x, pos, kv[i], dt)
        x = x + moe(model, layer, x, dt, all_rows=True, counts=model.moe_counts[1], live=live)
    return head_logits(model, x)


def reset_moe_stats(model: Omni) -> None:
    model.moe_counts.zero_()


def moe_stats(model: Omni) -> Dict[str, dict]:
    """The routing counts since the last :func:`reset_moe_stats`, the
    prefill's and the decode's apart (one host read): tokens routed to each
    routed expert and to the null experts summed over layers, the routing
    decisions (a token at a layer), the shares of decisions that chose one
    expert, two and a null one, the mean routed experts a decision uses,
    the largest routed expert's load over their mean, and the experts that
    some row chose, summed over the layers of each step."""
    R = model.cfg.n_routed
    out = {}
    for phase, row in zip(("prefill", "decode"), model.moe_counts.tolist()):
        routed, n = row[:R], row[R + DECISIONS]
        mean = sum(routed) / R
        out[phase] = {"routed_tokens": routed, "null_tokens": row[R + NULL], "decisions": n,
                      "one_expert_share": row[R + ONE] / n if n else None,
                      "two_expert_share": row[R + TWO] / n if n else None,
                      "null_share": row[R + NULL] / n if n else None,
                      "mean_routed_experts": sum(routed) / n if n else None,
                      "max_load_over_mean": max(routed) / mean if mean else None,
                      "active_experts": row[R + ACTIVE]}
    return out


# ------------------------------------------------------------------ weights
def weight_shapes(cfg: OmniConfig) -> List[Tuple[str, tuple]]:
    """(name, shape) of every weight a model is built from, in build order;
    matmul weights are (d_in, d_out), the encoder's convolutions (C_out,
    C_in, 3). The encoder's positions are Whisper's sinusoids, not drawn."""
    a, D = cfg.audio, cfg.d_model
    C, out = a.n_audio_state, []
    out += [("encoder.conv1.w", (C, a.n_mels, 3)), ("encoder.conv1.b", (C,)),
            ("encoder.conv2.w", (C, C, 3)), ("encoder.conv2.b", (C,))]
    for i in range(a.n_audio_layer):
        p = f"encoder.blocks.{i}."
        out += [(p + "attn_ln.g", (C,)), (p + "attn_ln.b", (C,))]
        out += [(p + f"attn.{n}", (C, C)) for n in ("wq", "wk", "wv", "wo")]
        out += [(p + f"attn.{n}", (C,)) for n in ("bq", "bv", "bo")]
        out += [(p + "mlp_ln.g", (C,)), (p + "mlp_ln.b", (C,)), (p + "mlp.w1", (C, 4 * C)),
                (p + "mlp.b1", (4 * C,)), (p + "mlp.w2", (4 * C, C)), (p + "mlp.b2", (C,))]
    out += [("encoder.ln_post.g", (C,)), ("encoder.ln_post.b", (C,)),
            ("projector.w", (C, D)), ("projector.b", (D,)), ("embed", (cfg.n_vocab, D))]
    Q, KV = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (D,)), (p + "attn.wq", (D, Q)), (p + "attn.bq", (Q,)),
                (p + "attn.wk", (D, KV)), (p + "attn.bk", (KV,)), (p + "attn.wv", (D, KV)),
                (p + "attn.bv", (KV,)), (p + "attn.wo", (Q, D)), (p + "moe_norm", (D,)),
                (p + "gate", (D, cfg.n_experts))]
        for kind, n, F_ in (("fixed", cfg.n_fixed, cfg.d_fixed),
                            ("routed", cfg.n_routed, cfg.d_routed)):
            for e in range(n):
                q = f"{p}{kind}.{e}."
                out += [(q + "w_gate", (D, F_)), (q + "w_up", (D, F_)), (q + "w_down", (F_, D))]
    out += [("norm", (D,)), ("head", (D, cfg.n_vocab))]
    return out


def _k_major(w: QTensor) -> QTensor:
    w.k_major()  # laid out as K8 reads it once, as it is built
    return w


def build_omni(cfg: OmniConfig, tensor: Callable[[str, tuple], torch.Tensor], device,
               dtype=torch.float32, quantize: bool = False) -> Omni:
    """The model from ``tensor(name, shape)`` (fp32 on ``device``, for every
    entry of :func:`weight_shapes`), one weight at a time: with
    ``quantize`` every matmul weight of the encoder's blocks and of the
    language model, the projector and the head becomes an int8
    per-output-channel ``QTensor`` as it arrives (``ops.quant``), so the
    fp32 model never lives whole; without it they are kept in ``dtype``.
    The encoder's other floats, the embedding and the compute happen in
    ``dtype``; norms, biases of the language model and the gate stay fp32."""
    def cast(t):
        return t.to(dtype)

    def w(name, shape, q: bool = True):
        t = tensor(name, shape)
        if q:
            return _k_major(quantize_weight(t, axis=-1)) if quantize else cast(t)
        return t

    shapes = dict(weight_shapes(cfg))
    a = cfg.audio

    def enc(name, q=False):
        t = w(name, shapes[name], q)
        return t if isinstance(t, QTensor) else cast(t)

    conv = [{"w": enc(f"encoder.conv{i}.w"), "b": enc(f"encoder.conv{i}.b")} for i in (1, 2)]
    blocks = []
    for i in range(a.n_audio_layer):
        p = f"encoder.blocks.{i}."
        blk = {"attn_ln": {}, "attn": {}, "mlp_ln": {}, "mlp": {}}
        for sub, names in (("attn_ln", ("g", "b")), ("attn", ("wq", "bq", "wk", "wv", "bv",
                                                              "wo", "bo")),
                           ("mlp_ln", ("g", "b")), ("mlp", ("w1", "b1", "w2", "b2"))):
            for n in names:
                blk[sub][n] = enc(p + f"{sub}.{n}", q=n.startswith("w"))
        blocks.append(blk)
    pos = cast(torch.from_numpy(sinusoids(a.n_audio_ctx, a.n_audio_state)).to(device))
    encoder = Encoder(conv1=conv[0], conv2=conv[1], pos_emb=pos,
                      ln_post={"g": enc("encoder.ln_post.g"), "b": enc("encoder.ln_post.b")},
                      blocks=blocks)
    proj = {"w": w("projector.w", shapes["projector.w"]),
            "b": tensor("projector.b", shapes["projector.b"])}
    embed = cast(tensor("embed", shapes["embed"]))

    def cat(names, dim):
        return torch.cat([tensor(n, shapes[n]) for n in names], dim=dim)

    def quant(t):
        return _k_major(quantize_weight(t, axis=-1)) if quantize else cast(t)

    layers = []
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        attn = {"norm": tensor(p + "attn_norm", shapes[p + "attn_norm"]),
                "w_qkv": quant(cat([p + "attn.wq", p + "attn.wk", p + "attn.wv"], 1)),
                "b_qkv": cat([p + "attn.bq", p + "attn.bk", p + "attn.bv"], 0),
                "w_o": w(p + "attn.wo", shapes[p + "attn.wo"])}
        fixed = [f"{p}fixed.{e}." for e in range(cfg.n_fixed)]
        mo = {"norm": tensor(p + "moe_norm", shapes[p + "moe_norm"]),
              "gate": tensor(p + "gate", shapes[p + "gate"]),
              # the fixed experts as one of their summed widths: [gates | ups], downs stacked
              "fixed": {"w_gate_up": quant(cat([f + "w_gate" for f in fixed]
                                               + [f + "w_up" for f in fixed], 1)),
                        "w_down": quant(cat([f + "w_down" for f in fixed], 0))},
              "routed": []}
        for e in range(cfg.n_routed):
            q = f"{p}routed.{e}."
            mo["routed"].append({"w_gate_up": quant(cat([q + "w_gate", q + "w_up"], 1)),
                                 "w_down": w(q + "w_down", shapes[q + "w_down"])})
        layers.append(OmniLayer(attn, mo))
    return Omni(cfg, AudioTower(a, encoder), proj, embed, layers,
                norm=tensor("norm", shapes["norm"]), head=w("head", shapes["head"]))


def init_scale(name: str, shape: tuple) -> Tuple[float, float]:
    """(offset, scale) of the port's own random weights: gains 1, biases
    N(0, 0.02^2), matmul weights N(0, 1/d_in), convolutions N(0, 1/(3 C_in)),
    the embedding N(0, 1) and the gate N(0, 2^2/d_in)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("g", "attn_norm", "moe_norm", "norm"):
        return 1.0, 0.0
    if len(shape) == 1:
        return 0.0, 0.02
    if len(shape) == 3:
        return 0.0, (3 * shape[1]) ** -0.5
    if leaf == "embed":
        return 0.0, 1.0
    return 0.0, (2.0 if leaf == "gate" else 1.0) * shape[0] ** -0.5


def init_omni_params(cfg: OmniConfig, seed: int = 0, device="cpu", dtype=torch.float32,
                     quantize: bool = False) -> Omni:
    """The port's random model from one ``torch.Generator`` of ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def tensor(name, shape):
        off, scale = init_scale(name, shape)
        return torch.randn(shape, generator=gen, device=device).mul_(scale).add_(off)

    return build_omni(cfg, tensor, device, dtype=dtype, quantize=quantize)
