"""The plain reference of Uni-MoE-2.0-Omni's speech-to-text path, in
float32 PyTorch with TF32 off: no kernel, no cache, no batching across
lengths, and nothing of the port. It follows the published configuration
(``configs/uni-moe-2.0-omni.json``) and what it assumes:

- audio: the log-mel of ``reference.log_mel`` (the first 2 x n_audio_ctx
  frames, all 3,000 at Whisper's 1,500 positions), Whisper's encoder
  (``reference.Reference.encode``), adaptive average pooling over time to
  ``n_query`` frames, and a linear projector with a bias;
- the prompt: ``n_prefix`` text ids, the audio embeddings, ``n_suffix``
  text ids (:func:`prompt_ids`, drawn from the weight seed below
  ``n_text_ids``), numbered from position 0;
- a block: ``h = x + Attn(RMSNorm(x))``, ``y = h + MoE(RMSNorm(h))``; then
  a final RMSNorm and the untied head. Attention: q, k and v with biases,
  o without; rotate-half RoPE at ``rope_theta`` over the whole head (the
  M-RoPE of equal position ids); GQA, each KV head repeated for its query
  heads; causal; scale head_dim^-0.5;
- MoE: ``p = softmax(u @ W_g)`` over the routed experts then the null one;
  the chosen set is the shortest prefix of the experts sorted by ``p``
  (ties to the lower index) whose mass reaches ``top_p``, at most
  ``top_k``; the output is every fixed expert (weight 1) plus ``p_e
  E_e(u)`` over the chosen routed ones, ``E(u) = W_down(silu(W_gate u) *
  W_up u)``, a null expert adding nothing, ``p`` not renormalised.

Every weight is drawn on its own (:func:`draw`): a generator seeded by the
weight seed and the weight's name, so the port's model, built from the same
draws one weight at a time, and this reference, which draws each block's
weights when it reaches the block and drops them after, read the same
values without the fp32 model (about 107 GB at the published sizes) ever
living whole. Scales (:func:`scale_of`): N(0, 1/d_in) matmul weights,
N(0, 1/(3 C_in)) convolutions, gains 1 + N(0, 0.1^2), biases N(0, 0.02^2),
the embedding N(0, 1), and the gate N(0, GATE_SCALE^2/d_in), so that a
token's router picks one expert, two, or the null one among them.

``quant="int4"`` is the control: every weight the configuration serves in
int8 (the encoder's linears, every linear of the language model, the
projector and the head) rounded to symmetric 4 bits per output channel,
and the activations entering them to 4 bits per row.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .reference import N_SAMPLES, Reference, _round_sym, log_mel
from .weights import Dims, sinusoids

GATE_SCALE = 2.0  # the router's logits N(0, 2^2): one expert on ~39% of decisions, null in ~32%
PROMPT_STREAM = 4  # generate.stream_seed's next free stream: the prompt's ids
ENCODE_BLOCK = 4  # clips encoded at a time


@dataclass(frozen=True)
class OmniDims:
    """The sizes of the configuration file, under the names the code uses."""

    whisper: Dims  # the audio encoder's (its text sizes unused)
    n_query: int
    d_model: int
    n_layer: int
    n_head: int
    n_kv_head: int
    head_dim: int
    n_vocab: int
    rms_eps: float
    rope_theta: float
    n_fixed: int
    d_fixed: int
    n_routed: int
    d_routed: int
    n_null: int
    top_p: float
    top_k: int
    n_prefix: int
    n_suffix: int
    n_text_ids: int
    stop_id: int

    @property
    def prompt_len(self) -> int:
        return self.n_prefix + self.n_query + self.n_suffix

    @classmethod
    def from_config(cls, c: dict) -> "OmniDims":
        a, p = c["assumed"]["audio_encoder"], c["assumed"]["prompt"]
        whisper = Dims(n_mels=a["num_mel_bins"], n_audio_ctx=a["max_source_positions"],
                       n_audio_state=c["whisper_hidden_size"],
                       n_audio_head=a["encoder_attention_heads"],
                       n_audio_layer=a["encoder_layers"], n_audio_ffn=a["encoder_ffn_dim"],
                       n_text_ctx=0, n_text_state=c["whisper_hidden_size"], n_text_head=1,
                       n_text_layer=0, n_text_ffn=0, n_vocab=0)
        return cls(whisper=whisper, n_query=c["whisper_query_tokens_size"],
                   d_model=c["hidden_size"], n_layer=c["num_hidden_layers"],
                   n_head=c["num_attention_heads"], n_kv_head=c["num_key_value_heads"],
                   head_dim=c["hidden_size"] // c["num_attention_heads"],
                   n_vocab=c["vocab_size"], rms_eps=c["rms_norm_eps"],
                   rope_theta=float(c["rope_theta"]), n_fixed=c["mlp_fixed_expert_num"],
                   d_fixed=c["shared_intermediate_size"], n_routed=c["mlp_dynamic_expert_num"],
                   d_routed=c["dynamic_intermediate_size"],
                   n_null=c["mlp_dynamic_null_expert_num"], top_p=c["mlp_dynamic_top_p"],
                   top_k=c["mlp_dynamic_top_k"], n_prefix=p["prefix_ids"],
                   n_suffix=p["suffix_ids"], n_text_ids=p["ids_below"], stop_id=p["stop_id"])


# ------------------------------------------------------------------ weights
def tensor_seed(seed: int, name: str) -> int:
    """The seed of weight ``name``'s own generator."""
    h = int.from_bytes(hashlib.blake2b(name.encode(), digest_size=8).digest(), "little")
    return int(np.random.SeedSequence([seed % 2 ** 64, h]).generate_state(1, np.uint64)[0]
               % 2 ** 63)


def scale_of(name: str, shape: tuple) -> Tuple[float, float]:
    """(offset, standard deviation) of weight ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("g", "attn_norm", "moe_norm", "norm"):
        return 1.0, 0.1
    if len(shape) == 1:
        return 0.0, 0.02
    if len(shape) == 3:  # a convolution (C_out, C_in, 3)
        return 0.0, (3 * shape[1]) ** -0.5
    if leaf == "embed":
        return 0.0, 1.0
    return 0.0, (GATE_SCALE if leaf == "gate" else 1.0) * shape[0] ** -0.5


def draw(seed: int, name: str, shape: tuple, device) -> torch.Tensor:
    """Weight ``name`` (fp32 on ``device``): the same seed, name and device
    type give the same values."""
    gen = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    off, sd = scale_of(name, shape)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(sd).add_(off)


def prompt_ids(d: OmniDims, seed: int) -> Tuple[List[int], List[int]]:
    """The prompt's prefix and suffix ids, drawn from the weight seed below
    ``n_text_ids``."""
    ss = np.random.SeedSequence([seed % 2 ** 64, PROMPT_STREAM])
    ids = np.random.default_rng(ss).integers(0, d.n_text_ids, d.n_prefix + d.n_suffix)
    return [int(i) for i in ids[: d.n_prefix]], [int(i) for i in ids[d.n_prefix:]]


# ------------------------------------------------------------------ pieces
def route(p: torch.Tensor, top_p: float, top_k: int) -> torch.Tensor:
    """(N, E) bool: each row's chosen experts (module docstring)."""
    ps, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    before = F.pad(torch.cumsum(ps, dim=-1)[:, :-1], (1, 0))
    keep = (before < top_p) & (torch.arange(p.shape[-1], device=p.device) < top_k)
    return torch.zeros_like(keep).scatter(-1, idx, keep)


def rope_tables(d: OmniDims, n: int, device):
    inv = d.rope_theta ** (-torch.arange(0, d.head_dim, 2, dtype=torch.float64,
                                         device=device) / d.head_dim)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g


class OmniReference:
    """The reference over the weights of ``seed`` on ``device``;
    ``quant="int4"`` makes it the control (module docstring)."""

    def __init__(self, d: OmniDims, seed: int, device, quant: Optional[str] = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.d, self.seed, self.device = d, seed, device
        self.bits = {None: None, "int4": 4}[quant]
        self.quant = quant

    def w(self, name: str, shape: tuple) -> torch.Tensor:
        return draw(self.seed, name, shape, self.device)

    def _linear(self, x, w, b=None):
        """A linear the configuration serves W8A8."""
        if self.bits is not None:
            x, w = _round_sym(x, (-1,), self.bits), _round_sym(w, (0,), self.bits)
        y = torch.matmul(x, w)
        return y if b is None else y + b

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) -> (B, n_audio_ctx, C): Whisper's encoder over
        the first 2 x n_audio_ctx frames."""
        wd = self.d.whisper
        C, F_ = wd.n_audio_state, wd.n_audio_ffn

        def g(name, shape):
            return self.w("encoder." + name, shape)

        enc = {"conv1": {"w": g("conv1.w", (C, wd.n_mels, 3)), "b": g("conv1.b", (C,))},
               "conv2": {"w": g("conv2.w", (C, C, 3)), "b": g("conv2.b", (C,))},
               "pos_emb": sinusoids(wd.n_audio_ctx, C, self.device),
               "ln_post": {"g": g("ln_post.g", (C,)), "b": g("ln_post.b", (C,))}, "blocks": []}
        for i in range(wd.n_audio_layer):
            p = f"blocks.{i}."
            attn = {n: g(p + "attn." + n, (C, C)) for n in ("wq", "wk", "wv", "wo")}
            attn.update({n: g(p + "attn." + n, (C,)) for n in ("bq", "bv", "bo")})
            enc["blocks"].append({
                "attn_ln": {"g": g(p + "attn_ln.g", (C,)), "b": g(p + "attn_ln.b", (C,))},
                "attn": attn,
                "mlp_ln": {"g": g(p + "mlp_ln.g", (C,)), "b": g(p + "mlp_ln.b", (C,))},
                "mlp": {"w1": g(p + "mlp.w1", (C, F_)), "b1": g(p + "mlp.b1", (F_,)),
                        "w2": g(p + "mlp.w2", (F_, C)), "b2": g(p + "mlp.b2", (C,))}})
        return Reference(wd, {"encoder": enc}, quant=self.quant).encode(
            mel[..., : 2 * wd.n_audio_ctx])

    def audio_embeddings(self, clips: Sequence[np.ndarray]) -> torch.Tensor:
        """(B, n_query, D): mel, encoder, pooling, projector."""
        d, out = self.d, []
        proj_w = self.w("projector.w", (d.whisper.n_audio_state, d.d_model))
        proj_b = self.w("projector.b", (d.d_model,))
        for lo in range(0, len(clips), ENCODE_BLOCK):
            block = clips[lo: lo + ENCODE_BLOCK]
            audio = torch.zeros((len(block), N_SAMPLES), dtype=torch.float32, device=self.device)
            for i, c in enumerate(block):
                audio[i, : len(c)] = torch.from_numpy(np.ascontiguousarray(c)).to(self.device)
            mel = log_mel(audio, [len(c) for c in block], d.whisper.n_mels)
            feats = self.encode(mel)
            pooled = F.adaptive_avg_pool1d(feats.transpose(1, 2), d.n_query).transpose(1, 2)
            out.append(self._linear(pooled, proj_w, proj_b))
        return torch.cat(out)

    def _attention(self, i: int, h: torch.Tensor, cos, sin) -> torch.Tensor:
        d, p = self.d, f"layers.{i}.attn."
        B, S, D = h.shape
        Q, KV = d.n_head * d.head_dim, d.n_kv_head * d.head_dim
        q = self._linear(h, self.w(p + "wq", (D, Q)), self.w(p + "bq", (Q,)))
        k = self._linear(h, self.w(p + "wk", (D, KV)), self.w(p + "bk", (KV,)))
        v = self._linear(h, self.w(p + "wv", (D, KV)), self.w(p + "bv", (KV,)))
        q = _rope(q.view(B, S, d.n_head, d.head_dim).transpose(1, 2), cos, sin)
        k = _rope(k.view(B, S, d.n_kv_head, d.head_dim).transpose(1, 2), cos, sin)
        v = v.view(B, S, d.n_kv_head, d.head_dim).transpose(1, 2)
        rep = d.n_head // d.n_kv_head
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        scores = torch.matmul(q, k.transpose(-1, -2)) * d.head_dim ** -0.5
        causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        o = torch.matmul(torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1), v)
        return self._linear(o.transpose(1, 2).reshape(B, S, Q), self.w(p + "wo", (Q, D)))

    def _expert(self, name: str, u: torch.Tensor, width: int) -> torch.Tensor:
        D = self.d.d_model
        g = self._linear(u, self.w(name + "w_gate", (D, width)))
        up = self._linear(u, self.w(name + "w_up", (D, width)))
        return self._linear(F.silu(g) * up, self.w(name + "w_down", (width, D)))

    def _moe(self, i: int, u: torch.Tensor, record: Optional[list]) -> torch.Tensor:
        """The MoE of normed rows ``u`` (N, D)."""
        d, p = self.d, f"layers.{i}."
        probs = torch.softmax(torch.matmul(u, self.w(p + "gate", (d.d_model, d.n_routed
                                                                    + d.n_null))), dim=-1)
        chosen = route(probs, d.top_p, d.top_k)
        if record is not None:
            record.append(chosen)
        out = sum(self._expert(f"{p}fixed.{f}.", u, d.d_fixed) for f in range(d.n_fixed))
        for e in range(d.n_routed):
            rows = chosen[:, e].nonzero()[:, 0]
            if len(rows):
                y = self._expert(f"{p}routed.{e}.", u[rows], d.d_routed)
                out = out.index_add(0, rows, probs[rows, e: e + 1] * y)
        return out

    def logits(self, clips: Sequence[np.ndarray], prefix: Sequence[int], suffix: Sequence[int],
               tokens: Sequence[np.ndarray], record: Optional[list] = None) -> List[torch.Tensor]:
        """Teacher-forced logits: for request r, (len(tokens[r]), V) at the
        positions that chose its served ``tokens[r]`` (the prompt's last and
        each served id's but the last), over the sequence prompt + served
        ids. The requests run together, shorter ones padded at the end
        (causal: no earlier position reads a pad). ``record`` gets each
        layer's chosen sets (B x S, E)."""
        d, dev = self.d, self.device
        B, P = len(clips), d.prompt_len
        n = max(len(t) for t in tokens)
        S = P + n - 1
        ids = torch.zeros((B, n), dtype=torch.int64, device=dev)
        for r, t in enumerate(tokens):
            ids[r, : len(t)] = torch.as_tensor(np.asarray(t, np.int64), device=dev)
        emb = self.w("embed", (d.n_vocab, d.d_model))
        text = lambda t: emb[torch.as_tensor(list(t), device=dev)][None].expand(B, -1, -1)
        x = torch.cat([text(prefix), self.audio_embeddings(clips), text(suffix),
                       emb[ids[:, :-1]]], dim=1)
        del emb
        cos, sin = rope_tables(d, S, dev)
        for i in range(d.n_layer):
            x = x + self._attention(i, _rms(x, self.w(f"layers.{i}.attn_norm", (d.d_model,)),
                                            d.rms_eps), cos, sin)
            u = _rms(x, self.w(f"layers.{i}.moe_norm", (d.d_model,)), d.rms_eps)
            x = x + self._moe(i, u.reshape(B * S, -1), record).view(B, S, -1)
        h = _rms(x[:, P - 1:], self.w("norm", (d.d_model,)), d.rms_eps)
        out = self._linear(h, self.w("head", (d.d_model, d.n_vocab)))
        return [out[r, : len(t)] for r, t in enumerate(tokens)]
