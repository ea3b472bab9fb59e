"""The model's float32 weights, made on the device from the seed.

One ``torch.randn`` call fills one flat buffer for every leaf; each leaf is
a view of it, scaled in place: N(0, 1/d_in) projections (the layout is
(d_in, d_out)), N(0, 1/(3 C_in)) convolutions, N(0, 1/D) token embeddings,
N(0, 0.01^2) decoder positions, LayerNorm gains 1 + N(0, 0.1^2), and biases
and LayerNorm shifts N(0, 0.02^2), so every bias and gain of the model is
read. The encoder's positions are Whisper's sinusoids. The same seed gives
the same weights on the same device; the port and the reference each get
their own copy (the port's quantization rewrites what it is given).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

FIRST_TOKEN_ID_VOCAB = 51766  # vocab - this = the languages (51865: 99, 51866: 100)


@dataclass(frozen=True)
class Dims:
    """The sizes of a configuration file, under the names the code uses."""

    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_audio_ffn: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    n_text_ffn: int
    n_vocab: int

    @property
    def num_languages(self) -> int:
        return self.n_vocab - FIRST_TOKEN_ID_VOCAB

    @classmethod
    def from_config(cls, c: dict) -> "Dims":
        """From a configuration file's published (Hugging Face) keys."""
        return cls(n_mels=c["num_mel_bins"], n_audio_ctx=c["max_source_positions"],
                   n_audio_state=c["d_model"], n_audio_head=c["encoder_attention_heads"],
                   n_audio_layer=c["encoder_layers"], n_audio_ffn=c["encoder_ffn_dim"],
                   n_text_ctx=c["max_target_positions"], n_text_state=c["d_model"],
                   n_text_head=c["decoder_attention_heads"], n_text_layer=c["decoder_layers"],
                   n_text_ffn=c["decoder_ffn_dim"], n_vocab=c["vocab_size"])


def _layout(d: Dims) -> List[Tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, scale) of every drawn leaf, in buffer order."""
    D, Dt, n = d.n_audio_state, d.n_text_state, []

    def ln(path, width):
        n.append((path + ("g",), (width,), "gain", 0.1))
        n.append((path + ("b",), (width,), "bias", 0.02))

    def attn(path, width):
        for name in ("wq", "wk", "wv", "wo"):
            n.append((path + (name,), (width, width), "weight", width ** -0.5))
        for name in ("bq", "bv", "bo"):
            n.append((path + (name,), (width,), "bias", 0.02))

    def mlp(path, width, ffn):
        n.append((path + ("w1",), (width, ffn), "weight", width ** -0.5))
        n.append((path + ("b1",), (ffn,), "bias", 0.02))
        n.append((path + ("w2",), (ffn, width), "weight", ffn ** -0.5))
        n.append((path + ("b2",), (width,), "bias", 0.02))

    e = ("encoder",)
    n.append((e + ("conv1", "w"), (D, d.n_mels, 3), "weight", (3 * d.n_mels) ** -0.5))
    n.append((e + ("conv1", "b"), (D,), "bias", 0.02))
    n.append((e + ("conv2", "w"), (D, D, 3), "weight", (3 * D) ** -0.5))
    n.append((e + ("conv2", "b"), (D,), "bias", 0.02))
    for i in range(d.n_audio_layer):
        blk = e + ("blocks", i)
        ln(blk + ("attn_ln",), D)
        attn(blk + ("attn",), D)
        ln(blk + ("mlp_ln",), D)
        mlp(blk + ("mlp",), D, d.n_audio_ffn)
    ln(e + ("ln_post",), D)
    t = ("decoder",)
    n.append((t + ("tok_emb",), (d.n_vocab, Dt), "weight", Dt ** -0.5))
    n.append((t + ("pos_emb",), (d.n_text_ctx, Dt), "weight", 0.01))
    for i in range(d.n_text_layer):
        blk = t + ("blocks", i)
        for sub in ("attn", "cross"):
            ln(blk + (sub + "_ln",), Dt)
            attn(blk + (sub,), Dt)
        ln(blk + ("mlp_ln",), Dt)
        mlp(blk + ("mlp",), Dt, d.n_text_ffn)
    ln(t + ("ln",), Dt)
    return n


def sinusoids(length: int, channels: int, device) -> torch.Tensor:
    """Whisper's encoder positions: sin then cos of position x 10000^(-i/(C/2-1))."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64, device=device))
    t = torch.arange(length, dtype=torch.float64, device=device)[:, None] * inv[None]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def make_weights(d: Dims, seed: int, device) -> dict:
    """{"encoder": {...}, "decoder": {...}} of float32 tensors on ``device``;
    the blocks as lists of {sublayer: {leaf: tensor}}."""
    layout = _layout(d)
    total = sum(math.prod(shape) for _, shape, _, _ in layout)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    at = 0
    for path, shape, kind, scale in layout:
        leaf = buf[at: at + math.prod(shape)].view(shape)
        at += leaf.numel()
        leaf.mul_(scale)
        if kind == "gain":
            leaf.add_(1.0)
        _put(tree, path, leaf)
    _put(tree, ("encoder", "pos_emb"), sinusoids(d.n_audio_ctx, d.n_audio_state, device))
    for part in ("encoder", "decoder"):
        blocks = tree[part]["blocks"]
        tree[part]["blocks"] = [blocks[i] for i in range(len(blocks))]
    return tree
