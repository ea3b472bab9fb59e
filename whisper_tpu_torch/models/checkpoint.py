"""Checkpoint loading and the snapshot format.

Port of ``whisper_tpu/models/checkpoint.py``. An OpenAI Whisper ``.pt``, a
Hugging Face model directory (``config.json`` + ``model.safetensors`` or
``pytorch_model.bin``) or a bare ``.safetensors`` file is read on the host,
its state dict remapped by the same converters as the JAX package's into the
JAX package's stacked numpy tree, and that tree is carried to the device by
:func:`~whisper_tpu_torch.params.from_jax_params`, the one bridge into a
:class:`~whisper_tpu_torch.models.model.Whisper`.

:func:`save_params` / :func:`load_params` write and read this package's
snapshot: one safetensors file with the JAX package's key names (stacked
``(L, ...)`` leaves, ``name.__q`` / ``name.__s`` for int8 weights) and its
``whisper_tpu.v1`` metadata, so a snapshot written by either package loads
in the other. bf16 weights are written as fp32, as the JAX writer does.

The safetensors reader and writer need no package; ``.pt`` and
``pytorch_model.bin`` are read with ``torch.load`` on the CPU with
``weights_only=True`` (tensors and plain containers only: OpenAI's ``dims``
is a dict), and the weights go to the caller's device after.

One repair against the JAX loader: the language count of a config made from
a checkpoint's dims (or an HF ``config.json``) is OpenAI's
``n_vocab - 51765 - is_multilingual`` (99 for tiny's 51,865 tokens, 100 for
turbo's 51,866), where the JAX loader counts one more; and an HF config's
``max_source_positions`` sets the audio context, which the JAX loader leaves
at 1,500.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import WhisperConfig, get_config
from ..ops.quant import QTensor
from ..params import from_jax_params, to_jax_params
from .model import Whisper, sinusoids

Tree = Dict[str, Any]

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


# ------------------------------------------------------------- file readers
def _read_header(path: str) -> Tuple[dict, int]:
    """A safetensors file's JSON header and the byte offset of its body."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) < 8:
            raise ValueError(f"{path}: not a safetensors file (truncated header)")
        (hlen,) = struct.unpack("<Q", raw)
        if hlen > os.path.getsize(path):
            raise ValueError(f"{path}: not a safetensors file (bad header length)")
        return json.loads(f.read(hlen)), 8 + hlen


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Minimal safetensors reader (header JSON + raw buffer); BF16 comes back
    as fp32."""
    header, start = _read_header(path)
    with open(path, "rb") as f:
        f.seek(start)
        body = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        s, e = meta["data_offsets"]
        raw = body[s:e]
        if meta["dtype"] == "BF16":
            arr = (np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=_DTYPES[meta["dtype"]])
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def _torch_load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def _numpy_state(sd) -> Dict[str, np.ndarray]:
    return {k: v.float().numpy() for k, v in sd.items()}


def load_torch_pt(path: str) -> Tuple[Dict[str, np.ndarray], Optional[dict]]:
    """An OpenAI whisper ``.pt`` (``{"dims", "model_state_dict"}``) or a bare
    state dict -> (fp32 numpy state dict, dims dict or None)."""
    ckpt = _torch_load(path)
    dims = None
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        dims = ckpt.get("dims")
        ckpt = ckpt["model_state_dict"]
    return _numpy_state(ckpt), dims


def save_safetensors(path: str, tensors: Dict[str, np.ndarray],
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Minimal safetensors writer (inverse of :func:`load_safetensors`);
    dtypes it does not name (bf16) are written as fp32."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    blobs = []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype not in _NAMES:
            arr = arr.astype(np.float32)
        blob = arr.tobytes()
        header[name] = {"dtype": _NAMES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


def save_params(path: str, model: Whisper, cfg: Optional[WhisperConfig] = None) -> None:
    """Write ``model`` (int8 QTensor leaves included) as one safetensors
    snapshot with the JAX package's key names and ``whisper_tpu.v1``
    metadata; the config is ``cfg``, else the model's."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, QTensor):
            flat[prefix + "__q"] = node.q
            flat[prefix + "__s"] = node.s
        else:
            flat[prefix.rstrip(".")] = node

    walk(to_jax_params(model), "")
    cfg = cfg or model.cfg
    save_safetensors(path, flat, metadata={"format": "whisper_tpu.v1", "config": cfg.to_json()})


def load_params_tree(path: str) -> Tuple[Tree, Optional[WhisperConfig]]:
    """A :func:`save_params` snapshot (of either package) -> (the JAX
    layout's numpy tree with QTensor leaves, its config or None)."""
    header, _ = _read_header(path)
    meta = header.get("__metadata__", {})
    tree: Tree = {}
    qparts: Dict[str, Dict[str, np.ndarray]] = {}
    for name, arr in load_safetensors(path).items():
        if name.endswith("__q") or name.endswith("__s"):
            base, kind = name.rsplit(".", 1)
            qparts.setdefault(base, {})[kind] = arr
            continue
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    for base, kv in qparts.items():
        node = tree
        parts = base.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = QTensor(kv["__q"], kv["__s"])
    cfg = WhisperConfig.from_json(meta["config"]) if "config" in meta else None
    return tree, cfg


def load_params(path: str, cfg: Optional[WhisperConfig] = None, *,
                device) -> Tuple[Whisper, WhisperConfig]:
    """A :func:`save_params` snapshot -> (:class:`Whisper` on ``device``, its
    config): the snapshot's own config, else ``cfg`` (one of the two must
    be there)."""
    tree, saved = load_params_tree(path)
    cfg = saved or cfg
    if cfg is None:
        raise ValueError(f"{path}: the snapshot holds no config; pass cfg=")
    return from_jax_params(tree, cfg, device=device), cfg


# ------------------------------------------------------------- converters
def _stack(arrs) -> np.ndarray:
    return np.stack([np.asarray(a, dtype=np.float32) for a in arrs], axis=0)


def _convert(sd: Dict[str, np.ndarray], cfg: WhisperConfig, names: Dict[str, str]) -> Tree:
    """A state dict in one naming -> the stacked tree; ``names`` maps this
    module's roles to the naming's key patterns."""
    n = names

    def lin_w(name):  # torch Linear stores (out, in); the tree uses (in, out)
        return np.asarray(sd[name], dtype=np.float32).T

    def get(name):
        return np.asarray(sd[name], dtype=np.float32)

    def attn(prefix, L, stem):
        return {
            "wq": _stack(lin_w(f"{prefix}.{i}.{stem}.{n['q']}.weight") for i in range(L)),
            "bq": _stack(get(f"{prefix}.{i}.{stem}.{n['q']}.bias") for i in range(L)),
            "wk": _stack(lin_w(f"{prefix}.{i}.{stem}.{n['k']}.weight") for i in range(L)),
            "wv": _stack(lin_w(f"{prefix}.{i}.{stem}.{n['v']}.weight") for i in range(L)),
            "bv": _stack(get(f"{prefix}.{i}.{stem}.{n['v']}.bias") for i in range(L)),
            "wo": _stack(lin_w(f"{prefix}.{i}.{stem}.{n['o']}.weight") for i in range(L)),
            "bo": _stack(get(f"{prefix}.{i}.{stem}.{n['o']}.bias") for i in range(L)),
        }

    def stacked_ln(prefix, L, name):
        return {"g": _stack(get(f"{prefix}.{i}.{name}.weight") for i in range(L)),
                "b": _stack(get(f"{prefix}.{i}.{name}.bias") for i in range(L))}

    def mlp(prefix, L):
        return {"w1": _stack(lin_w(f"{prefix}.{i}.{n['fc1']}.weight") for i in range(L)),
                "b1": _stack(get(f"{prefix}.{i}.{n['fc1']}.bias") for i in range(L)),
                "w2": _stack(lin_w(f"{prefix}.{i}.{n['fc2']}.weight") for i in range(L)),
                "b2": _stack(get(f"{prefix}.{i}.{n['fc2']}.bias") for i in range(L))}

    def ln(name):
        return {"g": get(f"{name}.weight"), "b": get(f"{name}.bias")}

    def conv(name):  # torch Conv1d weight (out, in, k) -> (k, in, out) WIO
        return {"w": get(f"{name}.weight").transpose(2, 1, 0), "b": get(f"{name}.bias")}

    La, Lt = cfg.n_audio_layer, cfg.n_text_layer
    ep, dp = n["enc_blocks"], n["dec_blocks"]
    encoder = {
        "conv1": conv(f"{n['enc']}.conv1"),
        "conv2": conv(f"{n['enc']}.conv2"),
        "pos_emb": (get(n["enc_pos"]) if n["enc_pos"] in sd
                    else sinusoids(cfg.n_audio_ctx, cfg.n_audio_state)),
        "blocks": {"attn_ln": stacked_ln(ep, La, n["attn_ln"]),
                   "attn": attn(ep, La, n["attn"]),
                   "mlp_ln": stacked_ln(ep, La, n["mlp_ln"]),
                   "mlp": mlp(ep, La)},
        "ln_post": ln(n["enc_ln"]),
    }
    decoder = {
        "tok_emb": get(n["tok_emb"]),
        "pos_emb": get(n["dec_pos"]),
        "blocks": {"attn_ln": stacked_ln(dp, Lt, n["attn_ln"]),
                   "attn": attn(dp, Lt, n["attn"]),
                   "cross_ln": stacked_ln(dp, Lt, n["cross_ln"]),
                   "cross": attn(dp, Lt, n["cross"]),
                   "mlp_ln": stacked_ln(dp, Lt, n["mlp_ln"]),
                   "mlp": mlp(dp, Lt)},
        "ln": ln(n["dec_ln"]),
    }
    return {"encoder": encoder, "decoder": decoder}


_OPENAI = dict(q="query", k="key", v="value", o="out", fc1="mlp.0", fc2="mlp.2",
               enc="encoder", enc_pos="encoder.positional_embedding",
               enc_blocks="encoder.blocks", dec_blocks="decoder.blocks",
               attn_ln="attn_ln", attn="attn", mlp_ln="mlp_ln", cross_ln="cross_attn_ln",
               cross="cross_attn", enc_ln="encoder.ln_post",
               tok_emb="decoder.token_embedding.weight",
               dec_pos="decoder.positional_embedding", dec_ln="decoder.ln")
_HF = dict(q="q_proj", k="k_proj", v="v_proj", o="out_proj", fc1="fc1", fc2="fc2",
           enc="model.encoder", enc_pos="model.encoder.embed_positions.weight",
           enc_blocks="model.encoder.layers", dec_blocks="model.decoder.layers",
           attn_ln="self_attn_layer_norm", attn="self_attn", mlp_ln="final_layer_norm",
           cross_ln="encoder_attn_layer_norm", cross="encoder_attn",
           enc_ln="model.encoder.layer_norm", tok_emb="model.decoder.embed_tokens.weight",
           dec_pos="model.decoder.embed_positions.weight", dec_ln="model.decoder.layer_norm")


def from_openai_state_dict(sd: Dict[str, np.ndarray], cfg: WhisperConfig) -> Tree:
    """OpenAI whisper naming (encoder.blocks.N.attn.query.weight, ...)."""
    return _convert(sd, cfg, _OPENAI)


def from_hf_state_dict(sd: Dict[str, np.ndarray], cfg: WhisperConfig) -> Tree:
    """HF Transformers naming (model.encoder.layers.N.self_attn.q_proj...),
    with or without the ``model.`` prefix."""
    if not any(k.startswith("model.") for k in sd) and "encoder.conv1.weight" in sd:
        sd = {f"model.{k}": v for k, v in sd.items()}
    return _convert(sd, cfg, _HF)


# ------------------------------------------------------------- entry points
def _languages(n_vocab: int) -> Tuple[bool, int]:
    """(is_multilingual, language count) of a vocabulary size, as OpenAI's
    ``Whisper.num_languages``: the multilingual vocab is 51,766 tokens plus
    one per language, the English-only one 51,765 plus 99 unused slots."""
    multilingual = n_vocab >= 51865
    return multilingual, n_vocab - 51765 - int(multilingual)


def _dims_to_config(dims: dict, name: str = "custom") -> WhisperConfig:
    multilingual, num_languages = _languages(dims.get("n_vocab", 51865))
    return WhisperConfig(
        name=name,
        n_mels=dims["n_mels"],
        n_audio_ctx=dims["n_audio_ctx"],
        n_audio_state=dims["n_audio_state"],
        n_audio_head=dims["n_audio_head"],
        n_audio_layer=dims["n_audio_layer"],
        n_vocab=dims["n_vocab"],
        n_text_ctx=dims["n_text_ctx"],
        n_text_state=dims["n_text_state"],
        n_text_head=dims["n_text_head"],
        n_text_layer=dims["n_text_layer"],
        is_multilingual=multilingual,
        num_languages=num_languages,
    )


def _hf_config(path: str, size: Optional[str]) -> WhisperConfig:
    cfg_file = os.path.join(path, "config.json")
    hf = {}
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            hf = json.load(f)
    n_vocab = hf.get("vocab_size", 51865)
    multilingual, num_languages = _languages(n_vocab)
    return WhisperConfig(
        name=size or os.path.basename(path.rstrip("/")),
        n_mels=hf.get("num_mel_bins", 80),
        n_audio_ctx=hf.get("max_source_positions", 1500),
        n_audio_state=hf.get("d_model", 384),
        n_audio_head=hf.get("encoder_attention_heads", 6),
        n_audio_layer=hf.get("encoder_layers", 4),
        n_vocab=n_vocab,
        n_text_ctx=hf.get("max_target_positions", 448),
        n_text_state=hf.get("d_model", 384),
        n_text_head=hf.get("decoder_attention_heads", 6),
        n_text_layer=hf.get("decoder_layers", 4),
        is_multilingual=multilingual,
        num_languages=num_languages,
    )


def _convert_any(sd: Dict[str, np.ndarray], cfg: WhisperConfig) -> Tree:
    hf = any("q_proj" in k for k in sd)
    return (from_hf_state_dict if hf else from_openai_state_dict)(sd, cfg)


def load_tree(path: str, size: Optional[str] = None) -> Tuple[Tree, WhisperConfig]:
    """Weights from a file or directory -> (the JAX layout's fp32 numpy
    tree, config), as the JAX ``load_checkpoint`` returns them.

    Accepts an OpenAI ``{size}.pt`` (its dims set the config, else
    ``size``'s preset), an HF model directory (``config.json`` +
    ``model.safetensors`` / ``pytorch_model.bin``) or a bare
    ``.safetensors`` file (needs ``size``)."""
    if os.path.isdir(path):
        cfg = _hf_config(path, size)
        st = os.path.join(path, "model.safetensors")
        pt = os.path.join(path, "pytorch_model.bin")
        if os.path.exists(st):
            sd = load_safetensors(st)
        elif os.path.exists(pt):
            sd = _numpy_state(_torch_load(pt))
        else:
            raise FileNotFoundError(f"no weights found in {path}")
        return from_hf_state_dict(sd, cfg), cfg

    if path.endswith(".safetensors"):
        if size is None:
            raise ValueError("bare .safetensors needs size=")
        cfg = get_config(size)
        return _convert_any(load_safetensors(path), cfg), cfg

    sd, dims = load_torch_pt(path)
    if dims is not None:
        cfg = _dims_to_config(dict(dims), name=size or os.path.basename(path).split(".")[0])
    elif size is None:
        raise ValueError("checkpoint has no dims; pass size=")
    else:
        cfg = get_config(size)
    return _convert_any(sd, cfg), cfg


def load_checkpoint(path: str, size: Optional[str] = None, *,
                    device) -> Tuple[Whisper, WhisperConfig]:
    """:func:`load_tree`, then :func:`~whisper_tpu_torch.params.from_jax_params`
    onto ``device``: (:class:`Whisper` in fp32, config)."""
    tree, cfg = load_tree(path, size)
    return from_jax_params(tree, cfg, device=device), cfg
