"""The entries a traffic mix's ``kind`` names: each builds the port, warms
it, runs the measured window and returns a ``harness.Outcome``. These are
the only modules here that import the port."""

from __future__ import annotations

import torch

from ..weights import Dims, make_weights


def port_model(dims: Dims, name: str, seed: int, device):
    """The port's ``Whisper`` over this benchmark's weights (views of one
    buffer: the port's quantization and cast replace every leaf)."""
    from whisper_tpu_torch.config import WhisperConfig
    from whisper_tpu_torch.models.model import Decoder, Encoder, Whisper

    if dims.n_audio_ffn != 4 * dims.n_audio_state or dims.n_text_ffn != 4 * dims.n_text_state:
        raise ValueError("the port's blocks take an MLP four times their width")
    cfg = WhisperConfig(name=name, n_mels=dims.n_mels, n_audio_ctx=dims.n_audio_ctx,
                        n_audio_state=dims.n_audio_state, n_audio_head=dims.n_audio_head,
                        n_audio_layer=dims.n_audio_layer, n_vocab=dims.n_vocab,
                        n_text_ctx=dims.n_text_ctx, n_text_state=dims.n_text_state,
                        n_text_head=dims.n_text_head, n_text_layer=dims.n_text_layer,
                        num_languages=dims.num_languages)
    w = make_weights(dims, seed, device)
    e, d = w["encoder"], w["decoder"]
    encoder = Encoder(conv1=e["conv1"], conv2=e["conv2"], pos_emb=e["pos_emb"],
                      ln_post=e["ln_post"], blocks=e["blocks"])
    decoder = Decoder(tok_emb=d["tok_emb"], pos_emb=d["pos_emb"], ln=d["ln"],
                      blocks=d["blocks"])
    return Whisper(cfg, encoder, decoder)


def build() -> dict:
    """Build the port's CUDA kernels that its build directory in the
    checkout lacks, all at once (the first run in a checkout builds, later
    runs find them built): how many were missing and the seconds taken."""
    from whisper_tpu_torch.ops import _build

    missing = [n for n in _build.KERNELS if not _build.library_path(n).exists()]
    return {"kernels_built": len(missing), **_build.build_all()}


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> dict:
    """Each hand-written kernel wrapper's launch count so far."""
    from whisper_tpu_torch.utils.graphs import kernel_wrappers

    return {fn.__name__: fn.launches for fn in kernel_wrappers()}
