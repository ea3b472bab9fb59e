"""The yardstick of the kernels and of the whole step: peaks, and each
kernel's operations and bytes at its shapes, from the configuration alone
(copied from the port's smoke script, so a kernel change cannot move it).

A kernel's least time is the larger of its operations over the peak of the
precision the configuration serves it in and its bytes over the memory
bandwidth, each input byte read once and each output byte written once.
"""

from __future__ import annotations

from .weights import Dims

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_FP32 = 67e12       # FLOP/s, without tensor cores
PEAK_INT8 = 1979e12     # OP/s, tensor cores
PEAK_BYTES = 3.35e12    # B/s, HBM3


def _least(flops: float, peak: float, nbytes: float) -> float:
    return max(flops / peak, nbytes / PEAK_BYTES)


def k1_seconds(d: Dims, batch: int) -> float:
    """K1 ``flash_attention_btd`` over the encoder at ``batch`` clips: bf16
    q, k, v in and o out; QK^T and PV."""
    dh = d.n_audio_state // d.n_audio_head
    T = d.n_audio_ctx
    flops = 4.0 * batch * d.n_audio_head * T * T * dh
    nbytes = 4.0 * batch * T * d.n_audio_state * 2
    return _least(flops, PEAK_BF16, nbytes)


def k8_shapes(d: Dims, batch: int) -> list:
    """(M, K, N) of an encoder layer's six W8A8 products, in launch order."""
    M, D, F = batch * d.n_audio_ctx, d.n_audio_state, d.n_audio_ffn
    return [(M, D, D), (M, D, D), (M, D, D), (M, D, D), (M, D, F), (M, F, D)]


def k8_seconds(M: int, K: int, N: int) -> float:
    """K8 ``int8_gemm_scaled`` at (M, K, N): int8 A and B in, bf16 C out
    with the fp32 row and channel scales and the bf16 bias in."""
    nbytes = M * K + K * N + 2.0 * M * N + 4.0 * M + 6.0 * N
    return _least(2.0 * M * K * N, PEAK_INT8, nbytes)


def k8_layer_seconds(d: Dims, batch: int) -> float:
    return sum(k8_seconds(*s) for s in k8_shapes(d, batch))


def k2_seconds(d: Dims, batch: int) -> float:
    """K2 ``cross_attention_decode_fd`` at ``batch`` rows of one step: int8
    K and V with fp32 scales, bf16 q and output; two fp32 products of
    dh x T a head."""
    dh, T = d.n_text_state // d.n_text_head, d.n_audio_ctx
    n = batch * d.n_text_head
    nbytes = 2.0 * n * dh * T + 2 * 4.0 * n * dh + 2 * 2.0 * n * dh
    return _least(4.0 * n * dh * T, PEAK_FP32, nbytes)


def offline_step_seconds(d: Dims, batch: int, prompt_len: int, generated: list) -> float:
    """The least time of one offline batch's model matmul work: the encoder
    (conv stem and attention in bf16, the W8A8 projections and MLP in
    int8), the cross-KV projections, and the decoder over the positions
    each row fed (the prompt and every one of its ``generated[r]`` tokens
    but the last), its self-attention over the positions that exist, its
    cross-attention over the audio, and the logits of the positions that
    chose a token; all but the int8 products at the bf16 peak. Each row's
    positions counted once, as the useful work."""
    fed = [prompt_len + n - 1 for n in generated]
    D, Dt, F = d.n_audio_state, d.n_text_state, d.n_audio_ffn
    Ta, frames = d.n_audio_ctx, 2 * d.n_audio_ctx
    stem = 2.0 * batch * frames * 3 * d.n_mels * D + 2.0 * batch * Ta * 3 * D * D
    proj = d.n_audio_layer * 2.0 * batch * Ta * (4 * D * D + 2 * D * F)
    attn = d.n_audio_layer * 4.0 * batch * Ta * Ta * D
    cross_kv = d.n_text_layer * 4.0 * batch * Ta * D * Dt
    positions = sum(fed)
    ctx = sum(p * (p + 1) / 2 for p in fed)  # self-attention keys over all positions
    dec_proj = d.n_text_layer * 2.0 * positions * (6 * Dt * Dt + 2 * Dt * d.n_text_ffn)
    dec_attn = d.n_text_layer * 4.0 * Dt * (ctx + positions * Ta)
    logits = 2.0 * sum(generated) * Dt * d.n_vocab
    bf16 = stem + attn + cross_kv + dec_proj + dec_attn + logits
    return bf16 / PEAK_BF16 + proj / PEAK_INT8
