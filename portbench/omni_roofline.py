"""The yardstick of Uni-MoE-2.0-Omni's offline cell, from the
configuration and the routing counts alone (``omni_reference.OmniDims``,
the driver's ``facts``): the bytes a decode step must read, the useful
matmul work of a batch at the peak of each product's precision
(``roofline.PEAK_*``: NVIDIA H100 SXM, dense, 700 W), and the least time
of the language model's K8 launches at their own shapes.

A weight the configuration serves in int8 is read as its int8 payload and
its fp32 per-channel scales; the KV cache is bf16.
"""

from __future__ import annotations

from .omni_reference import OmniDims
from .roofline import PEAK_BF16, PEAK_BYTES, PEAK_INT8

KV_BYTES = 2  # bf16


def _int8(k: int, n: int) -> float:
    return k * n + 4.0 * n


def decode_bytes(d: OmniDims, live_steps: int, active_experts: int, positions: int) -> float:
    """The bytes ``live_steps`` decode steps must read: every layer's
    attention and fixed experts and the head at each step, the routed
    experts some live row chose (``active_experts``: summed over the
    layers of every step), and the K/V of the ``positions`` the live rows
    attended to (summed over rows and steps)."""
    D, Q, KV = d.d_model, d.n_head * d.head_dim, d.n_kv_head * d.head_dim
    attn = _int8(D, Q + 2 * KV) + _int8(Q, D)
    fixed = 3 * _int8(D, d.n_fixed * d.d_fixed)
    expert = 2 * _int8(D, d.d_routed) + _int8(d.d_routed, D)
    per_step = d.n_layer * (attn + fixed) + _int8(D, d.n_vocab)
    kv = d.n_layer * 2 * KV * KV_BYTES * positions
    return live_steps * per_step + active_experts * expert + kv


def _encoder_seconds(d: OmniDims, batch: int) -> float:
    """The Whisper encoder's useful work (conv stem and attention bf16, the
    W8A8 projections and MLP int8), as ``roofline.offline_step_seconds``
    counts it."""
    w = d.whisper
    C, Fw, Ta = w.n_audio_state, w.n_audio_ffn, w.n_audio_ctx
    stem = 2.0 * batch * 2 * Ta * 3 * w.n_mels * C + 2.0 * batch * Ta * 3 * C * C
    proj = w.n_audio_layer * 2.0 * batch * Ta * (4 * C * C + 2 * C * Fw)
    attn = w.n_audio_layer * 4.0 * batch * Ta * Ta * C
    return (stem + attn) / PEAK_BF16 + proj / PEAK_INT8


def batch_seconds(d: OmniDims, batch: int, generated: list, moe: dict) -> float:
    """The least time of the useful matmul work of ``len(generated) /
    batch`` batches: the encoder, the projector, the prefill over the
    prompt (the head at its last position), and each row's decode steps
    (one for every generated id but the last, at its position), each
    token's routed experts as the routing counts give them (``moe``:
    ``moe_stats`` over the same batches); W8A8 products at the int8 peak,
    attention's products at the bf16 peak."""
    D, Q, KV = d.d_model, d.n_head * d.head_dim, d.n_kv_head * d.head_dim
    P, n_batches = d.prompt_len, len(generated) / batch
    dense = 2.0 * (D * (Q + 2 * KV) + Q * D + 3 * D * d.n_fixed * d.d_fixed)  # a token-layer
    expert = 2.0 * 3 * D * d.d_routed  # a token's pass through one routed expert
    head = 2.0 * D * d.n_vocab
    fed = [g - 1 for g in generated]  # decode steps a row ran
    rows_prefill = len(generated) * P
    int8 = (n_batches * 2.0 * batch * d.n_query * d.whisper.n_audio_state * D
            + d.n_layer * dense * (rows_prefill + sum(fed))
            + expert * (sum(moe["prefill"]["routed_tokens"]) + sum(moe["decode"]["routed_tokens"]))
            + head * (len(generated) + sum(fed)))
    # QK^T and PV over the positions each query sees: P(P+1)/2 in the
    # prefill, P + i at decode step i
    seen = len(generated) * P * (P + 1) / 2 + sum(f * P + f * (f + 1) / 2 for f in fed)
    bf16 = d.n_layer * 4.0 * Q * seen
    return n_batches * _encoder_seconds(d, batch) + int8 / PEAK_INT8 + bf16 / PEAK_BF16


def decode_seconds(d: OmniDims, generated: list, live_steps: int, moe: dict) -> float:
    """The least time, by bytes (:func:`decode_bytes`), of ``live_steps``
    decode steps (those with a live row) whose rows generated
    ``generated`` ids, with the active experts of ``moe`` (``moe_stats``
    over the same steps)."""
    P = d.prompt_len
    positions = sum((g - 1) * P + (g - 1) * g / 2 for g in generated)
    return decode_bytes(d, live_steps, moe["decode"]["active_experts"], positions) / PEAK_BYTES


def k8_seconds(M: float, K: int, N: int, out_bytes: int, bias: bool) -> float:
    """K8 ``int8_gemm_scaled`` at (M, K, N): int8 A and B in, the fp32 row
    and channel scales (and a bias) in, C out at ``out_bytes`` a value; the
    larger of its operations at the int8 peak and its bytes at the memory
    bandwidth."""
    nbytes = M * K + K * N + out_bytes * M * N + 4.0 * M + 4.0 * N + (out_bytes * N if bias else 0)
    return max(2.0 * M * K * N / PEAK_INT8, nbytes / PEAK_BYTES)


def lm_k8_launches(d: OmniDims, batch: int, n_batches: int, decode_steps: int,
                   prefill_moe: dict) -> list:
    """(M, K, N, out bytes, bias, launches) of the language model's K8
    launches over ``n_batches`` batches of ``batch`` rows: in each prefill,
    every block's q|k|v (with its bias) and o over the prompt's rows, the
    fixed experts' gate|up (bf16 out) and down, each routed expert that
    some row chose its gate|up and down over the rows routed to it, and the
    head at the prompt's last position; in each of the ``decode_steps``
    steps the device ran (masked steps included), the same products at
    ``batch`` rows with every routed expert on every row. The routed
    experts of the prefill come from its routing counts (``prefill_moe``,
    ``moe_stats``' prefill over the same batches): ``active_experts``
    launches of each product, their rows (``routed_tokens``) taken as even
    over them; every routed expert has the same K and N, and a least time
    of one launch is convex in its rows, so the even split never reads
    above the launches' own least time."""
    D, Q, KV = d.d_model, d.n_head * d.head_dim, d.n_kv_head * d.head_dim
    F, L = d.n_fixed * d.d_fixed, d.n_layer

    def block(M, n):
        return [(M, D, Q + 2 * KV, 4, True, n), (M, Q, D, 4, False, n),
                (M, D, 2 * F, 2, False, n), (M, F, D, 4, False, n)]

    rows = batch * d.prompt_len
    out = block(rows, L * n_batches) + [(batch, D, d.n_vocab, 4, False, n_batches)]
    active = prefill_moe["active_experts"]
    if active:
        M = sum(prefill_moe["routed_tokens"]) / active
        out += [(M, D, 2 * d.d_routed, 2, False, active), (M, d.d_routed, D, 4, False, active)]
    out += block(batch, L * decode_steps) + [(batch, D, d.n_vocab, 4, False, decode_steps)]
    out += [(batch, D, 2 * d.d_routed, 2, False, L * d.n_routed * decode_steps),
            (batch, d.d_routed, D, 4, False, L * d.n_routed * decode_steps)]
    return out


def lm_k8_seconds(d: OmniDims, batch: int, n_batches: int, decode_steps: int,
                  prefill_moe: dict):
    """The least time of :func:`lm_k8_launches` and their number."""
    launches = lm_k8_launches(d, batch, n_batches, decode_steps, prefill_moe)
    return (sum(n * k8_seconds(M, K, N, o, b) for M, K, N, o, b, n in launches),
            sum(n for *_, n in launches))
