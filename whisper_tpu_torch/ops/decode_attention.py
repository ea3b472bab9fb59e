"""Decode-step cross-attention against the int8 cross-KV.

``cross_attention_decode_fd`` is the port of the TPU kernel
``whisper_tpu/ops/decode_attention.py:cross_attention_decode_fd``
(``_fd_kernel``): one query per (batch, head) against int8 K and V stored
transposed (B, H, dh, T) with fp32 (B, H, 1, dh) per-channel scales; the K
scales and dh^-0.5 fold into the query, the V scales into the output, and the
softmax is online over T tiles, all in fp32. On a CUDA tensor it launches the
hand-written Hopper kernel ``whisper_tpu_torch/csrc/cross_attention_decode.cu``
(see the note there); on a CPU tensor it runs
:func:`cross_attention_decode_fd_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def cross_attention_decode_fd_plain(q, k_q, k_s, v_q, v_s) -> torch.Tensor:
    """Plain version, all fp32: softmax((q * k_s * dh^-0.5) . k_q) . v_q * v_s,
    returned in q's dtype, shape (B, H, 1, dh)."""
    dh = q.shape[-1]
    qs = q.to(torch.float32) * k_s * (dh ** -0.5)
    p = torch.softmax(torch.matmul(qs, k_q.to(torch.float32)), dim=-1)
    o = torch.matmul(p, v_q.to(torch.float32).transpose(-1, -2))
    return (o * v_s).to(q.dtype)


_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                      ctypes.c_int, ctypes.c_void_p]


def _kernel(dtype: torch.dtype):
    lib = _build.load("cross_attention_decode")
    fn = (lib.cross_attention_decode_fd_bf16 if dtype == torch.bfloat16
          else lib.cross_attention_decode_fd_f32)
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    return fn


def cross_attention_decode_fd(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                              v_q: torch.Tensor, v_s: torch.Tensor) -> torch.Tensor:
    """q (B, H, 1, dh); k_q, v_q (B, H, dh, T) int8; k_s, v_s (B, H, 1, dh)
    fp32 -> (B, H, 1, dh) in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (q bf16 or fp32, dh = 64, T % 4 == 0, contiguous) or raise.
    """
    if q.device.type == "cpu":
        return cross_attention_decode_fd_plain(q, k_q, k_s, v_q, v_s)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_decode_fd runs on cpu or cuda, not {q.device}")
    B, H, S, dh = q.shape
    T = k_q.shape[-1]
    if S != 1 or dh != 64:
        raise ValueError(f"the CUDA kernel takes one query of head dim 64, got {tuple(q.shape)}")
    if k_q.shape != (B, H, dh, T) or v_q.shape != (B, H, dh, T):
        raise ValueError("k_q and v_q must be (B, H, dh, T)")
    if k_s.shape != (B, H, 1, dh) or v_s.shape != (B, H, 1, dh):
        raise ValueError("k_s and v_s must be (B, H, 1, dh)")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise ValueError("k_q and v_q must be int8")
    if k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise ValueError("k_s and v_s must be fp32")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernel takes a bf16 or fp32 query, not {q.dtype}")
    if T % 4:
        raise ValueError(f"the CUDA kernel reads char4 along T: T % 4 must be 0, got {T}")
    ts = (q, k_q, k_s, v_q, v_s)
    if any(t.device != q.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("all inputs must be contiguous and on one device")
    out = torch.empty_like(q)
    err = _kernel(q.dtype)(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
                           v_s.data_ptr(), out.data_ptr(), B * H, T, dh ** -0.5,
                           q.device.index or 0,
                           torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"cross_attention_decode_fd launch failed: cudaError {err}")
    cross_attention_decode_fd.launches += 1
    return out


cross_attention_decode_fd.launches = 0  # kernel launches; only the CUDA branch counts
