"""Decode-step attention kernels: int8 cross-attention (K2, and the
head-batched K4 and dense K5 forms the JAX package selects with
``WHISPER_TPU_DECODE_FLASH``) and self-attention over the KV cache (K3).

``cross_attention_decode_fd`` is the port of the TPU kernel
``whisper_tpu/ops/decode_attention.py:cross_attention_decode_fd``
(``_fd_kernel``): one query per (batch, head) against int8 K and V stored
transposed (B, H, dh, T) with fp32 (B, H, 1, dh) per-channel scales; the K
scales and dh^-0.5 fold into the query, the V scales into the output, and the
softmax is over the whole T, all in fp32. On a CUDA tensor it launches the
hand-written Hopper kernel ``whisper_tpu_torch/csrc/cross_attention_decode.cu``
(a cluster of four CTAs a (batch, head), each moving its 16 K and V rows
with bulk copies; see the note there); on a CPU tensor it runs
:func:`cross_attention_decode_fd_plain`.

``self_attention_decode`` (float cache) and ``self_attention_decode_int8``
(packed int8 cache) are the port of the TPU kernel
``whisper_tpu/ops/decode_attention.py:self_attention_decode``
(``_self_kernel``): one query per (batch, head) against the self-attention
cache, key position t visible iff ``pads[b] <= t <= offsets[b]``, fp32
softmax. They read the port's position-minor cache layer views as they lie.
On a CUDA tensor they launch ``whisper_tpu_torch/csrc/self_attention_decode.cu``
(each warp loads its chunk of the visible window in one round: K and the
scales by cp.async, V into registers); on a CPU tensor they run their
``_plain`` versions.

``cross_attention_decode`` is the port of the TPU kernel
``whisper_tpu/ops/decode_attention.py:cross_attention_decode`` (``_kernel``,
and ``_kernel_vpu`` with ``use_vpu=True``): K2's contract with the softmax
taken over the whole T at once and the normalised weights multiplying V; the
default form rounds the scaled query and the weights to the query's dtype
before the two products, the ``use_vpu`` form computes all in fp32. On a
CUDA tensor it launches ``whisper_tpu_torch/csrc/cross_attention_decode_legacy.cu``.

``cross_attention_decode_dense`` is the port of the TPU kernel
``whisper_tpu/ops/decode_attention.py:cross_attention_decode_dense``
(``_dense_kernel``): the same function as one product of a block-diagonal
query with all heads' K, then V times the weights and its diagonal, every
operand rounded to bf16 whatever the query's dtype. On a CUDA tensor it
launches ``whisper_tpu_torch/csrc/cross_attention_decode_dense.cu`` (one
launch: a CTA per (batch, head), a cluster of them along a long T, int8 K
and V by bulk copies, the scores kept in shared memory; see the note
there).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from . import _build

NEG = -1e30  # masked score, as the JAX package's jnp.float32(-1e30)


def _check_cross(name: str, q, k_q, k_s, v_q, v_s):
    """The checks K2, K4 and K5 share on a CUDA tensor; returns (B, H, T)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
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
    if T % 4 or T < 4:
        raise ValueError(f"the CUDA kernel reads char4 along T: T % 4 must be 0, got {T}")
    ts = (q, k_q, k_s, v_q, v_s)
    if any(t.device != q.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("all inputs must be contiguous and on one device")
    return B, H, T


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


_FD_MAX_T = 16384  # two fp32 score arrays of a (batch, head) and a 4-row group in 227 KB


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
    (q bf16 or fp32, dh = 64, T % 4 == 0, T <= 16384, contiguous, k_q and
    v_q 16-byte aligned for the bulk copies) or raise.
    """
    if q.device.type == "cpu":
        return cross_attention_decode_fd_plain(q, k_q, k_s, v_q, v_s)
    B, H, T = _check_cross("cross_attention_decode_fd", q, k_q, k_s, v_q, v_s)
    if T > _FD_MAX_T:
        raise ValueError(f"the CUDA kernel keeps a head's scores in shared memory: T <= "
                         f"{_FD_MAX_T}, got {T}")
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("the CUDA kernel bulk-copies k_q and v_q: both must start "
                         "16-byte aligned")
    out = torch.empty_like(q)
    err = _build.launch(_kernel(q.dtype), q.device, q.data_ptr(), k_q.data_ptr(),
                        k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), out.data_ptr(), B * H,
                        T, 64 ** -0.5)
    if err:
        raise RuntimeError(f"cross_attention_decode_fd launch failed: cudaError {err}")
    _build.count(cross_attention_decode_fd)
    return out


cross_attention_decode_fd.launches = 0  # kernel launches; only the CUDA branch counts


# ---------------------------------------- head-batched, whole-T softmax (K4)
def cross_attention_decode_plain(q, k_q, k_s, v_q, v_s, use_vpu: bool = False) -> torch.Tensor:
    """Plain version: softmax((q * k_s * dh^-0.5) . k_q) . v_q * v_s in q's
    dtype, (B, H, 1, dh). Without ``use_vpu`` the scaled query and the
    normalised weights are rounded to q's dtype before the products (fp32
    accumulation), as ``_kernel`` does; with it everything is fp32."""
    dh = q.shape[-1]
    qs = q.to(torch.float32) * k_s * (dh ** -0.5)
    if not use_vpu:
        qs = qs.to(q.dtype).to(torch.float32)
    w = torch.softmax(torch.matmul(qs, k_q.to(torch.float32)), dim=-1)
    if not use_vpu:
        w = w.to(q.dtype).to(torch.float32)
    o = torch.matmul(w, v_q.to(torch.float32).transpose(-1, -2))
    return (o * v_s).to(q.dtype)


_LEGACY_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_LEGACY_MAX_T = 48 * 1024 // 4  # a head's scores live in shared memory


def _legacy_kernel(dtype: torch.dtype):
    lib = _build.load("cross_attention_decode_legacy")
    fn = (lib.cross_attention_decode_legacy_bf16 if dtype == torch.bfloat16
          else lib.cross_attention_decode_legacy_f32)
    fn.argtypes, fn.restype = _LEGACY_SIGNATURE, ctypes.c_int
    return fn


def cross_attention_decode(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                           v_q: torch.Tensor, v_s: torch.Tensor,
                           use_vpu: bool = False) -> torch.Tensor:
    """q (B, H, 1, dh); k_q, v_q (B, H, dh, T) int8; k_s, v_s (B, H, 1, dh)
    fp32 -> (B, H, 1, dh) in q's dtype. ``use_vpu`` selects the all-fp32
    form (the TPU's ``_kernel_vpu``).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (q bf16 or fp32, dh = 64, T % 4 == 0, T <= 12288, contiguous) or raise.
    """
    if q.device.type == "cpu":
        return cross_attention_decode_plain(q, k_q, k_s, v_q, v_s, use_vpu)
    B, H, T = _check_cross("cross_attention_decode", q, k_q, k_s, v_q, v_s)
    if T > _LEGACY_MAX_T:
        raise ValueError(f"the CUDA kernel keeps a head's scores in 48 KB: T <= "
                         f"{_LEGACY_MAX_T}, got {T}")
    out = torch.empty_like(q)
    err = _build.launch(_legacy_kernel(q.dtype), q.device, q.data_ptr(), k_q.data_ptr(),
                        k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), out.data_ptr(), B * H,
                        T, 64 ** -0.5, int(bool(use_vpu)))
    if err:
        raise RuntimeError(f"cross_attention_decode launch failed: cudaError {err}")
    _build.count(cross_attention_decode)
    return out


cross_attention_decode.launches = 0  # kernel launches; only the CUDA branch counts


# ------------------------------------------------ block-diagonal dense (K5)
def cross_attention_decode_dense_plain(q, k_q, k_s, v_q, v_s) -> torch.Tensor:
    """Plain version: K4's function with every operand rounded to bf16
    whatever q's dtype (the scaled query, K, V and the normalised weights;
    int8 is exact in bf16), fp32 accumulation and softmax, in q's dtype."""
    bf = torch.bfloat16
    dh = q.shape[-1]
    qs = (q.to(torch.float32) * k_s * (dh ** -0.5)).to(bf).to(torch.float32)
    w = torch.softmax(torch.matmul(qs, k_q.to(torch.float32)), dim=-1)
    w = w.to(bf).to(torch.float32)
    o = torch.matmul(w, v_q.to(torch.float32).transpose(-1, -2))
    return (o * v_s).to(q.dtype)


_DENSE_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]
# the longest T whose slice of a cluster of eight CTAs (its rows of K, later
# of V, and its scores: 107 KB) still leaves two CTAs an SM; the card tests
# run up to it
_DENSE_MAX_T = 12288


def _dense_kernel(dtype: torch.dtype):
    lib = _build.load("cross_attention_decode_dense")
    fn = (lib.cross_attention_decode_dense_bf16 if dtype == torch.bfloat16
          else lib.cross_attention_decode_dense_f32)
    fn.argtypes, fn.restype = _DENSE_SIGNATURE, ctypes.c_int
    return fn


def cross_attention_decode_dense(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                                 v_q: torch.Tensor, v_s: torch.Tensor) -> torch.Tensor:
    """q (B, H, 1, dh); k_q, v_q (B, H, dh, T) int8; k_s, v_s (B, H, 1, dh)
    fp32 -> (B, H, 1, dh) in q's dtype, through bf16 operands.

    CPU tensors take the plain version; CUDA tensors launch the kernel (q
    bf16 or fp32, dh = 64, H <= 32, T % 4 == 0, T <= 12288, contiguous,
    k_q and v_q 16-byte aligned for the bulk copies) or raise. One launch;
    the softmax's scores stay in the kernel's shared memory.
    """
    if q.device.type == "cpu":
        return cross_attention_decode_dense_plain(q, k_q, k_s, v_q, v_s)
    B, H, T = _check_cross("cross_attention_decode_dense", q, k_q, k_s, v_q, v_s)
    if H > 32:  # the contract of the first design, which the tests hold
        raise ValueError(f"the CUDA kernel takes H <= 32, got {H}")
    if T > _DENSE_MAX_T:
        raise ValueError(f"the CUDA kernel keeps a slice of T in shared memory: T <= "
                         f"{_DENSE_MAX_T}, got {T}")
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("the CUDA kernel bulk-copies k_q and v_q: both must start "
                         "16-byte aligned")
    out = torch.empty_like(q)
    err = _build.launch(_dense_kernel(q.dtype), q.device, q.data_ptr(), k_q.data_ptr(),
                        k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), out.data_ptr(), B, H,
                        T, 64 ** -0.5)
    if err:
        raise RuntimeError(f"cross_attention_decode_dense launch failed: cudaError {err}")
    _build.count(cross_attention_decode_dense)
    return out


cross_attention_decode_dense.launches = 0  # kernel launches; only the CUDA branch counts


# ------------------------------------------------------------ self-attention
def _visible(B: int, T: int, offsets, pads, device) -> torch.Tensor:
    """(B, 1, 1, T) bool: pads[b] <= t <= offsets[b]."""
    key = torch.arange(T, device=device)[None, :]
    vis = key <= torch.as_tensor(offsets, device=device).reshape(-1, 1)
    if pads is not None:
        vis = vis & (key >= pads.reshape(-1, 1))
    return vis.expand(B, T)[:, None, None, :]


def self_attention_decode_plain(q, k, v, offsets, pads=None) -> torch.Tensor:
    """Plain version, all fp32: softmax(q.k * dh^-0.5, masked to -1e30) . v,
    returned in q's dtype, shape (B, H, 1, dh). k, v (B, H, dh, T)."""
    B, dh, T = q.shape[0], q.shape[-1], k.shape[-1]
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32)) * (dh ** -0.5)
    s = torch.where(_visible(B, T, offsets, pads, q.device), s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1)
    return torch.matmul(w, v.to(torch.float32).transpose(-1, -2)).to(q.dtype)


def self_attention_decode_int8_plain(q, kv_q, kv_s, offsets, pads=None) -> torch.Tensor:
    """Plain version, all fp32, of attention_int8kv_perpos for one query:
    score columns scale by s_k after q.k, softmax (masked to -1e30), weights
    scale by s_v before w.v. kv_q (B, H, 2, dh, T) int8, kv_s (B, H, 2, T)."""
    B, dh, T = q.shape[0], q.shape[-1], kv_q.shape[-1]
    s = torch.matmul(q.to(torch.float32), kv_q[:, :, 0].to(torch.float32))
    s = s * kv_s[:, :, 0, None, :] * (dh ** -0.5)
    s = torch.where(_visible(B, T, offsets, pads, q.device), s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1) * kv_s[:, :, 1, None, :]
    return torch.matmul(w, kv_q[:, :, 1].to(torch.float32).transpose(-1, -2)).to(q.dtype)


_SELF_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                          ctypes.c_void_p]
_MAX_T = 12288  # the longest cache the wrapper takes (the card tests run up to it)


def _self_kernel(symbol: str):
    fn = getattr(_build.load("self_attention_decode"), symbol)
    fn.argtypes, fn.restype = _SELF_SIGNATURE, ctypes.c_int
    return fn


def _launch_self(name: str, q: torch.Tensor, cache: tuple, T: int,
                 offsets: Union[int, torch.Tensor], pads: Optional[torch.Tensor]):
    """Checks shared by both entry points, then the launch; ``cache`` holds
    the two cache tensors whose pointers the kernel takes after q."""
    B, H, S, dh = q.shape
    if S != 1 or dh != 64:
        raise ValueError(f"the CUDA kernel takes one query of head dim 64, got {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernel takes a bf16 or fp32 query, not {q.dtype}")
    if not 0 < T <= _MAX_T:
        raise ValueError(f"the CUDA kernel takes 1 <= T <= {_MAX_T}, got {T}")
    rows = []
    for what, t in (("offsets", offsets), ("pads", pads)):
        if isinstance(t, torch.Tensor):
            if t.shape != (B,) or t.dtype != torch.int64:
                raise ValueError(f"{what} must be a (B,) int64 tensor, got {tuple(t.shape)} "
                                 f"{t.dtype}")
            rows.append(t)
        elif t is not None and what == "pads":
            raise ValueError("pads must be a (B,) int64 tensor or None")
    ts = (q, *cache, *rows)
    if any(t.device != q.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("all inputs must be contiguous and on one device")
    scalar = 0 if isinstance(offsets, torch.Tensor) else int(offsets)
    off_ptr = offsets.data_ptr() if isinstance(offsets, torch.Tensor) else None
    pad_ptr = pads.data_ptr() if pads is not None else None
    out = torch.empty_like(q)
    tag = "bf16" if q.dtype == torch.bfloat16 else "f32"
    err = _build.launch(
        _self_kernel(f"{name}_{tag}"), q.device, q.data_ptr(), cache[0].data_ptr(),
        cache[1].data_ptr(), out.data_ptr(), off_ptr, pad_ptr, scalar, B * H, H, T, dh ** -0.5)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def self_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          offsets: Union[int, torch.Tensor],
                          pads: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float cache: q (B, H, 1, dh); k, v (B, H, dh, T) (a ``KVCache`` layer
    view); ``offsets`` one int or a (B,) int64 tensor; ``pads`` None or a
    (B,) int64 tensor. Key t of row b is visible iff pads[b] <= t <=
    offsets[b]. Returns (B, H, 1, dh) in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (q
    bf16 or fp32 with k, v of the same dtype, dh = 64, contiguous) or raise.
    """
    if q.device.type == "cpu":
        return self_attention_decode_plain(q, k, v, offsets, pads)
    if q.device.type != "cuda":
        raise ValueError(f"self_attention_decode runs on cpu or cuda, not {q.device}")
    B, H, _, dh = q.shape
    T = k.shape[-1]
    if k.shape != (B, H, dh, T) or v.shape != (B, H, dh, T):
        raise ValueError("k and v must be (B, H, dh, T)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k and v must have q's dtype {q.dtype}, got {k.dtype}, {v.dtype}")
    out = _launch_self("self_attention_decode", q, (k, v), T, offsets, pads)
    _build.count(self_attention_decode)
    return out


def self_attention_decode_int8(q: torch.Tensor, kv_q: torch.Tensor, kv_s: torch.Tensor,
                               offsets: Union[int, torch.Tensor],
                               pads: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Int8 cache: q (B, H, 1, dh); kv_q (B, H, 2, dh, T) int8 with K at
    index 0 and V at 1, kv_s (B, H, 2, T) fp32 (a ``QKVCache`` layer view);
    ``offsets`` and ``pads`` as in :func:`self_attention_decode`. Returns
    (B, H, 1, dh) in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (q
    bf16 or fp32, dh = 64, contiguous) or raise.
    """
    if q.device.type == "cpu":
        return self_attention_decode_int8_plain(q, kv_q, kv_s, offsets, pads)
    if q.device.type != "cuda":
        raise ValueError(f"self_attention_decode_int8 runs on cpu or cuda, not {q.device}")
    B, H, _, dh = q.shape
    T = kv_q.shape[-1]
    if kv_q.shape != (B, H, 2, dh, T) or kv_q.dtype != torch.int8:
        raise ValueError("kv_q must be (B, H, 2, dh, T) int8")
    if kv_s.shape != (B, H, 2, T) or kv_s.dtype != torch.float32:
        raise ValueError("kv_s must be (B, H, 2, T) fp32")
    out = _launch_self("self_attention_decode_int8", q, (kv_q, kv_s), T, offsets, pads)
    _build.count(self_attention_decode_int8)
    return out


self_attention_decode.launches = 0  # kernel launches; only the CUDA branch counts
self_attention_decode_int8.launches = 0
