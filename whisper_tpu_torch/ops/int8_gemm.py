"""Int8 x int8 GEMM (K8), the product under every W8A8 projection.

``int8_gemm`` is the port of the TPU kernel
``benchmarks/int8_gemm_probe.py:make_pallas_gemm``: (M, K) int8 @ (K, N)
int8 -> (M, N) int32. ``int8_gemm_scaled`` runs the same kernel with the W8A8
linear's epilogue fused in (:func:`scale_epilogue`: row scale x channel
scale, the output dtype, the bias), which XLA fuses around the JAX
package's dot (``whisper_tpu/models/model.py:_linear_a8``). On a CUDA tensor
both launch the hand-written Hopper kernel
``whisper_tpu_torch/csrc/int8_gemm.cu`` (see the note there), which reads B
K-major: ``b`` must then be stored column-major, the transpose of a
contiguous (N, K), as :meth:`~whisper_tpu_torch.ops.quant.QTensor.k_major`
lays a weight out once. On a CPU tensor they run their plain versions.
Both count their launches on ``int8_gemm.launches``: one launch, one count.

The kernel has two schedules of the same product, chosen by shape alone
(:func:`split_plan`): products of thousands of rows take the persistent
128 x 256 tiles; products of at most 128 rows whose few tiles would leave
SMs idle split K across the CTAs of a thread-block cluster, so that all
SMs stream the weight. Those launches also count on
``int8_gemm.split_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from . import _build

_OUT_MODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}  # the kernel's epilogues


def int8_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: an exact int32 matmul on the CPU. CUDA has no int32
    matmul, so there it runs in float64, which is exact here: |sum| <=
    K * 127^2 < 2^53."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def scale_epilogue(acc: torch.Tensor, sx: torch.Tensor, ws: torch.Tensor,
                   bias: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """int32 product -> (row scale ``sx`` x channel scale ``ws``) in fp32 ->
    ``dtype``, + ``bias`` in ``dtype``: the JAX ``_linear_a8``'s epilogue."""
    y = ((acc.to(torch.float32) * sx) * ws.to(torch.float32).reshape(-1)).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def int8_gemm_scaled_plain(a: torch.Tensor, b: torch.Tensor, sx: torch.Tensor,
                           ws: torch.Tensor, bias: Optional[torch.Tensor],
                           out_dtype) -> torch.Tensor:
    """Plain version of :func:`int8_gemm_scaled`."""
    return scale_epilogue(int8_gemm_plain(a, b), sx, ws, bias, out_dtype)


class SplitPlan(NamedTuple):
    """The split-K schedule of one product: tiles of 64 rows x ``bn``
    columns, each summed over ``split`` K slices by a cluster of ``split``
    CTAs, ``ctas`` CTAs in the launch (the clusters walk the tiles)."""
    bn: int
    split: int
    ctas: int


SPLIT_MAX_ROWS = 128  # the split schedule's rows: two 64-row tiles at most
SPLIT_WIDTHS = (128, 160, 192, 224, 256)  # its tile widths
SPLIT_MAX = 8  # CTAs of a cluster: the portable most
MIN_SLICE = 3  # 128-byte k tiles a CTA streams at least
FILL = 0.9  # the share of the card's cluster slots a plan's last round fills


def split_plan(M: int, K: int, N: int, waves: Sequence[int]) -> Optional[SplitPlan]:
    """The schedule of an (M, K) @ (K, N) product on a card that runs
    ``waves[s - 1]`` CTAs of the split kernel at once in clusters of ``s``
    (``waves[0]``: its SMs): None for the persistent 128 x 256 tiles, or
    the split-K plan.

    Only products of at most 128 rows may split: there the product is
    bound by the weight's bytes, and the persistent tiles of 128 rows, one
    CTA streaming K x 256 bytes of weight each, are few. A plan (a tile
    width, clusters of 1 to 8 CTAs, each K slice at least ``MIN_SLICE`` k
    tiles) lets the clusters the card holds at once walk its tiles in
    rounds; among the plans whose last round fills ``FILL`` of those
    cluster slots (or the fullest, where none does) the rule takes the
    fewest rounds (each costs a tile's start and reduction), then the
    narrowest tiles (the least partial sum to reduce), then the fewest CTAs
    a cluster. The product splits only where that plan's busiest CTA
    streams fewer bytes of weight than the persistent schedule's does over
    its waves of ``waves[0]`` tiles: a product whose persistent tiles
    already keep every SM streaming (the omni model's head, 594 tiles)
    keeps them."""
    if not 1 <= M <= SPLIT_MAX_ROWS:
        return None
    k_tiles, m_tiles = -(-K // 128), -(-M // 64)
    best, best_key, rounds_of_best = None, None, 0
    for bn in SPLIT_WIDTHS:
        tiles = m_tiles * -(-N // bn)
        for split in range(1, min(SPLIT_MAX, max(1, k_tiles // MIN_SLICE)) + 1):
            at_once = waves[split - 1] // split
            rounds = -(-tiles // at_once)
            key = (min(tiles / (rounds * at_once), FILL), -rounds, -bn, -split)
            if best_key is None or key > best_key:
                best, best_key = SplitPlan(bn, split, split * min(tiles, at_once)), key
                rounds_of_best = rounds
    # k tiles x columns of weight that the busiest CTA streams
    streamed = rounds_of_best * -(-k_tiles // best.split) * best.bn
    persistent_tiles = -(-M // 128) * -(-N // 256)
    persistent = -(-persistent_tiles // waves[0]) * k_tiles * 256
    return best if streamed < persistent else None


_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SPLIT_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _kernel():
    fn = _build.load("int8_gemm").int8_gemm_sm90a
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    return fn


def _split_kernel():
    fn = _build.load("int8_gemm").int8_gemm_sm90a_splitk
    fn.argtypes, fn.restype = _SPLIT_SIGNATURE, ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _plan(M: int, K: int, N: int, index: int) -> Optional[SplitPlan]:
    """:func:`split_plan` on card ``index``, once a shape."""
    return split_plan(M, K, N, _waves(index))


@functools.lru_cache(maxsize=None)
def _waves(index: int) -> tuple:
    """The card's ``waves`` for :func:`split_plan`, asked of it once."""
    slots = _build.load("int8_gemm").int8_gemm_splitk_slots
    slots.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    out = []
    for split in range(1, SPLIT_MAX + 1):
        clusters = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = slots(256, split, index, ctypes.byref(clusters))
        if err:
            raise RuntimeError(f"int8_gemm_splitk_slots failed: error {err}")
        out.append(clusters.value * split)
    return tuple(out)


def _check(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name} takes (M, K) @ (K, N), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"{name} takes int8 operands, got {a.dtype}, {b.dtype}")
    K, N = b.shape
    if K % 16 or N % 8:
        raise ValueError(f"the CUDA kernel needs K % 16 == 0 and N % 8 == 0, got K={K}, N={N}")
    if b.device != a.device or not (a.is_contiguous() and b.t().is_contiguous()):
        raise ValueError("a must be contiguous and b column-major (QTensor.k_major), "
                         "on one device")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("the TMA loads need 16-byte aligned operands")


def _launch(a, b, out, sx=None, ws=None, bias=None) -> torch.Tensor:
    M, K = a.shape
    N = b.shape[1]
    if M == 0:
        return out
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (sx, ws, bias)))
    plan = _plan(M, K, N, a.device.index or 0)
    if plan is None:
        err = _build.launch(_kernel(), a.device, *ptrs, M, N, K, _OUT_MODE[out.dtype])
    else:
        err = _build.launch(_split_kernel(), a.device, *ptrs, M, N, K, _OUT_MODE[out.dtype],
                            *plan)
    if err:
        raise RuntimeError(f"int8_gemm launch failed: error {err} (a cudaError_t, or "
                           f"minus a CUresult of the tensor-map encode)")
    _build.count(int8_gemm)
    if plan is not None:
        _build.count(int8_gemm, attr="split_launches")
    return out


def int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> (M, N) int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (K % 16 == 0, N % 8 == 0, ``a`` contiguous, ``b`` column-major, both
    16-byte aligned) or raise.
    """
    if a.device.type == "cpu":
        return int8_gemm_plain(a, b)
    _check(a, b, "int8_gemm")
    return _launch(a, b, torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32,
                                     device=a.device))


def int8_gemm_scaled(a: torch.Tensor, b: torch.Tensor, sx: torch.Tensor, ws: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16
                     ) -> torch.Tensor:
    """:func:`scale_epilogue` of ``a @ b``: a (M, K) int8, b (K, N) int8, row
    scales ``sx`` (M, 1) fp32, channel scales ``ws`` (N elements, fp32),
    ``bias`` (N,) or None -> (M, N) ``out_dtype`` (bf16 or fp32), only the
    output written.

    CPU tensors take the plain version; CUDA tensors launch the kernel (as
    :func:`int8_gemm` takes ``a`` and ``b``; ``sx`` and ``ws`` fp32,
    contiguous, 8-byte aligned; the bias cast to ``out_dtype`` as the plain
    version casts it) or raise.
    """
    if a.device.type == "cpu":
        return int8_gemm_scaled_plain(a, b, sx, ws, bias, out_dtype)
    _check(a, b, "int8_gemm_scaled")
    M, N = a.shape[0], b.shape[1]
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_gemm_scaled writes bf16 or fp32, not {out_dtype}")
    if bias is not None:
        bias = bias.to(out_dtype)
    for name, t, numel in (("sx", sx, M), ("ws", ws, N), ("bias", bias, N)):
        if t is None and name == "bias":
            continue
        if (t.numel() != numel or t.device != a.device or not t.is_contiguous()
                or t.data_ptr() % 8 or (name != "bias" and t.dtype != torch.float32)):
            raise ValueError(f"{name} must hold {numel} contiguous, 8-byte aligned values on "
                             f"{a.device} (fp32 for the scales); got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return _launch(a, b, torch.empty((M, N), dtype=out_dtype, device=a.device), sx, ws, bias)


int8_gemm.launches = 0  # kernel launches of both entries; only the CUDA branch counts
int8_gemm.split_launches = 0  # those of them that took the split-K schedule
