"""The port's hand-written CUDA kernels against their plain PyTorch versions.

Every test here needs an NVIDIA card with nvcc (marker ``cuda``) and skips
elsewhere. The file imports neither jax nor the JAX package, so it also runs
on a machine with only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.models.model import quantize_cross_kv, quantize_kv_heads
from whisper_tpu_torch.ops.decode_attention import (
    cross_attention_decode_fd,
    cross_attention_decode_fd_plain,
    self_attention_decode,
    self_attention_decode_int8,
    self_attention_decode_int8_plain,
    self_attention_decode_plain,
)
from whisper_tpu_torch.ops.flash_attention import flash_attention_btd, flash_attention_btd_plain

pytestmark = pytest.mark.cuda

# max |kernel - plain|: fp32 differs by summation order only; bf16 outputs
# may differ by one bf16 ulp (2^-7 at |out| < 2, 2^-8 at |out| < 1)
K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}
# K3 with |V| <= 1: fp32 differs by summation order only; bf16 outputs by one
# bf16 rounding of a value below 1 (<= 2^-9), plus the order
K3_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,D,H", [(2, 150, 256, 4), (1, 1500, 1280, 20), (3, 64, 128, 2)])
def test_flash_attention_btd_kernel_matches_plain(dev, dtype, B, T, D, H):
    rng = np.random.default_rng(T)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(dev, dtype)
               for _ in range(3))
    before = flash_attention_btd.launches
    got = flash_attention_btd(q, k, v, H)
    torch.cuda.synchronize()
    assert flash_attention_btd.launches == before + 1
    ref = flash_attention_btd_plain(q, k, v, H)
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - ref.float()).abs().max()) <= K1_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,T", [(2, 3, 300), (4, 20, 1500), (1, 2, 4)])
def test_cross_attention_decode_fd_kernel_matches_plain(dev, dtype, B, H, T):
    rng = np.random.default_rng(T)
    ck, cv = (torch.from_numpy(rng.standard_normal((1, B, H, T, 64)).astype(np.float32)).to(dev)
              for _ in range(2))
    k_q, k_s, v_q, v_s = (t[0] for t in quantize_cross_kv((ck, cv)))
    q = torch.from_numpy(rng.standard_normal((B, H, 1, 64)).astype(np.float32)).to(dev, dtype)
    before = cross_attention_decode_fd.launches
    got = cross_attention_decode_fd(q, k_q, k_s, v_q, v_s)
    torch.cuda.synchronize()
    assert cross_attention_decode_fd.launches == before + 1
    ref = cross_attention_decode_fd_plain(q, k_q, k_s, v_q, v_s)
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - ref.float()).abs().max()) <= K2_TOL[dtype]


def _self_cache(rng, B, H, T, dtype, dev):
    """q (B, H, 1, 64) and the two cache layer views, |V| <= 1: a float
    (k, v) (B, H, 64, T) and an int8 (kv_q, kv_s)."""
    q = torch.from_numpy(rng.standard_normal((B, H, 1, 64)).astype(np.float32)).to(dev, dtype)
    k = torch.from_numpy(rng.standard_normal((B, H, T, 64)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-1, 1, (B, H, T, 64)).astype(np.float32))
    kv_q, kv_s = quantize_kv_heads(k, v)
    return (q, (k.transpose(-1, -2).contiguous().to(dev, dtype),
                v.transpose(-1, -2).contiguous().to(dev, dtype)),
            (kv_q.contiguous().to(dev), kv_s.contiguous().to(dev)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,T", [(4, 20, 128), (8, 20, 256), (3, 2, 448), (2, 1, 1)])
def test_self_attention_decode_kernel_matches_plain(dev, dtype, B, H, T):
    """Both cache layouts at ragged per-row offsets (0 = one visible key,
    T-1, past the cache, negative = empty) with and without pads, and at a
    scalar offset."""
    rng = np.random.default_rng(T + B)
    q, (k, v), (kv_q, kv_s) = _self_cache(rng, B, H, T, dtype, dev)
    edge = [0, T - 1, T + 5, -1]
    offsets = torch.tensor((edge + list(rng.integers(0, T, B)))[:B], device=dev)
    pads = torch.tensor(rng.integers(0, max(T // 4, 1), B), device=dev)
    for off, pad in ((offsets, None), (offsets, pads), (T // 2, None), (T // 2, pads)):
        for fn, plain, cache in ((self_attention_decode, self_attention_decode_plain, (k, v)),
                                 (self_attention_decode_int8, self_attention_decode_int8_plain,
                                  (kv_q, kv_s))):
            before = fn.launches
            got = fn(q, *cache, off, pad)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            ref = plain(q, *cache, off, pad)
            assert got.dtype == dtype and got.shape == q.shape
            assert torch.isfinite(got).all()
            assert float((got.float() - ref.float()).abs().max()) <= K3_TOL[dtype], fn.__name__


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((1, 8, 96), device=dev)  # head dim 48
    with pytest.raises(ValueError):
        flash_attention_btd(x, x, x, 2)
    h = torch.zeros((1, 8, 128), device=dev, dtype=torch.half)  # fp16 is not taken
    with pytest.raises(ValueError):
        flash_attention_btd(h, h, h, 2)
    q = torch.zeros((1, 2, 1, 64), device=dev)
    kq = torch.zeros((1, 2, 64, 6), dtype=torch.int8, device=dev)  # T % 4 != 0
    s = torch.ones((1, 2, 1, 64), device=dev)
    with pytest.raises(ValueError):
        cross_attention_decode_fd(q, kq, s, kq, s)
    q = torch.zeros((1, 2, 1, 64), device=dev)
    k = torch.zeros((1, 2, 64, 8), device=dev, dtype=torch.bfloat16)  # dtype != q's
    with pytest.raises(ValueError):
        self_attention_decode(q, k, k, 3)
    k = torch.zeros((1, 2, 64, 8), device=dev)
    with pytest.raises(ValueError):  # int32 offsets
        self_attention_decode(q, k, k, torch.zeros(1, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # head dim 32
        self_attention_decode(q[..., :32].contiguous(), k[:, :, :32].contiguous(),
                              k[:, :, :32].contiguous(), 3)
